"""Scalar oracle codec: a bit-exact bzip2 encoder/decoder in NumPy/Python.

This is the test oracle every device op is differential-tested against,
standing in for the reference's C++ host pipeline + OpenCL kernel semantics
(reference include/BlockCompressor.hpp, include/BlockDecompressor.hpp,
kernel.cpp K3-K6). It targets *standard* bzip2 (100k-900k blocks), so stdlib
`bz2` / the system bzip2 binary serve as independent ground truth in both
directions.
"""

from bz2tpu.oracle.encoder import compress  # noqa: F401
from bz2tpu.oracle.decoder import decompress  # noqa: F401
