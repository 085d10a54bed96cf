"""Host-native (C) runtime pieces: stream decoder and CRC32.

The compute path of the framework is JAX/XLA on the accelerator; this
package is the native host runtime around it, mirroring where the
reference keeps C++ (its whole decode stack and CRC are host C++: reference
include/BlockDecompressor.hpp, include/CRC32.hpp). Falls back to the pure
NumPy implementations, with a warning, when the extension cannot be built.
"""

from __future__ import annotations

import os
import sysconfig

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "_bz2dec.c")
_SO = os.path.join(_HERE, "_bz2dec" + (sysconfig.get_config_var("EXT_SUFFIX") or ".so"))


def _is_stale(so: str, src: str) -> bool:
    """The built extension is missing or older than its C source."""
    return not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(src)


def _build(src: str, out: str) -> bool:
    """Compile ``src`` into the extension module ``out`` (one cc call).

    A fresh checkout has no .so, and a checkout whose _bz2dec.c changed
    has a stale one; without this the whole C fast path (sequential /
    parallel decode, RLE1 intake, CRC) would degrade to NumPy or run old
    code. Set BZ2TPU_NO_NATIVE_BUILD=1 to disable the build.
    """
    if os.environ.get("BZ2TPU_NO_NATIVE_BUILD"):
        return False
    import subprocess

    cc = sysconfig.get_config_var("CC") or "cc"
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [*cc.split(), "-O3", "-Wall", "-shared", "-fPIC",
           "-I", sysconfig.get_path("include"), src, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)  # atomic: parallel builders race safely
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def _load():
    if os.path.exists(_SRC) and _is_stale(_SO, _SRC):
        _build(_SRC, _SO)
    from bz2tpu.native import _bz2dec as impl

    return impl


try:  # pragma: no cover - exercised via the public wrappers
    _impl = _load()

    HAVE_NATIVE = True
    decode_stream = _impl.decode_stream
    crc32 = _impl.crc32
    rle1_split = _impl.rle1_split
    scan_blocks = _impl.scan_blocks
    decode_block_at = _impl.decode_block_at
    inverse_rle1 = _impl.inverse_rle1
    CrcError = _impl.CrcError
except (ImportError, AttributeError) as _e:  # not built, or a build that
    # predates newer entry points (AttributeError from _impl.<name>)
    import warnings

    warnings.warn(
        f"bz2tpu native extension unavailable ({_e}); using the NumPy "
        "fallbacks for intake, CRC and host decode",
        RuntimeWarning,
        stacklevel=2,
    )
    HAVE_NATIVE = False
    decode_stream = None
    crc32 = None
    rle1_split = None
    scan_blocks = None
    decode_block_at = None
    inverse_rle1 = None
    CrcError = None
