"""bz2tpu — a bzip2-format lossless codec whose block pipeline runs on an
accelerator through JAX/XLA.

Brand-new framework with the capability set of the reference
(Stan1slav337/Bzip2-OpenCL: parallel block compression, full decode, CRC
integrity checking, block-size levels, parallel-blocks control), re-designed
as vectorised stages:

- true 100 kB - 900 kB bzip2 blocks (standard levels 1-9), unlike the
  reference's 10x-downscaled blocks (reference include/Config.hpp:30);
- every compression stage vectorized for a vector machine (rank-doubling
  suffix sort for the BWT, scan-based MTF/RLE2, Huffman table refinement as
  matrix products, prefix-sum bitstream packing, GF(2) parallel CRC32) instead of
  the reference's one-sequential-pipeline-per-work-item design
  (reference kernel.cpp:3124-3159);
- block-level data parallelism expressed over a `jax.sharding.Mesh` with
  ordered, bit-aligned gathering of per-block bitstreams (the reference's
  host stitch loop, include/OutputStream.hpp:225-239, becomes an associative
  carry fold).

Layers (see SURVEY.md section 7):
  format/   -- bitstream format constants, CRC32, bit-level I/O (NumPy)
  oracle/   -- bit-exact scalar reference codec (NumPy), the test oracle
  ops/      -- JAX programs for each pipeline stage
  parallel/ -- mesh construction + shard_map'ed block pipeline
  runtime/  -- stream orchestration: block scheduler, stitcher, CLI entry
  utils/    -- timing/metrics helpers
"""

__version__ = "0.1.0"

from bz2tpu.format import constants  # noqa: F401


def __getattr__(name):
    """Top-level convenience API, imported lazily (keeps `import bz2tpu`
    free of JAX/device initialization):

        bz2tpu.compress(data, level=9)    -> bytes  (device pipeline)
        bz2tpu.decompress(stream)         -> bytes  (native C / NumPy)
        bz2tpu.compress_device_intake(..) -> bytes  (zero host passes)
        bz2tpu.decompress_device(stream)  -> bytes  (decode on the device)
        bz2tpu.StreamCompressor           push-style, checkpoint/resume
        bz2tpu.StreamDecompressor         push-style incremental decode
        bz2tpu.open / bz2tpu.BZ2File      stdlib-bz2-parity file objects
    """
    if name == "compress":
        from bz2tpu.runtime.compressor import compress

        return compress
    if name == "decompress":
        from bz2tpu.runtime.decompressor import decompress

        return decompress
    if name == "compress_device_intake":
        from bz2tpu.runtime.compressor import compress_device_intake

        return compress_device_intake
    if name == "decompress_device":
        from bz2tpu.runtime.device_decode import decompress_device

        return decompress_device
    if name == "StreamCompressor":
        from bz2tpu.runtime.stream import StreamCompressor

        return StreamCompressor
    if name == "StreamDecompressor":
        from bz2tpu.runtime.decompressor import StreamDecompressor

        return StreamDecompressor
    if name == "BZ2File":
        from bz2tpu.runtime.fileobj import BZ2File

        return BZ2File
    if name == "open":
        from bz2tpu.runtime.fileobj import bz2_open

        return bz2_open
    raise AttributeError(f"module 'bz2tpu' has no attribute {name!r}")
