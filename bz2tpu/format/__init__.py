"""Bitstream format layer: constants, CRC32, bit-level readers/writers.

Pure NumPy; CPU-testable; no JAX dependency. This is the ground truth for the
bzip2 container format that both the oracle codec (bz2tpu.oracle) and the device
pipeline (bz2tpu.ops / bz2tpu.runtime) emit and consume.
"""
