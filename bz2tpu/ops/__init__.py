"""JAX/XLA programs for each bzip2 pipeline stage.

Every op here is fixed-shape (blocks padded to capacity, valid lengths
carried as scalars), jit-compatible, and vmap-able over a batch-of-blocks
axis — one XLA compilation serves every block at a given level, and
block-level data parallelism is expressed by vmap + sharding rather than the
reference's one-sequential-pipeline-per-work-item design (reference
kernel.cpp:3124-3159).

Each op is differential-tested against the scalar oracle in bz2tpu.oracle.
"""
