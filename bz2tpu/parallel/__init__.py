"""Mesh layer: block-data-parallel compression over a jax.sharding.Mesh.

The reference's entire parallelism model is N independent bzip2 blocks per
kernel launch on one device (reference include/OutputStream.hpp:98-116,
kernel.cpp:3140-3144). The vectorized generalization: the block batch axis
is sharded over a device mesh with shard_map, each chip runs the vectorized
pipeline on its shard, and the ordered gather of per-block bitstreams is a
plain sharded-output fetch (block order == batch order by construction, so
no reordering collective is needed; the sub-byte bit alignment carry is
applied during the host stitch exactly as in the single-chip path).
"""

from bz2tpu.parallel.mesh import (  # noqa: F401
    block_mesh,
    encode_blocks_sharded,
    pad_batch,
)
