"""Device mesh + shard_map'ed block pipeline.

Design (SURVEY.md section 5, "Distributed communication backend"): blocks are
data-parallel over a 1-D ``("blocks",)`` mesh — ICI within a slice, DCN
across hosts when running under jax.distributed. Compression needs no
cross-block communication at all (each bzip2 block is self-contained), so
the only collective in the system is the implicit ordered gather of the
sharded outputs; CRC folding and bit stitching ride on the host today and
are associative (format.crc32.stream_crc docstring) so they can move into a
psum/scan collective when multi-host IO becomes the bottleneck.
"""

from __future__ import annotations

import functools

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from bz2tpu.ops.pipeline import bwt_stage, huff_pack_stage, mtf_stage


def block_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh over the available devices with axis name 'blocks'."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.asarray(devices), ("blocks",))


def pad_batch(n_blocks: int, n_shards: int, batch_per_shard: int | None = None) -> int:
    """Smallest total batch >= n_blocks divisible by the shard count."""
    if batch_per_shard is not None:
        return n_shards * batch_per_shard
    return ((n_blocks + n_shards - 1) // n_shards) * n_shards


@functools.lru_cache(maxsize=None)
def _sharded_stages(mesh: Mesh, mtf_chunk: int):
    """The three staged jits (ops.pipeline), each shard_map'ed over blocks.

    Sharding per stage keeps the compile-time win of the staged split
    (ops/pipeline.py) on meshes too.
    There is no cross-shard communication anywhere, so the
    varying-manual-axes check has nothing to protect (check_vma=False: the
    stages' scan/while carries start from replicated constants).
    """
    shard = P("blocks")

    def sm(fn, n_in):
        return jax.jit(
            jax.shard_map(
                fn,
                mesh=mesh,
                in_specs=(shard,) * n_in,
                out_specs=shard,
                check_vma=False,
            )
        )

    return (
        sm(bwt_stage, 2),
        sm(functools.partial(mtf_stage, mtf_chunk=mtf_chunk), 2),
        sm(huff_pack_stage, 7),
    )


def encode_blocks_sharded(blocks, ns, crcs=None, *, mesh: Mesh, mtf_chunk: int = 4096):
    """Batched block encode, blocks sharded over the mesh.

    blocks: (B, capacity) uint8 with B divisible by mesh size; ns: (B,);
    crcs: (B,) uint32 per-block CRCs (device header emission needs them;
    zeros when omitted — the streams then carry zero block CRCs and only
    suit tests that ignore CRC fields).
    Returns the same pytree as ops.pipeline.encode_blocks_staged, sharded
    on the leading axis; fetching it in order IS the ordered gather.
    """
    import jax.numpy as jnp

    bwt_s, mtf_s, huff_s = _sharded_stages(mesh, mtf_chunk)
    if crcs is None:
        crcs = jnp.zeros(blocks.shape[0], jnp.uint32)
    blocks = jax.device_put(blocks, NamedSharding(mesh, P("blocks", None)))
    ns = jax.device_put(ns, NamedSharding(mesh, P("blocks")))
    crcs = jax.device_put(crcs, NamedSharding(mesh, P("blocks")))
    last, orig_ptr = bwt_s(blocks, ns)
    mtf = mtf_s(last, ns)
    out = dict(
        huff_s(mtf["symbols"], mtf["n_sym"], mtf["freqs"], mtf["n_in_use"], orig_ptr, mtf["used"], crcs)
    )
    out["orig_ptr"] = orig_ptr
    out["used"] = mtf["used"]
    out["n_sym"] = mtf["n_sym"]
    out["n_in_use"] = mtf["n_in_use"]
    return out
