"""Fully-device compression intake: RLE1 + block splitting + CRCs.

Composes ops/rle1.py (scan-based run detection + greedy capacity cuts)
with ops/crc.py (masked range CRCs over the ORIGINAL bytes) so a raw
input chunk becomes ready-to-encode device blocks without the native C
extension or any host pass over the data — the device-side counterpart
of the reference's host BlockCompressor intake (reference
include/BlockCompressor.hpp:69-154).

The (max_blocks, capacity) block buffer this produces feeds
ops/pipeline.encode_blocks_staged directly, so intake output never
leaves the device.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from bz2tpu.format import constants as C
from bz2tpu.ops.crc import crc32_ranges
from bz2tpu.ops.rle1 import block_cuts, out_capacity, rle1_encode


def chunk_capacity(level: int, max_blocks: int) -> int:
    """Raw chunk bytes guaranteed to fill max_blocks blocks (power of two).

    The pow2 ceiling's ~16% slack over `need` is FUNCTIONAL, not waste:
    an exact-need window leaves the final block under-full whenever RLE1
    shrinks the raw bytes at all, firing the partial-block holdback every
    chunk (7 of 8 blocks consumed + a rescan), which lost end to end when
    the window was trimmed to a 2^16 multiple. The slack keeps every batch
    full on typical data.
    """
    need = C.block_capacity(level) * max_blocks
    cap = 1 << 12
    while cap < need:
        cap <<= 1
    return cap


@functools.partial(jax.jit, static_argnames=("level", "max_blocks"))
def device_intake(chunk: jnp.ndarray, length: jnp.ndarray, *, level: int, max_blocks: int):
    """Raw bytes -> padded RLE1 blocks + lengths + CRCs, all on device.

    Args:
      chunk: (N,) uint8 raw input, N a power of two (chunk_capacity).
      length: scalar int32 valid bytes.

    Returns dict with:
      blocks: (max_blocks, capacity) uint8 RLE1-encoded block data
      ns: (max_blocks,) int32 encoded lengths (1 for empty slots)
      crcs: (max_blocks,) uint32 CRCs over each block's ORIGINAL bytes
      raw_lens: (max_blocks,) int32 original bytes consumed per block
      n_blocks: scalar int32
    """
    cap = C.block_capacity(level)
    enc = rle1_encode(chunk, length)
    out_cuts, raw_cuts, n_blocks = block_cuts(
        enc["piece_out_cum"], enc["piece_raw_cum"], enc["n_pieces"],
        cap=cap, max_blocks=max_blocks,
    )
    starts_out = jnp.concatenate([jnp.zeros((1,), jnp.int32), out_cuts[:-1]])
    starts_raw = jnp.concatenate([jnp.zeros((1,), jnp.int32), raw_cuts[:-1]])
    b_iota = jnp.arange(max_blocks, dtype=jnp.int32)
    b_valid = b_iota < n_blocks

    # Gather each block's RLE1 bytes into its padded row. Rows carry
    # cap + 4 columns: the crossing piece may overshoot nblockMAX by up
    # to 4 bytes (stock's fill rule, ops/rle1.block_cuts).
    no = out_capacity(chunk.shape[0])
    col = jnp.arange(cap + 4, dtype=jnp.int32)[None, :]
    src = starts_out[:, None] + col
    in_range = col < (out_cuts - starts_out)[:, None]
    rows = jnp.where(
        in_range & b_valid[:, None],
        enc["out"][jnp.clip(src, 0, no - 1)],
        0,
    )
    ns = jnp.where(b_valid, jnp.maximum(out_cuts - starts_out, 1), 1)

    crcs = crc32_ranges(chunk, starts_raw, raw_cuts)
    crcs = jnp.where(b_valid, crcs, 0)
    return {
        "blocks": rows,
        "ns": ns,
        "crcs": crcs,
        "raw_lens": jnp.where(b_valid, raw_cuts - starts_raw, 0),
        "n_blocks": n_blocks,
    }
