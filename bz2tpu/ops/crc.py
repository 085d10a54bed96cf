"""Device CRC-32/BZIP2: lane-parallel table steps + GF(2) operator folds.

The reference computes CRCs strictly serially on the host, one byte at a
time (reference include/CRC32.hpp:62-74, include/BlockCompressor.hpp:137).
CRC over GF(2) is linear, so the vectorized formulation decomposes it:

  * the buffer is cut into L equal lanes; all lanes advance together one
    byte-position per step (a (B, L) table gather per step — vectorized,
    k = N/L sequential steps instead of N);
  * per-lane results fold pairwise in log2(L) rounds using the precomputed
    "advance past m zero bytes" operator (a 32x32 GF(2) matrix, applied as
    32 conditional XORs);
  * arbitrary [start, end) ranges of one buffer need no per-range pass:
    bytes outside the range are masked to zero during the lane steps (zero
    bytes apply exactly the linear shift operator), and the result is
    corrected with inverse/forward operator ladders (the shift operator is
    invertible because the CRC polynomial has a nonzero constant term).

The host/NumPy oracle with the same decomposition is
bz2tpu/format/crc32.py; differential tests pin both to crc32_serial.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from bz2tpu.format.crc32 import (
    CRC32_TABLE,
    _op_compose,
    _op_identity,
    _op_shift_one_byte,
)

_MASK32 = np.uint32(0xFFFFFFFF)


def _op_inverse(op: np.ndarray) -> np.ndarray:
    """Invert a 32x32 GF(2) operator given as 32 uint32 columns."""
    # Gaussian elimination over GF(2) on the augmented [op | I] columns.
    a = op.astype(np.uint64).copy()
    inv = _op_identity().astype(np.uint64)
    for bit in range(32):
        pivot = None
        for c in range(bit, 32):
            if (a[c] >> bit) & 1:
                pivot = c
                break
        assert pivot is not None, "shift operator must be invertible"
        a[[bit, pivot]] = a[[pivot, bit]]
        inv[[bit, pivot]] = inv[[pivot, bit]]
        for c in range(32):
            if c != bit and ((a[c] >> bit) & 1):
                a[c] ^= a[bit]
                inv[c] ^= inv[bit]
    return inv.astype(np.uint32)


@functools.cache
def _ladder_tables(max_log: int) -> tuple[np.ndarray, np.ndarray]:
    """(fwd, inv): (max_log, 32) uint32 operator tables, fwd[k] advancing a
    CRC state past 2^k zero bytes and inv[k] undoing it. ``max_log`` is
    derived from the (static) chunk size so every reachable exponent is
    covered — a ladder shorter than log2(n) would silently drop high
    exponent bits and emit wrong CRCs."""
    fwd = np.empty((max_log, 32), dtype=np.uint32)
    m = _op_shift_one_byte()
    mi = _op_inverse(m)
    inv = np.empty((max_log, 32), dtype=np.uint32)
    for k in range(max_log):
        fwd[k] = m
        inv[k] = mi
        m = _op_compose(m, m)
        mi = _op_compose(mi, mi)
    return fwd, inv


@functools.cache
def _fold_ops(k: int, rounds: int) -> np.ndarray:
    """(rounds, 32) operators: round r advances past k * 2^r zero bytes."""
    from bz2tpu.format.crc32 import shift_operator

    ops = np.empty((rounds, 32), dtype=np.uint32)
    op = shift_operator(k)
    for r in range(rounds):
        ops[r] = op
        op = _op_compose(op, op)
    return ops


def _apply_op(op: jnp.ndarray, state: jnp.ndarray) -> jnp.ndarray:
    """Apply a GF(2) operator (32 uint32 columns) to uint32 state(s)."""
    bits = (state[..., None] >> jnp.arange(32, dtype=jnp.uint32)) & jnp.uint32(1)
    terms = jnp.where(bits.astype(bool), op, jnp.uint32(0))
    return jax.lax.reduce(
        terms, jnp.uint32(0), jax.lax.bitwise_xor, dimensions=[terms.ndim - 1]
    )


def _apply_ladder(ops: jnp.ndarray, exponent: jnp.ndarray, state: jnp.ndarray) -> jnp.ndarray:
    """Apply op^exponent via the binary ladder (ops[k] = op^(2^k))."""

    def body(k, s):
        bit = ((exponent >> k) & 1).astype(bool)
        return jnp.where(bit, _apply_op(ops[k], s), s)

    return jax.lax.fori_loop(0, ops.shape[0], body, state)


@functools.partial(jax.jit, static_argnames=("lanes",))
def crc32_ranges(
    chunk: jnp.ndarray, starts: jnp.ndarray, ends: jnp.ndarray, *, lanes: int = 4096
) -> jnp.ndarray:
    """Finalized CRC-32/BZIP2 of chunk[starts[b]:ends[b]] for each range b.

    Args:
      chunk: (N,) uint8 with N a multiple of `lanes` (pad with anything:
        bytes outside every range never reach a table step).
      starts/ends: (B,) int32 byte ranges, 0 <= start <= end <= N.

    Prefix-state formulation: ONE unmasked lane pass over the chunk (N
    table gathers total, independent of B — the earlier per-range-masked
    (B, L) design cost B*N) computes every lane's running state; the loop
    captures the state at each range endpoint's in-lane offset as it
    passes it. CRC state evolution is affine over GF(2), so with S(p) =
    raw state of prefix [0, p) from init 0,

        crc[s, e) from init I  =  M^(e-s)(I xor S(s)) xor S(e)

    where M is the shift-one-byte operator — endpoint states alone
    reconstruct every range CRC via the precomputed operator ladders.
    """
    n = chunk.shape[0]
    # Largest power-of-two lane count <= `lanes` dividing n: shape-static.
    lanes_eff = 1
    while lanes_eff * 2 <= lanes and n % (lanes_eff * 2) == 0:
        lanes_eff *= 2
    lanes = lanes_eff
    assert n % lanes == 0 and n > 0
    k = n // lanes
    tab = jnp.asarray(CRC32_TABLE)
    # (k, L): step j reads row j contiguously (one-time transpose pass).
    lane_data = chunk.reshape(lanes, k).T

    # Endpoint positions in [0, n]: lane + in-lane offset. p == n maps to
    # lane == lanes with off == 0, whose captured partial state is the
    # init value 0 (correct: no partial bytes) and whose boundary prefix
    # is the full-chunk combine below.
    pts = jnp.concatenate([starts, ends]).astype(jnp.int32)  # (2B,)
    pt_lane = pts // k
    pt_off = pts % k
    pt_lane_c = jnp.clip(pt_lane, 0, lanes - 1)

    def step(j, carry):
        states, captured = carry  # (L,) uint32, (2B,) uint32
        # states[l] currently holds P_l(j): lane l's first j bytes from 0.
        captured = jnp.where(pt_off == j, states[pt_lane_c], captured)
        byte = lane_data[j].astype(jnp.uint32)
        idx = ((states >> jnp.uint32(24)) ^ byte) & jnp.uint32(0xFF)
        return (states << jnp.uint32(8)) ^ tab[idx], captured

    states, captured = jax.lax.fori_loop(
        0, k, step,
        (jnp.zeros(lanes, jnp.uint32), jnp.zeros(pts.shape[0], jnp.uint32)),
    )

    # Inclusive boundary prefixes T[m] = S((m+1) * k) via Kogge-Stone
    # doubling on the linear recurrence T[m] = M^k(T[m-1]) xor C[m].
    rounds = int(np.log2(lanes))
    fold = jnp.asarray(_fold_ops(k, rounds))
    T = states
    for r in range(rounds):
        sh = 1 << r
        shifted = jnp.concatenate([jnp.zeros(sh, jnp.uint32), T[:-sh]])
        T = _apply_op(fold[r], shifted) ^ T
    # Exclusive boundary prefix at each endpoint's lane: S(lane * k).
    s_bound = jnp.where(
        pt_lane == 0,
        jnp.uint32(0),
        T[jnp.clip(pt_lane - 1, 0, lanes - 1)],
    )

    # Exponents passed to the ladders are at most n (a static shape), so a
    # ladder of ceil(log2(n + 1)) rungs covers every reachable value.
    max_log = max(1, int(np.ceil(np.log2(n + 1))))
    fwd, _ = (jnp.asarray(t) for t in _ladder_tables(max_log))
    # S(p) = M^(p mod k)(S(lane * k)) xor P_lane(p mod k).
    s_pts = _apply_ladder(fwd, pt_off, s_bound) ^ captured
    b = starts.shape[0]
    s_s, s_e = s_pts[:b], s_pts[b:]
    span = (ends - starts).astype(jnp.int32)
    raw = _apply_ladder(fwd, span, s_s ^ jnp.uint32(0xFFFFFFFF)) ^ s_e
    return raw ^ jnp.uint32(0xFFFFFFFF)


def crc32_device(data: jnp.ndarray, length: jnp.ndarray | int, *, lanes: int = 512) -> jnp.ndarray:
    """Finalized CRC of data[:length] (padded fixed-shape buffer)."""
    starts = jnp.zeros((1,), dtype=jnp.int32)
    ends = jnp.asarray([length], dtype=jnp.int32).reshape(1)
    return crc32_ranges(data, starts, ends, lanes=lanes)[0]
