"""Burrows-Wheeler transform via rank-quadrupling suffix sort (JAX).

The reference runs a ~2,400-LoC sequential divsufsort per GPU work-item
(reference kernel.cpp:61-2456, one bzip2 block per thread). This design
inverts that: ONE vectorized prefix-doubling sort over the whole block (the
same algorithm family as the reference's own Larsson-Sadakane fallback,
kernel.cpp:1241-1509, but as the primary path), batched over blocks with
vmap and sharded over devices.

Prefix doubling is O(n log n) worst case with NO data-dependent degradation
— it natively answers the reference's TRBudget/lsSort escape hatch
(kernel.cpp:2109-2142): low-entropy repetitive input simply runs its full
log_fan(n) rounds.

Round structure:

  * NO random gathers anywhere on the hot path. ``rank[(i + k) mod n]``
    is served by a SHIFTED IMAGE: ``ext = concat(rank, 0...)`` with
    ``rank`` replayed at offset ``n`` (and the first 2*cap replayed at
    ``2n``) makes ``ext[j] = rank[j mod n]`` for all ``j < 4n``, so every
    wrapped read is one contiguous ``dynamic_slice`` (coalesced reads
    instead of a random gather).
  * round 0 ranks THREE characters with a single 24-bit key — a 2-operand
    unstable sort; the two lookahead characters come from the same
    shifted-image trick (blocks with n < 4 fall back to a 1-char round-0
    key with k0 = 1; the refinement rounds take over).
  * refinement rounds QUADRUPLE: sort (rank, rank[i+k], rank[i+2k],
    rank[i+3k], index) with num_keys=5 establishes 4k-order per round —
    half the rounds of classic doubling at a modestly higher cost per
    round. The index key breaks any ties surviving past k >= n
    (bit-identical rotations of periodic blocks) deterministically.
  * ranks are POSITION-based (rank = sorted position of the group head,
    the Larsson-Sadakane convention), which makes refinement local: a
    group splitting only renumbers inside its own span.
  * SPARSE ROUNDS (opt-in, BZ2TPU_SPARSE_BWT=1): once few positions
    remain tied, tied positions are compacted into a capacity/4 (then
    capacity/16) buffer and only they are re-sorted (classic 2x doubling
    within the compacted set). It trades compaction and scatter work for
    smaller sorts; it lost end to end on the hardware it was first
    measured on and has not been measured on the GPU, so the default
    path runs full quad rounds only.

All shapes are static: a block is a (capacity,) uint8 array plus a valid
length scalar. Padding positions are assigned distinct sort keys strictly
greater than any valid key so they cluster at the tail of the order and
never perturb the suffix array of the valid prefix.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
from jax import lax

_SPARSE_ROUNDS = os.environ.get("BZ2TPU_SPARSE_BWT", "0") == "1"
# Round-0 depth. 6 chars (two 24-bit keys, 3-operand sort) buys one
# fewer quad refinement round, but the extra round-0 operand lost end to
# end where it was first measured (streams identical): the early-exit
# ladder already skips the round the deeper key would have saved on
# typical blocks. Kept behind BZ2TPU_BWT_K0=6; not yet measured on the
# GPU.
_K0_CHARS = int(os.environ.get("BZ2TPU_BWT_K0", "3"))


def _head_positions(head: jnp.ndarray) -> jnp.ndarray:
    """Sorted-order group ranks: position of each element's group head."""
    iota = jnp.arange(head.shape[0], dtype=jnp.int32)
    return lax.cummax(jnp.where(head, iota, 0))


def _inverse_permute(order: jnp.ndarray, vals: jnp.ndarray) -> jnp.ndarray:
    """out[order[i]] = vals[i], via a 2-operand sort keyed on ``order``.

    Equivalent to ``zeros.at[order].set(vals)``; the sort form won over
    the scatter on the hardware this stage was first tuned on and has not
    been re-measured on the GPU. ``order`` must be a permutation of
    0..n-1.
    """
    _, out = lax.sort((order, vals), num_keys=1)
    return out


def _tied(head: jnp.ndarray) -> jnp.ndarray:
    """Element (in sorted order) is in a group of size >= 2."""
    nxt = jnp.concatenate([head[1:], jnp.ones((1,), jnp.bool_)])
    return ~head | ~nxt


def round0_keys(data: jnp.ndarray, n: jnp.ndarray, cap: int):
    """Round-0 sort keys: 3 chars in one 24-bit key (padding sorts last).

    Returns (key0, k0): the (cap,) int32 keys and the established order
    depth (3, or 1 when n < 4 disables the shifted image). The default
    round 0; BZ2TPU_BWT_K0=6 selects the 6-char form (round0_keys6).
    """
    iota = jnp.arange(cap, dtype=jnp.int32)
    valid = iota < n
    ext0 = jnp.concatenate([data, jnp.zeros((4,), jnp.int32)])
    ext0 = lax.dynamic_update_slice(ext0, data[:4], (n,))
    d1 = lax.slice(ext0, (1,), (1 + cap,))
    d2 = lax.slice(ext0, (2,), (2 + cap,))
    small = n < 4  # shifted image invalid: 1-char key, rounds take over
    key24 = jnp.where(small, data * 65536, data * 65536 + d1 * 256 + d2)
    key0 = jnp.where(valid, key24, (1 << 24) + iota)
    k0 = jnp.where(small, jnp.int32(1), jnp.int32(3))
    return key0, k0


def round0_keys6(data: jnp.ndarray, n: jnp.ndarray, cap: int):
    """Round-0 keys ranking SIX chars as two 24-bit keys (round-5 rework).

    One extra sort operand buys twice the round-0 depth: the quad ladder
    then starts at k0 = 6 instead of 3, which removes one full 5-operand
    refinement round from BOTH the worst case (6*4^8 covers 900k one
    doubling earlier) and typical text exits. Padding rows carry
    (2^24 + i, 0): distinct, strictly above every valid key, preserved
    singleton by every re-rank — same invariant as round0_keys. Blocks
    with n < 7 (shifted image would alias) fall back to the 1-char key;
    the refinement rounds take over from k0 = 1.
    """
    iota = jnp.arange(cap, dtype=jnp.int32)
    valid = iota < n
    ext0 = jnp.concatenate([data, jnp.zeros((8,), jnp.int32)])
    ext0 = lax.dynamic_update_slice(ext0, data[:8], (n,))
    ds = [lax.slice(ext0, (j,), (j + cap,)) for j in range(1, 6)]
    small = n < 7  # shifted image invalid: 1-char key, rounds take over
    keyA = jnp.where(small, data * 65536, data * 65536 + ds[0] * 256 + ds[1])
    keyB = jnp.where(small, 0, ds[2] * 65536 + ds[3] * 256 + ds[4])
    keyA = jnp.where(valid, keyA, (1 << 24) + iota)
    keyB = jnp.where(valid, keyB, 0)
    k0 = jnp.where(small, jnp.int32(1), jnp.int32(6))
    return keyA, keyB, k0


@functools.partial(jax.jit, static_argnames=("capacity",))
def bwt_encode(block: jnp.ndarray, n: jnp.ndarray, *, capacity: int | None = None):
    """BWT of the rotations of ``block[:n]``.

    Args:
      block: (capacity,) uint8, contents beyond ``n`` ignored.
      n: scalar int32 valid length, 1 <= n <= capacity.

    Returns:
      (last, orig_ptr): (capacity,) uint8 last column (zero-padded past n)
      and the sorted position of rotation 0.
    """
    if capacity is None:
        capacity = block.shape[-1]
    cap = capacity
    iota = jnp.arange(cap, dtype=jnp.int32)
    valid = iota < n
    data = block.astype(jnp.int32)

    # --- round 0: rank over 3 chars with one 24-bit key (2-operand
    # sort; lookahead chars are contiguous slices of a shifted image,
    # padding keys 2^24 + i sort last and stay singleton through every
    # re-rank). BZ2TPU_BWT_K0=6 switches to the 6-char double-key form
    # (see the _K0_CHARS note above).
    if _K0_CHARS >= 6:
        keyA, keyB, k0 = round0_keys6(data, n, cap)
        kA_s, kB_s, order = lax.sort((keyA, keyB, iota), num_keys=2)
        head = jnp.concatenate(
            [
                jnp.ones((1,), jnp.bool_),
                (kA_s[1:] != kA_s[:-1]) | (kB_s[1:] != kB_s[:-1]),
            ]
        )
    else:
        key0, k0 = round0_keys(data, n, cap)
        key_sorted, order = lax.sort((key0, iota), num_keys=1)
        head = jnp.concatenate(
            [jnp.ones((1,), jnp.bool_), key_sorted[1:] != key_sorted[:-1]]
        )
    rank = _inverse_permute(order, _head_positions(head))
    active = jnp.sum(_tied(head).astype(jnp.int32))
    if _SPARSE_ROUNDS:
        active_mask = jnp.zeros(cap, jnp.bool_).at[order].set(_tied(head))
    else:
        active_mask = jnp.zeros((1,), jnp.bool_)  # unused placeholder

    def shifted_rank(rank, k):
        """ext[j] = rank[j mod n] for j < 4n; reads reach i + 3k < 4n."""
        ext = jnp.concatenate([rank] + [jnp.zeros(cap, jnp.int32)] * 3)
        ext = lax.dynamic_update_slice(ext, rank, (n,))
        # ext[:2cap] now holds rank[j mod n] for j < 2n; replaying it at
        # offset 2n extends coverage to j < 4n.
        return lax.dynamic_update_slice(
            ext, lax.slice(ext, (0,), (2 * cap,)), (2 * n,)
        )

    # --- full quadrupling rounds (all positions) ------------------------
    def full_round(state):
        rank, sa, active_mask, active, k = state
        ext = shifted_rank(rank, k)
        s1 = jnp.where(valid, lax.dynamic_slice(ext, (k,), (cap,)), -1)
        s2 = jnp.where(valid, lax.dynamic_slice(ext, (2 * k,), (cap,)), -1)
        s3 = jnp.where(valid, lax.dynamic_slice(ext, (3 * k,), (cap,)), -1)
        k_r, k_1, k_2, k_3, order = lax.sort((rank, s1, s2, s3, iota), num_keys=5)
        head = jnp.concatenate(
            [
                jnp.ones((1,), jnp.bool_),
                (k_r[1:] != k_r[:-1])
                | (k_1[1:] != k_1[:-1])
                | (k_2[1:] != k_2[:-1])
                | (k_3[1:] != k_3[:-1]),
            ]
        )
        rank = _inverse_permute(order, _head_positions(head))
        tied = _tied(head)
        if _SPARSE_ROUNDS:
            active_mask = jnp.zeros(cap, jnp.bool_).at[order].set(tied)
        return rank, order, active_mask, jnp.sum(tied.astype(jnp.int32)), k * 4

    def full_cond(threshold):
        def cond(state):
            _, _, _, active, k = state
            return (active > threshold) & (k < n)

        return cond

    # --- sparse doubling rounds (tied positions only) ------------------
    def sparse_round(ccap):
        def round_(state):
            rank, sa, active_mask, active, k = state
            idx_a = jnp.nonzero(active_mask, size=ccap, fill_value=cap)[0].astype(
                jnp.int32
            )
            real = idx_a < cap
            safe = jnp.clip(idx_a, 0, cap - 1)
            r_a = jnp.where(real, rank[safe], (1 << 30))
            s_a = jnp.where(real, rank[jnp.where(real, (idx_a + k) % n, 0)], -1)
            r_s, s_s, i_s = lax.sort((r_a, s_a, idx_a), num_keys=3)
            r_head = jnp.concatenate(
                [jnp.ones((1,), jnp.bool_), r_s[1:] != r_s[:-1]]
            )
            head = r_head | jnp.concatenate(
                [jnp.ones((1,), jnp.bool_), s_s[1:] != s_s[:-1]]
            )
            pos = jnp.arange(ccap, dtype=jnp.int32)
            # Subgroup rank = old group base + offset of the subgroup head
            # within its (contiguous) old group.
            sub_head = lax.cummax(jnp.where(head, pos, 0))
            grp_head = lax.cummax(jnp.where(r_head, pos, 0))
            new_rank = r_s + (sub_head - grp_head)
            real_s = i_s < cap
            rank = rank.at[jnp.where(real_s, i_s, cap)].set(new_rank, mode="drop")
            sa = sa.at[jnp.where(real_s, new_rank, cap)].set(i_s, mode="drop")
            tied = _tied(head) & real_s
            active_mask = (
                jnp.zeros(cap, jnp.bool_)
                .at[jnp.where(tied, i_s, cap)]
                .set(True, mode="drop")
            )
            return rank, sa, active_mask, jnp.sum(tied.astype(jnp.int32)), k * 2

        return round_

    state = (rank, order, active_mask, active, k0)
    if _SPARSE_ROUNDS:
        # Sparse tiers pay off where sort bandwidth dominates: on text,
        # the rounds past ~24 chars touch a minority of positions. Opt-in
        # until a GPU measurement decides it (module docstring).
        ccap1 = max(cap // 4, 1024)
        ccap2 = max(cap // 16, 1024)
        state = lax.while_loop(full_cond(ccap1), full_round, state)
        state = lax.while_loop(
            lambda s: (s[3] > ccap2) & (s[3] > 0) & (s[4] < n),
            sparse_round(ccap1),
            state,
        )
        state = lax.while_loop(
            lambda s: (s[3] > 0) & (s[4] < n), sparse_round(ccap2), state
        )
        # Sparse rounds maintain sa lazily (a still-tied subgroup writes
        # only its head slot), so groups alive at the k >= n exit —
        # bit-identical rotations — would leave stale slots. One final
        # (rank, index) sort rebuilds sa completely with the index
        # tie-break, matching the full-round path's invariant.
        rank_f = state[0]
        _, sa = lax.sort((rank_f, iota), num_keys=2)
    else:
        state = lax.while_loop(full_cond(0), full_round, state)
        sa = state[1]

    orig_ptr = jnp.argmax(sa == 0).astype(jnp.int32)
    prev = jnp.where(sa == 0, n - 1, sa - 1)  # mod-free: 0 <= sa < cap
    last = jnp.where(valid, block[prev], 0).astype(jnp.uint8)
    return last, orig_ptr


bwt_encode_batch = jax.jit(
    jax.vmap(lambda b, n: bwt_encode(b, n)), static_argnames=()
)
