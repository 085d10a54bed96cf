"""Multi-table Huffman stage (JAX), semantics of stock bzip2 sendMTFValues.

The reference computes this serially per work-item (reference
kernel.cpp:2651-3096): cumulative-frequency table seeding, 4 refinement
iterations of per-group cheapest-table selection, per-table length-limited
Huffman rebuilds, canonical code assignment. Here:

- the group x table cost matrix is a (max_selectors, 258) @ (258, 6) matmul
  — the refinement inner loop the reference walks group-by-group
  (kernel.cpp:2908-2934) becomes one matrix product per iteration;
- per-table frequency accumulation is the transposed matmul
  (6, max_selectors) @ (max_selectors, 258);
- both products run in float32 at ``Precision.HIGHEST`` (``_exact_dot``),
  so they stay exact whatever the backend's default float32 matmul mode
  (TF32 on some GPUs): operands are integers below 2^11 and every sum
  stays below 2^24;
- tree construction (reference allocateHuffmanCodeLengths,
  kernel.cpp:2661-2806; two-queue over sorted weights) is a lax.scan of 257
  tiny steps, vmapped over all 6 tables of every block in the batch, with
  leaf depths extracted by parent-pointer doubling (10 batched gathers)
  instead of a sequential tree walk;
- everything is fixed-shape: 6 table rows and 258 symbol lanes always exist,
  tables >= n_groups and symbols >= alpha_size are masked.

All decisions (tie-breaks, seeding parity adjustment, depth-cap flattening
f -> 1 + f/2) match the scalar oracle bit-for-bit so the emitted stream is
deterministic across backends.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from bz2tpu.format import constants as C

_ALPHA = C.HUFFMAN_MAX_ALPHABET  # 258
_NTAB = C.HUFFMAN_MAX_TABLES  # 6
# Plain ints (NOT jnp.int32): module-scope jnp constants would initialize
# the XLA backend at import time, breaking jax.distributed.initialize in
# multi-host processes that import bz2tpu before calling it.
_INF_W = 1 << 30
_NEG = -(1 << 30)


def max_selectors(capacity: int) -> int:
    """Static selector-array size for a given block capacity."""
    return (capacity + 1 + C.HUFFMAN_GROUP_SIZE - 1) // C.HUFFMAN_GROUP_SIZE + 1


def table_count(n_sym: jnp.ndarray) -> jnp.ndarray:
    """Dynamic form of constants.table_count_for_symbols (2..6 tables)."""
    count = jnp.int32(C.HUFFMAN_MIN_TABLES)
    for t in C.TABLE_COUNT_THRESHOLDS:
        count = count + (n_sym >= t).astype(jnp.int32)
    return count


# --------------------------------------------------------------------------
# Length-limited Huffman code lengths (two-queue, scan form)
# --------------------------------------------------------------------------


def _huffman_depths(weights: jnp.ndarray, alpha: jnp.ndarray) -> jnp.ndarray:
    """Leaf depths of the Huffman tree over weights[:alpha] (two-queue).

    weights: (258,) int32, entries >= alpha ignored. Returns (258,) int32
    depths (0 for ignored symbols). Matches oracle _huffman_depths: stable
    ascending leaf order, leaf preferred over internal on weight ties.
    """
    lanes = jnp.arange(_ALPHA, dtype=jnp.int32)
    valid = lanes < alpha
    w_key = jnp.where(valid, weights, _INF_W)
    leaf_w, order = lax.sort((w_key, lanes), num_keys=1, is_stable=True)

    n_nodes = 2 * _ALPHA - 1  # leaves addressed by symbol id, internals 258+j
    parent0 = jnp.arange(n_nodes, dtype=jnp.int32)  # self-parent = unpicked
    node_w0 = jnp.full(_ALPHA - 1, _INF_W, jnp.int32)

    def pick(li, ii, j, node_w):
        leaf_avail = li < alpha
        node_avail = ii < j
        lw = jnp.where(leaf_avail, leaf_w[li], _INF_W)
        nw = jnp.where(node_avail, node_w[ii], _INF_W)
        take_leaf = leaf_avail & (~node_avail | (lw <= nw))
        pick_id = jnp.where(take_leaf, order[li], _ALPHA + ii)
        pick_w = jnp.where(take_leaf, lw, nw)
        return (
            li + take_leaf.astype(jnp.int32),
            ii + (~take_leaf).astype(jnp.int32),
            pick_id,
            pick_w,
        )

    def step(carry, j):
        li, ii, node_w, parent = carry
        active = j < alpha - 1
        li1, ii1, p0, w0 = pick(li, ii, j, node_w)
        li2, ii2, p1, w1 = pick(li1, ii1, j, node_w)
        internal = _ALPHA + j
        node_w = node_w.at[j].set(jnp.where(active, w0 + w1, _INF_W))
        # Inactive steps scatter into a trash row beyond the array.
        t0 = jnp.where(active, p0, n_nodes)
        t1 = jnp.where(active, p1, n_nodes)
        parent = parent.at[t0].set(internal, mode="drop")
        parent = parent.at[t1].set(internal, mode="drop")
        li = jnp.where(active, li2, li)
        ii = jnp.where(active, ii2, ii)
        return (li, ii, node_w, parent), None

    js = jnp.arange(_ALPHA - 1, dtype=jnp.int32)
    (_, _, _, parent), _ = lax.scan(
        step, (jnp.int32(0), jnp.int32(0), node_w0, parent0), js
    )

    # Depth = number of parent hops to the root (self-parented), by doubling.
    hop = (parent != jnp.arange(n_nodes, dtype=jnp.int32)).astype(jnp.int32)
    jump = parent
    for _ in range(10):  # 2^10 > max possible depth (257)
        hop = hop + hop[jump]
        jump = jump[jump]
    return jnp.where(valid, hop[:_ALPHA], 0)


def code_lengths(freqs: jnp.ndarray, alpha: jnp.ndarray) -> jnp.ndarray:
    """Length-limited code lengths for one table (oracle make_code_lengths).

    freqs: (258,) int32. Returns (258,) int32 lengths in 1..17 for
    symbols < alpha, 0 beyond.
    """
    lanes = jnp.arange(_ALPHA, dtype=jnp.int32)
    valid = lanes < alpha
    w0 = jnp.where(valid, jnp.maximum(freqs, 1), 0)
    d0 = _huffman_depths(w0, alpha)

    def cond(state):
        _, d = state
        return jnp.max(d) > C.HUFFMAN_ENCODE_MAX_LENGTH

    def body(state):
        w, _ = state
        w = jnp.where(valid, 1 + (w >> 1), 0)
        return w, _huffman_depths(w, alpha)

    _, depths = lax.while_loop(cond, body, (w0, d0))
    return depths


code_lengths_tables = jax.vmap(code_lengths, in_axes=(0, None))


# --------------------------------------------------------------------------
# Table seeding (oracle huffman_plan seeding / kernel.cpp:2859-2893)
# --------------------------------------------------------------------------


def seed_lengths(freqs: jnp.ndarray, n_groups: jnp.ndarray, alpha: jnp.ndarray) -> jnp.ndarray:
    """Initial (6, 258) length rows: 0 inside each table's frequency span,
    15 outside. Table t's span is filled from the highest row index down."""
    fp = jnp.concatenate([jnp.zeros(1, jnp.int32), jnp.cumsum(freqs)])  # (259,)

    def body(t, state):
        lengths, gs, rem_f = state
        active = t < n_groups
        t_freq = rem_f // jnp.maximum(n_groups - t, 1)
        prefix = fp[gs]
        # First ge >= gs with span frequency >= t_freq, capped at alpha-1;
        # a non-positive target leaves the span empty (ge = gs - 1).
        found = jnp.searchsorted(fp[1:], prefix + t_freq, side="left").astype(jnp.int32)
        ge = jnp.where(
            t_freq <= 0,
            gs - 1,
            jnp.minimum(jnp.maximum(found, gs), alpha - 1),
        )
        adj = (ge > gs) & (t != 0) & (t != n_groups - 1) & ((t % 2) == 1)
        ge = ge - adj.astype(jnp.int32)
        a_freq = fp[ge + 1] - prefix
        row = n_groups - 1 - t
        lanes = jnp.arange(_ALPHA, dtype=jnp.int32)
        in_span = (lanes >= gs) & (lanes <= ge)
        new_row = jnp.where(in_span, 0, lengths[row])
        lengths = jnp.where(active, lengths.at[row].set(new_row), lengths)
        gs = jnp.where(active, ge + 1, gs)
        rem_f = jnp.where(active, rem_f - a_freq, rem_f)
        return lengths, gs, rem_f

    lengths0 = jnp.full((_NTAB, _ALPHA), 15, jnp.int32)
    lengths, _, _ = lax.fori_loop(
        0, _NTAB, body, (lengths0, jnp.int32(0), jnp.sum(freqs))
    )
    return lengths


# --------------------------------------------------------------------------
# Group frequencies + refinement (oracle huffman_plan loop)
# --------------------------------------------------------------------------


def _exact_dot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """float32 matrix product pinned to full precision (module docstring):
    exact for the small-integer operands this module multiplies."""
    return jnp.dot(a, b, precision=lax.Precision.HIGHEST)


def group_frequencies(symbols: jnp.ndarray, maxsel: int) -> jnp.ndarray:
    """(maxsel, 258) histogram of symbols per 50-symbol group."""
    S = symbols.shape[0]
    gid = jnp.arange(S, dtype=jnp.int32) // C.HUFFMAN_GROUP_SIZE
    sym_valid = symbols >= 0
    flat = gid * _ALPHA + jnp.clip(symbols, 0, _ALPHA - 1)
    gfreq = jnp.zeros(maxsel * _ALPHA, jnp.int32).at[
        jnp.where(sym_valid, flat, maxsel * _ALPHA)
    ].add(1, mode="drop")
    return gfreq.reshape(maxsel, _ALPHA)


@functools.partial(jax.jit, static_argnames=("maxsel",))
def huffman_assign(
    symbols: jnp.ndarray,
    n_sym: jnp.ndarray,
    freqs: jnp.ndarray | None,
    n_in_use: jnp.ndarray,
    *,
    maxsel: int,
):
    """Full Huffman planning for one block.

    ``freqs`` (the (258,) whole-block histogram) may be None: it is
    exactly ``gfreq.sum(axis=0)`` of the per-group histogram computed
    here anyway, so passing None drops the caller's separate full-width
    histogram pass (a (width,) sort per block, ops/mtf._hist_by_sort).

    Returns dict: n_groups, n_selectors, selectors (maxsel,), selector_mtf
    (maxsel,), lengths (6,258), codes (6,258) — entries beyond the valid
    alphabet/tables/selector count are don't-care.
    """
    alpha = n_in_use + 2
    n_groups = table_count(n_sym)
    n_sel = (n_sym + C.HUFFMAN_GROUP_SIZE - 1) // C.HUFFMAN_GROUP_SIZE
    gfreq = group_frequencies(symbols, maxsel)
    if freqs is None:
        freqs = jnp.sum(gfreq, axis=0)
    gfreq_f = gfreq.astype(jnp.float32)

    lengths = seed_lengths(freqs, n_groups, alpha)
    table_mask = jnp.arange(_NTAB) < n_groups
    group_valid = jnp.arange(maxsel, dtype=jnp.int32) < n_sel
    selectors = jnp.zeros(maxsel, jnp.int32)

    def iterate(state):
        i, lengths, selectors, _, snap = state
        cost = _exact_dot(gfreq_f, lengths.astype(jnp.float32).T)  # (maxsel, 6)
        cost = jnp.where(table_mask[None, :], cost, jnp.float32(jnp.inf))
        new_sel = jnp.argmin(cost, axis=1).astype(jnp.int32)
        # Fixed point: the assignment repeated, so rfreq — and therefore
        # the refit lengths — cannot change either. (i > 0 guards the
        # zeros init coinciding with a real all-table-0 argmin before any
        # length refit has happened.)
        done = (i > 0) & jnp.all(new_sel == selectors)
        onehot = (
            (new_sel[:, None] == jnp.arange(_NTAB)[None, :]) & group_valid[:, None]
        ).astype(jnp.float32)
        rfreq = _exact_dot(onehot.T, gfreq_f).astype(jnp.int32)  # (6, 258)
        lengths = jnp.where(done, lengths, code_lengths_tables(rfreq, alpha))
        # Snapshot stock's operating point: the state after exactly 4
        # refinement iterations (libbz2 BZ_N_ITERS, kernel.cpp:2908-2934
        # runs the loop a fixed 4 times). Converging PAST it minimizes
        # SYMBOL bits monotonically but can grow the selector-MTF unary
        # stream and the delta-coded table headers — on a level-6 sweep
        # the converged point came out 0.006% ABOVE stock's size. The
        # end of huffman_assign picks whichever candidate has
        # fewer TOTAL bits, restoring ratio <= stock wherever the
        # iter-4 state matches stock's.
        take = i == 3
        snap = (
            jnp.where(take, lengths, snap[0]),
            jnp.where(take, new_sel, snap[1]),
        )
        return i + 1, lengths, new_sel, done, snap

    def not_converged(state):
        i, _, _, done, _ = state
        return (i < C.HUFFMAN_REFINE_ITERS) & ~done

    i_fin, lengths, selectors, _, snap = lax.while_loop(
        not_converged,
        iterate,
        (jnp.int32(0), lengths, selectors, jnp.bool_(False),
         (lengths, selectors)),
    )
    # Early convergence (exit before 5 iterations ran) means the iter-4
    # state IS the converged state; the placeholder snapshot is stale
    # seeding then, so fall back to the converged candidate.
    snapped = i_fin > 3
    lengths4 = jnp.where(snapped, snap[0], lengths)
    selectors4 = jnp.where(snapped, snap[1], selectors)

    def total_bits(lg, sel):
        """Exact stream bits that DEPEND on (lengths, selectors): symbol
        codes + selector unaries + delta-coded table rows (the emission
        formulas of ops/emit.block_header_parts, bit-for-bit). All int32:
        the matmul's per-table counts stay < 2^24 (exact in f32) but the
        bit TOTAL reaches ~1.8e7 * 20, which f32 would round."""
        onehot = (
            (sel[:, None] == jnp.arange(_NTAB)[None, :]) & group_valid[:, None]
        ).astype(jnp.float32)
        rfreq = _exact_dot(onehot.T, gfreq_f).astype(jnp.int32)  # (6, 258)
        sym_bits = jnp.sum(rfreq * lg)
        mtf = selector_mtf_ranks(sel, n_sel)
        sel_bits = jnp.sum(
            jnp.where(jnp.arange(sel.shape[0]) < n_sel, mtf + 1, 0)
        )
        lanes = jnp.arange(_ALPHA, dtype=jnp.int32)
        tmask = (jnp.arange(_NTAB)[:, None] < n_groups) & (lanes[None, :] < alpha)
        prev = jnp.concatenate([lg[:, :1], lg[:, :-1]], axis=1)
        tab_bits = jnp.sum(jnp.where(tmask, 2 * jnp.abs(lg - prev) + 1, 0))
        return sym_bits + sel_bits + tab_bits

    prefer4 = total_bits(lengths4, selectors4) < total_bits(lengths, selectors)
    lengths = jnp.where(prefer4, lengths4, lengths)
    selectors = jnp.where(prefer4, selectors4, selectors)
    codes = canonical_codes(lengths, alpha)
    sel_mtf = selector_mtf_ranks(selectors, n_sel)
    return {
        "n_groups": n_groups,
        "n_selectors": n_sel,
        "selectors": selectors,
        "selector_mtf": sel_mtf,
        "lengths": lengths,
        "codes": codes,
    }


# --------------------------------------------------------------------------
# Canonical code assignment (oracle assign_canonical_codes)
# --------------------------------------------------------------------------


def _canonical_row(lengths: jnp.ndarray, alpha: jnp.ndarray) -> jnp.ndarray:
    lanes = jnp.arange(_ALPHA, dtype=jnp.int32)
    valid = lanes < alpha
    L = jnp.where(valid, lengths, 0)
    onehot = (L[:, None] == jnp.arange(1, 21)[None, :]) & valid[:, None]  # (258, 20)
    counts = jnp.sum(onehot.astype(jnp.int32), axis=0)  # per length 1..20
    # base[l] = first code value at length l (canonical).
    def body(b, carry):
        vec, base = carry
        base = base.at[b].set(vec)
        vec = (vec + counts[b]) << 1
        return vec, base

    _, base = lax.fori_loop(0, 20, body, (jnp.int32(0), jnp.zeros(20, jnp.int32)))
    # Rank among same-length symbols in symbol order (exclusive cumsum).
    rank = jnp.cumsum(onehot.astype(jnp.int32), axis=0) - onehot.astype(jnp.int32)
    rank_self = jnp.sum(rank * onehot.astype(jnp.int32), axis=1)
    base_self = base[jnp.clip(L - 1, 0, 19)]
    return jnp.where(valid & (L > 0), base_self + rank_self, 0)


canonical_codes = jax.vmap(_canonical_row, in_axes=(0, None))


# --------------------------------------------------------------------------
# Selector MTF ranks (recency identity over 6 lanes)
# --------------------------------------------------------------------------


def selector_mtf_ranks(selectors: jnp.ndarray, n_sel: jnp.ndarray) -> jnp.ndarray:
    """MTF rank of each selector against the running table list."""
    maxsel = selectors.shape[0]
    lanes = jnp.arange(_NTAB, dtype=jnp.int32)
    pos = jnp.arange(maxsel, dtype=jnp.int32)
    sel = jnp.where(pos < n_sel, selectors, -1)
    times = jnp.where(sel[:, None] == lanes[None, :], pos[:, None], _NEG)
    incl = lax.cummax(times, axis=0)
    excl = jnp.concatenate([jnp.full((1, _NTAB), _NEG, jnp.int32), incl[:-1]], axis=0)
    init = -(lanes + 1)
    last = jnp.maximum(init[None, :], excl)
    self_idx = jnp.clip(sel, 0, _NTAB - 1)
    last_self = jnp.take_along_axis(last, self_idx[:, None], axis=1)
    return jnp.sum((last > last_self).astype(jnp.int32), axis=1)
