"""MTF + RLE2 encoding as vectorized scans (JAX).

The reference runs move-to-front as a strictly sequential 256-entry list
update per BWT byte inside each work-item (reference kernel.cpp:2514-2649).
That recurrence vectorizes via two observations:

1. **Recency identity.** MTF rank of symbol s at position i equals the
   number of symbols whose last occurrence before i is later than s's last
   occurrence before i (never-seen symbols get virtual occurrence times
   -(dense(u)+1), reproducing the initial list order). Last-occurrence
   times for all 256 dense symbols are a running cummax over one-hot
   position times, computed chunk-by-chunk with a carried 256-lane maximum.

2. **Run collapsing.** rank_i == 0 iff seq[i] == seq[i-1], and repeats do
   not change the MTF list (the symbol is already at the front). So the
   dense (chunk, 256) work only needs the *run-collapsed* sequence — for
   BWT output (long symbol clusters) that is typically 3-10x shorter. The
   chunk loop is a lax.while_loop whose trip count tracks the collapsed
   length, so compute scales with data entropy, not block capacity.

Round 5 adds the batch form (`mtf_rle2_encode_batch`): the per-chunk lane
carry has a closed form (one scatter-max of per-chunk last-occurrences into
(B, n_chunks, 256) + an exclusive cummax over the chunk axis), which makes
every (block, chunk) slot independent. The batch scan then runs a single
while_loop over a COMPACTED live-slot list, so the trip count is
sum(m_b)/(lanes*chunk) instead of max(m_b)/chunk — a mixed batch no longer
pays the worst block's trip count on every lane.

RLE2 (zero-run RUNA/RUNB coding, reference kernel.cpp:2612-2640) is closed
form in the collapsed domain: the zero run preceding collapsed position k
has length gap_k = i_k - i_{k-1} - 1, a run of length z emits
m = floor(log2(z+1)) digits, and digit t is bit t of (z+1) (bijective
base 2). Each output position maps back to its collapsed span via a
span-start cummax fill and decodes from two packed int32 gathers (see
_rle2_emit); floor(log2) is exact integer bit-length via lax.clz, not
float log2.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

# Plain int (NOT jnp.int32): a module-scope jnp constant would initialize
# the XLA backend at import time, breaking jax.distributed.initialize in
# multi-host processes that import bz2tpu before calling it.
_NEG = -(1 << 30)
_MAX_RUN_DIGITS = 21  # floor(log2(900_001 + 1)) = 19; margin for any capacity


def _hist_by_sort(vals: jnp.ndarray, n_bins: int) -> jnp.ndarray:
    """Histogram of ``vals`` into bins 0..n_bins-1 via sort + searchsorted.

    Entries outside [0, n_bins) are ignored (map them to >= n_bins before
    calling, e.g. a sentinel). One 1-operand sort plus a 257-query binary
    search instead of a scatter-add pass; the sort form won on the
    hardware it was first tuned on and has not been re-measured on the
    GPU.
    """
    s = lax.sort((vals,), num_keys=1)[0]
    edges = jnp.arange(n_bins + 1, dtype=vals.dtype)
    cuts = jnp.searchsorted(s, edges, side="left")
    return (cuts[1:] - cuts[:-1]).astype(jnp.int32)


def _collapse(last: jnp.ndarray, n: jnp.ndarray):
    """Dense-symbol mapping + run collapse of one padded BWT column.

    Returns (cseq, cidx, m, used, n_in_use): cseq (cap,) int32 collapsed
    dense symbols (-1 padding), cidx (cap,) int32 original positions of
    the change points, m the collapsed length.
    """
    cap = last.shape[0]
    iota = jnp.arange(cap, dtype=jnp.int32)
    valid = iota < n
    lasti = last.astype(jnp.int32)

    used_counts = _hist_by_sort(jnp.where(valid, lasti, 256), 256)
    used = used_counts > 0
    n_in_use = jnp.sum(used.astype(jnp.int32))
    dense = jnp.cumsum(used.astype(jnp.int32)) - 1
    seq = jnp.where(valid, dense[lasti], -1)

    # Compaction by one 3-operand stable sort on a front/back key instead
    # of two masked scatters: change positions keep relative order at the
    # front, the rest sink (same sort-for-scatter choice as the BWT
    # re-rank, ops/bwt.py:_inverse_permute).
    prev = jnp.concatenate([jnp.full((1,), -2, jnp.int32), seq[:-1]])
    change = valid & (seq != prev)
    m = jnp.sum(change.astype(jnp.int32))  # collapsed length
    front_key = jnp.where(change, iota, cap + iota)
    _, cseq_s, cidx_s = lax.sort((front_key, seq, iota), num_keys=1)
    k_pos = jnp.arange(cap, dtype=jnp.int32)
    cseq = jnp.where(k_pos < m, cseq_s, -1)
    cidx = jnp.where(k_pos < m, cidx_s, 0)
    return cseq, cidx, m, used, n_in_use


def _mtf_ranks_collapsed(seq: jnp.ndarray, m: jnp.ndarray, n_in_use: jnp.ndarray, chunk: int) -> jnp.ndarray:
    """MTF ranks for a run-collapsed dense symbol sequence.

    seq: (cap,) int32 dense symbols, adjacent entries distinct, -1 padding
    beyond ``m``. Returns (cap,) int32 ranks (garbage at padding).
    """
    cap = seq.shape[0]
    pad = (-cap) % chunk
    seqp = jnp.pad(seq, (0, pad), constant_values=-1)
    n_chunks = seqp.shape[0] // chunk
    chunks = seqp.reshape(n_chunks, chunk)

    lanes = jnp.arange(256, dtype=jnp.int32)
    carry0 = jnp.where(lanes < n_in_use, -(lanes + 1), jnp.int32(_NEG))
    ranks0 = jnp.zeros((n_chunks, chunk), jnp.int32)

    def chunk_body(c, carry, ranks):
        seq_c = chunks[c]
        r, last_t = _chunk_ranks(seq_c, carry)
        # Lanes that occurred in this chunk move their (int32, global-time)
        # carry forward; absent lanes keep it.
        carry = jnp.where(last_t >= 0, c * chunk + last_t.astype(jnp.int32), carry)
        return carry, ranks.at[c].set(r)

    def cond(state):
        c, _, _ = state
        return c * chunk < m

    def body(state):
        c, carry, ranks = state
        carry, ranks = chunk_body(c, carry, ranks)
        return c + 1, carry, ranks

    _, _, ranks = lax.while_loop(cond, body, (jnp.int32(0), carry0, ranks0))
    return ranks.reshape(-1)[:cap]


def _chunk_ranks(seq_c: jnp.ndarray, carry: jnp.ndarray):
    """Ranks of one (chunk,) collapsed slice against a (256,) int32 carry.

    Rank of position i = #{lanes u: last-occurrence(u) before i >
    last-occurrence(s_i) before i}. With the carry folded into row 0,
    the INCLUSIVE cummax row i-1 is exactly "last occurrence before
    i" for every lane — including lane s_i itself (s_{i-1} != s_i in
    the collapsed domain), so the self lane never overcounts and no
    exclusive shift or extra maximum pass is needed.

    All (chunk, 256) arrays run in int16 — half the scan/compare
    traffic of int32. Local times fit 15 bits; the int32 carry enters
    as its RANK mapped to [-512, -257): carry values are distinct on
    used lanes and every unused lane (_NEG-tied, ranked arbitrarily)
    stays strictly below every used lane, so all comparisons are
    order-preserved.

    Returns (ranks (chunk,) int32, last_t (256,) int16 — last local
    occurrence time per lane, -(2^15) where absent).
    """
    chunk = seq_c.shape[0]
    lanes = jnp.arange(256, dtype=jnp.int32)
    t_local = jnp.arange(chunk, dtype=jnp.int32)
    k256 = jnp.arange(256, dtype=jnp.int32)
    order = jnp.argsort(carry)
    carry_v = (
        jnp.zeros(256, jnp.int32).at[order].set(k256) - 512
    ).astype(jnp.int16)
    onehot_t = jnp.where(
        seq_c[:, None] == lanes[None, :],
        t_local[:, None].astype(jnp.int16),
        jnp.int16(-32768),
    )
    arr = onehot_t.at[0].max(carry_v)
    incl = lax.cummax(arr, axis=0)
    self_idx = jnp.clip(seq_c, 0, 255)
    # Position 0 ranks against the carry; positions 1.. against row i-1.
    r0 = jnp.sum((carry > carry[self_idx[0]]).astype(jnp.int32))
    prev_rows = incl[:-1]  # rows 0..chunk-2 serve positions 1..chunk-1
    self_tail = jnp.take_along_axis(prev_rows, self_idx[1:, None], axis=1)
    r_tail = jnp.sum((prev_rows > self_tail).astype(jnp.int32), axis=1)
    r = jnp.concatenate([r0[None], r_tail])
    last_t = jnp.max(onehot_t, axis=0)
    return r, last_t


def _mtf_ranks_batch(
    cseqs: jnp.ndarray,
    ms: jnp.ndarray,
    n_in_uses: jnp.ndarray,
    chunk: int,
    lanes: int = 8,
) -> jnp.ndarray:
    """Load-balanced MTF ranks over a BATCH of collapsed sequences.

    cseqs: (B, cap) int32 collapsed dense symbols (-1 padding); ms (B,)
    collapsed lengths. Returns (B, cap) int32 ranks (garbage at padding).

    The per-block chunk recurrence only threads the 256-lane last-
    occurrence carry. That carry has a closed form: per-chunk last local
    occurrences (ONE masked scatter-max over all positions at once) run
    through an exclusive cummax over the chunk axis. Every (block, chunk)
    slot is then independent, so the scan iterates over a compacted list
    of LIVE slots `lanes` at a time — trip count sum(ceil(m_b/chunk)) /
    lanes instead of the vmapped-while form's max(ceil(m_b/chunk)), which
    a single low-collapse (random-data) block otherwise forces on the
    whole batch.
    """
    B, cap = cseqs.shape
    pad = (-cap) % chunk
    capp = cap + pad
    nch = capp // chunk
    lanes = min(lanes, B * nch)  # tiny test shapes: never slice past the slot list
    seqp = jnp.pad(cseqs, ((0, 0), (0, pad)), constant_values=-1)

    iota_flat = jnp.arange(capp, dtype=jnp.int32)
    t_local_all = iota_flat % chunk
    seg_all = iota_flat // chunk

    # --- closed-form carries -------------------------------------------
    # M[b, c, u] = last local occurrence of lane u in chunk c (-1 absent):
    # one scatter-max over every position (padding writes -1: a no-op).
    valid = seqp >= 0
    sym = jnp.where(valid, seqp, 0)
    tval = jnp.where(valid, t_local_all[None, :], -1).astype(jnp.int32)
    M = jnp.full((B, nch * 256), -1, jnp.int32)
    flat_idx = seg_all[None, :] * 256 + sym
    M = jax.vmap(lambda m_, i_, v_: m_.at[i_].max(v_))(M, flat_idx, tval)
    M = M.reshape(B, nch, 256)
    # Global last-occurrence time per lane BEFORE each chunk: exclusive
    # cummax over the chunk axis, seeded with the virtual initial-order
    # times -(lane+1) (unused lanes pinned far below every real value).
    lane_iota = jnp.arange(256, dtype=jnp.int32)
    carry0 = jnp.where(
        lane_iota[None, :] < n_in_uses[:, None], -(lane_iota[None, :] + 1), _NEG
    )
    gtimes = jnp.where(
        M >= 0, (jnp.arange(nch, dtype=jnp.int32) * chunk)[None, :, None] + M, _NEG
    )
    G = lax.cummax(
        jnp.concatenate([carry0[:, None, :], gtimes[:, :-1, :]], axis=1), axis=1
    )  # (B, nch, 256): carry before chunk c

    # --- compacted live-slot list --------------------------------------
    n_live = (ms + chunk - 1) // chunk  # chunks holding data, per block
    slot_b = jnp.repeat(jnp.arange(B, dtype=jnp.int32), nch)
    slot_c = jnp.tile(jnp.arange(nch, dtype=jnp.int32), B)
    live = slot_c < n_live[slot_b]
    # Stable sort: live slots first, original order preserved.
    sortkey = jnp.where(live, jnp.arange(B * nch, dtype=jnp.int32), B * nch + jnp.arange(B * nch, dtype=jnp.int32))
    _, cb, cc = lax.sort((sortkey, slot_b, slot_c), num_keys=1)
    t_total = jnp.sum(n_live)

    flat_seq = seqp.reshape(-1)
    t_local = jnp.arange(chunk, dtype=jnp.int32)
    ranks0 = jnp.zeros((B, capp), jnp.int32)

    def body(state):
        i, ranks = state
        bs = lax.dynamic_slice(cb, (i * lanes,), (lanes,))
        cs = lax.dynamic_slice(cc, (i * lanes,), (lanes,))
        starts = bs * capp + cs * chunk
        seq_rows = flat_seq[starts[:, None] + t_local[None, :]]
        carry_rows = G[bs, cs]
        r, _ = jax.vmap(_chunk_ranks)(seq_rows, carry_rows)
        # Overhang slots past t_total recompute slot (0,0) harmlessly
        # (idempotent: same inputs, same ranks).
        ranks = ranks.reshape(-1).at[(starts[:, None] + t_local[None, :]).reshape(-1)].set(
            r.reshape(-1)
        ).reshape(B, capp)
        return i + 1, ranks

    def cond(state):
        i, _ = state
        return i * lanes < t_total

    _, ranks = lax.while_loop(cond, body, (jnp.int32(0), ranks0))
    return ranks[:, :cap]


def _rle2_plan(
    cranks: jnp.ndarray,
    cidx: jnp.ndarray,
    m: jnp.ndarray,
    n: jnp.ndarray,
    used: jnp.ndarray,
    n_in_use: jnp.ndarray,
):
    """Collapsed-domain RLE2 planning (one block): every array the
    output-domain emission needs, with NO output-domain pass — so the
    emission itself can run over a compact width >= n_sym instead of the
    full block capacity (ops/pipeline.py round-5 compact-width note).
    """
    cap = cranks.shape[0]
    k_iota = jnp.arange(cap, dtype=jnp.int32)
    k_valid = k_iota < m
    # Zero run ending just before collapsed position k (repeats of the
    # previous symbol); collapsed position 0 with rank 0 (symbol already at
    # the list front) prepends one more zero to the run it starts.
    prev_idx = jnp.concatenate([jnp.zeros((1,), jnp.int32), cidx[:-1]])
    gap = jnp.where(k_iota > 0, cidx - prev_idx - 1, 0)
    r0_zero = cranks[0] == 0
    # Trailing repeats after the last change position.
    tail_gap = jnp.where(m > 0, n - 1 - cidx[jnp.maximum(m - 1, 0)], 0)

    # Each collapsed position k emits: digits(gap'_k) then (rank_k + 1),
    # where gap'_1 absorbs position 0 when r0_zero (and position 0 then
    # emits nothing). A virtual final slot k == m emits digits of the
    # trailing run. Emission counts:
    gap_eff = jnp.where((k_iota == 1) & r0_zero, gap + 1, gap)
    zp1 = jnp.where(k_valid, gap_eff, 0) + 1  # run+1; 1 when no run
    mdig = 31 - lax.clz(zp1)  # exact floor(log2(zp1)); 0 when zp1 == 1
    sym_here = k_valid & ~((k_iota == 0) & r0_zero)
    emit = jnp.where(k_valid, mdig + sym_here.astype(jnp.int32), 0)
    offsets = jnp.cumsum(emit) - emit
    total = offsets[-1] + emit[-1]

    has_emit = k_valid & (emit > 0)
    # Scatter targets for the span-start fill: positions are < total (in
    # bounds at ANY output width >= n_sym); dead slots carry an
    # out-of-range sentinel dropped by the emission's mode="drop" scatter.
    pos = jnp.where(has_emit, offsets, jnp.int32(1 << 30))
    kval = jnp.where(has_emit, k_iota, 0)
    w1 = (offsets << 9) | (cranks + 1)  # 21 + 9 bits

    # Trailing run digits + EOB. r0_zero with m == 1 means the whole block
    # is one symbol: the run is tail_gap + 1 zeros (position 0 included)
    # and no symbol was emitted.
    tz = jnp.where((m == 1) & r0_zero, tail_gap + 1, tail_gap)
    tzp1 = tz + 1
    tdig = 31 - lax.clz(jnp.maximum(tzp1, 1))
    eob = n_in_use + 1
    t_lane = jnp.arange(_MAX_RUN_DIGITS + 1, dtype=jnp.int32)
    tail_vals = jnp.where(
        t_lane < tdig,
        (tzp1 >> t_lane) & 1,
        jnp.where(t_lane == tdig, eob, -1),
    )
    return {
        "w1": w1,
        "zp1": zp1,
        "pos": pos,
        "kval": kval,
        "total": total,
        "tail_vals": tail_vals,
        "n_sym": total + tdig + 1,
        "used": used,
        "n_in_use": n_in_use,
    }


def _rle2_out(plan: dict, width: int, *, with_freqs: bool = True):
    """Output-domain RLE2 emission over a static ``width`` >= n_sym.

    Emission is scatter-free on the output side: span-start markers fill
    forward (scatter + cummax), then each output position decodes from two
    packed int32 gathers — (offset<<9 | rank+1) and run+1 — halving the
    round-3 form's four gathers; mdig re-derives exactly from run+1 via
    lax.clz bit-length. Every output-domain pass here scales with
    ``width``, so the compact pipeline hands in the quantized batch width
    instead of capacity + 2. Returns (symbols (width,), freqs (258,)).
    """
    j_iota = jnp.arange(width, dtype=jnp.int32)
    # Output position j belongs to the collapsed position k whose span
    # [offsets[k], offsets[k]+emit[k]) holds j — recovered by filling
    # span-start markers forward (one scatter + cummax); within the span
    # the per-k payload arrives as TWO packed int32 gathers. A single
    # int64 fill word would need one gather but x64 is disabled jax-wide.
    k_of = jnp.zeros(width + 1, jnp.int32).at[plan["pos"]].max(
        plan["kval"], mode="drop"
    )[:width]
    k_of = lax.cummax(k_of)
    w1_j = plan["w1"][k_of]
    zp1_j = plan["zp1"][k_of]
    t_of = j_iota - (w1_j >> 9)
    mdig_j = 31 - lax.clz(jnp.maximum(zp1_j, 1))
    body_val = jnp.where(
        t_of < mdig_j,
        (zp1_j >> t_of) & 1,  # RUNA/RUNB digit t of the preceding run
        w1_j & 0x1FF,  # the symbol (rank+1), after its run digits
    )
    total = plan["total"]
    out = jnp.full(width + _MAX_RUN_DIGITS + 2, -1, jnp.int32)
    otrash = out.shape[0] - 1
    out = out.at[:width].set(jnp.where(j_iota < total, body_val, -1))
    # Tail digits + EOB as one small dynamic slice at the end.
    out = lax.dynamic_update_slice(out, plan["tail_vals"], (total,))
    out = out.at[otrash].set(-1)
    out = out[:width]

    if not with_freqs:
        # The Huffman stage derives the block histogram as gfreq.sum(0)
        # from the per-group histogram it builds anyway (huffman_assign
        # freqs=None) — identical counts, one (width,) sort saved.
        return out, None
    freqs = _hist_by_sort(jnp.where(out >= 0, out, 258), 258)
    return out, freqs


def _rle2_emit(
    cranks: jnp.ndarray,
    cidx: jnp.ndarray,
    m: jnp.ndarray,
    n: jnp.ndarray,
    used: jnp.ndarray,
    n_in_use: jnp.ndarray,
):
    """RLE2 emission at the full (cap + 2) width: plan + out composed —
    the single source of truth shared with the compact pipeline."""
    cap = cranks.shape[0]
    plan = _rle2_plan(cranks, cidx, m, n, used, n_in_use)
    out, freqs = _rle2_out(plan, cap + 2)
    return {
        "symbols": out,
        "n_sym": plan["n_sym"],
        "used": used,
        "n_in_use": n_in_use,
        "freqs": freqs,
    }


@functools.partial(jax.jit, static_argnames=("chunk",))
def mtf_rle2_encode(
    last: jnp.ndarray,
    n: jnp.ndarray,
    *,
    chunk: int = 4096,
):
    """MTF + RLE2 encode the BWT last column (one block).

    Args:
      last: (cap,) uint8 BWT output, padding beyond ``n`` ignored.
      n: scalar int32 valid length.

    Returns dict with:
      symbols: (cap + 2,) int32 — MTF/RLE2 symbol stream (RUNA=0, RUNB=1,
        value j -> j+1, EOB=n_in_use+1), -1 padding; n_sym entries valid.
      n_sym: scalar int32 — number of symbols incl. EOB.
      used: (256,) bool — byte-presence map.
      n_in_use: scalar int32.
      freqs: (258,) int32 — symbol histogram over the valid stream.
    """
    if chunk > 32768:
        # The scan runs its (chunk, 256) arrays in int16; local times must
        # fit 15 bits or the cummax last-occurrence invariant breaks.
        raise ValueError(f"mtf chunk must be <= 32768, got {chunk}")
    cseq, cidx, m, used, n_in_use = _collapse(last, n)
    cranks = _mtf_ranks_collapsed(cseq, m, n_in_use, chunk)
    return _rle2_emit(cranks, cidx, m, n, used, n_in_use)


@functools.partial(jax.jit, static_argnames=("chunk",))
def mtf_rle2_plan(
    last: jnp.ndarray,
    n: jnp.ndarray,
    *,
    chunk: int = 4096,
):
    """Collapse + MTF ranks + collapsed-domain RLE2 plan for one block —
    ``mtf_rle2_encode`` minus the output-domain emission, which the
    compact pipeline runs later at a quantized width >= n_sym
    (ops/pipeline.emit_huff_pack_stage). Returns the _rle2_plan pytree."""
    if chunk > 32768:
        raise ValueError(f"mtf chunk must be <= 32768, got {chunk}")
    cseq, cidx, m, used, n_in_use = _collapse(last, n)
    cranks = _mtf_ranks_collapsed(cseq, m, n_in_use, chunk)
    return _rle2_plan(cranks, cidx, m, n, used, n_in_use)


@functools.partial(jax.jit, static_argnames=("chunk",))
def mtf_rle2_encode_batch(
    last: jnp.ndarray,
    ns: jnp.ndarray,
    *,
    chunk: int = 4096,
):
    """Batch MTF + RLE2: same per-block results as vmapped
    ``mtf_rle2_encode`` but with the load-balanced compacted-slot ranks
    scan (see _mtf_ranks_batch). last (B, cap) uint8, ns (B,) int32."""
    if chunk > 32768:
        raise ValueError(f"mtf chunk must be <= 32768, got {chunk}")
    cseq, cidx, m, used, n_in_use = jax.vmap(_collapse)(last, ns)
    cranks = _mtf_ranks_batch(cseq, m, n_in_use, chunk)
    return jax.vmap(_rle2_emit)(cranks, cidx, m, ns, used, n_in_use)
