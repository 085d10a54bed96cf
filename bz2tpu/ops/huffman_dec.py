"""Device canonical-Huffman decode of bzip2 symbol data.

The reference decodes strictly serially on the host: one canonical-code
bit loop per symbol (reference include/HuffmanStageDecoder.hpp:48-73,
include/BlockDecompressor.hpp:187-242). The serial chain is the code
boundaries: symbol k's bit offset depends on every previous code length.

Device formulation — *jump-map decode* (the FSM-composition idea expressed
over bit positions, which for a prefix-free code need no tree-node state):

  1. For EVERY bit position p in the block's symbol-data range, and each
     of the <=6 Huffman tables, resolve the code length len_t(p) that a
     code starting at p would have — a fully parallel pass: one 23-bit
     window gather per position, 20 limit comparisons per table.
  2. jump_t(p) = p + len_t(p) advances one symbol; pointer-doubling
     composes it into jump_t^50(p) (the whole-group advance) in 7 gathers
     (50 = 32+16+2).
  3. Group starts chain through the selector sequence with one scalar
     walk over the jump^50 maps — n_groups dependent gathers, the ONLY
     serial part, each O(1).
  4. One vectorized 50-step pass re-decodes every group's symbols at its
     now-known start.

Exactness is structural (no speculation): position 0 is a true boundary
and jump maps are exact at true boundaries, so every chained start is
exact; validation additionally checks that the bit after EOB equals the
block's known end bit (from the native marker scan), which any corrupt
stream fails before the CRC even runs.

Returns raw MTF/RLE2 symbols; run expansion + inverse MTF live in
bz2tpu/ops/mtf_dec.py.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from bz2tpu.format import constants as C

_KMAX = C.HUFFMAN_DECODE_MAX_ACCEPTED_LENGTH  # 20: codes longer are invalid
_LUT_BITS = 20  # code length is a function of the top 20 window bits
# int16 relative-delta jump composition: half the gather bytes for two
# more elementwise ops per pass. Off by default; not yet measured on the
# GPU (PERF.md, Findings).
_I16_JUMPS = os.environ.get("BZ2TPU_DEC_I16", "0") == "1"


@jax.jit
def build_len_luts(thr: jnp.ndarray) -> jnp.ndarray:
    """(U, 21) thresholds -> (U, 2^20) int8 code-length lookup tables.

    The length of a code starting at window value v23 is
    searchsorted(thr, v23, 'right') = #(thr[k] <= v23). Every threshold
    is a multiple of 8 for k <= 20 (thr[k] = (limit+1) << (23-k)), so
    the length is a function of v20 = v23 >> 3 alone and the LUT is a
    step function: one tiny scatter of the 21 boundaries + a cumsum.
    Build cost is ~1 pass of 2^20 per UNIQUE table; the decode then
    replaces every per-position searchsorted (a ~5-pass binary search)
    with ONE gather (amortized across a block bucket by same-table
    detection in runtime/device_decode.py)."""
    u = thr.shape[0]
    thr3 = jnp.clip(thr >> 3, 0, 1 << _LUT_BITS)
    # int8 throughout: counts max out at 21, and int32 intermediates
    # would cost ~268 MB of device scratch at the decoder's U_CAP=64.
    hist = jnp.zeros((u, (1 << _LUT_BITS) + 1), jnp.int8)
    hist = hist.at[
        jnp.arange(u, dtype=jnp.int32)[:, None], thr3
    ].add(jnp.int8(1))
    return jnp.cumsum(hist[:, :-1], axis=1, dtype=jnp.int8)


def decode_tables_arrays(
    tables: list,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Pack oracle (limit, base, perm, min_len) tuples into device arrays.

    Bit counts below min_len get limit -1 so no candidate value (all >= 0)
    can match them; counts beyond each table's max length get limit 2^23
    (above any 23-bit window value) so malformed streams still resolve to
    SOME length — the resulting symbol is garbage, which the exact end-bit
    validation and the downstream CRC reject.

    Also returns ``thr``: the 23-bit LEFT-JUSTIFIED acceptance thresholds
    thr[t, k] = min((limit[t,k]+1) << (23-k), 2^23). A window value v23
    decodes with length k iff v23 >> (23-k) <= limit[t,k] iff
    v23 < thr[t,k]; canonical construction makes thr nondecreasing in k
    (enforced here with a running max for robustness on junk tables), so
    the code length is ONE searchsorted over 21 thresholds instead of 20
    masked compare passes — the device decode's dominant elementwise cost.
    """
    n = len(tables)
    limit = np.full((6, _KMAX + 1), -1, dtype=np.int64)
    base = np.zeros((6, _KMAX + 1), dtype=np.int64)
    perm = np.zeros((6, C.HUFFMAN_MAX_ALPHABET), dtype=np.int32)
    for t, (lim, bas, prm, min_l) in enumerate(tables):
        for k in range(min_l, _KMAX + 1):
            v = lim[k] if k < lim.size else np.iinfo(np.int64).max
            limit[t, k] = min(int(v), 1 << 23)
            if k < bas.size:
                base[t, k] = int(bas[k])
        perm[t, : prm.size] = prm
    ks = np.arange(_KMAX + 1)
    thr = np.minimum((limit + 1) << (23 - ks)[None, :], 1 << 23)
    thr = np.maximum.accumulate(thr, axis=1)
    return (
        limit[:n].astype(np.int32),
        base[:n].astype(np.int32),
        perm[:n],
        thr[:n].astype(np.int32),
    )


def _window23(stream: jnp.ndarray, bitpos: jnp.ndarray) -> jnp.ndarray:
    """23-bit big-endian window value at each absolute bit position."""
    nb = stream.shape[0]
    byte_idx = bitpos >> 3
    bidx = jnp.clip(byte_idx[..., None] + jnp.arange(4, dtype=jnp.int32), 0, nb - 1)
    w = stream[bidx].astype(jnp.uint32)
    w32 = (w[..., 0] << 24) | (w[..., 1] << 16) | (w[..., 2] << 8) | w[..., 3]
    off = (bitpos & 7).astype(jnp.uint32)
    return ((w32 >> (jnp.uint32(9) - off)) & jnp.uint32((1 << 23) - 1)).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("max_groups", "n_bits_cap"))
def decode_symbol_data(
    stream: jnp.ndarray,
    start_bit: jnp.ndarray,
    end_bit: jnp.ndarray,
    selectors: jnp.ndarray,
    n_groups: jnp.ndarray,
    limit: jnp.ndarray,
    base: jnp.ndarray,
    perm: jnp.ndarray,
    eob: jnp.ndarray,
    thr: jnp.ndarray,
    lut: jnp.ndarray | None = None,
    lut_idx: jnp.ndarray | None = None,
    *,
    max_groups: int,
    n_bits_cap: int,
):
    """Decode one block's Huffman symbol data region.

    Args:
      stream: (NB,) uint8 packed compressed stream (whole stream; offsets
        are absolute bit positions into it).
      start_bit/end_bit: symbol-data bit range (end = next block/stream
        marker position from the native scan); end - start <= n_bits_cap.
      selectors: (max_groups,) int32 table id per 50-symbol group (padded).
      n_groups: scalar int32 true group count.
      limit/base/perm: (T, 21) / (T, 21) / (T, 258) int32 canonical tables
        (see decode_tables_arrays).
      eob: scalar int32 end-of-block symbol value (alpha_size - 1).
      thr: (T, 21) int32 nondecreasing left-justified thresholds
        (decode_tables_arrays): code length at v23 = searchsorted-right.
      lut/lut_idx: optional (U, 2^20) int8 code-length LUTs
        (build_len_luts) + (T,) int32 row index per table slot. The
        bucket driver shares LUT rows across same-table blocks; when
        omitted, per-call LUTs are built from thr.
      max_groups/n_bits_cap: static (quantized) shape bounds.

    Returns dict with symbols (max_groups*50,) int32 (-1 past n_sym),
    n_sym, and ok (bool: EOB lands exactly at end_bit).
    """
    n_tables = limit.shape[0]
    g_iota = jnp.arange(max_groups, dtype=jnp.int32)
    g_valid = g_iota < n_groups
    tbl = jnp.clip(selectors, 0, n_tables - 1)
    if lut is None:
        lut = build_len_luts(thr)
        lut_idx = jnp.arange(n_tables, dtype=jnp.int32)

    # --- 1. per-position code lengths, ALL tables in one gather ----------
    p_rel = jnp.arange(n_bits_cap, dtype=jnp.int32)
    v23 = _window23(stream, start_bit + p_rel)  # (n_bits_cap,)
    v20 = v23 >> 3
    lens_all = lut[lut_idx[:, None], v20[None, :]].astype(jnp.int32)  # (T, nbc)
    # No acceptable length (malformed stream): advance 1 bit, as before.
    lens_all = jnp.where(lens_all > _KMAX, 1, jnp.maximum(lens_all, 1))

    # --- 2. 50-symbol jumps via pointer doubling, all tables fused -------
    # One flattened (T * nbc,) map (offsets keep each table's jumps inside
    # its own segment): 7 composition gathers TOTAL instead of 7 per
    # table — same elements moved, 6x fewer dispatches.
    seg = (jnp.arange(n_tables, dtype=jnp.int32) * n_bits_cap)[:, None]
    if _I16_JUMPS:
        # int16 RELATIVE composition: a 50-symbol advance is
        # <= 50*20 = 1000 bits, so every composed jump fits int16 as a
        # DELTA — the 7 gather passes move half the bytes (2 vs 4 B per
        # element) at the cost of re-deriving absolute indices (+2 fused
        # elementwise ops per pass). Worthwhile iff the backend prices
        # gathers by bytes rather than per element.
        p_flat = jnp.broadcast_to(p_rel[None, :], (n_tables, n_bits_cap)).reshape(-1)
        seg_flat = jnp.broadcast_to(seg, (n_tables, n_bits_cap)).reshape(-1)
        d = lens_all.astype(jnp.int16).reshape(-1)

        def compose(d_a, d_b):
            # d_{a+b}[p] = clip-composition matching the absolute form.
            nxt = jnp.minimum(p_flat + d_a.astype(jnp.int32), n_bits_cap - 1)
            total = jnp.minimum(
                nxt + d_b[seg_flat + nxt].astype(jnp.int32), n_bits_cap - 1
            )
            return (total - p_flat).astype(jnp.int16)

        d2 = compose(d, d)
        d16 = d2
        for _ in range(3):  # d4, d8, d16
            d16 = compose(d16, d16)
        d32 = compose(d16, d16)
        d50 = compose(compose(d2, d16), d32)  # 2 + 16 + 32 = 50 forward
        jump50 = jnp.minimum(
            p_rel[None, :] + d50.reshape(n_tables, n_bits_cap).astype(jnp.int32),
            n_bits_cap - 1,
        )
    else:
        j_all = (jnp.minimum(p_rel[None, :] + lens_all, n_bits_cap - 1) + seg).reshape(-1)
        j2 = j_all[j_all]
        j16 = j2
        for _ in range(3):  # j4, j8, j16
            j16 = j16[j16]
        j32 = j16[j16]
        j50 = j32[j16[j2]]  # 32 + 16 + 2 = 50 symbols forward
        jump50 = j50.reshape(n_tables, n_bits_cap) - seg

    # --- 3. serial group chain (the only sequential part) ----------------
    def chain_step(g, carry):
        cur, starts = carry
        starts = starts.at[g].set(cur)
        nxt = jump50[tbl[g], jnp.clip(cur, 0, n_bits_cap - 1)]
        return jnp.where(g < n_groups, nxt, cur), starts

    _, starts_rel = jax.lax.fori_loop(
        0, max_groups, chain_step, (jnp.int32(0), jnp.zeros(max_groups, jnp.int32))
    )
    starts = start_bit + starts_rel

    # --- 4. vectorized symbol extraction at known starts -----------------
    lut_g = lut_idx[tbl]
    base_g = base[tbl]
    perm_g = perm[tbl]

    def step(i, carry):
        offs, syms, lens = carry
        v = _window23(stream, offs)  # (G,)
        l = lut[lut_g, v >> 3].astype(jnp.int32)
        matched = l <= _KMAX
        l = jnp.where(matched, jnp.maximum(l, 1), 1)
        code = v >> (23 - l)
        pidx = code - jnp.take_along_axis(base_g, l[:, None], axis=1)[:, 0]
        bad = (~matched) | (pidx < 0) | (pidx >= C.HUFFMAN_MAX_ALPHABET)
        sym = jnp.take_along_axis(
            perm_g, jnp.clip(pidx, 0, C.HUFFMAN_MAX_ALPHABET - 1)[:, None], axis=1
        )[:, 0]
        sym = jnp.where(bad, -2, sym)
        syms = syms.at[:, i].set(sym)
        lens = lens.at[:, i].set(l)
        return offs + l, syms, lens

    zero = jnp.zeros((max_groups, C.HUFFMAN_GROUP_SIZE), jnp.int32)
    _, syms, lens = jax.lax.fori_loop(
        0, C.HUFFMAN_GROUP_SIZE, step, (starts, zero, zero)
    )

    # --- EOB trim + exact validation -------------------------------------
    flat_syms = syms.reshape(-1)
    flat_lens = lens.reshape(-1)
    sym_valid = jnp.repeat(g_valid, C.HUFFMAN_GROUP_SIZE)
    is_eob = (flat_syms == eob) & sym_valid
    any_eob = jnp.any(is_eob)
    n_sym = jnp.argmax(is_eob).astype(jnp.int32) + 1
    keep = jnp.arange(flat_syms.shape[0], dtype=jnp.int32) < n_sym
    out_syms = jnp.where(keep, flat_syms, -1)
    bits_used = jnp.sum(jnp.where(keep & sym_valid, flat_lens, 0))
    end_ok = (start_bit + bits_used) == end_bit
    no_bad = ~jnp.any(keep & (flat_syms == -2))
    fits = (end_bit - start_bit) <= n_bits_cap
    ok = any_eob & end_ok & no_bad & fits
    return {"symbols": out_syms, "n_sym": n_sym, "ok": ok}
