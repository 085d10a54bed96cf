"""Oracle bzip2 encoder: scalar/NumPy, bit-exact standard .bz2 output.

Stage-by-stage port of the bzip2 algorithm's *semantics* (what the reference
implements across include/BlockCompressor.hpp (RLE1+CRC intake) and
kernel.cpp K3-K6 (BWT, MTF+RLE2, multi-table Huffman, bit emission)), at the
standard 100k-900k block scale. Each stage is a standalone function so the
JAX kernels in bz2tpu/ops can be differential-tested against it.

Output need not be byte-identical to stock bzip2 (table seeding / tie
decisions are encoder freedom) but must decode via stock bzip2 to the exact
input at a comparable compressed size.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from bz2tpu.format import constants as C
from bz2tpu.format.bitio import BitWriter
from bz2tpu.format.crc32 import crc32, stream_crc


# --------------------------------------------------------------------------
# Stage 1: RLE1 — run-length pre-pass (reference BlockCompressor.hpp:134-154)
# --------------------------------------------------------------------------


@dataclass
class Rle1Block:
    data: np.ndarray  # RLE1-encoded bytes (uint8)
    raw_length: int  # original bytes consumed by this block
    crc: int  # CRC-32/BZIP2 over the original bytes


def _run_pieces(data: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Split input into RLE1 'pieces': independent encoding units.

    A run of length L becomes floor(L/255) pieces of 255 raw bytes (5 output
    bytes each: 4 literals + count 251) plus a final piece of L%255 raw bytes
    (1-3 literals, or 4 literals + count). Pieces re-start the run state, so
    a block may be cut at any piece boundary without changing any encoding —
    this is what makes block splitting vectorizable.

    Returns (piece_values, piece_raw_lens, piece_out_lens).
    """
    n = data.size
    if n == 0:
        z = np.zeros(0, dtype=np.int64)
        return z.astype(np.uint8), z, z
    change = np.empty(n, dtype=bool)
    change[0] = True
    np.not_equal(data[1:], data[:-1], out=change[1:])
    starts = np.flatnonzero(change)
    lens = np.diff(np.append(starts, n))
    vals = data[starts]
    full = lens // 255
    rem = lens % 255
    # Expand: each run i contributes full[i] pieces of 255 + (rem[i]>0) piece.
    counts = full + (rem > 0)
    piece_vals = np.repeat(vals, counts)
    piece_lens = np.full(int(counts.sum()), 255, dtype=np.int64)
    # Positions of final (remainder) pieces within the expanded array.
    ends = np.cumsum(counts)
    has_rem = rem > 0
    piece_lens[ends[has_rem] - 1] = rem[has_rem]
    out_lens = np.where(piece_lens >= C.RLE1_MIN_RUN, 5, piece_lens)
    return piece_vals, piece_lens, out_lens


def _emit_pieces(vals: np.ndarray, raw_lens: np.ndarray, out_lens: np.ndarray) -> np.ndarray:
    """Materialize RLE1 output bytes for a sequence of pieces (vectorized)."""
    lit_counts = np.minimum(raw_lens, C.RLE1_MIN_RUN)
    total = int(out_lens.sum())
    out = np.empty(total, dtype=np.uint8)
    # Literal bytes.
    ends = np.cumsum(out_lens)
    starts = ends - out_lens
    lit_idx = np.repeat(starts, lit_counts) + _ragged_arange(lit_counts)
    out[lit_idx] = np.repeat(vals, lit_counts)
    # Count bytes for pieces >= 4 raw bytes.
    counted = raw_lens >= C.RLE1_MIN_RUN
    out[ends[counted] - 1] = (raw_lens[counted] - C.RLE1_MIN_RUN).astype(np.uint8)
    return out


def _ragged_arange(counts: np.ndarray) -> np.ndarray:
    """[0..c0-1, 0..c1-1, ...] for counts array (classic cumsum trick)."""
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    ids = np.repeat(np.cumsum(counts) - counts, counts)
    return np.arange(total, dtype=np.int64) - ids


def rle1_split(data: np.ndarray, level: int) -> list[Rle1Block]:
    """RLE1-encode `data` and split into blocks, stock bzip2's fill rule.

    CRC is over the *original* bytes of each block (reference
    BlockCompressor.hpp:137). Cuts follow bzlib EXACTLY (verified against
    libbz2's own block spans, tests/test_native.py): pieces flush while
    the block's output is < block_capacity (= nblockMAX, 100000*level -
    19), so the block ends at the FIRST CROSSING piece — overshoot up to
    4 bytes — and the in-progress run carries entirely into the next
    block (stock's mid-stream compressBlock runs WITHOUT flush_RL).
    Matching stock's boundaries makes every block's content identical to
    libbz2's (round 5: the level-6 sweep's +0.006% ratio was entirely
    boundary drift).
    """
    data = np.ascontiguousarray(data, dtype=np.uint8)
    cap = C.block_capacity(level)
    vals, raw_lens, out_lens = _run_pieces(data)
    blocks: list[Rle1Block] = []
    if vals.size == 0:
        return blocks
    out_cum = np.cumsum(out_lens)
    raw_cum = np.cumsum(raw_lens)
    n_pieces = vals.size
    piece0 = 0
    out_base = 0
    raw_base = 0
    while piece0 < n_pieces:
        # First piece whose cumulative output reaches cap (inclusive cut);
        # no crossing -> the rest is the final block.
        k = int(np.searchsorted(out_cum, out_base + cap, side="left"))
        k = min(k, n_pieces - 1)
        sl = slice(piece0, k + 1)
        block_bytes = _emit_pieces(vals[sl], raw_lens[sl], out_lens[sl])
        raw_end = int(raw_cum[k])
        blocks.append(
            Rle1Block(
                data=block_bytes,
                raw_length=raw_end - raw_base,
                crc=crc32(data[raw_base:raw_end]),
            )
        )
        out_base = int(out_cum[k])
        raw_base = raw_end
        piece0 = k + 1
    return blocks


# --------------------------------------------------------------------------
# Stage 2: BWT of rotations (reference kernel.cpp:2144-2456 DivSufSortBWT)
# --------------------------------------------------------------------------


def bwt_encode(block: np.ndarray) -> tuple[np.ndarray, int]:
    """Burrows-Wheeler transform over all rotations of `block`.

    Rank-doubling (prefix doubling) sort — the same algorithm family as the
    reference's own Larsson-Sadakane fallback (kernel.cpp:1241-1509) but as
    the primary, fully vectorized path. Returns (last_column, orig_ptr) where
    orig_ptr is the sorted position of rotation 0.
    """
    block = np.ascontiguousarray(block, dtype=np.uint8)
    n = block.size
    if n == 0:
        raise ValueError("empty block")
    rank = block.astype(np.int64)
    k = 1
    idx = np.arange(n, dtype=np.int64)
    while True:
        second = rank[(idx + k) % n]
        order = np.lexsort((second, rank))
        key_r = rank[order]
        key_s = second[order]
        new_rank = np.empty(n, dtype=np.int64)
        head = np.empty(n, dtype=bool)
        head[0] = True
        np.logical_or(key_r[1:] != key_r[:-1], key_s[1:] != key_s[:-1], out=head[1:])
        new_rank[order] = np.cumsum(head) - 1
        rank = new_rank
        if int(rank[order[-1]]) == n - 1:  # all ranks distinct
            sa = order
            break
        k <<= 1
        if k >= n:
            # Ranks equal beyond n => identical rotations (periodic block);
            # break ties by index for a deterministic, valid order.
            sa = np.lexsort((idx, rank))
            break
    last = block[(sa - 1) % n]
    orig_ptr = int(np.flatnonzero(sa == 0)[0])
    return last, orig_ptr


# --------------------------------------------------------------------------
# Stage 3: MTF + RLE2 (reference kernel.cpp:2513-2649)
# --------------------------------------------------------------------------


@dataclass
class MtfResult:
    symbols: np.ndarray  # int32 MTF/RLE2 symbol stream incl. EOB
    used: np.ndarray  # bool[256], bytes present in the block
    alpha_size: int  # nInUse + 2
    freqs: np.ndarray  # int64[alpha_size]


def mtf_rle2_encode(bwt_last: np.ndarray) -> MtfResult:
    """Move-to-front + zero-run RUNA/RUNB coding of the BWT output.

    Symbols: RUNA=0, RUNB=1, MTF value j>=1 -> j+1, EOB=alpha_size-1. Zero
    runs are emitted in bijective base 2 (reference kernel.cpp:2612-2640).
    """
    used = np.zeros(256, dtype=bool)
    used[np.unique(bwt_last)] = True
    n_in_use = int(used.sum())
    alpha_size = n_in_use + 2
    eob = alpha_size - 1
    # Dense mapping byte -> 0..nInUse-1.
    dense = np.cumsum(used) - 1
    seq = dense[bwt_last].astype(np.int64)

    mtf = list(range(n_in_use))
    out: list[int] = []
    freqs = np.zeros(alpha_size, dtype=np.int64)
    zpend = 0

    def flush_zeros(z: int) -> None:
        # z -> bijective base-2 digits, LSB first: RUNA for 0-digit, RUNB for 1.
        z -= 1
        while True:
            d = z & 1
            out.append(d)  # RUNA=0 / RUNB=1
            freqs[d] += 1
            if z < 2:
                break
            z = (z - 2) >> 1

    for v in seq.tolist():
        j = mtf.index(v)
        if j == 0:
            zpend += 1
            continue
        if zpend:
            flush_zeros(zpend)
            zpend = 0
        mtf.pop(j)
        mtf.insert(0, v)
        sym = j + 1
        out.append(sym)
        freqs[sym] += 1
    if zpend:
        flush_zeros(zpend)
    out.append(eob)
    freqs[eob] += 1
    return MtfResult(np.asarray(out, dtype=np.int32), used, alpha_size, freqs)


# --------------------------------------------------------------------------
# Stage 4: multi-table Huffman (reference kernel.cpp:2651-3096)
# --------------------------------------------------------------------------


def make_code_lengths(freqs: np.ndarray, max_len: int = C.HUFFMAN_ENCODE_MAX_LENGTH) -> np.ndarray:
    """Length-limited Huffman code lengths (semantics of hbMakeCodeLengths /
    reference allocateHuffmanCodeLengths, kernel.cpp:2661-2806).

    Standard two-queue Huffman over weights max(freq,1); if the depth cap is
    exceeded, frequencies are flattened (f -> 1 + f/2) and rebuilt.
    """
    f = np.maximum(np.asarray(freqs, dtype=np.int64), 1)
    n = f.size
    while True:
        lengths = _huffman_depths(f)
        if lengths.max() <= max_len:
            return lengths.astype(np.int32)
        f = 1 + (f >> 1)


def _huffman_depths(weights: np.ndarray) -> np.ndarray:
    """Leaf depths of a Huffman tree over `weights` (two-queue algorithm)."""
    n = weights.size
    if n == 1:
        return np.ones(1, dtype=np.int64)
    order = np.argsort(weights, kind="stable")
    leaf_w = weights[order]
    # parent[] over node ids: 0..n-1 leaves (sorted order), n.. internals.
    parent = np.full(2 * n - 1, -1, dtype=np.int64)
    node_w = np.zeros(2 * n - 1, dtype=np.int64)
    node_w[:n] = leaf_w
    li = 0  # next leaf
    ii = n  # next internal to consume
    nxt = n  # next internal to create
    for _ in range(n - 1):
        picks = []
        for _ in range(2):
            take_leaf = li < n and (ii >= nxt or leaf_w[li] <= node_w[ii])
            if take_leaf:
                picks.append(li)
                li += 1
            else:
                picks.append(ii)
                ii += 1
        node_w[nxt] = node_w[picks[0]] + node_w[picks[1]]
        parent[picks[0]] = nxt
        parent[picks[1]] = nxt
        nxt += 1
    depth = np.zeros(2 * n - 1, dtype=np.int64)
    for v in range(2 * n - 3, -1, -1):
        depth[v] = depth[parent[v]] + 1
    out = np.empty(n, dtype=np.int64)
    out[order] = depth[:n]
    return out


def assign_canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """Canonical codes (reference kernel.cpp:2953-2989 semantics)."""
    lengths = np.asarray(lengths)
    codes = np.zeros(lengths.size, dtype=np.int64)
    vec = 0
    for bits in range(int(lengths.min()), int(lengths.max()) + 1):
        sel = np.flatnonzero(lengths == bits)
        codes[sel] = vec + np.arange(sel.size)
        vec = (vec + sel.size) << 1
    return codes


@dataclass
class HuffmanPlan:
    n_groups: int
    selectors: np.ndarray  # int32[n_selectors], table id per 50-symbol group
    lengths: np.ndarray  # int32[n_groups, alpha_size]
    codes: np.ndarray  # int64[n_groups, alpha_size]


def huffman_plan(symbols: np.ndarray, freqs: np.ndarray, alpha_size: int) -> HuffmanPlan:
    """Table seeding + iterative group->table refinement.

    Seeding slices the cumulative frequency range into nGroups spans with
    0/15 starting lengths; then per-group cheapest-table selection passes,
    iterated to the selector fixed point (capped at HUFFMAN_REFINE_ITERS) (a groups x tables cost reduction — on the device
    this is a (groups, alpha) @ (alpha, tables) matmul) and per-table code-length
    rebuilds. Semantics of reference kernel.cpp:2859-2951 / stock
    sendMTFValues.
    """
    n_mtf = symbols.size
    n_groups = C.table_count_for_symbols(n_mtf)
    n_selectors = (n_mtf + C.HUFFMAN_GROUP_SIZE - 1) // C.HUFFMAN_GROUP_SIZE

    # --- seed lengths by cumulative-frequency slicing ---
    lengths = np.full((n_groups, alpha_size), 15, dtype=np.int32)
    rem_f = int(freqs.sum())
    gs = 0
    for t in range(n_groups):
        t_freq = rem_f // (n_groups - t)
        ge = gs - 1
        a_freq = 0
        while a_freq < t_freq and ge < alpha_size - 1:
            ge += 1
            a_freq += int(freqs[ge])
        if ge > gs and t != 0 and t != n_groups - 1 and (t & 1) == 1:
            a_freq -= int(freqs[ge])
            ge -= 1
        # Stock fills tables from the highest index down (nPart-1).
        lengths[n_groups - 1 - t, gs : ge + 1] = 0
        gs = ge + 1
        rem_f -= a_freq

    # --- group frequency matrix (n_selectors, alpha_size) ---
    pad = n_selectors * C.HUFFMAN_GROUP_SIZE - n_mtf
    padded = np.concatenate([symbols, np.full(pad, -1, dtype=symbols.dtype)])
    grouped = padded.reshape(n_selectors, C.HUFFMAN_GROUP_SIZE)
    gfreq = np.zeros((n_selectors, alpha_size), dtype=np.int64)
    valid = grouped >= 0
    np.add.at(gfreq, (np.nonzero(valid)[0], grouped[valid]), 1)

    selectors = np.zeros(n_selectors, dtype=np.int32)
    snap = None  # state after exactly 4 iterations = stock's BZ_N_ITERS point
    for i in range(C.HUFFMAN_REFINE_ITERS):
        cost = gfreq @ lengths.T.astype(np.int64)  # (n_selectors, n_groups)
        new_sel = np.argmin(cost, axis=1).astype(np.int32)
        if i > 0 and np.array_equal(new_sel, selectors):
            break  # fixed point: rfreq, hence lengths, cannot change
        selectors = new_sel
        rfreq = np.zeros((n_groups, alpha_size), dtype=np.int64)
        np.add.at(rfreq, selectors, gfreq)
        for t in range(n_groups):
            lengths[t] = make_code_lengths(rfreq[t])
        if i == 3:
            snap = (lengths.copy(), selectors.copy())

    def _plan_bits(lg: np.ndarray, sel: np.ndarray) -> int:
        """Stream bits that depend on (lengths, selectors): symbol codes +
        selector unaries + delta-coded table rows — the tie-breaker
        between the converged point (minimal SYMBOL bits) and stock's
        4-iteration point (whose headers can be smaller). Must match
        ops/huffman.huffman_assign's total_bits bit-for-bit."""
        rf = np.zeros((n_groups, alpha_size), dtype=np.int64)
        np.add.at(rf, sel, gfreq)
        sym_bits = int((rf * lg).sum())
        order = list(range(n_groups))
        sel_bits = 0
        for s in sel.tolist():
            j = order.index(s)
            sel_bits += j + 1
            order.insert(0, order.pop(j))
        prev = np.concatenate([lg[:, :1], lg[:, :-1]], axis=1)
        tab_bits = int((2 * np.abs(lg - prev) + 1).sum())
        return sym_bits + sel_bits + tab_bits

    if snap is not None and _plan_bits(*snap) < _plan_bits(lengths, selectors):
        lengths, selectors = snap

    codes = np.stack([assign_canonical_codes(lengths[t]) for t in range(n_groups)])
    return HuffmanPlan(n_groups, selectors, lengths, codes)


# --------------------------------------------------------------------------
# Stage 5: block bit emission (reference kernel.cpp:2991-3122 + OutputStream)
# --------------------------------------------------------------------------


def write_block(
    w: BitWriter,
    block_crc: int,
    orig_ptr: int,
    used: np.ndarray,
    mtf: MtfResult,
    plan: HuffmanPlan,
    randomised: bool = False,
) -> None:
    # randomised is never set by compress() (reference OutputStream.hpp:211;
    # no modern encoder emits it) — it exists so tests can craft legacy
    # 0.9.0 randomised blocks to validate the decoders against stock bzip2.
    w.write_bits(48, C.BLOCK_HEADER_MARKER)
    w.write_bits(32, block_crc)
    w.write_bit(1 if randomised else 0)
    w.write_bits(24, orig_ptr)
    # Symbol map: 16 range bits + 16 bits per used range (kernel.cpp:2483-2511).
    ranges = used.reshape(16, 16)
    range_used = ranges.any(axis=1)
    w.write_bits(16, int("".join("1" if b else "0" for b in range_used), 2))
    for r in range(16):
        if range_used[r]:
            w.write_bits(16, int("".join("1" if b else "0" for b in ranges[r]), 2))
    w.write_bits(3, plan.n_groups)
    w.write_bits(15, plan.selectors.size)
    # Selectors, MTF-coded then unary.
    mtf_list = list(range(plan.n_groups))
    for s in plan.selectors.tolist():
        j = mtf_list.index(s)
        mtf_list.pop(j)
        mtf_list.insert(0, s)
        w.write_unary(j)
    # Tables: 5-bit initial length, then delta moves ('10' inc, '11' dec, '0' stop).
    for t in range(plan.n_groups):
        lens = plan.lengths[t]
        cur = int(lens[0])
        w.write_bits(5, cur)
        for v in lens.tolist():
            while cur < v:
                w.write_bits(2, 2)
                cur += 1
            while cur > v:
                w.write_bits(2, 3)
                cur -= 1
            w.write_bit(0)
    # Symbol data, switching tables every 50 symbols.
    syms = mtf.symbols
    for g in range(plan.selectors.size):
        t = int(plan.selectors[g])
        chunk = syms[g * C.HUFFMAN_GROUP_SIZE : (g + 1) * C.HUFFMAN_GROUP_SIZE]
        lens = plan.lengths[t]
        codes = plan.codes[t]
        for s in chunk.tolist():
            w.write_bits(int(lens[s]), int(codes[s]))


def encode_block(w: BitWriter, rle1: Rle1Block) -> None:
    last, orig_ptr = bwt_encode(rle1.data)
    mtf = mtf_rle2_encode(last)
    plan = huffman_plan(mtf.symbols, mtf.freqs, mtf.alpha_size)
    write_block(w, rle1.crc, orig_ptr, mtf.used, mtf, plan)


# --------------------------------------------------------------------------
# Stream assembly (reference OutputStream.hpp:126-176)
# --------------------------------------------------------------------------


def compress(data: bytes | np.ndarray, level: int = C.DEFAULT_LEVEL) -> bytes:
    """Compress `data` into a standard .bz2 stream."""
    arr = np.frombuffer(bytes(data), dtype=np.uint8) if not isinstance(data, np.ndarray) else data
    blocks = rle1_split(arr, level)
    w = BitWriter()
    w.write_bits(24, int.from_bytes(C.STREAM_MAGIC, "big"))
    w.write_bits(8, ord("0") + level)
    for blk in blocks:
        encode_block(w, blk)
    w.write_bits(48, C.STREAM_END_MARKER)
    w.write_bits(32, stream_crc([b.crc for b in blocks]))
    w.pad_to_byte()
    return w.getvalue()
