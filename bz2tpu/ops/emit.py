"""Device-side bitstream emission: variable-length codes -> packed words.

The reference writes every code bit-by-bit into a bool-per-bit buffer inside
the kernel (reference kernel.cpp:2458-2481, 3043-3062: writeBits loops over
single bits; 16 bool-bytes per input byte of device memory,
include/OutputStream.hpp:70). Here emission is a closed-form parallel pack:

  bit offset of code i = exclusive prefix sum of code lengths;
  each code, MSB-aligned into the 64-bit window anchored at its first
  32-bit word, contributes (hi, lo) word parts; all parts land with two
  scatter-adds (disjoint bit ranges make add == or, so order is free).

Output is 32x denser than the reference's device representation (packed
words vs bool-per-bit) and needs no serial repack on the host — the
driver-side stitcher concatenates already-packed streams.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from bz2tpu.format import constants as C


def packed_words(capacity: int) -> int:
    """Static word count covering the worst-case symbol-data bitstream."""
    # <= capacity+1 symbols, each code <= 20 bits.
    return ((capacity + 1) * C.HUFFMAN_ENCODE_MAX_LENGTH + 20 + 31) // 32 + 2


def header_elements(maxsel: int) -> int:
    """Static element count of the block-header emission sequence."""
    # 6 fixed fields + ranges word + 16 range rows + n_groups + n_selectors
    # + selector unaries + 6 tables x (init + 258 x (movesA, movesB+stop)).
    return 6 + 1 + 16 + 2 + maxsel + 6 * (1 + 2 * C.HUFFMAN_MAX_ALPHABET)


def header_words(maxsel: int) -> int:
    """Static word count covering the worst-case block header."""
    bits = (
        48 + 32 + 1 + 24 + 16 + 16 * 16 + 3 + 15
        + 6 * maxsel
        + 6 * (5 + C.HUFFMAN_MAX_ALPHABET * (2 * C.HUFFMAN_ENCODE_MAX_LENGTH + 3))
    )
    return bits // 32 + 2


def block_header_parts(
    crc: jnp.ndarray,
    orig_ptr: jnp.ndarray,
    used: jnp.ndarray,
    n_groups: jnp.ndarray,
    n_selectors: jnp.ndarray,
    selector_mtf: jnp.ndarray,
    lengths: jnp.ndarray,
    *,
    maxsel: int,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """The whole block header as (values, bit-lengths) element arrays.

    The reference emits the header on device too, bit by bit
    (kernel.cpp:2483-2511 writeSymbolMap, :2991-3041 selectors + delta
    tables); here every field is a fixed SLOT in a closed-form
    variable-length element sequence (unused slots carry 0 bits), so the
    same prefix-sum pack that emits symbol data emits the header:

      marker(24+24) crc(16+16) randomised(1) origPtr(24) ranges(16)
      16 x range-row(16|0) nGroups(3) nSelectors(15)
      maxsel x selector-unary(rank+1|0)
      6 x [init(5|0), 258 x [delta-moves<=20b, remaining-moves+stop]]

    Delta moves use the bijective '10'/'11' 2-bit codes; k repetitions of
    a 2-bit pattern p have value p*(4^k-1)/3. A move run of up to
    HUFFMAN_ENCODE_MAX_LENGTH splits across two slots so every element
    stays under 32 bits.
    """
    u32 = jnp.uint32
    crc = crc.astype(u32)
    fixed_vals = jnp.stack(
        [
            u32(0x314159),
            u32(0x265359),
            (crc >> u32(16)) & u32(0xFFFF),
            crc & u32(0xFFFF),
            u32(0),
            orig_ptr.astype(u32),
        ]
    )
    fixed_lens = jnp.asarray([24, 24, 16, 16, 1, 24], jnp.int32)

    used_m = used.reshape(16, 16)
    range_used = used_m.any(axis=1)
    pow16 = (u32(1) << (15 - jnp.arange(16, dtype=u32))).astype(u32)
    ranges_val = jnp.sum(jnp.where(range_used, pow16, u32(0)))
    row_vals = jnp.sum(jnp.where(used_m, pow16[None, :], u32(0)), axis=1)
    row_lens = jnp.where(range_used, 16, 0).astype(jnp.int32)

    counts_vals = jnp.stack([n_groups.astype(u32), n_selectors.astype(u32)])
    counts_lens = jnp.asarray([3, 15], jnp.int32)

    sel_rank = selector_mtf.astype(jnp.int32)
    sel_valid = jnp.arange(maxsel, dtype=jnp.int32) < n_selectors
    sel_lens = jnp.where(sel_valid, sel_rank + 1, 0)
    sel_vals = jnp.where(
        sel_valid, (u32(1) << (sel_rank + 1).astype(u32)) - u32(2), u32(0)
    )

    L = lengths.astype(jnp.int32)  # (6, 258)
    t_valid = jnp.arange(6, dtype=jnp.int32)[:, None] < n_groups
    alpha = jnp.sum(used.astype(jnp.int32)) + 2
    v_valid = jnp.arange(C.HUFFMAN_MAX_ALPHABET, dtype=jnp.int32)[None, :] < alpha
    mask = t_valid & v_valid
    prev = jnp.concatenate([L[:, :1], L[:, :-1]], axis=1)
    delta = jnp.where(mask, L - prev, 0)
    m = jnp.abs(delta)
    pat = jnp.where(delta > 0, 2, 3)
    half = C.HUFFMAN_ENCODE_MAX_LENGTH // 2 + 2  # slot-A move cap (<=32 bits)
    ka = jnp.minimum(m, half)
    kb = m - ka
    rep_a = ((jnp.int32(1) << (2 * ka)) - 1) // 3
    rep_b = ((jnp.int32(1) << (2 * kb)) - 1) // 3
    val_a = (pat * rep_a).astype(u32)
    len_a = jnp.where(mask, 2 * ka, 0)
    val_b = ((pat * rep_b) << 1).astype(u32)  # trailing 0 = stop bit
    len_b = jnp.where(mask, 2 * kb + 1, 0)
    moves_vals = jnp.stack([val_a, val_b], axis=2).reshape(6, -1)
    moves_lens = jnp.stack([len_a, len_b], axis=2).reshape(6, -1)
    # Elements with 0-bit slots MUST carry value 0 (the packer shifts the
    # value to its window position regardless of length).
    init_vals = jnp.where(t_valid[:, :1], L[:, :1], 0).astype(u32)
    init_lens = jnp.where(t_valid[:, :1], 5, 0)
    tab_vals = jnp.concatenate([init_vals, moves_vals], axis=1).reshape(-1)
    tab_lens = jnp.concatenate([init_lens, moves_lens], axis=1).reshape(-1)

    vals = jnp.concatenate(
        [fixed_vals, ranges_val[None], row_vals, counts_vals, sel_vals, tab_vals]
    )
    lens = jnp.concatenate(
        [fixed_lens, jnp.asarray([16], jnp.int32), row_lens, counts_lens, sel_lens, tab_lens]
    )
    return vals, lens


@functools.partial(jax.jit, static_argnames=("maxsel",))
def pack_symbol_data(
    symbols: jnp.ndarray,
    selectors: jnp.ndarray,
    lengths: jnp.ndarray,
    codes: jnp.ndarray,
    *,
    maxsel: int,
):
    """Huffman-encode the symbol stream and pack it into uint32 words.

    Args:
      symbols: (S,) int32 MTF/RLE2 stream, -1 padding (S = capacity + 2).
      selectors: (maxsel,) int32 table id per 50-symbol group.
      lengths/codes: (6, 258) int32 code tables.

    Returns (words, total_bits): (W,) uint32 MSB-first words and the valid
    bit count. Bytes are the big-endian view of the words.
    """
    S = symbols.shape[0]
    W = packed_words(S - 2)
    gid = jnp.arange(S, dtype=jnp.int32) // C.HUFFMAN_GROUP_SIZE
    sel = selectors[jnp.clip(gid, 0, maxsel - 1)]
    valid = symbols >= 0
    sym = jnp.clip(symbols, 0, 257)
    lens = jnp.where(valid, lengths[sel, sym], 0)
    vals = jnp.where(valid, codes[sel, sym], 0).astype(jnp.uint32)

    return pack_elements(vals, lens, jnp.where(valid, 1, 0), W)


def pack_elements(vals, lens, valid, W: int):
    """Pack a (value, nbits) element sequence into W uint32 words.

    32-bit-only window math (x64 is disabled under JAX defaults): an
    element of len <= 32 at bit position bitpos in its first word either
    fits (shift left by 32-bitpos-len) or spills len+bitpos-32 <= 31 bits
    into the next word. Values must be < 2^len (0 for 0-bit slots).
    ``valid`` is required; invalid elements are dropped (never clipped into
    range, which would corrupt the last word).
    """
    ends = jnp.cumsum(lens)
    offsets = ends - lens
    total_bits = ends[-1]

    bitpos = offsets & 31
    spill = jnp.clip(lens + bitpos - 32, 0, 31)
    fit = jnp.clip(32 - bitpos - lens, 0, 31)
    spills = (lens + bitpos) > 32
    hi = jnp.where(spills, vals >> spill.astype(jnp.uint32), vals << fit.astype(jnp.uint32))
    lo = jnp.where(
        spills, vals << jnp.clip(32 - spill, 0, 31).astype(jnp.uint32), jnp.uint32(0)
    )
    w0 = offsets >> 5

    mask = valid.astype(bool)
    out = jnp.zeros(W, jnp.uint32)
    out = out.at[jnp.where(mask, w0, W)].add(hi, mode="drop")
    out = out.at[jnp.where(mask, w0 + 1, W)].add(lo, mode="drop")
    return out, total_bits


@functools.partial(jax.jit, static_argnames=("maxsel",))
def pack_block(
    symbols: jnp.ndarray,
    selectors: jnp.ndarray,
    lengths: jnp.ndarray,
    codes: jnp.ndarray,
    crc: jnp.ndarray,
    orig_ptr: jnp.ndarray,
    used: jnp.ndarray,
    n_groups: jnp.ndarray,
    n_selectors: jnp.ndarray,
    selector_mtf: jnp.ndarray,
    *,
    maxsel: int,
):
    """Emit the COMPLETE block bitstream — header AND symbol data — as one
    packed uint32 word buffer (the device-side analog of the reference's
    whole-block emission, kernel.cpp:3099-3122). The host receives a
    finished block and only stitches.
    """
    S = symbols.shape[0]
    W = packed_words(S - 2) + header_words(maxsel)
    hdr_vals, hdr_lens = block_header_parts(
        crc, orig_ptr, used, n_groups, n_selectors, selector_mtf, lengths,
        maxsel=maxsel,
    )

    vals, lens, ok = _block_elements(
        symbols, selectors, lengths, codes, hdr_vals, hdr_lens, maxsel=maxsel
    )
    return pack_elements(vals, lens, ok, W)


def _block_elements(symbols, selectors, lengths, codes, hdr_vals, hdr_lens, *, maxsel):
    """One block's full (values, bit-lengths, valid) element sequence:
    header slots followed by Huffman symbol codes. The per-symbol length
    and code ride ONE packed (6, 258) table gather — (code << 5) | length
    fits 25 bits (codes < 2^20, lengths <= 20) — instead of two."""
    S = symbols.shape[0]
    gid = jnp.arange(S, dtype=jnp.int32) // C.HUFFMAN_GROUP_SIZE
    sel = selectors[jnp.clip(gid, 0, maxsel - 1)]
    valid = symbols >= 0
    sym = jnp.clip(symbols, 0, 257)
    comb = (codes << 5) | lengths  # (6, 258) int32
    cv = comb[sel, sym]
    sym_lens = jnp.where(valid, cv & 31, 0)
    sym_vals = jnp.where(valid, cv >> 5, 0).astype(jnp.uint32)

    vals = jnp.concatenate([hdr_vals, sym_vals])
    lens = jnp.concatenate([hdr_lens, sym_lens])
    ok = jnp.concatenate(
        [jnp.ones(hdr_vals.shape[0], jnp.int32), valid.astype(jnp.int32)]
    )
    return vals, lens, ok


@functools.partial(jax.jit, static_argnames=("maxsel",))
def pack_blocks_concat(
    symbols: jnp.ndarray,
    selectors: jnp.ndarray,
    lengths: jnp.ndarray,
    codes: jnp.ndarray,
    crcs: jnp.ndarray,
    orig_ptrs: jnp.ndarray,
    used: jnp.ndarray,
    n_groups: jnp.ndarray,
    n_selectors: jnp.ndarray,
    selector_mtf: jnp.ndarray,
    live: jnp.ndarray,
    *,
    maxsel: int,
):
    """Batch pack_block FUSED with concat_block_words: every block's
    header + symbol elements scatter ONCE into the final concatenated
    buffer at global bit offsets, skipping the intermediate per-block
    (B, W) words buffer and the concat's second scatter pass entirely.

    Args are the batch (leading B axis) forms of pack_block's, plus
    ``live`` (B,) bool — padding rows contribute 0 bits.

    Returns (out_words (B*W + 1,) uint32, total_bits, block_bits (B,)).
    """
    B, S = symbols.shape
    Wb = packed_words(S - 2) + header_words(maxsel)
    w_out = B * Wb + 1

    hdr_vals, hdr_lens = jax.vmap(
        functools.partial(block_header_parts, maxsel=maxsel)
    )(crcs, orig_ptrs, used, n_groups, n_selectors, selector_mtf, lengths)
    vals, lens, ok = jax.vmap(
        functools.partial(_block_elements, maxsel=maxsel)
    )(symbols, selectors, lengths, codes, hdr_vals, hdr_lens)

    lens = jnp.where(live[:, None], lens, 0)
    ok = ok * live[:, None].astype(jnp.int32)

    ends = jnp.cumsum(lens, axis=1)  # (B, E) per-block inclusive
    block_bits = ends[:, -1]
    bases = jnp.cumsum(block_bits) - block_bits  # exclusive across blocks
    total_bits = bases[-1] + block_bits[-1]
    offsets = bases[:, None] + (ends - lens)  # global bit offsets

    bitpos = offsets & 31
    spill = jnp.clip(lens + bitpos - 32, 0, 31)
    fit = jnp.clip(32 - bitpos - lens, 0, 31)
    spills = (lens + bitpos) > 32
    hi = jnp.where(
        spills, vals >> spill.astype(jnp.uint32), vals << fit.astype(jnp.uint32)
    )
    lo = jnp.where(
        spills, vals << jnp.clip(32 - spill, 0, 31).astype(jnp.uint32), jnp.uint32(0)
    )
    w0 = offsets >> 5

    mask = ok.astype(bool)
    out = jnp.zeros(w_out, jnp.uint32)
    out = out.at[jnp.where(mask, w0, w_out)].add(hi, mode="drop")
    out = out.at[jnp.where(mask, w0 + 1, w_out)].add(lo, mode="drop")
    return out, total_bits, block_bits


@jax.jit
def concat_block_words(words: jnp.ndarray, bits: jnp.ndarray):
    """Concatenate a batch's block bitstreams at bit granularity on device.

    The reference stitches per-block bool buffers serially on the host
    with a sub-byte carry (include/OutputStream.hpp:225-239); here the
    batch's packed words land in one output buffer via bit-offset prefix
    sums + two scatter-adds (block b's word j splits into
    out[base_b + j] >> s and out[base_b + j + 1] << (32-s)); bits past
    each block's length are zero by construction, so contributions from
    adjacent blocks never collide.

    Args:
      words: (B, W) uint32 per-block packed streams (zero past bits[b]).
      bits: (B,) int32 valid bit counts.

    Returns (out_words (B*W + 1,) uint32, total_bits).
    """
    b, w = words.shape
    w_out = b * w + 1
    offs = jnp.cumsum(bits) - bits  # exclusive
    total_bits = jnp.sum(bits)
    shift = (offs & 31).astype(jnp.uint32)  # (B,)
    word0 = (offs >> 5).astype(jnp.int32)
    hi = words >> shift[:, None]
    lo = jnp.where(
        (shift > 0)[:, None], words << (jnp.uint32(32) - shift)[:, None], jnp.uint32(0)
    )
    j = jnp.arange(w, dtype=jnp.int32)[None, :]
    nw = (bits + 31) >> 5  # words actually used per block
    live = j < nw[:, None]
    idx = word0[:, None] + j
    out = jnp.zeros(w_out, jnp.uint32)
    out = out.at[jnp.where(live, idx, w_out)].add(hi, mode="drop")
    out = out.at[jnp.where(live, idx + 1, w_out)].add(lo, mode="drop")
    return out, total_bits


def words_to_bytes(words, total_bits: int) -> bytes:
    """Big-endian byte view of packed words, trimmed to ceil(bits/8)."""
    import numpy as np

    raw = np.asarray(words).astype(">u4").tobytes()
    return raw[: (int(total_bits) + 7) // 8]
