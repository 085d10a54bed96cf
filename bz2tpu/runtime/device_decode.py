"""Device decompression driver: Huffman + MTF + IBWT on the device.

The reference decompresses 100% on the host (reference
include/InputStream.hpp:51-95 — single thread, one byte per pull). This
driver moves the three expensive stages onto the device per block:

  host   native bit-scan finds block boundaries (the same scan the
         block-parallel host path uses) and parses each block's small
         header (symbol map, selectors, delta tables) with the BitReader;
  device speculative group-parallel Huffman decode (ops/huffman_dec.py)
         -> run expansion + inverse MTF (ops/mtf_dec.py)
         -> pointer-doubling inverse BWT (ops/ibwt.py);
  host   native single-pass inverse RLE1 + CRC (native/_bz2dec.c), CRC
         verification, ordered concatenation.

Every device result is validated exactly (fixpoint + EOB-at-end-bit +
block CRC); any block the device path cannot certify routes the whole
stream to the host decoder, so behavior is identical to
runtime/decompressor.decompress on all inputs. Every such fallback is
counted by reason in ``fallback_stats`` and warned about, so a caller that
meant to decode on the device can tell that it did not.

Compile shapes are quantized (group count to a power of two, output
capacity per level) so a handful of XLA programs serve every stream.
"""

from __future__ import annotations

import collections
import functools
import os
import warnings

import numpy as np

# Blocks per vmapped device dispatch (pow2-padded); 16 halves the dispatch
# count per bucket. Neither value has been measured on the GPU yet.
_BUCKET_W = int(os.environ.get("BZ2TPU_DEC_BUCKET", "8"))

import jax
import jax.numpy as jnp

from bz2tpu import native
from bz2tpu.format import constants as C
from bz2tpu.format.bitio import BitReader
from bz2tpu.format.crc32 import stream_crc_fold
from bz2tpu.ops.huffman_dec import decode_symbol_data, decode_tables_arrays
from bz2tpu.ops.ibwt import ibwt
from bz2tpu.ops.mtf_dec import mtf_rle2_decode
from bz2tpu.oracle import decoder as od
from bz2tpu.oracle.decoder import Bz2CrcError, Bz2FormatError

# Host-decoder fallbacks of decompress_device in this process, by reason.
fallback_stats: collections.Counter = collections.Counter()


class _HostFallback(Exception):
    """The device path cannot certify this stream; the message says why."""


def _parse_block_header(stream: bytes, bit_off: int) -> dict:
    """Host-side parse of one block header starting at its 48-bit marker."""
    r = BitReader(stream)
    r._pos = bit_off
    if r.read_bits(48) != C.BLOCK_HEADER_MARKER:
        raise Bz2FormatError("bad block marker")
    crc = r.read_bits(32)
    if r.read_bit():
        # Legacy 0.9.0 randomised blocks route to the host decoders (which
        # fully support them, tests/test_randomised.py): the XOR schedule
        # is a serial detail not worth a device program variant for blocks
        # no modern encoder emits.
        raise Bz2FormatError("randomised block: host path")
    orig_ptr = r.read_bits(24)
    used = od._read_symbol_map(r)
    used_bytes = np.flatnonzero(used)
    if used_bytes.size == 0:
        raise Bz2FormatError("empty symbol map")
    alpha = used_bytes.size + 2
    n_groups = r.read_bits(3)
    if not C.HUFFMAN_MIN_TABLES <= n_groups <= C.HUFFMAN_MAX_TABLES:
        raise Bz2FormatError(f"bad table count {n_groups}")
    n_sel = r.read_bits(15)
    if not 1 <= n_sel <= C.HUFFMAN_MAX_SELECTORS:
        raise Bz2FormatError(f"bad selector count {n_sel}")
    selectors = od._decode_selectors(r, n_groups, n_sel)
    lengths = od._read_tables(r, n_groups, alpha)
    tables = [od.build_decode_tables(lengths[t]) for t in range(n_groups)]
    return {
        "crc": crc,
        "orig_ptr": orig_ptr,
        "used_bytes": used_bytes,
        "alpha": alpha,
        "selectors": np.asarray(selectors, dtype=np.int32),
        "tables": tables,
        "data_start_bit": r.bit_position,
    }


def _decode_block_core(
    stream, start_bit, end_bit, selectors, n_groups, limit, base, perm,
    eob, thr, lut, lut_idx, orig_ptr, init_list,
    *, max_groups, m_sym, out_cap, n_bits_cap,
):
    hd = decode_symbol_data(
        stream, start_bit, end_bit, selectors, n_groups, limit, base, perm,
        eob, thr, lut, lut_idx, max_groups=max_groups, n_bits_cap=n_bits_cap,
    )
    syms = jnp.full((m_sym,), -1, jnp.int32).at[: max_groups * C.HUFFMAN_GROUP_SIZE].set(
        hd["symbols"]
    )
    md = mtf_rle2_decode(syms, hd["n_sym"], init_list, eob, out_capacity=out_cap)
    decoded = ibwt(md["bwt"], md["n_bwt"], orig_ptr)
    ok = hd["ok"] & md["ok"] & (orig_ptr < md["n_bwt"])
    return decoded, md["n_bwt"], ok


@functools.partial(
    jax.jit, static_argnames=("max_groups", "m_sym", "out_cap", "n_bits_cap")
)
def _decode_blocks_jit(
    stream,
    start_bits,
    end_bits,
    selectors,
    n_groups,
    limits,
    bases,
    perms,
    eobs,
    thrs,
    lut,
    lut_idxs,
    init_lists,
    orig_ptrs,
    *,
    max_groups: int,
    m_sym: int,
    out_cap: int,
    n_bits_cap: int,
):
    """Batched block decode: vmap of the chain over same-shape blocks
    (stream and the bucket-shared length LUT broadcast; every other
    per-block input stacked on axis 0)."""

    def one(sb, eb, sl, ng, li, ba, pe, eo, th, lx, il, op):
        return _decode_block_core(
            stream, sb, eb, sl, ng, li, ba, pe, eo, th, lut, lx, op, il,
            max_groups=max_groups, m_sym=m_sym, out_cap=out_cap,
            n_bits_cap=n_bits_cap,
        )

    return jax.vmap(one)(
        start_bits, end_bits, selectors, n_groups, limits, bases, perms,
        eobs, thrs, lut_idxs, init_lists, orig_ptrs,
    )


def _pow2_at_least(n: int, floor: int = 16) -> int:
    v = floor
    while v < n:
        v <<= 1
    return v


def decompress_device(stream: bytes, verify_crc: bool = True) -> bytes:
    """Decode a .bz2 stream with the device pipeline; host fallback on any
    stream the device path cannot certify (multi-member, randomised
    blocks, spurious marker matches, pathological convergence). Each
    fallback is counted in ``fallback_stats`` and warned about."""
    from bz2tpu.runtime.decompressor import decompress as _host_decompress
    from bz2tpu.utils.jaxenv import setup_compilation_cache

    setup_compilation_cache()
    stream = bytes(stream)
    try:
        return _decompress_device_inner(stream, verify_crc)
    except _HostFallback as e:
        reason = str(e)
    fallback_stats[reason] += 1
    warnings.warn(
        f"decompress_device: host decoder used ({reason})", RuntimeWarning,
        stacklevel=2,
    )
    return _host_decompress(stream, verify_crc=verify_crc)


def _decompress_device_inner(stream: bytes, verify_crc: bool) -> bytes:
    if not native.HAVE_NATIVE:
        raise _HostFallback("native extension unavailable")
    if len(stream) < 4 or stream[:3] != b"BZh" or not (ord("1") <= stream[3] <= ord("9")):
        raise _HostFallback("no stream header")  # host path raises the error
    level = stream[3] - ord("0")
    headers, ends = native.scan_blocks(stream)
    if not headers or not ends or headers[0] != 32:
        raise _HostFallback("no block at the stream start")
    # Single-member streams only: the final end marker must follow the last
    # header; anything else (concatenations, stray matches) -> host path.
    boundaries = headers[1:] + [ends[-1]]

    arr = np.frombuffer(stream, dtype=np.uint8)
    padded = np.zeros(_pow2_at_least(arr.size, 1 << 12), dtype=np.uint8)
    padded[: arr.size] = arr
    stream_dev = jax.device_put(jnp.asarray(padded))

    out_cap = _pow2_at_least(level * C.BLOCK_SIZE_BASE)

    # Host header parse for every block, then bucket same-shape blocks and
    # decode each bucket in ONE vmapped device call (+ one sliced fetch).
    parsed = []
    for i, start in enumerate(headers):
        try:
            hdr = _parse_block_header(stream, start)
        except (Bz2FormatError, EOFError) as e:
            raise _HostFallback(f"block header: {e}") from None
        n_bits = boundaries[i] - hdr["data_start_bit"]
        if n_bits <= 0:
            raise _HostFallback("empty block data")
        n_groups = hdr["selectors"].size
        gmax = _pow2_at_least(n_groups)
        hdr["gmax"] = gmax
        hdr["m_sym"] = -(-gmax * C.HUFFMAN_GROUP_SIZE // 128) * 128
        hdr["nbc"] = _pow2_at_least(n_bits, 1 << 12)
        hdr["end_bit"] = boundaries[i]
        parsed.append(hdr)

    buckets: dict[tuple, list[int]] = {}
    for i, p in enumerate(parsed):
        buckets.setdefault((p["gmax"], p["m_sym"], p["nbc"]), []).append(i)

    results: list[bytes | None] = [None] * len(parsed)
    for (gmax, m_sym, nbc), idxs in buckets.items():
        for base_i in range(0, len(idxs), _BUCKET_W):
            group = idxs[base_i : base_i + _BUCKET_W]
            b = _pow2_at_least(len(group), 1)
            rows = group + [group[0]] * (b - len(group))  # pad w/ repeats
            sel = np.zeros((b, gmax), np.int32)
            lim = np.zeros((b, 6, 21), np.int32)
            bas = np.zeros((b, 6, 21), np.int32)
            prm = np.zeros((b, 6, C.HUFFMAN_MAX_ALPHABET), np.int32)
            thr_b = np.zeros((b, 6, 21), np.int32)
            il = np.zeros((b, 256), np.int32)
            sb = np.zeros(b, np.int32)
            eb = np.zeros(b, np.int32)
            ng = np.zeros(b, np.int32)
            eo = np.zeros(b, np.int32)
            op = np.zeros(b, np.int32)
            # Same-table detection: each distinct threshold row builds its
            # 2^20-entry length LUT ONCE for the whole batch (repeat-padded
            # rows and identical tables across blocks share; 8 blocks x 6
            # tables + the zero row bounds uniques at 49 < U_CAP). Fixed
            # U_CAP keeps one compiled program per bucket shape.
            U_CAP = 64
            thr_rows = np.zeros((U_CAP, 21), np.int32)
            lut_map: dict[bytes, int] = {thr_rows[0].tobytes(): 0}
            lidx = np.zeros((b, 6), np.int32)
            n_unique = 1
            for r, bi in enumerate(rows):
                p = parsed[bi]
                sel[r, : p["selectors"].size] = p["selectors"]
                limit, base_a, perm, thr_a = decode_tables_arrays(p["tables"])
                lim[r, : limit.shape[0]] = limit
                lim[r, limit.shape[0] :] = -1  # unused tables never match
                bas[r, : base_a.shape[0]] = base_a
                prm[r, : perm.shape[0]] = perm
                thr_b[r, : thr_a.shape[0]] = thr_a  # unused rows stay 0
                for t in range(6):
                    key = thr_b[r, t].tobytes()
                    if key not in lut_map:
                        lut_map[key] = n_unique
                        thr_rows[n_unique] = thr_b[r, t]
                        n_unique += 1
                    lidx[r, t] = lut_map[key]
                il[r, : p["used_bytes"].size] = p["used_bytes"]
                sb[r] = p["data_start_bit"]
                eb[r] = p["end_bit"]
                ng[r] = p["selectors"].size
                eo[r] = p["alpha"] - 1
                op[r] = p["orig_ptr"]
            from bz2tpu.ops.huffman_dec import build_len_luts

            lut = build_len_luts(jnp.asarray(thr_rows))
            decoded, n_bwts, oks = _decode_blocks_jit(
                stream_dev,
                jnp.asarray(sb), jnp.asarray(eb), jnp.asarray(sel),
                jnp.asarray(ng), jnp.asarray(lim), jnp.asarray(bas),
                jnp.asarray(prm), jnp.asarray(eo), jnp.asarray(thr_b),
                lut, jnp.asarray(lidx),
                jnp.asarray(il), jnp.asarray(op),
                max_groups=gmax, m_sym=m_sym, out_cap=out_cap, n_bits_cap=nbc,
            )
            n_bwts = np.asarray(n_bwts)
            if not all(bool(o) for o in np.asarray(oks)[: len(group)]):
                raise _HostFallback("device decode not certified")
            # ONE sliced fetch for the whole bucket batch.
            width = _pow2_at_least(int(n_bwts[: len(group)].max()), 1 << 10)
            width = min(width, out_cap)
            walked = np.asarray(jax.device_get(decoded[:, :width]))
            for r, bi in enumerate(group):
                results[bi] = walked[r, : int(n_bwts[r])].tobytes()

    pieces = []
    s_crc = 0
    for i, p in enumerate(parsed):
        data, crc = native.inverse_rle1(results[i])
        if verify_crc and crc != p["crc"]:
            raise Bz2CrcError(f"block CRC mismatch: {p['crc']:#x} != {crc:#x}")
        s_crc = stream_crc_fold(s_crc, p["crc"])
        pieces.append(data)
    # Stream CRC sits 48 bits past the final end marker.
    pos = ends[-1] + 48
    if pos + 32 > len(stream) * 8:
        raise _HostFallback("stream ends inside its CRC")
    r = BitReader(stream)
    r._pos = pos
    stored = r.read_bits(32)
    if verify_crc and stored != s_crc:
        # Could be a multi-member stream (per-member CRCs): host path
        # decides whether this is an error or a member boundary.
        raise _HostFallback("stream CRC differs (multi-member?)")
    return b"".join(pieces)
