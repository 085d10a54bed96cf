"""Device decode ops (huffman_dec / mtf_dec / ibwt) and the composed
device decompression driver, differential-tested against the oracle and
stdlib/stock streams."""

import bz2 as stdlib_bz2

import numpy as np
import pytest

import jax.numpy as jnp

from bz2tpu.format import constants as C
from bz2tpu.ops.huffman_dec import decode_symbol_data, decode_tables_arrays
from bz2tpu.ops.ibwt import ibwt, ibwt_batch
from bz2tpu.ops.mtf_dec import mtf_rle2_decode
from bz2tpu.oracle.encoder import bwt_encode as oracle_bwt, mtf_rle2_encode
from bz2tpu.runtime.device_decode import (
    _parse_block_header,
    decompress_device,
)

from conftest import make_corpus


@pytest.mark.parametrize("kind", ["text", "runs", "zeros", "random"])
def test_ibwt_inverts_oracle_bwt(kind):
    rng = np.random.default_rng(61)
    data = np.frombuffer(make_corpus(rng, kind, 30_000), dtype=np.uint8)
    last, orig_ptr = oracle_bwt(data)
    S = 1 << 15
    padded = np.zeros(S, np.uint8)
    padded[: last.size] = last
    got = np.asarray(ibwt(jnp.asarray(padded), last.size, orig_ptr))
    assert (got[: data.size] == data).all()
    assert (got[data.size :] == 0).all()


def test_ibwt_periodic_and_tiny():
    for data in (np.tile(np.array([1, 2, 3], np.uint8), 500), np.array([9], np.uint8)):
        last, orig_ptr = oracle_bwt(data)
        S = 2048
        padded = np.zeros(S, np.uint8)
        padded[: last.size] = last
        got = np.asarray(ibwt(jnp.asarray(padded), last.size, orig_ptr))
        assert (got[: data.size] == data).all()


def test_ibwt_batch():
    rng = np.random.default_rng(62)
    S = 4096
    blocks = np.zeros((3, S), np.uint8)
    ns, ops, datas = [], [], []
    for i in range(3):
        d = np.frombuffer(make_corpus(rng, "text", 1000 + 700 * i), dtype=np.uint8)
        last, op = oracle_bwt(d)
        blocks[i, : last.size] = last
        ns.append(d.size)
        ops.append(op)
        datas.append(d)
    out = np.asarray(ibwt_batch(jnp.asarray(blocks), jnp.asarray(ns), jnp.asarray(ops)))
    for i, d in enumerate(datas):
        assert (out[i, : d.size] == d).all()


@pytest.mark.parametrize("kind", ["text", "runs", "zeros", "random"])
def test_mtf_dec_inverts_oracle_encode(kind):
    rng = np.random.default_rng(63)
    data = np.frombuffer(make_corpus(rng, kind, 25_000), dtype=np.uint8)
    last, _ = oracle_bwt(data)
    mtf = mtf_rle2_encode(last)
    syms = mtf.symbols
    M = -(-(syms.size + 1) // 128) * 128
    padded = np.full(M, -1, np.int32)
    padded[: syms.size] = syms
    init_list = np.zeros(256, np.int32)
    ub = np.flatnonzero(mtf.used)
    init_list[: ub.size] = ub
    r = mtf_rle2_decode(
        jnp.asarray(padded), syms.size, jnp.asarray(init_list),
        mtf.alpha_size - 1, out_capacity=1 << 16,
    )
    assert bool(r["ok"])
    n = int(r["n_bwt"])
    assert n == last.size
    assert (np.asarray(r["bwt"])[:n] == last).all()


def _decode_first_block_symbols_oracle(comp, hdr, end_bit):
    """Serial reference decode of one block's raw symbol stream."""
    from bz2tpu.format.bitio import BitReader

    r = BitReader(comp)
    r._pos = hdr["data_start_bit"]
    eob = hdr["alpha"] - 1
    out = []
    gi, gcount = -1, 0
    while True:
        if gcount == 0:
            gi += 1
            limit, base, perm, min_l = hdr["tables"][int(hdr["selectors"][gi])]
            gcount = C.HUFFMAN_GROUP_SIZE
        gcount -= 1
        bits = min_l
        code = r.read_bits(min_l)
        while code > limit[bits]:
            code = (code << 1) | r.read_bit()
            bits += 1
        sym = int(perm[code - int(base[bits])])
        out.append(sym)
        if sym == eob:
            return np.array(out), r.bit_position


@pytest.mark.parametrize("kind,level", [("text", 1), ("text", 9), ("random", 1), ("runs", 2)])
def test_huffman_dec_matches_serial(kind, level):
    from bz2tpu import native

    rng = np.random.default_rng(64)
    data = make_corpus(rng, kind, 150_000)
    comp = stdlib_bz2.compress(data, level)
    headers, ends = native.scan_blocks(comp)
    hdr = _parse_block_header(comp, headers[0])
    end_bit = headers[1] if len(headers) > 1 else ends[-1]
    want, end_pos = _decode_first_block_symbols_oracle(comp, hdr, end_bit)
    assert end_pos == end_bit  # scan boundary is the symbol-data end

    n_groups = hdr["selectors"].size
    gmax = 1 << max(4, (n_groups - 1).bit_length())
    sel = np.zeros(gmax, np.int32)
    sel[:n_groups] = hdr["selectors"]
    limit, base, perm, thr = decode_tables_arrays(hdr["tables"])
    n_bits = end_bit - hdr["data_start_bit"]
    cap = 1 << max(12, (n_bits - 1).bit_length())
    res = decode_symbol_data(
        jnp.asarray(np.frombuffer(comp, np.uint8)),
        jnp.int32(hdr["data_start_bit"]),
        jnp.int32(end_bit),
        jnp.asarray(sel),
        jnp.int32(n_groups),
        jnp.asarray(limit),
        jnp.asarray(base),
        jnp.asarray(perm),
        jnp.int32(hdr["alpha"] - 1),
        jnp.asarray(thr),
        max_groups=gmax,
        n_bits_cap=cap,
    )
    assert bool(res["ok"])
    got = np.asarray(res["symbols"])[: int(res["n_sym"])]
    assert got.size == want.size and (got == want).all()


@pytest.mark.parametrize("kind,level", [
    ("text", 1), ("text", 9), ("zeros", 1), ("random", 2), ("runs", 1),
])
def test_decompress_device_stock_streams(kind, level):
    rng = np.random.default_rng(65)
    data = make_corpus(rng, kind, 400_000)
    comp = stdlib_bz2.compress(data, level)
    assert decompress_device(comp) == data


def test_decompress_device_multiblock_and_fallbacks():
    rng = np.random.default_rng(66)
    a = make_corpus(rng, "text", 250_000)
    comp = stdlib_bz2.compress(a, 1)  # multiple 100k blocks
    assert decompress_device(comp) == a
    # Multi-member: certified fallback to the host path.
    b = make_corpus(rng, "runs", 100_000)
    mm = comp + stdlib_bz2.compress(b, 9)
    assert decompress_device(mm) == a + b
    # Corruption raises like the host path.
    bad = bytearray(comp)
    for off in range(60, 600, 60):
        bad[off] ^= 0x04
    with pytest.raises(ValueError):
        decompress_device(bytes(bad))


def test_decompress_device_own_output():
    # Streams produced by our own oracle encoder decode on device too.
    from bz2tpu.oracle.encoder import compress as oracle_compress

    rng = np.random.default_rng(67)
    data = make_corpus(rng, "text", 150_000)
    comp = oracle_compress(data, level=1)
    assert decompress_device(comp) == data


def test_build_len_luts_matches_searchsorted(rng):
    # The LUT must reproduce searchsorted(thr, v23, 'right') for every
    # window value, including degenerate all-zero (unused-slot) rows.
    from bz2tpu.ops.huffman_dec import build_len_luts

    data = make_corpus(rng, "text", 60_000)
    comp = stdlib_bz2.compress(data, 1)
    from bz2tpu import native

    headers, ends = native.scan_blocks(comp)
    hdr = _parse_block_header(comp, headers[0])
    _, _, _, thr = decode_tables_arrays(hdr["tables"])
    rows = np.zeros((thr.shape[0] + 1, 21), np.int32)
    rows[1:] = thr  # row 0 = the zero row used for padded table slots
    lut = np.asarray(build_len_luts(jnp.asarray(rows)))
    v23 = np.concatenate(
        [rng.integers(0, 1 << 23, 5000), np.asarray([0, 7, 8, (1 << 23) - 1])]
    ).astype(np.int64)
    for u in range(rows.shape[0]):
        want = np.searchsorted(rows[u], v23, side="right")
        got = lut[u, v23 >> 3].astype(np.int64)
        np.testing.assert_array_equal(got, want)


def test_device_decode_counts_no_fallback_on_single_member():
    import warnings

    from bz2tpu.runtime.device_decode import fallback_stats

    data = b"single member stream " * 3000
    before = sum(fallback_stats.values())
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        assert decompress_device(stdlib_bz2.compress(data, 1)) == data
    assert sum(fallback_stats.values()) == before


def test_device_decode_counts_and_warns_multi_member_fallback():
    from bz2tpu.runtime.device_decode import fallback_stats

    a, b = b"first member " * 500, b"second member " * 700
    before = sum(fallback_stats.values())
    with pytest.warns(RuntimeWarning, match="host decoder used"):
        assert decompress_device(stdlib_bz2.compress(a, 1) + stdlib_bz2.compress(b, 1)) == a + b
    assert sum(fallback_stats.values()) >= before + 1
