"""Native (C) decoder: differential vs stdlib bz2 and the NumPy decoder."""

import bz2 as stdlib_bz2
import os

import numpy as np
import pytest

from bz2tpu import native
from bz2tpu.format.crc32 import crc32_serial
from bz2tpu.oracle import compress as oracle_compress
from bz2tpu.runtime.decompressor import Bz2CrcError, Bz2FormatError, decompress

from conftest import CORPUS_KINDS, make_corpus

pytestmark = pytest.mark.skipif(not native.HAVE_NATIVE, reason="extension not built")


@pytest.mark.parametrize("kind", CORPUS_KINDS)
def test_decodes_stock_streams(rng, kind):
    data = make_corpus(rng, kind, 300_000)
    for level in (1, 9):
        assert native.decode_stream(stdlib_bz2.compress(data, level)) == data


@pytest.mark.parametrize("kind", ["text", "runs"])
def test_decodes_our_streams(rng, kind):
    data = make_corpus(rng, kind, 150_000)
    assert native.decode_stream(oracle_compress(data, level=1)) == data


def test_empty_and_tiny():
    assert native.decode_stream(stdlib_bz2.compress(b"")) == b""
    assert native.decode_stream(stdlib_bz2.compress(b"x")) == b"x"


def test_crc32_matches_serial(rng):
    for size in (0, 1, 100, 65537):
        data = make_corpus(rng, "random", size)
        assert native.crc32(data) == crc32_serial(data)


def test_corruption_raises(rng):
    data = make_corpus(rng, "text", 50_000)
    comp = bytearray(stdlib_bz2.compress(data, 1))
    comp[len(comp) // 2] ^= 0x40
    with pytest.raises(ValueError):
        native.decode_stream(bytes(comp))


def test_crc_error_type(rng):
    # Flip a bit in the stored block CRC field (bit offset 32+48 = byte 10).
    data = make_corpus(rng, "text", 50_000)
    comp = bytearray(oracle_compress(data, level=1))
    comp[10] ^= 0x01
    with pytest.raises(Bz2CrcError):
        decompress(bytes(comp))
    with pytest.raises((Bz2FormatError, Bz2CrcError)):
        decompress(b"BZh9" + b"\x00" * 20)


def test_truncated_stream_raises(rng):
    data = make_corpus(rng, "text", 50_000)
    comp = stdlib_bz2.compress(data, 1)
    with pytest.raises(ValueError):
        native.decode_stream(comp[: len(comp) // 2])


def test_driver_uses_native(rng):
    data = make_corpus(rng, "zeros", 100_000)
    assert decompress(stdlib_bz2.compress(data, 1)) == data


def test_parallel_decode_matches(rng):
    from bz2tpu.runtime.decompressor import _decompress_parallel

    data = make_corpus(rng, "text", 2_000_000)
    comp = stdlib_bz2.compress(data, 1)  # many blocks
    out = _decompress_parallel(comp, True)
    assert out == data


def test_parallel_decode_crc_detects_corruption(rng):
    from bz2tpu.runtime.decompressor import _decompress_parallel, decompress

    data = make_corpus(rng, "text", 2_000_000)
    comp = bytearray(stdlib_bz2.compress(data, 1))
    # Flip several spread-out bytes so at least one provably corrupts
    # decoded content (a single flip can land in a dead table entry).
    for off in range(100, 2000, 250):
        comp[off] ^= 0x10
    # The optimistic parallel path may either detect the corruption itself
    # or signal fallback (None); the public driver must always raise.
    try:
        assert _decompress_parallel(bytes(comp), True) is None
    except ValueError:
        pass
    with pytest.raises(ValueError):
        decompress(bytes(comp))


def test_scan_blocks_offsets(rng):
    data = make_corpus(rng, "text", 500_000)
    comp = stdlib_bz2.compress(data, 1)
    headers, ends = native.scan_blocks(comp)
    assert headers and headers[0] == 32
    assert len(ends) >= 1
    # First header decodes and chains to the second.
    out, crc, end_bit = native.decode_block_at(comp, headers[0], 1, True)
    assert len(out) > 0
    if len(headers) > 1:
        assert end_bit == headers[1]


def test_multi_member_streams(rng):
    # Stock bzip2 / stdlib bz2 decode concatenated members; so do we, in
    # both decoders, including mixed levels and ignored trailing garbage.
    from bz2tpu.oracle.decoder import decompress as np_dec

    a = make_corpus(rng, "text", 40_000)
    b = make_corpus(rng, "runs", 30_000)
    comp = stdlib_bz2.compress(a, 1) + stdlib_bz2.compress(b, 9)
    assert native.decode_stream(comp) == a + b
    assert np_dec(comp) == a + b
    assert decompress(comp) == a + b
    # trailing garbage after a complete member is ignored (stdlib parity)
    assert native.decode_stream(comp + b"garbage") == a + b
    assert np_dec(comp + b"garbage") == a + b


def test_trailing_bzh_prefixed_garbage(rng):
    # stdlib ignores ANY undecodable trailing data once >= 1 member decoded,
    # including junk that merely starts with a plausible "BZh9" header.
    from bz2tpu.oracle.decoder import decompress as np_dec

    data = make_corpus(rng, "text", 20_000)
    comp = stdlib_bz2.compress(data, 1)
    junk = comp + b"BZh9 definitely not a stream"
    assert stdlib_bz2.decompress(junk) == data  # stdlib reference behavior
    assert native.decode_stream(junk) == data
    assert np_dec(junk) == data
    # But a corrupt FIRST member still raises everywhere.
    bad = bytearray(comp)
    bad[8] ^= 0xFF
    with pytest.raises(ValueError):
        native.decode_stream(bytes(bad))
    with pytest.raises(ValueError):
        np_dec(bytes(bad))


def test_recover_damaged_stream(rng):
    from bz2tpu.runtime.decompressor import recover

    # 4-block stream at level 1; corrupt the SECOND block's data.
    data = make_corpus(rng, "text", 350_000)
    comp = bytearray(stdlib_bz2.compress(data, 1))
    headers, _ = native.scan_blocks(bytes(comp))
    assert len(headers) >= 3
    hurt = (headers[1] // 8) + 40  # well inside block 2
    comp[hurt] ^= 0xFF
    out, ok, total = recover(bytes(comp))
    assert ok == total - 1
    # Recovered bytes = original minus the damaged block's contribution:
    # the surviving prefix must match and the tail must be a suffix.
    assert data.startswith(out[: 50_000])
    assert data.endswith(out[-50_000:])
    # Fully intact stream recovers everything.
    full, ok2, total2 = recover(stdlib_bz2.compress(data, 1))
    assert full == data and ok2 == total2


def test_decompress_file(tmp_path, rng):
    from bz2tpu.runtime.decompressor import decompress_file

    # Multi-block parallel-chained file.
    data = make_corpus(rng, "text", 400_000)
    src = tmp_path / "a.bz2"
    src.write_bytes(stdlib_bz2.compress(data, 1))
    decompress_file(str(src), str(tmp_path / "a.out"))
    assert (tmp_path / "a.out").read_bytes() == data

    # Multi-member file: chain breaks -> whole-buffer fallback.
    b = make_corpus(rng, "runs", 120_000)
    src2 = tmp_path / "b.bz2"
    src2.write_bytes(stdlib_bz2.compress(data, 1) + stdlib_bz2.compress(b, 9))
    decompress_file(str(src2), str(tmp_path / "b.out"))
    assert (tmp_path / "b.out").read_bytes() == data + b

    # Corrupt file: raises, no output left behind.
    bad = bytearray(stdlib_bz2.compress(data, 1))
    bad[50] ^= 0xFF
    src3 = tmp_path / "c.bz2"
    src3.write_bytes(bytes(bad))
    with pytest.raises(ValueError):
        decompress_file(str(src3), str(tmp_path / "c.out"))
    assert not (tmp_path / "c.out").exists()


def test_decompress_file_sequential_fallback_semantics(tmp_path, rng):
    """The bounded-memory sequential fallback must match decode_stream's
    multi-member / trailing-data semantics (_bz2dec.c:424-500)."""
    from bz2tpu.runtime.decompressor import decompress_file

    a = make_corpus(rng, "text", 250_000)
    b = make_corpus(rng, "runs", 90_000)
    # Multi-member (level change breaks the parallel chain) + junk tail
    # that is NOT a magic prefix: ignored.
    src = tmp_path / "junk.bz2"
    src.write_bytes(
        stdlib_bz2.compress(a, 1) + stdlib_bz2.compress(b, 9) + b"\x00garbage"
    )
    decompress_file(str(src), str(tmp_path / "junk.out"))
    assert (tmp_path / "junk.out").read_bytes() == a + b

    # Second member TRUNCATED mid-stream: raises (stdlib parity), nothing
    # left behind.
    second = stdlib_bz2.compress(b, 9)
    src2 = tmp_path / "trunc.bz2"
    src2.write_bytes(stdlib_bz2.compress(a, 1) + second[: len(second) // 2])
    with pytest.raises(ValueError):
        decompress_file(str(src2), str(tmp_path / "trunc.out"))
    assert not (tmp_path / "trunc.out").exists()

    # Second member CORRUPT: differential vs decode_stream — either both
    # roll back to the first member, or both raise (a corruption that
    # reads as truncation re-raises in both).
    broken = bytearray(second)
    broken[20] ^= 0xFF
    src3 = tmp_path / "roll.bz2"
    src3.write_bytes(stdlib_bz2.compress(a, 1) + bytes(broken))
    try:
        expect = native.decode_stream(src3.read_bytes())
    except ValueError:
        expect = None
    if expect is None:
        with pytest.raises(ValueError):
            decompress_file(str(src3), str(tmp_path / "roll.out"))
    else:
        decompress_file(str(src3), str(tmp_path / "roll.out"))
        assert (tmp_path / "roll.out").read_bytes() == expect

    # A bare magic PREFIX after a complete member: truncated, raises.
    src4 = tmp_path / "prefix.bz2"
    src4.write_bytes(stdlib_bz2.compress(a, 1) + b"BZ")
    with pytest.raises(ValueError):
        decompress_file(str(src4), str(tmp_path / "prefix.out"))


def test_parallel_decode_multimember(rng):
    # The optimistic block-parallel path now chains MEMBERS too (pbzip2-
    # style concatenated streams, mixed levels), with per-member stream
    # CRC folds; equality against stdlib on the same bytes.
    from bz2tpu.runtime.decompressor import _decompress_parallel

    a = make_corpus(rng, "text", 500_000)
    b = make_corpus(rng, "runs", 300_000)
    c = make_corpus(rng, "random", 120_000)
    comp = (
        stdlib_bz2.compress(a, 1)
        + stdlib_bz2.compress(b, 9)
        + stdlib_bz2.compress(c, 2)
    )
    assert _decompress_parallel(comp, True) == a + b + c
    assert decompress(comp) == a + b + c
    # Trailing junk after the final member is ignored on the fast path
    # (sequential decode_stream parity) unless it is magic-like.
    assert _decompress_parallel(comp + b"\x00junk", True) == a + b + c
    # Truncated magic / empty member tails defer to sequential (None).
    assert _decompress_parallel(comp + b"BZh9", True) is None
    # A corrupted middle member must not pass.
    bad = bytearray(comp)
    mid = len(stdlib_bz2.compress(a, 1)) + 200
    for off in range(mid, mid + 1500, 200):
        bad[off] ^= 0x08
    try:
        assert _decompress_parallel(bytes(bad), True) is None
    except ValueError:
        pass


def test_parallel_decode_multimember_pbzip2_style(rng):
    # Many small same-level members (what pbzip2 emits: one member per
    # worker chunk) — the common real-world multi-member shape.
    from bz2tpu.runtime.decompressor import _decompress_parallel

    parts = [make_corpus(rng, "text", 150_000 + 7 * i) for i in range(6)]
    comp = b"".join(stdlib_bz2.compress(p, 1) for p in parts)
    assert _decompress_parallel(comp, True) == b"".join(parts)
    assert decompress(comp) == b"".join(parts)


def test_decompress_file_multimember_parallel(tmp_path, rng):
    # decompress_file's sliding-window path also chains members now.
    from bz2tpu.runtime.decompressor import decompress_file

    parts = [make_corpus(rng, "text", 200_000 + 13 * i) for i in range(4)]
    comp = b"".join(stdlib_bz2.compress(p, 1) for p in parts)
    src = tmp_path / "in.bz2"
    dst = tmp_path / "out.bin"
    src.write_bytes(comp)
    decompress_file(str(src), str(dst))
    assert dst.read_bytes() == b"".join(parts)


def test_rle1_split_matches_stock_block_spans(rng):
    """Round 5: our block boundaries must be byte-identical to libbz2's
    (bzlib nblockMAX = 100000*level - 19, block cut at the FIRST crossing
    piece, in-progress run carried to the next block). Stock's own spans
    are extracted by decoding each block of its stream independently."""
    import numpy as np

    from bz2tpu import native
    from bz2tpu.oracle.encoder import rle1_split

    seg = lambda n, lo, hi: rng.integers(lo, hi, n, dtype=np.uint8)  # noqa: E731
    data = np.concatenate([
        seg(220_000, 97, 123),          # text-ish
        np.full(130_000, 65, np.uint8),  # one giant run (255-piece chains)
        seg(150_000, 0, 256),            # incompressible
        np.repeat(seg(4_000, 0, 4), 60).astype(np.uint8),  # short runs
    ])
    for lv in (1, 2, 3):
        ours = rle1_split(data, lv)
        nat = native.rle1_split(data.tobytes(), lv)
        assert [bytes(b) for b, _, _ in nat] == [b.data.tobytes() for b in ours]
        stock = stdlib_bz2.compress(data.tobytes(), lv)
        headers, _ = native.scan_blocks(stock)
        spans = []
        for h in headers:
            r = native.decode_block_at(stock, h, lv, False)
            spans.append(len(r[0]) if isinstance(r, tuple) else len(r))
        assert spans == [b.raw_length for b in ours], lv


def _copy_source(tmp_path):
    import shutil

    src = tmp_path / "_bz2dec.c"
    shutil.copy(os.path.join(os.path.dirname(native.__file__), "_bz2dec.c"), src)
    return str(src), str(tmp_path / ("_bz2dec" + os.path.splitext(native._SO)[1]))


def test_loader_rebuilds_so_older_than_source(tmp_path, monkeypatch):
    import importlib.util

    monkeypatch.delenv("BZ2TPU_NO_NATIVE_BUILD", raising=False)
    src, so = _copy_source(tmp_path)
    with open(so, "wb") as f:
        f.write(b"a stale build")
    os.utime(so, (1, 1))  # far older than the source
    assert native._is_stale(so, src)
    assert native._build(src, so)
    assert not native._is_stale(so, src)
    spec = importlib.util.spec_from_file_location("_bz2dec", so)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.crc32(b"123456789") == native.crc32(b"123456789") == 0xFC891918


def test_loader_missing_so_is_stale_and_build_can_be_disabled(tmp_path, monkeypatch):
    src, so = _copy_source(tmp_path)
    assert native._is_stale(so, src)
    monkeypatch.setenv("BZ2TPU_NO_NATIVE_BUILD", "1")
    assert not native._build(src, so)
    assert not os.path.exists(so)
