"""End-to-end smoke run of bz2tpu on one NVIDIA GPU.

    python chip_smoke.py               # every phase, one card
    python chip_smoke.py --multichip   # the block-sharded path on 4 cards only

It drives the main paths through the entry points a user calls —
``bz2tpu.compress``, ``bz2tpu.decompress``, ``bz2tpu.decompress_device``,
``compress_device_intake``, ``StreamCompressor`` and the CLI (in-process,
so that one process holds the card) — at production block size (level 9,
900 kB blocks), and checks every stream byte for byte against the NumPy
oracle (``bz2tpu.oracle``) and stdlib ``bz2``. Each phase prints one JSON
line with its result and its walls (first call, compile included, and
second call), and every line names the card and its power limit. The last
line is the contract line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``,
printed only after every phase passed; any failure exits non-zero.

The phases are functions that take their sizes as arguments, so the tests
run each of them at a tiny size on the CPU; the GPU requirement lives in
``main()`` alone. ``--expect-warm`` makes the run fail unless it compiled
nothing (a second run against the same ``JAX_COMPILATION_CACHE_DIR``).
"""

from __future__ import annotations

import argparse
import bz2
import hashlib
import json
import os
import sys
import tempfile
import time

MB = 1_000_000
# Phase 1's corpus: 16 full level-9 blocks, two batches of the default width 8.
CORPUS_BYTES = 16 * 900_000


def _timed(fn, *args, **kw):
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    return out, time.perf_counter() - t0


def _twice(fn, *args, **kw):
    """Run fn twice; return (result, walls): the first call compiles, the
    second shows the steady state. Both results must be identical."""
    first, w1 = _timed(fn, *args, **kw)
    second, w2 = _timed(fn, *args, **kw)
    if first != second:
        raise AssertionError(f"{getattr(fn, '__name__', fn)}: two calls disagree")
    return second, {"first_s": w1, "second_s": w2}


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def phase_environment() -> dict:
    """Phase 0: what runs, and the native extension is really there."""
    import jax

    from bz2tpu import native

    _check(native.HAVE_NATIVE, "bz2tpu.native.HAVE_NATIVE is false")
    d = jax.devices()[0]
    return {
        "jax": jax.__version__,
        "platform": d.platform,
        "device_kind": d.device_kind,
        "device_count": len(jax.devices()),
        "XLA_FLAGS": os.environ.get("XLA_FLAGS", ""),
        "JAX_COMPILATION_CACHE_DIR": os.environ.get("JAX_COMPILATION_CACHE_DIR"),
    }


def phase_compress(data: bytes, level: int) -> tuple[dict, bytes]:
    """Phase 1: ``bz2tpu.compress`` is byte-identical to the oracle, decodes
    with stdlib bz2, and is no larger than stock bzip2."""
    import bz2tpu
    from bz2tpu import oracle

    out, walls = _twice(bz2tpu.compress, data, level=level)
    _check(bz2.decompress(out) == data, "stdlib bz2 does not decode our stream")
    want, oracle_s = _timed(oracle.compress, data, level=level)
    _check(out == want, "stream differs from bz2tpu.oracle.compress")
    stock = bz2.compress(data, level)
    _check(len(out) <= len(stock), f"larger than stock: {len(out)} > {len(stock)}")
    return {
        "level": level,
        "input_bytes": len(data),
        "input_sha256": hashlib.sha256(data).hexdigest(),
        "out_bytes": len(out),
        "stock_bytes": len(stock),
        "oracle_identical": True,
        "oracle_s": oracle_s,
        **walls,
    }, out


def phase_level1_and_worst(data: bytes, worst: bytes, level_worst: int) -> dict:
    """Phase 2: level 1 byte-identical to the oracle, and the periodic worst
    case (full BWT round count) round-tripped through stdlib bz2."""
    import bz2tpu
    from bz2tpu import oracle

    out1, walls1 = _twice(bz2tpu.compress, data, level=1)
    _check(out1 == oracle.compress(data, level=1), "level 1 differs from the oracle")
    _check(bz2.decompress(out1) == data, "level 1 does not decode")
    outw, wallsw = _twice(bz2tpu.compress, worst, level=level_worst)
    _check(bz2.decompress(outw) == worst, "worst case does not decode")
    return {
        "level1": {"input_bytes": len(data), "out_bytes": len(out1),
                   "oracle_identical": True, **walls1},
        "worst_case": {"level": level_worst, "input_bytes": len(worst),
                       "out_bytes": len(outw), **wallsw},
    }


def phase_decode(data: bytes, own: bytes, level: int) -> dict:
    """Phase 3: the stock stream and our own, each decoded twice by the
    host C decoder and twice on the device, with no host fallback."""
    import bz2tpu
    from bz2tpu.runtime.device_decode import fallback_stats

    before = sum(fallback_stats.values())
    res = {}
    for name, stream in (("stock", bz2.compress(data, level)), ("own", own)):
        got, host = _twice(bz2tpu.decompress, stream)
        _check(got == data, f"host decode of the {name} stream differs")
        got, dev = _twice(bz2tpu.decompress_device, stream)
        _check(got == data, f"device decode of the {name} stream differs")
        res[name] = {"stream_bytes": len(stream), "host": host, "device": dev}
    fallbacks = sum(fallback_stats.values()) - before
    _check(fallbacks == 0, f"device decode fell back: {dict(fallback_stats)}")
    res["device_decode_fallbacks"] = fallbacks
    return res


def phase_entry_points(data: bytes, cli_bytes: int, intake_bytes: int,
                       level: int, chunk: int = MB) -> dict:
    """Phase 4: the CLI in-process, the device-intake compressor, and
    ``StreamCompressor`` fed ``chunk``-byte pieces."""
    import io

    import bz2tpu
    from bz2tpu.cli import main as cli

    res = {}
    small = data[:cli_bytes]
    with tempfile.TemporaryDirectory() as td:
        src = os.path.join(td, "in.bin")
        with open(src, "wb") as f:
            f.write(small)
        comp = src + ".bz2"
        rt = os.path.join(td, "rt.bin")
        stock_bz2 = os.path.join(td, "stock.bz2")
        with open(stock_bz2, "wb") as f:
            f.write(bz2.compress(small, level))
        walls = {}
        for name, argv in (
            ("compress", [src, "--size", str(level), "-o", comp]),
            ("check", [comp, "--check"]),
            ("dec", [comp, "--dec", "-o", rt]),
            ("dec_stock", [stock_bz2, "--dec", "-o", rt + ".stock"]),
        ):
            rc, walls[name] = _timed(cli, argv)
            _check(rc == 0, f"CLI {name} exited {rc}")
        with open(comp, "rb") as f:
            _check(bz2.decompress(f.read()) == small, "CLI stream does not decode")
        for path in (rt, rt + ".stock"):
            with open(path, "rb") as f:
                _check(f.read() == small, f"CLI --dec output differs ({path})")
    res["cli"] = {"input_bytes": len(small), "walls_s": walls}

    part = data[:intake_bytes]
    out, walls = _twice(bz2tpu.compress_device_intake, part, level=level)
    _check(bz2.decompress(out) == part, "device-intake stream does not decode")
    res["device_intake"] = {"input_bytes": len(part), "out_bytes": len(out), **walls}

    def stream_compress() -> bytes:
        sink = io.BytesIO()
        sc = bz2tpu.StreamCompressor(sink, level=level)
        for i in range(0, len(data), chunk):
            sc.write(data[i : i + chunk])
        sc.close()
        return sink.getvalue()

    out, walls = _twice(stream_compress)
    _check(bz2.decompress(out) == data, "StreamCompressor stream does not decode")
    res["stream_compressor"] = {"input_bytes": len(data), "chunk_bytes": chunk,
                                "out_bytes": len(out), **walls}
    return res


def phase_memory_and_cache(compiles) -> dict:
    """Phase 5: peak device memory and this run's compile counts."""
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return {
        "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
        "fresh_compiles": compiles.fresh,
        "cache_hits": compiles.cache_hits,
    }


def multichip(data: bytes, level: int, n_devices: int) -> dict:
    """The block-sharded path: ``data``'s blocks encoded on a
    ``block_mesh(n_devices)`` and stitched collectively must equal the
    one-device stream of the same blocks byte for byte and decode with
    stdlib bz2."""
    import jax.numpy as jnp
    import numpy as np

    import bz2tpu
    from bz2tpu.format import constants as C
    from bz2tpu.parallel.mesh import block_mesh, encode_blocks_sharded
    from bz2tpu.parallel.stitch import stitch_stream_sharded
    from bz2tpu.runtime.compressor import split_blocks

    blocks = split_blocks(data, level)
    n_live = len(blocks)
    B = -(-n_live // n_devices) * n_devices  # padding rows carry 0 bits
    buf = np.zeros((B, C.BLOCK_SIZE_BASE * level), np.uint8)
    ns = np.ones(B, np.int32)
    crcs = np.zeros(B, np.uint32)
    for i, blk in enumerate(blocks):
        buf[i, : blk.data.size] = blk.data
        ns[i] = blk.data.size
        crcs[i] = blk.crc
    mesh = block_mesh(n_devices)

    def sharded() -> bytes:
        out = encode_blocks_sharded(
            jnp.asarray(buf), jnp.asarray(ns), jnp.asarray(crcs), mesh=mesh
        )
        bits = np.asarray(out["total_bits"]).astype(np.int32)
        bits[n_live:] = 0
        stream, _ = stitch_stream_sharded(
            out["words"], jnp.asarray(bits), jnp.asarray(crcs), n_live, level,
            mesh=mesh,
        )
        return stream

    got, walls = _twice(sharded)
    want, single_s = _timed(bz2tpu.compress, data, level=level)
    _check(got == want, "sharded stream differs from the one-device stream")
    _check(bz2.decompress(got) == data, "sharded stream does not decode")
    return {
        "n_devices": n_devices,
        "blocks": n_live,
        "level": level,
        "input_bytes": len(data),
        "stream_bytes": len(got),
        "identical_to_single_device": True,
        "single_device_s": single_s,
        **walls,
    }


def first_blocks(data: bytes, level: int, n_blocks: int) -> bytes:
    """The prefix of ``data`` that splits into exactly its first
    ``n_blocks`` blocks."""
    from bz2tpu.runtime.compressor import split_blocks

    blocks = split_blocks(data, level)[:n_blocks]
    _check(len(blocks) == n_blocks, f"corpus holds fewer than {n_blocks} blocks")
    return data[: sum(b.raw_length for b in blocks)]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multichip", action="store_true",
                    help="run only the 4-card block-sharded path")
    ap.add_argument("--expect-warm", action="store_true",
                    help="fail unless this run compiled nothing")
    args = ap.parse_args(argv)

    # A CUDA plugin that fails to load must raise, not fall back to the CPU.
    os.environ.setdefault("JAX_PLATFORMS", "cuda")
    import jax

    from bz2tpu.utils.device import gpu_card, require_gpu
    from bz2tpu.utils.jaxenv import CompileCounter, setup_compilation_cache

    device = require_gpu()
    setup_compilation_cache()  # before the first compile (jaxenv docstring)
    card = gpu_card()
    print(json.dumps({"card": card}), flush=True)

    def emit(phase: str, result: dict, wall: float) -> None:
        print(json.dumps({"phase": phase, "ok": True, "card": card,
                          "phase_wall_s": wall, **result}), flush=True)

    import bench

    level = 9
    if args.multichip:
        n = 4
        _check(len(jax.devices()) >= n, f"--multichip needs {n} devices")
        data = first_blocks(bench.make_mixed_corpus(CORPUS_BYTES), level, 2 * n)
        t0 = time.perf_counter()
        emit("multichip", multichip(data, level, n), time.perf_counter() - t0)
    else:
        with CompileCounter() as compiles:
            t0 = time.perf_counter()
            emit("environment", phase_environment(), time.perf_counter() - t0)
            data = bench.make_mixed_corpus(CORPUS_BYTES)
            t0 = time.perf_counter()
            res, own = phase_compress(data, level)
            emit("compress", res, time.perf_counter() - t0)
            t0 = time.perf_counter()
            res = phase_level1_and_worst(
                data[: 24 * 100_000], bench.worst_case_data(8 * 900_000), level
            )
            emit("level1_and_worst", res, time.perf_counter() - t0)
            t0 = time.perf_counter()
            emit("decode", phase_decode(data, own, level), time.perf_counter() - t0)
            t0 = time.perf_counter()
            res = phase_entry_points(data, 24 * 100_000, 8 * 900_000, level)
            emit("entry_points", res, time.perf_counter() - t0)
        res = phase_memory_and_cache(compiles)
        if args.expect_warm:
            _check(compiles.fresh == 0, f"warm run compiled {compiles.fresh} programs")
        emit("memory_and_cache", res, 0.0)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
