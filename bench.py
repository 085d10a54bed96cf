"""bz2tpu benchmark: steady-state compress throughput on the GPU.

Prints one JSON record per line; the LAST line is the headline:
  {"metric": "compress_throughput", "value": <MB/s>, "unit": "MB/s",
   "vs_baseline": <ours / stock-libbz2-single-core>, "device": {...}}

Corpus (BASELINE.md configs ask for real corpora, not toy text): a
deterministic Silesia-style MIX of real source text (the installed numpy
and jax packages), an ELF binary (numpy's extension modules), Markov text,
structured runs and random bytes in fixed proportions. The text and binary
parts come from the installed packages, so the corpus depends on their
versions: every run prints the corpus sha256, and a changed hash means a
different corpus. Baseline is stdlib bz2 (libbz2, one core) at the same
level on the same data — the reference's own comparison target ("competes
with and can surpass the original library", thesis p. 33). Output is
round-trip-verified through stdlib bz2 before any number is reported, and
any failed sub-measurement fails the run.

The run refuses a machine whose JAX default device is not a GPU; every
record names the device, and the headline names the card and its power
limit.
"""

from __future__ import annotations

import bz2 as stdlib_bz2
import glob
import json
import os
import sys
import sysconfig
import time

import numpy as np

LEVEL = 9
N_BLOCKS = 16  # two batches of 8: exercises dispatch/fetch pipelining
BATCH = 8
WORDS = [b"the ", b"quick ", b"brown ", b"fox ", b"jumps  ", b"over\n", b"lazy ", b"dog. "]


def make_text(nbytes: int, seed: int) -> bytes:
    r = np.random.default_rng(seed)
    parts = []
    size = 0
    while size < nbytes:
        w = WORDS[int(r.integers(len(WORDS)))]
        parts.append(w)
        size += len(w)
    return b"".join(parts)[:nbytes]


def _real_text(nbytes: int) -> bytes:
    """Real source text from the installed packages, no repetition."""
    site = sysconfig.get_paths()["purelib"]
    src = []
    size = 0
    seen: set[str] = set()
    # Widening pool ladder: numpy/jax sources first, then every
    # site-packages .py, so even a 100 MB corpus is genuine source text.
    # Paths dedupe so nothing repeats (repetition flatters compressors).
    for pat in (os.path.join(site, "numpy", "**", "*.py"),
                os.path.join(site, "jax", "_src", "*.py"),
                os.path.join(site, "**", "*.py")):
        if size > nbytes:
            break
        for p in sorted(glob.glob(pat, recursive=True)):
            if p in seen:
                continue
            seen.add(p)
            try:
                with open(p, "rb") as f:
                    src.append(f.read())
            except OSError:
                continue
            size += len(src[-1])
            if size > nbytes:
                break
    blob = b"".join(src)
    if len(blob) < nbytes:  # pad with Markov text, never by repetition
        blob += make_text(nbytes - len(blob), 7)
    return blob[:nbytes]


def _binary(nbytes: int) -> bytes:
    site = sysconfig.get_paths()["platlib"]
    for p in sorted(glob.glob(os.path.join(site, "numpy", "_core", "*.so"))):
        with open(p, "rb") as f:
            b = f.read()
        if len(b) >= nbytes:
            return b[:nbytes]
    return np.random.default_rng(3).integers(0, 256, nbytes, dtype=np.uint8).tobytes()


def _runs(nbytes: int, seed: int) -> bytes:
    r = np.random.default_rng(seed)
    vals = r.integers(0, 16, 4096, dtype=np.uint8)
    lens = r.integers(1, 600, 4096)
    return np.repeat(vals, lens).tobytes()[:nbytes]


def make_mixed_corpus(nbytes: int) -> bytes:
    """Silesia-style deterministic mix: 40% real text, 15% binary, 20%
    Markov text, 15% structured runs, 10% random."""
    spec = [
        (0.40, lambda n: _real_text(n)),
        (0.15, lambda n: _binary(n)),
        (0.20, lambda n: make_text(n, 11)),
        (0.15, lambda n: _runs(n, 13)),
        (0.10, lambda n: np.random.default_rng(17).integers(0, 256, n, dtype=np.uint8).tobytes()),
    ]
    parts = []
    for frac, fn in spec:
        parts.append(fn(int(nbytes * frac)))
    blob = b"".join(parts)
    if len(blob) < nbytes:
        blob += make_text(nbytes - len(blob), 19)
    return blob[:nbytes]


def corpus_provenance(data: bytes) -> dict:
    """The corpus is deterministic given the installed packages; the hash
    says whether two runs compressed the same bytes."""
    import hashlib

    return {
        "sha256": hashlib.sha256(data).hexdigest(),
        "composition": "40% installed-package source text (numpy, jax), "
                       "15% numpy ELF .so, 20% seeded Markov text, 15% "
                       "seeded runs, 10% seeded random",
        "regenerate": "python -c \"import bench; bench.make_mixed_corpus(N)\"",
    }


def worst_case_data(n: int) -> bytes:
    """BWT worst case (BASELINE 'repetitive/low-entropy' config): a
    251-byte cycle of distinct values — RLE1 cannot collapse it and every
    suffix shares long periodic context, so prefix doubling runs its full
    round count (the input class the reference needed a TRBudget escape
    hatch for, kernel.cpp:2109-2142)."""
    cycle = bytes(range(1, 252))
    return (cycle * (n // len(cycle) + 1))[:n]


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"bench: {what}")


def _timed(fn, *args, **kw):
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    return out, time.perf_counter() - t0


def _worst_case() -> dict:
    """The periodic worst case at the main run's batch shapes (no extra
    compiles), round-trip verified."""
    from bz2tpu.runtime.compressor import compress

    n = 8 * 9 * 100_000
    data = worst_case_data(n)
    compress(data, level=LEVEL, parallel=BATCH)  # warm shapes
    out, dt = _timed(compress, data, level=LEVEL, parallel=BATCH)
    _check(stdlib_bz2.decompress(out) == data, "worst case round trip")
    return {"mb_s": n / dt / 1e6, "ratio": len(out) / n}


def _device_intake() -> dict:
    """Fully-device compress (RLE1 + splitting + CRC on the device, zero
    host passes over raw bytes — the no-C-extension path, `--backend
    device`). One batch of 8 level-9 blocks; round-trip verified."""
    from bz2tpu.runtime.compressor import compress_device_intake

    n = 8 * 9 * 100_000
    data = make_mixed_corpus(n)
    compress_device_intake(data, level=LEVEL, parallel=BATCH)  # warm
    out, dt = _timed(compress_device_intake, data, level=LEVEL, parallel=BATCH)
    _check(stdlib_bz2.decompress(out) == data, "device intake round trip")
    return {"mb_s": n / dt / 1e6}


def _stock_decompress_sweep(levels=(1, 5, 9)) -> dict:
    """Decompress STOCK-produced streams (foreign bitstreams, the
    interop-critical direction) with our host decoder at several levels."""
    from bz2tpu.runtime.decompressor import decompress as our_decompress

    out = {}
    for lv in levels:
        n = 2 * 100_000 * lv
        data = make_mixed_corpus(n)
        stream = stdlib_bz2.compress(data, lv)
        got, dt = _timed(our_decompress, stream)
        _check(got == data, f"host decode of a stock level-{lv} stream")
        out[str(lv)] = {"mb_s": n / dt / 1e6}
    return out


def _device_decode() -> dict:
    """Device decode (Huffman+MTF+IBWT on the GPU) of a stock 2-block
    level-1 stream; a host fallback fails the run."""
    from bz2tpu.format import constants as C
    from bz2tpu.runtime.device_decode import decompress_device, fallback_stats

    data = make_mixed_corpus(2 * C.BLOCK_SIZE_BASE)
    stream = stdlib_bz2.compress(data, 1)
    before = sum(fallback_stats.values())
    decompress_device(stream)  # compile
    got, dt = _timed(decompress_device, stream)
    _check(got == data, "device decode mismatch")
    _check(sum(fallback_stats.values()) == before, f"device decode fell back: {dict(fallback_stats)}")
    return {"mb_s": len(data) / dt / 1e6}


def _ratio_sweep(levels=(1, 9)) -> dict:
    """Ratio parity vs stock on a 2-block slice per level (cached shapes)."""
    from bz2tpu.format import constants as C
    from bz2tpu.runtime.compressor import compress

    out = {}
    for lv in levels:
        n = 2 * C.BLOCK_SIZE_BASE * lv
        data = make_mixed_corpus(n)
        ours = compress(data, level=lv, parallel=2)
        _check(stdlib_bz2.decompress(ours) == data, f"level-{lv} round trip")
        stock = stdlib_bz2.compress(data, lv)
        out[str(lv)] = {"ratio": len(ours) / n, "stock_ratio": len(stock) / n}
    return out


def main() -> int:
    from bz2tpu.format import constants as C
    from bz2tpu.runtime.compressor import compress
    from bz2tpu.utils.device import gpu_card, require_gpu
    from bz2tpu.utils.jaxenv import CompileCounter, setup_compilation_cache

    setup_compilation_cache()  # before the first compile (jaxenv docstring)
    device = require_gpu()
    device["card"] = gpu_card()
    print(json.dumps({"record": "device", "value": device}), flush=True)

    nbytes = N_BLOCKS * C.BLOCK_SIZE_BASE * LEVEL
    data = make_mixed_corpus(nbytes)
    warm = make_mixed_corpus(nbytes)[: nbytes // 2] + make_text(nbytes - nbytes // 2, 42)

    # A primed cache should show 0 fresh compiles during warmup.
    t0 = time.perf_counter()
    with CompileCounter() as compiles:
        compress(warm, level=LEVEL, parallel=BATCH)  # compile + warm caches
        compress(warm, level=LEVEL, parallel=BATCH)
    warm_s = time.perf_counter() - t0

    # Median of three timed runs (all samples recorded); every run is
    # round-trip-verified.
    ours_samples = []
    for _ in range(3):
        out, dt = _timed(compress, data, level=LEVEL, parallel=BATCH)
        ours_samples.append(dt)
        _check(stdlib_bz2.decompress(out) == data, "level-9 round trip")
    ours = nbytes / sorted(ours_samples)[1] / 1e6

    stock_samples = []
    for _ in range(3):
        stock, dt = _timed(stdlib_bz2.compress, data, LEVEL)
        stock_samples.append(dt)
    stock_mbps = nbytes / sorted(stock_samples)[1] / 1e6

    from bz2tpu.runtime.decompressor import decompress as our_decompress

    _, dt = _timed(our_decompress, out)
    dec_mbps = nbytes / dt / 1e6
    _, dt = _timed(stdlib_bz2.decompress, out)
    stock_dec_mbps = nbytes / dt / 1e6

    detail = {
        "device": device,
        "level": LEVEL,
        "input_mb": nbytes / 1e6,
        "ratio": len(out) / nbytes,
        "stock_ratio": len(stock) / nbytes,
        "stock_mb_s": stock_mbps,
        "decompress_mb_s": dec_mbps,
        "stock_decompress_mb_s": stock_dec_mbps,
        "device_decompress": _device_decode(),
        "warmup_s": warm_s,
        "warmup_fresh_compiles": compiles.fresh,
        "warmup_cache_hits": compiles.cache_hits,
        "samples_s": {"ours": ours_samples, "stock": stock_samples},
        "corpus_provenance": corpus_provenance(data),
        "stock_stream_decompress": _stock_decompress_sweep(),
        "ratio_sweep": _ratio_sweep(),
        "bwt_worst_case": _worst_case(),
        "device_intake_compress": _device_intake(),
    }
    # One record per line, each small enough to survive a tail window;
    # the headline line is last and carries only scalars.
    for key in sorted(detail):
        print(json.dumps({"record": key, "value": detail[key]}))
    sys.stdout.flush()
    print(json.dumps({
        "metric": "compress_throughput",
        "value": ours,
        "unit": "MB/s",
        "vs_baseline": ours / stock_mbps,
        "device": device,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
