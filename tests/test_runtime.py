"""End-to-end tests of the JAX compression pipeline.

Three-way verification: (1) stdlib bz2 (independent ground truth) decodes
our output to the input; (2) our decoder round-trips it; (3) the stream is
byte-identical to the scalar oracle's (the pipeline makes the same
algorithmic decisions, so any divergence is a kernel bug).
"""

import bz2 as stdlib_bz2

import numpy as np
import pytest

from bz2tpu.oracle import compress as oracle_compress, decompress as our_decompress
from bz2tpu.runtime.compressor import compress as device_compress

from conftest import CORPUS_KINDS, make_corpus


@pytest.mark.parametrize("kind", CORPUS_KINDS)
def test_round_trip_small(rng, kind):
    data = make_corpus(rng, kind, 5000)
    out = device_compress(data, level=1)
    assert stdlib_bz2.decompress(out) == data
    assert our_decompress(out) == data


@pytest.mark.parametrize("kind", ["text", "runs"])
def test_matches_oracle_bytes(rng, kind):
    data = make_corpus(rng, kind, 5000)
    assert device_compress(data, level=1) == oracle_compress(data, level=1)


def test_multi_block(rng):
    # >1 block at level 1 (100k capacity): 350 kB of text -> 4 blocks.
    data = make_corpus(rng, "text", 350_000)
    out = device_compress(data, level=1, parallel=2)  # forces multiple batches
    assert stdlib_bz2.decompress(out) == data
    assert our_decompress(out) == data


def test_empty_input():
    out = device_compress(b"", level=9)
    assert stdlib_bz2.decompress(out) == b""
    assert our_decompress(out) == b""


def test_single_byte():
    out = device_compress(b"x", level=1)
    assert stdlib_bz2.decompress(out) == b"x"


def test_stock_ratio_parity(rng):
    # Compressed size within 1% of stock bzip2 at the same level.
    data = make_corpus(rng, "text", 200_000)
    ours = len(device_compress(data, level=1))
    stock = len(stdlib_bz2.compress(data, 1))
    assert ours <= stock * 1.01


def test_top_level_api(rng):
    import bz2tpu

    data = make_corpus(rng, "text", 20_000)
    out = bz2tpu.compress(data, level=1)
    assert bz2tpu.decompress(out) == data
    assert stdlib_bz2.decompress(out) == data


@pytest.mark.parametrize(
    "size_delta", [-2, -1, 0, 1, 2, 17]
)
def test_block_capacity_boundaries(rng, size_delta):
    # Inputs straddling exactly one block's capacity at level 1.
    from bz2tpu.format.constants import block_capacity

    cap = block_capacity(1)
    data = make_corpus(rng, "random", cap + size_delta)  # random: no RLE1 shrink
    out = device_compress(data, level=1)
    assert stdlib_bz2.decompress(out) == data


def test_run_crossing_block_boundary(rng):
    # A >255 run positioned to straddle the first block's capacity.
    from bz2tpu.format.constants import block_capacity

    cap = block_capacity(1)
    head = make_corpus(rng, "random", cap - 100)
    data = head + b"\x42" * 1000 + make_corpus(rng, "text", 5000)
    out = device_compress(data, level=1)
    assert stdlib_bz2.decompress(out) == data


def test_rle1_255_boundary_patterns(rng):
    # Runs of exactly 4, 255, 259, 510 at a block edge region.
    data = b"".join(
        bytes([i % 251]) * n for i, n in enumerate([4, 255, 259, 510, 3, 1000])
    ) * 50
    out = device_compress(data, level=1)
    assert stdlib_bz2.decompress(out) == data
