"""chip_smoke.py's phases at a tiny size on the CPU.

The script itself must never pass on a CPU: main() refuses any default
device that is not a GPU. Its phase functions take their sizes as
arguments, so each runs here at level 1 on a few hundred kB.
"""

import bz2
import os
import sys

import pytest

from conftest import make_corpus

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402


@pytest.fixture(scope="module")
def corpus():
    import numpy as np

    rng = np.random.default_rng(0x5A0E)
    return make_corpus(rng, "text", 150_000) + make_corpus(rng, "random", 50_000)


def test_main_refuses_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.main([])


def test_phase_environment():
    res = chip_smoke.phase_environment()
    assert res["platform"] == "cpu" and res["device_count"] >= 1


def test_phase_compress(corpus):
    res, out = chip_smoke.phase_compress(corpus, 1)
    assert res["oracle_identical"] and res["out_bytes"] == len(out)
    assert res["out_bytes"] <= res["stock_bytes"]
    assert bz2.decompress(out) == corpus


def test_phase_level1_and_worst(corpus):
    from bench import worst_case_data

    res = chip_smoke.phase_level1_and_worst(corpus[:120_000], worst_case_data(60_000), 1)
    assert res["level1"]["oracle_identical"]
    assert res["worst_case"]["input_bytes"] == 60_000


def test_phase_decode(corpus):
    import bz2tpu

    own = bz2tpu.compress(corpus, level=1)
    res = chip_smoke.phase_decode(corpus, own, 1)
    assert res["device_decode_fallbacks"] == 0
    assert set(res) == {"stock", "own", "device_decode_fallbacks"}


def test_phase_entry_points(corpus):
    res = chip_smoke.phase_entry_points(corpus, 120_000, 120_000, 1, chunk=64_000)
    assert set(res["cli"]["walls_s"]) == {"compress", "check", "dec", "dec_stock"}
    assert res["stream_compressor"]["input_bytes"] == len(corpus)


def test_phase_memory_and_cache():
    from bz2tpu.utils.jaxenv import CompileCounter

    import jax
    import jax.numpy as jnp

    with CompileCounter() as c:
        jax.jit(lambda x: x * 3 + 1)(jnp.arange(7))
    res = chip_smoke.phase_memory_and_cache(c)
    assert res["fresh_compiles"] + res["cache_hits"] >= 1


def test_multichip_matches_single_device(corpus):
    data = chip_smoke.first_blocks(corpus, 1, 2)
    res = chip_smoke.multichip(data, 1, 4)
    assert res["identical_to_single_device"] and res["blocks"] == 2


def test_first_blocks_exact_prefix(corpus):
    from bz2tpu.runtime.compressor import split_blocks

    data = chip_smoke.first_blocks(corpus, 1, 1)
    assert len(split_blocks(data, 1)) == 1 and corpus.startswith(data)
    with pytest.raises(AssertionError, match="fewer than"):
        chip_smoke.first_blocks(corpus, 1, 50)
