"""Differential tests: JAX Huffman stage vs the scalar oracle."""

import numpy as np
import jax.numpy as jnp
import pytest

from bz2tpu.format import constants as C
from bz2tpu.ops.huffman import (
    canonical_codes,
    code_lengths,
    huffman_assign,
    max_selectors,
    selector_mtf_ranks,
)
from bz2tpu.oracle.encoder import (
    assign_canonical_codes as oracle_canon,
    bwt_encode as oracle_bwt,
    huffman_plan as oracle_plan,
    make_code_lengths as oracle_lengths,
    mtf_rle2_encode as oracle_mtf,
)

from conftest import CORPUS_KINDS, make_corpus


def _pad_freqs(freqs: np.ndarray) -> np.ndarray:
    out = np.zeros(258, dtype=np.int32)
    out[: freqs.size] = freqs
    return out


@pytest.mark.parametrize(
    "freqs",
    [
        [5, 3, 1, 1],
        [1000, 1, 1],
        [0, 0, 7],
        list(range(30)),
        [1] * 258,
        [2**20, 1, 1, 1, 1],
    ],
)
def test_code_lengths_vs_oracle(freqs):
    freqs = np.asarray(freqs, dtype=np.int64)
    want = oracle_lengths(freqs)
    got = np.asarray(code_lengths(jnp.asarray(_pad_freqs(freqs)), jnp.int32(freqs.size)))
    np.testing.assert_array_equal(got[: freqs.size], want)
    assert np.all(got[freqs.size :] == 0)


def test_code_lengths_depth_cap():
    # Fibonacci-like frequencies force deep trees -> the flatten loop.
    f = np.ones(30, dtype=np.int64)
    for i in range(2, 30):
        f[i] = f[i - 1] + f[i - 2]
    want = oracle_lengths(f)
    got = np.asarray(code_lengths(jnp.asarray(_pad_freqs(f)), jnp.int32(f.size)))
    np.testing.assert_array_equal(got[: f.size], want)
    assert got.max() <= C.HUFFMAN_ENCODE_MAX_LENGTH


def test_canonical_vs_oracle(rng):
    for _ in range(10):
        n = int(rng.integers(3, 258))
        freqs = rng.integers(0, 1000, n)
        lens = oracle_lengths(freqs)
        want = oracle_canon(lens)
        padded = np.zeros((1, 258), dtype=np.int32)
        padded[0, :n] = lens
        got = np.asarray(canonical_codes(jnp.asarray(padded), jnp.int32(n)))[0]
        np.testing.assert_array_equal(got[:n], want)


def test_selector_mtf(rng):
    sels = rng.integers(0, 4, 200).astype(np.int32)
    # Oracle: explicit list MTF (mirrors encoder write_block).
    mtf = list(range(6))
    want = []
    for s in sels.tolist():
        j = mtf.index(s)
        mtf.pop(j)
        mtf.insert(0, s)
        want.append(j)
    padded = np.zeros(256, dtype=np.int32)
    padded[:200] = sels
    got = np.asarray(selector_mtf_ranks(jnp.asarray(padded), jnp.int32(200)))
    np.testing.assert_array_equal(got[:200], want)


@pytest.mark.parametrize("kind", CORPUS_KINDS)
@pytest.mark.parametrize("size", [30, 300, 4093])
def test_plan_vs_oracle(rng, kind, size):
    arr = np.frombuffer(make_corpus(rng, kind, size), dtype=np.uint8)
    last, _ = oracle_bwt(arr)
    mtf = oracle_mtf(last)
    want = oracle_plan(mtf.symbols, mtf.freqs, mtf.alpha_size)

    cap = 4096
    maxsel = max_selectors(cap)
    syms = np.full(cap + 2, -1, dtype=np.int32)
    syms[: mtf.symbols.size] = mtf.symbols
    got = huffman_assign(
        jnp.asarray(syms),
        jnp.int32(mtf.symbols.size),
        jnp.asarray(_pad_freqs(mtf.freqs)),
        jnp.int32(mtf.alpha_size - 2),
        maxsel=maxsel,
    )
    n_groups = int(got["n_groups"])
    n_sel = int(got["n_selectors"])
    assert n_groups == want.n_groups
    assert n_sel == want.selectors.size
    np.testing.assert_array_equal(np.asarray(got["selectors"])[:n_sel], want.selectors)
    np.testing.assert_array_equal(
        np.asarray(got["lengths"])[:n_groups, : mtf.alpha_size], want.lengths
    )
    np.testing.assert_array_equal(
        np.asarray(got["codes"])[:n_groups, : mtf.alpha_size], want.codes
    )


def test_plan_concentrated_frequencies(rng):
    # One dominant symbol: seeding consumes nearly all frequency in the
    # first span, later spans may be empty; plan must still be valid and
    # the stream must round-trip.
    import bz2 as stdlib_bz2

    from bz2tpu.oracle import compress as oracle_compress

    data = bytes([65] * 5000 + list(rng.integers(0, 256, 50)) + [65] * 5000)
    out = oracle_compress(data, level=1)
    assert stdlib_bz2.decompress(out) == data


def test_plan_exact_group_boundary(rng):
    # n_sym exactly divisible by 50 and exactly at table-count thresholds.
    from bz2tpu.format.constants import table_count_for_symbols
    from bz2tpu.ops.huffman import table_count

    import jax.numpy as jnp
    import numpy as np

    for n in (1, 199, 200, 599, 600, 1199, 1200, 2399, 2400, 10**6):
        assert int(table_count(jnp.int32(n))) == table_count_for_symbols(n)


def test_refinement_products_pinned_to_highest_precision():
    """Every float32 matrix product of the Huffman planner is pinned to
    Precision.HIGHEST, so its exactness does not rest on a backend default
    (float32 products may run in TF32 on a GPU)."""
    import jax
    from jax import lax

    from bz2tpu.ops.huffman import huffman_assign

    def dots(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                yield eqn
            for sub in jax.core.jaxprs_in_params(eqn.params):
                yield from dots(sub)

    sym = jnp.zeros(302, jnp.int32)
    closed = jax.make_jaxpr(
        lambda s: huffman_assign(s, jnp.int32(300), None, jnp.int32(5), maxsel=8)
    )(sym)
    found = list(dots(closed.jaxpr))
    # Cost and refit in the refinement loop, plus the refit inside
    # total_bits, which scores two candidates.
    assert len(found) == 4
    for eqn in found:
        assert eqn.params["precision"] == (lax.Precision.HIGHEST, lax.Precision.HIGHEST)
        assert all(v.aval.dtype == jnp.float32 for v in eqn.invars)
