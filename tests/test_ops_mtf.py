"""Differential tests: JAX MTF+RLE2 vs the scalar oracle."""

import numpy as np
import jax.numpy as jnp
import pytest

from bz2tpu.ops.mtf import mtf_rle2_encode
from bz2tpu.oracle.encoder import bwt_encode as oracle_bwt, mtf_rle2_encode as oracle_mtf

from conftest import CORPUS_KINDS, make_corpus


def _check(arr: np.ndarray, cap: int, chunk: int = 256):
    last, _ = oracle_bwt(arr)  # realistic input distribution for this stage
    padded = np.zeros(cap, dtype=np.uint8)
    padded[: arr.size] = last
    got = mtf_rle2_encode(jnp.asarray(padded), jnp.int32(arr.size), chunk=chunk)
    want = oracle_mtf(last)
    n_sym = int(got["n_sym"])
    assert n_sym == want.symbols.size
    np.testing.assert_array_equal(np.asarray(got["symbols"])[:n_sym], want.symbols)
    assert np.all(np.asarray(got["symbols"])[n_sym:] == -1)
    np.testing.assert_array_equal(np.asarray(got["used"]), want.used)
    assert int(got["n_in_use"]) + 2 == want.alpha_size
    np.testing.assert_array_equal(
        np.asarray(got["freqs"])[: want.alpha_size], want.freqs
    )
    assert np.all(np.asarray(got["freqs"])[want.alpha_size :] == 0)


@pytest.mark.parametrize("kind", CORPUS_KINDS)
@pytest.mark.parametrize("size", [1, 2, 65, 1000, 4093])
def test_vs_oracle(rng, kind, size):
    arr = np.frombuffer(make_corpus(rng, kind, size), dtype=np.uint8)
    _check(arr, cap=4096)


def test_chunk_boundaries(rng):
    # Runs and symbol changes crossing scan-chunk boundaries.
    arr = np.frombuffer(make_corpus(rng, "runs", 2048), dtype=np.uint8)
    for chunk in (64, 100, 2048, 4096):
        _check(arr, cap=2048, chunk=chunk)


def test_long_zero_run_digits(rng):
    # A BWT of all-identical bytes gives one maximal zero run: exercises the
    # bijective base-2 digit expansion at many lengths.
    for size in (1, 2, 3, 4, 5, 6, 7, 8, 9, 100, 255, 256, 1000, 2047):
        arr = np.full(size, 7, dtype=np.uint8)
        _check(arr, cap=2048)


def test_batch_matches_per_block(rng):
    """The load-balanced batch scan (compacted slots + closed-form carries)
    must produce bit-identical results to the per-block while_loop form,
    across a batch mixing collapse ratios and valid lengths."""
    from bz2tpu.ops.mtf import mtf_rle2_encode_batch

    cap = 4096
    kinds_sizes = [
        ("text", 4093), ("random", 4096), ("runs", 3000), ("zeros", 4096),
        ("alternating", 2048), ("text", 1), ("random", 65), ("runs", 4096),
    ]
    batch = np.zeros((len(kinds_sizes), cap), np.uint8)
    ns = np.zeros(len(kinds_sizes), np.int32)
    for i, (kind, size) in enumerate(kinds_sizes):
        arr = np.frombuffer(make_corpus(rng, kind, size), dtype=np.uint8)
        last, _ = oracle_bwt(arr)
        batch[i, : arr.size] = last
        ns[i] = arr.size
    got = mtf_rle2_encode_batch(jnp.asarray(batch), jnp.asarray(ns), chunk=256)
    for i in range(len(kinds_sizes)):
        want = mtf_rle2_encode(
            jnp.asarray(batch[i]), jnp.int32(ns[i]), chunk=256
        )
        n_sym = int(want["n_sym"])
        assert int(got["n_sym"][i]) == n_sym
        np.testing.assert_array_equal(
            np.asarray(got["symbols"][i])[:n_sym], np.asarray(want["symbols"])[:n_sym]
        )
        assert np.all(np.asarray(got["symbols"][i])[n_sym:] == -1)
        np.testing.assert_array_equal(np.asarray(got["used"][i]), np.asarray(want["used"]))
        np.testing.assert_array_equal(np.asarray(got["freqs"][i]), np.asarray(want["freqs"]))


def test_batch_single_block_tiny(rng):
    # B*n_chunks smaller than the scan's lane width must still work.
    from bz2tpu.ops.mtf import mtf_rle2_encode_batch

    arr = np.frombuffer(make_corpus(rng, "text", 300), dtype=np.uint8)
    last, _ = oracle_bwt(arr)
    padded = np.zeros(512, np.uint8)
    padded[: arr.size] = last
    got = mtf_rle2_encode_batch(
        jnp.asarray(padded[None, :]), jnp.asarray([arr.size], np.int32), chunk=256
    )
    want = oracle_mtf(last)
    n_sym = int(got["n_sym"][0])
    assert n_sym == want.symbols.size
    np.testing.assert_array_equal(np.asarray(got["symbols"][0])[:n_sym], want.symbols)


def test_mtf_chunk_over_int16_bound_rejected():
    # The scan runs (chunk, 256) arrays in int16; chunk > 32768 would wrap
    # local times negative and silently corrupt ranks — it must raise.
    import jax.numpy as jnp
    import pytest

    from bz2tpu.ops.mtf import mtf_rle2_encode

    with pytest.raises(ValueError, match="32768"):
        mtf_rle2_encode(jnp.zeros(1024, jnp.uint8), jnp.int32(1024), chunk=65536)


def _oracle_ranks(seq, n_in_use):
    mtf = list(range(n_in_use))
    out = []
    for v in seq:
        j = mtf.index(v)
        out.append(j)
        mtf.pop(j)
        mtf.insert(0, v)
    return out


@pytest.mark.parametrize(
    "n_sym,length,chunk",
    [(5, 100, 64), (256, 1000, 128), (30, 4095, 512), (3, 17, 256)],
)
def test_collapsed_ranks_vs_oracle(rng, n_sym, length, chunk):
    """The ranks scan over a run-collapsed sequence (adjacent symbols
    distinct, -1 padding) against a literal move-to-front list."""
    import functools

    import jax

    from bz2tpu.ops.mtf import _mtf_ranks_collapsed

    seq = [int(rng.integers(n_sym))]
    while len(seq) < length:
        v = int(rng.integers(n_sym))
        if v != seq[-1]:
            seq.append(v)
    padded = np.full(length + 37, -1, np.int32)
    padded[:length] = seq
    ranks = jax.jit(functools.partial(_mtf_ranks_collapsed, chunk=chunk))(
        jnp.asarray(padded), jnp.int32(length), jnp.int32(n_sym)
    )
    np.testing.assert_array_equal(np.asarray(ranks)[:length], _oracle_ranks(seq, n_sym))


def test_plan_then_emission_vs_oracle(rng):
    """The compact pipeline's split form — collapsed-domain plan, then the
    output-domain emission at full width — against the oracle stream."""
    from bz2tpu.ops.mtf import _rle2_out, mtf_rle2_plan

    arr = np.frombuffer(make_corpus(rng, "text", 3000), dtype=np.uint8)
    last, _ = oracle_bwt(arr)
    padded = np.zeros(4096, np.uint8)
    padded[: arr.size] = last
    plan = mtf_rle2_plan(jnp.asarray(padded), jnp.int32(arr.size), chunk=512)
    symbols, freqs = _rle2_out(plan, 4096 + 2)
    want = oracle_mtf(last)
    n_sym = int(plan["n_sym"])
    assert n_sym == want.symbols.size
    np.testing.assert_array_equal(np.asarray(symbols)[:n_sym], want.symbols)
    np.testing.assert_array_equal(np.asarray(freqs)[: want.alpha_size], want.freqs)
