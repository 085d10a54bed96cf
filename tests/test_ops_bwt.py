"""Differential tests: JAX rank-doubling BWT vs the scalar oracle."""

import numpy as np
import jax.numpy as jnp
import pytest

from bz2tpu.ops.bwt import bwt_encode, bwt_encode_batch
from bz2tpu.oracle.encoder import bwt_encode as oracle_bwt

from conftest import CORPUS_KINDS, make_corpus


def _pad(arr: np.ndarray, cap: int) -> np.ndarray:
    out = np.zeros(cap, dtype=np.uint8)
    out[: arr.size] = arr
    return out


def test_banana():
    arr = np.frombuffer(b"banana", dtype=np.uint8)
    last, ptr = bwt_encode(jnp.asarray(_pad(arr, 16)), jnp.int32(6))
    assert bytes(np.asarray(last)[:6]) == b"nnbaaa"
    assert int(ptr) == 3


@pytest.mark.parametrize("kind", CORPUS_KINDS)
@pytest.mark.parametrize("size", [1, 2, 64, 1000, 4093])
def test_vs_oracle(rng, kind, size):
    arr = np.frombuffer(make_corpus(rng, kind, size), dtype=np.uint8)
    cap = 4096
    last, ptr = bwt_encode(jnp.asarray(_pad(arr, cap)), jnp.int32(arr.size))
    olast, optr = oracle_bwt(arr)
    np.testing.assert_array_equal(np.asarray(last)[: arr.size], olast)
    assert np.all(np.asarray(last)[arr.size :] == 0)
    # For periodic inputs multiple origin pointers decode identically; the
    # oracle uses the same index tie-break, so pointers must still match.
    assert int(ptr) == optr


def test_batch_matches_single(rng):
    cap = 2048
    blocks = np.zeros((6, cap), dtype=np.uint8)
    ns = []
    for i in range(6):
        d = np.frombuffer(
            make_corpus(rng, CORPUS_KINDS[i % len(CORPUS_KINDS)], int(rng.integers(1, cap))),
            dtype=np.uint8,
        )
        blocks[i, : d.size] = d
        ns.append(d.size)
    lasts, ptrs = bwt_encode_batch(jnp.asarray(blocks), jnp.asarray(ns, dtype=np.int32))
    for i in range(6):
        ol, op = oracle_bwt(blocks[i, : ns[i]])
        np.testing.assert_array_equal(np.asarray(lasts[i])[: ns[i]], ol)
        assert int(ptrs[i]) == op


def test_full_block_no_padding(rng):
    arr = np.frombuffer(make_corpus(rng, "text", 2048), dtype=np.uint8)
    last, ptr = bwt_encode(jnp.asarray(arr), jnp.int32(arr.size))
    olast, optr = oracle_bwt(arr)
    np.testing.assert_array_equal(np.asarray(last), olast)
    assert int(ptr) == optr


_STAGE_CASES = {
    "text": (lambda rng: make_corpus(rng, "text", 700), 1024),
    "random": (lambda rng: make_corpus(rng, "random", 1000), 1024),
    "periodic7": (lambda rng: bytes(range(1, 8)) * 100, 1024),
    "ab": (lambda rng: b"ab" * 300, 1024),
    "tiny_a": (lambda rng: b"a", 256),
    "tiny_ab": (lambda rng: b"ab", 256),
    "tiny_aaa": (lambda rng: b"aaa", 256),
    "tiny_abcd": (lambda rng: b"abcd", 256),
    "partial_capacity": (lambda rng: make_corpus(rng, "text", 100), 2048),
}


@pytest.mark.parametrize("case", sorted(_STAGE_CASES))
def test_bwt_stage_vs_oracle(rng, case):
    """pipeline.bwt_stage — the batched stage the compressor dispatches —
    on a batch of the case block and a text block, against the oracle."""
    from bz2tpu.ops.pipeline import bwt_stage

    make, cap = _STAGE_CASES[case]
    datas = [make(rng), make_corpus(rng, "text", cap // 2)]
    blocks = np.stack([_pad(np.frombuffer(d, np.uint8), cap) for d in datas])
    ns = np.asarray([len(d) for d in datas], np.int32)
    lasts, ptrs = bwt_stage(jnp.asarray(blocks), jnp.asarray(ns))
    for i, d in enumerate(datas):
        olast, optr = oracle_bwt(np.frombuffer(d, np.uint8))
        np.testing.assert_array_equal(np.asarray(lasts[i])[: len(d)], olast)
        assert np.all(np.asarray(lasts[i])[len(d) :] == 0)
        assert int(ptrs[i]) == optr
