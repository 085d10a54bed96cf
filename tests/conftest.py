"""Test configuration.

JAX tests run on a virtual 8-device CPU mesh (the standard JAX
fake-multi-device trick) so sharding/collective code paths are exercised
without an accelerator. Must be set before jax is imported anywhere.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax

# The tests compare against CPU-only references and must never pick up an
# accelerator, even where one is installed.
jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0xB212)


def make_corpus(rng: np.random.Generator, kind: str, n: int) -> bytes:
    """Deterministic test inputs across the interesting regimes."""
    if kind == "text":
        # Markov-ish ASCII text: skewed symbol distribution, runs of spaces.
        words = [b"the ", b"quick ", b"brown ", b"fox ", b"jumps  ", b"over\n", b"lazy ", b"dog. "]
        parts = []
        size = 0
        while size < n:
            w = words[int(rng.integers(len(words)))]
            parts.append(w)
            size += len(w)
        return b"".join(parts)[:n]
    if kind == "random":
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    if kind == "runs":
        # Long runs exercising RLE1 (incl. >255 and 4..259 boundaries).
        parts = []
        size = 0
        while size < n:
            v = int(rng.integers(0, 5))
            ln = int(rng.choice([1, 2, 3, 4, 5, 251, 255, 256, 259, 300, 1000]))
            parts.append(bytes([v]) * ln)
            size += ln
        return b"".join(parts)[:n]
    if kind == "zeros":
        return bytes(n)
    if kind == "alternating":
        return (b"ab" * ((n + 1) // 2))[:n]
    raise ValueError(kind)


CORPUS_KINDS = ["text", "random", "runs", "zeros", "alternating"]
