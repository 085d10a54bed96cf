"""Differential coverage for the opt-in sparse-BWT refinement path.

BZ2TPU_SPARSE_BWT=1 is read at module import (ops/bwt.py), so the sparse
path runs in a subprocess and its (last, orig_ptr) outputs are compared
against the default full-rounds path computed in-process. Covers text,
periodic (the worst case the sparse tiers must survive), runs, and random
blocks, plus a partial-capacity block.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from tests.conftest import make_corpus

_SCRIPT = r"""
import os, sys, json
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["BZ2TPU_SPARSE_BWT"] = "1"
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
import jax.numpy as jnp
from bz2tpu.ops.bwt import bwt_encode

spec = json.loads(sys.stdin.read())
out = []
for cap, data_hex, n in spec:
    block = np.zeros(cap, np.uint8)
    raw = bytes.fromhex(data_hex)
    block[: len(raw)] = np.frombuffer(raw, np.uint8)
    last, ptr = bwt_encode(jnp.asarray(block), jnp.int32(n))
    out.append([np.asarray(last).tolist(), int(ptr)])
print(json.dumps(out))
"""


@pytest.mark.slow
def test_sparse_bwt_matches_default(rng):
    from bz2tpu.ops import bwt

    assert not bwt._SPARSE_ROUNDS, "default path must be full rounds"
    import jax.numpy as jnp

    cap = 4096
    cases = []
    for kind in ["text", "runs", "random", "alternating"]:
        data = make_corpus(rng, kind, cap)
        cases.append((cap, data, cap))
    # Partial block: valid length below capacity.
    cases.append((cap, make_corpus(rng, "text", 1500), 1500))

    spec = []
    expected = []
    for cap_i, data, n in cases:
        block = np.zeros(cap_i, np.uint8)
        block[: len(data)] = np.frombuffer(data, np.uint8)
        last, ptr = bwt.bwt_encode(jnp.asarray(block), jnp.int32(n))
        expected.append((np.asarray(last), int(ptr)))
        spec.append((cap_i, data.hex(), n))

    env = dict(os.environ)
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT],
        input=json.dumps(spec),
        capture_output=True,
        text=True,
        env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    for (exp_last, exp_ptr), (g_last, g_ptr), (_, _, n) in zip(expected, got, cases):
        np.testing.assert_array_equal(exp_last, np.asarray(g_last, np.uint8))
        assert exp_ptr == g_ptr
