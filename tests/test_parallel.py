"""Sharded block pipeline over the virtual 8-device CPU mesh."""

import numpy as np
import jax
import jax.numpy as jnp

from bz2tpu.ops.pipeline import encode_blocks
from bz2tpu.parallel.mesh import block_mesh, encode_blocks_sharded, pad_batch

from conftest import make_corpus


def test_pad_batch():
    assert pad_batch(1, 8) == 8
    assert pad_batch(8, 8) == 8
    assert pad_batch(9, 8) == 16
    assert pad_batch(3, 8, batch_per_shard=2) == 16


def test_sharded_matches_single_device(rng):
    n_dev = len(jax.devices())
    assert n_dev == 8, "conftest must provide the 8-device CPU mesh"
    cap = 2048
    B = 2 * n_dev
    blocks = np.zeros((B, cap), dtype=np.uint8)
    ns = np.zeros(B, dtype=np.int32)
    for i in range(B):
        d = np.frombuffer(make_corpus(rng, "text", int(rng.integers(64, cap))), np.uint8)
        blocks[i, : d.size] = d
        ns[i] = d.size
    crcs = rng.integers(0, 1 << 32, B).astype(np.uint32)
    mesh = block_mesh()
    sharded = encode_blocks_sharded(
        jnp.asarray(blocks), jnp.asarray(ns), jnp.asarray(crcs), mesh=mesh, mtf_chunk=256
    )
    single = encode_blocks(jnp.asarray(blocks), jnp.asarray(ns), jnp.asarray(crcs), mtf_chunk=256)
    for key in ("orig_ptr", "n_sym", "total_bits", "words"):
        np.testing.assert_array_equal(np.asarray(sharded[key]), np.asarray(single[key]))


def test_graft_entry_dryrun():
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import __graft_entry__ as g

    g.dryrun_multichip(8)
    fn, args = g.entry()
    out = fn(*args)
    assert (np.asarray(out["total_bits"]) > 0).all()


def test_graft_entry_dryrun_16_devices():
    # 16 virtual devices exceed the in-process mesh (conftest pins 8), so
    # the dryrun runs in a subprocess with its own XLA_FLAGS.
    import os
    import subprocess
    import sys

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=16"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(
        [sys.executable, "-c",
         "import __graft_entry__ as g; g.dryrun_multichip(16)"],
        env=env, capture_output=True, cwd=repo, timeout=900,
    )
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    assert b"dryrun_multichip ok: 29 live blocks (+3 padding)" in r.stdout


def test_runtime_uses_mesh_when_divisible(rng):
    # 8-device CPU mesh + batch 8: the driver takes the shard_map path.
    import bz2 as stdlib_bz2

    from bz2tpu.runtime.compressor import compress

    data = make_corpus(rng, "text", 820_000)  # ~9-10 blocks at level 1
    out = compress(data, level=1, parallel=8)
    assert stdlib_bz2.decompress(out) == data
