"""Real multi-process jax.distributed validation (CPU backend).

Two subprocesses form an actual jax.distributed cluster (coordinator on
localhost), each contributing 2 virtual CPU devices to a global 4-device
("blocks",) mesh, and run the sharded block pipeline end to end. Process 0
assembles the stream; it must be byte-identical to the single-process
result — the ordered-gather and addressable-shard logic this exercises is
exactly what a multi-host run uses (SURVEY.md section 5, distributed row).
"""

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from conftest import make_corpus

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = textwrap.dedent(
    """
    import os, sys, pickle

    dpp = int(sys.argv[5])  # devices per process (global mesh = 2*dpp)

    # Must be configured before jax import (and conftest isn't loaded here).
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={dpp}"
    ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")

    coord, pid = sys.argv[1], int(sys.argv[2])
    from bz2tpu.parallel.distributed import initialize, is_primary

    initialize(coordinator_address=coord, num_processes=2, process_id=pid)
    assert jax.process_count() == 2, jax.process_count()
    assert jax.device_count() == 2 * dpp, jax.device_count()

    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from bz2tpu.parallel.mesh import block_mesh, encode_blocks_sharded

    data = np.frombuffer(open(sys.argv[3], "rb").read(), dtype=np.uint8)
    from bz2tpu.oracle.encoder import rle1_split
    from bz2tpu.format import constants as C

    level = 1
    blocks = rle1_split(data, level)
    cap = C.block_capacity(level) + 4  # +4: crossing-piece overshoot
    B = 2 * dpp  # one row per global device; rows past len(blocks) pad
    assert len(blocks) <= B
    batch = np.zeros((B, cap), np.uint8)
    ns = np.ones(B, np.int32)  # padded slots: length-1 dummy (valid >= 1)
    for i, blk in enumerate(blocks):
        batch[i, : blk.data.size] = blk.data
        ns[i] = blk.data.size

    mesh = block_mesh()  # all 4 global devices
    crcs = np.zeros(B, np.uint32)
    for i, blk in enumerate(blocks):
        crcs[i] = blk.crc
    out = encode_blocks_sharded(batch, jnp.asarray(ns), jnp.asarray(crcs), mesh=mesh)
    # Ordered gather: fetch per-block words on every process (addressable
    # shards differ; jax.device_get of a global array gathers).
    from jax.experimental import multihost_utils

    words = np.asarray(multihost_utils.process_allgather(out["words"], tiled=True))
    bits = np.asarray(multihost_utils.process_allgather(out["total_bits"], tiled=True))

    # Collective stitch: the WHOLE stream (header, blocks, end marker,
    # stream CRC) assembles on the mesh; host 0 receives finished bytes.
    from bz2tpu.parallel.stitch import stitch_stream_sharded

    bits_live = bits.astype(np.int32).copy()  # already allgathered above
    bits_live[len(blocks):] = 0
    stream, _ = stitch_stream_sharded(
        out["words"], jnp.asarray(bits_live), jnp.asarray(crcs), len(blocks),
        level, mesh=mesh,
    )
    if is_primary():
        with open(sys.argv[4], "wb") as f:
            pickle.dump(
                {"words": words[: len(blocks)], "bits": bits[: len(blocks)],
                 "stream": stream}, f
            )
    """
)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
@pytest.mark.parametrize("dpp", [2, 4])  # 2x2=4 and 2x4=8 global devices
def test_two_process_distributed_matches_single(tmp_path, dpp):
    rng = np.random.default_rng(71)
    data = make_corpus(rng, "text", 250_000)
    data_path = tmp_path / "input.bin"
    data_path.write_bytes(data)
    out_path = tmp_path / "out.pkl"
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    coord = f"127.0.0.1:{_free_port()}"

    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    # The worker script lives in tmp_path, so the repo root is not on
    # sys.path automatically (cwd is only added for -c/interactive).
    env["PYTHONPATH"] = _REPO + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else ""
    )
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), coord, str(pid), str(data_path),
             str(out_path), str(dpp)],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            cwd=_REPO,
        )
        for pid in range(2)
    ]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se.decode()[-2000:]

    import pickle

    got = pickle.loads(out_path.read_bytes())

    # Single-process reference on the same input.
    import jax.numpy as jnp

    from bz2tpu.format import constants as C
    from bz2tpu.oracle.encoder import rle1_split
    from bz2tpu.parallel.mesh import block_mesh, encode_blocks_sharded

    B = 2 * dpp
    blocks = rle1_split(np.frombuffer(data, np.uint8), 1)
    cap = C.block_capacity(1) + 4  # +4: crossing-piece overshoot
    batch = np.zeros((B, cap), np.uint8)
    ns = np.ones(B, np.int32)
    crcs = np.zeros(B, np.uint32)
    for i, blk in enumerate(blocks):
        batch[i, : blk.data.size] = blk.data
        ns[i] = blk.data.size
        crcs[i] = blk.crc
    import jax

    mesh = block_mesh(B)
    out = encode_blocks_sharded(batch, jnp.asarray(ns), jnp.asarray(crcs), mesh=mesh)
    want_words = np.asarray(jax.device_get(out["words"]))[: len(blocks)]
    want_bits = np.asarray(jax.device_get(out["total_bits"]))[: len(blocks)]

    assert (got["bits"] == want_bits).all()
    assert (got["words"] == want_words).all()

    # The collectively-stitched stream must equal the single-process
    # compressed stream byte-for-byte and decode with libbz2.
    import bz2 as stdlib_bz2

    from bz2tpu.runtime.compressor import compress

    assert got["stream"] == compress(data, level=1, parallel=4)
    assert stdlib_bz2.decompress(got["stream"]) == data


def test_initialize_single_process_noop():
    from bz2tpu.parallel.distributed import initialize

    initialize(num_processes=1)  # must not raise or warn


def test_initialize_autodetect_warns_loudly():
    # Auto-detection failure must WARN, not silently degrade (VERDICT r1).
    # Run in a subprocess: jax.distributed state is process-global.
    code = textwrap.dedent(
        """
        import os, warnings
        os.environ["JAX_PLATFORMS"] = "cpu"
        import jax
        jax.config.update("jax_platforms", "cpu")
        from bz2tpu.parallel.distributed import initialize
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            initialize()  # nothing to detect in this environment
        relevant = [x for x in w if "SINGLE-PROCESS" in str(x.message)]
        assert relevant, [str(x.message) for x in w]
        print("WARNED-OK")
        """
    )
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, cwd=_REPO,
        timeout=300,
    )
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    assert b"WARNED-OK" in r.stdout
