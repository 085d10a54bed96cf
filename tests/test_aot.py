"""Shippable AOT artifact (utils/aot.py): export in one process, start a
FRESH process with an empty cache, and reach compiled code with zero XLA
optimization (every dispatch a persistent-cache hit).

The artifact is the analog of the reference's prebuilt kernel binary dump
(#define PTX, include/opencl.hpp:203-205).
"""

import json
import os
import subprocess
import sys

import pytest

from conftest import make_corpus


def _run(code: str, env_extra: dict, timeout=900):
    env = dict(os.environ)
    # Plain single-device CPU: export and use must agree on the backend or
    # cache keys (rightly) miss.
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    env.update(env_extra)
    return subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True, text=True, env=env, timeout=timeout,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )


def test_aot_artifact_fresh_process_zero_compiles(tmp_path, rng):
    art = str(tmp_path / "artifact")
    cache_use = str(tmp_path / "fresh_cache")
    datafile = tmp_path / "data.bin"
    datafile.write_bytes(make_corpus(rng, "text", 150_000))

    r = _run(
        f"""
from bz2tpu.utils.aot import export_artifact
n = export_artifact({art!r}, levels=(1,), batch=2, verbose=False)
print("EXPORTED", n)
""",
        {"JAX_COMPILATION_CACHE_DIR": str(tmp_path / "export_cache")},
    )
    assert r.returncode == 0, r.stderr[-2000:]
    n_exported = int(r.stdout.split("EXPORTED")[1].strip())
    assert n_exported >= 6  # 3 stages + stitch across widths {1, 2}
    manifest = json.load(open(os.path.join(art, "bz2tpu_aot_manifest.json")))
    assert manifest["n_entries"] == n_exported

    # Fresh process, EMPTY cache dir, artifact installed via env: the
    # compress path must be all cache hits (deserialize-only) and the
    # stream must round-trip through stdlib bz2.
    r2 = _run(
        f"""
import bz2
from bz2tpu.runtime.compressor import compress
from bz2tpu.utils.jaxenv import CompileCounter
data = open({str(datafile)!r}, "rb").read()
with CompileCounter() as compiles:
    out = compress(data, level=1, parallel=2)
assert bz2.decompress(out) == data, "round-trip failed"
print("HITS", compiles.cache_hits, "FRESH", compiles.fresh)
""",
        {"JAX_COMPILATION_CACHE_DIR": cache_use, "BZ2TPU_AOT_DIR": art},
    )
    assert r2.returncode == 0, r2.stderr[-2000:]
    line = [l for l in r2.stdout.splitlines() if l.startswith("HITS")][0]
    n_hits, n_fresh = int(line.split()[1]), int(line.split()[3])
    # 150k @ level 1 = 2 blocks = batch width 2: bwt + mtf + huff_pack +
    # concat all served from the artifact; nothing big compiles fresh
    # (sub-second slicers may, they are below the cache write threshold).
    assert n_hits >= 4, r2.stdout
    # The installed entries really came from the artifact.
    assert len(os.listdir(cache_use)) >= n_hits


def test_aot_install_mismatch_warns(tmp_path):
    from bz2tpu.utils import aot

    art = tmp_path / "artifact"
    art.mkdir()
    (art / "somefile.bin").write_bytes(b"x")
    manifest = {"version": 2, "jax": "0.0.0", "platform": "cpu",
                "platform_version": "nope", "n_entries": 1}
    (art / "bz2tpu_aot_manifest.json").write_text(json.dumps(manifest))
    aot._installed.clear()
    with pytest.warns(UserWarning, match="does not match this runtime"):
        ok = aot.install(str(art), str(tmp_path / "cache"))
    assert not ok
    # Unreadable artifact: warns, degrades.
    aot._installed.clear()
    with pytest.warns(UserWarning, match="unreadable"):
        ok = aot.install(str(tmp_path / "missing"), str(tmp_path / "cache"))
    assert not ok
