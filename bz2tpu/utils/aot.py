"""Shippable AOT artifacts: a fresh process reaches compiled code with
zero XLA optimization time.

The persistent compilation cache (utils/jaxenv.py) already makes compiles
one-time per machine — but a cache is state, not an artifact: a fresh
machine (or an emptied cache) still pays minutes of XLA before the first
compressed byte. This module turns the cache into the reference's
prebuilt-binary ship model (``#define PTX`` kernel dump, reference
include/opencl.hpp:203-205):

  * ``bz2tpu --export-aot DIR --size L`` builds DIR as a self-contained
    artifact: it points the compilation cache AT ``DIR``, runs the real
    prime pass (so exactly the programs the runtime dispatches — stages,
    device stitch, slicers — are compiled, including sub-second ones),
    and writes a manifest recording the backend identity.
  * any later process with ``BZ2TPU_AOT_DIR=DIR`` installs the artifact's
    entries into its active cache at startup (hardlink/copy, idempotent)
    — every jit dispatch is then a cache *hit*: deserialization only,
    XLA never optimizes.

Direct executable pickling (jax.experimental.serialize_executable) is not
used: the XLA:CPU runtime refuses to serialize sort-comparator thunks
("`LessThan` is not serializable"), and every hot program here is
sort-based. The cache entry format is the same deserialize-on-load
executable, reached through an API every backend supports.

Artifacts are exact-match: jax version + platform + platform_version must
agree (manifest-checked; mismatch warns once and falls back to normal
compilation — cache keys would miss anyway).
"""

from __future__ import annotations

import json
import os
import shutil
import warnings

_ARTIFACT_VERSION = 2
_MANIFEST = "bz2tpu_aot_manifest.json"

# One-shot state: artifact dirs already installed this process, and
# install counters (tests assert on these).
_installed: dict[str, bool] = {}
stats = {"installed_files": 0, "skipped_files": 0}


def _platform_tag():
    import jax

    client = jax.devices()[0].client
    return {
        "jax": jax.__version__,
        "platform": client.platform,
        "platform_version": client.platform_version,
    }


def export_artifact(
    path: str,
    levels=(9,),
    batch: int | None = None,
    verbose: bool = True,
) -> int:
    """Build ``path`` as a shippable AOT artifact for ``levels``.

    Compiles into a cache rooted at ``path`` via the real prime pass (full
    compiles if ``path`` is new — this is the artifact *build* step, the
    analog of the reference compiling its kernels before dumping the
    binary). Returns the number of executable entries in the artifact.
    """
    import jax

    from bz2tpu.utils import jaxenv

    os.makedirs(path, exist_ok=True)
    # Configure the NORMAL cache first (so prev_dir below is the real
    # machine cache, not the artifact — setup is one-shot per process,
    # and calling it with `path` would leave the process permanently
    # redirected; it would also fire the BZ2TPU_AOT_DIR install hook
    # INTO the artifact being exported). Then re-point at the artifact
    # for the prime pass only.
    jaxenv.setup_compilation_cache()
    prev_dir = jax.config.jax_compilation_cache_dir
    prev_min = jax.config.jax_persistent_cache_min_compile_time_secs
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    # Drop in-memory executables: a warm process would otherwise satisfy
    # the prime from its jit cache and write NOTHING into the artifact.
    jax.clear_caches()
    try:
        jaxenv.prime(levels=levels, batch=batch, verbose=verbose)
    finally:
        jax.config.update("jax_persistent_cache_min_compile_time_secs", prev_min)
        jax.config.update("jax_compilation_cache_dir", prev_dir)
    entries = [f for f in os.listdir(path) if f != _MANIFEST]
    manifest = {
        "version": _ARTIFACT_VERSION,
        **_platform_tag(),
        "levels": list(levels),
        "n_entries": len(entries),
    }
    with open(os.path.join(path, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    return len(entries)


def install(artifact_dir: str, cache_dir: str) -> bool:
    """Install an artifact's executables into the active cache (idempotent:
    existing entries are kept). Returns True if the artifact was usable."""
    if _installed.get(artifact_dir) is not None:
        return _installed[artifact_dir]
    ok = False
    try:
        with open(os.path.join(artifact_dir, _MANIFEST)) as f:
            manifest = json.load(f)
        tag = _platform_tag()
        mismatch = [
            k for k in ("platform", "platform_version", "jax")
            if manifest.get(k) != tag[k]
        ]
        if manifest.get("version") != _ARTIFACT_VERSION or mismatch:
            warnings.warn(
                f"BZ2TPU_AOT_DIR artifact at {artifact_dir} does not match "
                f"this runtime ({mismatch or 'version'}); compiling normally",
                stacklevel=2,
            )
        else:
            os.makedirs(cache_dir, exist_ok=True)
            for name in os.listdir(artifact_dir):
                if name == _MANIFEST:
                    continue
                src = os.path.join(artifact_dir, name)
                dst = os.path.join(cache_dir, name)
                if os.path.exists(dst):
                    stats["skipped_files"] += 1
                    continue
                try:
                    os.link(src, dst)  # same-fs fast path
                except OSError:
                    shutil.copy2(src, dst)
                stats["installed_files"] += 1
            ok = True
    except (OSError, json.JSONDecodeError) as e:
        warnings.warn(
            f"BZ2TPU_AOT_DIR artifact at {artifact_dir} unreadable ({e}); "
            "compiling normally",
            stacklevel=2,
        )
    _installed[artifact_dir] = ok
    return ok
