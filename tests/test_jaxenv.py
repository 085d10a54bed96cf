"""Compile-cache directory resolution (utils/jaxenv.py).

JAX finds a cached program again only in the directory it was written to,
so the directory must be the caller's ``JAX_COMPILATION_CACHE_DIR`` when
set and one fixed checkout-local path otherwise.
"""

import os
import subprocess
import sys

from bz2tpu.utils import jaxenv

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
from bz2tpu.utils import jaxenv
import jax
jaxenv.setup_compilation_cache()
print(jaxenv.cache_dir(), jax.config.jax_compilation_cache_dir)
"""


def _probe(env_dir):
    env = dict(os.environ)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    r = subprocess.run([sys.executable, "-c", _PROBE], env=env, cwd=_REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout.split()


def test_cache_dir_env_set(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert jaxenv.cache_dir() == str(tmp_path)
    # The running process uses exactly that directory and sets no other.
    assert _probe(str(tmp_path / "c")) == [str(tmp_path / "c")] * 2


def test_cache_dir_env_unset(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert jaxenv.cache_dir() == os.path.join(_REPO, ".jax_cache")


def test_cache_dir_stable_across_processes():
    first, second = _probe(None), _probe(None)
    assert first == second == [os.path.join(_REPO, ".jax_cache")] * 2


_UNWRITABLE_PROBE = """
import bz2, sys, warnings
from bz2tpu.utils import jaxenv
jaxenv._DEFAULT_CACHE = sys.argv[1]
import bz2tpu, jax
data = b"an install whose checkout is read-only " * 4000
with warnings.catch_warnings(record=True) as caught:
    warnings.simplefilter("always")
    out = bz2tpu.compress(data, level=1)
assert bz2.decompress(out) == data, "round trip failed"
print(jax.config.jax_compilation_cache_dir,
      any("compile cache" in str(w.message) for w in caught))
"""


def test_unwritable_default_cache_warns_and_compresses(tmp_path):
    # A default under a regular file can never be created (as root too):
    # compress must warn, leave the persistent cache off, and still work.
    blocker = tmp_path / "site-packages"
    blocker.write_bytes(b"")
    env = dict(os.environ)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    r = subprocess.run(
        [sys.executable, "-c", _UNWRITABLE_PROBE, str(blocker / ".jax_cache")],
        env=env, cwd=_REPO, capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.split() == ["None", "True"]
