"""Round trips on the GPU (marker ``gpu``; run with ``pytest -m gpu``).

Each level runs in a child process that opens the card itself: the test
process stays on the CPU (tests/conftest.py), so only one process at a
time holds the card. The child compresses about a block and a half of
bench.py's mixed corpus with ``bz2tpu.compress``, decodes it with stdlib
bz2, the host C decoder and device decode, decodes stock's stream of the
same bytes on the device, and fails on any device-decode host fallback.
"""

import os
import shutil
import subprocess
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = """
import bz2, os, sys
os.environ["JAX_PLATFORMS"] = "cuda"
import jax
assert jax.devices()[0].platform == "gpu", jax.devices()
import bench, bz2tpu
from bz2tpu import oracle
from bz2tpu.runtime.device_decode import fallback_stats
level = int(sys.argv[1])
data = bench.make_mixed_corpus(150_000 * level)
out = bz2tpu.compress(data, level=level)
assert out == oracle.compress(data, level=level), "differs from the oracle"
assert len(out) <= len(bz2.compress(data, level)), "larger than stock"
assert bz2.decompress(out) == data
assert bz2tpu.decompress(out) == data
assert bz2tpu.decompress_device(out) == data
assert bz2tpu.decompress_device(bz2.compress(data, level)) == data
assert not fallback_stats, dict(fallback_stats)
print("GPU-OK", level)
"""


@pytest.fixture
def gpu():
    """Skip unless nvidia-smi lists a card (decided here, never at import)."""
    smi = shutil.which("nvidia-smi")
    if smi is None or subprocess.run([smi, "-L"], capture_output=True).returncode != 0:
        pytest.skip("no NVIDIA GPU on this machine")


@pytest.mark.gpu
@pytest.mark.parametrize("level", range(1, 10))
def test_level_round_trips_on_gpu(gpu, level):
    env = {k: v for k, v in os.environ.items() if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    r = subprocess.run([sys.executable, "-c", _CHILD, str(level)], env=env,
                       cwd=_REPO, capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stderr[-3000:]
    assert f"GPU-OK {level}" in r.stdout
