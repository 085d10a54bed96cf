"""AOT cold-start measurement.

The criterion for the shippable AOT artifact (utils/aot.py, the
reference's prebuilt-binary ship model, include/opencl.hpp:203-205): a
FRESH process with an EMPTY ``JAX_COMPILATION_CACHE_DIR`` and
``BZ2TPU_AOT_DIR`` pointing at the artifact must produce its first
compressed byte in < 60 s.

This tool:
  1. exports (or reuses) an artifact for level 9 / batch 8;
  2. spawns a fresh python subprocess with a brand-new empty cache dir
     and the artifact installed via env, which compresses one full
     8x900k batch on the device and prints the wall from interpreter
     start to the first compressed byte leaving the stitcher;
  3. spawns the CONTROL: same fresh process, same empty cache, NO
     artifact — the full-XLA-compile cold start, for the ratio;
  4. prints the record as one JSON line.

Every step runs in a child process, one at a time, and this parent never
imports JAX: on a GPU only one process at a time holds the card.

Usage: python tools/bench_aot_cold.py [--artifact DIR] [--skip-control]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# The child measures time-to-first-compressed-byte: interpreter start ->
# first write() from the streaming compressor. One full 8x900k batch of
# low-compressibility bytes so the first flush is a real device batch.
_CHILD = r"""
import os, sys, time
t0 = time.time()
sys.path.insert(0, os.environ["BZ2TPU_ROOT"])
import numpy as np
from bz2tpu.runtime.stream import StreamCompressor

class FirstByteSink:
    # The 4-byte stream header flushes at construction, before any device
    # work — "first compressed byte" means the first DEVICE-ENCODED byte.
    def __init__(self):
        self.first = None
        self.n = 0
    def write(self, b):
        self.n += len(b)
        if self.n > 4 and self.first is None:
            self.first = time.time() - t0

data = np.random.default_rng(0).integers(0, 256, 8 * 900_000 - 4096, dtype=np.uint8)
sink = FirstByteSink()
sc = StreamCompressor(sink, level=9, parallel=8)
sc.write(data.tobytes())
sc.close()
print("CHILD_RESULT " + str({"first_byte_s": round(sink.first, 2),
                             "total_s": round(time.time() - t0, 2),
                             "out_bytes": sink.n}))
"""


def _run_child(artifact: str | None, timeout: int) -> dict:
    with tempfile.TemporaryDirectory() as cache:
        env = dict(os.environ)
        env["JAX_COMPILATION_CACHE_DIR"] = os.path.join(cache, "xla")  # empty, fresh
        env["BZ2TPU_ROOT"] = ROOT
        env.pop("BZ2TPU_AOT_DIR", None)
        if artifact:
            env["BZ2TPU_AOT_DIR"] = artifact
        t0 = time.time()
        r = subprocess.run(
            [sys.executable, "-c", _CHILD], env=env, capture_output=True,
            timeout=timeout, cwd=cache,  # NOT the repo: no stale pyc luck
        )
        wall = time.time() - t0
        for line in r.stdout.decode().splitlines():
            if line.startswith("CHILD_RESULT "):
                res = eval(line[len("CHILD_RESULT "):], {}, {})  # noqa: S307 — our own subprocess's literal dict
                res["subprocess_wall_s"] = round(wall, 2)
                return res
        return {"error": (r.stderr.decode()[-400:] or "no result line"),
                "subprocess_wall_s": round(wall, 2)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--artifact", default=os.path.join(ROOT, ".aot_artifact_l9"))
    ap.add_argument("--skip-control", action="store_true")
    ap.add_argument("--skip-export", action="store_true",
                    help="reuse an existing artifact dir as-is")
    args = ap.parse_args()

    rec: dict = {"recorded": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())}

    if not args.skip_export:
        # Build the artifact (fast if the machine cache is warm: the prime
        # pass hits it and the entries hardlink across).
        t0 = time.time()
        r = subprocess.run(
            [sys.executable, "-c",
             "import sys; sys.path.insert(0, %r); "
             "from bz2tpu.utils.aot import export_artifact; "
             "print('ENTRIES', export_artifact(%r, levels=(9,)))"
             % (ROOT, args.artifact)],
            capture_output=True, timeout=3600,
        )
        rec["export_s"] = round(time.time() - t0, 1)
        tail = r.stdout.decode().strip().splitlines()
        rec["export_entries"] = next(
            (int(x.split()[1]) for x in tail if x.startswith("ENTRIES")), None
        )
        if r.returncode != 0:
            rec["export_error"] = r.stderr.decode()[-400:]
            print(json.dumps(rec))
            return 1

    print("measuring AOT cold start (fresh process, empty cache)...",
          file=sys.stderr, flush=True)
    rec["aot_cold"] = _run_child(args.artifact, timeout=1800)
    if not args.skip_control:
        print("measuring control cold start (no artifact, full compile)...",
              file=sys.stderr, flush=True)
        rec["control_cold"] = _run_child(None, timeout=3600)

    rec["criterion"] = "first_byte_s < 60 with artifact"
    fb = rec["aot_cold"].get("first_byte_s")
    rec["pass"] = bool(fb is not None and fb < 60)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
