"""Per-stage device time of one level-9 compress, from a profiler trace.

    python tools/trace_stages.py [--out DIR]

Compresses chip_smoke.py's phase-1 corpus (bench.py's mixed corpus, 16
level-9 blocks) twice to warm every program and time an untraced call,
then traces a third ``bz2tpu.compress`` with ``jax.profiler`` into DIR
under a host annotation, and reduces the trace: per jitted program
(``hlo_module`` of each event on the GPU's stream lines) its kernel time,
kernel count, top kernel families and the copies it issued (a D2H copy
inside a module is a ``while_loop`` predicate read back to the host);
host<->device copy time by direction; the union of busy intervals; and
the idle share of the annotated ``compress()`` span. Prints one JSON
line; the trace itself stays in DIR.
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SPAN = "trace_stages.compress"  # host annotation around the traced call


def _copy_kind(name: str) -> str | None:
    """'h2d', 'd2h' or 'd2d' for a copy event (MemcpyH2D, ...), else None."""
    return name[len("Memcpy"):].lower() if name.startswith("Memcpy") else None


def _family(kernel: str) -> str:
    """A kernel's name without XLA's numeric suffixes: 'sort_24_1' and
    'sort_3' are both 'sort'."""
    return kernel.rstrip("0123456789_.") or kernel


def reduce_trace(path: str, top: int = 3) -> dict:
    """Reduce one ``.xplane.pb``: per module its kernel ns and count, its
    ``top`` kernel families by time and its copies by kind; all copy ns by
    kind; busy ns (union of all device events) and the window they span;
    and the duration of the host ``SPAN`` annotation, if present."""
    from jax.profiler import ProfileData

    modules: dict = collections.defaultdict(
        lambda: {"kernel_ns": 0, "kernels": 0, "families": collections.Counter(),
                 "family_count": collections.Counter(), "copies": collections.Counter()}
    )
    copy_ns: collections.Counter = collections.Counter()
    intervals = []
    span_ns = None
    for plane in ProfileData.from_file(path).planes:
        on_device = plane.name.startswith("/device:")
        for line in plane.lines:
            if not on_device:
                for ev in line.events:
                    if ev.name == SPAN:
                        span_ns = ev.duration_ns
                continue
            if not line.name.lower().startswith("stream"):
                continue  # derived lines (XLA Modules/Ops) repeat the kernels
            for ev in line.events:
                dur = ev.duration_ns
                intervals.append((ev.start_ns, ev.start_ns + dur))
                module = dict(ev.stats).get("hlo_module")
                kind = _copy_kind(ev.name)
                if kind:
                    copy_ns[kind] += dur
                    if module:
                        modules[str(module)]["copies"][kind] += 1
                    continue
                m = modules[str(module or "?")]
                m["kernel_ns"] += dur
                m["kernels"] += 1
                m["families"][_family(ev.name)] += dur
                m["family_count"][_family(ev.name)] += 1
    busy, window = busy_ns(intervals)
    by_module = {
        name: {
            "kernel_ns": m["kernel_ns"],
            "kernels": m["kernels"],
            "top": [{"family": f, "ns": ns, "count": m["family_count"][f]}
                    for f, ns in m["families"].most_common(top)],
            "copies": dict(m["copies"]),
        }
        for name, m in sorted(modules.items(), key=lambda kv: -kv[1]["kernel_ns"])
    }
    return {
        "modules": by_module,
        "copy_ns": dict(copy_ns),
        "busy_ns": busy,
        "device_window_ns": window,
        "span_ns": span_ns,
    }


def busy_ns(intervals) -> tuple[int, int]:
    """(length of the union of [start, end) intervals, first start to last
    end): the device's busy time and the window it falls in."""
    busy = 0
    first = end = None
    for s, e in sorted(intervals):
        if end is None:
            first = s
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy, (end - first) if end is not None else 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "trace"))
    args = ap.parse_args()

    import jax

    import bench
    import bz2tpu
    from bz2tpu.utils.device import gpu_card, require_gpu
    from bz2tpu.utils.jaxenv import setup_compilation_cache
    from chip_smoke import CORPUS_BYTES

    device = require_gpu()
    setup_compilation_cache()
    data = bench.make_mixed_corpus(CORPUS_BYTES)
    bz2tpu.compress(data, level=9)  # compile + warm
    t0 = time.perf_counter()
    bz2tpu.compress(data, level=9)
    untraced = time.perf_counter() - t0
    with jax.profiler.trace(args.out):
        with jax.profiler.TraceAnnotation(SPAN):
            bz2tpu.compress(data, level=9)
    path = sorted(glob.glob(os.path.join(args.out, "plugins", "profile", "*", "*.xplane.pb")))[-1]
    res = reduce_trace(path)
    if res["span_ns"] is None:
        raise RuntimeError(f"no {SPAN!r} host event in {path}")
    res["untraced_wall_s"] = untraced
    res["idle_share_of_span"] = 1 - res["busy_ns"] / res["span_ns"]
    print(json.dumps({"device": device, "card": gpu_card(), "input_bytes": len(data), **res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
