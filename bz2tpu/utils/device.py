"""Device discovery and banner.

Parity: the reference enumerates OpenCL devices, estimates TFLOPs, and
selects the max-FLOPs device (reference include/opencl.hpp:14-142,
print_device_info :87-107). JAX owns discovery here; this module surfaces
the same information and the mesh shape that will be used.
"""

from __future__ import annotations


def device_info() -> list[dict]:
    """One dict per visible accelerator (reference Device_Info analog)."""
    import jax

    out = []
    for d in jax.devices():
        out.append(
            {
                "id": d.id,
                "platform": d.platform,
                "kind": getattr(d, "device_kind", "unknown"),
                "process": getattr(d, "process_index", 0),
            }
        )
    return out


def print_device_banner(file=None) -> None:
    import sys

    file = file or sys.stderr
    infos = device_info()
    print(f"bz2tpu: {len(infos)} device(s)", file=file)
    for i in infos:
        print(
            f"  [{i['id']}] {i['kind']} ({i['platform']}, process {i['process']})",
            file=file,
        )


def gpu_card() -> str:
    """The NVIDIA card's name and power limit, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them (one line per card). A card set below its maximum power
    runs slower under load, so every recorded time names this line.
    Raises when nvidia-smi is missing or fails."""
    import subprocess

    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return r.stdout.strip()


def require_gpu() -> dict:
    """Identity of the GPU JAX runs on; raises RuntimeError when JAX's
    default device is not a GPU (measurements never fall back to the CPU)."""
    import jax

    d = jax.devices()[0]
    if d.platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's default device is {d.platform} ({d.device_kind})"
        )
    return {"platform": d.platform, "kind": d.device_kind, "count": len(jax.devices())}
