"""Multi-host initialization.

The reference is strictly single-process/single-device (one OpenCL queue,
include/opencl.hpp). Multi-host bz2tpu runs are plain jax.distributed SPMD:
every host runs the same driver, the global ("blocks",) mesh spans all
chips, each host feeds its local shard of the block batch, and host 0
stitches (compression needs no cross-block communication, so DCN carries
only the gathered compressed bits; per-shard CRCs fold associatively —
format.crc32.stream_crc — so integrity can be checked before the gather).
"""

from __future__ import annotations


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Initialize jax.distributed.

    With no arguments, attempts environment auto-detection (cluster
    metadata and env vars) exactly like jax.distributed.initialize;
    a plain single-process environment with nothing to detect degrades to
    a single-process run WITH A LOUD WARNING (a misconfigured pod must not
    silently compress on 1/N of its hosts). Explicit arguments always
    propagate errors.
    """
    import jax

    if num_processes == 1:
        return
    explicit = any(v is not None for v in (coordinator_address, num_processes, process_id))
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except (RuntimeError, ValueError) as e:
        if explicit:
            raise
        import warnings

        warnings.warn(
            "jax.distributed auto-detection failed "
            f"({e}); continuing SINGLE-PROCESS. If this host is part of a "
            "multi-host run, pass coordinator_address/num_processes/"
            "process_id explicitly.",
            RuntimeWarning,
            stacklevel=2,
        )


def is_primary() -> bool:
    import jax

    return jax.process_index() == 0
