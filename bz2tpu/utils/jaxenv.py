"""JAX environment knobs.

The 900k-block pipeline is a large XLA graph and its first compilation
takes a noticeable part of a cold run. A persistent compilation cache makes
that a one-time cost per (shape, level) across processes — the analog of
the reference shipping a prebuilt kernel binary via #define PTX (reference
include/opencl.hpp:203-205), except the cache is automatic.
"""

from __future__ import annotations

import os
import warnings

_DONE = False
# The checkout-local default: a FIXED path, because JAX's cache keys are
# only found again by a process that looks in the same directory.
_DEFAULT_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def cache_dir() -> str:
    """The persistent cache directory: ``JAX_COMPILATION_CACHE_DIR`` when
    set (JAX reads it at start-up), else ``<checkout>/.jax_cache``."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or _DEFAULT_CACHE


def setup_compilation_cache() -> None:
    """Enable the persistent XLA compilation cache (idempotent).

    Call it before the process's first compilation: JAX decides once per
    process whether the cache is in use. Where the checkout-local default
    cannot be created or written (an install into a read-only
    site-packages), warn and leave the persistent cache off."""
    global _DONE
    if _DONE:
        return
    import jax

    cache = cache_dir()
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(cache, exist_ok=True)
    else:
        try:
            os.makedirs(cache, exist_ok=True)
            writable = os.access(cache, os.W_OK)
        except OSError:
            writable = False
        if not writable:
            warnings.warn(
                f"bz2tpu: cannot write the compile cache {cache}; the persistent "
                "compilation cache is off (set JAX_COMPILATION_CACHE_DIR to enable it)",
                stacklevel=2,
            )
            _DONE = True
            return
        jax.config.update("jax_compilation_cache_dir", cache)
    # Cache every program, sub-second ones included, so that a warm run
    # compiles nothing at all (chip_smoke.py counts fresh compiles).
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    # JAX roots XLA's GPU autotune sub-cache inside the cache dir and puts
    # that PATH into the compile options, so every cache key would depend
    # on where the cache lives: an exported AOT artifact (utils/aot.py)
    # installed into another directory would never hit. With the
    # sub-cache off, keys are path-portable (tests/test_aot.py) and a warm
    # GPU run still compiles nothing (chip_smoke.py phase 5).
    jax.config.update("jax_persistent_cache_enable_xla_caches", "none")
    _DONE = True
    # A shipped AOT artifact (utils/aot.py) installs its prebuilt
    # executables into the cache so every dispatch below is a hit.
    aot_dir = os.environ.get("BZ2TPU_AOT_DIR")
    if aot_dir and os.path.abspath(aot_dir) != os.path.abspath(cache):
        from bz2tpu.utils import aot

        aot.install(aot_dir, cache)


class CompileCounter:
    """Counts XLA compilations while active, split into persistent-cache
    hits and fresh compiles.

    JAX logs "Compiling <fn>" before every cache lookup (under
    ``jax_log_compiles``) and "Persistent compilation cache hit" when the
    lookup succeeds, so fresh = compiling - hits. Use as a context
    manager; a warm cache shows ``fresh == 0``.
    """

    def __init__(self) -> None:
        self.compiling = 0
        self.cache_hits = 0

    @property
    def fresh(self) -> int:
        return max(self.compiling - self.cache_hits, 0)

    def __enter__(self) -> "CompileCounter":
        import logging

        import jax

        counter = self

        class _Handler(logging.Handler):
            def emit(self, record):
                msg = record.getMessage()
                if "Persistent compilation cache hit" in msg:
                    counter.cache_hits += 1
                elif msg.startswith("Compiling "):
                    counter.compiling += 1

        self._logger = logging.getLogger("jax")
        self._handler = _Handler()
        self._prev_level = self._logger.level
        self._prev_log = jax.config.jax_log_compiles
        jax.config.update("jax_log_compiles", True)
        self._logger.addHandler(self._handler)
        self._logger.setLevel(logging.WARNING)
        return self

    def __exit__(self, *exc) -> None:
        import jax

        jax.config.update("jax_log_compiles", self._prev_log)
        self._logger.removeHandler(self._handler)
        self._logger.setLevel(self._prev_level)


def prime(levels=(9,), batch: int | None = None, verbose: bool = True) -> None:
    """Pre-compile the standard pipeline shapes into the persistent cache.

    Cold CLI runs otherwise pay the full XLA compile for every shape. The
    compiled programs depend only on (level, batch) shapes, so compressing
    a tiny input exercises exactly the executables real runs need; after
    one prime, cold processes hit the cache. The analog of the reference
    shipping a prebuilt kernel binary (reference include/opencl.hpp:203).
    """
    import time

    import numpy as np

    setup_compilation_cache()
    from bz2tpu.format import constants as C
    from bz2tpu.runtime.compressor import DEFAULT_BATCH, compress

    b = batch or DEFAULT_BATCH
    for level in levels:
        t0 = time.time()
        # Every pow2 batch width the quantizer can pick (compressor.py:
        # small streams quantize to {1, 2, 4, ..., b}), plus the full
        # batch. Random bytes barely shrink under RLE1, so w*capacity -
        # margin raw bytes split into exactly w full blocks — the same
        # (w, capacity) programs real streams use. (The old tiny-input
        # prime only ever compiled batch=1, which is why primed runs
        # still paid the full batch compile.)
        w = 1
        widths = []
        while w < b:
            widths.append(w)
            w <<= 1
        widths.append(b)
        for w in widths:
            if w == 1:
                compress(b"prime" * 300, level=level, parallel=b)
                continue
            n = w * C.BLOCK_SIZE_BASE * level - 4096
            data = np.random.default_rng(0).integers(0, 256, n, dtype=np.uint8)
            compress(data, level=level, parallel=b)
        # Compact-width stage variants (ops/pipeline.huff_width): the
        # random prime corpus barely collapses under MTF, so the real
        # compress calls above only ever compile the FULL-width rung;
        # text-like corpora land on sub-full rungs. Compile each rung
        # directly at the full batch (the only batch width padded streams
        # dispatch) so a shipped artifact keeps its zero-compile promise.
        # Sub-full rungs at SMALLER pow2 batches are not primed (tiny
        # streams only), same trade as the escalation windows below.
        from bz2tpu.ops.pipeline import prime_width_programs

        prime_width_programs(b, C.BLOCK_SIZE_BASE * level)
        # The --backend device intake program at its BASE chunk window.
        # NOT primed: the 2x/4x/8x escalation windows that highly
        # compressible streams can reach (compressor.py window widening)
        # — each is one more compile, paid once on first escalation and
        # cached after.
        from bz2tpu.runtime.compressor import compress_device_intake

        data = np.random.default_rng(0).integers(
            0, 256, C.BLOCK_SIZE_BASE * level, dtype=np.uint8
        )
        compress_device_intake(data, level=level, parallel=b)
        if verbose:
            print(f"primed level {level} (batch 1 + {b}): {time.time() - t0:.1f}s")
