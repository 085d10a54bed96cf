"""Inverse BWT on device: pointer-doubling orbit materialization.

The reference (and every host bzip2) walks the T-vector one dependent hop
per output byte — a serial pointer chase that is THE classic decode
bottleneck (reference include/BlockDecompressor.hpp:244-282: counting sort
to build T, then one `decodeNextBWTByte` per byte). The device formulation
removes the serial chain: the walk's orbit

    pos[0] = T[orig_ptr],  pos[i+1] = T[pos[i]]

is materialized with log2(n) batched gathers — after round r the first 2^r
entries are known, and applying the 2^r-step jump map T^(2^r) to them
yields the next 2^r (the same doubling used by the NumPy oracle,
bz2tpu/oracle/decoder.py:inverse_bwt). All shapes static; padding bytes
carry sort keys above any real byte so the stable counting order of the
valid prefix is untouched.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=())
def ibwt(last: jnp.ndarray, n: jnp.ndarray, orig_ptr: jnp.ndarray) -> jnp.ndarray:
    """Invert the BWT of a padded block.

    Args:
      last: (S,) uint8 BWT last column, padded past ``n`` (content ignored).
      n: scalar int32 valid length (>= 1).
      orig_ptr: scalar int32 sorted position of rotation 0.

    Returns:
      (S,) uint8 decoded bytes, zero-padded past ``n``.
    """
    s = last.shape[0]
    iota = jnp.arange(s, dtype=jnp.int32)
    valid = iota < n
    # Stable order of bytes = the T-vector; padding keys sort after all
    # real bytes so order[:n] is exactly the oracle's counting order.
    key = jnp.where(valid, last.astype(jnp.int32), 257)
    order = jnp.argsort(key, stable=True).astype(jnp.int32)

    pos = jnp.zeros(s, dtype=jnp.int32).at[0].set(order[orig_ptr])
    jump = order
    rounds = max(1, (s - 1).bit_length())
    for r in range(rounds):
        f = 1 << r
        cand = jnp.roll(jump[pos], f)
        pos = jnp.where((iota >= f) & (iota < 2 * f), cand, pos)
        if r + 1 < rounds:
            jump = jump[jump]
    return jnp.where(valid, last[pos], 0).astype(jnp.uint8)


ibwt_batch = jax.jit(jax.vmap(ibwt))
