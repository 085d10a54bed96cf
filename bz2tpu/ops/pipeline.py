"""The fused per-block encode pipeline: BWT -> MTF/RLE2 -> Huffman -> pack.

One jit compilation serves every block at a given capacity; blocks batch
along a leading vmap axis (the vectorised replacement for the reference's
one-work-item-per-block kernel_close, reference kernel.cpp:3124-3159).
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp

from bz2tpu.ops.bwt import bwt_encode
from bz2tpu.ops.emit import pack_block
from bz2tpu.ops.huffman import huffman_assign, max_selectors
from bz2tpu.ops.mtf import mtf_rle2_encode


def encode_block(block, n, crc, *, mtf_chunk: int = 4096):
    """Encode one padded block into its COMPLETE bitstream (header +
    symbol data) on device (reference close_block, kernel.cpp:3099-3122;
    the header emission matches kernel.cpp:2483-2511,2991-3041)."""
    capacity = block.shape[-1]
    maxsel = max_selectors(capacity)
    last, orig_ptr = bwt_encode(block, n)
    mtf = mtf_rle2_encode(last, n, chunk=mtf_chunk)
    plan = huffman_assign(
        mtf["symbols"], mtf["n_sym"], mtf["freqs"], mtf["n_in_use"], maxsel=maxsel
    )
    words, total_bits = pack_block(
        mtf["symbols"], plan["selectors"], plan["lengths"], plan["codes"],
        crc, orig_ptr, mtf["used"], plan["n_groups"], plan["n_selectors"],
        plan["selector_mtf"], maxsel=maxsel,
    )
    return {
        "orig_ptr": orig_ptr,
        "used": mtf["used"],
        "n_sym": mtf["n_sym"],
        "n_in_use": mtf["n_in_use"],
        "n_groups": plan["n_groups"],
        "n_selectors": plan["n_selectors"],
        "words": words,
        "total_bits": total_bits,
    }


@functools.partial(jax.jit, static_argnames=("mtf_chunk",))
def encode_blocks(blocks, ns, crcs, *, mtf_chunk: int = 4096):
    """vmapped batch encode: blocks (B, capacity) uint8, ns (B,) int32,
    crcs (B,) uint32 (per-block CRCs from the RLE1 intake)."""
    return jax.vmap(functools.partial(encode_block, mtf_chunk=mtf_chunk))(blocks, ns, crcs)


# --- staged form: three smaller compilations instead of one mega-graph ---
# The fused jit above is what the compile-check entry uses; the runtime
# dispatches these stages instead because XLA optimization time grows
# superlinearly with graph size, and the stages cache independently.
# Intermediates never leave the device.


@jax.jit
def bwt_stage(blocks, ns):
    return jax.vmap(bwt_encode)(blocks, ns)


_BATCH_MTF = os.environ.get("BZ2TPU_BATCH_MTF", "0") == "1"


@functools.partial(jax.jit, static_argnames=("mtf_chunk",))
def mtf_stage(last, ns, *, mtf_chunk: int = 4096):
    """Per-block vmapped MTF.

    The load-balanced batch scan (ops/mtf.mtf_rle2_encode_batch:
    compacted live slots + closed-form carries, trip count sum(m_b) not
    max(m_b)) stays behind BZ2TPU_BATCH_MTF=1: it lost on the hardware
    it was first measured on, where the carry-precompute scatter and the
    per-iteration gather/scatter cost more than the halved trip count
    saved. It has not been measured on the GPU."""
    if _BATCH_MTF:
        from bz2tpu.ops.mtf import mtf_rle2_encode_batch

        return mtf_rle2_encode_batch(last, ns, chunk=mtf_chunk)
    return jax.vmap(lambda l, n: mtf_rle2_encode(l, n, chunk=mtf_chunk))(last, ns)


@jax.jit
def huff_pack_stage(symbols, n_sym, freqs, n_in_use, orig_ptr, used, crcs):
    """Huffman planning + COMPLETE block emission (header + symbol data
    packed on device, ops/emit.pack_block) with per-block scalars bundled
    into one (B, 6) 'meta' array so the host pulls everything in two
    transfers (meta + sliced words). Meta layout: orig_ptr, n_sym,
    n_in_use, n_groups, n_selectors, total_bits."""
    capacity = symbols.shape[-1] - 2
    maxsel = max_selectors(capacity)

    def one(sym, nsym, fr, niu, optr, usd, crc):
        plan = huffman_assign(sym, nsym, fr, niu, maxsel=maxsel)
        words, total_bits = pack_block(
            sym, plan["selectors"], plan["lengths"], plan["codes"],
            crc, optr, usd, plan["n_groups"], plan["n_selectors"],
            plan["selector_mtf"], maxsel=maxsel,
        )
        meta = jnp.stack(
            [optr, nsym, niu, plan["n_groups"], plan["n_selectors"], total_bits]
        ).astype(jnp.int32)
        return {
            "n_groups": plan["n_groups"],
            "n_selectors": plan["n_selectors"],
            "words": words,
            "total_bits": total_bits,
            "meta": meta,
        }

    return jax.vmap(one)(symbols, n_sym, freqs, n_in_use, orig_ptr, used, crcs)


# Compact-width huff+pack (round 5): MTF+RLE2 output is typically 1.5-3x
# shorter than the padded (capacity + 2) symbol domain, yet the Huffman
# group histogram and the whole pack (cumsum + 2 gathers + 2 scatter-adds)
# ran over the FULL domain. Slicing the symbol batch to a quantized width
# >= max(n_sym) before huff_pack_stage cuts that stage's element traffic
# proportionally with BIT-IDENTICAL output (positions >= n_sym are -1
# padding that contributes 0 bits either way; the header's selector slots
# shrink with max_selectors(width) but slots beyond n_selectors carry 0
# bits). Widths quantize to eighths of the full domain so at most six
# programs per capacity ever compile (each distinct shape is one more
# cached compile).
_COMPACT_PACK = os.environ.get("BZ2TPU_COMPACT_PACK", "1") == "1"
# Sub-toggle: also run the RLE2 output-domain emission at the compact
# width (ops/mtf._rle2_out) inside the pack program, instead of at full
# width inside the MTF stage. BZ2TPU_COMPACT_PACK=0 disables both.
_COMPACT_EMIT = os.environ.get("BZ2TPU_COMPACT_EMIT", "1") == "1"
_WIDTH_EIGHTHS = (2, 3, 4, 5, 6, 8)


def huff_width(capacity: int, max_nsym: int) -> int:
    """Smallest ladder width (eighths of capacity + 2) covering max_nsym."""
    full = capacity + 2
    for k in _WIDTH_EIGHTHS:
        w = (full * k + 7) // 8
        if w >= max_nsym:
            return w
    return full


@functools.lru_cache(maxsize=None)
def _sym_slicer(width: int):
    return jax.jit(lambda s: jax.lax.slice_in_dim(s, 0, width, axis=-1))


@functools.partial(jax.jit, static_argnames=("mtf_chunk",))
def mtf_plan_stage(last, ns, *, mtf_chunk: int = 4096):
    """MTF ranks + collapsed-domain RLE2 plan (no output-domain pass):
    the compact pipeline's replacement for mtf_stage. Returns the vmapped
    ops/mtf._rle2_plan pytree (w1/zp1/pos/kval/total/tail_vals/n_sym/
    used/n_in_use)."""
    from bz2tpu.ops.mtf import mtf_rle2_plan

    return jax.vmap(lambda l, n: mtf_rle2_plan(l, n, chunk=mtf_chunk))(last, ns)


@functools.partial(jax.jit, static_argnames=("width",))
def emit_huff_pack_stage(plan, orig_ptr, crcs, *, width: int):
    """RLE2 emission + Huffman planning + COMPLETE block emission, all at
    the compact ``width`` (>= the batch's max n_sym): every output-domain
    pass of the emission, the group histogram, and the whole pack run
    over ``width`` elements instead of capacity + 2. Bit-identical to the
    full-width path (tests/test_compact_pack.py)."""
    from bz2tpu.ops.mtf import _rle2_out

    maxsel = max_selectors(width - 2)

    def one(p, optr, crc):
        sym, _ = _rle2_out(p, width, with_freqs=False)
        hp = huffman_assign(sym, p["n_sym"], None, p["n_in_use"], maxsel=maxsel)
        words, total_bits = pack_block(
            sym, hp["selectors"], hp["lengths"], hp["codes"],
            crc, optr, p["used"], hp["n_groups"], hp["n_selectors"],
            hp["selector_mtf"], maxsel=maxsel,
        )
        meta = jnp.stack(
            [optr, p["n_sym"], p["n_in_use"], hp["n_groups"],
             hp["n_selectors"], total_bits]
        ).astype(jnp.int32)
        return {
            "n_groups": hp["n_groups"],
            "n_selectors": hp["n_selectors"],
            "words": words,
            "total_bits": total_bits,
            "meta": meta,
        }

    return jax.vmap(one)(plan, orig_ptr, crcs)


# Fused pack+concat (round 5): the batch's block bitstreams scatter ONCE
# into the final concatenated buffer at global bit offsets
# (ops/emit.pack_blocks_concat) instead of per-block pack then a second
# concat scatter pass. Bit-identical; BZ2TPU_FUSED_PACK=0 restores the
# separate stages.
_FUSED_PACK = os.environ.get("BZ2TPU_FUSED_PACK", "1") == "1"


@functools.partial(jax.jit, static_argnames=("width",))
def emit_huff_pack_concat_stage(plan, orig_ptr, crcs, live, *, width: int):
    """RLE2 emission + Huffman planning at the compact ``width``, then the
    whole batch packs + concatenates in one scatter pass. Returns
    (cat_words (B*W + 1,) uint32, total_bits, block_bits (B,))."""
    from bz2tpu.ops.emit import pack_blocks_concat
    from bz2tpu.ops.mtf import _rle2_out

    maxsel = max_selectors(width - 2)

    def one(p):
        sym, _ = _rle2_out(p, width, with_freqs=False)
        hp = huffman_assign(sym, p["n_sym"], None, p["n_in_use"], maxsel=maxsel)
        return sym, hp

    sym, hp = jax.vmap(one)(plan)
    return pack_blocks_concat(
        sym, hp["selectors"], hp["lengths"], hp["codes"], crcs, orig_ptr,
        plan["used"], hp["n_groups"], hp["n_selectors"], hp["selector_mtf"],
        live, maxsel=maxsel,
    )


def encode_blocks_staged(blocks, ns, crcs, *, mtf_chunk: int = 4096):
    """Same result pytree as encode_blocks (plus 'meta'), via staged jits.

    Cold processes skip compilation twice over: the persistent cache
    covers this machine, and a shipped AOT artifact (utils/aot.py,
    BZ2TPU_AOT_DIR) pre-installs the executables on fresh machines."""
    last, orig_ptr = bwt_stage(blocks, ns)
    if _COMPACT_PACK and _COMPACT_EMIT and not _BATCH_MTF:
        plan = mtf_plan_stage(last, ns, mtf_chunk=mtf_chunk)
        # One small scalar fetch per batch; the device executes in order,
        # so the previous batch's D2H still overlaps this batch's
        # emit+huff+pack dispatch (runtime/compressor.py async notes).
        width = huff_width(blocks.shape[-1], int(jnp.max(plan["n_sym"])))
        out = dict(emit_huff_pack_stage(plan, orig_ptr, crcs, width=width))
        out["orig_ptr"] = orig_ptr
        out["used"] = plan["used"]
        out["n_sym"] = plan["n_sym"]
        out["n_in_use"] = plan["n_in_use"]
        return out
    mtf = mtf_stage(last, ns, mtf_chunk=mtf_chunk)
    symbols = mtf["symbols"]
    if _COMPACT_PACK:
        max_nsym = int(jnp.max(mtf["n_sym"]))
        width = huff_width(blocks.shape[-1], max_nsym)
        if width < symbols.shape[-1]:
            symbols = _sym_slicer(width)(symbols)
    out = huff_pack_stage(
        symbols, mtf["n_sym"], mtf["freqs"], mtf["n_in_use"], orig_ptr,
        mtf["used"], crcs,
    )
    out = dict(out)
    out["orig_ptr"] = orig_ptr
    out["used"] = mtf["used"]
    out["n_sym"] = mtf["n_sym"]
    out["n_in_use"] = mtf["n_in_use"]
    return out


def prime_width_programs(batch: int, capacity: int) -> None:
    """Compile every compact-width stage variant the driver can dispatch
    at (batch, capacity), into the active compilation cache (called by
    utils/jaxenv.prime so shipped AOT artifacts keep their zero-compile
    promise — the random prime corpus only ever lands on the full rung).
    Runs whichever stage the current flags select."""
    if not _COMPACT_PACK:
        return

    from bz2tpu.ops.emit import concat_block_words

    blocks = jnp.zeros((batch, capacity), jnp.uint8)
    ns = jnp.ones(batch, jnp.int32)
    crcs = jnp.zeros(batch, jnp.uint32)
    live = jnp.ones(batch, bool)
    last, orig_ptr = bwt_stage(blocks, ns)
    full = capacity + 2
    compact_emit = _COMPACT_EMIT and not _BATCH_MTF
    plan = mtf_plan_stage(last, ns) if compact_emit else None
    mtf = None if compact_emit else mtf_stage(last, ns)
    for k in _WIDTH_EIGHTHS:
        w = (full * k + 7) // 8
        if w >= full and not (compact_emit and _FUSED_PACK):
            continue  # the full rung compiles via prime's real compress
        if compact_emit:
            if _FUSED_PACK:
                cat = emit_huff_pack_concat_stage(
                    plan, orig_ptr, crcs, live, width=w
                )
                jax.block_until_ready(cat)
                continue
            out = emit_huff_pack_stage(plan, orig_ptr, crcs, width=w)
        else:
            out = huff_pack_stage(
                _sym_slicer(w)(mtf["symbols"]), mtf["n_sym"], mtf["freqs"],
                mtf["n_in_use"], orig_ptr, mtf["used"], crcs,
            )
        cat = concat_block_words(
            out["words"], out["meta"][:, 5].astype(jnp.int32)
        )
        jax.block_until_ready(cat)
