"""Compression driver: host RLE1/split -> batched device encode -> stitch.

Orchestration parity with the reference OutputStream (compress path,
include/OutputStream.hpp:126-239): stream header, per-block headers + CRCs,
device batch launch, ordered bit-exact stitching with sub-byte carry, end
marker + combined stream CRC. Redesigned: blocks are packed uint32 words on
device (not bool-per-bit buffers), the stitch is a vectorized byte-shift
concat (format.bitio.concat_bitstreams) instead of a bit-at-a-time host
loop, and batches are padded to a fixed size so one XLA compilation serves
the whole stream.
"""

from __future__ import annotations

import functools

import numpy as np

from bz2tpu.format import constants as C
from bz2tpu.format.bitio import BitWriter, concat_bitstreams
from bz2tpu.format.crc32 import stream_crc
from bz2tpu.oracle.encoder import Rle1Block, rle1_split

DEFAULT_BATCH = 8  # blocks per device batch; not yet re-swept on the GPU


def split_blocks(data: bytes | np.ndarray, level: int) -> list[Rle1Block]:
    """RLE1 + CRC block intake: native C single pass when built, NumPy
    fallback (bz2tpu.native warns when it has to fall back)."""
    from bz2tpu import native

    if native.HAVE_NATIVE:
        arr = data if isinstance(data, (bytes, bytearray, memoryview)) else np.ascontiguousarray(data, np.uint8)
        return [
            Rle1Block(np.frombuffer(b, np.uint8), raw, crc)
            for b, raw, crc in native.rle1_split(arr, level)
        ]
    arr = np.frombuffer(bytes(data), np.uint8) if not isinstance(data, np.ndarray) else data
    return rle1_split(arr, level)


def _block_header_bits(
    crc: int,
    orig_ptr: int,
    used: np.ndarray,
    n_groups: int,
    n_selectors: int,
    selector_mtf: np.ndarray,
    lengths: np.ndarray,
    n_in_use: int,
) -> tuple[np.ndarray, int]:
    """Everything before the Huffman-coded symbol data of one block.

    HOST ORACLE ONLY: the runtime emits the whole block — header included —
    on device (ops/emit.pack_block); this NumPy writer remains as the
    differential-test reference for that emission
    (tests/test_ops_emit_header.py)."""
    w = BitWriter()
    w.write_bits(48, C.BLOCK_HEADER_MARKER)
    w.write_bits(32, crc)
    w.write_bit(0)  # randomised: never emitted
    w.write_bits(24, orig_ptr)
    ranges = used.reshape(16, 16)
    range_used = ranges.any(axis=1)
    w.write_bits(16, int.from_bytes(np.packbits(range_used).tobytes(), "big"))
    for r in np.flatnonzero(range_used):
        w.write_bits(16, int.from_bytes(np.packbits(ranges[r]).tobytes(), "big"))
    w.write_bits(3, n_groups)
    w.write_bits(15, n_selectors)
    for j in selector_mtf[:n_selectors].tolist():
        w.write_unary(j)
    alpha = n_in_use + 2
    for t in range(n_groups):
        lens = lengths[t, :alpha]
        cur = int(lens[0])
        w.write_bits(5, cur)
        for v in lens.tolist():
            while cur < v:
                w.write_bits(2, 2)  # '10' increment
                cur += 1
            while cur > v:
                w.write_bits(2, 3)  # '11' decrement
                cur -= 1
            w.write_bit(0)
    return np.frombuffer(w.getvalue(), dtype=np.uint8), w.bit_length


# Default ON (removes all host bit work); BZ2TPU_DEVICE_STITCH=0 restores
# the per-block host stitch.
_DEVICE_STITCH = __import__("os").environ.get("BZ2TPU_DEVICE_STITCH", "1") == "1"

_SLICE_GRANULE = 1 << 14  # words; bounds distinct compiled slice shapes


@functools.lru_cache(maxsize=None)
def _word_slicer(nwords: int):
    import jax

    return jax.jit(lambda w: jax.lax.dynamic_slice_in_dim(w, 0, nwords, axis=1))


def _fetch_words_batch(words_dev, bit_counts: list[int]) -> list[np.ndarray]:
    """Fetch every block's compressed word prefix in ONE transfer.

    The padded words buffer is many times the compressed size, and every
    fetch is one device->host round trip. One sliced (B, max_words) pull
    sized by the batch's largest block moves less than whole rows and
    costs fewer round trips than per-row slices. Slice widths round to a
    granule so only a handful of slice programs ever compile.
    """
    nws = [(tb + 31) // 32 for tb in bit_counts]
    # Power-of-two widths: every distinct width compiles a (tiny) slice
    # program — one width per octave keeps that to a handful per stream.
    padded = _SLICE_GRANULE
    while padded < max(nws):
        padded *= 2
    padded = min(padded, words_dev.shape[1])
    rows = np.asarray(_word_slicer(padded)(words_dev))
    return [rows[i, :nw] for i, nw in enumerate(nws)]


def _encode_batches(blocks: list[Rle1Block], capacity: int, batch: int):
    """Run the device pipeline over fixed-size batches; yield per-block
    numpy outputs in stream order.

    Dispatch is async: the next batch is launched before the previous
    batch's results are pulled, overlapping device compute with the
    (slow) device->host fetch of compressed words.
    """
    import jax
    import jax.numpy as jnp

    from bz2tpu.ops.pipeline import encode_blocks_staged
    from bz2tpu.utils.jaxenv import setup_compilation_cache

    setup_compilation_cache()

    n_blocks = len(blocks)
    bases = list(range(0, n_blocks, batch))
    n_dev = jax.device_count()
    use_mesh = n_dev > 1 and batch % n_dev == 0

    def run(buf, ns, crcs):
        if use_mesh:
            from bz2tpu.parallel.mesh import block_mesh, encode_blocks_sharded

            return encode_blocks_sharded(buf, ns, crcs, mesh=block_mesh())
        return encode_blocks_staged(buf, ns, crcs)

    def dispatch(base):
        chunk = blocks[base : base + batch]
        # Always pad to the full batch so one compiled shape serves every
        # round.
        buf = np.zeros((batch, capacity), dtype=np.uint8)
        ns = np.ones(batch, dtype=np.int32)  # padding rows encode 1 junk byte
        crcs = np.zeros(batch, dtype=np.uint32)
        for i, blk in enumerate(chunk):
            buf[i, : blk.data.size] = blk.data
            ns[i] = blk.data.size
            crcs[i] = blk.crc
        return len(chunk), run(jnp.asarray(buf), jnp.asarray(ns), jnp.asarray(crcs))

    META = ("orig_ptr", "n_sym", "n_in_use", "n_groups", "n_selectors", "total_bits")
    pending = dispatch(bases[0]) if bases else None
    for bi, base in enumerate(bases):
        n_chunk, out = pending
        pending = dispatch(bases[bi + 1]) if bi + 1 < len(bases) else None
        # Two fetches per batch: packed scalars and the compressed words —
        # the device emits the COMPLETE block bitstream (header included,
        # ops/emit.pack_block), so no header blob exists.
        meta = np.asarray(out["meta"])
        words = _fetch_words_batch(
            out["words"], [int(meta[i, 5]) for i in range(n_chunk)]
        )
        for i in range(n_chunk):
            row = {k: int(meta[i, j]) for j, k in enumerate(META)}
            row["words"] = words[i]
            yield row


def compress_device_intake(
    data: bytes | np.ndarray,
    level: int = C.DEFAULT_LEVEL,
    parallel: int | None = None,
) -> bytes:
    """Compress with the FULLY-DEVICE pipeline: RLE1, block splitting, and
    per-block CRCs run on the device (ops/intake.py) — no native extension
    and no host pass over the raw bytes; the host only uploads chunks and
    stitches finished block bitstreams.

    Streams are valid and CRC-exact; block boundaries can differ from the
    host-intake path only when a chunk ends in a partial block on highly
    compressible data (both splits are conformant).
    """
    import jax
    import jax.numpy as jnp

    from bz2tpu.ops.intake import chunk_capacity, device_intake
    from bz2tpu.ops.pipeline import encode_blocks_staged
    from bz2tpu.utils.jaxenv import setup_compilation_cache

    setup_compilation_cache()
    arr = (
        np.frombuffer(bytes(data), dtype=np.uint8)
        if not isinstance(data, np.ndarray)
        else np.ascontiguousarray(data, dtype=np.uint8)
    )
    if not C.MIN_LEVEL <= level <= C.MAX_LEVEL:
        raise ValueError(f"block size level must be 1..9, got {level}")
    batch = parallel or DEFAULT_BATCH
    capacity = C.BLOCK_SIZE_BASE * level
    chunk_n = chunk_capacity(level, batch)

    parts: list[tuple[np.ndarray, int]] = []
    head = BitWriter()
    head.write_bits(24, int.from_bytes(C.STREAM_MAGIC, "big"))
    head.write_bits(8, ord("0") + level)
    parts.append((np.frombuffer(head.getvalue(), dtype=np.uint8), head.bit_length))

    offset = 0
    crc_list: list[int] = []
    # Highly compressible input can RLE1 a whole chunk into a single
    # under-full block; rather than emit undersized blocks (ratio loss),
    # escalate the chunk window (each pow2 size is one cached compile).
    cur_chunk_n = chunk_n
    max_chunk_n = chunk_n * 8

    def drain(pending):
        """Fetch a launched batch's words (the big D2H) and emit blocks."""
        nb, crcs_host, out = pending
        meta = np.asarray(out["meta"])
        words = _fetch_words_batch(
            out["words"], [int(meta[i, 5]) for i in range(nb)]
        )
        for i in range(nb):
            parts.append((words[i].astype(">u4").view(np.uint8), int(meta[i, 5])))
            crc_list.append(int(crcs_host[i]))

    # One launched-but-unfetched batch rides behind the scan: the next
    # chunk's intake+encode is dispatched BEFORE the previous batch's
    # words leave the device, overlapping the D2H transfer with device
    # compute — the same async pattern as _encode_batches.
    pending = None
    while offset < arr.size:
        take = min(cur_chunk_n, arr.size - offset)
        padded = np.zeros(cur_chunk_n, np.uint8)
        padded[:take] = arr[offset : offset + take]
        res = device_intake(
            jnp.asarray(padded), jnp.int32(take), level=level, max_blocks=batch
        )
        nb = int(res["n_blocks"])
        raw_lens = np.asarray(res["raw_lens"])
        ns_host = np.asarray(res["ns"])
        more = offset + take < arr.size
        # Full = reached stock's fill threshold (nblockMAX); comparing
        # against the padded buffer width (capacity) instead held back
        # even FULL trailing blocks for a pointless re-scan every chunk.
        under_full = ns_host[nb - 1] < C.block_capacity(level)
        if more and nb == 1 and under_full and cur_chunk_n < max_chunk_n:
            cur_chunk_n *= 2  # widen the window until the block fills
            continue
        if more and nb > 1 and under_full:
            nb -= 1  # hold back the partial trailing block for the next chunk
        out = encode_blocks_staged(res["blocks"], res["ns"], res["crcs"])
        crcs_host = np.asarray(res["crcs"])
        offset += int(raw_lens[:nb].sum())
        if cur_chunk_n > chunk_n and nb == batch:
            # A full batch from a widened window means the data stopped
            # being ultra-compressible: block_cuts caps at `batch` blocks,
            # so keeping the wide window would re-scan/upload up to 8x the
            # consumable bytes every launch. Drop back to the base window
            # (re-escalation is cheap: each pow2 size is a cached compile).
            cur_chunk_n = chunk_n
        if pending is not None:
            drain(pending)
        pending = (nb, crcs_host, out)
    if pending is not None:
        drain(pending)

    tail = BitWriter()
    tail.write_bits(48, C.STREAM_END_MARKER)
    tail.write_bits(32, stream_crc(crc_list))
    parts.append((np.frombuffer(tail.getvalue(), dtype=np.uint8), tail.bit_length))
    packed, _ = concat_bitstreams(parts)
    return packed.tobytes()


@functools.lru_cache(maxsize=None)
def _live_mask(batch: int, n_chunk: int):
    """Device-resident (batch,) bool mask, uploaded ONCE per distinct
    value: a stream sees exactly two (all-live and the final partial
    batch), so no batch pays its own host->device upload."""
    import jax.numpy as jnp

    return jnp.asarray(np.arange(batch) < n_chunk)


@functools.lru_cache(maxsize=None)
def _pair_fetch():
    """One program stacking two scalars: the previous batch's total bits
    and the current batch's max n_sym leave the device in ONE transfer."""
    import jax
    import jax.numpy as jnp

    return jax.jit(
        lambda a, b: jnp.stack([a.astype(jnp.int32), b.astype(jnp.int32)])
    )


def _fetch_cat_words(cat, total: int) -> np.ndarray:
    nw = (total + 31) // 32
    padded = _SLICE_GRANULE
    while padded < nw:
        padded *= 2
    padded = min(padded, cat.shape[0])
    return np.asarray(_word_slicer_1d(padded)(cat))[:nw]


def _encode_batches_concat(blocks: list[Rle1Block], capacity: int, batch: int):
    """Like _encode_batches but the batch's block bitstreams concatenate ON
    DEVICE (ops/emit.concat_block_words): yields per-BATCH
    (bytes_be, nbits) — one scalar fetch + one sliced words fetch per
    batch, zero host bit work (default ON; BZ2TPU_DEVICE_STITCH=0
    restores the per-block host stitch).

    With the compact-width pipeline (ops/pipeline compact-width note) the
    batch's max n_sym must reach the host BEFORE the emit+huff+pack
    dispatch; fetching it separately would cost one extra device->host
    round trip per batch. Here it rides the scalar fetch the stitch
    already pays: one (2,) fetch carries the PREVIOUS batch's total bits
    and the CURRENT batch's max n_sym, keeping the per-batch round-trip
    count identical to the full-width driver.
    """
    import jax.numpy as jnp

    from bz2tpu.ops import pipeline as _pipe
    from bz2tpu.ops.emit import concat_block_words
    from bz2tpu.utils.jaxenv import setup_compilation_cache

    setup_compilation_cache()
    n_blocks = len(blocks)
    bases = list(range(0, n_blocks, batch))
    compact = _pipe._COMPACT_PACK and _pipe._COMPACT_EMIT and not _pipe._BATCH_MTF

    def load(base):
        chunk = blocks[base : base + batch]
        buf = np.zeros((batch, capacity), dtype=np.uint8)
        ns = np.ones(batch, dtype=np.int32)
        crcs = np.zeros(batch, dtype=np.uint32)
        for i, blk in enumerate(chunk):
            buf[i, : blk.data.size] = blk.data
            ns[i] = blk.data.size
            crcs[i] = blk.crc
        return len(chunk), jnp.asarray(buf), jnp.asarray(ns), jnp.asarray(crcs)

    def concat(out, n_chunk):
        bits = out["meta"][:, 5]
        # Padding rows must contribute 0 bits to the concatenation.
        live = jnp.arange(batch) < n_chunk
        return concat_block_words(out["words"], jnp.where(live, bits, 0))

    if not compact:
        from bz2tpu.ops.pipeline import encode_blocks_staged

        def dispatch(base):
            n_chunk, buf, ns, crcs = load(base)
            return concat(encode_blocks_staged(buf, ns, crcs), n_chunk)

        pending = dispatch(bases[0]) if bases else None
        for bi in range(len(bases)):
            cat, total = pending
            # Launch the next batch before fetching this one (overlap
            # compute with the device->host transfer).
            pending = dispatch(bases[bi + 1]) if bi + 1 < len(bases) else None
            total = int(total)
            yield _fetch_cat_words(cat, total).astype(">u4").view(np.uint8), total
        return

    def stage12(base):
        n_chunk, buf, ns, crcs = load(base)
        last, orig_ptr = _pipe.bwt_stage(buf, ns)
        plan = _pipe.mtf_plan_stage(last, ns)
        return n_chunk, plan, orig_ptr, crcs, jnp.max(plan["n_sym"])

    pend12 = stage12(bases[0]) if bases else None
    prev = None  # (cat_dev, total_dev)
    for bi in range(len(bases)):
        n_chunk, plan, orig_ptr, crcs, nsym_max = pend12
        # Enqueue the tiny pair program BEFORE the next batch's heavy
        # stages: the device executes in dispatch order, so a later spot
        # in the queue would stall this batch's width decision behind the
        # whole next BWT+MTF.
        pair_dev = _pair_fetch()(prev[1], nsym_max) if prev is not None else None
        pend12 = stage12(bases[bi + 1]) if bi + 1 < len(bases) else None
        if pair_dev is None:
            mx = int(nsym_max)
        else:
            pair = np.asarray(pair_dev)
            total_prev, mx = int(pair[0]), int(pair[1])
        width = _pipe.huff_width(capacity, mx)
        if _pipe._FUSED_PACK:
            cat, total, _ = _pipe.emit_huff_pack_concat_stage(
                plan, orig_ptr, crcs, _live_mask(batch, n_chunk), width=width
            )
            cur = (cat, total)
        else:
            out = _pipe.emit_huff_pack_stage(plan, orig_ptr, crcs, width=width)
            cur = concat(out, n_chunk)
        if prev is not None:
            # Previous batch's words transfer overlaps this batch's
            # emit+huff+pack execution.
            yield _fetch_cat_words(prev[0], total_prev).astype(">u4").view(
                np.uint8
            ), total_prev
        prev = cur
    if prev is not None:
        total = int(prev[1])
        yield _fetch_cat_words(prev[0], total).astype(">u4").view(np.uint8), total


@functools.lru_cache(maxsize=None)
def _word_slicer_1d(nwords: int):
    import jax

    return jax.jit(lambda w: jax.lax.dynamic_slice_in_dim(w, 0, nwords, axis=0))


def compress(
    data: bytes | np.ndarray,
    level: int = C.DEFAULT_LEVEL,
    parallel: int | None = None,
) -> bytes:
    """Compress `data` into a standard .bz2 stream via the device pipeline."""
    arr = (
        np.frombuffer(bytes(data), dtype=np.uint8)
        if not isinstance(data, np.ndarray)
        else np.ascontiguousarray(data, dtype=np.uint8)
    )
    if not C.MIN_LEVEL <= level <= C.MAX_LEVEL:
        raise ValueError(f"block size level must be 1..9, got {level}")
    blocks = split_blocks(arr, level)
    capacity = C.BLOCK_SIZE_BASE * level
    batch = parallel or DEFAULT_BATCH
    if len(blocks) < batch:
        # Quantize small streams to power-of-two batch widths: every
        # distinct width is its own XLA compile, so {1,2,4,8} bounds the
        # program count (utils.jaxenv.prime pre-compiles every width in
        # the set). An EXPLICIT
        # --parallel is a device-memory cap, so never quantize past it.
        b = 1
        while b < max(len(blocks), 1):
            b <<= 1
        batch = min(b, parallel) if parallel else b

    parts: list[tuple[np.ndarray, int]] = []
    head = BitWriter()
    head.write_bits(24, int.from_bytes(C.STREAM_MAGIC, "big"))
    head.write_bits(8, ord("0") + level)
    parts.append((np.frombuffer(head.getvalue(), dtype=np.uint8), head.bit_length))

    if _DEVICE_STITCH:
        for row, nbits in _encode_batches_concat(blocks, capacity, batch):
            parts.append((row, nbits))
    else:
        for out in _encode_batches(blocks, capacity, batch):
            # The device words ARE the complete block (header + symbol data).
            parts.append((out["words"].astype(">u4").view(np.uint8), int(out["total_bits"])))

    tail = BitWriter()
    tail.write_bits(48, C.STREAM_END_MARKER)
    tail.write_bits(32, stream_crc([b.crc for b in blocks]))
    parts.append((np.frombuffer(tail.getvalue(), dtype=np.uint8), tail.bit_length))

    packed, _ = concat_bitstreams(parts)
    return packed.tobytes()
