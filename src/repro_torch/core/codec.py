"""Tensor / state-dict encode-decode on top of the CABAC engine (the port's
copy of ``repro.core.codec``).

Levels are host numpy int64 arrays, as in the reference; everything a
decode reconstructs (raw records, dequantized tensors) is a CPU torch
tensor, so bf16 needs no ``ml_dtypes``: it is carried as torch bf16 and
written as its bit pattern.  The bytes of every record equal the
reference's, the temporal-context delta ("P-frame") records included.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..arrays import cast_host, tensor_from_bytes, torch_dtype
from . import binarization as B
from . import cabac_vec
from .cabac import RangeDecoder, RangeEncoder, temporal_classes_u8
from .container import (ENC_CABAC, ENC_CABAC_DELTA, ENC_CABAC_V3, ENC_HUFF,
                        ENC_Q8, ENC_RAW, ContainerReader, ContainerWriter)

DEFAULT_CHUNK = 1 << 16


@dataclass
class DecodeOptions:
    """How CABAC records are entropy-decoded.

    ``backend`` picks the lane engine (``auto``/``c``/``numpy`` from
    :mod:`repro_torch.core.cabac_vec`) or ``scalar`` for the serial
    per-chunk loop, which also decodes lane batches the vector engines
    refuse (levels beyond ``cabac_vec.MAX_ABS_LEVEL``); ``lanes`` is how
    many chunk streams one batch advances.
    """

    lanes: int = 64
    backend: str = "auto"


@dataclass
class QuantizedTensor:
    """A tensor on the equidistant grid q = step * level."""

    levels: np.ndarray            # int64, original shape
    step: float
    dtype: str = "float32"        # reconstruction dtype

    def dequantize(self) -> torch.Tensor:
        """The reference's f64 product rounded to ``dtype``, on the CPU."""
        return cast_host(self.levels.astype(np.float64) * self.step,
                         self.dtype)

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.levels.shape)


@dataclass
class Q8Tensor:
    """int8 levels with per-channel scales q = scale[..., c] * level;
    stacked (L, ..., out) tensors carry an (L, out) scale."""

    levels: np.ndarray            # int8, original shape
    scale: np.ndarray             # float32, (out,) or (L, out)
    dtype: str = "float32"        # reconstruction dtype

    def dequantize(self) -> torch.Tensor:
        s = np.asarray(self.scale, dtype=np.float32)
        lv = self.levels
        if lv.ndim >= 3 and s.ndim == 2:
            s = s.reshape(s.shape[0], *([1] * (lv.ndim - 2)), s.shape[-1])
        return cast_host(lv.astype(np.float32) * s, self.dtype)

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.levels.shape)


def encode_level_chunks(levels: np.ndarray, num_gr: int = B.DEFAULT_NUM_GR,
                        chunk_size: int = DEFAULT_CHUNK) -> list[bytes]:
    """Encode a flat level array as independently-decodable chunks."""
    flat = np.asarray(levels).ravel()
    chunks = []
    for s in range(0, max(flat.size, 1), chunk_size):
        blk = flat[s:s + chunk_size]
        enc = RangeEncoder(B.make_contexts(num_gr))
        B.encode_levels(enc, blk, num_gr)
        chunks.append(enc.finish())
    return chunks


def decode_level_chunks(chunk_payloads: list[bytes], count: int,
                        num_gr: int = B.DEFAULT_NUM_GR,
                        chunk_size: int = DEFAULT_CHUNK) -> np.ndarray:
    out = np.empty(count, dtype=np.int64)
    pos = 0
    for payload in chunk_payloads:
        n = min(chunk_size, count - pos)
        dec = RangeDecoder(payload, B.make_contexts(num_gr))
        out[pos:pos + n] = B.decode_levels(dec, n, num_gr)
        pos += n
    assert pos == count, f"decoded {pos} of {count} values"
    return out


def encode_level_chunks_batched(levels: np.ndarray,
                                num_gr: int = B.DEFAULT_NUM_GR,
                                chunk_size: int = DEFAULT_CHUNK,
                                backend: str = "auto"
                                ) -> tuple[list[bytes], list[int]]:
    """Chunk a flat level array and encode all chunks as one lane batch.
    Returns ``(payloads, counts)`` (the v3 lane metadata); byte-identical
    to :func:`encode_level_chunks` per chunk."""
    flat = np.asarray(levels).ravel()
    blocks = [flat[s:s + chunk_size]
              for s in range(0, max(flat.size, 1), chunk_size)]
    payloads = cabac_vec.encode_lanes(blocks, num_gr, backend=backend)
    return payloads, [b.size for b in blocks]


def _decode_chunks_scalar(chunk_payloads, counts, num_gr):
    return [B.decode_levels(RangeDecoder(bytes(p), B.make_contexts(num_gr)),
                            n, num_gr)
            for p, n in zip(chunk_payloads, counts)]


def decode_level_chunks_batched(chunk_payloads: list[bytes],
                                chunk_counts: list[int],
                                num_gr: int = B.DEFAULT_NUM_GR,
                                opts: DecodeOptions | None = None
                                ) -> np.ndarray:
    """Decode independently-coded chunks as lane batches (or the scalar
    residual path) and concatenate the levels in chunk order."""
    opts = opts or DecodeOptions()
    if not chunk_payloads:
        return np.empty(0, dtype=np.int64)
    if opts.backend == "scalar":
        parts = _decode_chunks_scalar(chunk_payloads, chunk_counts, num_gr)
    else:
        parts = []
        lanes = max(int(opts.lanes), 1)
        for s in range(0, len(chunk_payloads), lanes):
            batch = [bytes(p) for p in chunk_payloads[s:s + lanes]]
            counts = chunk_counts[s:s + lanes]
            try:
                parts.extend(cabac_vec.decode_lanes(
                    batch, counts, num_gr, backend=opts.backend))
            except OverflowError:
                # a stream in this batch carries levels beyond the lane
                # engines' int64-safe range (only the scalar coder writes
                # those)
                parts.extend(_decode_chunks_scalar(batch, counts, num_gr))
    out = (np.concatenate(parts) if parts else np.empty(0, dtype=np.int64))
    total = int(sum(chunk_counts))
    assert out.size == total, f"decoded {out.size} of {total} values"
    return out


# ---------------------------------------------------------------------------
# Temporal-context delta ("P-frame") chunk coding
# ---------------------------------------------------------------------------

@dataclass
class DeltaTensor:
    """An integer-level residual against a base frame's levels.

    ``resid = new_levels - base_levels`` elementwise on the *same*
    quantization grid (the base frame's ``step``), so base + every chained
    residual reconstructs the direct encoding bit for bit.  ``base`` rides
    along because the entropy coder conditions each residual's context
    bank on the co-located base level (``cabac.temporal_classes``).
    """

    resid: np.ndarray             # int64, original shape
    base: np.ndarray              # int64, same shape (context source)
    step: float
    dtype: str = "float32"        # reconstruction dtype

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.resid.shape)

    def new_levels(self) -> np.ndarray:
        return (self.base.astype(np.int64, copy=False)
                + self.resid.astype(np.int64, copy=False))


def encode_delta_chunks_batched(resid: np.ndarray, base_levels: np.ndarray,
                                num_gr: int = B.DEFAULT_NUM_GR,
                                chunk_size: int = DEFAULT_CHUNK,
                                backend: str = "auto"
                                ) -> tuple[list[bytes], list[int]]:
    """Chunk a flat residual array and temporal-context-encode all chunks
    as one lane batch; classes come from the co-located ``base_levels``.
    Returns ``(payloads, counts)`` like the v3 encoder."""
    flat = np.asarray(resid).ravel()
    cls = temporal_classes_u8(base_levels)
    if cls.size != flat.size:
        raise ValueError(
            f"delta of {flat.size} values against a base of {cls.size}")
    blocks = [flat[s:s + chunk_size]
              for s in range(0, max(flat.size, 1), chunk_size)]
    cblocks = [cls[s:s + chunk_size]
               for s in range(0, max(flat.size, 1), chunk_size)]
    payloads = cabac_vec.encode_lanes_tc(blocks, cblocks, num_gr,
                                         backend=backend)
    return payloads, [b.size for b in blocks]


def _decode_chunks_scalar_tc(chunk_payloads, cls_blocks, num_gr):
    return [B.decode_levels_tc(
                RangeDecoder(bytes(p), B.make_contexts_tc(num_gr)), c, num_gr)
            for p, c in zip(chunk_payloads, cls_blocks)]


def decode_delta_chunks_batched(chunk_payloads: list[bytes],
                                chunk_counts: list[int],
                                base_levels: np.ndarray,
                                num_gr: int = B.DEFAULT_NUM_GR,
                                opts: DecodeOptions | None = None
                                ) -> np.ndarray:
    """Decode temporal-context residual chunks; ``base_levels`` supplies
    the per-element context classes and must cover ``sum(chunk_counts)``
    values.  Returns the flat residual (not base + resid)."""
    opts = opts or DecodeOptions()
    cls = temporal_classes_u8(base_levels)
    total = int(sum(chunk_counts))
    if cls.size != total:
        raise ValueError(
            f"delta record of {total} values against a base of {cls.size}")
    if not chunk_payloads:
        return np.empty(0, dtype=np.int64)
    offs = np.zeros(len(chunk_counts) + 1, dtype=np.int64)
    np.cumsum(chunk_counts, out=offs[1:])
    cls_blocks = [cls[offs[i]:offs[i + 1]]
                  for i in range(len(chunk_counts))]
    if opts.backend == "scalar":
        parts = _decode_chunks_scalar_tc(chunk_payloads, cls_blocks, num_gr)
    else:
        parts = []
        lanes = max(int(opts.lanes), 1)
        for s in range(0, len(chunk_payloads), lanes):
            batch = [bytes(p) for p in chunk_payloads[s:s + lanes]]
            cbatch = cls_blocks[s:s + lanes]
            try:
                parts.extend(cabac_vec.decode_lanes_tc(
                    batch, cbatch, num_gr, backend=opts.backend))
            except OverflowError:
                parts.extend(_decode_chunks_scalar_tc(batch, cbatch, num_gr))
    out = (np.concatenate(parts) if parts else np.empty(0, dtype=np.int64))
    assert out.size == total, f"decoded {out.size} of {total} values"
    return out


def decode_delta_record(hdr, payload, base_levels: np.ndarray,
                        dequantize: bool = False,
                        opts: DecodeOptions | None = None):
    """Decode one ENC_CABAC_DELTA record next to its base frame's levels
    and return the reconstructed *new-frame* tensor (base + residual) —
    as a :class:`QuantizedTensor` by default, so chained deltas can feed
    the next link's base; a CPU tensor with ``dequantize=True``."""
    if hdr.encoding != ENC_CABAC_DELTA:
        raise ValueError(
            f"{hdr.name}: not a delta record (encoding {hdr.encoding})")
    base = np.asarray(base_levels, dtype=np.int64)
    count = _count(hdr)
    if base.size != count:
        raise ValueError(
            f"{hdr.name}: delta record of shape {hdr.shape} against a "
            f"base of {base.size} values")
    counts = _v3_chunk_counts(hdr)
    chunks = _split_chunks(payload, hdr.chunk_lens)
    resid = decode_delta_chunks_batched(chunks, counts, base, hdr.num_gr,
                                        opts)
    levels = (base.ravel() + resid).reshape(hdr.shape)
    qt = QuantizedTensor(levels=levels, step=hdr.step, dtype=hdr.dtype)
    return qt.dequantize() if dequantize else qt


def encode_state_dict(entries: dict, num_gr: int = B.DEFAULT_NUM_GR,
                      chunk_size: int = DEFAULT_CHUNK) -> bytes:
    """Quantized tensors are CABAC-coded (v1 records); raw tensors (torch
    or numpy) pass through verbatim."""
    w = ContainerWriter()
    for name, entry in entries.items():
        if isinstance(entry, QuantizedTensor):
            chunks = encode_level_chunks(entry.levels, num_gr, chunk_size)
            w.add_cabac(name, entry.dtype, entry.shape, entry.step,
                        num_gr, chunk_size, chunks)
        elif isinstance(entry, Q8Tensor):
            w.add_q8(name, entry.dtype, entry.levels, entry.scale)
        else:
            w.add_raw(name, entry)
    return w.tobytes()


def _split_chunks(payload, chunk_lens):
    offs, chunks = 0, []
    for ln in chunk_lens:
        chunks.append(payload[offs:offs + ln])
        offs += ln
    return chunks


def _count(hdr) -> int:
    return int(np.prod(hdr.shape)) if hdr.shape else 1


def _v3_chunk_counts(hdr) -> list[int]:
    """Validated per-chunk lane metadata of an ENC_CABAC_V3 record."""
    count = _count(hdr)
    counts = [int(c) for c in hdr.chunk_counts]
    if sum(counts) != hdr.total_count or hdr.total_count != count:
        raise ValueError(
            f"{hdr.name}: lane metadata disagrees — chunk counts sum to "
            f"{sum(counts)}, header total {hdr.total_count}, shape wants "
            f"{count}")
    return counts


def decode_record(hdr, payload, dequantize: bool = True,
                  opts: DecodeOptions | None = None):
    """Decode one container record (header + payload): a CPU tensor, or
    with ``dequantize=False`` a :class:`QuantizedTensor` /
    :class:`Q8Tensor` for the records that carry levels."""
    if hdr.encoding == ENC_RAW:
        return tensor_from_bytes(payload, hdr.dtype, hdr.shape)
    if hdr.encoding == ENC_CABAC:
        chunks = _split_chunks(payload, hdr.chunk_lens)
        levels = decode_level_chunks(
            chunks, _count(hdr), hdr.num_gr,
            hdr.chunk_size).reshape(hdr.shape)
        qt = QuantizedTensor(levels=levels, step=hdr.step, dtype=hdr.dtype)
        return qt.dequantize() if dequantize else qt
    if hdr.encoding == ENC_CABAC_V3:
        counts = _v3_chunk_counts(hdr)
        chunks = _split_chunks(payload, hdr.chunk_lens)
        # all chunks of the tensor go through the lane engine as one batch
        levels = decode_level_chunks_batched(
            chunks, counts, hdr.num_gr, opts).reshape(hdr.shape)
        qt = QuantizedTensor(levels=levels, step=hdr.step, dtype=hdr.dtype)
        return qt.dequantize() if dequantize else qt
    if hdr.encoding == ENC_HUFF:
        from .huffman import unpack_payload
        levels = unpack_payload(bytes(payload),
                                _count(hdr)).reshape(hdr.shape)
        qt = QuantizedTensor(levels=levels, step=hdr.step, dtype=hdr.dtype)
        return qt.dequantize() if dequantize else qt
    if hdr.encoding == ENC_CABAC_DELTA:
        raise ValueError(
            f"{hdr.name}: ENC_CABAC_DELTA records are residuals against a "
            "base frame and cannot be decoded standalone — resolve the "
            "delta chain (repro_torch.checkpoint.delta.resolve_chain) and "
            "decode through decode_delta_record with the base frame's "
            "levels")
    if hdr.encoding == ENC_Q8:
        sc_count = int(np.prod(hdr.scale_shape)) if hdr.scale_shape else 1
        scale = np.frombuffer(payload, dtype="<f4",
                              count=sc_count).reshape(
                                  hdr.scale_shape).copy()
        levels = np.frombuffer(payload, dtype=np.int8,
                               offset=4 * sc_count).reshape(
                                   hdr.shape).copy()
        q8 = Q8Tensor(levels=levels, scale=scale, dtype=hdr.dtype)
        return q8.dequantize() if dequantize else q8
    raise ValueError(f"unknown encoding {hdr.encoding}")


def iter_decode_state_dict(data: bytes, dequantize: bool = True,
                           opts: DecodeOptions | None = None):
    """Per-tensor streaming decode: yields ``(name, tensor)`` record by
    record, so a consumer that moves each tensor on before pulling the
    next keeps the decoded host peak at one tensor."""
    for hdr, payload in ContainerReader(data):
        yield hdr.name, decode_record(hdr, payload, dequantize, opts)


def decode_state_dict(data: bytes, dequantize: bool = True,
                      opts: DecodeOptions | None = None) -> dict:
    return dict(iter_decode_state_dict(data, dequantize, opts))


def decode_state_dict_batched(data: bytes, dequantize: bool = True,
                              opts: DecodeOptions | None = None) -> dict:
    """Whole-container lane scheduling: every CABAC chunk of every record
    joins one decode batch per ``num_gr`` (the cold-start path; decoded
    host memory is model-bound)."""
    opts = opts or DecodeOptions()
    records = list(ContainerReader(data))
    # num_gr -> (chunks, counts, [(record idx, first chunk, nchunks)])
    groups: dict[int, tuple[list, list, list]] = {}
    for i, (hdr, payload) in enumerate(records):
        if hdr.encoding not in (ENC_CABAC, ENC_CABAC_V3):
            continue
        chunks = _split_chunks(payload, hdr.chunk_lens)
        if hdr.encoding == ENC_CABAC_V3:
            counts = _v3_chunk_counts(hdr)
        else:
            total = _count(hdr)
            csz = hdr.chunk_size or total or 1
            counts = [min(csz, total - s)
                      for s in range(0, max(total, 1), csz)]
        gch, gct, gspan = groups.setdefault(hdr.num_gr, ([], [], []))
        gspan.append((i, len(gch), len(chunks)))
        gch.extend(chunks)
        gct.extend(counts)
    decoded: dict[int, QuantizedTensor] = {}
    for num_gr, (gch, gct, gspan) in groups.items():
        flat = decode_level_chunks_batched(gch, gct, num_gr, opts)
        offsets = np.zeros(len(gct) + 1, dtype=np.int64)
        np.cumsum(gct, out=offsets[1:])
        for i, first, nch in gspan:
            hdr = records[i][0]
            levels = flat[offsets[first]:offsets[first + nch]].reshape(
                hdr.shape)
            decoded[i] = QuantizedTensor(levels=levels, step=hdr.step,
                                         dtype=hdr.dtype)
    out: dict = {}
    for i, (hdr, payload) in enumerate(records):
        if i in decoded:
            qt = decoded[i]
            out[hdr.name] = qt.dequantize() if dequantize else qt
        else:
            out[hdr.name] = decode_record(hdr, payload, dequantize, opts)
    return out


def compressed_size_report(entries: dict, blob: bytes) -> dict[str, float]:
    """Bits/param + ratio vs. the original-dtype footprint (bf16 state
    dicts count 2 bytes/param)."""
    n_params = 0
    orig_bytes = 0
    for e in entries.values():
        if hasattr(e, "levels"):           # QuantizedTensor | Q8Tensor
            n = int(np.prod(e.levels.shape))
            nb = n * torch_dtype(e.dtype).itemsize
        elif isinstance(e, torch.Tensor):
            n, nb = e.numel(), e.numel() * e.element_size()
        else:
            arr = np.asarray(e)
            n, nb = arr.size, arr.nbytes
        n_params += n
        orig_bytes += nb
    return {
        "params": float(n_params),
        "orig_mb": orig_bytes / 2**20,
        "compressed_mb": len(blob) / 2**20,
        "ratio_pct": 100.0 * len(blob) / max(orig_bytes, 1),
        "bits_per_param": 8.0 * len(blob) / max(n_params, 1),
    }
