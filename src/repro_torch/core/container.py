"""Serialized bitstream container for DeepCABAC-coded pytrees (the port's
copy of ``repro.core.container``: it writes and reads versions 1-4 byte for
byte as the reference does).

Layout (little-endian):

    magic 'DCBC' | version u16 | num_records u32
    per record:
      name: u16 len + utf8
      encoding: u8         (0 = raw bytes, 1 = cabac levels,
                            2 = huffman levels, 3 = int8 levels + scales,
                            4 = cabac levels + lane metadata,
                            5 = temporal-context cabac level residuals)
      dtype str: u8 len + ascii   (original array dtype)
      ndim u8, dims u32[ndim]
      if encoding == 1:
        step f64 | num_gr u8 | chunk_size u32 | num_chunks u32
        chunk_byte_lens u32[num_chunks]
      if encoding == 2:
        step f64             (payload: self-describing table + bitstream)
      if encoding == 3:
        scale_ndim u8, scale_dims u32[scale_ndim]
                             (payload: f32 scales then int8 levels)
      if encoding == 4 or encoding == 5:
        step f64 | num_gr u8 | chunk_size u32 | total_count u64
        num_chunks u32 | chunk_byte_lens u32[num_chunks]
        chunk_counts u32[num_chunks]
      payload_len u64 | payload

Version 1 containers hold only raw/cabac records; version 2 adds the
huffman and q8 encodings; version 3 adds the lane-scheduled cabac record
(encoding 4), whose bitstream chunks are byte-identical to encoding 1 —
only the header grows per-chunk value counts and the total count, so a
reader can schedule all chunks of a tensor into one lane-parallel decode
batch (``cabac_vec``).  Version 4 adds the temporal-context delta record
(encoding 5, residuals against a base frame named outside the container).
Its levels are decodable only next to the base frame's (each value's
context bank is selected by the class of its co-located base level).  The
writer emits the lowest version that covers the records present.  Chunks
are independently decodable (fresh context state per chunk).  Records are
independently addressable: :meth:`ContainerWriter.record_spans` gives
each record's (offset, length) and :func:`read_record_at` parses one
record from a byte-range read (the sharded-checkpoint manifest's
contract).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

from ..arrays import raw_bytes

MAGIC = b"DCBC"
VERSION = 1
VERSION_V2 = 2
VERSION_V3 = 3
VERSION_V4 = 4
SUPPORTED_VERSIONS = (VERSION, VERSION_V2, VERSION_V3, VERSION_V4)
HEADER_LEN = 10          # magic + version u16 + num_records u32
ENC_RAW = 0
ENC_CABAC = 1
ENC_HUFF = 2
ENC_Q8 = 3
ENC_CABAC_V3 = 4
ENC_CABAC_DELTA = 5


@dataclass
class RecordHeader:
    name: str
    encoding: int
    dtype: str
    shape: tuple[int, ...]
    step: float = 0.0
    num_gr: int = 0
    chunk_size: int = 0
    chunk_lens: tuple[int, ...] = ()
    scale_shape: tuple[int, ...] = ()
    chunk_counts: tuple[int, ...] = ()   # v3 lane metadata
    total_count: int = 0                 # v3: sum(chunk_counts), validated


def _pack_str(s: str, lenfmt: str) -> bytes:
    b = s.encode("utf-8")
    return struct.pack(lenfmt, len(b)) + b


class ContainerWriter:
    def __init__(self):
        # each record as (header + payload length, payload): the payload is
        # copied once, when the container is serialized
        self._records: list[tuple[bytes, bytes]] = []
        self._needs_v2 = False
        self._needs_v3 = False
        self._needs_v4 = False

    def _add(self, hdr: bytes, payload: bytes) -> None:
        self._records.append((hdr + struct.pack("<Q", len(payload)),
                              payload))

    def add_raw(self, name: str, arr) -> None:
        """A tensor stored verbatim: a torch tensor (any device; bf16 as
        its bit pattern) or a numpy array."""
        payload, dtype = raw_bytes(arr)
        shape = tuple(arr.shape)
        hdr = (_pack_str(name, "<H") + struct.pack("<B", ENC_RAW)
               + _pack_str(dtype, "<B")
               + struct.pack("<B", len(shape))
               + struct.pack(f"<{len(shape)}I", *shape))
        self._add(hdr, payload)

    def add_cabac(self, name: str, dtype: str, shape: tuple[int, ...],
                  step: float, num_gr: int, chunk_size: int,
                  chunk_payloads: list[bytes]) -> None:
        payload = b"".join(chunk_payloads)
        ndim = len(shape)
        hdr = (_pack_str(name, "<H") + struct.pack("<B", ENC_CABAC)
               + _pack_str(dtype, "<B")
               + struct.pack("<B", ndim) + struct.pack(f"<{ndim}I", *shape)
               + struct.pack("<dBII", step, num_gr, chunk_size,
                             len(chunk_payloads))
               + struct.pack(f"<{len(chunk_payloads)}I",
                             *[len(c) for c in chunk_payloads]))
        self._add(hdr, payload)

    def add_cabac_v3(self, name: str, dtype: str, shape: tuple[int, ...],
                     step: float, num_gr: int, chunk_size: int,
                     chunk_payloads: list[bytes],
                     chunk_counts: list[int]) -> None:
        """CABAC chunks with lane metadata: per-chunk value counts and the
        total count travel in the header, so a reader can schedule every
        chunk straight into a vectorized decode batch.  The chunk
        bitstreams themselves are byte-identical to :meth:`add_cabac`."""
        if len(chunk_counts) != len(chunk_payloads):
            raise ValueError(
                f"{len(chunk_counts)} chunk counts for "
                f"{len(chunk_payloads)} chunk payloads")
        total = sum(int(c) for c in chunk_counts)
        payload = b"".join(chunk_payloads)
        ndim = len(shape)
        nch = len(chunk_payloads)
        hdr = (_pack_str(name, "<H") + struct.pack("<B", ENC_CABAC_V3)
               + _pack_str(dtype, "<B")
               + struct.pack("<B", ndim) + struct.pack(f"<{ndim}I", *shape)
               + struct.pack("<dBIQI", step, num_gr, chunk_size, total, nch)
               + struct.pack(f"<{nch}I", *[len(c) for c in chunk_payloads])
               + struct.pack(f"<{nch}I", *chunk_counts))
        self._add(hdr, payload)
        self._needs_v3 = True

    def add_cabac_delta(self, name: str, dtype: str, shape: tuple[int, ...],
                        step: float, num_gr: int, chunk_size: int,
                        chunk_payloads: list[bytes],
                        chunk_counts: list[int]) -> None:
        """Temporal-context-coded level *residuals* against a base frame.

        Header layout is identical to :meth:`add_cabac_v3`; the chunk
        bitstreams differ (temporal-context banks, cabac_vec
        ``encode_lanes_tc``) and can only be decoded next to the base
        frame's levels — the chain linkage lives in the delta manifest
        (``repro.checkpoint.delta``), not in the container."""
        if len(chunk_counts) != len(chunk_payloads):
            raise ValueError(
                f"{len(chunk_counts)} chunk counts for "
                f"{len(chunk_payloads)} chunk payloads")
        total = sum(int(c) for c in chunk_counts)
        payload = b"".join(chunk_payloads)
        ndim = len(shape)
        nch = len(chunk_payloads)
        hdr = (_pack_str(name, "<H") + struct.pack("<B", ENC_CABAC_DELTA)
               + _pack_str(dtype, "<B")
               + struct.pack("<B", ndim) + struct.pack(f"<{ndim}I", *shape)
               + struct.pack("<dBIQI", step, num_gr, chunk_size, total, nch)
               + struct.pack(f"<{nch}I", *[len(c) for c in chunk_payloads])
               + struct.pack(f"<{nch}I", *chunk_counts))
        self._add(hdr, payload)
        self._needs_v4 = True

    def add_huffman(self, name: str, dtype: str, shape: tuple[int, ...],
                    step: float, payload: bytes) -> None:
        """Canonical-Huffman-coded levels; the payload carries its own
        two-part code table (symbols + lengths) ahead of the bitstream."""
        ndim = len(shape)
        hdr = (_pack_str(name, "<H") + struct.pack("<B", ENC_HUFF)
               + _pack_str(dtype, "<B")
               + struct.pack("<B", ndim) + struct.pack(f"<{ndim}I", *shape)
               + struct.pack("<d", step))
        self._add(hdr, payload)
        self._needs_v2 = True

    def add_q8(self, name: str, dtype: str, levels: np.ndarray,
               scale: np.ndarray) -> None:
        """Raw int8 levels with per-channel f32 scales (fixed-point serving)."""
        levels = np.ascontiguousarray(levels)
        if levels.dtype != np.int8:
            raise TypeError(f"q8 levels must be int8, got {levels.dtype}")
        scale = np.ascontiguousarray(scale, dtype="<f4")   # explicit LE,
        # matching the reader and the container's documented layout
        hdr = (_pack_str(name, "<H") + struct.pack("<B", ENC_Q8)
               + _pack_str(dtype, "<B")
               + struct.pack("<B", levels.ndim)
               + struct.pack(f"<{levels.ndim}I", *levels.shape)
               + struct.pack("<B", scale.ndim)
               + struct.pack(f"<{scale.ndim}I", *scale.shape))
        payload = scale.tobytes() + levels.tobytes()
        self._add(hdr, payload)
        self._needs_v2 = True

    def tobytes(self) -> bytes:
        version = (VERSION_V4 if self._needs_v4
                   else VERSION_V3 if self._needs_v3
                   else VERSION_V2 if self._needs_v2 else VERSION)
        head = MAGIC + struct.pack("<HI", version, len(self._records))
        return b"".join([head, *(part for rec in self._records
                                 for part in rec)])

    def record_spans(self) -> list[tuple[int, int]]:
        """(byte offset, byte length) of each record in the container
        :meth:`tobytes` serializes, in add order.  Offsets include the
        container header, so a reader can pread one record straight out
        of the file and hand it to :func:`read_record_at` — the
        sharded-checkpoint manifest persists exactly these spans."""
        spans, off = [], HEADER_LEN
        for hdr, payload in self._records:
            spans.append((off, len(hdr) + len(payload)))
            off += len(hdr) + len(payload)
        return spans


def _parse_record(data, view, off: int, label: str
                  ) -> tuple[RecordHeader, memoryview, int]:
    """Parse one record at ``off``; returns (header, payload, next offset).

    ``label`` names the record in truncation errors ("record 3 of 9" for
    the whole-container iterator, "byte-range record" for pread paths).
    The payload is a zero-copy memoryview slice of ``view``.
    """
    try:
        (nlen,) = struct.unpack_from("<H", data, off); off += 2
        name = bytes(data[off:off + nlen]).decode("utf-8"); off += nlen
        (enc,) = struct.unpack_from("<B", data, off); off += 1
        (dlen,) = struct.unpack_from("<B", data, off); off += 1
        dtype = bytes(data[off:off + dlen]).decode("ascii"); off += dlen
        (ndim,) = struct.unpack_from("<B", data, off); off += 1
        shape = struct.unpack_from(f"<{ndim}I", data, off)
        off += 4 * ndim
        step, num_gr, chunk_size, nchunks = 0.0, 0, 0, 0
        total = 0
        chunk_lens: tuple[int, ...] = ()
        chunk_counts: tuple[int, ...] = ()
        scale_shape: tuple[int, ...] = ()
        if enc == ENC_CABAC:
            step, num_gr, chunk_size, nchunks = struct.unpack_from(
                "<dBII", data, off)
            off += 17
            chunk_lens = struct.unpack_from(f"<{nchunks}I", data, off)
            off += 4 * nchunks
        elif enc in (ENC_CABAC_V3, ENC_CABAC_DELTA):
            step, num_gr, chunk_size, total, nchunks = \
                struct.unpack_from("<dBIQI", data, off)
            off += 25
            chunk_lens = struct.unpack_from(f"<{nchunks}I", data, off)
            off += 4 * nchunks
            chunk_counts = struct.unpack_from(f"<{nchunks}I", data, off)
            off += 4 * nchunks
        elif enc == ENC_HUFF:
            (step,) = struct.unpack_from("<d", data, off)
            off += 8
        elif enc == ENC_Q8:
            (sndim,) = struct.unpack_from("<B", data, off); off += 1
            scale_shape = struct.unpack_from(f"<{sndim}I", data, off)
            off += 4 * sndim
        (plen,) = struct.unpack_from("<Q", data, off); off += 8
    except (struct.error, UnicodeDecodeError) as e:
        # UnicodeDecodeError: a mis-aligned byte-range read lands the
        # name/dtype fields on arbitrary bytes — same failure class as a
        # short read, same descriptive error
        raise ValueError(
            f"truncated DCBC record header ({label})") from e
    if off + plen > len(data):
        raise ValueError(
            f"truncated DCBC record payload: {label} ({name!r}) wants "
            f"{plen} bytes, {len(data) - off} remain")
    payload = view[off:off + plen]
    hdr = RecordHeader(name, enc, dtype, tuple(shape), step, num_gr,
                       chunk_size, chunk_lens, tuple(scale_shape),
                       chunk_counts, total)
    return hdr, payload, off + plen


def read_record_at(data, offset: int = 0
                   ) -> tuple[RecordHeader, memoryview]:
    """Parse exactly one record from ``data`` starting at ``offset``.

    ``data`` is a *byte-range read* of one record — no container header,
    no surrounding records required — so a manifest-driven restore can
    ``seek(offset); read(length)`` a single shard record out of a large
    shard file instead of mapping the whole file
    (``ContainerWriter.record_spans`` is where the spans come from).
    Truncated inputs raise a descriptive ``ValueError`` like the
    whole-container reader."""
    view = memoryview(data)
    hdr, payload, _ = _parse_record(data, view, offset, "byte-range record")
    return hdr, payload


class ContainerReader:
    def __init__(self, data: bytes):
        if len(data) < HEADER_LEN:
            raise ValueError(
                f"truncated DCBC container: {len(data)} bytes, need at "
                f"least the {HEADER_LEN}-byte header")
        if data[:4] != MAGIC:
            raise ValueError("not a DCBC container (bad magic)")
        version, self.num_records = struct.unpack_from("<HI", data, 4)
        if version not in SUPPORTED_VERSIONS:
            raise ValueError(
                f"unsupported container version {version} "
                f"(this reader handles <= {VERSION_V4})")
        self.version = version
        self._data = data
        self._offset = HEADER_LEN

    def __iter__(self):
        data = self._data
        # payloads are yielded as zero-copy memoryview slices: a streaming
        # consumer (serve weight backends) then pays one decoded-tensor
        # copy per record, not an extra per-record payload copy
        view = memoryview(data)
        off = self._offset
        for rec in range(self.num_records):
            hdr, payload, off = _parse_record(
                data, view, off, f"record {rec} of {self.num_records}")
            yield hdr, payload
