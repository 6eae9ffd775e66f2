"""EntropyCoder strategies: quantized tensor -> DCBC container record (the
port's copy of ``repro.compression.coders``).  Decoding needs no strategy
object: records are self-describing (a delta record needs its base frame's
levels besides, ``core.codec.decode_delta_record``)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core import binarization as B
from ..core.codec import (DEFAULT_CHUNK, DeltaTensor, Q8Tensor,
                          QuantizedTensor, encode_delta_chunks_batched,
                          encode_level_chunks, encode_level_chunks_batched)
from ..core.container import ContainerWriter
from ..core.huffman import build_huffman, pack_payload


class EntropyCoder:
    """Strategy interface: append one quantized tensor to a container."""

    def add_record(self, writer: ContainerWriter, name: str, qt) -> None:
        raise NotImplementedError


@dataclass
class CabacCoder(EntropyCoder):
    """Chunk-parallel CABAC (container v1 records), coded by the scalar
    range coder."""

    num_gr: int = B.DEFAULT_NUM_GR
    chunk_size: int = DEFAULT_CHUNK

    def add_record(self, writer, name, qt):
        if not isinstance(qt, QuantizedTensor):
            raise TypeError(
                f"CabacCoder codes scalar-step levels, got {type(qt).__name__}")
        chunks = encode_level_chunks(qt.levels, self.num_gr, self.chunk_size)
        writer.add_cabac(name, qt.dtype, qt.shape, qt.step,
                         self.num_gr, self.chunk_size, chunks)


@dataclass
class CabacV3Coder(EntropyCoder):
    """Lane-scheduled CABAC: chunks are encoded as one lane batch
    (streams bit-identical to :class:`CabacCoder`) and the record carries
    per-chunk value counts (container v3)."""

    num_gr: int = B.DEFAULT_NUM_GR
    chunk_size: int = DEFAULT_CHUNK
    backend: str = "auto"          # lane engine for encode: auto | c | numpy

    def add_record(self, writer, name, qt):
        if not isinstance(qt, QuantizedTensor):
            raise TypeError(
                f"CabacV3Coder codes scalar-step levels, "
                f"got {type(qt).__name__}")
        chunks, counts = encode_level_chunks_batched(
            qt.levels, self.num_gr, self.chunk_size, backend=self.backend)
        writer.add_cabac_v3(name, qt.dtype, qt.shape, qt.step,
                            self.num_gr, self.chunk_size, chunks, counts)


@dataclass
class CabacDeltaCoder(EntropyCoder):
    """Temporal-context CABAC over integer-level *residuals* ("P-frame"
    records): each residual's context bank is selected by the class of
    its co-located base-frame level, and the chunk layout mirrors the v3
    lane schedule.  Containers carrying these records are version 4 and
    undecodable without the base frame the delta manifest names."""

    num_gr: int = B.DEFAULT_NUM_GR
    chunk_size: int = DEFAULT_CHUNK
    backend: str = "auto"          # lane engine for encode: auto | c | numpy

    def add_record(self, writer, name, dt):
        if not isinstance(dt, DeltaTensor):
            raise TypeError(
                f"CabacDeltaCoder codes level residuals, "
                f"got {type(dt).__name__}")
        chunks, counts = encode_delta_chunks_batched(
            dt.resid, dt.base, self.num_gr, self.chunk_size,
            backend=self.backend)
        writer.add_cabac_delta(name, dt.dtype, dt.shape, dt.step,
                               self.num_gr, self.chunk_size, chunks, counts)


@dataclass
class HuffmanCoder(EntropyCoder):
    """Canonical scalar Huffman baseline (paper §IV-B-2) with the two-part
    code table transmitted in-band ahead of the bitstream.  A benchmark
    baseline: its per-symbol Python loops suit the paper-table fixtures,
    not a full model."""

    def add_record(self, writer, name, qt):
        if not isinstance(qt, QuantizedTensor):
            raise TypeError(f"HuffmanCoder codes scalar-step levels, got "
                            f"{type(qt).__name__}")
        flat = np.asarray(qt.levels).ravel()
        payload = pack_payload(flat, build_huffman(flat))
        writer.add_huffman(name, qt.dtype, qt.shape, qt.step, payload)


@dataclass
class RawLevelCoder(EntropyCoder):
    """Raw int8 levels + per-channel scales, no entropy coding (the
    serving artifact)."""

    def add_record(self, writer, name, qt):
        if not isinstance(qt, Q8Tensor):
            raise TypeError(
                f"RawLevelCoder stores int8 per-channel tensors, "
                f"got {type(qt).__name__}")
        writer.add_q8(name, qt.dtype, qt.levels, qt.scale)
