"""EntropyCoder strategies: quantized tensor -> DCBC container record (the
port's copy of ``CabacCoder``, ``CabacV3Coder`` and ``RawLevelCoder`` from
``repro.compression.coders``; the Huffman and delta coders wait).
Decoding needs no strategy object: records are self-describing."""

from __future__ import annotations

from dataclasses import dataclass

from ..core import binarization as B
from ..core.codec import (DEFAULT_CHUNK, Q8Tensor, QuantizedTensor,
                          encode_level_chunks, encode_level_chunks_batched)
from ..core.container import ContainerWriter


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
class RawLevelCoder(EntropyCoder):
    """Raw int8 levels + per-channel scales, no entropy coding (the
    serving artifact)."""

    def add_record(self, writer, name, qt):
        if not isinstance(qt, Q8Tensor):
            raise TypeError(
                f"RawLevelCoder stores int8 per-channel tensors, "
                f"got {type(qt).__name__}")
        writer.add_q8(name, qt.dtype, qt.levels, qt.scale)
