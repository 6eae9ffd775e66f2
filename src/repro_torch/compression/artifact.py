"""Shared artifact type every compression path returns (the port's copy
of ``repro.compression.artifact``)."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Artifact:
    """Result of compressing a parameter tree: serialized blob + bookkeeping.

    ``quantized`` maps flat tensor names to the quantized representation
    (``QuantizedTensor`` / ``Q8Tensor``, anything with ``dequantize()``) or
    the raw tensor that passed through uncoded.
    """

    blob: bytes
    report: dict
    hyperparams: dict
    quantized: dict = field(repr=False, default_factory=dict)

    def reconstructed(self) -> dict:
        """Dequantized view of every entry (what a decoder will produce)."""
        return {k: v.dequantize() if hasattr(v, "dequantize") else v
                for k, v in self.quantized.items()}
