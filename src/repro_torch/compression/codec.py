"""The Codec: Quantizer x EntropyCoder x per-tensor policy over parameter
trees (the port's copy of ``Codec``, ``decompress`` and
``iter_decompress`` from ``repro.compression.codec``; ``DeltaCodec``
waits for the delta slice).

``compress`` takes a nested dict of tensors (on any device) or a flat
``{"a/b/c": tensor}`` dict, applies the policy per tensor, quantizes what
it selects, entropy-codes into one DCBC container and returns an
:class:`Artifact` whose blob equals the reference's for the same values.
``decompress`` is codec-independent: the container is self-describing.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..core.codec import (DecodeOptions, compressed_size_report,  # noqa: F401
                          decode_state_dict, decode_state_dict_batched,
                          iter_decode_state_dict)
from ..core.container import ContainerWriter
from .artifact import Artifact
from .coders import EntropyCoder
from .quantizers import PolicyFn, Quantizer
from .tree import flatten_tree, unflatten_like


def iter_decompress(blob: bytes, dequantize: bool = True,
                    opts: DecodeOptions | None = None):
    """Streaming decode of any codec's container: yields ``(name, tensor)``
    one record at a time (the decoded host peak is one tensor)."""
    yield from iter_decode_state_dict(blob, dequantize=dequantize, opts=opts)


def decompress(blob: bytes, like=None, dequantize: bool = True,
               batched: bool = False, opts: DecodeOptions | None = None):
    """Decode any codec's container to the flat ``{"a/b/c": tensor}`` dict
    of CPU tensors, or — given ``like``, a template tree — the rebuilt
    tree with each leaf cast to the template's dtype.  ``batched=True``
    schedules every CABAC chunk into one lane batch (cold-start path)."""
    if batched:
        flat = decode_state_dict_batched(blob, dequantize=dequantize,
                                         opts=opts)
    else:
        flat = decode_state_dict(blob, dequantize=dequantize, opts=opts)
    return flat if like is None else unflatten_like(flat, like)


@dataclass
class Codec:
    name: str
    coder: EntropyCoder | None = None       # None => raw-only codec
    quantizer: Quantizer | None = None      # None => everything raw
    policy: PolicyFn | None = None
    hyperparams: dict = field(default_factory=dict)

    def quantize_entries(self, tree) -> dict:
        """Flatten + per-tensor policy + quantize; raw leaves pass through."""
        entries: dict = {}
        for name, w in flatten_tree(tree).items():
            if (self.quantizer is not None and w.numel() > 0
                    and (self.policy is None or self.policy(name, w))):
                entries[name] = self.quantizer.quantize(name, w)
            else:
                entries[name] = w
        return entries

    def compress_entries(self, entries: dict) -> Artifact:
        """Entropy-code an already-quantized flat entry dict."""
        writer = ContainerWriter()
        for name, e in entries.items():
            if isinstance(e, (torch.Tensor, np.ndarray)):
                writer.add_raw(name, e)
            elif self.coder is None:
                raise ValueError(
                    f"codec {self.name!r} quantized {name} but has no "
                    f"entropy coder")
            else:
                self.coder.add_record(writer, name, e)
        blob = writer.tobytes()
        return Artifact(blob=blob,
                        report=compressed_size_report(entries, blob),
                        hyperparams={"codec": self.name, **self.hyperparams},
                        quantized=entries)

    def compress(self, tree) -> Artifact:
        return self.compress_entries(self.quantize_entries(tree))

    def decompress(self, blob: bytes, like=None, dequantize: bool = True):
        return decompress(blob, like=like, dequantize=dequantize)
