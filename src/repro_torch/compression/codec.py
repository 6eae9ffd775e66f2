"""The Codec: Quantizer x EntropyCoder x per-tensor policy over parameter
trees (the port's copy of ``repro.compression.codec``: ``Codec``, the
temporal ``DeltaCodec``, ``decompress`` and ``iter_decompress``).

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

from ..arrays import dtype_name
from ..core.codec import (DecodeOptions, DeltaTensor,  # noqa: F401
                          QuantizedTensor, compressed_size_report,
                          decode_state_dict, decode_state_dict_batched,
                          iter_decode_state_dict)
from ..core.container import ContainerWriter
from ..core.quant import nearest_level
from .artifact import Artifact
from .coders import EntropyCoder
from .quantizers import PolicyFn, Quantizer, host_f64
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


def _step_locked_levels(w, step: float, block: int = 1 << 22
                        ) -> np.ndarray:
    """``nearest_level(w in f64, step)`` in ``w``'s shape, computed in
    blocks of ``block`` values: the same int64 levels as the whole-tensor
    f64 oracle (every operation is elementwise), without a model-sized
    f64 copy."""
    flat = w.detach().reshape(-1) if isinstance(w, torch.Tensor) \
        else np.asarray(w).reshape(-1)
    out = np.empty(flat.shape[0], dtype=np.int64)
    for s in range(0, out.size, block):
        out[s:s + block] = nearest_level(host_f64(flat[s:s + block]), step)
    return out.reshape(tuple(w.shape))


def _is_raw(e) -> bool:
    return isinstance(e, (torch.Tensor, np.ndarray))


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
        """Entropy-code an already-quantized flat entry dict (the output
        of :meth:`quantize_entries`, or of ``DeltaCodec.quantize_like``
        for a step-locked frame) without re-quantizing."""
        writer = ContainerWriter()
        for name, e in entries.items():
            if _is_raw(e):
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


@dataclass
class DeltaCodec(Codec):
    """Temporal delta ("P-frame") codec.

    Keyframes (I-frames) go through the inherited :meth:`Codec.compress`.
    :meth:`compress_delta` codes a new frame against a base frame's
    quantized entries: the new frame is quantized on the *base tensor's
    grid* (step locking, by the f64 host oracle ``nearest_level``), the
    integer-level residual is temporal-context CABAC coded, and
    reconstruction is therefore bit-identical to the direct encoding of the
    same step-locked frame, with no drift across chains of any depth.
    Tensors with no compatible base (new name, shape change, raw in the
    base) become full intra records inside the same container.
    """

    delta_coder: EntropyCoder | None = None

    def _quantizable(self, name, w) -> bool:
        return (self.quantizer is not None and w.numel() > 0
                and (self.policy is None or self.policy(name, w)))

    def _lockable(self, name, w, base) -> bool:
        return (self._quantizable(name, w)
                and isinstance(base, QuantizedTensor)
                and base.shape == tuple(w.shape) and base.step > 0)

    def delta_entries(self, tree, base_entries: dict) -> dict:
        """Flatten the new frame; every tensor with a compatible base
        entry is quantized on the *base's* grid and becomes a
        :class:`DeltaTensor` residual against the base levels; the rest
        follow the codec's own quantizer and policy as full intra
        entries (raw leaves pass through)."""
        out: dict = {}
        for name, w in flatten_tree(tree).items():
            base = base_entries.get(name)
            if self._lockable(name, w, base):
                resid = _step_locked_levels(w, base.step)
                resid -= base.levels.astype(np.int64, copy=False)
                out[name] = DeltaTensor(resid=resid, base=base.levels,
                                        step=base.step,
                                        dtype=dtype_name(w.dtype))
            elif self._quantizable(name, w):
                out[name] = self.quantizer.quantize(name, w)
            else:
                out[name] = w
        return out

    def quantize_like(self, tree, base_entries: dict) -> dict:
        """The step-locked quantization of the new frame: the frame a
        base + delta chain reconstructs bit for bit.  Encoding these
        entries directly (:meth:`Codec.compress_entries`) is the
        monolithic reference a chain is held to."""
        return self.reconstruct_entries(
            self.delta_entries(tree, base_entries))

    @staticmethod
    def reconstruct_entries(dentries: dict) -> dict:
        """New-frame entries (QuantizedTensor / Q8Tensor / raw tensor)
        from a :meth:`delta_entries` dict: what a decoder of the chain
        yields, and what the next link's ``base_entries`` should be."""
        return {name: (QuantizedTensor(e.new_levels().reshape(e.shape),
                                       e.step, e.dtype)
                       if isinstance(e, DeltaTensor) else e)
                for name, e in dentries.items()}

    def compress_delta(self, tree, base_entries: dict) -> Artifact:
        """Encode ``tree`` as a P-frame against ``base_entries`` (the flat
        quantized entries of the base frame, e.g. ``Artifact.quantized``
        of the previous save).  ``Artifact.quantized`` holds the
        *reconstructed new frame*, so callers chain the next delta
        without decoding."""
        if self.delta_coder is None:
            raise ValueError(
                f"codec {self.name!r} has no delta coder; use compress()")
        dentries = self.delta_entries(tree, base_entries)
        writer = ContainerWriter()
        n_delta = 0
        for name, e in dentries.items():
            if isinstance(e, DeltaTensor):
                self.delta_coder.add_record(writer, name, e)
                n_delta += 1
            elif _is_raw(e):
                writer.add_raw(name, e)
            elif self.coder is None:
                raise ValueError(
                    f"codec {self.name!r} quantized {name} but has no "
                    f"entropy coder")
            else:
                self.coder.add_record(writer, name, e)
        blob = writer.tobytes()
        new_entries = self.reconstruct_entries(dentries)
        return Artifact(
            blob=blob,
            report={**compressed_size_report(new_entries, blob),
                    "delta_records": n_delta},
            hyperparams={"codec": self.name, "delta": True,
                         **self.hyperparams},
            quantized=new_entries)
