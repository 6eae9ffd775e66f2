"""Serving weight backends: how a ServeSession gets its parameters (port of
``repro.serve.backends`` for in-memory trees and DCBC container blobs).

    ``bf16``       full-precision leaves: a tree passes through; a blob is
                   decoded record by record to the model's param dtype.
    ``q8``         fixed-point serving: eligible matmul weights become
                   ``{"q8", "q8s"}`` leaves that every projection and the
                   untied head read through ``dequant_matmul``; a blob's
                   entropy-coded records are dequantized to the param
                   dtype and re-quantized with ``quantize_leaf``.
    ``container``  the paper's deployment artifact: a blob streamed record
                   by record; ``serve-q8`` records stay int8 and feed
                   ``dequant_matmul``, entropy-coded records dequantize to
                   the param dtype.

Blob loads keep the reference's layer-bound contract: one decoded record
is on the host at a time, moved to the device before the next is decoded,
and the template comes from the model's shapes and dtypes alone, leaf by
leaf (``models.transformer.param_specs``: a MoE router stays f32 in a bf16
model).  A ``serve-q8`` record of a stacked 4-D expert bank (L, E, K, N)
keeps its (L, N) scale, so each layer hands ``dequant_matmul_grouped`` the
shared (N,) form.  ``policy_table=`` applies a per-tensor RD policy to
*tree* sources (quantize, then dequantize back), so a tree session equals
one cold-started from the matching ``deepcabac-rd`` container.  Sharded-manifest sources (a path) are not
ported yet and raise.
"""

from __future__ import annotations

import os

import torch

from ..compression.codec import DecodeOptions, iter_decompress
from ..compression.quantizers import (quantize_leaf, quantize_tree_q8,
                                      serve_q8_policy)
from ..compression.tree import flatten_tree, unflatten
from ..core.codec import Q8Tensor

_BLOB = (bytes, bytearray, memoryview)


class WeightBackend:
    """Strategy interface: one weight source -> serving parameter tree.

    ``decode`` tunes the entropy decode of container blobs;
    ``policy_table`` (a ``TensorPolicy``, its dict payload or a JSON path)
    applies to tree sources only."""

    name = "?"

    def __init__(self, decode: DecodeOptions | None = None,
                 policy_table=None):
        self.decode = decode or DecodeOptions()
        self.policy_table = policy_table

    def load(self, cfg, source, device=None):
        """``device`` places the leaves of a blob source (default: the
        card); tree sources stay where they are."""
        raise NotImplementedError

    def _convert(self, name: str, rec, dtype, device):
        """One decoded record -> this backend's resident leaf."""
        return _to_tensor(rec, dtype, device)

    @staticmethod
    def _check_source(source) -> None:
        if isinstance(source, (str, os.PathLike)):
            raise NotImplementedError(
                "sharded-checkpoint manifest sources: not yet ported")

    def _apply_policy_tree(self, tree):
        """Quantize-dequantize a tree through ``policy_table`` (no-op
        without one): each covered float leaf is quantized on its rule
        where it lies (the ``rd_quant`` kernel on the card) and
        dequantized back to its dtype on its device."""
        if self.policy_table is None:
            return tree
        from ..compression.rd_search import PolicyQuantizer, resolve_policy
        table = resolve_policy(self.policy_table)
        quant = PolicyQuantizer(table=table)
        out = {}
        for name, leaf in flatten_tree(tree).items():
            rule = table.rule_for(name)
            if (rule is None or rule.kind == "raw" or leaf.numel() == 0
                    or not leaf.is_floating_point()):
                out[name] = leaf
                continue
            rec = quant.quantize(name, leaf)
            out[name] = rec.dequantize().to(leaf.device, leaf.dtype)
        return unflatten(out)

    def _blob_tree(self, cfg, source, device):
        return _stream_tree(cfg, bytes(source), self._convert,
                            _device(device), decode=self.decode)


def _device(device) -> torch.device:
    from ..kernels.registry import resolve_device
    return resolve_device("cuda" if device is None else device)


def _to_tensor(record, dtype, device) -> torch.Tensor:
    """Decoded record -> tensor in the template dtype on ``device``."""
    t = record.dequantize() if hasattr(record, "dequantize") else record
    return t.to(device=device, dtype=dtype)


def _q8_leaf(record: Q8Tensor, device) -> dict:
    return {"q8": torch.from_numpy(record.levels).to(device),
            "q8s": torch.from_numpy(record.scale).to(device, torch.float32)}


def _stream_tree(cfg, blob: bytes, convert, device,
                 decode: DecodeOptions | None = None) -> dict:
    """Fold the per-record decode iterator into a nested params dict,
    checked against the model's template: records the model does not
    expect are skipped, a shape mismatch raises, and a container missing
    a template tensor raises.  Each decoded record is converted (and
    moved to ``device``) before the next one is decoded."""
    from ..models.transformer import param_specs
    specs = param_specs(cfg)
    flat: dict = {}
    for name, record in iter_decompress(blob, dequantize=False, opts=decode):
        spec = specs.get(name)
        if spec is None:
            continue                       # not part of this model
        shape, dtype = spec
        if tuple(record.shape) != tuple(shape):
            raise ValueError(
                f"{name}: container shape {tuple(record.shape)} != model "
                f"{tuple(shape)}")
        flat[name] = convert(name, record, dtype, device)
        del record
    missing = sorted(set(specs) - set(flat))
    if missing:
        raise KeyError(
            f"container missing {len(missing)} model tensor(s), e.g. "
            f"{missing[:3]}")
    return unflatten(flat)


class Bf16Backend(WeightBackend):
    name = "bf16"

    def load(self, cfg, source, device=None):
        self._check_source(source)
        if isinstance(source, _BLOB):
            return self._blob_tree(cfg, source, device)
        return self._apply_policy_tree(source)


class Q8Backend(WeightBackend):
    name = "q8"

    def _convert(self, name, rec, dtype, device):
        if isinstance(rec, Q8Tensor):
            return _q8_leaf(rec, device)
        t = _to_tensor(rec, dtype, device)
        return quantize_leaf(t) if serve_q8_policy(name, t) else t

    def load(self, cfg, source, device=None):
        self._check_source(source)
        if isinstance(source, _BLOB):
            return self._blob_tree(cfg, source, device)
        return quantize_tree_q8(self._apply_policy_tree(source))


class ContainerBackend(WeightBackend):
    name = "container"

    def _convert(self, name, rec, dtype, device):
        if isinstance(rec, Q8Tensor):
            return _q8_leaf(rec, device)
        return _to_tensor(rec, dtype, device)

    def load(self, cfg, source, device=None):
        self._check_source(source)
        if not isinstance(source, _BLOB):
            raise TypeError(
                "container backend loads DCBC blobs (bytes); got "
                f"{type(source).__name__} — use the 'bf16' or 'q8' backend "
                "for in-memory trees")
        return self._blob_tree(cfg, source, device)


_BACKENDS: dict = {"bf16": Bf16Backend, "q8": Q8Backend,
                   "container": ContainerBackend}


def available_backends() -> list[str]:
    return sorted(_BACKENDS)


def get_backend(name: str, **overrides) -> WeightBackend:
    if name not in _BACKENDS:
        raise KeyError(f"unknown weight backend {name!r}; available: "
                       f"{available_backends()}")
    return _BACKENDS[name](**overrides)


def resolve_backend(backend) -> WeightBackend:
    if isinstance(backend, WeightBackend):
        return backend
    return get_backend(backend)
