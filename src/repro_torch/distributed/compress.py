"""Gradient compression with error feedback (the port's copy of
``repro.distributed.compress``).

:func:`ef_compress_update` quantizes the update stream to int8 codes with
blockwise scales (``compression/q8.py``) and keeps a persistent
per-parameter f32 error accumulator (EF-SGD): what a step's codes leave
out is added to the next step's gradient.  The accumulator is written in
place, as the port's AdamW writes its moments.  Wire bytes are accounted
by the entropy of the codes (:func:`code_entropy_bits_per_param`), the
rate a CABAC pass would approach.

The explicit collective (``cross_pod_psum_compressed``) waits for the
distribution slice.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..compression.q8 import q8_decode, q8_encode
from ..compression.tree import flatten_tree, unflatten


@dataclass(frozen=True)
class CompressionConfig:
    enabled: bool = False
    ef_decay: float = 1.0          # error-feedback memory (1.0 = full EF)


def init_error_feedback(params):
    """Zero f32 accumulators shaped like ``params``, on their devices."""
    return unflatten({k: torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device)
                      for k, p in flatten_tree(params).items()})


def ef_compress_update(grads, ef, cfg: CompressionConfig):
    """Returns (compressed grads, error-feedback state); the state's
    tensors are updated in place."""
    if not cfg.enabled:
        return grads, ef
    flat_e = flatten_tree(ef)
    out = {}
    for name, g in flatten_tree(grads).items():
        t = flat_e[name]
        t.mul_(cfg.ef_decay).add_(g.to(torch.float32))
        codes, scale = q8_encode(t)
        deq = q8_decode(codes, scale)
        del codes, scale
        t.sub_(deq)
        out[name] = deq.to(g.dtype)
    return unflatten(out), ef


def cross_pod_psum_compressed(x, mesh, pod_axis: str = "pod"):
    """Quantized hierarchical sum over the pod axis: a collective."""
    raise NotImplementedError(
        "cross_pod_psum_compressed: not yet ported (distribution slice)")


def code_entropy_bits_per_param(codes) -> float:
    """EPMD entropy of int8 codes — the wire rate a CABAC pass achieves
    (upper bound; context adaptation goes below)."""
    c = (codes.detach().cpu().numpy() if isinstance(codes, torch.Tensor)
         else np.asarray(codes)).ravel()
    _, counts = np.unique(c, return_counts=True)
    p = counts / counts.sum()
    return float(-(p * np.log2(p)).sum())
