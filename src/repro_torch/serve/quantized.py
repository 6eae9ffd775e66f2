"""Fixed-point serving helpers (port of ``repro.serve.quantized``): q8
weight leaves and the int8 KV cache."""

from __future__ import annotations

import torch

from ..compression.quantizers import quantize_tree_q8  # noqa: F401
from ..kernels.embed_lookup import is_q8_leaf

is_q8 = is_q8_leaf

DEFAULT_KV_CACHE_DELTA = 1.0 / 16.0


def dequant_leaf(leaf, dtype: torch.dtype):
    if is_q8(leaf):
        q, s = leaf["q8"], leaf["q8s"]
        if s.dim() == 2 and q.dim() > 2:
            # stacked leaf: scales are (L, out) for levels (L, ..., out)
            s = s.reshape((s.shape[0],) + (1,) * (q.dim() - 2)
                          + (s.shape[1],))
        return (q.to(torch.float32) * s).to(dtype)
    return leaf


def quantize_cache_value(x: torch.Tensor,
                         delta: float = DEFAULT_KV_CACHE_DELTA
                         ) -> torch.Tensor:
    """Levels of ``x`` on the grid ``delta``.  Divides by a 0-d tensor, not
    a Python scalar, which CUDA would turn into a product with 1/delta (see
    ``compression.quantizers``): a calibrated delta is no power of two."""
    d = torch.full((), delta, dtype=torch.float32, device=x.device)
    return torch.clamp(torch.round(x.to(torch.float32) / d),
                       -127, 127).to(torch.int8)


def dequant_cache_value(q: torch.Tensor, dtype: torch.dtype,
                        delta: float = DEFAULT_KV_CACHE_DELTA
                        ) -> torch.Tensor:
    return (q.to(torch.float32) * delta).to(dtype)
