"""Shared layer primitives (port of ``repro.models.layers``): the q8
projection, RMSNorm, activations, SwiGLU MLP and RoPE."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.dequant_matmul import dequant_matmul
from ..kernels.embed_lookup import is_q8_leaf


def q8_einsum(x: torch.Tensor, w) -> torch.Tensor:
    """x (..., K) @ w -> (..., N) in ``x.dtype``.  A q8 leaf
    {"q8": (K, N) int8, "q8s": (N,) f32} goes through ``dequant_matmul``
    (f32 result cast back to x's dtype); a dense (K, N) weight is a plain
    product."""
    if is_q8_leaf(w):
        return dequant_matmul(x, w["q8"], w["q8s"]).to(x.dtype)
    return torch.einsum("...k,kn->...n", x, w)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    dtype = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * scale.to(torch.float32)
            ).to(dtype)


def activation(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")     # jax.nn.gelu's default
    raise ValueError(kind)


def swiglu_mlp(x: torch.Tensor, p: dict, act: str) -> torch.Tensor:
    gate = activation(q8_einsum(x, p["w_gate"]), act)
    up = q8_einsum(x, p["w_up"])
    return q8_einsum(gate * up, p["w_down"])


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x (..., S, H, D); positions (..., S) int.  Rotates the two split
    halves of D (not interleaved pairs), as the reference does."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    ang = positions[..., None].to(torch.float32) * freqs    # (..., S, D/2)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
