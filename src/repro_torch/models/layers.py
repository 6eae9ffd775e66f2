"""Shared layer primitives (port of ``repro.models.layers``): the q8
projection, RMSNorm and layernorm, activations, SwiGLU MLP, RoPE and
M-RoPE."""

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


def layer_norm(x: torch.Tensor, p: dict, eps: float) -> torch.Tensor:
    """Layernorm with ``{"scale", "bias"}``: f32 mean and (biased)
    variance, ``rsqrt(var + eps)``, then scale and bias, back in x's type
    (the reference's ``transformer._norm``)."""
    xf = x.to(torch.float32)
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


def norm(x: torch.Tensor, p, cfg) -> torch.Tensor:
    """The model's norm, as ``cfg.norm`` names it: ``"layernorm"`` takes a
    ``{"scale", "bias"}`` dict, ``"rmsnorm"`` a scale vector."""
    if cfg.norm == "layernorm":
        return layer_norm(x, p, cfg.norm_eps)
    return rms_norm(x, p, cfg.norm_eps)


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


def apply_m_rope(x: torch.Tensor, positions_3d: torch.Tensor, theta: float,
                 sections: tuple[int, int, int]) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE.  x (B, S, H, D), positions_3d (3, B, S).
    The D/2 rotation frequencies are split into (t, h, w) sections: the
    first ``sections[0]`` rotate by the temporal stream, the next
    ``sections[1]`` by the height stream, the rest by the width stream."""
    half = x.shape[-1] // 2
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    ang_all = positions_3d[..., None].to(torch.float32) * freqs  # (3,B,S,D/2)
    s0, s1 = sections[0], sections[0] + sections[1]
    ang = torch.cat([ang_all[0, ..., :s0], ang_all[1, ..., s0:s1],
                     ang_all[2, ..., s1:half]], dim=-1)            # (B,S,D/2)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
