"""Plain PyTorch version of the fused dequantize-matmul (the kernel's
counterpart of ``repro.kernels.dequant_matmul.ref``)."""

from __future__ import annotations

import torch


def dequant_matmul_ref(x: torch.Tensor, w_q: torch.Tensor,
                       scale: torch.Tensor) -> torch.Tensor:
    """x (M, K) float @ dequant(w_q (K, N) int8, scale (N,) f32) -> (M, N)
    f32.  The per-output-channel scale multiplies the weight before the
    product, as in the reference; the sums are f32."""
    w = w_q.to(torch.float32) * scale[None, :].to(torch.float32)
    return x.to(torch.float32) @ w


def dequant_matmul_grouped_ref(x: torch.Tensor, w_q: torch.Tensor,
                               scale: torch.Tensor) -> torch.Tensor:
    """One independent product per expert: x (E, M, K) float @
    dequant(w_q (E, K, N) int8, scale (E, N) | (N,) f32) -> (E, M, N) f32.
    A (N,) scale (the stacked-MoE wire format: one per-channel Delta shared
    by the layer's experts) broadcasts over E."""
    if scale.dim() == 1:
        scale = scale[None, :]
    w = w_q.to(torch.float32) * scale[:, None, :].to(torch.float32)
    return x.to(torch.float32) @ w


def dequant_matmul_grouped_scale_after(x: torch.Tensor, w_q: torch.Tensor,
                                       scale: torch.Tensor) -> torch.Tensor:
    """The grouped product in the order of the kernel's bf16-x instance:
    f32 sums of x * q, then the per-column scale, out = s * (x @ q).  For a
    bf16 x every product x * q is exact in f32, so this is the reference's
    function with the scale factored out of the sum over K.  For tests and
    ``chip_smoke.py``; the op computes with :func:`dequant_matmul_grouped_ref`
    on the CPU."""
    if scale.dim() == 1:
        scale = scale[None, :]
    acc = x.to(torch.float32) @ w_q.to(torch.float32)
    return acc * scale[:, None, :].to(torch.float32)
