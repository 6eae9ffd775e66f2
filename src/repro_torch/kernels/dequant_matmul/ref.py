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


def bf16x3_split(x: torch.Tensor):
    """(hi, mid, lo), three bf16 tensors with hi + mid + lo == x exactly for
    a f32 x (|x| >= 2^-110, finite in bf16): hi = rn(x), mid = rn(x - hi),
    lo = x - hi - mid, the split the kernel's tensor-core instance makes of
    a f32 x.  Each piece has 8 significant bits, so its product with an
    int8 level is exact in f32."""
    x = x.to(torch.float32)
    hi = x.to(torch.bfloat16)
    r = x - hi.float()
    mid = r.to(torch.bfloat16)
    lo = (r - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


def dequant_matmul_scale_after(x: torch.Tensor, w_q: torch.Tensor,
                               scale: torch.Tensor) -> torch.Tensor:
    """The product in the order of the kernel's tensor-core instance: f32
    sums of exact products x * q, then the per-column scale, out =
    s * (x @ q).  A bf16 x is used as it is; a f32 x as its three bf16
    pieces (:func:`bf16x3_split`), s * (lo @ q + mid @ q + hi @ q).  For
    tests and ``chip_smoke.py``; the op computes with
    :func:`dequant_matmul_ref` on the CPU."""
    q = w_q.to(torch.float32)
    if x.dtype == torch.bfloat16:
        acc = x.float() @ q
    else:
        hi, mid, lo = bf16x3_split(x)
        acc = lo.float() @ q + mid.float() @ q + hi.float() @ q
    return acc * scale[None, :].to(torch.float32)


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
    """The grouped product in the order of the kernel: f32 sums of exact
    products x * q, then the per-column scale, out = s * (x @ q).  A bf16 x
    is used as it is (every product x * q is exact in f32, so this is the
    reference's function with the scale factored out of the sum over K); a
    f32 x as its three bf16 pieces (:func:`bf16x3_split`), s * (lo @ q +
    mid @ q + hi @ q).  For tests and ``chip_smoke.py``; the op computes
    with :func:`dequant_matmul_grouped_ref` on the CPU."""
    if scale.dim() == 1:
        scale = scale[None, :]
    q = w_q.to(torch.float32)
    if x.dtype == torch.bfloat16:
        acc = x.float() @ q
    else:
        hi, mid, lo = bf16x3_split(x)
        acc = lo.float() @ q + mid.float() @ q + hi.float() @ q
    return acc * scale[:, None, :].to(torch.float32)
