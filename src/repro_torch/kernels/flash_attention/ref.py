"""Plain PyTorch version of the flash-attention kernel (causal MHA), the
counterpart of ``repro.kernels.flash_attention.ref``."""

from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True) -> torch.Tensor:
    """q (BH, Sq, D); k, v (BH, Skv, D) -> (BH, Sq, D), f32 accumulation.
    Causal alignment: query i attends keys j <= i + (Skv - Sq)."""
    sq, skv = q.shape[1], k.shape[1]
    scale = 1.0 / torch.sqrt(torch.tensor(float(q.shape[-1])))
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale.to(q.device)
    if causal:
        offs = skv - sq
        mask = (torch.arange(skv, device=q.device)[None, :]
                <= torch.arange(sq, device=q.device)[:, None] + offs)
        s = torch.where(mask[None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqk,bkd->bqd", p, v.float())
    return out.to(q.dtype)


def tf32_split(x: torch.Tensor):
    """(big, small), two f32 tensors of TF32 values (the low 13 significand
    bits zero) with big + small within about 2^-22 |x| of a f32 x: big is x
    rounded to TF32 (ties away from zero), so x - big is exact, and small
    is x - big rounded the same way.  The split the kernel's f32 instance
    makes of every operand of both products."""
    def to_tf32(t):
        bits = t.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)
    x = x.to(torch.float32)
    big = to_tf32(x)
    return big, to_tf32(x - big)


def _mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b from split operands, small a * big b + big a * small b +
    big a * big b, each product in f32: what three TF32 MMAs sum."""
    (ab, as_), (bb, bs) = tf32_split(a), tf32_split(b)
    return as_ @ bb + ab @ bs + ab @ bb


def flash_attention_3xtf32(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor) -> torch.Tensor:
    """Causal attention of f32 q (BH, Sq, D), k, v (BH, Skv, D) with both
    products as the kernel's f32 instance takes them (3xTF32,
    :func:`tf32_split`); the softmax as :func:`flash_attention_ref`'s, with
    the denominator floored at 1e-30.  For tests; the op computes with
    :func:`flash_attention_ref` on the CPU."""
    sq, skv = q.shape[1], k.shape[1]
    s = _mm_3xtf32(q, k.transpose(1, 2)) * (1.0 / float(q.shape[-1]) ** 0.5)
    mask = (torch.arange(skv, device=q.device)[None, :]
            <= torch.arange(sq, device=q.device)[:, None] + (skv - sq))
    s = torch.where(mask[None], s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    return _mm_3xtf32(p, v.float()) / p.sum(-1, keepdim=True).clamp_min(
        1e-30)
