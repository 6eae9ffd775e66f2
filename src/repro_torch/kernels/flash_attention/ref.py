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
