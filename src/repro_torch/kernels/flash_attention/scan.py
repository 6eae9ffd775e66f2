"""Plain PyTorch attention outside the kernel: the online-softmax scan and
the naive path (ports of ``repro.kernels.flash_attention.scan``).

Both honour ragged per-row ``kv_len`` masks, so decode (Sq == 1) and the
shapes the kernel does not take run here, on the CPU or on the card.  GQA
is expanded inside the einsum (q reshaped to (B, S, G, R, D)); K/V are
never repeated in memory.  Scores and sums are f32, as the reference's
``preferred_element_type=f32``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

NEG_INF = -1e30


def _scale(d: int) -> float:
    """1/sqrt(d) as the reference rounds it in f32, held as a Python
    number: a tensor made on the host would be a copy to the card in every
    step, which a CUDA graph cannot capture."""
    return float(np.float32(1.0) / np.sqrt(np.float32(d)))


def online_softmax_scan(q5, k, v, qpos, kv_block: int, kv_len=None):
    """q5 (B,Sq,G,R,D); k,v (B,Skv,G,D); qpos (B,Sq) global positions.
    Returns (B,Sq,G,R,D)."""
    b, sq, g, r, d = q5.shape
    dv = v.shape[-1]
    skv = k.shape[1]
    nb = -(-skv // kv_block)
    pad = nb * kv_block - skv
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    scale = _scale(d)
    qf = q5.float()
    m = torch.full((b, g, r, sq), NEG_INF, device=q5.device)
    l = torch.zeros((b, g, r, sq), device=q5.device)
    acc = torch.zeros((b, g, r, sq, dv), device=q5.device)
    arange = torch.arange(kv_block, device=q5.device)
    for i in range(nb):
        k_i = k[:, i * kv_block:(i + 1) * kv_block]
        v_i = v[:, i * kv_block:(i + 1) * kv_block]
        kpos = i * kv_block + arange
        s = torch.einsum("bsgrd,btgd->bgrst", qf, k_i.float()) * scale
        mask = kpos[None, None, None, None, :] <= \
            qpos[:, None, None, :, None]
        if kv_len is not None:
            mask = mask & (kpos[None, None, None, None, :]
                           < kv_len[:, None, None, None, None])
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bgrst,btgd->bgrsd", p.to(v_i.dtype).float(), v_i.float())
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).to(q5.dtype)       # (B,Sq,G,R,D)


def naive_attend(q5, k, v, qpos, kv_len=None):
    """Full score matrix; the decode path (Sq == 1)."""
    b, sq, g, r, d = q5.shape
    skv = k.shape[1]
    scale = _scale(d)
    s = torch.einsum("bsgrd,btgd->bgrst", q5.float(), k.float()) * scale
    kpos = torch.arange(skv, device=q5.device)
    mask = kpos[None, None, None, None, :] <= qpos[:, None, None, :, None]
    if kv_len is not None:
        mask = mask & (kpos[None, None, None, None, :]
                       < kv_len[:, None, None, None, None])
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrst,btgd->bsgrd", p.to(v.dtype).float(), v.float())
    return out.to(q5.dtype)
