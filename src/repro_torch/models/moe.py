"""Capacity-routed top-k MoE, DeepSeek style: shared + routed experts
(port of ``repro.models.moe``).

Groups are batch rows: each row scatters its tokens into its own
(E, C, d) slice of the capacity buffer (G, E, C, d), so a row's routing
never depends on another's (a free serving slot disturbs nobody).  Tokens
past an expert's per-row capacity are dropped: their contribution is
zeroed, and they still add that zero at position C - 1, as the reference's
``.at[].add`` does.  The buffer stays dense (empty experts and padding rows
are computed), and the routed experts' products go through the
``dequant_matmul_grouped`` kernel when the expert bank is q8.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.dequant_matmul import dequant_matmul_grouped
from ..kernels.embed_lookup import is_q8_leaf
from .layers import activation, q8_einsum


def _expert_einsum(buf: torch.Tensor, w) -> torch.Tensor:
    """Per-expert matmul buf (G, E, C, K) @ w (E, K, N) -> (G, E, C, N).

    ``w`` is the dense expert bank (a plain einsum) or a q8 leaf
    {"q8": (E, K, N) int8, "q8s": (E, N) | (N,) f32}: the group and
    capacity dims flatten to the grouped kernel's per-expert M (a
    contiguous (E, G*C, K) copy), and its f32 result is cast back to the
    buffer's dtype."""
    if is_q8_leaf(w):
        g, e, c, k = buf.shape
        xg = buf.transpose(0, 1).reshape(e, g * c, k)
        out = dequant_matmul_grouped(xg, w["q8"], w["q8s"])
        return out.reshape(e, g, c, -1).transpose(0, 1).to(buf.dtype)
    return torch.einsum("gecd,edf->gecf", buf, w)


def moe_capacity(group_tokens: int, cfg) -> int:
    cap = int(group_tokens * cfg.top_k * cfg.capacity_factor
              / cfg.num_experts)
    return max(cap - cap % -8, 8)   # round up to a multiple of 8


def top_k(probs: torch.Tensor, k: int):
    """The k largest entries of the last dim, largest first; equal values
    keep the lower index first, as ``lax.top_k`` does (``torch.topk``
    promises no order for ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_block(x: torch.Tensor, p: dict, cfg):
    """x (G, S, d) -> (out (G, S, d), aux load-balance loss, 0-d f32)."""
    g, s, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    dev = x.device

    if is_q8_leaf(p["router"]):
        logits = q8_einsum(x.to(torch.float32), p["router"])
    else:
        logits = torch.einsum("gsd,de->gse", x.to(torch.float32),
                              p["router"].to(torch.float32))
    probs = torch.softmax(logits, dim=-1)
    topw, topi = top_k(probs, k)                         # (g, s, k)
    topw = topw / torch.sum(topw, dim=-1, keepdim=True)

    cap = moe_capacity(s, cfg)
    buf = torch.zeros((g, e, cap, d), dtype=x.dtype, device=dev)
    base = torch.zeros((g, e), dtype=torch.int64, device=dev)
    rows = torch.arange(g, device=dev)[:, None].expand(g, s)
    slot_pos, slot_keep = [], []
    for j in range(k):
        ej = topi[..., j]                                # (g, s)
        oh = F.one_hot(ej, e)                            # (g, s, e)
        pos = torch.gather(torch.cumsum(oh, dim=1), 2,
                           ej[..., None])[..., 0] - 1
        pos = pos + torch.gather(base, 1, ej)
        base = base + oh.sum(dim=1)
        keep = pos < cap
        cpos = pos.clamp(0, cap - 1)
        contrib = torch.where(keep, 1.0, 0.0).to(x.dtype)[..., None] * x
        # kept positions are unique; dropped tokens add zeros at cap - 1
        buf.index_put_((rows, ej, cpos), contrib, accumulate=True)
        slot_pos.append(cpos)
        slot_keep.append(keep)

    # routed experts: stacked SwiGLU on the capacity buffer
    gate = activation(_expert_einsum(buf, p["w_gate"]), cfg.act)
    up = _expert_einsum(buf, p["w_up"])
    hbuf = _expert_einsum(gate * up, p["w_down"])

    out = torch.zeros((g, s, d), dtype=x.dtype, device=dev)
    for j in range(k):
        vals = hbuf[rows, topi[..., j], slot_pos[j]]     # (g, s, d)
        w = (topw[..., j] * slot_keep[j]).to(x.dtype)
        out = out + w[..., None] * vals

    # shared experts: one dense SwiGLU of width num_shared * moe_d_ff
    if cfg.num_shared_experts:
        sg = activation(q8_einsum(x, p["sh_gate"]), cfg.act)
        su = q8_einsum(x, p["sh_up"])
        out = out + q8_einsum(sg * su, p["sh_down"])

    # Switch-style load-balance aux loss: E * sum_e f_e * P_e
    me = torch.mean(probs, dim=(0, 1))                   # (e,)
    assigned = torch.zeros((e,), dtype=torch.float32, device=dev)
    for j in range(k):
        assigned = assigned + F.one_hot(topi[..., j], e).to(
            torch.float32).sum(dim=(0, 1))
    fe = assigned / (g * s * k)
    aux = e * torch.sum(fe * me)
    return out, aux
