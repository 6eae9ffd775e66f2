"""Capacity-routed top-k MoE, DeepSeek style: shared + routed experts
(port of ``repro.models.moe``).

Groups are batch rows: each row scatters its tokens into its own
(E, C, d) slice of the capacity buffer (G, E, C, d), so a row's routing
never depends on another's (a free serving slot disturbs nobody).  Tokens
past an expert's per-row capacity are dropped: their contribution is
zeroed.  The routing takes a few whole-tensor ops and no host sync (no
one-hot, no accumulating scatter, nothing sized on the host), so a CUDA
graph can capture it.  The buffer stays dense (empty experts and padding
rows are computed), and the routed experts' products go through
``kernels.get("dequant_matmul_grouped")`` with ``cfg.kernels`` when the
expert bank is q8 (the router and shared experts through
``dequant_matmul``).
"""

from __future__ import annotations

import torch

from .. import kernels as _kernels
from .layers import activation, q8_einsum


def _expert_einsum(buf: torch.Tensor, w, *, policy=None) -> torch.Tensor:
    """Per-expert matmul buf (G, E, C, K) @ w (E, K, N) -> (G, E, C, N).

    ``w`` is the dense expert bank (a plain einsum) or a q8 leaf
    {"q8": (E, K, N) int8, "q8s": (E, N) | (N,) f32}: the group and
    capacity dims flatten to the grouped kernel's per-expert M, (E, G*C,
    K), a view of a buffer stored expert-major (as :func:`dispatch` stores
    it, and as the result comes back), and its f32 result is cast back to
    the buffer's dtype.  The q8 product goes through
    ``kernels.get("dequant_matmul_grouped")`` under ``policy``."""
    if _kernels.is_q8_leaf(w):
        g, e, c, k = buf.shape
        xg = buf.transpose(0, 1).reshape(e, g * c, k)
        out = _kernels.get("dequant_matmul_grouped")(
            xg, w["q8"], w["q8s"], policy=policy)
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


def route(topi: torch.Tensor, num_experts: int, cap: int):
    """Capacity positions of the choices ``topi`` (G, S, k), as the
    reference's loop over j assigns them: choice j of every token comes
    after every choice < j of its row, tokens in order within a choice.

    One cumulative count over that j-major (k*S) order of
    ``topi == arange(E)`` gives every position at once (along the last
    dim, the scan a GPU runs fastest).  Returns (hit (G, E, k*S) bool, the
    compare; pos (G, S, k), clipped to cap - 1 as the reference gathers
    it; keep (G, S, k), pos < cap)."""
    g, s, k = topi.shape
    ej = topi.transpose(1, 2).reshape(g, 1, k * s)
    hit = ej == torch.arange(num_experts, device=topi.device)[:, None]
    pos = torch.gather(torch.cumsum(hit, dim=2, dtype=torch.int32), 1,
                       ej)[:, 0] - 1
    pos = pos.view(g, k, s).transpose(1, 2)
    return hit, pos.clamp_max(cap - 1), pos < cap


def dispatch(x: torch.Tensor, topi, pos, keep, num_experts: int,
             cap: int) -> torch.Tensor:
    """The capacity buffer (G, E, C, d): row ``pos`` of expert ``topi``
    holds token x of each kept choice, the rest is zero.  It is stored
    expert-major, (E, G, C, d), the grouped kernel's operand layout, with
    one spare row after it where every dropped choice lands, so one
    scatter without accumulation fills it (kept positions are unique).
    The reference adds a dropped token's zero at C - 1, which changes no
    value."""
    g, s, d = x.shape
    k = topi.shape[-1]
    rows = torch.arange(g, device=x.device)[:, None, None]
    spare = num_experts * g * cap
    slot = torch.where(keep, (topi * g + rows) * cap + pos, spare)
    store = torch.zeros((spare + 1, d), dtype=x.dtype, device=x.device)
    store[slot] = x[:, :, None, :].expand(g, s, k, d)
    return store[:spare].view(num_experts, g, cap, d).transpose(0, 1)


def moe_block(x: torch.Tensor, p: dict, cfg, *, with_aux: bool = True):
    """x (G, S, d) -> (out (G, S, d), aux load-balance loss, 0-d f32; None
    unless ``with_aux``: the serving steps never use it)."""
    g, s, d = x.shape
    e, k = cfg.num_experts, cfg.top_k

    if _kernels.is_q8_leaf(p["router"]):
        logits = q8_einsum(x.to(torch.float32), p["router"],
                           policy=cfg.kernels)
    else:
        logits = torch.einsum("gsd,de->gse", x.to(torch.float32),
                              p["router"].to(torch.float32))
    probs = torch.softmax(logits, dim=-1)
    topw, topi = top_k(probs, k)                         # (g, s, k)
    topw = topw / torch.sum(topw, dim=-1, keepdim=True)

    cap = moe_capacity(s, cfg)
    hit, pos, keep = route(topi, e, cap)
    buf = dispatch(x, topi, pos, keep, e, cap)

    # routed experts: stacked SwiGLU on the capacity buffer
    pol = cfg.kernels
    gate = activation(_expert_einsum(buf, p["w_gate"], policy=pol), cfg.act)
    up = _expert_einsum(buf, p["w_up"], policy=pol)
    hbuf = _expert_einsum(gate * up, p["w_down"], policy=pol)

    # combine in the reference's order: out = 0 + w_0 v_0 + w_1 v_1 + ...
    rows = torch.arange(g, device=x.device)[:, None, None]
    w = (topw * keep).to(x.dtype)
    terms = w[..., None] * hbuf[rows, topi, pos]         # (g, s, k, d)
    out = terms[:, :, 0]
    for j in range(1, k):
        out = out + terms[:, :, j]

    # shared experts: one dense SwiGLU of width num_shared * moe_d_ff
    if cfg.num_shared_experts:
        sg = activation(q8_einsum(x, p["sh_gate"], policy=pol), cfg.act)
        su = q8_einsum(x, p["sh_up"], policy=pol)
        out = out + q8_einsum(sg * su, p["sh_down"], policy=pol)

    if not with_aux:
        return out, None
    # Switch-style load-balance aux loss: E * sum_e f_e * P_e
    me = torch.mean(probs, dim=(0, 1))                   # (e,)
    fe = hit.sum(dim=(0, 2)).to(torch.float32) / (g * s * k)
    aux = e * torch.sum(fe * me)
    return out, aux
