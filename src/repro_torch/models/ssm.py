"""Mamba2 — SSD (state-space duality) block, chunked scan and single-step
decode (port of ``repro.models.ssm``).

Chunked SSD (arXiv:2405.21060 §6): the sequence is split into chunks of
length Q; within a chunk the recurrence is a masked quadratic form
(attention-like), across chunks a short loop passes the (H, P, N) state.
Decode is the exact linear recurrence: state = a * state + dt * B * x per
token.  Everything here is torch ops and ``torch.einsum``, as the reference
is plain JAX outside any kernel.

Dtypes are the reference's: ``dt = softplus(dt_raw + dt_bias)`` is f32
(``dt_bias`` is f32), the chunked scan and the decode recurrence run in
f32 on an f32 state, ``y`` returns to the compute dtype before the skip
term, and the causal conv sums its W shifted products in order in the
compute dtype.

With a cache, the mixer writes its final state and conv tails into the
cache's tensors in place (``copy_``) and returns that cache, so a decode
step reads no device value on the host and writes nothing new that a CUDA
graph would have to keep: the reference returns new arrays instead.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import rms_norm


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a (..., l) -> (..., l, l) with out[t, s] = sum_{u in (s, t]} a_u
    (lower-triangular; -inf above the diagonal)."""
    l = a.shape[-1]
    cum = torch.cumsum(a, dim=-1)
    d = cum[..., :, None] - cum[..., None, :]
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool, device=a.device))
    return d.masked_fill(~mask, float("-inf"))


def ssd_chunked(x, a_log, b_mat, c_mat, chunk: int, state0=None):
    """x (B,S,H,P); a_log (B,S,H) (= dt*A, negative); b_mat, c_mat
    (B,S,G,N).  Returns (y (B,S,H,P), final_state (B,H,P,N) f32)."""
    bsz, s, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    rep = h // g
    nc = s // chunk
    xc = x.reshape(bsz, nc, chunk, h, p)
    ac = a_log.reshape(bsz, nc, chunk, h)
    bc = b_mat.reshape(bsz, nc, chunk, g, n)
    cc = c_mat.reshape(bsz, nc, chunk, g, n)

    # intra-chunk (quadratic): y_diag[t] = sum_{s<=t} C_t B_s L_{t,s} x_s
    ll = torch.exp(_segsum(ac.permute(0, 1, 3, 2)))      # (B,nc,H,l,l)
    cb = torch.einsum("bctgn,bcsgn->bcgts", cc, bc)      # (B,nc,G,l,l)
    cb = cb.reshape(bsz, nc, g, 1, chunk, chunk) * ll.reshape(
        bsz, nc, g, rep, chunk, chunk)
    y_diag = torch.einsum("bcgrts,bcsgrp->bctgrp", cb,
                          xc.reshape(bsz, nc, chunk, g, rep, p))

    # chunk states: contribution of each chunk to the running state
    a_cum = torch.cumsum(ac, dim=2)                      # (B,nc,l,H)
    a_tot = a_cum[:, :, -1, :]                           # (B,nc,H)
    decay_out = torch.exp(a_tot[:, :, None, :] - a_cum)  # (B,nc,l,H)
    states = torch.einsum(
        "bcsgn,bcsgr,bcsgrp->bcgrpn", bc,
        decay_out.reshape(bsz, nc, chunk, g, rep),
        xc.reshape(bsz, nc, chunk, g, rep, p)).reshape(bsz, nc, h, p, n)

    # inter-chunk recurrence, emitting the state *before* each chunk
    carry = (torch.zeros((bsz, h, p, n), dtype=torch.float32,
                         device=x.device) if state0 is None
             else state0.to(torch.float32))
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = (carry * torch.exp(a_tot[:, c])[:, :, None, None]
                 + states[:, c].to(torch.float32))
    prev_states = torch.stack(prev, dim=1)               # (B,nc,H,P,N)

    # inter-chunk output: y_off[t] = C_t * decay_in[t] * state_prev
    decay_in = torch.exp(a_cum)                          # (B,nc,l,H)
    y_off = torch.einsum(
        "bctgn,bctgr,bcgrpn->bctgrp", cc,
        decay_in.reshape(bsz, nc, chunk, g, rep),
        prev_states.reshape(bsz, nc, g, rep, p, n)).reshape(
            bsz, nc, chunk, h, p)
    y = y_diag.reshape(bsz, nc, chunk, h, p) + y_off
    return y.reshape(bsz, s, h, p), carry


def _causal_conv(u: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                 tail: torch.Tensor | None = None):
    """Depthwise causal conv.  u (B,S,C), w (C,W), bias (C,).  Returns
    (out (B,S,C), new_tail (B,W-1,C)); the W shifted products are summed
    in order i = 0..W-1, in u's dtype."""
    width = w.shape[1]
    if tail is None:
        tail = torch.zeros((u.shape[0], width - 1, u.shape[2]),
                           dtype=u.dtype, device=u.device)
    up = torch.cat([tail, u], dim=1)
    out = sum(up[:, i:i + u.shape[1], :] * w[:, i][None, None, :]
              for i in range(width))
    new_tail = up[:, -(width - 1):, :] if width > 1 else tail
    return out + bias[None, None, :], new_tail


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bsd,dk->bsk", x, w)


def mamba2_mixer(x, p, cfg, *, cache=None):
    """One Mamba2 mixer.  x (B,S,d_model); ``p`` the layer's mixer leaves
    (plain tensors: a q8 leaf is dequantized by the caller's loop).

    cache: {"conv": {"x", "b", "c": (B,W-1,C)}, "state": (B,H,P,N) f32}.
    With S == 1 and a cache the step is the decode recurrence from the
    cache's state and tails (a 1-token prompt at prefill too, on a zeroed
    cache); otherwise the chunked scan from a zero state, the conv from the
    cache's tails.  The new state and tails are written into ``cache`` in
    place.  Returns (y (B,S,d_model), cache)."""
    bsz, s, _ = x.shape
    h, pdim, n, g = (cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state,
                     cfg.ssm_ngroups)
    d_in = cfg.d_inner

    z = _proj(x, p["w_z"])
    xr = _proj(x, p["w_x"])
    br = _proj(x, p["w_b"])
    cr = _proj(x, p["w_c"])
    dt_raw = _proj(x, p["w_dt"])                          # (B,S,H)

    tails = cache["conv"] if cache is not None else {"x": None, "b": None,
                                                     "c": None}
    xr, tx = _causal_conv(xr, p["conv_x_w"], p["conv_x_b"], tails["x"])
    br, tb = _causal_conv(br, p["conv_b_w"], p["conv_b_b"], tails["b"])
    cr, tc = _causal_conv(cr, p["conv_c_w"], p["conv_c_b"], tails["c"])
    xs = F.silu(xr).reshape(bsz, s, h, pdim)
    b_mat = F.silu(br).reshape(bsz, s, g, n)
    c_mat = F.silu(cr).reshape(bsz, s, g, n)

    dt = F.softplus(dt_raw + p["dt_bias"][None, None, :])  # (B,S,H) f32
    neg_a = -torch.exp(p["a_log"].to(torch.float32))        # (H,)
    a_log = dt * neg_a[None, None, :]

    f32 = torch.float32
    if cache is not None and s == 1:                      # decode step
        rep = h // g
        a1 = torch.exp(a_log[:, 0, :])                    # (B,H)
        bx = torch.einsum("bgn,bgrp,bgr->bgrpn", b_mat[:, 0].to(f32),
                          xs[:, 0].reshape(bsz, g, rep, pdim).to(f32),
                          dt[:, 0].reshape(bsz, g, rep)).reshape(
                              bsz, h, pdim, n)
        state = cache["state"] * a1[:, :, None, None] + bx
        y = torch.einsum("bgn,bgrpn->bgrp", c_mat[:, 0].to(f32),
                         state.reshape(bsz, g, rep, pdim, n)).reshape(
                             bsz, 1, h, pdim).to(x.dtype)
    else:
        xdt = xs * dt[..., None]                          # fold dt into x
        # front-pad to a chunk multiple: zero inputs with a zero initial
        # state contribute nothing, so this is exact (the final state too)
        pad = (-s) % cfg.ssm_chunk
        if pad:
            def fp(a):
                return F.pad(a, (0, 0) * (a.dim() - 2) + (pad, 0))
            xdt, a_log, b_mat, c_mat = map(fp, (xdt, a_log, b_mat, c_mat))
        y, state = ssd_chunked(xdt.to(f32), a_log, b_mat.to(f32),
                               c_mat.to(f32), cfg.ssm_chunk)
        y = y[:, pad:].to(x.dtype)
    if cache is not None:
        cache["state"].copy_(state)
        for key, t in (("x", tx), ("b", tb), ("c", tc)):
            cache["conv"][key].copy_(t)

    y = y + p["d_skip"][None, None, :, None] * xs
    y = y.reshape(bsz, s, d_in)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    return _proj(y, p["out_proj"]), cache
