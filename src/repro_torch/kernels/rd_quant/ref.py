"""Plain PyTorch version of the eq. (11) RD assignment pass (the port's
counterpart of ``repro.kernels.rd_quant.ref``).

It computes in f32, one IEEE-rounded operation at a time, in the jnp
reference's order: ``nn = clip(round(w / step))``; per candidate
``dist = F * (w - step * k)^2`` and ``cost = dist + lam * rate`` with
``rate = (l1 + sign) + mag`` (or ``l0`` for k = 0); the first strict
minimum wins.  Divisions and products by step and lambda take 0-d tensors
on the weight's device: PyTorch's CUDA kernel turns a division by a
Python scalar into a product with its reciprocal.  Work runs in chunks
of ``CHUNK`` elements, so the card holds a few f32 temporaries of that
size, not of the whole tensor.
"""

from __future__ import annotations

import numpy as np
import torch

from .coeffs import (SC_L0_SIG0, SC_L0_SIG1, SC_L1_SIG0, SC_L1_SIG1, SC_LNEG,
                     SC_LPOS)

CHUNK = 1 << 24


def floor_log2(i: torch.Tensor) -> torch.Tensor:
    """floor(log2(i)) of integer-valued f32 i >= 1 from the IEEE exponent
    field (exact for i < 2^24)."""
    return ((i.view(torch.int32) >> 23) & 0xFF) - 127


def level_rate(k: torch.Tensor, ps: torch.Tensor, scalars: torch.Tensor,
               mag: torch.Tensor, num_gr: int) -> torch.Tensor:
    """Bits to code the integer-valued f32 levels ``k`` after a level of
    significance ``ps`` (bool).  A magnitude class outside the table costs
    0, as the reference's one-hot sum does."""
    l0 = torch.where(ps, scalars[SC_L0_SIG1], scalars[SC_L0_SIG0])
    l1 = torch.where(ps, scalars[SC_L1_SIG1], scalars[SC_L1_SIG0])
    a = torch.abs(k)
    small = a <= num_gr
    cls_small = torch.clamp_min(a - 1.0, 0.0)
    i = torch.clamp_min(a - num_gr, 1.0)
    cls_big = num_gr + floor_log2(i).to(torch.float32)
    cls = torch.where(small, cls_small, cls_big).to(torch.int64)
    nc = mag.numel()
    table = torch.cat([mag, mag.new_zeros(1)])
    m = table[torch.where((cls >= 0) & (cls < nc), cls, nc)]
    sign_cost = torch.where(k < 0, scalars[SC_LNEG], scalars[SC_LPOS])
    return torch.where(a == 0, l0, (l1 + sign_cost) + m)


def nearest_f32(w: torch.Tensor, step_t: torch.Tensor,
                max_level: float) -> torch.Tensor:
    return torch.clamp(torch.round(w.to(torch.float32) / step_t),
                       -max_level, max_level)


def rd_quant_pass_ref(w: torch.Tensor, f: torch.Tensor | None,
                      ps: torch.Tensor, scalars: torch.Tensor,
                      mag: torch.Tensor, *, step_t: torch.Tensor,
                      lam_t: torch.Tensor, window: int, max_level: float,
                      num_gr: int) -> torch.Tensor:
    """One assignment pass over aligned flat ``w`` / ``f`` / ``ps``:
    argmin over k in {clip(nn + d) : |d| <= window} and {0} of
    ``F (w - step k)^2 + lam rate(k, ps)``; int32 levels."""
    w = w.to(torch.float32)
    nn = nearest_f32(w, step_t, max_level)
    best_cost = torch.full_like(w, float("inf"))
    best_k = nn
    for d in list(range(-window, window + 1)) + [None]:
        k = (torch.clamp(nn + d, -max_level, max_level) if d is not None
             else torch.zeros_like(nn))
        dist = torch.square(w - step_t * k)
        if f is not None:
            dist = f * dist
        cost = dist + lam_t * level_rate(k, ps, scalars, mag, num_gr)
        better = cost < best_cost
        best_cost = torch.where(better, cost, best_cost)
        best_k = torch.where(better, k, best_k)
    return best_k.to(torch.int32)


def rd_quant_ref(w: torch.Tensor, fisher: torch.Tensor | None,
                 scalars: np.ndarray, mag: np.ndarray, *, step: float,
                 lam: float, window: int, max_level: int, num_gr: int,
                 passes: int) -> torch.Tensor:
    """``passes`` assignment passes over flat ``w`` (f32 or bf16); pass 1
    takes prev_sig from the f32 nearest level, each later pass from the
    previous pass's levels.  Returns flat int32 levels on ``w``'s device."""
    dev = w.device
    flat = w.reshape(-1)
    fl = None if fisher is None else fisher.reshape(-1).to(torch.float32)
    n = flat.numel()
    step_t = torch.tensor(step, dtype=torch.float32, device=dev)
    lam_t = torch.tensor(lam, dtype=torch.float32, device=dev)
    sc = torch.from_numpy(np.asarray(scalars, np.float32).reshape(-1)).to(dev)
    mg = torch.from_numpy(np.asarray(mag, np.float32).reshape(-1)).to(dev)
    ml = float(max_level)
    prev = None
    for _ in range(max(passes, 1)):
        out = torch.empty(n, dtype=torch.int32, device=dev)
        for s in range(0, n, CHUNK):
            e = min(n, s + CHUNK)
            lo = max(s - 1, 0)
            src = (nearest_f32(flat[lo:e - 1], step_t, ml) if prev is None
                   else prev[lo:e - 1])
            sig = src != 0
            if s == 0:
                sig = torch.cat([sig.new_zeros(1), sig])
            out[s:e] = rd_quant_pass_ref(
                flat[s:e], None if fl is None else fl[s:e], sig, sc, mg,
                step_t=step_t, lam_t=lam_t, window=window, max_level=ml,
                num_gr=num_gr)
        prev = out
    return prev if prev is not None else torch.empty(0, dtype=torch.int32)
