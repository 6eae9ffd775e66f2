"""Quantizers: uniform (alg. 5), weighted Lloyd (alg. 4), RD assignment
(eq. 11) — the port's copy of ``repro.core.quant``.

All operate on flat float arrays and optional per-parameter importance
(Fisher / 1/sigma^2) weights.  These are the numpy f64 host oracles, equal
to the reference's bit for bit; ``kernels/rd_quant`` is the CUDA version
of :func:`rd_assign`'s assignment pass.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .rate_model import RateTable


def nearest_level(w: np.ndarray, step: float,
                  max_level: int | None = None) -> np.ndarray:
    lv = np.rint(np.asarray(w, dtype=np.float64) / step).astype(np.int64)
    if max_level is not None:
        lv = np.clip(lv, -max_level, max_level)
    return lv


def dequantize(levels: np.ndarray, step: float) -> np.ndarray:
    return np.asarray(levels, dtype=np.float64) * step


# ---------------------------------------------------------------------------
# Uniform quantization (paper alg. 5 / §V "uniform")
# ---------------------------------------------------------------------------

def uniform_centers(w: np.ndarray, k: int) -> np.ndarray:
    """K centers uniformly spread over the value range, snapped so that an
    exact zero center exists (preserves sparsity of pruned models)."""
    lo, hi = float(np.min(w)), float(np.max(w))
    centers = np.linspace(lo, hi, k)
    centers[np.argmin(np.abs(centers))] = 0.0
    return centers


def assign_nearest(w: np.ndarray, centers: np.ndarray,
                   importance: np.ndarray | None = None,
                   chunk: int = 1 << 16) -> np.ndarray:
    """Nearest-centre assignment (importance does not change the argmin for
    a plain distance, it is accepted for API symmetry with Lloyd)."""
    w = np.asarray(w, dtype=np.float64).ravel()
    out = np.empty(w.shape, dtype=np.int64)
    for s in range(0, w.size, chunk):
        blk = w[s:s + chunk]
        out[s:s + chunk] = np.argmin(
            (blk[:, None] - centers[None, :]) ** 2, axis=1)
    return out


def uniform_quantize(w: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Return (assignments, centers)."""
    centers = uniform_centers(w, k)
    return assign_nearest(w, centers), centers


# ---------------------------------------------------------------------------
# Weighted Lloyd (paper alg. 4)
# ---------------------------------------------------------------------------

@dataclass
class LloydResult:
    assignments: np.ndarray
    centers: np.ndarray
    probs: np.ndarray
    objective: list[float] = field(default_factory=list)


def weighted_lloyd(w: np.ndarray, importance: np.ndarray | None, k: int,
                   lam: float, iters: int = 30, tol: float = 1e-7,
                   chunk: int = 1 << 15, ensure_zero: bool = True,
                   seed: int = 0) -> LloydResult:
    w = np.asarray(w, dtype=np.float64).ravel()
    n = w.size
    f = (np.ones(n) if importance is None
         else np.asarray(importance, dtype=np.float64).ravel())
    rng = np.random.default_rng(seed)
    # init: quantile-spread centers (robust to heavy tails), plus exact zero
    qs = np.linspace(0.0, 1.0, k)
    centers = np.quantile(w, qs) + rng.normal(0, 1e-12, k)
    if ensure_zero:
        centers[np.argmin(np.abs(centers))] = 0.0
    probs = np.full(k, 1.0 / k)
    assignments = np.zeros(n, dtype=np.int64)
    history: list[float] = []
    prev_obj = np.inf
    for _ in range(iters):
        rate_pen = -lam * np.log2(np.maximum(probs, 1e-12))
        obj = 0.0
        for s in range(0, n, chunk):
            blk_w = w[s:s + chunk]
            blk_f = f[s:s + chunk]
            cost = blk_f[:, None] * (blk_w[:, None] - centers[None, :]) ** 2 \
                + rate_pen[None, :]
            a = np.argmin(cost, axis=1)
            assignments[s:s + chunk] = a
            obj += float(cost[np.arange(a.size), a].sum())
        history.append(obj)
        # update step
        counts = np.bincount(assignments, minlength=k).astype(np.float64)
        fw = np.bincount(assignments, weights=f * w, minlength=k)
        fs = np.bincount(assignments, weights=f, minlength=k)
        nonempty = fs > 0
        centers = np.where(nonempty, fw / np.maximum(fs, 1e-30), centers)
        probs = np.maximum(counts, 1e-12) / n
        if ensure_zero:
            centers[np.argmin(counts)] = 0.0   # alg.4 lines 14-16
        if prev_obj - obj <= tol * max(abs(prev_obj), 1.0):
            break
        prev_obj = obj
    return LloydResult(assignments=assignments, centers=centers, probs=probs,
                       objective=history)


# ---------------------------------------------------------------------------
# RD assignment on the equidistant grid (paper eq. 11)
# ---------------------------------------------------------------------------

def rd_assign(w: np.ndarray, importance: np.ndarray | None, step: float,
              lam: float, table: RateTable, window: int = 4,
              max_level: int | None = None, passes: int = 2) -> np.ndarray:
    """argmin_k F_i (w_i - Delta k)^2 + lam * L[prev_sig, k].

    Candidates are the nearest-neighbour level +- window plus level 0 (at
    large lambda the optimum for big weights jumps straight to zero, far
    outside any local window).  prev_sig (the significance of the
    previously *assigned* level) makes the exact problem sequential; the
    vectorized fixed-point iteration seeds it from the nearest-neighbour
    assignment and re-derives it from each pass.
    """
    w = np.asarray(w, dtype=np.float64).ravel()
    n = w.size
    f = (np.ones(n) if importance is None
         else np.asarray(importance, dtype=np.float64).ravel())
    if max_level is None:
        max_level = table.max_level
    nn = nearest_level(w, step, max_level)
    offsets = np.arange(-window, window + 1)
    cand = np.clip(nn[:, None] + offsets[None, :], -max_level, max_level)
    cand = np.concatenate([cand, np.zeros((n, 1), dtype=cand.dtype)], axis=1)
    dist = f[:, None] * (w[:, None] - step * cand) ** 2

    levels = nn
    for _ in range(max(passes, 1)):
        sig = levels != 0
        prev_sig = np.concatenate([[False], sig[:-1]]).astype(np.int64)
        idx = cand + table.max_level
        rate = table.bits[prev_sig[:, None], idx]
        cost = dist + lam * rate
        levels = cand[np.arange(n), np.argmin(cost, axis=1)]
    return levels
