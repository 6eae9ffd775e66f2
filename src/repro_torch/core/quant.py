"""Equidistant-grid quantizers: nearest level and the eq. (11) RD
assignment (the port's copy of ``nearest_level``, ``dequantize`` and
``rd_assign`` from ``repro.core.quant``; uniform and weighted-Lloyd wait).

These are the numpy f64 host oracles; ``kernels/rd_quant`` is the CUDA
version of :func:`rd_assign`'s assignment pass.
"""

from __future__ import annotations

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
