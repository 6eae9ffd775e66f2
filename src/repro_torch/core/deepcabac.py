"""DeepCABAC top-level pipelines: DC-v1 and DC-v2 (paper §III, Fig. 5),
the port's copy of ``repro.core.deepcabac``.

Pipeline per Fig. 5:  scan weights layer-by-layer (row-major) -> pick a
hyperparameter beta = (Delta, lambda) -> RD-quantize (eq. 11) -> CABAC-code ->
reconstruct & evaluate -> repeat over the hyperparameter grid until the
desired accuracy-vs-size trade-off.

DC-v1 (eq. 12): per-layer step size from sigma_min and w_max with global
coarseness S; importance F_i = 1/sigma_i^2.
DC-v2: global Delta grid (bracketed by a nearest-neighbour screening round),
F_i = 1.

Both quantize with the f64 host oracle (:func:`quantize_tensor_rd`), as the
reference does, so their containers equal the reference's byte for byte
wherever the weights lie; the oracle builds (n, 2 * window + 2) f64
arrays, so these pipelines suit models of smoke size.  Parameters are
flat dicts or trees of tensors on any device (or numpy arrays); an
``eval_fn`` receives the reconstructed flat dict (CPU tensors for the
quantized entries, the raw leaves as given) and returns a metric, higher
is better.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from ..arrays import dtype_name
from ..compression.artifact import Artifact
from ..compression.quantizers import host_f64
from . import binarization as B
from .codec import QuantizedTensor
from .quant import nearest_level, rd_assign
from .rate_model import build_rate_table, estimate_bin_probs

QUANT_MIN_NDIM = 2   # 1-D tensors (biases/norms) stay raw, as in the paper


def _host(x) -> np.ndarray:
    """A host numpy array of ``x`` in its own dtype (a torch tensor on any
    device, or an array; numpy has no bf16)."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def dc_v1_step_size(w_max: float, sigma_min: float, s: float) -> float:
    """Paper eq. (12): Delta = 2|w_max| / (2|w_max|/sigma_min + S)."""
    w_max = abs(float(w_max))
    if w_max == 0.0:
        return 1.0
    return 2.0 * w_max / (2.0 * w_max / max(sigma_min, 1e-12) + s)


def quantize_tensor_rd(w: np.ndarray, step: float, lam: float,
                       importance: np.ndarray | None = None,
                       num_gr: int = B.DEFAULT_NUM_GR, window: int = 4,
                       passes: int = 2, table_refinements: int = 1,
                       dtype: str | None = None) -> QuantizedTensor:
    """NN seed -> context statistics -> rate table -> RD assignment, with
    the statistics re-estimated from the assigned levels
    ``table_refinements`` times.  ``w`` is a host array (f64, or any dtype
    numpy holds); ``dtype`` names the reconstruction dtype (default
    ``w``'s, which is how a bf16 tensor, carried as f64, keeps its name).
    """
    flat = np.asarray(w, dtype=np.float64).ravel()
    nn = nearest_level(flat, step)
    max_level = int(np.abs(nn).max()) + window + 1
    fl = None if importance is None else np.asarray(importance).ravel()
    levels = nn
    for _ in range(1 + max(table_refinements, 0)):
        table = build_rate_table(estimate_bin_probs(levels, num_gr),
                                 max_level)
        levels = rd_assign(flat, fl, step, lam, table, window=window,
                           max_level=max_level, passes=passes)
    return QuantizedTensor(levels=levels.reshape(np.shape(w)), step=step,
                           dtype=dtype or str(np.asarray(w).dtype))


class CompressionResult(Artifact):
    """DC-v1/v2 result — the shared :class:`Artifact` under its historical
    name (blob + report + quantized entries)."""


def compress_dc_v2(params, delta: float, lam: float,
                   num_gr: int = B.DEFAULT_NUM_GR) -> CompressionResult:
    """One (Delta, lambda) point of DC-v2 (F_i = 1, global step)."""
    from ..compression import get
    art = get("deepcabac-v2", delta=delta, lam=lam, num_gr=num_gr,
              min_ndim=QUANT_MIN_NDIM).compress(params)
    return CompressionResult(
        blob=art.blob, report=art.report,
        hyperparams={"method": "dc-v2", "delta": delta, "lam": lam,
                     "codec": "deepcabac-v2"},
        quantized=art.quantized)


def compress_dc_v1(params, sigma, s: float, lam: float,
                   num_gr: int = B.DEFAULT_NUM_GR) -> CompressionResult:
    """One (S, lambda) point of DC-v1: per-layer Delta via eq. 12,
    F_i = 1/sigma_i^2 (computed in sigma's dtype, as the reference
    does)."""
    from ..compression import (CabacCoder, Codec, RDGridQuantizer,
                               flatten_tree, ndim_float_policy)
    flat_sigma = {k: _host(v) for k, v in flatten_tree(sigma).items()}

    def step_for(name, w):
        return dc_v1_step_size(float(abs(w).max()),
                               float(np.min(flat_sigma[name])), s)

    importance = {k: 1.0 / (v ** 2 + 1e-24) for k, v in flat_sigma.items()}
    codec = Codec("deepcabac-v1",
                  coder=CabacCoder(num_gr=num_gr),
                  quantizer=RDGridQuantizer(lam=lam, num_gr=num_gr,
                                            step_for=step_for,
                                            importance=importance),
                  policy=ndim_float_policy(QUANT_MIN_NDIM))
    art = codec.compress(params)
    return CompressionResult(
        blob=art.blob, report=art.report,
        hyperparams={"method": "dc-v1", "S": s, "lam": lam,
                     "codec": "deepcabac-v1"},
        quantized=art.quantized)


# ---------------------------------------------------------------------------
# Grid-search drivers (paper Fig. 5 step 6 + appendix D/E)
# ---------------------------------------------------------------------------

def default_lambda_grid(num: int = 12) -> np.ndarray:
    """Log-spaced lambdas as in appendix D (coarsened for practicality)."""
    return 1e-4 * 2.0 ** (np.log2(1e2) * np.arange(num) / num)


def default_s_grid() -> list[float]:
    return [0.0, 8.0, 16.0, 32.0, 64.0, 96.0, 128.0, 160.0, 192.0, 256.0]


def screen_deltas_nn(params: dict, eval_fn: Callable, acc_floor: float,
                     deltas: np.ndarray) -> np.ndarray:
    """DC-v2 round 1: nearest-neighbour (lambda = 0) screening to find the
    usable step-size range (paper §III-C-4)."""
    keep = []
    for d in deltas:
        rec = {}
        for name, w in params.items():
            if w.ndim < QUANT_MIN_NDIM:
                rec[name] = w
            else:
                wf = host_f64(w)
                lv = nearest_level(wf.ravel(), d).reshape(wf.shape)
                rec[name] = QuantizedTensor(
                    lv, d, dtype_name(w.dtype)).dequantize()
        if eval_fn(rec) >= acc_floor:
            keep.append(d)
    return np.asarray(keep if keep else [float(deltas[0])])


def search_dc_v2(params: dict, eval_fn: Callable, orig_metric: float,
                 tol: float = 0.005, deltas: np.ndarray | None = None,
                 lambdas: np.ndarray | None = None,
                 num_gr: int = B.DEFAULT_NUM_GR) -> CompressionResult:
    """Smallest blob whose eval metric stays within ``tol`` of the original
    (``eval_fn(flat dict) -> metric``, higher is better)."""
    if deltas is None:
        deltas = 0.001 * 2.0 ** (np.log2(0.15 / 0.001) * np.arange(12) / 12)
    if lambdas is None:
        lambdas = np.concatenate([[0.0], default_lambda_grid(6)])
    floor = orig_metric - tol
    usable = screen_deltas_nn(params, eval_fn, floor, deltas)
    best: CompressionResult | None = None
    # largest usable deltas compress most; search top few with all lambdas
    for d in sorted(usable.tolist(), reverse=True)[:4]:
        for lam in lambdas:
            res = compress_dc_v2(params, d, float(lam), num_gr)
            if eval_fn(res.reconstructed()) >= floor:
                if best is None or len(res.blob) < len(best.blob):
                    best = res
    if best is None:   # fall back to the finest screening point
        best = compress_dc_v2(params, float(np.min(deltas)), 0.0, num_gr)
    return best


def search_dc_v1(params: dict, sigma: dict, eval_fn: Callable,
                 orig_metric: float, tol: float = 0.005,
                 s_grid: list[float] | None = None,
                 lambdas: np.ndarray | None = None,
                 num_gr: int = B.DEFAULT_NUM_GR) -> CompressionResult:
    """DC-v1's grid over (S, lambda): the smallest blob within ``tol``."""
    if s_grid is None:
        s_grid = default_s_grid()
    if lambdas is None:
        lambdas = np.concatenate([[0.0], default_lambda_grid(6)])
    floor = orig_metric - tol
    best: CompressionResult | None = None
    for s in s_grid:
        for lam in lambdas:
            res = compress_dc_v1(params, sigma, s, float(lam), num_gr)
            if eval_fn(res.reconstructed()) >= floor:
                if best is None or len(res.blob) < len(best.blob):
                    best = res
    if best is None:
        best = compress_dc_v1(params, sigma, s_grid[-1], 0.0, num_gr)
    return best
