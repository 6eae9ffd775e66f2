"""The paper's quantize step on the host (the port's copy of
``quantize_tensor_rd`` from ``repro.core.deepcabac``; the DC-v1/v2
search pipelines wait)."""

from __future__ import annotations

import numpy as np

from . import binarization as B
from .codec import QuantizedTensor
from .quant import nearest_level, rd_assign
from .rate_model import build_rate_table, estimate_bin_probs


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
