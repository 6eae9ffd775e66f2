"""Rate-model coefficient packing shared by the kernel and its plain
version (the port's copy of ``repro.kernels.rd_quant.coeffs``).

The CABAC rate of a level k decomposes into

    k == 0 : l0_sig[ps]
    k != 0 : l1_sig[ps] + (l_neg | l_pos) + mag_rate[class(|k|)]

with a "magnitude class" that is |k|-1 for |k| <= num_gr and
num_gr + floor(log2(|k| - num_gr)) beyond (the Exp-Golomb exponent).  The
class table folds the AbsGr cumulative costs, the unary exponent costs,
the context cap and the k bypass bits into one f32 entry per class.
"""

from __future__ import annotations

import numpy as np

from ...core.binarization import EG_CTXS
from ...core.rate_model import BinProbs

NUM_SCALARS = 8  # l0_sig0, l0_sig1, l1_sig0, l1_sig1, l_neg, l_pos, pad, pad
EG_CLASSES = 32
SC_L0_SIG0, SC_L0_SIG1, SC_L1_SIG0, SC_L1_SIG1, SC_LNEG, SC_LPOS = range(6)


def num_classes(num_gr: int) -> int:
    return num_gr + EG_CLASSES


def pack_coeffs(probs: BinProbs) -> tuple[np.ndarray, np.ndarray]:
    """Return (scalars (1, NUM_SCALARS) f32, mag_rate (1, classes) f32)."""
    num_gr = probs.num_gr
    scalars = np.zeros(NUM_SCALARS, dtype=np.float64)
    scalars[SC_L0_SIG0] = -np.log2(1.0 - probs.p_sig[0])
    scalars[SC_L0_SIG1] = -np.log2(1.0 - probs.p_sig[1])
    scalars[SC_L1_SIG0] = -np.log2(probs.p_sig[0])
    scalars[SC_L1_SIG1] = -np.log2(probs.p_sig[1])
    scalars[SC_LNEG] = -np.log2(probs.p_sign)
    scalars[SC_LPOS] = -np.log2(1.0 - probs.p_sign)

    cum_gr1 = np.concatenate([[0.0], np.cumsum(-np.log2(probs.p_gr))])
    l0_gr = -np.log2(1.0 - probs.p_gr)
    cum_eg1 = np.concatenate([[0.0], np.cumsum(-np.log2(probs.p_eg))])
    l0_eg = -np.log2(1.0 - probs.p_eg)
    l1_eg_last = -np.log2(probs.p_eg[-1])

    mag = np.zeros(num_classes(num_gr), dtype=np.float64)
    for a in range(1, num_gr + 1):                      # |k| <= num_gr
        mag[a - 1] = cum_gr1[a - 1] + l0_gr[a - 1]
    for k_exp in range(EG_CLASSES):                     # |k| > num_gr
        kk = min(k_exp, EG_CTXS - 1)
        mag[num_gr + k_exp] = (cum_gr1[num_gr] + cum_eg1[kk]
                               + (k_exp - kk) * l1_eg_last + l0_eg[kk]
                               + k_exp)                 # + bypass bits
    return (scalars[None, :].astype(np.float32),
            mag[None, :].astype(np.float32))
