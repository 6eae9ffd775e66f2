"""Vectorized CABAC code-length model for RD quantization (paper eq. 11);
the port's copy of ``repro.core.rate_model``.

The RD assignment needs L_ik — the number of bits CABAC would spend on coding
level k at position i.  Running the sequential coder inside the quantizer
would serialize the whole operation, so DeepCABAC-style systems estimate the
rate from *static per-context probabilities* gathered in a vectorized first
pass (a provisional nearest-neighbour quantization), optionally iterating
assignment → statistics → assignment.

The numpy functions are the reference's.  The ``*_torch`` functions run
where the levels are (on the card for the ``rd_quant`` kernel's refinement
loop, so a large level tensor never comes to the host between passes):
they count bins by integer sums, which are exact in any order, and hand
the counts to the same f64 ``_smooth`` on the host, so their
:class:`BinProbs` equal the numpy version's bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .binarization import DEFAULT_NUM_GR, EG_CTXS

_EPS_P = 1.0 / 4096.0


@dataclass
class BinProbs:
    """Static per-context P(bin == 1) estimates."""

    p_sig: np.ndarray    # shape (2,): P(sig==1 | prev_sig)
    p_sign: float        # P(negative | significant)
    p_gr: np.ndarray     # shape (num_gr,): P(AbsGr(j)==1 | emitted), j=1..n
    p_eg: np.ndarray     # shape (EG_CTXS,): P(unary bit==1 | emitted)
    num_gr: int


def _smooth(ones: np.ndarray | float, total: np.ndarray | float) -> np.ndarray:
    p = (np.asarray(ones, dtype=np.float64) + 0.5) / (
        np.asarray(total, dtype=np.float64) + 1.0)
    return np.clip(p, _EPS_P, 1.0 - _EPS_P)


def estimate_bin_probs(levels: np.ndarray,
                       num_gr: int = DEFAULT_NUM_GR) -> BinProbs:
    """Gather per-context statistics from a provisional level assignment."""
    v = np.asarray(levels).astype(np.int64).ravel()
    sig = v != 0
    prev_sig = np.concatenate([[False], sig[:-1]])

    sig_tot = np.array([np.sum(~prev_sig), np.sum(prev_sig)], dtype=np.float64)
    sig_one = np.array([np.sum(sig & ~prev_sig), np.sum(sig & prev_sig)],
                       dtype=np.float64)
    p_sig = _smooth(sig_one, sig_tot)

    a = np.abs(v[sig])
    p_sign = float(_smooth(np.sum(v < 0), a.size))

    js = np.arange(1, num_gr + 1)[:, None]
    emitted = a[None, :] >= js               # flag j emitted iff a >= j
    ones = a[None, :] > js
    p_gr = _smooth(ones.sum(axis=1), emitted.sum(axis=1))

    rem = a[a > num_gr] - num_gr             # i >= 1
    if rem.size:
        k = np.floor(np.log2(rem)).astype(np.int64)
        pos = np.arange(EG_CTXS)[:, None]
        kk = np.minimum(k, EG_CTXS - 1)      # cap positions at the last ctx
        emitted_eg = kk[None, :] >= pos
        ones_eg = kk[None, :] > pos
        p_eg = _smooth(ones_eg.sum(axis=1), emitted_eg.sum(axis=1))
    else:
        p_eg = np.full(EG_CTXS, 0.5)
    return BinProbs(p_sig=p_sig, p_sign=p_sign, p_gr=np.asarray(p_gr),
                    p_eg=np.asarray(p_eg), num_gr=num_gr)


def level_rates(vs: np.ndarray, probs: BinProbs, prev_sig: int) -> np.ndarray:
    """Bits to code each (signed integer) level in ``vs`` — fully vectorized.

    Closed-form decomposition of the binarization using cumulative context
    cost tables; O(1) per element.
    """
    v = np.asarray(vs, dtype=np.int64)
    num_gr = probs.num_gr
    l1_sig = -np.log2(probs.p_sig[prev_sig])
    l0_sig = -np.log2(1.0 - probs.p_sig[prev_sig])
    l_neg = -np.log2(probs.p_sign)
    l_pos = -np.log2(1.0 - probs.p_sign)

    cum_gr1 = np.concatenate([[0.0], np.cumsum(-np.log2(probs.p_gr))])
    l0_gr = -np.log2(1.0 - probs.p_gr)
    cum_eg1 = np.concatenate([[0.0], np.cumsum(-np.log2(probs.p_eg))])
    l0_eg = -np.log2(1.0 - probs.p_eg)

    out = np.empty(v.shape, dtype=np.float64)
    zero = v == 0
    out[zero] = l0_sig

    nz = ~zero
    a = np.abs(v[nz])
    r = np.full(a.shape, l1_sig)
    r += np.where(v[nz] < 0, l_neg, l_pos)

    small = a <= num_gr
    a_s = a[small]
    r_small = cum_gr1[a_s - 1] + l0_gr[a_s - 1]
    big = ~small
    a_b = a[big]
    i = a_b - num_gr
    k = np.floor(np.log2(i)).astype(np.int64)
    kk = np.minimum(k, EG_CTXS - 1)
    r_big = cum_gr1[num_gr] + cum_eg1[kk] + (k - kk) * (-np.log2(
        probs.p_eg[-1])) + l0_eg[kk] + k  # + k bypass bits
    tmp = np.empty(a.shape, dtype=np.float64)
    tmp[small] = r_small
    tmp[big] = r_big
    out[nz] = r + tmp
    return out


@dataclass
class RateTable:
    """Rate lookup L[prev_sig, level + max_level] in bits."""

    bits: np.ndarray      # (2, 2*max_level+1) float32
    max_level: int


def build_rate_table(probs: BinProbs, max_level: int) -> RateTable:
    vs = np.arange(-max_level, max_level + 1)
    bits = np.stack([level_rates(vs, probs, 0), level_rates(vs, probs, 1)])
    return RateTable(bits=bits.astype(np.float32), max_level=max_level)


def estimate_level_bits(levels: np.ndarray,
                        num_gr: int = DEFAULT_NUM_GR) -> float:
    """Total bits the static-context model assigns to its own assignment.

    Self-entropy of ``levels`` under per-context probabilities estimated
    from those same levels, with the true per-element prev_sig context —
    the scan-free rate proxy the RD search uses to score per-tensor
    operating points without running the sequential coder.  Tracks the
    actual CABAC stream to within the adaptation overhead (small for the
    >= thousands-of-values tensors the search touches).
    """
    v = np.asarray(levels).astype(np.int64).ravel()
    if v.size == 0:
        return 0.0
    probs = estimate_bin_probs(v, num_gr)
    sig = v != 0
    prev = np.concatenate([[False], sig[:-1]])
    r0 = level_rates(v, probs, 0)
    r1 = level_rates(v, probs, 1)
    return float(np.where(prev, r1, r0).sum())


# ---------------------------------------------------------------------------
# Device-side statistics (integer counts where the levels live)
# ---------------------------------------------------------------------------

STATS_CHUNK = 1 << 27      # elements per pass over a large level tensor


def _suffix_sums(hist: list[int]) -> list[int]:
    out, acc = [0] * len(hist), 0
    for i in range(len(hist) - 1, -1, -1):
        acc += hist[i]
        out[i] = acc
    return out


def estimate_bin_probs_torch(levels: torch.Tensor,
                             num_gr: int = DEFAULT_NUM_GR) -> BinProbs:
    """:func:`estimate_bin_probs` of an integer tensor on its own device.
    Bins are counted in chunks (the previous chunk's last significance
    carries over); only the counts come to the host."""
    v = levels.reshape(-1)
    dev = v.device
    n = v.numel()
    z = torch.zeros((), dtype=torch.int64, device=dev)
    prev_sig_n, sig_prev_n, sig_n, neg_n, rem_n = z, z, z, z, z
    gr_hist = torch.zeros(num_gr + 2, dtype=torch.int64, device=dev)
    eg_hist = torch.zeros(EG_CTXS, dtype=torch.int64, device=dev)
    carry = torch.zeros(1, dtype=torch.bool, device=dev)
    for s in range(0, n, STATS_CHUNK):
        blk = v[s:s + STATS_CHUNK]
        sig = blk != 0
        prev = torch.cat([carry, sig[:-1]])
        carry = sig[-1:]
        prev_sig_n = prev_sig_n + prev.sum()
        sig_prev_n = sig_prev_n + (sig & prev).sum()
        sig_n = sig_n + sig.sum()
        neg_n = neg_n + (blk < 0).sum()
        a = blk.abs().to(torch.int64)
        gr_hist += torch.bincount(a.clamp(max=num_gr + 1),
                                  minlength=num_gr + 2)
        rem = a[a > num_gr] - num_gr                 # i >= 1
        rem_n = rem_n + rem.numel()
        if rem.numel():
            k = torch.frexp(rem.to(torch.float64))[1].to(torch.int64) - 1
            eg_hist += torch.bincount(k.clamp(max=EG_CTXS - 1),
                                      minlength=EG_CTXS)
    prev_sig_n, sig_prev_n, sig_n, neg_n, rem_n = (
        int(t) for t in (prev_sig_n, sig_prev_n, sig_n, neg_n, rem_n))
    sig_tot = np.array([n - prev_sig_n, prev_sig_n], dtype=np.float64)
    sig_one = np.array([sig_n - sig_prev_n, sig_prev_n], dtype=np.float64)
    p_sig = _smooth(sig_one, sig_tot)
    p_sign = float(_smooth(neg_n, sig_n))
    ge = _suffix_sums(gr_hist.tolist())           # ge[j] = #(|v| >= j)
    p_gr = _smooth(np.array(ge[2:num_gr + 2]), np.array(ge[1:num_gr + 1]))
    if rem_n:
        ge_eg = _suffix_sums(eg_hist.tolist()) + [0]
        p_eg = _smooth(np.array(ge_eg[1:EG_CTXS + 1]),
                       np.array(ge_eg[:EG_CTXS]))
    else:
        p_eg = np.full(EG_CTXS, 0.5)
    return BinProbs(p_sig=p_sig, p_sign=p_sign, p_gr=np.asarray(p_gr),
                    p_eg=np.asarray(p_eg), num_gr=num_gr)


def estimate_level_bits_torch(levels: torch.Tensor,
                              num_gr: int = DEFAULT_NUM_GR) -> float:
    """:func:`estimate_level_bits` of a tensor on its own device: a joint
    (prev_sig, level) histogram is counted there and weighted on the host
    by :func:`level_rates` in f64 (the sum runs in another order than the
    numpy version's, so the two agree to f64 rounding, not bit for bit)."""
    v = levels.reshape(-1)
    n = v.numel()
    if n == 0:
        return 0.0
    probs = estimate_bin_probs_torch(v, num_gr)
    ml = int(v.abs().max())
    width = 2 * ml + 1
    hist = torch.zeros(2 * width, dtype=torch.int64, device=v.device)
    carry = torch.zeros(1, dtype=torch.int64, device=v.device)
    for s in range(0, n, STATS_CHUNK):
        blk = v[s:s + STATS_CHUNK].to(torch.int64)
        sig = (blk != 0).to(torch.int64)
        prev = torch.cat([carry, sig[:-1]])
        carry = sig[-1:]
        hist += torch.bincount(blk + ml + prev * width, minlength=2 * width)
    counts = hist.cpu().numpy().reshape(2, width).astype(np.float64)
    vs = np.arange(-ml, ml + 1)
    return float(counts[0] @ level_rates(vs, probs, 0)
                 + counts[1] @ level_rates(vs, probs, 1))
