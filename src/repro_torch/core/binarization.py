"""DeepCABAC binarization (paper §III-B, Figs. 6–7); the port's copy of
``repro.core.binarization``, the temporal-context ``*_tc`` functions of the
delta ("P-frame") mode included.

Each quantized integer weight ``v`` is coded as:

    sigFlag | signFlag | AbsGr(1..n)Flags | ExpGolomb(|v| - n)
                                            ^ unary part: context-coded
                                            ^ fixed-length part: bypass

* ``sigFlag``  — v != 0.  Context selected by the significance of the
  *previous* weight in scan order (2 contexts) → captures the local
  clustering of zeros that lets CABAC code below the i.i.d. entropy.
* ``signFlag`` — v < 0 (1 context).
* ``AbsGr(j)`` — |v| > j for j = 1..n, context per j, stop at first 0.
* Remainder i = |v| - n >= 1 coded Exp-Golomb style (paper footnote 4):
  k = floor(log2 i) coded unary (k ones + terminating zero, context per
  position), then the k low bits of i - 2^k as bypass bins.

Worked examples from the paper (n = 1):
    1  -> 1 0 0            (sig=1, sign=+, Gr1=0)
    -4 -> 1 1 1 1 0 1      (sig, sign=-, Gr1, EG: k=1 -> '10', r=1 -> '1')
    7  -> 1 0 1 1 1 0 1 0  (sig, sign=+, Gr1, EG: k=2 -> '110', r=2 -> '10')

These exact vectors are asserted in tests/test_torch_codec.py.
"""

from __future__ import annotations

import numpy as np

from .cabac import TEMPORAL_CLASSES, ContextSet, RangeDecoder, RangeEncoder

DEFAULT_NUM_GR = 10   # paper appendix: "we set the AbsGr(n)-Flag to 10"
EG_CTXS = 24          # unary exponent positions with dedicated contexts

# Context layout ------------------------------------------------------------
CTX_SIG0 = 0          # sigFlag, previous weight was zero
CTX_SIG1 = 1          # sigFlag, previous weight was significant
CTX_SIGN = 2
CTX_GR_BASE = 3       # CTX_GR_BASE + (j-1), j = 1..n


def ctx_eg_base(num_gr: int) -> int:
    return CTX_GR_BASE + num_gr


def num_contexts(num_gr: int = DEFAULT_NUM_GR) -> int:
    return CTX_GR_BASE + num_gr + EG_CTXS


def make_contexts(num_gr: int = DEFAULT_NUM_GR) -> ContextSet:
    return ContextSet(num_contexts(num_gr))


def num_contexts_tc(num_gr: int = DEFAULT_NUM_GR) -> int:
    """Context count of the temporal-context (delta) mode: one full intra
    bank per temporal significance class of the co-located base level."""
    return TEMPORAL_CLASSES * num_contexts(num_gr)


def make_contexts_tc(num_gr: int = DEFAULT_NUM_GR) -> ContextSet:
    return ContextSet(num_contexts_tc(num_gr))


# ---------------------------------------------------------------------------
# Stream coding of integer tensors
# ---------------------------------------------------------------------------

def encode_levels(enc: RangeEncoder, levels: np.ndarray,
                  num_gr: int = DEFAULT_NUM_GR) -> None:
    """Encode a flat int array in scan order with the DeepCABAC binarization."""
    eg_base = ctx_eg_base(num_gr)
    eg_last = eg_base + EG_CTXS - 1
    encode_bin = enc.encode_bin
    encode_bypass_bits = enc.encode_bypass_bits
    prev_sig = 0
    for v in levels.tolist():
        if v == 0:
            encode_bin(prev_sig, 0)   # ctx CTX_SIG0/CTX_SIG1 == prev_sig
            prev_sig = 0
            continue
        encode_bin(prev_sig, 1)
        prev_sig = 1
        encode_bin(CTX_SIGN, 1 if v < 0 else 0)
        a = -v if v < 0 else v
        j = 1
        while j <= num_gr:
            gr = 1 if a > j else 0
            encode_bin(CTX_GR_BASE + j - 1, gr)
            if not gr:
                break
            j += 1
        if a > num_gr:
            i = a - num_gr                       # >= 1
            k = i.bit_length() - 1               # floor(log2 i)
            for pos in range(k):
                c = eg_base + pos
                encode_bin(c if c <= eg_last else eg_last, 1)
            c = eg_base + k
            encode_bin(c if c <= eg_last else eg_last, 0)
            if k:
                encode_bypass_bits(i - (1 << k), k)


def decode_levels(dec: RangeDecoder, count: int,
                  num_gr: int = DEFAULT_NUM_GR) -> np.ndarray:
    """Decode ``count`` integers (mirror of :func:`encode_levels`)."""
    eg_base = ctx_eg_base(num_gr)
    eg_last = eg_base + EG_CTXS - 1
    decode_bin = dec.decode_bin
    decode_bypass_bits = dec.decode_bypass_bits
    out = np.empty(count, dtype=np.int64)
    prev_sig = 0
    for idx in range(count):
        if not decode_bin(prev_sig):
            out[idx] = 0
            prev_sig = 0
            continue
        prev_sig = 1
        neg = decode_bin(CTX_SIGN)
        a = 1
        j = 1
        while j <= num_gr:
            if decode_bin(CTX_GR_BASE + j - 1):
                a = j + 1
                j += 1
            else:
                a = j
                break
        else:
            # all num_gr flags were 1 -> remainder follows
            k = 0
            while True:
                c = eg_base + k
                if not decode_bin(c if c <= eg_last else eg_last):
                    break
                k += 1
            i = 1 << k
            if k:
                i += decode_bypass_bits(k)
            a = num_gr + i
        out[idx] = -a if neg else a
    return out


# ---------------------------------------------------------------------------
# Temporal-context ("P-frame") stream coding
# ---------------------------------------------------------------------------
#
# Delta residuals reuse the intra binarization verbatim, but every context
# index is offset into one of TEMPORAL_CLASSES banks selected by the class
# of the co-located base-frame level (cabac.temporal_classes).  Bypass bins
# stay bypass; the within-lane prev_sig conditioning of the sigFlag is kept
# inside each bank, so the mode strictly refines the intra model.

def encode_levels_tc(enc: RangeEncoder, levels: np.ndarray, cls: np.ndarray,
                     num_gr: int = DEFAULT_NUM_GR) -> None:
    """Encode a flat int array with per-value temporal-class context banks.

    ``cls[idx]`` in ``[0, TEMPORAL_CLASSES)`` selects the bank for value
    ``idx``; ``enc`` must have been built with :func:`make_contexts_tc`.
    """
    base_nctx = num_contexts(num_gr)
    eg_base = ctx_eg_base(num_gr)
    eg_last = eg_base + EG_CTXS - 1
    encode_bin = enc.encode_bin
    encode_bypass_bits = enc.encode_bypass_bits
    cls_list = np.asarray(cls, dtype=np.int64).tolist()
    prev_sig = 0
    for idx, v in enumerate(levels.tolist()):
        off = cls_list[idx] * base_nctx
        if v == 0:
            encode_bin(off + prev_sig, 0)
            prev_sig = 0
            continue
        encode_bin(off + prev_sig, 1)
        prev_sig = 1
        encode_bin(off + CTX_SIGN, 1 if v < 0 else 0)
        a = -v if v < 0 else v
        j = 1
        while j <= num_gr:
            gr = 1 if a > j else 0
            encode_bin(off + CTX_GR_BASE + j - 1, gr)
            if not gr:
                break
            j += 1
        if a > num_gr:
            i = a - num_gr
            k = i.bit_length() - 1
            for pos in range(k):
                c = eg_base + pos
                encode_bin(off + (c if c <= eg_last else eg_last), 1)
            c = eg_base + k
            encode_bin(off + (c if c <= eg_last else eg_last), 0)
            if k:
                encode_bypass_bits(i - (1 << k), k)


def decode_levels_tc(dec: RangeDecoder, cls: np.ndarray,
                     num_gr: int = DEFAULT_NUM_GR) -> np.ndarray:
    """Decode ``len(cls)`` integers (mirror of :func:`encode_levels_tc`)."""
    base_nctx = num_contexts(num_gr)
    eg_base = ctx_eg_base(num_gr)
    eg_last = eg_base + EG_CTXS - 1
    decode_bin = dec.decode_bin
    decode_bypass_bits = dec.decode_bypass_bits
    cls_list = np.asarray(cls, dtype=np.int64).tolist()
    count = len(cls_list)
    out = np.empty(count, dtype=np.int64)
    prev_sig = 0
    for idx in range(count):
        off = cls_list[idx] * base_nctx
        if not decode_bin(off + prev_sig):
            out[idx] = 0
            prev_sig = 0
            continue
        prev_sig = 1
        neg = decode_bin(off + CTX_SIGN)
        a = 1
        j = 1
        while j <= num_gr:
            if decode_bin(off + CTX_GR_BASE + j - 1):
                a = j + 1
                j += 1
            else:
                a = j
                break
        else:
            k = 0
            while True:
                c = eg_base + k
                if not decode_bin(off + (c if c <= eg_last else eg_last)):
                    break
                k += 1
            i = 1 << k
            if k:
                i += decode_bypass_bits(k)
            a = num_gr + i
        out[idx] = -a if neg else a
    return out


# ---------------------------------------------------------------------------
# Vectorized bin expansion (for the rate model & analysis — no coder state)
# ---------------------------------------------------------------------------

def binarize_value(v: int, num_gr: int = DEFAULT_NUM_GR,
                   prev_sig: int = 0) -> list[tuple[int, int]]:
    """Return the (ctx, bit) sequence for one value. ctx == -1 -> bypass."""
    eg_base = ctx_eg_base(num_gr)
    eg_last = eg_base + EG_CTXS - 1
    if v == 0:
        return [(prev_sig, 0)]
    bins = [(prev_sig, 1), (CTX_SIGN, 1 if v < 0 else 0)]
    a = abs(v)
    for j in range(1, num_gr + 1):
        gr = 1 if a > j else 0
        bins.append((CTX_GR_BASE + j - 1, gr))
        if not gr:
            return bins
    i = a - num_gr
    k = i.bit_length() - 1
    for pos in range(k):
        bins.append((min(eg_base + pos, eg_last), 1))
    bins.append((min(eg_base + k, eg_last), 0))
    r = i - (1 << k)
    for shift in range(k - 1, -1, -1):
        bins.append((-1, (r >> shift) & 1))
    return bins


def expand_bins(levels: np.ndarray, num_gr: int = DEFAULT_NUM_GR
                ) -> tuple[np.ndarray, np.ndarray]:
    """(bits, ctx_ids) for a whole scan — used by the exact rate accountant."""
    bits: list[int] = []
    ctxs: list[int] = []
    prev_sig = 0
    for v in levels.tolist():
        for c, b in binarize_value(int(v), num_gr, prev_sig):
            ctxs.append(c)
            bits.append(b)
        prev_sig = 0 if v == 0 else 1
    return np.asarray(bits, dtype=np.int8), np.asarray(ctxs, dtype=np.int32)


def expand_bins_tc(levels: np.ndarray, cls: np.ndarray,
                   num_gr: int = DEFAULT_NUM_GR
                   ) -> tuple[np.ndarray, np.ndarray]:
    """(bits, ctx_ids) with temporal-class bank offsets applied to every
    context-coded bin (bypass bins keep ctx == -1).  Drives the lockstep
    numpy lane encoder of the delta mode."""
    base_nctx = num_contexts(num_gr)
    bits: list[int] = []
    ctxs: list[int] = []
    cls_list = np.asarray(cls, dtype=np.int64).tolist()
    prev_sig = 0
    for idx, v in enumerate(levels.tolist()):
        off = cls_list[idx] * base_nctx
        for c, b in binarize_value(int(v), num_gr, prev_sig):
            ctxs.append(c if c < 0 else c + off)
            bits.append(b)
        prev_sig = 0 if v == 0 else 1
    return np.asarray(bits, dtype=np.int8), np.asarray(ctxs, dtype=np.int32)
