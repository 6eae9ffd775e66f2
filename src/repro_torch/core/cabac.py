"""Adaptive binary range coder with context models (the CABAC engine); the
port's copy of ``repro.core.cabac``, temporal context classes of the delta
("P-frame") mode included.

This is the lossless entropy-coding engine of DeepCABAC (paper §II-B, §III-B).
It is an *exact* binary arithmetic coder: ``decode(encode(bits)) == bits``
always, for any adaptation trajectory.

Design notes
------------
* H.264/AVC CABAC proper uses the table-driven, multiplication-free M-coder
  for hardware friendliness.  On a host CPU we use the multiplicative range
  coder (LZMA-style 64-bit low / 32-bit range with carry propagation), which
  is rate-equivalent to within a fraction of a percent and much simpler to
  verify.  The *context modelling* — the part that matters for compression —
  follows CABAC: per-bin adaptive binary probability states with exponential
  decay updates, plus uncontexted "bypass" bins for near-uniform bits.
* Probabilities are 12-bit (``PROB_BITS``); adaptation shift 5 gives a decay
  rate close to CABAC's 0.95 alpha.
* The coder is host-side by design: the bin-by-bin interval subdivision is
  inherently sequential.  Parallelism comes from
  chunking at the container layer (codec.py), never from inside a stream.
"""

from __future__ import annotations

import numpy as np

PROB_BITS = 12
PROB_ONE = 1 << PROB_BITS          # 4096
PROB_HALF = PROB_ONE >> 1          # 2048
PROB_MIN = 16                      # keep contexts away from 0/1 (stability)
PROB_MAX = PROB_ONE - PROB_MIN
ADAPT_SHIFT = 5                    # CABAC-like adaptation speed
TOP = 1 << 24
MASK32 = 0xFFFFFFFF


class ContextSet:
    """A bank of adaptive binary probability models.

    ``probs[i]`` is P(bin == 1) for context ``i``, scaled to ``PROB_ONE``.
    Encoder and decoder construct identical banks and update them identically
    (backward adaptation — nothing is transmitted).
    """

    __slots__ = ("probs",)

    def __init__(self, num_contexts: int):
        self.probs = [PROB_HALF] * num_contexts



class RangeEncoder:
    """LZMA-style binary range encoder with carry propagation."""

    def __init__(self, contexts: ContextSet):
        self.ctx = contexts
        self.low = 0                  # up to 40 bits before shift_low
        self.range = MASK32
        self.cache = 0
        self.cache_size = 1           # first shift_low emits a leading 0 byte
        self.out = bytearray()
        self.bins_coded = 0

    # -- internals ---------------------------------------------------------
    def _shift_low(self) -> None:
        low = self.low
        if low < 0xFF000000 or low > MASK32:
            carry = low >> 32
            out = self.out
            out.append((self.cache + carry) & 0xFF)
            filler = (0xFF + carry) & 0xFF
            for _ in range(self.cache_size - 1):
                out.append(filler)
            self.cache_size = 0
            self.cache = (low >> 24) & 0xFF
        self.cache_size += 1
        self.low = (low << 8) & MASK32

    # -- public API --------------------------------------------------------
    def encode_bin(self, ctx_idx: int, bit: int) -> None:
        probs = self.ctx.probs
        p1 = probs[ctx_idx]
        bound = (self.range >> PROB_BITS) * p1
        if bit:
            self.range = bound
            p1 += (PROB_ONE - p1) >> ADAPT_SHIFT
            if p1 > PROB_MAX:
                p1 = PROB_MAX
        else:
            self.low += bound
            self.range -= bound
            p1 -= p1 >> ADAPT_SHIFT
            if p1 < PROB_MIN:
                p1 = PROB_MIN
        probs[ctx_idx] = p1
        if self.range < TOP:
            self.range = (self.range << 8) & MASK32
            self._shift_low()
        self.bins_coded += 1

    def encode_bypass(self, bit: int) -> None:
        self.range >>= 1
        if bit:
            self.low += self.range
        if self.range < TOP:
            self.range = (self.range << 8) & MASK32
            self._shift_low()
        self.bins_coded += 1

    def encode_bypass_bits(self, value: int, nbits: int) -> None:
        for shift in range(nbits - 1, -1, -1):
            self.encode_bypass((value >> shift) & 1)

    def finish(self) -> bytes:
        for _ in range(5):
            self._shift_low()
        # Drop the leading dummy zero byte emitted by the first shift_low.
        return bytes(self.out[1:])


class RangeDecoder:
    """Mirror of :class:`RangeEncoder`."""

    def __init__(self, data: bytes, contexts: ContextSet):
        self.ctx = contexts
        self.data = data
        self.pos = 0
        self.range = MASK32
        code = 0
        for _ in range(4):
            code = ((code << 8) | self._next_byte()) & MASK32
        self.code = code

    def _next_byte(self) -> int:
        d = self.data
        if self.pos < len(d):
            b = d[self.pos]
            self.pos += 1
            return b
        return 0  # zero-padding past the end is safe for range coders

    def decode_bin(self, ctx_idx: int) -> int:
        probs = self.ctx.probs
        p1 = probs[ctx_idx]
        bound = (self.range >> PROB_BITS) * p1
        if self.code < bound:
            bit = 1
            self.range = bound
            p1 += (PROB_ONE - p1) >> ADAPT_SHIFT
            if p1 > PROB_MAX:
                p1 = PROB_MAX
        else:
            bit = 0
            self.code -= bound
            self.range -= bound
            p1 -= p1 >> ADAPT_SHIFT
            if p1 < PROB_MIN:
                p1 = PROB_MIN
        probs[ctx_idx] = p1
        if self.range < TOP:
            self.range = (self.range << 8) & MASK32
            self.code = ((self.code << 8) | self._next_byte()) & MASK32
        return bit

    def decode_bypass(self) -> int:
        self.range >>= 1
        if self.code >= self.range:
            self.code -= self.range
            bit = 1
        else:
            bit = 0
        if self.range < TOP:
            self.range = (self.range << 8) & MASK32
            self.code = ((self.code << 8) | self._next_byte()) & MASK32
        return bit

    def decode_bypass_bits(self, nbits: int) -> int:
        v = 0
        for _ in range(nbits):
            v = (v << 1) | self.decode_bypass()
        return v


# ---------------------------------------------------------------------------
# Temporal context classes (delta / "P-frame" coding)
# ---------------------------------------------------------------------------

# Residuals between two checkpoints are coded with a *temporal-context*
# CABAC mode: every element selects one of TEMPORAL_CLASSES context banks
# by the significance of its co-located previous-frame level — the
# inter-frame analogue of the sigFlag's previous-weight conditioning.
# Class 0: prev level was zero; class 1: small (|prev| <= TC_SMALL_MAX);
# class 2: large.  The thresholds are part of the wire format (both sides
# derive classes from the shared base frame; nothing is transmitted), so
# changing them is a container-version event.
TEMPORAL_CLASSES = 3
TC_SMALL_MAX = 2


def temporal_classes(prev_levels) -> np.ndarray:
    """Per-element context-bank class of a delta stream, derived from the
    co-located base-frame levels.  Encoder and decoder call this on the
    *same* base levels, so the class arrays — and therefore every context
    index — agree bit-for-bit across the scalar/numpy/C engines."""
    return temporal_classes_u8(prev_levels).astype(np.int64)


def temporal_classes_u8(prev_levels) -> np.ndarray:
    """:func:`temporal_classes` as uint8, one byte per value: what the
    delta coder hands the lane engines."""
    b = np.asarray(prev_levels, dtype=np.int64).ravel()
    cls = (b != 0).view(np.uint8)
    cls += ((b > TC_SMALL_MAX) | (b < -TC_SMALL_MAX)).view(np.uint8)
    return cls
