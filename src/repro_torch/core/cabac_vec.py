"""Lane-parallel vectorized CABAC: N independent chunk streams in lockstep
(the port's copy of ``repro.core.cabac_vec``, the temporal-context
``*_tc`` lanes of the delta ("P-frame") mode included).

The interval subdivision of a range coder is inherently sequential *within*
a stream, but the chunk split the container emits makes streams
independent — so one program can advance many streams ("lanes"): every
lane is bit-exact with the scalar :class:`~repro_torch.core.cabac.
RangeEncoder` / :class:`~repro_torch.core.cabac.RangeDecoder`, which is
what lets a v3 reader schedule all chunks of a tensor into one batch.

Two backends hide behind one API:

* ``numpy`` — the portable lockstep engine in this file: one step codes
  one bin in every live lane; lanes that finish early park in a DONE
  state, so ragged chunk counts need no compaction.
* ``c`` — ``_cabac_lanes.c`` (the scalar coder transliterated to C, run
  per lane), compiled on first use with the host ``cc`` into
  ``build/host/`` at the root of the checkout and called through ctypes.
  A batch is split into contiguous lane groups that run on a thread pool
  (ctypes drops the GIL during the call); each lane is coded exactly as
  alone, so the bytes do not depend on the split.  Without a compiler the
  engine warns once and falls back to numpy.

``backend="auto"`` picks C when available, else numpy.  This is host
code: it never runs on the card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from . import binarization as B
from .cabac import (ADAPT_SHIFT, MASK32, PROB_BITS, PROB_HALF, PROB_MAX,
                    PROB_MIN, PROB_ONE, TOP)

__all__ = [
    "available_backends", "resolve_backend",
    "encode_lanes", "decode_lanes",
    "encode_lanes_tc", "decode_lanes_tc",
    "VecRangeEncoder", "VecRangeDecoder",
]

_I64 = np.int64

# Levels beyond this magnitude would overflow the int64 Exp-Golomb
# accumulators; the scalar coder (arbitrary-precision Python ints) remains
# the path of record for such streams.  Far beyond any quantizer output.
MAX_ABS_LEVEL = (1 << 61) - 1


# ---------------------------------------------------------------------------
# Lockstep bin coder (the numpy backend's core)
# ---------------------------------------------------------------------------

class VecRangeDecoder:
    """Lockstep mirror of ``RangeDecoder`` over ``n_lanes`` streams.

    Each lane has its own payload, 32-bit range/code registers and context
    bank row; :meth:`decode_bins` advances every selected lane by exactly
    one bin.  Context index ``num_contexts`` is a scratch slot: bypass bins
    (and parked lanes) read/write it so the bank update needs no masking.
    """

    def __init__(self, payloads: list[bytes], num_contexts: int,
                 pad: int = 64):
        n = len(payloads)
        self.n_lanes = n
        self.num_contexts = num_contexts
        self._row = num_contexts + 1          # bank row incl. scratch slot
        self.probs = np.full(n * self._row, PROB_HALF, dtype=_I64)
        self._lane_off = np.arange(n, dtype=_I64) * self._row
        self.lens = np.asarray([len(p) for p in payloads], dtype=_I64)
        width = int(self.lens.max(initial=0)) + pad
        data = np.zeros((n, width), dtype=np.uint8)
        for i, p in enumerate(payloads):
            data[i, :len(p)] = np.frombuffer(p, dtype=np.uint8)
        self._data = data.reshape(-1).astype(_I64)
        self._width = width
        self._dbase = np.arange(n, dtype=_I64) * width
        self.rng = np.full(n, MASK32, dtype=_I64)
        self.code = np.zeros(n, dtype=_I64)
        self.pos = np.zeros(n, dtype=_I64)
        for _ in range(4):
            self.code = ((self.code << 8)
                         | self._data[self._dbase + self.pos]) & MASK32
            self.pos += 1

    def decode_bins(self, ctx: np.ndarray, is_byp: np.ndarray) -> np.ndarray:
        """One bin per lane; ``ctx`` is ignored where ``is_byp``.  Returns
        the decoded bits as an int64 0/1 vector."""
        cidx = self._lane_off + np.where(is_byp, self.num_contexts, ctx)
        p1 = self.probs[cidx]
        bound = np.where(is_byp, self.rng >> 1, (self.rng >> PROB_BITS) * p1)
        ge = self.code >= bound
        bit = np.where(is_byp, ge, ~ge)
        self.code = self.code - np.where(ge, bound, 0)
        self.rng = np.where(bit | is_byp, bound, self.rng - bound)
        up = np.minimum(p1 + ((PROB_ONE - p1) >> ADAPT_SHIFT), PROB_MAX)
        dn = np.maximum(p1 - (p1 >> ADAPT_SHIFT), PROB_MIN)
        newp = np.where(is_byp, p1, np.where(bit, up, dn))
        self.probs[cidx] = newp
        need = self.rng < TOP
        self.rng = np.where(need, (self.rng << 8) & MASK32, self.rng)
        byte = self._data[self._dbase + np.minimum(self.pos, self._width - 1)]
        self.code = np.where(need, ((self.code << 8) | byte) & MASK32,
                             self.code)
        self.pos = self.pos + need
        return bit.astype(_I64)


class VecRangeEncoder:
    """Lockstep mirror of ``RangeEncoder``: per-lane 40-bit low with carry
    propagation and cache/filler runs, vectorized with masked updates."""

    def __init__(self, n_lanes: int, num_contexts: int, out_capacity: int):
        self.n_lanes = n_lanes
        self.num_contexts = num_contexts
        self._row = num_contexts + 1
        self.probs = np.full(n_lanes * self._row, PROB_HALF, dtype=_I64)
        self._lane_off = np.arange(n_lanes, dtype=_I64) * self._row
        self.low = np.zeros(n_lanes, dtype=_I64)
        self.rng = np.full(n_lanes, MASK32, dtype=_I64)
        self.cache = np.zeros(n_lanes, dtype=_I64)
        self.cache_size = np.ones(n_lanes, dtype=_I64)
        self.out = np.zeros((n_lanes, out_capacity), dtype=np.uint8)
        self.opos = np.zeros(n_lanes, dtype=_I64)
        self._iota = np.arange(n_lanes)

    def _shift_low(self, mask: np.ndarray) -> None:
        low = self.low
        cond = mask & ((low < 0xFF000000) | (low > MASK32))
        if cond.any():
            carry = low >> 32
            byte = (self.cache + carry) & 0xFF
            rows = self._iota[cond]
            self.out[rows, self.opos[cond]] = byte[cond]
            self.opos = self.opos + cond
            filler = (0xFF + carry) & 0xFF
            fcount = np.where(cond, self.cache_size - 1, 0)
            while True:
                m = fcount > 0
                if not m.any():
                    break
                rows = self._iota[m]
                self.out[rows, self.opos[m]] = filler[m]
                self.opos = self.opos + m
                fcount = fcount - m
            self.cache = np.where(cond, (low >> 24) & 0xFF, self.cache)
            self.cache_size = np.where(cond, 0, self.cache_size)
        self.cache_size = self.cache_size + mask
        self.low = np.where(mask, (low << 8) & MASK32, low)

    def encode_bins(self, ctx: np.ndarray, bits: np.ndarray,
                    is_byp: np.ndarray, active: np.ndarray) -> None:
        """One bin per active lane; inactive lanes are untouched."""
        byp = is_byp & active
        cidx = self._lane_off + np.where(active & ~byp, ctx,
                                         self.num_contexts)
        p1 = self.probs[cidx]
        bound = (self.rng >> PROB_BITS) * p1
        half = self.rng >> 1
        bit1 = bits.astype(bool)
        rng_new = np.where(byp, half, np.where(bit1, bound, self.rng - bound))
        add = np.where(byp, np.where(bit1, half, 0),
                       np.where(bit1, 0, bound))
        self.low = self.low + np.where(active, add, 0)
        self.rng = np.where(active, rng_new, self.rng)
        up = np.minimum(p1 + ((PROB_ONE - p1) >> ADAPT_SHIFT), PROB_MAX)
        dn = np.maximum(p1 - (p1 >> ADAPT_SHIFT), PROB_MIN)
        ctx_upd = active & ~byp
        newp = np.where(ctx_upd, np.where(bit1, up, dn), p1)
        self.probs[cidx] = newp
        need = active & (self.rng < TOP)
        self.rng = np.where(need, (self.rng << 8) & MASK32, self.rng)
        self._shift_low(need)

    def finish(self) -> list[bytes]:
        all_lanes = np.ones(self.n_lanes, dtype=bool)
        for _ in range(5):
            self._shift_low(all_lanes)
        # Drop the leading dummy zero byte, like RangeEncoder.finish().
        return [self.out[i, 1:self.opos[i]].tobytes()
                for i in range(self.n_lanes)]


# ---------------------------------------------------------------------------
# Level-stream state machine on top of the lockstep bin coder
# ---------------------------------------------------------------------------

# Binarization automaton phases (one value = sig | sign | AbsGr flags |
# Exp-Golomb exponent | bypass remainder, per binarization.py).
_P_SIG, _P_SIGN, _P_GR, _P_EGE, _P_BYP, _P_DONE = range(6)


def _decode_lanes_numpy(payloads: list[bytes], counts: np.ndarray,
                        num_gr: int,
                        cls_arrays: list[np.ndarray] | None = None
                        ) -> list[np.ndarray]:
    n = len(payloads)
    counts = np.asarray(counts, dtype=_I64)
    base_nctx = B.num_contexts(num_gr)
    nctx = B.num_contexts_tc(num_gr) if cls_arrays is not None else base_nctx
    eg_base = B.ctx_eg_base(num_gr)
    eg_last = eg_base + B.EG_CTXS - 1
    dec = VecRangeDecoder(payloads, nctx)

    phase = np.where(counts > 0, _P_SIG, _P_DONE).astype(_I64)
    jj = np.zeros(n, dtype=_I64)          # GR j / EGE k / BYP bits-left
    kk = np.zeros(n, dtype=_I64)          # saved Exp-Golomb exponent
    neg = np.zeros(n, dtype=bool)
    acc = np.zeros(n, dtype=_I64)
    prev_sig = np.zeros(n, dtype=_I64)
    out_idx = np.zeros(n, dtype=_I64)
    maxc = int(counts.max(initial=0))
    out = np.zeros((n, maxc + 1), dtype=_I64)   # +1 slack: parked lanes
    iota = np.arange(n)                         # keep writing to out[:, c]
    sign = np.ones(n, dtype=_I64)

    # Temporal-context mode: per-lane class of the value currently being
    # decoded, gathered by out_idx (classes are known up front — they come
    # from the shared base frame, not from the stream).
    cls_pad = None
    if cls_arrays is not None:
        cls_pad = np.zeros((n, maxc + 1), dtype=_I64)
        for i, c in enumerate(cls_arrays):
            c = np.asarray(c, dtype=_I64).ravel()
            cls_pad[i, :c.size] = c

    one = np.ones(n, dtype=_I64)
    while not bool((phase == _P_DONE).all()):
        # ctx of the bin each lane decodes this step (selected by phase);
        # bypass-remainder and parked lanes take the uncontexted path.
        ctx = np.where(phase == _P_SIG, prev_sig,
              np.where(phase == _P_SIGN, B.CTX_SIGN,
              np.where(phase == _P_GR, B.CTX_GR_BASE + jj - 1,
                       np.minimum(eg_base + jj, eg_last))))
        if cls_pad is not None:
            ctx = ctx + cls_pad[iota, out_idx] * base_nctx
        is_byp = phase >= _P_BYP
        bit = dec.decode_bins(ctx, is_byp)
        b1 = bit.astype(bool)

        emit = np.zeros(n, dtype=bool)
        val = np.zeros(n, dtype=_I64)

        # Transitions apply to the phase each lane was in at step start;
        # the was_* masks keep just-arrived lanes out of the next block.
        was_sig = phase == _P_SIG
        emit |= was_sig & ~b1                            # v == 0
        prev_sig = np.where(was_sig, bit, prev_sig)
        phase = np.where(was_sig & b1, _P_SIGN, phase)

        was_sign = (phase == _P_SIGN) & ~was_sig
        neg = np.where(was_sign, b1, neg)
        sign = np.where(neg, -one, one)
        jj = np.where(was_sign, 1, jj)
        phase = np.where(was_sign, _P_GR, phase)

        was_gr = (phase == _P_GR) & ~was_sign
        term = was_gr & ~b1
        emit |= term
        val = np.where(term, sign * jj, val)
        phase = np.where(term, _P_SIG, phase)
        grow = was_gr & b1
        jj = np.where(grow, jj + 1, jj)
        to_eg = grow & (jj > num_gr)
        phase = np.where(to_eg, _P_EGE, phase)
        jj = np.where(to_eg, 0, jj)

        was_ege = (phase == _P_EGE) & ~to_eg
        jj = np.where(was_ege & b1, jj + 1, jj)
        if bool((was_ege & (jj > 60)).any()):
            # Exp-Golomb exponent beyond the |level| <= 2^61 - 1 lane
            # range (legal for the arbitrary-precision scalar coder) —
            # refuse rather than wrap int64; callers fall back to scalar.
            raise OverflowError(
                "cabac_vec decode hit a level beyond 2**61 - 1; the "
                "stream needs the scalar decoder")
        done_k = was_ege & ~b1
        k0 = done_k & (jj == 0)
        emit |= k0
        val = np.where(k0, sign * (num_gr + 1), val)
        phase = np.where(k0, _P_SIG, phase)
        to_byp = done_k & (jj > 0)
        kk = np.where(to_byp, jj, kk)
        acc = np.where(to_byp, 0, acc)
        phase = np.where(to_byp, _P_BYP, phase)

        was_byp = (phase == _P_BYP) & ~to_byp
        acc = np.where(was_byp, (acc << 1) | bit, acc)
        jj = np.where(was_byp, jj - 1, jj)
        fin = was_byp & (jj == 0)
        emit |= fin
        val = np.where(fin, sign * (num_gr + (one << kk) + acc), val)
        phase = np.where(fin, _P_SIG, phase)

        out[iota, out_idx] = np.where(emit, val, out[iota, out_idx])
        out_idx = out_idx + emit
        phase = np.where(out_idx >= counts, _P_DONE, phase)
    return [out[i, :counts[i]] for i in range(n)]


def _encode_lanes_numpy(level_arrays: list[np.ndarray], num_gr: int,
                        cls_arrays: list[np.ndarray] | None = None
                        ) -> list[bytes]:
    n = len(level_arrays)
    if cls_arrays is not None:
        nctx = B.num_contexts_tc(num_gr)
        expanded = [B.expand_bins_tc(np.asarray(lv).ravel(), cls, num_gr)
                    for lv, cls in zip(level_arrays, cls_arrays)]
    else:
        nctx = B.num_contexts(num_gr)
        expanded = [B.expand_bins(np.asarray(lv).ravel(), num_gr)
                    for lv in level_arrays]
    nbins = np.asarray([len(b) for b, _ in expanded], dtype=_I64)
    tmax = int(nbins.max(initial=0))
    bits = np.zeros((n, tmax), dtype=_I64)
    ctxs = np.zeros((n, tmax), dtype=_I64)
    for i, (b, c) in enumerate(expanded):
        bits[i, :len(b)] = b
        ctxs[i, :len(c)] = c
    enc = VecRangeEncoder(n, nctx, tmax + 16)
    for t in range(tmax):
        active = t < nbins
        ctx = ctxs[:, t]
        enc.encode_bins(np.maximum(ctx, 0), bits[:, t], ctx < 0, active)
    return enc.finish()


# ---------------------------------------------------------------------------
# Compiled per-lane engine (the fast host backend)
# ---------------------------------------------------------------------------

_KERNEL = None        # ctypes lib, False after a failed attempt
_KERNEL_SRC = Path(__file__).resolve().parent / "_cabac_lanes.c"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "host"
CC_FLAGS = ["-O3", "-shared", "-fPIC"]


def _lib_path() -> Path:
    h = hashlib.sha256(_KERNEL_SRC.read_bytes()
                       + " ".join(CC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"cabac_lanes-{h[:16]}.so"


def _build_kernel():
    so_path = _lib_path()
    if not so_path.exists():
        cc = (os.environ.get("CC") or shutil.which("cc")
              or shutil.which("gcc") or shutil.which("clang"))
        if cc is None:
            raise RuntimeError("no C compiler on PATH")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run([cc, *CC_FLAGS, "-o", tmp, str(_KERNEL_SRC)],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp, so_path)      # atomic for concurrent builds
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
    lib = ctypes.CDLL(str(so_path))
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
    lib.cabac_decode_lanes.argtypes = [vp, vp, vp, vp, i32, i32]
    lib.cabac_decode_lanes.restype = i32
    lib.cabac_encode_lanes.argtypes = [vp, vp, vp, i64, vp, i32, i32]
    lib.cabac_encode_lanes.restype = None
    lib.cabac_decode_lanes_tc.argtypes = [vp, vp, vp, vp, vp, i32, i32]
    lib.cabac_decode_lanes_tc.restype = i32
    lib.cabac_encode_lanes_tc.argtypes = [vp, vp, vp, vp, i64, vp, i32, i32]
    lib.cabac_encode_lanes_tc.restype = None
    return lib


def _get_kernel():
    global _KERNEL
    if _KERNEL is None:
        try:
            _KERNEL = _build_kernel()
        except Exception as e:  # no cc, read-only tree, bad toolchain, ...
            _KERNEL = False
            warnings.warn(
                f"cabac_vec: C lane engine unavailable ({e}); "
                f"falling back to the numpy lockstep engine", stacklevel=2)
    return _KERNEL or None


def default_threads() -> int:
    """Threads the C engine spreads one batch over: the host's cores, at
    most 16."""
    return max(1, min(os.cpu_count() or 1, 16))


def _lane_groups(n: int, threads: int) -> list[tuple[int, int]]:
    """Contiguous [start, stop) lane ranges, one per thread."""
    t = max(1, min(threads, n))
    bounds = [n * i // t for i in range(t + 1)]
    return [(bounds[i], bounds[i + 1]) for i in range(t)
            if bounds[i + 1] > bounds[i]]


def _run_groups(fn, groups) -> list:
    if len(groups) == 1:
        return [fn(*groups[0])]
    with ThreadPoolExecutor(max_workers=len(groups)) as ex:
        return list(ex.map(lambda g: fn(*g), groups))


def _addr(arr: np.ndarray, elem_offset: int = 0) -> int:
    return arr.ctypes.data + elem_offset * arr.itemsize


def _flat_classes(cls_arrays, total: int) -> np.ndarray:
    """The lanes' class ids concatenated, one byte each: they share the
    value offsets of the levels (``ooff`` / ``loff``)."""
    if not total:
        return np.zeros(1, dtype=np.uint8)
    return np.ascontiguousarray(np.concatenate(
        [np.asarray(c).ravel().astype(np.uint8, copy=False)
         for c in cls_arrays]))


def _decode_lanes_c(payloads: list[bytes], counts: np.ndarray,
                    num_gr: int, lib, threads: int,
                    cls_arrays: list[np.ndarray] | None = None
                    ) -> list[np.ndarray]:
    n = len(payloads)
    counts = np.asarray(counts, dtype=_I64)
    data = np.frombuffer(b"".join(payloads), dtype=np.uint8)
    if data.size == 0:
        data = np.zeros(1, dtype=np.uint8)
    doff = np.zeros(n + 1, dtype=_I64)
    np.cumsum([len(p) for p in payloads], out=doff[1:])
    ooff = np.zeros(n + 1, dtype=_I64)
    np.cumsum(counts, out=ooff[1:])
    out = np.empty(max(int(ooff[-1]), 1), dtype=_I64)
    cls = (None if cls_arrays is None
           else _flat_classes(cls_arrays, int(ooff[-1])))

    def run(lo, hi):
        # lane offsets are absolute, so each group passes its slice of
        # doff / ooff and the shared base pointers
        if cls is not None:
            return lib.cabac_decode_lanes_tc(
                _addr(data), _addr(doff, lo), _addr(cls), _addr(out),
                _addr(ooff, lo), hi - lo, num_gr)
        return lib.cabac_decode_lanes(_addr(data), _addr(doff, lo),
                                      _addr(out), _addr(ooff, lo),
                                      hi - lo, num_gr)

    if any(_run_groups(run, _lane_groups(n, threads))):
        raise OverflowError(
            "cabac_vec decode hit a level beyond 2**61 - 1; the stream "
            "needs the scalar decoder")
    return [out[ooff[i]:ooff[i + 1]] for i in range(n)]


def _encode_lanes_c(level_arrays: list[np.ndarray], num_gr: int, lib,
                    threads: int,
                    cls_arrays: list[np.ndarray] | None = None
                    ) -> list[bytes]:
    n = len(level_arrays)
    flats = [np.ascontiguousarray(np.asarray(lv).ravel(), dtype=_I64)
             for lv in level_arrays]
    loff = np.zeros(n + 1, dtype=_I64)
    np.cumsum([f.size for f in flats], out=loff[1:])
    levels = (np.concatenate(flats) if int(loff[-1])
              else np.zeros(1, dtype=_I64))
    maxc = max((f.size for f in flats), default=0)
    # Worst case ~ (2 + num_gr + 2*63 + 1) bits/value plus flush bytes.
    stride = (maxc * (num_gr + 130)) // 8 + 32
    out = np.empty((n, stride), dtype=np.uint8)
    out_lens = np.zeros(n, dtype=_I64)
    cls = (None if cls_arrays is None
           else _flat_classes(cls_arrays, int(loff[-1])))

    def run(lo, hi):
        if cls is not None:
            lib.cabac_encode_lanes_tc(_addr(levels), _addr(cls),
                                      _addr(loff, lo),
                                      _addr(out, lo * stride), stride,
                                      _addr(out_lens, lo), hi - lo, num_gr)
            return
        lib.cabac_encode_lanes(_addr(levels), _addr(loff, lo),
                               _addr(out, lo * stride), stride,
                               _addr(out_lens, lo), hi - lo, num_gr)

    _run_groups(run, _lane_groups(n, threads))
    # Drop the leading dummy zero byte, like RangeEncoder.finish().
    return [out[i, 1:out_lens[i]].tobytes() for i in range(n)]


# ---------------------------------------------------------------------------
# Public batched API
# ---------------------------------------------------------------------------

def available_backends() -> list[str]:
    out = ["numpy"]
    if _get_kernel() is not None:
        out.insert(0, "c")
    return out


def resolve_backend(backend: str = "auto") -> str:
    if backend == "auto":
        return "c" if _get_kernel() is not None else "numpy"
    if backend == "c" and _get_kernel() is None:
        raise RuntimeError("cabac_vec C engine requested but unavailable")
    if backend not in ("c", "numpy"):
        raise ValueError(f"unknown cabac_vec backend {backend!r}")
    return backend


def decode_lanes(payloads: list[bytes], counts,
                 num_gr: int = B.DEFAULT_NUM_GR,
                 backend: str = "auto") -> list[np.ndarray]:
    """Decode N independent chunk streams; lane ``i`` yields ``counts[i]``
    int64 levels, bit-exact with ``RangeDecoder`` + ``decode_levels``.

    Raises ``OverflowError`` (never silently wraps) when a stream carries
    a level beyond ``MAX_ABS_LEVEL`` — possible only for streams the
    arbitrary-precision scalar coder wrote; callers fall back to it."""
    if not payloads:
        return []
    if resolve_backend(backend) == "c":
        return _decode_lanes_c(payloads, counts, num_gr, _get_kernel(),
                               default_threads())
    return _decode_lanes_numpy(payloads, counts, num_gr)


def encode_lanes(level_arrays: list[np.ndarray],
                 num_gr: int = B.DEFAULT_NUM_GR,
                 backend: str = "auto") -> list[bytes]:
    """Encode N level arrays as independent streams; byte-exact with
    ``RangeEncoder`` + ``encode_levels`` per lane."""
    if not level_arrays:
        return []
    for lv in level_arrays:
        a = np.asarray(lv)
        if a.size and int(np.abs(a).max()) > MAX_ABS_LEVEL:
            raise OverflowError(
                "cabac_vec lanes code |level| <= 2**61 - 1; use the scalar "
                "coder for wider values")
    if resolve_backend(backend) == "c":
        return _encode_lanes_c(level_arrays, num_gr, _get_kernel(),
                               default_threads())
    return _encode_lanes_numpy(level_arrays, num_gr)


# ---------------------------------------------------------------------------
# Temporal-context ("P-frame") lanes
# ---------------------------------------------------------------------------

def _check_classes(cls_arrays, sizes) -> None:
    from .cabac import TEMPORAL_CLASSES
    if len(cls_arrays) != len(sizes):
        raise ValueError("one class array per lane is required")
    for cls, size in zip(cls_arrays, sizes):
        c = np.asarray(cls)
        if c.size != size:
            raise ValueError(
                f"class array of {c.size} values for a lane of {size}")
        if c.size and (int(c.min()) < 0
                       or int(c.max()) >= TEMPORAL_CLASSES):
            raise ValueError("temporal class ids must be in "
                             f"[0, {TEMPORAL_CLASSES})")


def decode_lanes_tc(payloads: list[bytes], cls_arrays: list[np.ndarray],
                    num_gr: int = B.DEFAULT_NUM_GR,
                    backend: str = "auto") -> list[np.ndarray]:
    """Temporal-context decode: lane ``i`` yields ``len(cls_arrays[i])``
    levels, each coded in the context bank named by its class id (derived
    from the co-located base-frame level via ``cabac.temporal_classes``).
    Bit-exact with ``RangeDecoder`` + ``decode_levels_tc`` per lane; the
    ``OverflowError`` contract matches :func:`decode_lanes`."""
    if not payloads:
        return []
    counts = np.asarray([np.asarray(c).size for c in cls_arrays],
                        dtype=_I64)
    _check_classes(cls_arrays, counts.tolist())
    if resolve_backend(backend) == "c":
        return _decode_lanes_c(payloads, counts, num_gr, _get_kernel(),
                               default_threads(), cls_arrays=cls_arrays)
    return _decode_lanes_numpy(payloads, counts, num_gr,
                               cls_arrays=cls_arrays)


def encode_lanes_tc(level_arrays: list[np.ndarray],
                    cls_arrays: list[np.ndarray],
                    num_gr: int = B.DEFAULT_NUM_GR,
                    backend: str = "auto") -> list[bytes]:
    """Temporal-context encode; byte-exact with ``RangeEncoder`` +
    ``encode_levels_tc`` per lane."""
    if not level_arrays:
        return []
    sizes = []
    for lv in level_arrays:
        a = np.asarray(lv)
        sizes.append(a.size)
        if a.size and int(np.abs(a).max()) > MAX_ABS_LEVEL:
            raise OverflowError(
                "cabac_vec lanes code |level| <= 2**61 - 1; use the scalar "
                "coder for wider values")
    _check_classes(cls_arrays, sizes)
    if resolve_backend(backend) == "c":
        return _encode_lanes_c(level_arrays, num_gr, _get_kernel(),
                               default_threads(), cls_arrays=cls_arrays)
    return _encode_lanes_numpy(level_arrays, num_gr,
                               cls_arrays=cls_arrays)
