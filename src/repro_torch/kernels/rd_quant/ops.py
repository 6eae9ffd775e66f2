"""Public wrapper of the eq. (11) RD level assignment.

``rd_quant(w, fisher, probs, *, step, lam, window, max_level, passes)``
returns int32 levels with ``w``'s shape on ``w``'s device.  A CPU tensor
takes the plain version (``ref.py``); a CUDA tensor launches the
hand-written kernel (``csrc/rd_quant.cu``) once per pass, or raises —
there is no fallback.  Levels stay on the card between passes: two int32
buffers alternate, and pass p reads pass p-1's levels for prev_sig.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ...core.rate_model import BinProbs
from .. import _build
from ..registry import count_launch
from .coeffs import pack_coeffs
from .ref import rd_quant_ref

MAX_LEVEL_LIMIT = 1 << 24        # |k| must stay exact in f32

_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int64, ctypes.c_float, ctypes.c_float,
             ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
_FN = None


def _launcher():
    global _FN
    if _FN is None:
        fn = _build.load("rd_quant").rd_quant_launch
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def rd_quant_cuda(w: torch.Tensor, fisher: torch.Tensor | None,
                  scalars: np.ndarray, mag: np.ndarray, *, step: float,
                  lam: float, window: int, max_level: int, num_gr: int,
                  passes: int) -> torch.Tensor:
    """``passes`` kernel launches over flat CUDA ``w``; flat int32 out."""
    if not w.is_cuda:
        raise ValueError(f"rd_quant: the CUDA kernel takes CUDA tensors; "
                         f"w is on {w.device}")
    if w.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"rd_quant: w dtype {w.dtype} not in (float32, "
                        "bfloat16)")
    if not w.is_contiguous():
        raise ValueError("rd_quant: w is not contiguous")
    if fisher is not None:
        if (not fisher.is_cuda or fisher.device != w.device
                or fisher.dtype != torch.float32
                or not fisher.is_contiguous()
                or fisher.numel() != w.numel()):
            raise ValueError("rd_quant: fisher must be a contiguous f32 "
                             "tensor on w's device with w's size")
    if not 0 <= max_level < MAX_LEVEL_LIMIT:
        raise ValueError(f"rd_quant: max_level {max_level} outside "
                         f"[0, 2^24)")
    sc = np.ascontiguousarray(np.asarray(scalars, np.float32).reshape(-1))
    mg = np.ascontiguousarray(np.asarray(mag, np.float32).reshape(-1))
    n = w.numel()
    bufs = [torch.empty(n, dtype=torch.int32, device=w.device)
            for _ in range(min(max(passes, 1), 2))]
    stream = torch.cuda.current_stream(w.device).cuda_stream
    prev = None
    for p in range(max(passes, 1)):
        out = bufs[p % len(bufs)]
        err = _launcher()(
            w.data_ptr(), int(w.dtype == torch.bfloat16),
            None if fisher is None else fisher.data_ptr(),
            None if prev is None else prev.data_ptr(), out.data_ptr(), n,
            float(np.float32(step)), float(np.float32(lam)), int(window),
            float(max_level), int(num_gr), sc.ctypes.data, mg.ctypes.data,
            mg.size, stream)
        _build.check(err, "rd_quant")
        count_launch("rd_quant")
        prev = out
    return prev


def rd_quant(w: torch.Tensor, fisher: torch.Tensor | None, probs: BinProbs,
             *, step: float, lam: float, window: int = 4,
             max_level: int = 1 << 20, passes: int = 2) -> torch.Tensor:
    """RD-quantize a tensor of any shape on its device; int32 levels."""
    scalars, mag = pack_coeffs(probs)
    kw = dict(step=float(step), lam=float(lam), window=int(window),
              max_level=int(max_level), num_gr=int(probs.num_gr),
              passes=int(passes))
    flat = w.reshape(-1)
    fl = None if fisher is None else fisher.reshape(-1)
    if w.is_cuda:
        out = rd_quant_cuda(flat, fl, scalars, mag, **kw)
    elif w.device.type == "cpu":
        out = rd_quant_ref(flat, fl, scalars, mag, **kw)
    else:
        raise ValueError(f"rd_quant: unsupported device {w.device}")
    return out.reshape(w.shape)
