"""Public wrapper of the eq. (11) RD level assignment.

``rd_quant(w, fisher, probs, *, step, lam, window, max_level, passes)``
returns int32 levels with ``w``'s shape on ``w``'s device.  A CPU tensor
takes the plain version (``ref.py``); a CUDA tensor launches the
hand-written kernel (``csrc/rd_quant.cu``) once per pass, or raises —
there is no fallback.  Levels stay on the card between passes: two int32
buffers alternate, and pass p reads pass p-1's levels for prev_sig.  The
kernel's one knob, ``blocks_per_sm`` (the grid's cap, default 16), is the
op's tile space; the levels do not depend on it.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ...core.rate_model import BinProbs
from .. import _build
from ..registry import Impl, OpSpec, count_launch, register_op
from ..tune import pow2_bucket
from .coeffs import pack_coeffs
from .ref import rd_quant_ref

MAX_LEVEL_LIMIT = 1 << 24        # |k| must stay exact in f32
BLOCKS_PER_SM = 16               # the grid's default cap, per SM

_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int64, ctypes.c_float, ctypes.c_float,
             ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
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
                  passes: int, blocks_per_sm: int = BLOCKS_PER_SM
                  ) -> torch.Tensor:
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
            mg.size, int(blocks_per_sm), stream)
        _build.check(err, "rd_quant")
        count_launch("rd_quant")
        prev = out
    return prev


def rd_quant_plain(w: torch.Tensor, fisher: torch.Tensor | None,
                   probs: BinProbs, *, step: float, lam: float,
                   window: int = 4, max_level: int = 1 << 20,
                   passes: int = 2) -> torch.Tensor:
    """The plain version (``ref.py``) on ``w``'s device; the op's ``ref``
    impl."""
    scalars, mag = pack_coeffs(probs)
    out = rd_quant_ref(w.reshape(-1),
                       None if fisher is None else fisher.reshape(-1),
                       scalars, mag, step=float(step), lam=float(lam),
                       window=int(window), max_level=int(max_level),
                       num_gr=int(probs.num_gr), passes=int(passes))
    return out.reshape(w.shape)


def rd_quant(w: torch.Tensor, fisher: torch.Tensor | None, probs: BinProbs,
             *, step: float, lam: float, window: int = 4,
             max_level: int = 1 << 20, passes: int = 2,
             blocks_per_sm: int = BLOCKS_PER_SM) -> torch.Tensor:
    """RD-quantize a tensor of any shape on its device; int32 levels.
    ``blocks_per_sm``: the kernel's grid cap (the plain version has no
    grid)."""
    if not w.is_cuda:
        return rd_quant_plain(w, fisher, probs, step=step, lam=lam,
                              window=window, max_level=max_level,
                              passes=passes)
    scalars, mag = pack_coeffs(probs)
    out = rd_quant_cuda(
        w.reshape(-1), None if fisher is None else fisher.reshape(-1),
        scalars, mag, step=float(step), lam=float(lam), window=int(window),
        max_level=int(max_level), num_gr=int(probs.num_gr),
        passes=int(passes), blocks_per_sm=blocks_per_sm)
    return out.reshape(w.shape)


# ---------------------------------------------------------------------------
# Registry spec.  Op signature: (w, fisher, probs, *, step, lam, ...)
# ---------------------------------------------------------------------------

def _shape_info(w, fisher=None, probs=None, **kwargs) -> dict:
    return {"n": max(w.numel(), 1)}


def _bucket(s: dict) -> str:
    return f"n{pow2_bucket(s['n'])}"


def _example_inputs(shape, device="cpu"):
    """(n,) or (n, w dtype name): seeded weights on ``device``, half of
    them zero, and the bin statistics of the nearest levels of their first
    2^20 values."""
    from ...core.quant import nearest_level
    from ...core.rate_model import estimate_bin_probs
    n = int(shape[0]) if isinstance(shape, (tuple, list)) else int(shape)
    wdt = (getattr(torch, shape[1]) if isinstance(shape, (tuple, list))
           and len(shape) > 1 else torch.float32)
    gen = torch.Generator(device=device)
    gen.manual_seed(n)
    w = torch.randn(n, generator=gen, device=device) * 0.05
    w = torch.where(torch.rand(n, generator=gen, device=device) < 0.5, 0.0,
                    w).to(wdt)
    step = 0.008
    head = w[:1 << 20].float().cpu().numpy()
    probs = estimate_bin_probs(nearest_level(head, step))
    return (w, None, probs), {"step": step, "lam": 2e-4}


@register_op
def _rd_quant_spec() -> OpSpec:
    return OpSpec(
        name="rd_quant",
        impls={
            "cuda": Impl("cuda", rd_quant, platforms=("cuda",)),
            "ref": Impl("ref", rd_quant_plain, uses_tiles=False),
        },
        defaults={"cuda": "cuda", "*": "ref"},
        fallbacks=("ref",),
        tile_space={"blocks_per_sm": (4, 8, 16, 32, 64)},
        default_tiles=lambda s: {"blocks_per_sm": BLOCKS_PER_SM},
        shape_info=_shape_info,
        bucket=_bucket,
        example_inputs=_example_inputs,
        oracle=rd_quant_ref,
        tune_impls={"cuda": "cuda"},
    )
