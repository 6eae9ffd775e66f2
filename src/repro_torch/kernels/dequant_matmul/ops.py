"""Public wrapper of the fused dequantize-matmul.

``dequant_matmul(x (..., K), w_q (K, N) int8, scale (N,) f32) -> (..., N)
f32``: leading dims of ``x`` flatten to the kernel's M and come back on
the way out.  A CPU tensor takes the plain version (``ref.py``); a CUDA
tensor launches the hand-written kernel (``csrc/dequant_matmul.cu``) or
raises — there is no fallback.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import _build
from ..registry import count_launch
from .ref import dequant_matmul_ref

_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p]
_FN = None


def _launcher():
    global _FN
    if _FN is None:
        fn = _build.load("dequant_matmul").dequant_matmul_launch
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def dequant_matmul_cuda(x2: torch.Tensor, w_q: torch.Tensor,
                        scale: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on 2-D operands; checks what it takes."""
    m, k = x2.shape
    if w_q.dim() != 2 or w_q.shape[0] != k:
        raise ValueError(f"dequant_matmul: w_q {tuple(w_q.shape)} does not "
                         f"match x (m={m}, k={k})")
    n = w_q.shape[1]
    if x2.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dequant_matmul: x dtype {x2.dtype} not in "
                        "(float32, bfloat16)")
    if w_q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError("dequant_matmul: w_q must be int8 and scale float32")
    if scale.shape != (n,):
        raise ValueError(f"dequant_matmul: scale {tuple(scale.shape)} != "
                         f"({n},)")
    for name, t in (("w_q", w_q), ("scale", scale)):
        if not t.is_cuda or t.device != x2.device:
            raise ValueError(f"dequant_matmul: {name} on {t.device}, x on "
                             f"{x2.device}")
        if not t.is_contiguous():
            raise ValueError(f"dequant_matmul: {name} is not contiguous")
    if max(m, k, n) >= 2 ** 31:
        raise ValueError("dequant_matmul: a dimension exceeds int32")
    x2 = x2.contiguous()
    out = torch.empty((m, n), dtype=torch.float32, device=x2.device)
    if m == 0 or n == 0:
        return out
    if k == 0:
        return out.zero_()
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    err = _launcher()(x2.data_ptr(), int(x2.dtype == torch.bfloat16),
                      w_q.data_ptr(), scale.data_ptr(), out.data_ptr(),
                      m, k, n, stream)
    _build.check(err, "dequant_matmul")
    count_launch("dequant_matmul")
    return out


def dequant_matmul(x: torch.Tensor, w_q: torch.Tensor,
                   scale: torch.Tensor) -> torch.Tensor:
    """Serving matmul against DeepCABAC-quantized weights.

    x (..., K) f32|bf16, w_q (K, N) int8 levels, scale (N,) per-channel
    Delta -> (..., N) f32."""
    lead = tuple(x.shape[:-1])
    k = x.shape[-1]
    m = math.prod(lead)
    n = w_q.shape[1]
    x2 = x.reshape(m, k)
    if x.is_cuda:
        out = dequant_matmul_cuda(x2, w_q, scale)
    else:
        out = dequant_matmul_ref(x2, w_q, scale)
    return out.reshape(*lead, n)
