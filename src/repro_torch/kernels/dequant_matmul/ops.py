"""Public wrappers of the fused dequantize-matmul.

``dequant_matmul(x (..., K), w_q (K, N) int8, scale (N,) f32) -> (..., N)
f32``: leading dims of ``x`` flatten to the kernel's M and come back on
the way out.  ``dequant_matmul_grouped(x (E, M, K), w_q (E, K, N) int8,
scale (E, N) | (N,) f32) -> (E, M, N) f32``: one product per expert.  A
CPU tensor takes the plain version (``ref.py``); a CUDA tensor launches
the hand-written kernel (``csrc/dequant_matmul.cu``,
``csrc/dequant_matmul_grouped.cu``) or raises — there is no fallback.  The
grouped kernel runs its tensor-core instance for a bf16 x and its f32 tile
for a f32 x.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import _build
from ..registry import count_launch
from .ref import dequant_matmul_grouped_ref, dequant_matmul_ref

_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p]
_GROUPED_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                     ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                     ctypes.c_void_p]
_FNS: dict = {}


def _launcher(name: str = "dequant_matmul", argtypes=_ARGTYPES):
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(_build.load(name), f"{name}_launch")
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


def _check_operands(op: str, x, w_q, scale) -> None:
    """What both kernels take: f32|bf16 x, int8 contiguous levels and f32
    contiguous scales on x's card, dimensions within int32."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{op}: x dtype {x.dtype} not in (float32, "
                        "bfloat16)")
    if w_q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"{op}: w_q must be int8 and scale float32")
    for name, t in (("w_q", w_q), ("scale", scale)):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"{op}: {name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{op}: {name} is not contiguous")
    if max(x.shape + w_q.shape) >= 2 ** 31:
        raise ValueError(f"{op}: a dimension exceeds int32")


def dequant_matmul_cuda(x2: torch.Tensor, w_q: torch.Tensor,
                        scale: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on 2-D operands; checks what it takes."""
    m, k = x2.shape
    if w_q.dim() != 2 or w_q.shape[0] != k:
        raise ValueError(f"dequant_matmul: w_q {tuple(w_q.shape)} does not "
                         f"match x (m={m}, k={k})")
    n = w_q.shape[1]
    if scale.shape != (n,):
        raise ValueError(f"dequant_matmul: scale {tuple(scale.shape)} != "
                         f"({n},)")
    _check_operands("dequant_matmul", x2, w_q, scale)
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


def dequant_matmul_grouped_cuda(x: torch.Tensor, w_q: torch.Tensor,
                                scale: torch.Tensor) -> torch.Tensor:
    """Launch the grouped CUDA kernel; checks what it takes.  A (N,) scale
    goes to the kernel as an expert stride of 0 (no (E, N) copy)."""
    if x.dim() != 3 or w_q.dim() != 3 or w_q.shape[0] != x.shape[0] or \
            w_q.shape[1] != x.shape[2]:
        raise ValueError(f"dequant_matmul_grouped: x {tuple(x.shape)} and "
                         f"w_q {tuple(w_q.shape)} are not (E, M, K) and "
                         "(E, K, N)")
    e, m, k = x.shape
    n = w_q.shape[2]
    if scale.shape == (n,):
        stride = 0
    elif scale.shape == (e, n):
        stride = n
    else:
        raise ValueError(f"dequant_matmul_grouped: scale "
                         f"{tuple(scale.shape)} is neither ({e}, {n}) nor "
                         f"({n},)")
    _check_operands("dequant_matmul_grouped", x, w_q, scale)
    if e > 65535:
        raise ValueError(f"dequant_matmul_grouped: {e} experts exceed the "
                         "grid's 65535")
    x = x.contiguous()
    out = torch.empty((e, m, n), dtype=torch.float32, device=x.device)
    if e == 0 or m == 0 or n == 0:
        return out
    if k == 0:
        return out.zero_()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _launcher("dequant_matmul_grouped", _GROUPED_ARGTYPES)(
        x.data_ptr(), int(x.dtype == torch.bfloat16), w_q.data_ptr(),
        scale.data_ptr(), stride, out.data_ptr(), e, m, k, n, stream)
    _build.check(err, "dequant_matmul_grouped")
    count_launch("dequant_matmul_grouped")
    return out


def dequant_matmul_grouped(x: torch.Tensor, w_q: torch.Tensor,
                           scale: torch.Tensor) -> torch.Tensor:
    """Grouped-expert serving matmul, one independent product per expert.

    x (E, M, K) f32|bf16, w_q (E, K, N) int8 levels, scale (E, N) f32 or
    (N,) (one per-channel Delta shared by the layer's experts) -> (E, M, N)
    f32."""
    if x.is_cuda:
        return dequant_matmul_grouped_cuda(x, w_q, scale)
    return dequant_matmul_grouped_ref(x, w_q, scale)
