"""Quantizer strategies and per-tensor policies (the port's copy of
``repro.compression.quantizers``).

A quantizer maps one full-precision tensor to a quantized representation
(``QuantizedTensor`` for scalar-step equidistant grids, ``Q8Tensor`` for
per-channel int8); a policy decides per flat-named leaf whether to
quantize at all.  Grid steps and RD assignment run on the host in f64 as
in the reference (``relative_step`` included: a std taken on the card
sums in another order and can move the step by an ulp); the per-channel
int8 quantizer runs where the tensor is.

Serving int8 levels and scales are bit-identical to the reference: the order of
operations is kept exactly (stacked leaves divide by
``max(amax / 127, 1e-12)``, 2-D leaves by ``max(amax, 1e-12) / 127``), and
``torch.round`` rounds half to even as ``jnp.round`` does.  Every division
by 127 divides by a 0-d tensor on the weight's device: PyTorch's CUDA
kernel turns ``t / 127.0`` (a Python scalar) into ``t * (1 / 127)``, which
moves a scale by an ulp and flips levels on a rounding edge, so the card
would quantize differently from the CPU and the reference.  Stacked
tensors are quantized one layer at a time, so no f32 copy of a whole
(L, K, N) stack is ever made.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Protocol, runtime_checkable

import numpy as np
import torch

from ..arrays import dtype_name, is_float_dtype
from ..core import binarization as B
from ..core.codec import Q8Tensor, QuantizedTensor
from ..core.quant import nearest_level

STACKED_TOP_KEYS = ("layers", "dense_layers")


@runtime_checkable
class PolicyFn(Protocol):
    """``(flat name, tensor) -> bool``: True quantizes the leaf, False
    stores it raw."""

    def __call__(self, name: str, w: torch.Tensor) -> bool: ...


def ndim_float_policy(min_ndim: int = 2) -> PolicyFn:
    """Quantize float tensors of rank >= min_ndim; everything else raw."""
    def policy(name: str, w) -> bool:
        return w.ndim >= min_ndim and is_float_dtype(w.dtype)
    return policy


def serve_q8_policy(name: str, w: torch.Tensor) -> bool:
    """Stacked layer tensors of ndim >= 3 and unstacked 2-D matrices
    (embed / head) are quantized; per-layer vectors stay full precision."""
    top = name.split("/", 1)[0]
    stacked = top in STACKED_TOP_KEYS
    return w.is_floating_point() and (
        (stacked and w.dim() >= 3) or (not stacked and w.dim() == 2))


def quantize_leaf(w: torch.Tensor) -> dict:
    """Per-output-channel (last dim) symmetric int8.  Stacked (L, ..., out)
    tensors keep a per-layer leading dim on the scale: (L, out)."""
    q_max = torch.full((), 127.0, dtype=torch.float32, device=w.device)
    if w.dim() >= 3:
        q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
        scales = torch.empty((w.shape[0], w.shape[-1]), dtype=torch.float32,
                             device=w.device)
        axes = tuple(range(0, w.dim() - 2))      # within one layer
        for i in range(w.shape[0]):
            wf = w[i].to(torch.float32)
            amax = wf.abs().amax(dim=axes, keepdim=True)    # (1.., out)
            q[i] = torch.clamp(torch.round(
                wf / torch.clamp_min(amax / q_max, 1e-12)), -127, 127
            ).to(torch.int8)
            scales[i] = torch.clamp_min(amax.reshape(-1) / q_max, 1e-12)
        return {"q8": q, "q8s": scales}
    wf = w.to(torch.float32)
    axes = tuple(range(w.dim() - 1))
    scale = torch.clamp_min(wf.abs().amax(dim=axes), 1e-12) / q_max
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return {"q8": q, "q8s": scale.to(torch.float32)}


def quantize_tree_q8(params: dict, prefix: str = "") -> dict:
    """Quantize the matmul weights of a nested parameter dict into
    ``{"q8", "q8s"}`` leaf dicts, leaving every other leaf as it is.  An
    already-quantized tree passes through (int8 leaves are not float)."""
    out = {}
    for key, val in params.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            out[key] = quantize_tree_q8(val, name + "/")
        elif isinstance(val, torch.Tensor) and serve_q8_policy(name, val):
            out[key] = quantize_leaf(val)
        else:
            out[key] = val
    return out


# ---------------------------------------------------------------------------
# Quantizer strategies
# ---------------------------------------------------------------------------

def host_f64(w) -> np.ndarray:
    """``w`` (torch on any device, or numpy) as a host f64 array; exact
    for f32 and bf16."""
    if isinstance(w, torch.Tensor):
        return w.detach().to("cpu", torch.float64).numpy()
    return np.asarray(w, dtype=np.float64)


class Quantizer:
    """Strategy interface: one tensor -> quantized representation."""

    def quantize(self, name: str, w: torch.Tensor):
        raise NotImplementedError


def relative_step(w, delta_rel: float, min_step: float = 1e-12) -> float:
    """Per-tensor grid step Delta = delta_rel * std(w), in numpy f64 on the
    host as the reference computes it.  (Near-)constant tensors fall back
    to Delta = delta_rel * max|w|."""
    wf = host_f64(w)
    if wf.size == 0:
        return min_step
    std = float(wf.std())
    amax = float(np.abs(wf).max())
    scale = std if std > 1e-6 * amax else amax
    return max(delta_rel * scale, min_step)


@dataclass
class RDGridQuantizer(Quantizer):
    """Rate-distortion assignment on the equidistant grid (paper eq. 11),
    by the host oracle: a global ``delta``, or ``step_for(name, w)`` per
    tensor, and optional ``importance`` weights keyed by flat name."""

    delta: float = 0.01
    lam: float = 0.0
    num_gr: int = B.DEFAULT_NUM_GR
    step_for: Callable | None = None
    importance: dict | None = None

    def quantize(self, name: str, w) -> QuantizedTensor:
        # core.deepcabac builds its DC-v1/v2 codecs from this module
        from ..core.deepcabac import quantize_tensor_rd
        step = (self.delta if self.step_for is None
                else float(self.step_for(name, w)))
        fim = (None if self.importance is None
               else host_f64(self.importance[name]))
        return quantize_tensor_rd(host_f64(w).reshape(tuple(w.shape)), step,
                                  self.lam, fim, num_gr=self.num_gr,
                                  dtype=dtype_name(w.dtype))


@dataclass
class NearestStdQuantizer(Quantizer):
    """Nearest level on the per-tensor :func:`relative_step` grid (the
    deterministic checkpoint quantizer)."""

    delta_rel: float = 1e-3
    min_step: float = 1e-12

    def quantize(self, name: str, w) -> QuantizedTensor:
        wf = host_f64(w)
        step = relative_step(wf, self.delta_rel, self.min_step)
        levels = nearest_level(wf.ravel(), step).reshape(wf.shape)
        return QuantizedTensor(levels, step, dtype_name(w.dtype))


@dataclass
class PerChannelInt8Quantizer(Quantizer):
    """Per-output-channel symmetric int8 (the serving representation),
    through :func:`quantize_leaf` on the tensor's own device, so the
    container path and the in-memory serving path agree bit for bit."""

    def quantize(self, name: str, w: torch.Tensor) -> Q8Tensor:
        q = quantize_leaf(w)
        return Q8Tensor(levels=q["q8"].cpu().numpy(),
                        scale=q["q8s"].cpu().numpy(),
                        dtype=dtype_name(w.dtype))
