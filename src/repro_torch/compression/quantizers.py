"""Serving int8 quantization (port of the q8 part of
``repro.compression.quantizers``).

Levels and scales are bit-identical to the reference: the order of
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

import torch

STACKED_TOP_KEYS = ("layers", "dense_layers")


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
