"""Shared int8 block-quantization primitives (the port's copy of
``repro.compression.q8``).

int8 codes with per-block (``Q8_BLOCK`` along the last axis) absmax
scales: the eviction format of float KV pages (``kv_pages``) and, later,
the 8-bit AdamW moments.  Codes equal the reference's exactly and scales
bit for bit.  The arithmetic stays in the input's dtype, as ``jnp`` keeps
a bf16 array's ``/ 127.0`` in bf16, and every division divides by a 0-d
tensor of that dtype: PyTorch's CUDA kernel turns a division by a Python
scalar into a product with its reciprocal (see ``quantizers``).
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

Q8_BLOCK = 128


def q8_blockable(shape: tuple[int, ...]) -> bool:
    return len(shape) >= 1 and shape[-1] % Q8_BLOCK == 0


def _const(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(value, dtype=like.dtype, device=like.device)


def q8_encode(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x -> (int8 codes, float32 blockwise scales)."""
    if q8_blockable(tuple(x.shape)):
        b = x.reshape(*x.shape[:-1], x.shape[-1] // Q8_BLOCK, Q8_BLOCK)
        scale = torch.amax(b.abs(), dim=-1, keepdim=True) / _const(127.0, b)
        scale = torch.maximum(scale, _const(1e-12, scale))
        codes = torch.clamp(torch.round(b / scale), -127, 127).to(torch.int8)
        return codes.reshape(x.shape), scale.squeeze(-1).to(torch.float32)
    scale = x.abs().max() / _const(127.0, x)
    scale = torch.maximum(scale, _const(1e-12, scale))
    codes = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return codes, scale.to(torch.float32)


def q8_decode(codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    if codes.dim() >= 1 and codes.shape[-1] % Q8_BLOCK == 0 and \
            scale.dim() == codes.dim():
        b = codes.reshape(*codes.shape[:-1], codes.shape[-1] // Q8_BLOCK,
                          Q8_BLOCK)
        return (b.to(torch.float32) * scale[..., None]).reshape(codes.shape)
    return codes.to(torch.float32) * scale


def q8_encode_sqrt(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Second moment in sqrt-space: v spans many orders of magnitude, so
    linear absmax codes flush small entries to zero; quantizing sqrt(v)
    halves the dynamic range in log terms."""
    return q8_encode(torch.sqrt(torch.clamp_min(v, 0.0)))


def q8_decode_sqrt(codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.square(q8_decode(codes, scale))


# the whole leaf's codes and scales, as one codec object (a sharded
# state's ``distributed.fsdp.BoxQ8`` gives a box's)
WHOLE_Q8 = SimpleNamespace(encode=q8_encode, decode=q8_decode,
                           encode_sqrt=q8_encode_sqrt,
                           decode_sqrt=q8_decode_sqrt)


def q8_scale_shape(shape: tuple[int, ...]) -> tuple[int, ...]:
    if q8_blockable(shape):
        return (*shape[:-1], shape[-1] // Q8_BLOCK)
    return ()
