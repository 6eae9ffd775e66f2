"""GQA attention (port of ``repro.models.attention``, GQA path only).

The caches are updated **in place**: where the reference returns a new
cache array, the port writes this step's K/V into the preallocated cache
tensor it was given and returns that same tensor.  The attention math is
routed by ``kernels.flash_attention.attention`` (prefill on the card ->
the hand-written kernel; decode -> the naive path).  The paged KV path is
not ported yet and raises; MLA models are refused by the transformer."""

from __future__ import annotations

import torch

from ..kernels.flash_attention import attention as attend
from ..serve.quantized import dequant_cache_value, quantize_cache_value
from .layers import apply_rope, q8_einsum, rms_norm


def _cache_store(x, cache_arr, delta):
    """Quantize to the cache's storage dtype (int8 fixed-point serving)."""
    if cache_arr.dtype == torch.int8:
        return quantize_cache_value(x, delta)
    return x.to(cache_arr.dtype)


def _cache_load(arr, dtype, delta):
    if arr.dtype == torch.int8:
        return dequant_cache_value(arr, dtype, delta)
    return arr


def host_offset(cache_pos) -> int | None:
    """The offset every row writes at, as a host int (``cache_pos`` an int
    or a 0-d tensor on the CPU), or None for a (B,) tensor of per-row
    offsets, which the step reads on the device.  A 0-d tensor on the card
    is refused: reading it would sync the host with the card, which a CUDA
    graph cannot capture."""
    if not isinstance(cache_pos, torch.Tensor):
        return int(cache_pos)
    if cache_pos.dim() == 1:
        return None
    if cache_pos.dim() == 0 and not cache_pos.is_cuda:
        return int(cache_pos)
    raise ValueError(
        f"cache_pos must be an int, a 0-d CPU tensor or a (B,) tensor; got "
        f"shape {tuple(cache_pos.shape)} on {cache_pos.device}")


def _cache_update(cache_arr, new_vals, cache_pos, delta):
    """Write this step's K/V into ``cache_arr`` (B, Smax, ...) in place.

    cache_pos int / 0-d CPU tensor: all rows write at the same offset.
    cache_pos (B,) int tensor: per-slot ragged positions (continuous
    batching) — each row writes its single new entry at its own offset."""
    vals = _cache_store(new_vals, cache_arr, delta)
    start = host_offset(cache_pos)
    if start is not None:
        cache_arr[:, start:start + vals.shape[1]] = vals
        return cache_arr
    if new_vals.shape[1] != 1:
        raise ValueError("ragged cache update is decode-only (S=1)")
    b = cache_arr.shape[0]
    rows = torch.arange(b, device=cache_arr.device)
    cache_arr[rows, cache_pos.to(cache_arr.device)] = vals[:, 0]
    return cache_arr


def gqa_attention(x, p, cfg, positions, *, cache=None, cache_pos=None,
                  cache_pages=None, qpos_canonical: bool | None = None):
    """x (B,S,d).  Returns (out (B,S,d), cache | None).

    Prefill: ``cache`` is a dict of (B, Smax, G, D) tensors filled from
    position 0.  Decode: S == 1 and ``cache_pos`` is an int (whole batch at
    one offset) or a (B,) tensor of per-row offsets.  Both write the
    cache in place."""
    if cache_pages is not None:
        raise NotImplementedError("paged KV decode: not yet ported")
    if cfg.m_rope:
        raise NotImplementedError("m_rope: not yet ported")
    b, s, _ = x.shape
    h, g, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = q8_einsum(x, p["wq"])
    k = q8_einsum(x, p["wk"])
    v = q8_einsum(x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, h, dh)
    k = k.reshape(b, s, g, dh)
    v = v.reshape(b, s, g, dh)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    new_cache = None
    kv_len = None
    delta = cfg.kv_cache_delta
    if cache is not None and cache_pos is not None:        # decode step
        ck = _cache_update(cache["k"], k, cache_pos, delta)
        cv = _cache_update(cache["v"], v, cache_pos, delta)
        new_cache = {"k": ck, "v": cv}
        k = _cache_load(ck, q.dtype, delta)
        v = _cache_load(cv, q.dtype, delta)
        off = host_offset(cache_pos)
        kv_len = (torch.full((b,), off + s, dtype=torch.int32,
                             device=x.device) if off is not None else
                  (cache_pos.to(x.device) + s).to(torch.int32))
    elif cache is not None:                                 # prefill: fill
        cache["k"][:, :s] = _cache_store(k, cache["k"], delta)
        cache["v"][:, :s] = _cache_store(v, cache["v"], delta)
        new_cache = cache

    out = attend(q, k, v, positions, kv_block=cfg.attn_kv_block,
                 kv_len=kv_len, qpos_canonical=qpos_canonical)
    out = q8_einsum(out.reshape(b, s, h * dh), p["wo"])
    return out, new_cache
