"""Attention: GQA (+qk-norm, +bias, +M-RoPE) and MLA (port of
``repro.models.attention``).

The caches are updated **in place**: where the reference returns a new
cache array, the port writes this step's K/V (MLA: its latents) into the
preallocated cache tensor it was given and returns that same tensor.  Every
projection and the attention math go through the kernel registry with
``cfg.kernels`` (``kernels.get("dequant_matmul")`` for q8 weights,
``kernels.get("flash_attention")``: prefill on the card -> the
hand-written kernel; decode -> the naive path; MLA's d != dv -> the scan,
recorded, as in the reference).  The paged KV path is not ported yet and
raises."""

from __future__ import annotations

import torch

from .. import kernels as _kernels
from ..serve.quantized import dequant_cache_value, quantize_cache_value
from .layers import apply_m_rope, apply_rope, q8_einsum, rms_norm


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


def _kv_len(cache_pos, b, s, device):
    """(B,) int32 count of valid cache rows after this decode step."""
    off = host_offset(cache_pos)
    if off is not None:
        return torch.full((b,), off + s, dtype=torch.int32, device=device)
    return (cache_pos.to(device) + s).to(torch.int32)


def gqa_attention(x, p, cfg, positions, *, cache=None, cache_pos=None,
                  positions_3d=None, cache_pages=None,
                  qpos_canonical: bool | None = None):
    """x (B,S,d).  Returns (out (B,S,d), cache | None).

    Prefill: ``cache`` is a dict of (B, Smax, G, D) tensors filled from
    position 0.  Decode: S == 1 and ``cache_pos`` is an int (whole batch at
    one offset) or a (B,) tensor of per-row offsets.  Both write the
    cache in place.  An M-RoPE model rotates q and k by ``positions_3d``
    (3, B, S); ``positions`` still orders the cache and the causal mask."""
    if cache_pages is not None:
        raise NotImplementedError("paged KV decode: not yet ported")
    b, s, _ = x.shape
    h, g, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = q8_einsum(x, p["wq"], policy=cfg.kernels)
    k = q8_einsum(x, p["wk"], policy=cfg.kernels)
    v = q8_einsum(x, p["wv"], policy=cfg.kernels)
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, h, dh)
    k = k.reshape(b, s, g, dh)
    v = v.reshape(b, s, g, dh)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if cfg.m_rope:
        q = apply_m_rope(q, positions_3d, cfg.rope_theta,
                         cfg.m_rope_sections)
        k = apply_m_rope(k, positions_3d, cfg.rope_theta,
                         cfg.m_rope_sections)
    else:
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
        kv_len = _kv_len(cache_pos, b, s, x.device)
    elif cache is not None:                                 # prefill: fill
        cache["k"][:, :s] = _cache_store(k, cache["k"], delta)
        cache["v"][:, :s] = _cache_store(v, cache["v"], delta)
        new_cache = cache

    out = _kernels.get("flash_attention")(
        q, k, v, positions, kv_block=cfg.attn_kv_block, kv_len=kv_len,
        qpos_canonical=qpos_canonical, policy=cfg.kernels)
    out = q8_einsum(out.reshape(b, s, h * dh), p["wo"],
                    policy=cfg.kernels)
    return out, new_cache


def mla_attention(x, p, cfg, positions, *, cache=None, cache_pos=None,
                  cache_pages=None, qpos_canonical: bool | None = None):
    """DeepSeek-V3 multi-head latent attention.  x (B,S,d).  Returns
    (out (B,S,d), cache | None).

    The cache holds only the latents: ``{"ckv": (B, Smax, kv_lora_rank),
    "kr": (B, Smax, qk_rope_head_dim)}``, int8 under ``q8_cache``; prefill
    fills it from position 0, decode writes at ``cache_pos`` in place, as
    :func:`gqa_attention` does.  Keys and values are up-projected from the
    latents through ``w_uk`` / ``w_uv`` on every call, the whole cache at
    decode (the reference's recompute path).  The head dim of q and k
    (nope + rope) differs from v's, so prefill attention takes the scan
    and records it, as the reference does."""
    if cache_pages is not None:
        raise NotImplementedError("paged KV decode: not yet ported")
    b, s, _ = x.shape
    h = cfg.num_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim

    if cfg.q_lora_rank:
        ql = rms_norm(q8_einsum(x, p["w_dq"], policy=cfg.kernels),
                      p["q_norm"], cfg.norm_eps)
        q = q8_einsum(ql, p["w_uq"], policy=cfg.kernels)
    else:
        q = q8_einsum(x, p["w_uq"], policy=cfg.kernels)
    q = q.reshape(b, s, h, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    ckv = rms_norm(q8_einsum(x, p["w_dkv"], policy=cfg.kernels),
                   p["kv_norm"], cfg.norm_eps)
    kr = apply_rope(
        q8_einsum(x, p["w_kr"], policy=cfg.kernels)[:, :, None, :],
        positions, cfg.rope_theta)[:, :, 0, :]

    new_cache = None
    kv_len = None
    delta = cfg.kv_cache_delta
    if cache is not None and cache_pos is not None:        # decode
        ckv_all = _cache_update(cache["ckv"], ckv, cache_pos, delta)
        kr_all = _cache_update(cache["kr"], kr, cache_pos, delta)
        new_cache = {"ckv": ckv_all, "kr": kr_all}
        ckv = _cache_load(ckv_all, x.dtype, delta)
        kr = _cache_load(kr_all, x.dtype, delta)
        kv_len = _kv_len(cache_pos, b, s, x.device)
    elif cache is not None:                                 # prefill
        cache["ckv"][:, :s] = _cache_store(ckv, cache["ckv"], delta)
        cache["kr"][:, :s] = _cache_store(kr, cache["kr"], delta)
        new_cache = cache

    # up-project the latents (the recompute path)
    k_nope = q8_einsum(ckv, p["w_uk"],
                       policy=cfg.kernels).reshape(b, -1, h, dn)
    vv = q8_einsum(ckv, p["w_uv"], policy=cfg.kernels).reshape(b, -1, h, dv)
    k_full = torch.cat([k_nope, kr[:, :, None, :].expand(
        *kr.shape[:2], h, dr)], dim=-1)
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    out = _kernels.get("flash_attention")(
        q_full, k_full, vv, positions, kv_block=cfg.attn_kv_block,
        kv_len=kv_len, qpos_canonical=qpos_canonical, policy=cfg.kernels)
    out = q8_einsum(out.reshape(b, s, h * dv), p["wo"],
                    policy=cfg.kernels)
    return out, new_cache
