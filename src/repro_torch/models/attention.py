"""Attention: GQA (+qk-norm, +bias, +M-RoPE) and MLA (port of
``repro.models.attention``).

The caches are updated **in place**: where the reference returns a new
cache array, the port writes this step's K/V (MLA: its latents) into the
preallocated cache tensor it was given and returns that same tensor.  Every
projection and the attention math go through the kernel registry with
``cfg.kernels`` (``kernels.get("dequant_matmul")`` for q8 weights,
``kernels.get("flash_attention")``: prefill on the card -> the
hand-written kernel; decode -> the naive path; MLA's d != dv -> the scan,
recorded, as in the reference).

Paged decode (``cache_pages``) takes the same routes over a page pool
(P, page, ...) per layer: the new token's K/V (MLA: latents) is written
into ``pool[pid, pos % page]`` with ``index_put_`` on the pool the layer
was given, the page id looked up on the device (a gather of the page
table at ``pos // page``), and the rows read back as ``pool[cache_pages]``
reshaped to (B, n_max * page, ...).  Nothing is read on the host and no
pool is reallocated, so a CUDA graph captures the step and replays it
over whatever pages the serving page table names
(``repro_torch.serve.kv``)."""

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


def _paged_update_load(pool, new_vals, cache_pos, cache_pages, delta,
                       dtype):
    """Paged decode: write one token per row into the page pool in place,
    read the batch's logical views back.

    pool (P, page, ...) is the shared hot-page pool (one layer's slice of
    the stacked pools); cache_pages (B, n_max) int maps each row's logical
    page index to a pool page id.  Row ``i``'s new K/V lands in page
    ``cache_pages[i, pos // page]`` at offset ``pos % page``; the gathered
    view ``pool[cache_pages]`` reshapes to the row's contiguous
    (B, n_max * page, ...) cache.  Pool page 0 is the scheduler's scratch
    page: padding rows aim every logical page at it, so their writes
    collide harmlessly there and never touch a live page.

    Returns (pool, per-row contiguous values in ``dtype``)."""
    b, n_max = cache_pages.shape
    if new_vals.shape[1] != 1:
        raise ValueError("paged cache update is decode-only (S=1)")
    page = pool.shape[1]
    dev = pool.device
    off = host_offset(cache_pos)
    cp = (torch.full((b,), off, dtype=torch.int64, device=dev)
          if off is not None else cache_pos.to(dev, torch.int64))
    pages = cache_pages.to(dev, torch.int64)
    pid = torch.gather(pages, 1, (cp // page)[:, None])[:, 0]
    pool.index_put_((pid, cp % page),
                    _cache_store(new_vals, pool, delta)[:, 0])
    view = pool.index_select(0, pages.reshape(-1)).reshape(
        b, n_max * page, *pool.shape[2:])
    return pool, _cache_load(view, dtype, delta)


def _kv_len(cache_pos, b, s, device):
    """(B,) int32 count of valid cache rows after this decode step."""
    off = host_offset(cache_pos)
    if off is not None:
        return torch.full((b,), off + s, dtype=torch.int32, device=device)
    return (cache_pos.to(device) + s).to(torch.int32)


def gqa_attention(x, p, cfg, positions, *, cache=None, cache_pos=None,
                  positions_3d=None, cache_pages=None,
                  qpos_canonical: bool | None = None, tp=None):
    """x (B,S,d).  Returns (out (B,S,d), cache | None).

    Prefill: ``cache`` is a dict of (B, Smax, G, D) tensors filled from
    position 0.  Decode: S == 1 and ``cache_pos`` is an int (whole batch at
    one offset) or a (B,) tensor of per-row offsets.  Both write the
    cache in place.  Paged decode: the cache leaves are page pools
    (P, page, G, D) and ``cache_pages`` (B, n_max) maps each row's logical
    pages to pool pages (:func:`_paged_update_load`).  An M-RoPE model
    rotates q and k by ``positions_3d`` (3, B, S); ``positions`` still
    orders the cache and the causal mask.

    Tensor-parallel (``tp``, the train step's model group): ``cfg`` holds
    this rank's head counts and ``p`` its query heads' columns of ``wq``
    (and ``bq``), the key/value heads they read in ``wk`` / ``wv`` (and
    their biases) and the matching rows of ``wo``; the input's gradient
    and the output are summed over the group."""
    b, s, _ = x.shape
    h, g, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if tp is not None:
        x = tp.enter(x)
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
    if cache is not None and cache_pages is not None:      # paged decode
        ck, k = _paged_update_load(cache["k"], k, cache_pos, cache_pages,
                                   delta, q.dtype)
        cv, v = _paged_update_load(cache["v"], v, cache_pos, cache_pages,
                                   delta, q.dtype)
        new_cache = {"k": ck, "v": cv}
        kv_len = _kv_len(cache_pos, b, s, x.device)
    elif cache is not None and cache_pos is not None:      # decode step
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
    return (out if tp is None else tp.leave(out)), new_cache


def mla_attention(x, p, cfg, positions, *, cache=None, cache_pos=None,
                  cache_pages=None, qpos_canonical: bool | None = None):
    """DeepSeek-V3 multi-head latent attention.  x (B,S,d).  Returns
    (out (B,S,d), cache | None).

    The cache holds only the latents: ``{"ckv": (B, Smax, kv_lora_rank),
    "kr": (B, Smax, qk_rope_head_dim)}``, int8 under ``q8_cache``; prefill
    fills it from position 0, decode writes at ``cache_pos`` in place, as
    :func:`gqa_attention` does.  Keys and values are up-projected from the
    latents through ``w_uk`` / ``w_uv`` on every call, the whole cache at
    decode (the reference's recompute path).  ``cache_pages`` selects
    paged decode over (P, page, R) latent pools, as in
    :func:`gqa_attention`.  The head dim of q and k (nope + rope) differs
    from v's, so prefill attention takes the scan and records it, as the
    reference does."""
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
    if cache is not None and cache_pages is not None:      # paged decode
        ckv_all, ckv = _paged_update_load(cache["ckv"], ckv, cache_pos,
                                          cache_pages, delta, x.dtype)
        kr_all, kr = _paged_update_load(cache["kr"], kr, cache_pos,
                                        cache_pages, delta, x.dtype)
        new_cache = {"ckv": ckv_all, "kr": kr_all}
        kv_len = _kv_len(cache_pos, b, s, x.device)
    elif cache is not None and cache_pos is not None:      # decode
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
