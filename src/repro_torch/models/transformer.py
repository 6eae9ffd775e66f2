"""Decoder-only backbone, dense family (port of ``repro.models.transformer``).

Layers are stacked on a leading L axis with the reference's names and
layouts; a Python loop over L takes the place of ``lax.scan``.  Stacked
q8 leaves are sliced per layer (``q8[l]`` / ``q8s[l]``), so each layer's
projections read int8 levels through ``dequant_matmul``.  Caches are
updated in place (see ``models.attention``).  The MoE, SSM and hybrid
families, MLA and layernorm are not ported yet and raise."""

from __future__ import annotations

import torch

from ..compression.tree import unflatten
from ..kernels.dequant_matmul import dequant_matmul
from ..kernels.embed_lookup import embed_lookup_q8
from ..kernels.registry import platform_of, record_event, resolve_device
from ..serve.quantized import dequant_leaf, is_q8
from .attention import gqa_attention
from .config import ModelConfig
from .layers import rms_norm, swiglu_mlp

# q8 leaves the fused dequant_matmul path consumes in place; anything else
# is dequantized in the loop body and reported once per tensor.
# (The MLA and MoE names join with the slices that port those families.)
_FUSED_ELIGIBLE = frozenset({
    "wq", "wk", "wv", "wo",                       # gqa projections
    "w_gate", "w_up", "w_down",                   # dense MLP
})

# (tensor name) already reported — loop-body dequant is a per-tensor
# decision, so it is reported once, not once per step
_reported_loop_dequant: set = set()


def _dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


def _require_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.attention != "gqa" or \
            cfg.norm != "rmsnorm":
        raise NotImplementedError(
            f"{cfg.family}/{cfg.attention}/{cfg.norm} model: not yet ported "
            "(dense GQA with RMSNorm only)")


def _record_loop_dequant(name: str, reason: str, platform: str) -> None:
    if name in _reported_loop_dequant:
        return
    _reported_loop_dequant.add(name)
    record_event(op="dequant_matmul", platform=platform,
                 impl="loop_dequant", reason=f"{name}: {reason}",
                 kind="loop_dequant")


def _fused_layer_params(lp: dict, dt: torch.dtype, platform: str) -> dict:
    """Eligible q8 leaves pass through intact (their consumer feeds the
    int8 levels to ``dequant_matmul``); ineligible ones are dequantized
    here and recorded once with ``kind="loop_dequant"``."""
    out = {}
    for key, leaf in lp.items():
        if is_q8(leaf):
            if key in _FUSED_ELIGIBLE:
                out[key] = leaf
            else:
                _record_loop_dequant(
                    key, "no fused q8 consumer for this tensor (not an "
                    "attention/MLP projection)", platform)
                out[key] = dequant_leaf(leaf, dt)
        elif isinstance(leaf, dict):
            out[key] = _fused_layer_params(leaf, dt, platform)
        else:
            out[key] = leaf
    return out


def _layer_slice(stacked, i: int):
    """Layer ``i`` of a stacked tree: q8 leaves slice levels and (L, out)
    scales together."""
    if isinstance(stacked, dict):
        return {k: _layer_slice(v, i) for k, v in stacked.items()}
    return stacked[i]


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------

def _normal(gen, shape, scale, dtype, device):
    return (torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device) * scale).to(dtype)


def _stacked(gen, n, d_in, d_out, dtype, device):
    """(n, d_in, d_out) weights, one layer at a time (no f32 stack)."""
    out = torch.empty((n, d_in, d_out), dtype=dtype, device=device)
    for i in range(n):
        out[i] = _normal(gen, (d_in, d_out), d_in ** -0.5, dtype, device)
    return out


def _layout(cfg: ModelConfig) -> dict:
    """Flat name -> (shape, init) of the parameters, in draw order.  init
    is ("normal", std), ("stacked", d_in) for (L, d_in, d_out) weights
    drawn one layer at a time with std d_in ** -0.5, "zeros" or "ones"."""
    _require_dense(cfg)
    L = cfg.num_layers
    h, g, dh, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    out: dict = {}
    if cfg.embed_input:
        out["embed"] = ((cfg.vocab_size, d), ("normal", 0.02))
    for name, d_in, d_out in (("wq", d, h * dh), ("wk", d, g * dh),
                              ("wv", d, g * dh), ("wo", h * dh, d)):
        out[f"layers/attn/{name}"] = ((L, d_in, d_out), ("stacked", d_in))
    if cfg.qkv_bias:
        for name, width in (("bq", h * dh), ("bk", g * dh), ("bv", g * dh)):
            out[f"layers/attn/{name}"] = ((L, width), "zeros")
    if cfg.qk_norm:
        out["layers/attn/q_norm"] = ((L, dh), "ones")
        out["layers/attn/k_norm"] = ((L, dh), "ones")
    out["layers/attn_norm"] = ((L, d), "ones")
    out["layers/mlp_norm"] = ((L, d), "ones")
    for name, d_in, d_out in (("w_gate", d, cfg.d_ff), ("w_up", d, cfg.d_ff),
                              ("w_down", cfg.d_ff, d)):
        out[f"layers/mlp/{name}"] = ((L, d_in, d_out), ("stacked", d_in))
    out["final_norm"] = ((d,), "ones")
    if not cfg.tie_embeddings:
        out["head"] = ((d, cfg.vocab_size), ("normal", d ** -0.5))
    return out


def param_specs(cfg: ModelConfig) -> dict:
    """Flat name -> (shape, dtype) of ``init_params(cfg)``'s tree, with no
    weight memory allocated (the template a container load checks
    against)."""
    dtype = _dtype(cfg.param_dtype)
    return {name: (shape, dtype) for name, (shape, _) in _layout(cfg).items()}


def init_params(cfg: ModelConfig, seed: int = 0, *, device="cuda") -> dict:
    """Random parameters with the reference's names, shapes and dtypes,
    drawn from a ``torch.Generator`` seeded with ``seed`` (the numbers
    differ from ``jax.random``'s; tests carry JAX parameters across with
    ``repro_torch.convert``)."""
    dev = resolve_device(device)
    dtype = _dtype(cfg.param_dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    flat = {}
    for name, (shape, init) in _layout(cfg).items():
        if init == "zeros":
            flat[name] = torch.zeros(shape, dtype=dtype, device=dev)
        elif init == "ones":
            flat[name] = torch.ones(shape, dtype=dtype, device=dev)
        elif init[0] == "stacked":
            flat[name] = _stacked(gen, *shape, dtype, dev)
        else:
            flat[name] = _normal(gen, shape, init[1], dtype, dev)
    return unflatten(flat)


# ---------------------------------------------------------------------------
# Forward / prefill / decode
# ---------------------------------------------------------------------------

def _dense_block(x, lp, cfg, positions, cache, cache_pos, qpos_canonical):
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    a, new_cache = gqa_attention(h, lp["attn"], cfg, positions, cache=cache,
                                 cache_pos=cache_pos,
                                 qpos_canonical=qpos_canonical)
    x = x + a
    x = x + swiglu_mlp(rms_norm(x, lp["mlp_norm"], cfg.norm_eps), lp["mlp"],
                       cfg.act)
    return x, new_cache


def forward(params, cfg: ModelConfig, *, tokens, positions=None,
            caches=None, cache_pos=None, last_only: bool = False,
            last_index=None):
    """Returns (logits, caches, aux).

    tokens (B, S) int.  ``last_only`` projects position -1 only;
    ``last_index`` (B,) gathers one position per row (padded-bucket
    prefill).  ``caches`` (a dict of (L, B, Smax, G, D) tensors) is
    written in place and returned."""
    _require_dense(cfg)
    dt = _dtype(cfg.compute_dtype)
    x = embed_lookup_q8(params["embed"], tokens, dt)
    b, s = x.shape[0], x.shape[1]
    dev = x.device
    platform = platform_of(x)
    qpos_canonical = None
    if positions is None:
        ar = torch.arange(s, device=dev).expand(b, s)
        if cache_pos is None:
            positions = ar
            qpos_canonical = True      # arange from 0 over this prompt
        else:
            cp = torch.as_tensor(cache_pos, device=dev)
            positions = (cp[:, None] if cp.dim() == 1 else cp) + ar

    stacked = params["layers"]
    for i in range(cfg.num_layers):
        lp = _fused_layer_params(_layer_slice(stacked, i), dt, platform)
        cache_l = None if caches is None else {k: c[i]
                                               for k, c in caches.items()}
        x, _ = _dense_block(x, lp, cfg, positions, cache_l, cache_pos,
                            qpos_canonical)

    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if last_index is not None:
        li = torch.as_tensor(last_index, device=dev)
        x = x[torch.arange(b, device=dev), li][:, None, :]
    elif last_only:
        x = x[:, -1:, :]
    logits = _head_logits(x, params, cfg)
    return logits, caches, torch.zeros((), device=dev)


def _head_logits(x, params, cfg: ModelConfig):
    """Final projection.  An untied q8 head (d, V) goes through
    ``dequant_matmul`` with x in f32; a tied q8 head transposes the
    per-row scales onto the contraction dim, so it is dequantized in the
    loop (recorded)."""
    head_leaf = params["embed"] if cfg.tie_embeddings else params["head"]
    bsz, s, d = x.shape
    if not cfg.tie_embeddings and is_q8(head_leaf):
        out = dequant_matmul(x.reshape(bsz * s, d).to(torch.float32),
                             head_leaf["q8"], head_leaf["q8s"])
        return out.reshape(bsz, s, -1)
    if cfg.tie_embeddings and is_q8(head_leaf):
        _record_loop_dequant(
            "embed.T (tied head)", "tied embedding head transposes "
            "per-vocab-row scales onto the contraction dim", platform_of(x))
    head = (dequant_leaf(head_leaf, torch.float32).T if cfg.tie_embeddings
            else dequant_leaf(head_leaf, torch.float32))
    return torch.einsum("bsd,dv->bsv", x.to(torch.float32),
                        head.to(torch.float32))


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device="cuda") -> dict:
    """Preallocated decode caches, stacked on the layer axis."""
    _require_dense(cfg)
    dev = resolve_device(device)
    dt = torch.int8 if cfg.q8_cache else _dtype(cfg.compute_dtype)
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev)}


def prefill(params, cfg: ModelConfig, *, tokens, max_len: int | None = None,
            last_index=None):
    """Process the prompt; return (last-position logits (B, V), caches).
    ``last_index`` (B,) picks each row's last real position instead of -1
    (padded prompts)."""
    b, s = tokens.shape
    caches = init_cache(cfg, b, max_len or s, device=tokens.device)
    logits, caches, _ = forward(params, cfg, tokens=tokens, caches=caches,
                                last_only=True, last_index=last_index)
    return logits[:, 0, :], caches


def decode_step(params, cfg: ModelConfig, caches, pos, *, tokens):
    """One token step.  tokens (B,); pos an int (all rows at one offset)
    or a (B,) tensor of per-row offsets (ragged continuous batching).
    Returns (logits (B, V), caches) with ``caches`` updated in place."""
    logits, caches, _ = forward(params, cfg, tokens=tokens[:, None],
                                caches=caches, cache_pos=pos, last_only=True)
    return logits[:, 0, :], caches
