"""Decoder-only backbone, dense and MoE families (port of
``repro.models.transformer``).

:func:`train_loss` is the NLL the FIM differentiates: nothing in the
forward cuts autograd's graph (attention under grad takes the scan, see
``kernels.flash_attention.ops``).  Layers are stacked on a leading L axis
with the reference's names and layouts; a Python loop over L takes the
place of ``lax.scan``.  Stacked
q8 leaves are sliced per layer (``q8[l]`` / ``q8s[l]``), so each layer's
projections read int8 levels through ``dequant_matmul`` and a MoE layer's
expert banks through ``dequant_matmul_grouped``.  A MoE model runs its
leading dense layers (``dense_layers``) first, then the MoE stack
(``layers``), with nested caches ``{"dense": ..., "main": ...}``.  Caches
are updated in place (see ``models.attention``).  The SSM and hybrid
families, MLA and layernorm are not ported yet and raise."""

from __future__ import annotations

import torch

from ..compression.tree import unflatten
from ..kernels.dequant_matmul import dequant_matmul
from ..kernels.embed_lookup import embed_lookup_q8
from ..kernels.registry import platform_of, record_event, resolve_device
from ..serve.quantized import dequant_leaf, is_q8
from .attention import gqa_attention, host_offset
from .config import ModelConfig
from .layers import rms_norm, swiglu_mlp
from .moe import moe_block

# q8 leaves the fused dequant_matmul path consumes in place; anything else
# is dequantized in the loop body and reported once per tensor.
# (The MLA names join with the slice that ports that attention.)
_FUSED_ELIGIBLE = frozenset({
    "wq", "wk", "wv", "wo",                       # gqa projections
    "w_gate", "w_up", "w_down",                   # dense MLP / expert banks
    "sh_gate", "sh_up", "sh_down", "router",      # MoE shared + router
})

# (tensor name) already reported — loop-body dequant is a per-tensor
# decision, so it is reported once, not once per step
_reported_loop_dequant: set = set()


def _dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


def _require_ported(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "moe") or cfg.attention != "gqa" or \
            cfg.norm != "rmsnorm":
        raise NotImplementedError(
            f"{cfg.family}/{cfg.attention}/{cfg.norm} model: not yet ported "
            "(dense and MoE GQA with RMSNorm only)")


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


def _stacked(gen, shape, std, dtype, device):
    """(L, ...) weights drawn one layer at a time (no f32 copy of the
    stack)."""
    out = torch.empty(shape, dtype=dtype, device=device)
    for i in range(shape[0]):
        out[i] = _normal(gen, shape[1:], std, dtype, device)
    return out


def _layout(cfg: ModelConfig) -> dict:
    """Flat name -> (shape, init, dtype) of the parameters, in draw order.
    init is ("normal", std), ("stacked", std) for (L, ...) weights drawn
    one layer at a time, "zeros" or "ones".  Every leaf has the param dtype
    except a MoE router, which is f32 as in the reference."""
    _require_ported(cfg)
    pdt = _dtype(cfg.param_dtype)
    h, g, dh, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    out: dict = {}

    def add(name, shape, init, dtype=pdt):
        out[name] = (shape, init, dtype)

    def mat(name, shape, dtype=pdt):      # std d_in ** -0.5, d_in = shape[-2]
        add(name, shape, ("stacked", shape[-2] ** -0.5), dtype)

    def layer_stack(top, n, d_ff):        # attention, norms, dense MLP
        for name, d_in, d_out in (("wq", d, h * dh), ("wk", d, g * dh),
                                  ("wv", d, g * dh), ("wo", h * dh, d)):
            mat(f"{top}/attn/{name}", (n, d_in, d_out))
        if cfg.qkv_bias:
            for name, width in (("bq", h * dh), ("bk", g * dh),
                                ("bv", g * dh)):
                add(f"{top}/attn/{name}", (n, width), "zeros")
        if cfg.qk_norm:
            add(f"{top}/attn/q_norm", (n, dh), "ones")
            add(f"{top}/attn/k_norm", (n, dh), "ones")
        add(f"{top}/attn_norm", (n, d), "ones")
        add(f"{top}/mlp_norm", (n, d), "ones")
        if d_ff:
            for name, d_in, d_out in (("w_gate", d, d_ff), ("w_up", d, d_ff),
                                      ("w_down", d_ff, d)):
                mat(f"{top}/mlp/{name}", (n, d_in, d_out))

    if cfg.embed_input:
        add("embed", (cfg.vocab_size, d), ("normal", 0.02))
    if cfg.family == "dense":
        layer_stack("layers", cfg.num_layers, cfg.d_ff)
    else:
        nd = cfg.first_dense_layers
        if nd:
            layer_stack("dense_layers", nd, cfg.d_ff)
        n = cfg.num_layers - nd
        layer_stack("layers", n, 0)
        e, f = cfg.num_experts, cfg.moe_d_ff
        mat("layers/moe/router", (n, d, e), torch.float32)
        for name, d_in, d_out in (("w_gate", d, f), ("w_up", d, f),
                                  ("w_down", f, d)):
            mat(f"layers/moe/{name}", (n, e, d_in, d_out))
        if cfg.num_shared_experts:
            fs = cfg.num_shared_experts * f
            for name, d_in, d_out in (("sh_gate", d, fs), ("sh_up", d, fs),
                                      ("sh_down", fs, d)):
                mat(f"layers/moe/{name}", (n, d_in, d_out))
    add("final_norm", (d,), "ones")
    if not cfg.tie_embeddings:
        add("head", (d, cfg.vocab_size), ("normal", d ** -0.5))
    return out


def param_specs(cfg: ModelConfig) -> dict:
    """Flat name -> (shape, dtype) of ``init_params(cfg)``'s tree, leaf by
    leaf, with no weight memory allocated (the template a container load
    checks against)."""
    return {name: (shape, dtype)
            for name, (shape, _, dtype) in _layout(cfg).items()}


def init_params(cfg: ModelConfig, seed: int = 0, *, device="cuda") -> dict:
    """Random parameters with the reference's names, shapes and dtypes,
    drawn from a ``torch.Generator`` seeded with ``seed`` (the numbers
    differ from ``jax.random``'s; tests carry JAX parameters across with
    ``repro_torch.convert``)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    flat = {}
    for name, (shape, init, dtype) in _layout(cfg).items():
        if init == "zeros":
            flat[name] = torch.zeros(shape, dtype=dtype, device=dev)
        elif init == "ones":
            flat[name] = torch.ones(shape, dtype=dtype, device=dev)
        elif init[0] == "stacked":
            flat[name] = _stacked(gen, shape, init[1], dtype, dev)
        else:
            flat[name] = _normal(gen, shape, init[1], dtype, dev)
    return unflatten(flat)


# ---------------------------------------------------------------------------
# Forward / prefill / decode
# ---------------------------------------------------------------------------

def _attn_block(x, lp, cfg, positions, cache, cache_pos, qpos_canonical):
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    a, _ = gqa_attention(h, lp["attn"], cfg, positions, cache=cache,
                         cache_pos=cache_pos, qpos_canonical=qpos_canonical)
    return x + a


def _dense_block(x, lp, cfg, *attn_args, with_aux=True):
    x = _attn_block(x, lp, cfg, *attn_args)
    x = x + swiglu_mlp(rms_norm(x, lp["mlp_norm"], cfg.norm_eps), lp["mlp"],
                       cfg.act)
    return x, None


def _moe_layer_block(x, lp, cfg, *attn_args, with_aux=True):
    x = _attn_block(x, lp, cfg, *attn_args)
    m, aux = moe_block(rms_norm(x, lp["mlp_norm"], cfg.norm_eps), lp["moe"],
                       cfg, with_aux=with_aux)
    return x + m, aux


_BLOCKS = {"dense": _dense_block, "moe": _moe_layer_block}


def _stacks(params, cfg: ModelConfig, caches):
    """(stacked params, layer count, block, caches) of each layer stack in
    the order they run: a MoE model's leading dense layers, then the rest."""
    nd = cfg.first_dense_layers if cfg.family == "moe" else 0
    if not nd:
        return [(params["layers"], cfg.num_layers, _BLOCKS[cfg.family],
                 caches)]
    return [(params["dense_layers"], nd, _dense_block,
             None if caches is None else caches["dense"]),
            (params["layers"], cfg.num_layers - nd, _moe_layer_block,
             None if caches is None else caches["main"])]


def forward(params, cfg: ModelConfig, *, tokens, positions=None,
            caches=None, cache_pos=None, last_only: bool = False,
            last_index=None, with_aux: bool = True):
    """Returns (logits, caches, aux).

    tokens (B, S) int.  ``last_only`` projects position -1 only;
    ``last_index`` (B,) gathers one position per row (padded-bucket
    prefill).  ``caches`` (``init_cache``'s tree of (L, B, Smax, G, D)
    tensors) is written in place and returned.  ``aux`` is the MoE
    load-balance loss summed over layers (0 for a dense model), or None
    unless ``with_aux``: :func:`prefill` and :func:`decode_step` skip it,
    as the reference's compiled serving steps drop it.

    Nothing here reads a device value on the host, so a CUDA graph can
    capture a step: offsets are Python ints or device tensors (see
    ``models.attention.host_offset``)."""
    _require_ported(cfg)
    dt = _dtype(cfg.compute_dtype)
    x = embed_lookup_q8(params["embed"], tokens, dt)
    b, s = x.shape[0], x.shape[1]
    dev = x.device
    platform = platform_of(x)
    qpos_canonical = None
    if positions is None:
        ar = torch.arange(s, device=dev).expand(b, s)
        off = None if cache_pos is None else host_offset(cache_pos)
        if cache_pos is None:
            positions = ar
            qpos_canonical = True      # arange from 0 over this prompt
        elif off is not None:
            positions = ar + off
            qpos_canonical = off == 0
        else:
            positions = cache_pos.to(dev)[:, None] + ar

    aux = (torch.zeros((), dtype=torch.float32, device=dev) if with_aux
           else None)
    for stacked, n, block, stack_caches in _stacks(params, cfg, caches):
        for i in range(n):
            lp = _fused_layer_params(_layer_slice(stacked, i), dt, platform)
            cache_l = None if stack_caches is None else {
                k: c[i] for k, c in stack_caches.items()}
            x, a = block(x, lp, cfg, positions, cache_l, cache_pos,
                         qpos_canonical, with_aux=with_aux)
            if a is not None:
                aux = aux + a

    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if last_index is not None:
        li = torch.as_tensor(last_index, device=dev)
        x = x[torch.arange(b, device=dev), li][:, None, :]
    elif last_only:
        x = x[:, -1:, :]
    logits = _head_logits(x, params, cfg)
    return logits, caches, aux


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


def train_loss(params, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """Mean next-token NLL of ``batch`` (tokens and labels (B, S) int
    tensors, ``data.pipeline.to_device``), as a 0-d f32 tensor that
    autograd differentiates; a MoE model adds
    ``router_aux_weight * aux / num_layers``."""
    logits, _, aux = forward(params, cfg, tokens=batch["tokens"])
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, batch["labels"][..., None])[..., 0]
    loss = -torch.mean(ll)
    if cfg.family == "moe":
        loss = loss + cfg.router_aux_weight * aux / max(cfg.num_layers, 1)
    return loss


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device="cuda") -> dict:
    """Preallocated decode caches, stacked on the layer axis: {"k", "v"}
    of (L, B, Smax, G, D), or for a MoE model with leading dense layers
    {"dense": {"k", "v"}, "main": {"k", "v"}}."""
    _require_ported(cfg)
    dev = resolve_device(device)
    dt = torch.int8 if cfg.q8_cache else _dtype(cfg.compute_dtype)

    def attn_cache(n_layers):
        shape = (n_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=dt, device=dev),
                "v": torch.zeros(shape, dtype=dt, device=dev)}

    nd = cfg.first_dense_layers if cfg.family == "moe" else 0
    if nd:
        return {"dense": attn_cache(nd),
                "main": attn_cache(cfg.num_layers - nd)}
    return attn_cache(cfg.num_layers)


def prefill(params, cfg: ModelConfig, *, tokens, max_len: int | None = None,
            last_index=None):
    """Process the prompt; return (last-position logits (B, V), caches).
    ``last_index`` (B,) picks each row's last real position instead of -1
    (padded prompts)."""
    b, s = tokens.shape
    caches = init_cache(cfg, b, max_len or s, device=tokens.device)
    logits, caches, _ = forward(params, cfg, tokens=tokens, caches=caches,
                                last_only=True, last_index=last_index,
                                with_aux=False)
    return logits[:, 0, :], caches


def decode_step(params, cfg: ModelConfig, caches, pos, *, tokens):
    """One token step.  tokens (B,); pos an int (all rows at one offset)
    or a (B,) tensor of per-row offsets (ragged continuous batching).
    Returns (logits (B, V), caches) with ``caches`` updated in place."""
    logits, caches, _ = forward(params, cfg, tokens=tokens[:, None],
                                caches=caches, cache_pos=pos, last_only=True,
                                with_aux=False)
    return logits[:, 0, :], caches
