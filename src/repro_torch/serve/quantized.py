"""Fixed-point serving helpers (port of ``repro.serve.quantized``): q8
weight leaves (:func:`quantize_params_for_serving`) and the int8 KV
cache."""

from __future__ import annotations

import torch

from ..compression.quantizers import quantize_tree_q8  # noqa: F401
from ..kernels.embed_lookup import is_q8_leaf

is_q8 = is_q8_leaf

DEFAULT_KV_CACHE_DELTA = 1.0 / 16.0


def quantize_params_for_serving(params):
    """int8-quantize the matmul weights: stacked layer tensors (ndim >= 3 —
    per-layer vectors stack to 2-D and stay full precision, as the paper
    leaves 1-D tensors unquantized) and the unstacked 2-D embed/head.

    This is the in-memory form of ``compression.get("serve-q8")`` — the
    codec's tree pass with {"q8","q8s"} leaf dicts instead of a container.
    """
    return quantize_tree_q8(params)


def dequant_leaf(leaf, dtype: torch.dtype):
    if is_q8(leaf):
        q, s = leaf["q8"], leaf["q8s"]
        if s.dim() == 2 and q.dim() > 2:
            # stacked leaf: scales are (L, out) for levels (L, ..., out)
            s = s.reshape((s.shape[0],) + (1,) * (q.dim() - 2)
                          + (s.shape[1],))
        return (q.to(torch.float32) * s).to(dtype)
    return leaf


def quantize_cache_value(x: torch.Tensor,
                         delta: float = DEFAULT_KV_CACHE_DELTA
                         ) -> torch.Tensor:
    """Levels of ``x`` on the grid ``delta``.  Divides by a 0-d tensor, not
    a Python scalar, which CUDA would turn into a product with 1/delta (see
    ``compression.quantizers``): a calibrated delta is no power of two."""
    d = torch.full((), delta, dtype=torch.float32, device=x.device)
    return torch.clamp(torch.round(x.to(torch.float32) / d),
                       -127, 127).to(torch.int8)


def dequant_cache_value(q: torch.Tensor, dtype: torch.dtype,
                        delta: float = DEFAULT_KV_CACHE_DELTA
                        ) -> torch.Tensor:
    return (q.to(torch.float32) * delta).to(dtype)


def calibrate_kv_cache_delta(cfg, params, tokens, margin: float = 1.05
                             ) -> float:
    """Calibrated per-model KV-cache Delta: run a full-precision prefill
    on ``tokens`` (B, S) on the parameters' device and map the observed
    attention-cache absmax to level 127 (times ``margin`` headroom).  Use
    the result as ``ServeConfig.kv_cache_delta`` /
    ``ModelConfig.kv_cache_delta``: a fixed grid silently clips
    activations out of its range.  The template that says which leaves
    ``q8_cache`` stores as int8 is built on the meta device."""
    # local imports: models.transformer imports this module at module scope
    from ..compression.tree import flatten_tree
    from ..models.transformer import init_cache, prefill

    leaf = next(iter(flatten_tree(params).values()))
    toks = torch.as_tensor(tokens).to(device=leaf.device, dtype=torch.int64)
    fp_cfg = cfg.replace(q8_cache=False)
    _, caches = prefill(params, fp_cfg, tokens=toks, max_len=toks.shape[1])
    template = init_cache(cfg.replace(q8_cache=True), toks.shape[0],
                          toks.shape[1], device="meta")
    amax = 0.0
    got_leaves = flatten_tree(caches)
    for name, want in flatten_tree(template).items():
        if want.dtype == torch.int8:   # the leaves q8_cache would quantize
            amax = max(amax, float(got_leaves[name].abs().max()))
    return max(margin * amax / 127.0, 1e-8)
