"""AdamW with optional 8-bit block-quantized moments (the port's copy of
``repro.optim.adamw``).

The math is the reference's: a global-norm clip of the gradients, bias
correction in f32 and decoupled weight decay.  The state has the
reference's layout, ``{"count", "moments": tree}``, each leaf of the tree
``{"m", "v"}`` (f32) or, with ``quantized_moments=True``, ``{"m_q", "m_s",
"v_q", "v_s"}``: int8 codes with per-block (128 along the last axis)
absmax scales from ``compression/q8.py``, ``v`` quantized in sqrt-space.
So a train state's ``state.npz`` holds the same entries in either package.

As ``torch.optim`` does, :func:`adamw_update` writes the new parameters
and moments into the tensors it was given (the reference returns new
pytrees): at full width the variational FIM keeps two f32 copies of the
model and their four moments, and a second set would not fit the card.
The 8-bit moments are decoded, updated in f32 and encoded back into the
same code and scale tensors.  ``count`` is a host ``np.int32``: the bias
correction is computed on the host.

    state = adamw_init(params, cfg)
    params, state = adamw_update(grads, state, params, cfg)
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..compression.q8 import WHOLE_Q8, q8_scale_shape
from ..compression.tree import flatten_tree, unflatten


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    quantized_moments: bool = False   # int8 m/v with blockwise scales


def adamw_init(params, cfg: AdamWConfig) -> dict:
    """{"count": 0, "moments": tree}: zero moments shaped like ``params``,
    on their devices."""
    def zeros(shape, dtype, like):
        return torch.zeros(shape, dtype=dtype, device=like.device)

    def moment(p):
        if cfg.quantized_moments:
            s = q8_scale_shape(tuple(p.shape))
            return {"m_q": zeros(p.shape, torch.int8, p),
                    "m_s": zeros(s, torch.float32, p),
                    "v_q": zeros(p.shape, torch.int8, p),
                    "v_s": zeros(s, torch.float32, p)}
        return {"m": zeros(p.shape, torch.float32, p),
                "v": zeros(p.shape, torch.float32, p)}

    return {"count": np.int32(0),
            "moments": unflatten({k: moment(p) for k, p in
                                  flatten_tree(params).items()})}


def global_norm(tree, layout=None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 (a 0-d tensor).
    With ``layout`` (``distributed.fsdp.StateLayout``) the leaves are this
    rank's boxes and the norm is the whole tree's: each box's sum is
    summed over the axes its leaf is split on only."""
    flat = flatten_tree(tree)
    if layout is not None:
        return torch.sqrt(layout.sum_squares(
            {k: torch.sum(torch.square(x.to(torch.float32)))
             for k, x in flat.items()}))
    total = sum(torch.sum(torch.square(x.to(torch.float32)))
                for x in flat.values())
    return torch.sqrt(total)


def _moments_of(state: dict) -> dict:
    """Flat param name -> that leaf's moment dict."""
    flat = flatten_tree(state["moments"])
    out: dict = {}
    for name, t in flat.items():
        path, which = name.rsplit("/", 1)
        out.setdefault(path, {})[which] = t
    return out


def adamw_update(grads, state: dict, params, cfg: AdamWConfig,
                 lr_scale=1.0, layout=None):
    """One step: updates ``params`` and ``state`` in place and returns
    them as ``(params, state)``.  ``lr_scale`` is a float or a 0-d
    tensor (the schedule's value).  With ``layout``
    (``distributed.fsdp.StateLayout``) every tensor is this rank's box of
    its leaf: the clip takes the whole tree's norm and 8-bit moments the
    whole leaf's codes (``layout.codec``)."""
    count = np.int32(state["count"] + 1)
    gnorm = global_norm(grads, layout)
    clip = torch.clamp_max(cfg.grad_clip / (gnorm + 1e-12), 1.0)
    c = np.float32(count)
    bc1 = float(np.float32(1.0) - np.float32(cfg.b1) ** c)
    bc2 = float(np.float32(1.0) - np.float32(cfg.b2) ** c)
    lr = cfg.lr * lr_scale
    flat_g = flatten_tree(grads)
    moments = _moments_of(state)
    for name, p in flatten_tree(params).items():
        g = flat_g[name].to(torch.float32) * clip
        mom = moments[name]
        q8 = WHOLE_Q8 if layout is None else layout.codec(name)
        if cfg.quantized_moments:
            m = q8.decode(mom["m_q"], mom["m_s"])
            v = q8.decode_sqrt(mom["v_q"], mom["v_s"])
        else:
            m, v = mom["m"], mom["v"]
        m.mul_(cfg.b1).add_((1.0 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1.0 - cfg.b2) * torch.square(g))
        del g
        step = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        pf = p.to(torch.float32)
        step += cfg.weight_decay * pf
        p.copy_(pf - lr * step)
        del step, pf
        if cfg.quantized_moments:
            for (q, s), (codes, scale) in (
                    (("m_q", "m_s"), q8.encode(m)),
                    (("v_q", "v_s"), q8.encode_sqrt(v))):
                mom[q].copy_(codes)
                mom[s].copy_(scale)
    state["count"] = count
    return params, state
