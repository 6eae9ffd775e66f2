"""AdamW with f32 moments (the port's copy of ``repro.optim.adamw``).

The math is the reference's: a global-norm clip of the gradients, bias
correction in f32 and decoupled weight decay.  As ``torch.optim`` does,
:func:`adamw_update` writes the new parameters and moments into the
tensors it was given (the reference returns new pytrees): at full width
the variational FIM keeps two f32 copies of the model and their four
moments, and a second set would not fit the card.  The 8-bit moments
(``quantized_moments=True``) need ``compression/q8.py`` and wait with the
training slice.

    state = adamw_init(params, cfg)
    params, state = adamw_update(grads, state, params, cfg)
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

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
    """{"count": 0, "m": tree, "v": tree}: zero f32 moments shaped like
    ``params``, on their devices."""
    if cfg.quantized_moments:
        raise NotImplementedError(
            "quantized_moments: not yet ported (needs compression/q8.py)")

    def zeros():
        return unflatten({k: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device)
                          for k, p in flatten_tree(params).items()})
    return {"count": 0, "m": zeros(), "v": zeros()}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 (a 0-d tensor)."""
    leaves = list(flatten_tree(tree).values())
    total = sum(torch.sum(torch.square(x.to(torch.float32)))
                for x in leaves)
    return torch.sqrt(total)


def adamw_update(grads, state: dict, params, cfg: AdamWConfig,
                 lr_scale: float = 1.0):
    """One step: updates ``params`` and ``state`` in place and returns
    them as ``(params, state)``."""
    count = state["count"] + 1
    gnorm = global_norm(grads)
    clip = torch.clamp_max(cfg.grad_clip / (gnorm + 1e-12), 1.0)
    c = np.float32(count)
    bc1 = float(np.float32(1.0) - np.float32(cfg.b1) ** c)
    bc2 = float(np.float32(1.0) - np.float32(cfg.b2) ** c)
    lr = cfg.lr * lr_scale
    flat_g = flatten_tree(grads)
    flat_m, flat_v = flatten_tree(state["m"]), flatten_tree(state["v"])
    for name, p in flatten_tree(params).items():
        g = flat_g[name].to(torch.float32) * clip
        m, v = flat_m[name], flat_v[name]
        m.mul_(cfg.b1).add_((1.0 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1.0 - cfg.b2) * torch.square(g))
        del g
        step = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        pf = p.to(torch.float32)
        step += cfg.weight_decay * pf
        p.copy_(pf - lr * step)
    state["count"] = count
    return params, state
