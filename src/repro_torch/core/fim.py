"""FIM-diagonal estimation for DC-v1 (paper §III-C-3, appendix B), the
port's copy of ``repro.core.fim``, by ``torch.autograd``.

Two routes:

* :func:`empirical_fisher_diag` — mean squared gradients (the
  Hessian-diagonal proxy of [45]).  Each gradient is squared in its
  parameter's dtype (a bf16 square for bf16 weights) and added to an f32
  accumulator, as the reference does.
* :func:`variational_fim` — the paper's route [26]: a fully factorized
  Gaussian posterior (mu, sigma = exp(rho)) trained with the
  variational-dropout KL approximation (eq. 13/14) by AdamW; returns sigma
  with F_i = 1 / sigma_i^2 and mu as the new weight value.
  :func:`vd_sparsify` is the paper's pruning rule alpha^-1 < e^-3.

A loss ``loss_fn(params, batch)`` is any function of a parameter tree
that returns a 0-d tensor autograd can differentiate (for the model:
``models.transformer.train_loss``).  Everything runs where the parameters
are.  The noise of the variational route comes from ``torch.Generator``s
seeded from ``seed`` (one per step and leaf), so it is reproducible but is
not ``jax.random``'s stream: :func:`_vd_objective` takes the noise as an
argument, so the objective can be held against the reference's formula.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterable

import numpy as np
import torch

from ..compression.tree import flatten_tree, unflatten
from ..optim.adamw import AdamWConfig, adamw_init, adamw_update

K1, K2, K3 = 0.63576, 1.87320, 1.48695
KL_CHUNK = 1 << 24        # values per piece of the KL term's gradient


def _grads(loss_fn: Callable, flat: dict, batch) -> list[torch.Tensor]:
    """d loss / d leaf for every leaf of the flat dict ``flat`` (in its
    order); a leaf the loss does not reach gets zeros, as ``jax.grad``
    gives."""
    leaves = [p.detach().requires_grad_(True) for p in flat.values()]
    with torch.enable_grad():
        loss = loss_fn(unflatten(dict(zip(flat, leaves))), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves, grads)]


def empirical_fisher_diag(loss_fn: Callable, params, batches: Iterable,
                          max_batches: int = 16):
    """Mean of squared gradients over batches — diag-Fisher proxy, as an
    f32 tree shaped like ``params``."""
    flat = flatten_tree(params)
    acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for p in flat.values()]
    n = 0
    for batch in batches:
        for a, g in zip(acc, _grads(loss_fn, flat, batch)):
            a += torch.square(g)
        n += 1
        if n >= max_batches:
            break
    return unflatten({k: a / max(n, 1) for k, a in zip(flat, acc)})


def vd_neg_kl(log_alpha: torch.Tensor) -> torch.Tensor:
    """Molchanov et al. approximation of -D_KL per parameter (paper eq. 14)."""
    return (K1 * torch.sigmoid(K2 + K3 * log_alpha)
            - 0.5 * torch.log1p(torch.exp(-log_alpha)) - K1)


def _log_alpha(rho: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    return 2.0 * rho - torch.log(torch.square(mu) + 1e-12)


@dataclass
class VariationalResult:
    mu: dict
    sigma: dict
    log_alpha: dict


def _vd_objective(loss_fn: Callable, vp: dict, batch, eps: dict,
                  beta: float) -> torch.Tensor:
    """E_q[L] + beta * KL(q || log-uniform prior) at one draw of the noise:
    ``vp`` = {"mu": tree, "rho": tree}, ``eps`` a flat dict of standard
    normal noise keyed like ``flatten_tree(vp["mu"])``.  The reference's
    objective written out; :func:`variational_fim` computes its gradient
    leaf by leaf (:func:`_vd_grads`), which tests hold against autograd of
    this function."""
    mu, rho = flatten_tree(vp["mu"]), flatten_tree(vp["rho"])
    sampled = {k: mu[k] + torch.exp(rho[k]) * eps[k] for k in mu}
    task = loss_fn(unflatten(sampled), batch)
    kl = sum(torch.sum(-vd_neg_kl(_log_alpha(rho[k], mu[k]))) for k in mu)
    return task + beta * kl


def _kl_grads(mu: torch.Tensor, rho: torch.Tensor, beta: float):
    """(d/d mu, d/d rho) of beta * sum(-vd_neg_kl(log_alpha)) for one
    leaf, by autograd over pieces of KL_CHUNK values (the term is a sum
    of independent per-value terms, so no piece needs another)."""
    gm, gr = torch.empty_like(mu), torch.empty_like(rho)
    fm, fr = mu.reshape(-1), rho.reshape(-1)
    om, orr = gm.view(-1), gr.view(-1)
    for s in range(0, fm.numel(), KL_CHUNK):
        m = fm[s:s + KL_CHUNK].detach().requires_grad_(True)
        r = fr[s:s + KL_CHUNK].detach().requires_grad_(True)
        with torch.enable_grad():
            kl = beta * torch.sum(-vd_neg_kl(_log_alpha(r, m)))
            dm, dr = torch.autograd.grad(kl, (m, r))
        om[s:s + KL_CHUNK] = dm
        orr[s:s + KL_CHUNK] = dr
    return gm, gr


def _vd_grads(loss_fn: Callable, vp: dict, batch, noise: Callable,
              beta: float) -> dict:
    """The gradient of :func:`_vd_objective` as {"mu": tree, "rho": tree},
    holding one f32 copy of the model beyond (mu, rho) and their moments:
    with s = mu + exp(rho) * eps, d/d mu of the task term is dL/ds and
    d/d rho is (dL/ds * eps) * exp(rho), autograd's own products;
    ``noise(name)`` draws eps for a leaf again instead of keeping it
    (it must return the same tensor on every call)."""
    mu, rho = flatten_tree(vp["mu"]), flatten_tree(vp["rho"])
    with torch.no_grad():
        sampled = {k: mu[k] + torch.exp(rho[k]) * noise(k) for k in mu}
    g_s = dict(zip(mu, _grads(loss_fn, sampled, batch)))
    del sampled
    g_mu, g_rho = {}, {}
    for k in mu:
        km, kr = _kl_grads(mu[k], rho[k], beta)
        with torch.no_grad():
            g = g_s.pop(k)
            g_rho[k] = (g * noise(k)) * torch.exp(rho[k]) + kr
            g_mu[k] = g.add_(km)
    return {"mu": unflatten(g_mu), "rho": unflatten(g_rho)}


def _leaf_seed(seed: int, step: int, index: int) -> int:
    return int(np.random.SeedSequence([seed, step, index]).generate_state(
        1, np.uint64)[0] >> 1)


def variational_fim(loss_fn: Callable, params, batches: Iterable,
                    steps: int = 200, beta: float = 1e-4, lr: float = 1e-3,
                    seed: int = 0) -> VariationalResult:
    """Minimize E_q[L] + beta * KL(q || log-uniform prior) over (mu, rho)
    on f32 copies of ``params``; sigma = exp(rho) starts at ~10% of |w|.
    AdamW (no weight decay, clip 10) takes ``steps`` steps over
    ``batches`` in turn, one noise draw per step."""
    flat = flatten_tree(params)
    mu = {k: p.detach().to(torch.float32).clone() for k, p in flat.items()}
    rho = {k: torch.log(0.1 * torch.abs(m) + 1e-8) for k, m in mu.items()}
    vp = {"mu": unflatten(mu), "rho": unflatten(rho)}
    index = {k: i for i, k in enumerate(mu)}

    cfg = AdamWConfig(lr=lr, weight_decay=0.0, grad_clip=10.0)
    state = adamw_init(vp, cfg)
    batch_list = list(batches)
    for i in range(steps):
        def noise(name, step=i):
            m = mu[name]
            gen = torch.Generator(m.device)
            gen.manual_seed(_leaf_seed(seed, step, index[name]))
            return torch.randn(m.shape, generator=gen, dtype=torch.float32,
                               device=m.device)
        grads = _vd_grads(loss_fn, vp, batch_list[i % len(batch_list)],
                          noise, beta)
        adamw_update(grads, state, vp, cfg)
        del grads
    del state

    with torch.no_grad():
        sigma = {k: torch.exp(r) for k, r in rho.items()}
        log_alpha = {k: torch.log(torch.square(s)
                                  / (torch.square(mu[k]) + 1e-12) + 1e-12)
                     for k, s in sigma.items()}
    return VariationalResult(mu=vp["mu"], sigma=unflatten(sigma),
                             log_alpha=unflatten(log_alpha))


def vd_sparsify(result: VariationalResult,
                threshold: float = float(np.exp(-3))) -> dict:
    """Paper appendix A pruning rule: zero params with alpha^-1 < e^-3."""
    mu, la = flatten_tree(result.mu), flatten_tree(result.log_alpha)
    # alpha^-1 = mu^2 / sigma^2
    return unflatten({k: torch.where(torch.exp(-la[k]) < threshold,
                                     torch.zeros_like(m), m)
                      for k, m in mu.items()})
