"""The port's training-side pieces against the JAX package, on the CPU:
the synthetic batches, ``train_loss`` and its gradients by autograd
against ``jax.grad`` (dense and MoE smoke models), the empirical FIM
(including its square in the parameter's dtype), AdamW, the
variational-dropout objective with fixed noise and its leaf-by-leaf
gradient, and the appendix-B toy behaviour of ``variational_fim``.

Weights and batches are made with numpy from a seed and carried across
with ``repro_torch.convert``; every tolerance is stated beside its
assertion.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.compression.tree import flatten_tree as jflatten  # noqa: E402
from repro.core import fim as jfim  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.compression import flatten_tree, unflatten  # noqa: E402
from repro_torch.convert import (params_from_numpy,  # noqa: E402
                                 tensor_to_numpy)
from repro_torch.core import fim  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

ARCHS = ["llama3-8b", "deepseek-moe-16b"]
GRAD_TOL = 1e-4          # |port - ref| <= GRAD_TOL * max|ref|, per leaf
LOSS_RTOL = 1e-5


def _np(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float64)


def _leaf_close(got: dict, want: dict, tol: float) -> None:
    assert sorted(got) == sorted(want)
    for k in want:
        w, g = _np(want[k]), _np(tensor_to_numpy(got[k])
                                 if isinstance(got[k], torch.Tensor)
                                 else got[k])
        assert g.shape == w.shape, k
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g - w).max())
        assert err <= tol * scale, (k, err, scale)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(jax cfg, port cfg, jax params, port params, jax batches, port
    batches): the reference's smoke init carried across."""
    jcfg = jconfigs.get(request.param, smoke=True)
    cfg = configs.get(request.param, smoke=True)
    jp = jtf.init_params(jcfg, jax.random.PRNGKey(3))
    flat = {k: np.asarray(v) for k, v in jflatten(jp).items()}
    tp = params_from_numpy(flat, "cpu")
    jbs = [jpipe.make_batch(jcfg, i, batch=2, seq=12, seed=5)
           for i in range(2)]
    tbs = [pipeline.to_device(pipeline.make_batch(cfg, i, batch=2, seq=12,
                                                  seed=5), "cpu")
           for i in range(2)]
    return jcfg, cfg, jp, tp, jbs, tbs


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_make_batch_equals_reference(arch):
    jcfg, cfg = jconfigs.get(arch, smoke=True), configs.get(arch, smoke=True)
    for step, seed in ((0, 1234), (7, 3), (123, 9)):
        want = jpipe.make_batch(jcfg, step, batch=3, seq=10, seed=seed)
        got = pipeline.make_batch(cfg, step, batch=3, seq=10, seed=seed)
        assert sorted(got) == sorted(want)
        for k in want:                           # exact, dtype included
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    for g, w in zip(pipeline.make_eval_batches(cfg, 2, batch=2, seq=5),
                    jpipe.make_eval_batches(jcfg, 2, batch=2, seq=5)):
        np.testing.assert_array_equal(g["tokens"], w["tokens"])
        np.testing.assert_array_equal(g["labels"], w["labels"])
    dev = pipeline.to_device(got, "cpu")
    assert all(t.dtype == torch.int64 for t in dev.values())
    extra = pipeline.to_device({"embeds": np.zeros((1, 2, 3), np.float32),
                                "pos3d": np.zeros((3, 1, 2), np.int32)},
                               "cpu")
    assert extra["embeds"].dtype == torch.float32
    assert extra["pos3d"].dtype == torch.int64
    with pytest.raises(ValueError, match="batch inputs"):
        pipeline.to_device({**got, "frames": np.zeros(1)}, "cpu")


# ---------------------------------------------------------------------------
# train_loss and its gradients
# ---------------------------------------------------------------------------

def test_train_loss_and_gradients_match_jax_grad(model):
    jcfg, cfg, jp, tp, jbs, tbs = model
    for jb, tb in zip(jbs, tbs):
        jloss, jg = jax.jit(jax.value_and_grad(
            lambda p, b: jtf.train_loss(p, b, jcfg)))(jp, jb)
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in flatten_tree(tp).items()}
        loss = ttf.train_loss(unflatten(leaves), tb, cfg)
        loss.backward()
        assert loss.dtype == torch.float32
        # loss: rel LOSS_RTOL
        np.testing.assert_allclose(loss.item(), float(jloss),
                                   rtol=LOSS_RTOL)
        # gradients: each leaf within GRAD_TOL of its max|g|
        _leaf_close({k: v.grad for k, v in leaves.items()},
                    {k: np.asarray(v) for k, v in jflatten(jg).items()},
                    GRAD_TOL)
        for name in ("wq", "wk", "wv"):          # through attention
            assert float(leaves[f"layers/attn/{name}"].grad.abs().max()) > 0


def test_empirical_fisher_matches_reference(model):
    jcfg, cfg, jp, tp, jbs, tbs = model
    want = jfim.empirical_fisher_diag(
        lambda p, b: jtf.train_loss(p, b, jcfg), jp, jbs)
    got = fim.empirical_fisher_diag(
        lambda p, b: ttf.train_loss(p, b, cfg), tp, tbs)
    assert all(v.dtype == torch.float32 for v in flatten_tree(got).values())
    # F = mean g^2: each leaf within GRAD_TOL of its max|F|
    _leaf_close(flatten_tree(got),
                {k: np.asarray(v) for k, v in jflatten(want).items()},
                GRAD_TOL)


def test_empirical_fisher_squares_in_the_parameter_dtype():
    """bf16 gradients are squared in bf16 before the f32 accumulation, as
    the reference does: a loss linear in w makes the gradient c exactly in
    both packages, and c^2 is not a bf16 number."""
    c = np.array([1.0 + 2 ** -7, 3.0 + 2 ** -6, -5.0 - 2 ** -5, 0.5],
                 np.float32)
    w0 = np.array([0.25, -1.0, 2.0, 0.0], np.float32)
    jparams = {"w": jnp.asarray(w0, jnp.bfloat16)}
    want = jfim.empirical_fisher_diag(
        lambda p, b: jnp.sum(p["w"] * jnp.asarray(c, jnp.bfloat16)),
        jparams, [0, 1])
    tparams = {"w": torch.from_numpy(w0).to(torch.bfloat16)}
    got = fim.empirical_fisher_diag(
        lambda p, b: torch.sum(p["w"] * torch.from_numpy(c).to(
            torch.bfloat16)), tparams, [0, 1])
    assert got["w"].dtype == torch.float32
    np.testing.assert_array_equal(got["w"].numpy(),
                                  np.asarray(want["w"]))      # exact
    assert not np.array_equal(got["w"].numpy(), c.astype(np.float32) ** 2)


def test_attention_under_grad_takes_the_scan(monkeypatch):
    """A call autograd differentiates never reaches the kernel's wrapper;
    a forward-only call on the CPU takes the scan too (platform default)."""
    def boom(*a, **k):
        raise AssertionError("flash kernel reached under grad")
    monkeypatch.setattr(fa_ops, "flash_attention", boom)
    q = torch.randn(1, 8, 4, 32, requires_grad=True)
    k = torch.randn(1, 8, 2, 32)
    v = torch.randn(1, 8, 2, 32)
    out = fa_ops.attention(q, k, v, torch.arange(8)[None])
    out.sum().backward()
    assert q.grad is not None and float(q.grad.abs().max()) > 0
    assert fa_ops._wants_grad(q, k, v)
    with torch.no_grad():
        assert not fa_ops._wants_grad(q, k, v)
    assert not fa_ops._wants_grad(q.detach(), k, v)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def test_adamw_three_steps_match_reference():
    rng = np.random.default_rng(0)
    shapes = {"a": (6, 5), "b/c": (7,), "b/d": (3, 2, 4)}
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * 3).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    for kw in ({}, {"weight_decay": 0.0, "grad_clip": 10.0, "lr": 1e-2}):
        jcfg, tcfg = jadamw.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
        jp = unflatten({k: jnp.asarray(v) for k, v in p0.items()})
        tp = unflatten({k: torch.from_numpy(v.copy()) for k, v in p0.items()})
        jst, tst = jadamw.adamw_init(jp, jcfg), adamw.adamw_init(tp, tcfg)
        for g in grads:
            jp, jst = jadamw.adamw_update(
                unflatten({k: jnp.asarray(v) for k, v in g.items()}),
                jst, jp, jcfg)
            tp, tst = adamw.adamw_update(
                unflatten({k: torch.from_numpy(v) for k, v in g.items()}),
                tst, tp, tcfg)
        assert tst["count"] == int(jst["count"]) == 3
        for k, v in jflatten(jp).items():          # rel 1e-6
            np.testing.assert_allclose(flatten_tree(tp)[k].numpy(),
                                       np.asarray(v), rtol=1e-6, atol=0)
        # the moments: within 1e-6 of each leaf's max|moment| (b1*m +
        # (1-b1)*g cancels, and XLA may fuse it into an FMA)
        for k, mom in jflatten(jst["moments"]).items():
            *path, which = k.split("/")
            mom = np.asarray(mom)
            np.testing.assert_allclose(
                flatten_tree(tst[which])["/".join(path)].numpy(), mom,
                rtol=0, atol=1e-6 * float(np.abs(mom).max()))
    np.testing.assert_allclose(
        float(adamw.global_norm(unflatten({k: torch.from_numpy(v)
                                           for k, v in grads[0].items()}))),
        float(jadamw.global_norm({k: jnp.asarray(v)
                                  for k, v in grads[0].items()})),
        rtol=1e-6)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        adamw.adamw_init(tp, adamw.AdamWConfig(quantized_moments=True))


# ---------------------------------------------------------------------------
# variational FIM
# ---------------------------------------------------------------------------

def test_vd_neg_kl_matches_reference():
    la = np.linspace(-12, 12, 97).astype(np.float32)
    np.testing.assert_allclose(                     # rel 1e-5
        fim.vd_neg_kl(torch.from_numpy(la)).numpy(),
        np.asarray(jfim.vd_neg_kl(jnp.asarray(la))), rtol=1e-5, atol=1e-7)


def _vp_and_eps(flat: dict, seed: int):
    rng = np.random.default_rng(seed)
    mu = {k: v.astype(np.float32) for k, v in flat.items()}
    rho = {k: np.log(0.1 * np.abs(v) + 1e-8).astype(np.float32)
           for k, v in mu.items()}
    eps = {k: rng.standard_normal(v.shape).astype(np.float32)
           for k, v in mu.items()}
    return mu, rho, eps


def test_vd_objective_with_fixed_noise_matches_reference_formula(model):
    """The reference's objective (``repro.core.fim.variational_fim``'s
    ``objective``) written out with jnp at a fixed draw of the noise.  The
    per-value KL terms are the reference's, summed in f64: XLA's f32 sum on
    the CPU drifts by more than the tolerance over the MoE expert banks
    (131072 terms of 2.94: jnp 385165.66, f64 385214.39, numpy and torch
    f32 385214.375)."""
    jcfg, cfg, jp, tp, jbs, tbs = model
    flat = {k: np.asarray(v) for k, v in jflatten(jp).items()}
    mu, rho, eps = _vp_and_eps(flat, 4)
    beta = 1e-4

    def ref_objective(m, r, e, batch):
        sampled = {k: m[k] + jnp.exp(r[k]) * e[k] for k in m}
        task = jtf.train_loss(unflatten(sampled), batch, jcfg)
        terms = [-jfim.vd_neg_kl(2.0 * r[k] - jnp.log(
            jnp.square(m[k]) + 1e-12)) for k in sorted(m)]
        return task, terms

    j = {n: {k: jnp.asarray(v) for k, v in d.items()}
         for n, d in (("m", mu), ("r", rho), ("e", eps))}
    task, terms = jax.jit(ref_objective)(j["m"], j["r"], j["e"], jbs[0])
    want = float(task) + beta * sum(float(np.sum(np.asarray(t, np.float64)))
                                    for t in terms)
    t = {n: {k: torch.from_numpy(v) for k, v in d.items()}
         for n, d in (("m", mu), ("r", rho), ("e", eps))}
    vp = {"mu": unflatten(t["m"]), "rho": unflatten(t["r"])}
    got = float(fim._vd_objective(lambda p, b: ttf.train_loss(p, b, cfg),
                                  vp, tbs[0], t["e"], beta))
    np.testing.assert_allclose(got, want, rtol=1e-5)          # rel 1e-5


def test_vd_grads_equal_autograd_of_the_objective(model):
    """The leaf-by-leaf gradient ``variational_fim`` takes (one f32 model
    copy, the noise drawn again) against autograd of the whole objective:
    the same products, so rel 1e-6."""
    jcfg, cfg, jp, tp, jbs, tbs = model
    flat = {k: tensor_to_numpy(v) for k, v in flatten_tree(tp).items()}
    mu, rho, eps = _vp_and_eps(flat, 6)
    beta = 3e-3

    def loss_fn(p, b):
        return ttf.train_loss(p, b, cfg)
    m = {k: torch.from_numpy(v).requires_grad_(True) for k, v in mu.items()}
    r = {k: torch.from_numpy(v).requires_grad_(True) for k, v in rho.items()}
    e = {k: torch.from_numpy(v) for k, v in eps.items()}
    obj = fim._vd_objective(loss_fn, {"mu": unflatten(m),
                                      "rho": unflatten(r)}, tbs[1], e, beta)
    obj.backward()
    vp = {"mu": unflatten({k: v.detach() for k, v in m.items()}),
          "rho": unflatten({k: v.detach() for k, v in r.items()})}
    old_chunk = fim.KL_CHUNK
    fim.KL_CHUNK = 1000                 # several pieces per leaf
    try:
        g = fim._vd_grads(loss_fn, vp, tbs[1], lambda k: e[k], beta)
    finally:
        fim.KL_CHUNK = old_chunk
    for which, leaves in (("mu", m), ("rho", r)):
        got = flatten_tree(g[which])
        for k, v in leaves.items():
            np.testing.assert_allclose(got[k].numpy(), v.grad.numpy(),
                                       rtol=1e-6, atol=1e-12 * float(
                                           v.grad.abs().max()))


def test_empirical_fisher_identifies_important_weight():
    """tests/test_fim_and_baselines.py's toy on the port."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((256, 8)).astype(np.float32)
    w_true = np.zeros(8, np.float32)
    w_true[0] = 2.0
    y = x @ w_true
    params = {"w": torch.from_numpy(
        (w_true + 0.01 * rng.standard_normal(8)).astype(np.float32)) + 0.1}

    def loss(p, batch):
        xb, yb = batch
        return torch.mean(torch.square(xb @ p["w"] - yb))
    batches = [(torch.from_numpy(x[i::4]), torch.from_numpy(y[i::4]))
               for i in range(4)]
    f = fim.empirical_fisher_diag(loss, params, batches)["w"].numpy()
    assert f[0] > 0 and np.all(np.isfinite(f))


def test_variational_fim_sigma_reflects_curvature():
    """Paper appendix B (tests/test_fim_and_baselines.py:44 on the port):
    sigma_i^2 ~ beta / H_i — the high-curvature direction gets the small
    posterior std, and the pruning rule keeps the useful weights."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((512, 4)).astype(np.float32)
    x[:, 0] *= 10.0                  # 100x curvature on feature 0
    w_true = np.array([1.0, 1.0, 1.0, 0.0], np.float32)
    y = x @ w_true
    params = {"w": torch.from_numpy(
        (w_true + 0.01 * rng.standard_normal(4)).astype(np.float32))}

    def loss(p, batch):
        xb, yb = batch
        return torch.mean(torch.square(xb @ p["w"] - yb))
    batches = [(torch.from_numpy(x[i::4]), torch.from_numpy(y[i::4]))
               for i in range(4)]
    w0 = params["w"].clone()
    res = fim.variational_fim(loss, params, batches, steps=500, beta=1e-3,
                              lr=5e-3, seed=0)
    sigma = res.sigma["w"].numpy()
    assert sigma[0] < sigma[1] and sigma[0] < sigma[2], sigma
    pruned = fim.vd_sparsify(res)["w"].numpy()
    assert pruned[0] != 0.0 and pruned[1] != 0.0
    # the same seed draws the same noise: a rerun is bit-identical
    again = fim.variational_fim(loss, params, batches, steps=5, beta=1e-3,
                                lr=5e-3, seed=0)
    once = fim.variational_fim(loss, params, batches, steps=5, beta=1e-3,
                               lr=5e-3, seed=0)
    np.testing.assert_array_equal(again.sigma["w"].numpy(),
                                  once.sigma["w"].numpy())
    assert torch.equal(params["w"], w0)         # the input is not touched
