"""The paper's search loops in the port against the JAX package, on the
CPU: DC-v1/DC-v2 (eq. 12, the grids, the nearest-neighbour screening and
both searches: the same choice and byte-identical blobs), the RD Pareto
sweep (``rd_sweep`` on the llama3-8b smoke model, once with F = 1 and once
with one FIM passed to both packages: equal points, policy and policy
bytes), ``pareto_front``, ``TaskProxy`` and ``fisher_for``.

The sweep's bytes and token error are exact; its logit KL is a sum over
the vocabulary of differences of f32 log-probabilities, which the two
packages round differently, so it is held to 1e-6 absolute.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jax.config.update("jax_platforms", "cpu")
import ml_dtypes  # noqa: E402

from repro import compression as jcompression  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.compression import rd_search as jrd  # noqa: E402
from repro.compression.tree import flatten_tree as jflatten  # noqa: E402
from repro.core import deepcabac as jdc  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import compression, configs  # noqa: E402
from repro_torch.compression import rd_search  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import deepcabac as dc  # noqa: E402

KL_ATOL = 1e-6
FIM_TOL = 1e-4           # |port - ref| <= FIM_TOL * max|ref F|, per leaf
SEARCH = dict(delta_rels=(1e-3, 6e-3), lambdas=(0.0, 1e-5), prompts=2,
              prompt_len=8, decode_steps=4)


@pytest.fixture(scope="module")
def smoke():
    """The reference's llama3-8b smoke init: (jax cfg, port cfg, jax tree,
    flat numpy f32, port tree)."""
    jcfg = jconfigs.get("llama3-8b", smoke=True)
    jp = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    flat = {k: np.asarray(v) for k, v in jflatten(jp).items()}
    return (jcfg, configs.get("llama3-8b", smoke=True), jp, flat,
            params_from_numpy(flat, "cpu"))


@pytest.fixture(scope="module")
def fims(smoke):
    """fisher_for in both packages (one batch of 2 x 16)."""
    jcfg, cfg, jp, flat, tp = smoke
    want = jrd.fisher_for(jcfg, jp, batches=1)
    got = rd_search.fisher_for(cfg, tp, batches=1)
    return ({k: np.asarray(v) for k, v in jflatten(want).items()},
            compression.flatten_tree(got))


@pytest.fixture(scope="module", params=["unit", "fim"])
def sweeps(request, smoke, fims):
    """rd_sweep in both packages: F = 1 (fim_batches=0), or the reference's
    FIM passed to both."""
    jcfg, cfg, jp, flat, tp = smoke
    if request.param == "unit":
        jf = tf = None
    else:
        jf = jcompression.unflatten_like(fims[0], jp)
        tf = params_from_numpy(fims[0], "cpu")
    want = jrd.rd_sweep(jcfg, jp, jrd.RDSearchConfig(**SEARCH,
                                                     fim_batches=0), fim=jf)
    got = rd_search.rd_sweep(cfg, tp, rd_search.RDSearchConfig(
        **SEARCH, fim_batches=0), fim=tf)
    return request.param, want, got


def test_fisher_for_matches_reference(fims):
    want, got = fims
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k].numpy()
        assert g.dtype == np.float32 and g.shape == w.shape
        assert float(np.abs(g - w).max()) <= FIM_TOL * float(np.abs(w).max())


def test_rd_sweep_points_and_policy_equal_reference(sweeps):
    kind, want, got = sweeps
    assert len(got.points) == len(want.points)
    for p, q in zip(got.points, want.points):
        assert (p.delta_rel, p.lam, p.bytes, p.token_err, p.on_front) == \
            (q.delta_rel, q.lam, q.bytes, q.token_err, q.on_front)  # exact
        assert abs(p.logit_kl - q.logit_kl) <= KL_ATOL
    assert (got.winner.delta_rel, got.winner.lam) == \
        (want.winner.delta_rel, want.winner.lam)
    assert got.policy.to_dict() == want.policy.to_dict()
    assert got.policy_bytes == want.policy_bytes
    assert got.policy_token_err == want.policy_token_err
    assert abs(got.policy_logit_kl - want.policy_logit_kl) <= KL_ATOL
    assert (got.refined_tensors, got.reverted) == \
        (want.refined_tensors, want.reverted)
    assert got.refined_tensors > 0, kind      # stage B did coarsen


def test_rd_sweep_policy_reencodes_to_its_bytes(smoke, sweeps):
    """The policy re-applied through the registry gives the swept
    container in both packages, byte for byte."""
    jcfg, cfg, jp, flat, tp = smoke
    kind, want, got = sweeps
    table = got.policy.to_dict()
    blob = compression.get("deepcabac-rd", policy_table=table).compress(
        tp).blob
    jblob = jcompression.get("deepcabac-rd", policy_table=table).compress(
        jp).blob
    assert len(blob) == got.policy_bytes
    assert blob == jblob


def test_task_proxy_matches_reference(smoke):
    """Greedy tokens equal; log-probabilities are the f32 log-softmax cast
    to f64 (every value is an f32 number), as the reference takes them."""
    jcfg, cfg, jp, flat, tp = smoke
    want = jrd.TaskProxy(jcfg, jp, prompts=3, prompt_len=6, decode_steps=5,
                         seed=2)
    got = rd_search.TaskProxy(cfg, tp, prompts=3, prompt_len=6,
                              decode_steps=5, seed=2, device="cpu")
    assert got.ref_tokens == want.ref_tokens
    for logp in (got.ref_logp, want.ref_logp):
        assert logp.dtype == np.float64
        np.testing.assert_array_equal(logp, logp.astype(np.float32))
    np.testing.assert_allclose(got.ref_logp, want.ref_logp, rtol=0,
                               atol=1e-5)                     # abs 1e-5
    assert got.measure(tp) == {"token_err": 0.0, "logit_kl": 0.0}


def test_pareto_front_marking():
    rng = np.random.default_rng(0)
    for trial in range(20):
        n = int(rng.integers(1, 9))
        raw = [(int(rng.integers(100, 110)), float(rng.integers(0, 3)) / 4,
                float(rng.integers(0, 4)) * 1e-4) for _ in range(n)]
        mine = [rd_search.RDPoint(0.01, 0.0, b, t, k) for b, t, k in raw]
        theirs = [jrd.RDPoint(0.01, 0.0, b, t, k) for b, t, k in raw]
        front = rd_search.pareto_front(mine)
        jfront = jrd.pareto_front(theirs)
        assert [p.on_front for p in mine] == [p.on_front for p in theirs]
        assert [p.to_dict() for p in front] == [p.to_dict() for p in jfront]


# ---------------------------------------------------------------------------
# DC-v1 / DC-v2
# ---------------------------------------------------------------------------

def test_dc_helpers_equal_reference():
    for args in ((0.3, 1e-3, 0.0), (0.3, 1e-3, 64.0), (0.0, 1e-3, 8.0),
                 (-2.5, 0.0, 16.0)):
        assert dc.dc_v1_step_size(*args) == jdc.dc_v1_step_size(*args)
    np.testing.assert_array_equal(dc.default_lambda_grid(6),
                                  jdc.default_lambda_grid(6))
    assert dc.default_s_grid() == jdc.default_s_grid()
    assert dc.QUANT_MIN_NDIM == jdc.QUANT_MIN_NDIM


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compress_dc_v2_and_v1_blobs_equal_reference(smoke, dtype):
    jcfg, cfg, jp, flat, tp = smoke
    jflat = {k: v.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else v
             for k, v in flat.items()}
    tflat = {k: v.to(getattr(torch, dtype))
             for k, v in compression.flatten_tree(tp).items()}
    got = dc.compress_dc_v2(tflat, 0.01, 1e-4)
    want = jdc.compress_dc_v2(jflat, 0.01, 1e-4)
    assert got.blob == want.blob                                # bytes
    assert got.hyperparams == want.hyperparams
    if dtype == "bfloat16":
        return
    rng = np.random.default_rng(7)
    sigma = {k: (0.1 * np.abs(v) + rng.random(v.shape) * 1e-3).astype(
        np.float32) for k, v in flat.items()}
    got = dc.compress_dc_v1(tflat, {k: torch.from_numpy(v)
                                    for k, v in sigma.items()}, 16.0, 1e-4)
    want = jdc.compress_dc_v1(jflat, sigma, 16.0, 1e-4)
    assert got.blob == want.blob                                # bytes
    assert got.hyperparams == want.hyperparams


def _small_params():
    rng = np.random.default_rng(3)
    return {"a": (rng.standard_t(3, (48, 64)) * 0.05).astype(np.float32),
            "b": rng.standard_normal(64).astype(np.float32),
            "c": (rng.standard_normal((4, 24, 16)) * 0.1).astype(np.float32)}


def _metric(orig: dict):
    """A deterministic eval_fn on numpy: minus the summed relative squared
    error of the reconstruction (0 for the original weights)."""
    def eval_fn(rec: dict) -> float:
        err = 0.0
        for k, w in orig.items():
            r = rec[k]
            r = r.numpy() if isinstance(r, torch.Tensor) else np.asarray(r)
            w64 = w.astype(np.float64)
            err += float(np.sum((r.astype(np.float64) - w64) ** 2)
                         / np.sum(w64 ** 2))
        return -err
    return eval_fn


def test_search_dc_v2_equals_reference():
    p = _small_params()
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    deltas = np.array([0.002, 0.01, 0.03, 0.08, 0.2])
    lambdas = np.array([0.0, 1e-4, 1e-3])
    floor = -0.01
    kept = dc.screen_deltas_nn(tp, _metric(p), floor, deltas)
    np.testing.assert_array_equal(
        kept, jdc.screen_deltas_nn(p, _metric(p), floor, deltas))
    assert 0 < kept.size < deltas.size
    pb = {k: v.astype(ml_dtypes.bfloat16) for k, v in p.items()}
    seen = {}                       # the bf16 screen's reconstructions

    def rec_bits(tag):
        def eval_fn(rec):
            seen.setdefault(tag, []).append({
                k: (v.float().numpy() if isinstance(v, torch.Tensor)
                    else np.asarray(v, np.float32)) for k, v in rec.items()})
            return 0.0
        return eval_fn
    dc.screen_deltas_nn({k: v.to(torch.bfloat16) for k, v in tp.items()},
                        rec_bits("port"), floor, deltas)
    jdc.screen_deltas_nn(pb, rec_bits("ref"), floor, deltas)
    for got, want in zip(seen["port"], seen["ref"]):
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    got = dc.search_dc_v2(tp, _metric(p), 0.0, tol=0.01, deltas=deltas,
                          lambdas=lambdas)
    want = jdc.search_dc_v2(p, _metric(p), 0.0, tol=0.01, deltas=deltas,
                            lambdas=lambdas)
    assert got.hyperparams == want.hyperparams
    assert got.hyperparams["delta"] == 0.01  # not the fallback
    assert got.blob == want.blob                                # bytes


def test_search_dc_v1_equals_reference():
    p = _small_params()
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    rng = np.random.default_rng(4)
    sigma = {k: (0.03 + 0.05 * np.abs(v) + 1e-3 * rng.random(v.shape)
                 ).astype(np.float32) for k, v in p.items()}
    tsigma = {k: torch.from_numpy(v) for k, v in sigma.items()}
    s_grid, lambdas = [0.0, 16.0, 128.0], np.array([0.0, 1e-3])
    got = dc.search_dc_v1(tp, tsigma, _metric(p), 0.0, tol=0.01,
                          s_grid=s_grid, lambdas=lambdas)
    want = jdc.search_dc_v1(p, sigma, _metric(p), 0.0, tol=0.01,
                            s_grid=s_grid, lambdas=lambdas)
    assert got.hyperparams["S"] == 16.0     # S = 0 fails the floor
    assert got.hyperparams == want.hyperparams
    assert got.blob == want.blob                                # bytes
