"""The port's training path against the JAX package, on the CPU: the LR
schedules, the 8-bit AdamW moments and error-feedback compression (the
port's counterparts of ``tests/test_distributed.py``), the train state's
names, shapes, dtypes and specs, ``make_train_step`` from converted
weights, the prefill and decode steps, the fault-tolerant loop (loss,
cadence, retention, SIGTERM, exact resume, stragglers under one fake
clock), train-state checkpoints resumed across the packages, and the
training launcher.

The reference's steps run under ``jax.jit`` with the state placed on its
1 x 1 mesh (one compile each); weights and batches cross with
``repro_torch.convert`` as numpy arrays; every tolerance is stated beside
its assertion.
"""

import functools
import os
import re
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.checkpoint import manager as jmanager  # noqa: E402
from repro.compression.tree import flatten_tree as jflatten  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.distributed import compress as jcompress  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import schedule as jschedule  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.checkpoint import manager  # noqa: E402
from repro_torch.compression import q8  # noqa: E402
from repro_torch.compression.tree import flatten_tree  # noqa: E402
from repro_torch.convert import params_from_numpy, tensor_to_numpy  # noqa
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.distributed import compress  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.optim import adamw, schedule  # noqa: E402
from repro_torch.train import loop as tloop  # noqa: E402
from repro_torch.train import steps  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
ARCHS = ["llama3-8b", "deepseek-moe-16b"]
SPEC_ARCHS = ["llama3-8b", "deepseek-moe-16b", "deepseek-v3-671b",
              "mamba2-2.7b"]            # dense, MoE, MLA, SSM
LOSS_RTOL = 1e-5
B, S = 2, 16                            # the steps' batch
TOTAL, WARMUP, LR = 12, 2, 1e-2         # make_train_step's schedule here


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test processes at once: intra-op threads
    beyond one a process oversubscribe the cores, and the loop's many
    small steps then wait on each other's thread pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape


def _np(t) -> np.ndarray:
    return np.asarray(tensor_to_numpy(t) if isinstance(t, torch.Tensor)
                      else t)


@functools.lru_cache(maxsize=None)
def _jmesh():
    return jmesh.make_local_mesh(1, 1)


def _placed(tree):
    """The reference's state or batch committed to its 1 x 1 mesh, where
    its jitted step leaves it, so the step compiles once."""
    return jax.device_put(tree, NamedSharding(_jmesh(), P()))


@functools.lru_cache(maxsize=None)
def _jstep(arch: str, quant: bool, total: int = TOTAL, warmup: int = WARMUP):
    jcfg = jconfigs.get(arch, smoke=True)
    f, _ = jsteps.make_train_step(
        jcfg, _jmesh(), jadamw.AdamWConfig(lr=LR, quantized_moments=quant),
        jcompress.CompressionConfig(enabled=quant), total_steps=total,
        warmup=warmup)
    return jax.jit(f)


def _configs(quant: bool, ef: bool, lr: float = LR):
    return ((jadamw.AdamWConfig(lr=lr, quantized_moments=quant),
             jcompress.CompressionConfig(enabled=ef)),
            (adamw.AdamWConfig(lr=lr, quantized_moments=quant),
             compress.CompressionConfig(enabled=ef)))


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("warmup,total", [(0, 1), (10, 100), (100, 60),
                                          (7, 7)])
def test_schedules_match_reference(warmup, total):
    for step in range(2 * total + 1):
        for fn, jfn, args in (
                (schedule.cosine_schedule, jschedule.cosine_schedule,
                 (total,)),
                (schedule.linear_warmup_cosine,
                 jschedule.linear_warmup_cosine, (warmup, total))):
            want = float(jfn(jnp.asarray(step, jnp.int32), *args))
            for arg in (step, torch.tensor(step, dtype=torch.int32)):
                got = fn(arg, *args)
                assert got.dtype == torch.float32 and got.dim() == 0
                # f32 arithmetic in both: rel 1e-6
                np.testing.assert_allclose(float(got), want, rtol=1e-6,
                                           atol=1e-7)


# ---------------------------------------------------------------------------
# 8-bit moments, AdamW and error feedback (tests/test_distributed.py)
# ---------------------------------------------------------------------------

def test_q8_roundtrip_error():
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal((64, 256)) * 0.1)
                         .astype(np.float32))
    codes, scale = q8.q8_encode(x)
    back = q8.q8_decode(codes, scale)
    blockmax = np.abs(x.numpy()).reshape(64, 2, 128).max(-1)
    tol = (blockmax / 127.0).max()
    assert float((back - x).abs().max()) <= tol + 1e-7


@pytest.mark.parametrize("quant", [False, True])
def test_adamw_converges_quadratic(quant):
    target = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (4, 128)).astype(np.float32))
    params = {"w": torch.zeros((4, 128))}
    cfg = adamw.AdamWConfig(lr=0.05, weight_decay=0.0,
                            quantized_moments=quant)
    state = adamw.adamw_init(params, cfg)
    for _ in range(300):
        w = params["w"].detach().requires_grad_(True)
        (g,) = torch.autograd.grad(torch.mean(torch.square(w - target)), w)
        with torch.no_grad():
            adamw.adamw_update({"w": g}, state, params, cfg)
    assert float(torch.mean(torch.square(params["w"] - target))) < 1e-2


def test_ef_compression_beats_no_ef():
    """EF-quantized GD converges on a quadratic despite int8 grads, and
    beats the same quantization without error feedback."""
    target = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (8, 128)).astype(np.float32))

    def run(use_ef: bool):
        w = torch.zeros((8, 128))
        cfg = compress.CompressionConfig(enabled=True,
                                         ef_decay=1.0 if use_ef else 0.0)
        ef = compress.init_error_feedback({"w": w})
        for _ in range(200):
            gq, ef = compress.ef_compress_update({"w": 2 * (w - target)},
                                                 ef, cfg)
            w = w - 0.2 * gq["w"]
        return float(torch.mean(torch.square(w - target)))

    err_ef, err_no = run(True), run(False)
    assert err_ef < 1e-4, err_ef
    assert err_ef <= err_no


def test_ef_disabled_passthrough_and_entropy():
    g = {"w": torch.ones((4, 128))}
    ef = compress.init_error_feedback(g)
    out, ef2 = compress.ef_compress_update(
        g, ef, compress.CompressionConfig(enabled=False))
    assert out is g and ef2 is ef
    codes, _ = q8.q8_encode(torch.from_numpy(
        np.random.default_rng(3).standard_normal((16, 256))
        .astype(np.float32)))
    bits = compress.code_entropy_bits_per_param(codes)
    assert 0 < bits <= 8
    assert bits == jcompress.code_entropy_bits_per_param(codes.numpy())
    with pytest.raises(ValueError, match="pod axis"):
        compress.cross_pod_psum_compressed(torch.zeros(2, 128), None)


def test_ef_update_matches_reference():
    """Codes and the error state equal the reference's exactly over
    three steps (bf16 and f32 gradients, blockable and not)."""
    rng = np.random.default_rng(4)
    shapes = {"a": (6, 256), "b": (5, 7)}
    cfgs = (jcompress.CompressionConfig(enabled=True, ef_decay=0.9),
            compress.CompressionConfig(enabled=True, ef_decay=0.9))
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        je = jcompress.init_error_feedback(
            {k: jnp.zeros(s) for k, s in shapes.items()})
        te = compress.init_error_feedback(
            {k: torch.zeros(s) for k, s in shapes.items()})
        for _ in range(3):
            g = {k: rng.standard_normal(s).astype(np.float32)
                 for k, s in shapes.items()}
            jg, je = jcompress.ef_compress_update(
                {k: jnp.asarray(v, jdt) for k, v in g.items()}, je, cfgs[0])
            tg, te = compress.ef_compress_update(
                {k: torch.from_numpy(v).to(dt) for k, v in g.items()}, te,
                cfgs[1])
            for k in shapes:
                assert tg[k].dtype == dt
                np.testing.assert_array_equal(
                    tg[k].float().numpy(), np.asarray(jg[k], np.float32))
                np.testing.assert_array_equal(te[k].numpy(),
                                              np.asarray(je[k]))


def test_flatten_tree_drops_none():
    t = torch.zeros(3)
    flat = flatten_tree({"a": t, "ef": None, "opt": {"x": t, "y": None}})
    assert sorted(flat) == ["a", "opt/x"]
    assert sorted(flat) == sorted(jflatten({"a": jnp.zeros(3), "ef": None,
                                            "opt": {"x": jnp.zeros(3),
                                                    "y": None}}))


def test_unflatten_like_moves_tensors_to_the_template():
    """A decoded tensor takes the template leaf's dtype and the asked
    device (every tensor has a ``dequantize`` method; only a quantized
    record stays as it is)."""
    from repro_torch.compression.tree import unflatten_like
    from repro_torch.core.codec import QuantizedTensor
    rec = QuantizedTensor(np.zeros(2, np.int64), 0.5)
    out = unflatten_like({"a": torch.ones(2), "b": rec},
                         {"a": torch.zeros(2, dtype=torch.bfloat16),
                          "b": torch.zeros(2)}, device=torch.device("meta"))
    assert out["a"].device.type == "meta"
    assert out["a"].dtype == torch.bfloat16
    assert out["b"] is rec


# ---------------------------------------------------------------------------
# train state, specs and meshes
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jstate_shape(arch, quant, ef):
    (jo, jc), _ = _configs(quant, ef)
    return jax.eval_shape(lambda: jsteps.init_train_state(
        jconfigs.get(arch, smoke=True), jo, jc))


def _tstate(arch, quant, ef):
    _, (to, tc) = _configs(quant, ef)
    return steps.init_train_state(configs.get(arch, smoke=True), to, tc,
                                  device="cpu")


def _jnames(tree) -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out["/".join(str(k.key) for k in path)] = leaf
    return out


@pytest.mark.parametrize("arch", SPEC_ARCHS)
@pytest.mark.parametrize("quant,ef", [(False, False), (True, False),
                                      (False, True), (True, True)])
def test_init_train_state_layout_matches_reference(arch, quant, ef):
    want = _jnames(_jstate_shape(arch, quant, ef))
    state = _tstate(arch, quant, ef)
    assert (state["ef"] is None) == (not ef)
    got = flatten_tree(state)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        shape = tuple(np.shape(got[k]))
        dt = (str(got[k].dtype).removeprefix("torch.")
              if isinstance(got[k], torch.Tensor) else np.dtype(
                  type(got[k])).name)
        assert (shape, dt) == (tuple(w.shape), str(w.dtype)), k
        if isinstance(got[k], torch.Tensor):
            assert got[k].device.type == "cpu"
        if not k.startswith("params/"):          # zero moments, EF, step
            assert not np.any(_np(got[k])), k


def _tuples(tree):
    return jax.tree.map(tuple, tree, is_leaf=lambda x: isinstance(x, P))


MESHES = [{"data": 2, "model": 2}, {"pod": 2, "data": 2, "model": 2}]


@pytest.mark.parametrize("arch", SPEC_ARCHS)
@pytest.mark.parametrize("mesh", MESHES, ids=["dp2tp2", "pod2dp2tp2"])
def test_specs_match_reference(arch, mesh):
    jcfg, cfg = jconfigs.get(arch, smoke=True), configs.get(arch, smoke=True)
    fake = FakeMesh(mesh)
    want = _tuples(jsteps.state_specs(_jstate_shape(arch, True, True),
                                      fake))
    got = steps.state_specs(_tstate(arch, True, True), fake)
    assert got == want
    assert steps.state_specs(_tstate(arch, False, False), fake) == \
        _tuples(jsteps.state_specs(_jstate_shape(arch, False, False), fake))
    jcache = jax.eval_shape(lambda: jtf.init_cache(jcfg, 4, 32))
    tcache = ttf.init_cache(cfg, 4, 32, device="meta")
    assert steps.cache_logical_specs(tcache, fake) == \
        _tuples(jsteps.cache_logical_specs(jcache, fake))
    batch = pipeline.make_batch(cfg, 0, batch=4, seq=8)
    assert steps.batch_specs(batch, fake) == _tuples(
        jsteps.batch_specs(jpipe.make_batch(jcfg, 0, batch=4, seq=8), fake))
    # the same specs from tensors, and with pos3d
    pos3d = np.zeros((3, 4, 8), np.int32)
    tb = pipeline.to_device({**batch, "pos3d": pos3d}, "cpu")
    assert steps.batch_specs(tb, fake) == _tuples(jsteps.batch_specs(
        {**batch, "pos3d": pos3d}, fake))


def test_meshes_match_reference():
    assert tmesh.make_production_mesh().shape == {"data": 16, "model": 16}
    assert tmesh.make_production_mesh(multi_pod=True).shape == {
        "pod": 2, "data": 16, "model": 16}
    assert tmesh.make_local_mesh(2, 3).shape == {"data": 2, "model": 3}
    assert tmesh.make_local_mesh(1, 2, pod=2).shape == {
        "pod": 2, "data": 1, "model": 2}
    assert dict(_jmesh().shape) == tmesh.make_local_mesh(1, 1).shape
    cfg = configs.get("llama3-8b", smoke=True)
    _, (to, _) = _configs(False, False)
    # a device-free mesh of several devices needs a DeviceMesh, and a
    # model axis above 1 runs only the dense family's train step
    # (tensor-parallel, on a DeviceMesh): the prefill and decode steps and
    # another family's train step raise "not yet ported"
    moe = configs.get("deepseek-moe-16b", smoke=True)
    tp = {"data": 1, "model": 2}
    for mesh, err, match in ((tmesh.make_local_mesh(2, 1), ValueError,
                              "DeviceMesh"),
                             (tp, NotImplementedError, "not yet ported")):
        for make in (lambda m: steps.make_train_step(
                         cfg if mesh is not tp else moe, m, to),
                     lambda m: steps.make_prefill_step(cfg, m),
                     lambda m: steps.make_decode_step(cfg, m)):
            with pytest.raises(err, match=match):
                make(mesh)
    with pytest.raises(ValueError, match="DeviceMesh"):
        steps.make_train_step(cfg, tp, to)
    with pytest.raises(NotImplementedError, match="moe family"):
        train_cli.main(["--smoke", "--steps", "1", "--production-mesh",
                        "--arch", "deepseek-moe-16b", "--device", "cpu"])
    # the full llama3-8b's 32 / 8 heads split over the model axis of 16;
    # the launcher then needs a world of 256 ranks
    with pytest.raises(ValueError, match="256 ranks"):
        train_cli.main(["--steps", "1", "--production-mesh", "--device",
                        "cpu"])
    if not torch.cuda.is_available():        # no CPU path behind the caller
        with pytest.raises(RuntimeError, match="is_available"):
            steps.init_train_state(cfg, to)


# ---------------------------------------------------------------------------
# steps from converted weights
# ---------------------------------------------------------------------------

def _numpy_params(jcfg, seed: int):
    """(jax params, port params): the reference's tree of shapes filled
    by numpy from ``seed`` (norm scales about 1, the rest N(0, 0.05))."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jtf.init_params(jcfg,
                                                    jax.random.PRNGKey(0)))
    flat = {}
    for k, leaf in _jnames(shapes).items():
        x = rng.standard_normal(leaf.shape) * 0.05
        flat[k] = (x + 1.0 if k.endswith("norm") else x).astype(leaf.dtype)
    jp = jax.tree.map(jnp.asarray, jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(shapes), [flat[k] for k in
                                               _jnames(shapes)]))
    return jp, params_from_numpy(flat, "cpu")


@pytest.fixture(scope="module", params=ARCHS)
def converted(request):
    """(arch, jax cfg, port cfg, jax params, port params)."""
    arch = request.param
    jcfg = jconfigs.get(arch, smoke=True)
    jp, tp = _numpy_params(jcfg, 7)
    return arch, jcfg, configs.get(arch, smoke=True), jp, tp


def test_train_step_matches_reference(converted):
    """Three steps with 8-bit moments and error feedback: loss rel
    LOSS_RTOL, lr_scale rel 1e-6, the counters equal.  Parameters: each
    leaf within PARAM_TOL of its max|p| but for at most PART_SHARE of its
    elements; every int8 moment code within CODE_TOL steps.  The
    gradients differ in their last bits, so a gradient or moment code
    sitting on a rounding boundary may round the other way (on the MoE
    model 4% of a leaf's weights then part by more than 1e-5, 0.15% by
    more than 1e-3), and where
    ``v``'s code is 0 and ``m``'s is not, AdamW divides by eps in both
    packages (a weight of the llama3-8b smoke embedding jumps from 0.09
    to 19.3 at step 2), so one flipped code moves its weight by far more
    than any tolerance on the others."""
    PARAM_TOL, PART_SHARE, CODE_TOL = 1e-3, 0.005, 2
    arch, jcfg, cfg, jp, tp = converted
    jp0 = _jnames(jp)
    tp = params_from_numpy({k: _np(v) for k, v in flatten_tree(tp).items()},
                           "cpu")                # the step writes in place
    (jo, jc), (to, tc) = _configs(True, True)
    jst = _placed({**jsteps.init_train_state(jcfg, jo, jc), "params": jp})
    tst = steps.init_train_state(cfg, to, tc, device="cpu")
    tst["params"] = tp
    step_fn, make = steps.make_train_step(cfg, None, to, tc,
                                          total_steps=TOTAL, warmup=WARMUP)
    fn = make(tst, None)
    for i in range(3):
        batch = pipeline.make_batch(cfg, i, batch=B, seq=S, seed=0)
        jst, jm = _jstep(arch, True)(jst, _placed(batch))
        tst, tm = fn(tst, batch)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(tm["lr_scale"]),
                                   float(jm["lr_scale"]), rtol=1e-6)
    assert int(tst["step"]) == int(jst["step"]) == 3
    assert tst["opt"]["count"] == int(jst["opt"]["count"]) == 3
    got, want = flatten_tree(tst), _jnames(jst)
    assert sorted(got) == sorted(want)
    assert any(not np.array_equal(np.asarray(v), np.asarray(jp0[k[7:]]))
               for k, v in want.items() if k.startswith("params/"))
    for k, w in want.items():
        w, g = np.asarray(w), _np(got[k])
        if k.startswith("params/"):
            far = np.abs(g - w) > PARAM_TOL * float(np.abs(w).max())
            assert far.mean() <= PART_SHARE, (k, far.mean())
        elif w.dtype == np.int8:
            assert int(np.abs(g.astype(np.int16) - w).max()) <= CODE_TOL, k


def test_prefill_and_decode_steps_match_reference():
    """The llama3-8b smoke model's prefill and three decode steps against
    the reference's step body (``forward`` over ``init_cache`` with
    ``last_only``; the reference's own step wrappers raise a sharding
    error under the installed jax on a mesh): logits within 1e-4 of
    max|logit|, greedy tokens equal."""
    jcfg = jconfigs.get("llama3-8b", smoke=True)
    cfg = configs.get("llama3-8b", smoke=True)
    jp, tp = _numpy_params(jcfg, 8)
    toks = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (B, 8)).astype(np.int32)
    max_len = 12
    jlog, jc, _ = jtf.forward(jp, jcfg, tokens=jnp.asarray(toks),
                              caches=jtf.init_cache(jcfg, B, max_len),
                              last_only=True)
    jlog = jlog[:, 0, :]
    pre = steps.make_prefill_step(cfg, None, max_len=max_len)
    dec = steps.make_decode_step(cfg, tmesh.make_local_mesh(1, 1))
    tlog, tc = pre(tp, {"tokens": torch.from_numpy(toks).long()})
    for i in range(3):
        w = np.asarray(jlog)
        np.testing.assert_allclose(tlog.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max())
        nxt = np.argmax(w, -1).astype(np.int32)
        assert np.array_equal(tlog.argmax(-1).numpy(), nxt)
        jlog, jc, _ = jtf.forward(jp, jcfg, tokens=jnp.asarray(nxt)[:, None],
                                  caches=jc, cache_pos=8 + i,
                                  last_only=True)
        jlog = jlog[:, 0, :]
        tlog, tc = dec(tp, tc, {"tokens": torch.from_numpy(nxt).long()},
                       8 + i)


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------

class FakeClock:
    """``time.monotonic`` for both loops: a step's two readings are
    ``durations[i]`` apart."""

    def __init__(self, durations):
        self.durations, self.calls, self.t = list(durations), 0, 0.0

    def monotonic(self):
        if self.calls % 2:
            self.t += self.durations[self.calls // 2]
        self.calls += 1
        return self.t


def _ckpt(d, **kw):
    return manager.CheckpointConfig(str(d), params_mode="raw", **kw)


def _restored(d, quant, ef, step=None, arch="llama3-8b"):
    return manager.CheckpointManager(_ckpt(d)).restore(
        _tstate(arch, quant, ef), step=step, device="cpu")[0]


def test_loop_reduces_loss():
    cfg = configs.get("llama3-8b", smoke=True)
    res = tloop.train_loop(cfg, None, tloop.LoopConfig(
        total_steps=60, batch=8, seq=64, resume=False),
        opt_cfg=adamw.AdamWConfig(lr=2e-3), device="cpu")
    assert res.final_step == 60 and len(res.losses) == 60
    first, last = np.mean(res.losses[:5]), np.mean(res.losses[-5:])
    assert last < first - 0.1, (first, last)


def test_loop_cadence_and_retention(tmp_path):
    cfg = configs.get("llama3-8b", smoke=True)
    loop = tloop.LoopConfig(total_steps=7, batch=B, seq=S, ckpt_every=2)
    res = tloop.train_loop(cfg, None, loop, ckpt_cfg=_ckpt(tmp_path, keep=2),
                           device="cpu")
    mgr = manager.CheckpointManager(_ckpt(tmp_path))
    assert res.final_step == 7 and mgr.steps() == [6, 7]
    st = _restored(tmp_path, False, False)
    assert int(st["step"]) == 7 and st["opt"]["count"] == 7
    assert st["ef"] is None


def test_loop_saves_the_final_step_once(tmp_path, monkeypatch):
    """A final step the cadence already saved is not written again; the
    final save still waits for it."""
    cfg = configs.get("llama3-8b", smoke=True)
    saves = []
    real = manager.CheckpointManager.save

    def counted(self, state, step, **kw):
        saves.append(step)
        return real(self, state, step, **kw)
    monkeypatch.setattr(manager.CheckpointManager, "save", counted)
    loop = tloop.LoopConfig(total_steps=6, batch=B, seq=S, ckpt_every=3)
    res = tloop.train_loop(cfg, None, loop, ckpt_cfg=_ckpt(
        tmp_path, async_save=True), device="cpu")
    assert res.final_step == 6 and saves == [3, 6]
    assert manager.CheckpointManager(_ckpt(tmp_path)).steps() == [3, 6]
    assert int(_restored(tmp_path, False, False)["step"]) == 6


def _sigterm_at(monkeypatch, at: int):
    """make_batch in the port's loop sends SIGTERM to this process when
    it builds step ``at``'s batch."""
    def hooked(cfg, step, **kw):
        if step == at:
            os.kill(os.getpid(), signal.SIGTERM)
        return pipeline.make_batch(cfg, step, **kw)
    monkeypatch.setattr(tloop, "make_batch", hooked)


def test_sigterm_ends_the_loop_with_a_final_save(tmp_path, monkeypatch):
    cfg = configs.get("llama3-8b", smoke=True)
    before = signal.getsignal(signal.SIGTERM)
    _sigterm_at(monkeypatch, 4)
    loop = tloop.LoopConfig(total_steps=10, batch=B, seq=S, ckpt_every=3)
    res = tloop.train_loop(cfg, None, loop, ckpt_cfg=_ckpt(tmp_path),
                           device="cpu")
    assert res.final_step == 5 and len(res.losses) == 5
    assert manager.CheckpointManager(_ckpt(tmp_path)).steps() == [3, 5]
    assert signal.getsignal(signal.SIGTERM) is before


def test_resume_equals_an_uninterrupted_run(tmp_path, monkeypatch):
    """Preempted at step 4, resumed to 8: losses of steps 5-7 and the
    whole final state (params, 8-bit moments, EF, counters) equal the
    straight run's exactly."""
    cfg = configs.get("llama3-8b", smoke=True)
    _, (to, tc) = _configs(True, True)
    loop = tloop.LoopConfig(total_steps=8, batch=B, seq=S, ckpt_every=3)
    straight = tloop.train_loop(cfg, None, loop, to, tc,
                                _ckpt(tmp_path / "a"), device="cpu")
    with monkeypatch.context() as m:
        _sigterm_at(m, 4)
        cut = tloop.train_loop(cfg, None, loop, to, tc,
                               _ckpt(tmp_path / "b"), device="cpu")
    resumed = tloop.train_loop(cfg, None, loop, to, tc,
                               _ckpt(tmp_path / "b"), device="cpu")
    assert cut.final_step == 5 and resumed.final_step == 8
    assert cut.losses == straight.losses[:5]
    assert resumed.losses == straight.losses[5:]
    a = flatten_tree(_restored(tmp_path / "a", True, True))
    b = flatten_tree(_restored(tmp_path / "b", True, True))
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(_np(a[k]), _np(b[k]), err_msg=k)


DURATIONS = [1.0] * 9 + [3.5, 1.0, 1.0, 3.0, 10.0]   # steps 9, 13 straggle


def test_stragglers_and_resume_across_packages(tmp_path, monkeypatch):
    """Both loops under one fake clock flag the same straggler steps.
    The reference's step-7 directory (8-bit moments, EF) restores into
    the port's template and the port's two next steps give the
    reference's losses; the port's (f32 moments, ``ef`` None) restores
    into the reference's template and the reference's two next steps
    give the port's.  Losses rel LOSS_RTOL."""
    jcfg = jconfigs.get("llama3-8b", smoke=True)
    cfg = configs.get("llama3-8b", smoke=True)
    n = len(DURATIONS)
    loop_kw = dict(total_steps=n, batch=B, seq=S, ckpt_every=7)

    (jo, jc), (to, tc) = _configs(True, True)
    monkeypatch.setattr(jloop, "time", FakeClock(DURATIONS))
    jres = jloop.train_loop(jcfg, _jmesh(), jloop.LoopConfig(**loop_kw),
                            jo, jc, jmanager.CheckpointConfig(
                                str(tmp_path / "j"), params_mode="raw"))
    st = _restored(tmp_path / "j", True, True, step=7)
    assert int(st["step"]) == 7 and st["opt"]["count"] == 7
    _, make = steps.make_train_step(cfg, None, to, tc, total_steps=n)
    fn = make(st, None)
    for i in (7, 8):
        _, m = fn(st, pipeline.make_batch(cfg, i, batch=B, seq=S, seed=0))
        np.testing.assert_allclose(float(m["loss"]), jres.losses[i],
                                   rtol=LOSS_RTOL)

    (jo, jc), (to, tc) = _configs(False, False)
    monkeypatch.setattr(tloop, "time", FakeClock(DURATIONS))
    tres = tloop.train_loop(cfg, None, tloop.LoopConfig(**loop_kw), to, tc,
                            _ckpt(tmp_path / "t"), device="cpu")
    assert tres.straggler_steps == jres.straggler_steps == [9, 13]
    assert tres.step_times == jres.step_times == DURATIONS
    mgr = jmanager.CheckpointManager(jmanager.CheckpointConfig(
        str(tmp_path / "t"), params_mode="raw"))
    jst, meta = mgr.restore(jsteps.init_train_state(jcfg, jo, jc), step=7)
    assert jst["ef"] is None and int(meta["step"]) == 7
    jst = _placed(jst)
    jfn = _jstep("llama3-8b", False, n, 100)
    for i in (7, 8):
        jst, m = jfn(jst, _placed(jpipe.make_batch(jcfg, i, batch=B, seq=S,
                                                   seed=0)))
        np.testing.assert_allclose(float(m["loss"]), tres.losses[i],
                                   rtol=LOSS_RTOL)


def test_launcher_trains():
    """``python -m repro_torch.launch.train --smoke --device cpu`` with
    compressed gradients prints the reference's summary line."""
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
         "--device", "cpu", "--steps", "4", "--batch", str(B), "--seq",
         str(S), "--compress-grads"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(REPO / "src"),
             "OMP_NUM_THREADS": "1"})
    assert res.returncode == 0, res.stderr
    m = re.fullmatch(r"steps=4 first_loss=(\S+) last_loss=(\S+) "
                     r"stragglers=\d+", res.stdout.strip().splitlines()[-1])
    assert m and all(np.isfinite(float(v)) for v in m.groups())
