"""The port's distribution layer on the CPU: a gloo world of four spawned
processes (``tests/_torch_dist_worker.py``, one intra-op thread each,
rendezvous through a ``FileStore``, no TCP port) runs every check once;
the cases below assert on what each rank wrote.

Held against the JAX package where it runs under the installed jax:
``cross_pod_psum_compressed`` (the reference's own function on fake CPU
devices, in one subprocess), the mesh restores (steps the reference
wrote; its ``restore_flat``, ``restore_flat_delta`` and device-free
``restore_local_slices``), the backends' ``mesh=`` loads and
``quantize_params_for_serving``.  Where the reference fails under jax 0.9
(``gpipe_apply``, a ``make_train_step`` on a mesh of several devices), the
port is held to its sequential math: the stages run in sequence, and the
single-process step on the whole batch (itself held to the reference in
``tests/test_torch_train.py``).  Every tolerance is stated beside its
assertion.
"""

import os
import re
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jax.config.update("jax_platforms", "cpu")

from repro import configs as jconfigs  # noqa: E402
from repro.checkpoint import CheckpointConfig as JConfig  # noqa: E402
from repro.checkpoint import CheckpointManager as JManager  # noqa: E402
from repro.checkpoint import delta as jdelta  # noqa: E402
from repro.checkpoint import sharded as jsharded  # noqa: E402
from repro.compression.tree import flatten_tree as jflatten  # noqa: E402
from repro.distributed import sharding as jsharding  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serve import backends as jbackends  # noqa: E402
from repro.serve import quantized as jquantized  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.arrays import to_storage  # noqa: E402
from repro_torch.checkpoint import CheckpointConfig, CheckpointManager  # noqa
from repro_torch.checkpoint.sharded import MeshSpec  # noqa: E402
from repro_torch.compression.tree import flatten_tree, unflatten  # noqa
from repro_torch.distributed.compress import init_error_feedback  # noqa
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.data.pipeline import make_batch  # noqa: E402
from repro_torch.distributed import pipeline_stage  # noqa: E402
from repro_torch.distributed.compress import CompressionConfig  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.serve import quantized  # noqa: E402
from repro_torch.serve.session import ServeConfig, ServeSession  # noqa: E402
from repro_torch.train.steps import (init_train_state,  # noqa: E402
                                     make_decode_step, make_prefill_step,
                                     make_train_step)

REPO = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).with_name("_torch_dist_worker.py")
WORLD = 4
ARCHS = ("llama3-8b", "deepseek-moe-16b")
B, S = 4, 16                   # the worker's global batch
TOTAL, WARMUP, LR = 12, 2, 1e-2
DP_STEPS = 2
LOSS_RTOL = 1e-5               # tests/test_torch_train.py's
PARAM_RTOL = 1e-5
GPIPE_RTOL = 2e-5              # tests/test_pipeline.py's
GPIPE_M, GPIPE_D, GPIPE_H = 6, 16, 32
SAVE_MESH = {"data": 2, "model": 2}
PSUM_SHAPES = {"block": (8, 384), "flat": (6, 10)}
# one tree name per rule of the reference's PARAM_RULES (held below), with
# dims of 8 so that every mesh axis of 2 or 4 divides them
PLACEMENT_NAMES = [
    ("embed", (8, 8)), ("head", (8, 8)),
    ("layers/attn/wq", (2, 8, 8)), ("layers/attn/wk", (2, 8, 8)),
    ("layers/attn/wv", (2, 8, 8)), ("layers/attn/wo", (2, 8, 8)),
    ("layers/attn/bq", (2, 8)), ("layers/attn/q_norm", (2, 8)),
    ("layers/attn/w_dq", (2, 8, 8)), ("layers/attn/w_uq", (2, 8, 8)),
    ("layers/attn/w_dkv", (2, 8, 8)), ("layers/attn/w_uk", (2, 8, 8)),
    ("layers/attn/w_uv", (2, 8, 8)), ("layers/attn/w_kr", (2, 8, 8)),
    ("layers/attn/kv_norm", (2, 8)),
    ("layers/mlp/w_gate", (2, 8, 8)), ("layers/mlp/w_up", (2, 8, 8)),
    ("layers/mlp/w_down", (2, 8, 8)),
    ("layers/moe/router", (2, 8, 8)), ("layers/moe/w_gate", (2, 8, 8, 8)),
    ("layers/moe/w_up", (2, 8, 8, 8)), ("layers/moe/w_down", (2, 8, 8, 8)),
    ("layers/moe/sh_gate", (2, 8, 8)), ("layers/moe/sh_up", (2, 8, 8)),
    ("layers/moe/sh_down", (2, 8, 8)),
    ("layers/mixer/w_z", (2, 8, 8)), ("layers/mixer/w_x", (2, 8, 8)),
    ("layers/mixer/w_b", (2, 8, 8)), ("layers/mixer/w_c", (2, 8, 8)),
    ("layers/mixer/w_dt", (2, 8, 8)), ("layers/mixer/conv_x_w", (2, 8, 4)),
    ("layers/mixer/conv_x_b", (2, 8)), ("layers/mixer/a_log", (2, 8)),
    ("layers/mixer/norm", (2, 8)), ("layers/mixer/out_proj", (2, 8, 8)),
    ("final_norm", (8,)),
    ("layers/mlp/w_up/m", (2, 8, 8)), ("layers/mlp/w_up/q8", (2, 8, 8)),
    ("layers/mlp/w_up/q8s", (2, 8)), ("layers/moe/w_gate/v_q", (2, 8, 8, 8)),
]
MESHES = ("data4", "pod2data2", "data2model2")

JAX_PSUM = r"""
import sys
import numpy as np
import jax
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.distributed.compress import cross_pod_psum_compressed
d = sys.argv[1]
inp = dict(np.load(d + "/psum_in.npz"))
out = {}
for n in (2, 4):
    mesh = jax.make_mesh((n, 4 // n), ("pod", "data"))
    for key in ("block", "flat"):
        x = jax.device_put(inp[f"{key}_{n}"], NamedSharding(mesh, P("pod")))
        out[f"{key}_{n}"] = np.asarray(cross_pod_psum_compressed(x, mesh))
np.savez(d + "/psum_out.npz", **out)
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return to_storage(t) if isinstance(t, torch.Tensor) else np.asarray(t)


def _bits(a) -> np.ndarray:
    """An array's bit pattern (ml_dtypes bf16 as uint16, as the port's
    ``to_storage`` gives it)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16)
    return a


def _inputs(d: Path) -> dict:
    rng = np.random.default_rng(11)
    inp = {"placement_names": PLACEMENT_NAMES}
    for s in (2, 4):
        inp[f"gpipe_params_{s}"] = {
            "w1": torch.from_numpy(rng.standard_normal(
                (s, GPIPE_D, GPIPE_H)).astype(np.float32) * 0.2),
            "w2": torch.from_numpy(rng.standard_normal(
                (s, GPIPE_H, GPIPE_D)).astype(np.float32) * 0.2)}
    inp["gpipe_x"] = torch.from_numpy(rng.standard_normal(
        (GPIPE_M, 2, 8, GPIPE_D)).astype(np.float32))
    psum_in = {}
    for n in (2, 4):
        for key, shape in PSUM_SHAPES.items():
            x = rng.standard_normal((n, *shape)).astype(np.float32)
            psum_in[f"{key}_{n}"] = x
            inp[f"psum_{key}_{n}"] = torch.from_numpy(x)
    np.savez(d / "psum_in.npz", **psum_in)
    torch.save(inp, d / "inputs.pt")
    return inp


def _reference_steps(d: Path) -> dict:
    """The reference writes a sharded keyframe (step 1) and a P-frame
    (step 2) of the llama3-8b smoke model over a (data 2, model 2)
    MeshSpec, and a monolithic raw step elsewhere."""
    jcfg = jconfigs.get("llama3-8b", smoke=True)
    p1 = {k: np.asarray(v) for k, v in jflatten(
        jtf.init_params(jcfg, jax.random.PRNGKey(0))).items()}
    rng = np.random.default_rng(3)
    p2 = {k: (v * (1 + 1e-3 * rng.standard_normal(v.shape))).astype(v.dtype)
          for k, v in p1.items()}

    def tree(flat):
        out: dict = {}
        for name, v in flat.items():
            *parents, last = name.split("/")
            node = out
            for p in parents:
                node = node.setdefault(p, {})
            node[last] = v
        return out
    mgr = JManager(JConfig(str(d / "ref_ckpt"), codec="deepcabac-delta",
                           delta_every=4, sharded=True, keep=10))
    mesh = jsharded.MeshSpec.from_any(SAVE_MESH)
    for step, p in ((1, p1), (2, p2)):
        mgr.save({"params": tree(p), "opt": {"count": np.int32(step)}},
                 step, mesh=mesh)
    JManager(JConfig(str(d / "ref_mono"), params_mode="raw")).save(
        {"params": tree(p1), "opt": {"count": np.int32(1)}}, 1)
    return {"p1": p1, "tree": tree}


def _whole_batch(arch, quant, ef, init: dict) -> dict:
    """The single-process step on the whole batch, from a copy of the
    arch's smoke train state ``init[arch]`` (drawn once for all its
    cases; fresh zero moments and EF of the case's kind)."""
    cfg = configs.get(arch, smoke=True)
    opt = AdamWConfig(lr=LR, quantized_moments=quant)
    comp = CompressionConfig(enabled=ef)
    if arch not in init:
        init[arch] = init_train_state(cfg, opt, seed=0, device="cpu")
    params = unflatten({k: v.clone() for k, v in
                        flatten_tree(init[arch]["params"]).items()})
    state = {"params": params, "opt": adamw_init(params, opt),
             "ef": init_error_feedback(params) if ef else None,
             "step": torch.zeros((), dtype=torch.int32)}
    _, make = make_train_step(cfg, None, opt, comp, total_steps=TOTAL,
                              warmup=WARMUP)
    fn = make(state, None)
    losses = []
    for i in range(DP_STEPS):
        state, m = fn(state, make_batch(cfg, i, batch=B, seq=S, seed=0))
        losses.append(float(m["loss"]))
    return {"losses": losses, "state": {k: _np(v) for k, v in
                                        flatten_tree(state).items()}}


def _sequential_gpipe(inp, s) -> np.ndarray:
    p = inp[f"gpipe_params_{s}"]
    ys = []
    for x in inp["gpipe_x"]:
        for i in range(s):
            x = x + torch.tanh(x @ p["w1"][i]) @ p["w2"][i]
        ys.append(x)
    return torch.stack(ys).numpy()


def _single_prefill_decode() -> list:
    cfg = configs.get("llama3-8b", smoke=True)
    params = init_train_state(cfg, AdamWConfig(), seed=0,
                              device="cpu")["params"]
    toks = torch.randint(0, cfg.vocab_size, (B, 8),
                         generator=torch.Generator().manual_seed(5))
    logits, caches = make_prefill_step(cfg, None, max_len=11)(
        params, {"tokens": toks})
    out = [logits]
    dec = make_decode_step(cfg, None)
    for i in range(2):
        pos = torch.full((B,), 8 + i, dtype=torch.int32)
        logits, caches = dec(params, caches, {"tokens": out[-1].argmax(-1)},
                             pos)
        out.append(logits)
    return [o.numpy() for o in out]


def _resume_world_one(d: Path) -> list:
    """A world of one resumes the world of 2's sharded step 2 and runs
    steps 2 and 3 with the loop's schedule (4 steps, warmup 100)."""
    cfg = configs.get("llama3-8b", smoke=True)
    opt, comp = AdamWConfig(lr=LR), CompressionConfig(enabled=True)
    template = init_train_state(cfg, opt, comp, seed=5, device="cpu")
    mgr = CheckpointManager(CheckpointConfig(str(d / "ckpt_w2"),
                                             params_mode="raw"))
    state, meta = mgr.restore(template, step=2, device="cpu")
    _, make = make_train_step(cfg, None, opt, comp, total_steps=4)
    fn = make(state, None)
    losses = []
    for i in (2, 3):
        state, m = fn(state, make_batch(cfg, i, batch=B, seq=S, seed=0))
        losses.append(float(m["loss"]))
    return losses


def _launcher() -> subprocess.Popen:
    """``torchrun --standalone --nproc-per-node 2 -m
    repro_torch.launch.train --smoke --device cpu`` (3 steps, the worker's
    batch), started beside the world."""
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"),
           "OMP_NUM_THREADS": "1"}
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         "--smoke", "--device", "cpu", "--steps", "3", "--batch", str(B),
         "--seq", str(S), "--compress-grads"], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Run the four ranks once (and, beside them, the reference's psum on
    four fake CPU devices in one jax subprocess, and the launcher under
    ``torchrun``); return what each rank wrote with the single-process
    and reference results."""
    d = tmp_path_factory.mktemp("world")
    inp = _inputs(d)
    launcher = _launcher()
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(REPO / "src"), os.environ.get("PYTHONPATH", "")]),
        "OMP_NUM_THREADS": "1"}
    jax_env = {**env, "JAX_PLATFORMS": "cpu",
               "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    logs = [open(d / f"rank{r}.log", "w") for r in range(WORLD)]
    procs = []
    try:
        jproc = subprocess.Popen([sys.executable, "-c", JAX_PSUM, str(d)],
                                 env=jax_env, cwd=REPO,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
        procs = [jproc] + [subprocess.Popen(
            [sys.executable, str(WORKER), str(r), str(WORLD), str(d)],
            env=env, cwd=REPO, stdout=logs[r], stderr=subprocess.STDOUT)
            for r in range(WORLD)]
        # the reference's steps (the ranks wait for them before their
        # restores) and the single-process references, while the world
        # runs
        ref = _reference_steps(d)
        (d / "ref_ready").touch()
        init: dict = {}
        whole = {(arch, quant, ef): _whole_batch(arch, quant, ef, init)
                 for arch in ARCHS for quant, ef in
                 ((False, False), (False, True), (True, True))}
        seq = {s: _sequential_gpipe(inp, s) for s in (2, 4)}
        single = _single_prefill_decode()
        for p in procs[1:]:
            p.wait(timeout=400)
        _, jerr = jproc.communicate(timeout=300)
    except BaseException:
        for p in procs + [launcher]:
            p.kill()
        raise
    finally:
        for f in logs:
            f.close()
    procs = procs[1:]
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    assert not failed, "\n".join(
        f"rank {r}:\n" + (d / f"rank{r}.log").read_text()[-3000:]
        for r in failed)
    assert jproc.returncode == 0, jerr[-3000:]
    ranks = [torch.load(d / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    return SimpleNamespace(dir=d, inp=inp, ref=ref, ranks=ranks,
                           whole=whole, seq=seq, single=single,
                           psum=dict(np.load(d / "psum_out.npz")),
                           resumed=_resume_world_one(d), launcher=launcher)


# ---------------------------------------------------------------------------
# sharding rules, meshes and placements
# ---------------------------------------------------------------------------

def test_rules_and_names_match_reference():
    from repro_torch.distributed import sharding
    assert sharding.SERVE_RULES == jsharding.SERVE_RULES
    assert sharding.PREFILL_RULES == jsharding.PREFILL_RULES
    assert sharding.PARAM_RULES == jsharding.PARAM_RULES
    for pat, _ in jsharding.PARAM_RULES:
        assert any(re.search(pat, n) for n, _ in PLACEMENT_NAMES), pat


@pytest.mark.parametrize("rules", ["default", "serve"])
@pytest.mark.parametrize("mesh", MESHES)
def test_placements_give_each_rank_its_device_box(world, mesh, rules):
    """Every rule on every mesh: each rank's ``to_local()`` of a tensor
    distributed with ``placements_for(spec)`` is the reference's
    ``device_box`` of its flat mesh index (the port's copy of
    ``device_box`` is held to the reference's here too)."""
    jr = {"default": jsharding.DEFAULT_RULES, "serve": jsharding.SERVE_RULES}
    shapes = {"data4": {"data": 4}, "pod2data2": {"pod": 2, "data": 2},
              "data2model2": {"data": 2, "model": 2}}[mesh]
    jm = jsharded.MeshSpec.from_any(shapes)
    multi = 0
    for r, res in enumerate(world.ranks):
        rows = res["placements"][(mesh, rules)]
        assert len(rows) == len(PLACEMENT_NAMES)
        for (name, spec, ok), (_, shape) in zip(rows, PLACEMENT_NAMES):
            assert ok, (r, name, spec)
            want = jsharding.spec_for(
                shape, jsharding.logical_axes_for_path(name, len(shape)), jm,
                jr[rules])
            assert tuple(spec) == tuple(want), (name, spec, want)
            multi += any(isinstance(e, tuple) for e in spec)
    if (mesh, rules) == ("data2model2", "serve"):
        assert multi > 0          # an expert dim over ("data", "model")


def test_batch_spec_shards_over_pod_then_data(world):
    for res in world.ranks:
        assert res["batch_spec"] == ["S(0)", "S(0)"]
        assert res["meshspec"] == {"data": 2, "model": 2}
    assert [r["flat_index"]["m22tp"] for r in world.ranks] == [0, 1, 2, 3]


def test_device_mesh_and_steps_refuse_what_they_cannot_run(world):
    """``device_mesh`` on a world of another size, a ``model`` axis of 2
    for each step factory (the train step of the MoE family, which has no
    tensor parallelism; the prefill and decode steps of any), a mesh on
    another device: each raises."""
    for res in world.ranks:
        e = res["errors"]
        assert e["world_size"].startswith("ValueError") and \
            "4 ranks" in e["world_size"]
        for msg in e["model_axis"]:
            assert msg.startswith("NotImplementedError") and \
                "not yet ported" in msg
        assert e["device"].startswith("ValueError")


def test_device_free_meshes_of_several_devices_raise():
    cfg = configs.get("llama3-8b", smoke=True)
    with pytest.raises(ValueError, match="DeviceMesh"):
        make_train_step(cfg, MeshSpec(("data", "model"), (2, 1)),
                        AdamWConfig())
    with pytest.raises(NotImplementedError, match="not yet ported"):
        make_prefill_step(cfg, {"data": 1, "model": 2})


# ---------------------------------------------------------------------------
# gpipe_apply
# ---------------------------------------------------------------------------

def test_split_stages():
    layers = {"w": torch.arange(24.).reshape(6, 2, 2)}
    got = pipeline_stage.split_stages(layers, 3)
    assert got["w"].shape == (3, 2, 2, 2)
    assert torch.equal(got["w"][1, 0], layers["w"][2])


@pytest.mark.parametrize("stages", [2, 4])
def test_gpipe_matches_the_stages_in_sequence(world, stages):
    """S stages over M = 6 microbatches equal the stages run in sequence
    (rtol GPIPE_RTOL) on every rank; each stage boundary carried exactly
    M + S - 1 sends, one a tick."""
    want = world.seq[stages]
    sends = {}
    for res in world.ranks:
        g = res["gpipe"][stages]
        np.testing.assert_allclose(g["y"].numpy(), want, rtol=GPIPE_RTOL,
                                   atol=0)
        assert g["calls"] == GPIPE_M + stages - 1
        sends[g["sid"]] = sends.get(g["sid"], 0) + g["sends"]
    pipes = WORLD // stages
    for sid in range(stages):
        want_sends = (GPIPE_M + stages - 1) * pipes if sid < stages - 1 \
            else 0
        assert sends[sid] == want_sends, (sid, sends)


# ---------------------------------------------------------------------------
# cross_pod_psum_compressed
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("key", list(PSUM_SHAPES))
@pytest.mark.parametrize("pods", [2, 4])
def test_psum_matches_reference(world, pods, key):
    """The global result equals the reference's on fake CPU devices: bit
    for bit on 2 pods, within 2 ulp on 4 (the sum of 4 parts may take
    another order); every rank's part is its pod's slice of it."""
    want = world.psum[f"{key}_{pods}"]
    for res in world.ranks:
        got = res["psum"][pods][key]
        full = got["full"].numpy()
        assert full.dtype == want.dtype == np.float32
        if pods == 2:
            np.testing.assert_array_equal(full, want)
        else:
            ulp = np.spacing(np.abs(want).astype(np.float32))
            assert np.all(np.abs(full - want) <= 2 * ulp)
        assert got["placements"][0] == "S(0)"
    for r, res in enumerate(world.ranks):
        pod = r // (WORLD // pods)
        np.testing.assert_array_equal(res["psum"][pods][key]["local"][0],
                                      res["psum"][pods][key]["full"][pod])


@pytest.mark.parametrize("pods", [2, 4])
def test_psum_wire_bytes_per_value(world, pods):
    """Codes plus scales each rank puts on the wire: 1 + 4 / 128 = 1.03125
    B a value for a blockable part, within the 1.04 bound."""
    for res in world.ranks:
        st = res["psum"][pods]["block"]["stats"]
        n = int(np.prod(PSUM_SHAPES["block"]))
        assert st["elements"] == n
        assert st["wire_bytes"] == n + 4 * n // 128
        assert st["wire_bytes"] <= 1.04 * st["elements"]


@pytest.mark.parametrize("case", ["leading", "replicated", "plain",
                                  "no_pod_axis"])
def test_psum_rejects_what_is_not_sharded_on_the_pod_axis(world, case):
    for res in world.ranks:
        msg = res["psum_rejects"][case]
        assert msg is not None and msg.startswith("ValueError"), msg
        assert "pod axis" in msg


# ---------------------------------------------------------------------------
# data-parallel steps
# ---------------------------------------------------------------------------

def _dp_runs(world, size, arch, tag):
    """(rank, run) of every rank that ran this case."""
    return [(r, res["dp"][(size, arch, tag)]) for r, res in
            enumerate(world.ranks) if (size, arch, tag) in res["dp"]]


@pytest.mark.parametrize("ef", [False, True], ids=["ef_off", "ef_on"])
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("size", [2, 4])
def test_data_parallel_step_matches_the_whole_batch(world, size, arch, ef):
    """Two steps on a world of ``size`` (4: (pod 2, data 2, model 1) under
    the default rules, the state sharded over data with pod replicas and
    gathered whole; 2: the data axis of one pod, the state replicated,
    ``"fsdp": None``) against the single-process step on the whole batch,
    f32 moments; the replicas of every rank equal bit for bit.  Gradients summed in f32 across ranks differ from the whole
    batch's in their last bits, so: losses rel LOSS_RTOL; without EF
    every state tensor within PARAM_RTOL of its leaf's max magnitude
    (elementwise, a weight near 0 parts by up to 2.4e-4 of itself); with
    EF an int8 code on a rounding boundary may round either way, so a
    parameter leaf may part beyond that in at most PART_SHARE of its
    weights (5e-5 to 9e-5 measured), none beyond PARAM_TOL of its max,
    and the EF state and moments, which take the flipped codes, are not
    compared elementwise."""
    PARAM_TOL, PART_SHARE = 1e-3, 1e-3
    want = world.whole[(arch, False, ef)]
    runs = _dp_runs(world, size, arch, ef)
    assert len(runs) == size
    for r, run in runs:
        np.testing.assert_allclose(run["losses"], want["losses"],
                                   rtol=LOSS_RTOL)
        assert sorted(run["state"]) == sorted(want["state"])
        for k, w in want["state"].items():
            g = run["state"][k]
            if not isinstance(w, np.ndarray) or w.dtype.kind != "f":
                assert np.array_equal(g, w), k
                continue
            scale = float(np.abs(w).max())
            if not ef:
                np.testing.assert_allclose(g, w, rtol=0,
                                           atol=PARAM_RTOL * scale,
                                           err_msg=k)
            elif k.startswith("params/"):
                far = np.abs(g - w) > PARAM_RTOL * scale
                assert far.mean() <= PART_SHARE, (k, far.mean())
                np.testing.assert_allclose(g, w, rtol=0,
                                           atol=PARAM_TOL * scale,
                                           err_msg=k)
    first = runs[0][1]["state"]
    for _, run in runs[1:]:
        for k, v in run["state"].items():
            np.testing.assert_array_equal(v, first[k], err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_data_parallel_step_with_8bit_moments(world, arch):
    """8-bit moments and EF on a world of 2 (the state replicated,
    ``"fsdp": None``): losses rel LOSS_RTOL; a
    moment code on a rounding boundary may round either way after
    last-bit gradient differences, and where ``v``'s code is 0 AdamW
    divides by eps, so, as ``tests/test_torch_train.py`` does, each
    parameter leaf may part beyond PARAM_TOL of its max|p| in at most
    PART_SHARE of its weights, and codes by at most CODE_TOL."""
    PARAM_TOL, PART_SHARE, CODE_TOL = 1e-3, 0.005, 2
    want = world.whole[(arch, True, True)]
    runs = _dp_runs(world, 2, arch, "q8")
    assert len(runs) == 2
    for _, run in runs:
        np.testing.assert_allclose(run["losses"], want["losses"],
                                   rtol=LOSS_RTOL)
        for k, w in want["state"].items():
            g = run["state"][k]
            if k.startswith("params/"):
                far = np.abs(g - w) > PARAM_TOL * float(np.abs(w).max())
                assert far.mean() <= PART_SHARE, (k, far.mean())
            elif np.asarray(w).dtype == np.int8:
                assert int(np.abs(g.astype(np.int16) - w).max()) <= \
                    CODE_TOL, k


def test_data_parallel_prefill_and_decode(world):
    """Prefill and two decode steps on (data 4, model 1): each rank keeps
    its row's caches and returns every row's logits, within 1e-5 of
    max|logit| of the single-process steps', greedy tokens equal."""
    for res in world.ranks:
        pd = res["prefill_decode"]
        assert pd["cache_rows"] == B // WORLD
        for got, want in zip(pd["logits"], world.single):
            got = got.numpy()
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=1e-5 * np.abs(want).max())
            assert np.array_equal(got.argmax(-1), want.argmax(-1))


# ---------------------------------------------------------------------------
# the loop: checkpoints, resume, SIGTERM
# ---------------------------------------------------------------------------

def test_world_of_two_saves_and_a_world_of_one_resumes(world):
    """The world of 2 (ranks 0 and 1) trains 4 steps with sharded raw
    saves at 2 and 4 written by rank 0 alone; a world of one restores
    step 2 and its steps 2 and 3 give the world of 2's losses (rel
    LOSS_RTOL).  A second world-of-2 run restores step 4 on both ranks
    and trains to 6."""
    a, b = world.ranks[0]["loops"], world.ranks[1]["loops"]
    assert a["final"] == b["final"] == 4 and a["losses"] == b["losses"]
    assert a["steps"] == [2, 4, 6]
    assert a["more_final"] == b["more_final"] == 6
    assert len(a["more_losses"]) == 2 and a["more_losses"] == b["more_losses"]
    manifest = jsharded.load_manifest(str(world.dir / "ckpt_w2" /
                                          "step_00000002"))
    assert manifest["mesh"] == {"axes": ["data"], "shape": [2]}
    assert {t["encoding"] for t in manifest["tensors"].values()} == {"raw"}
    np.testing.assert_allclose(world.resumed, a["losses"][2:],
                               rtol=LOSS_RTOL)


def test_sigterm_on_one_rank_stops_both_at_the_same_step(world):
    a, b = world.ranks[2]["loops"], world.ranks[3]["loops"]
    assert a["final"] == b["final"] == 2
    assert len(a["losses"]) == len(b["losses"]) == 2
    assert a["losses"] == b["losses"]
    assert a["steps"] == b["steps"] == [2]      # rank 2's final save


# ---------------------------------------------------------------------------
# restores onto a DeviceMesh
# ---------------------------------------------------------------------------

def _local_want(full: np.ndarray, name: str, flat: int) -> np.ndarray:
    jm = jsharded.MeshSpec.from_any(SAVE_MESH)
    axes = jsharded.spec_axes_for(name, full.shape, jm)
    starts, stops = jsharded.device_box(full.shape, axes, jm, flat)
    return full[tuple(slice(a, b) for a, b in zip(starts, stops))]


def test_restore_on_mesh_equals_reference(world):
    """The keyframe on (data 2, model 2): ``full_tensor()`` equals the
    reference's ``restore_flat`` bit for bit, each rank's local part its
    ``restore_local_slices`` for that rank, and a rank decodes fewer
    values than the whole manifest holds."""
    key = world.dir / "ref_ckpt" / "step_00000001"
    flat = jsharded.restore_flat(str(key))
    local = jsharded.restore_local_slices(
        str(key), jsharded.MeshSpec.from_any(SAVE_MESH), range(WORLD))
    total = jsharded.manifest_total_values(jsharded.load_manifest(str(key)))
    sharded_any = False
    for r, res in enumerate(world.ranks):
        got = res["restores"]
        assert got["keyframe_types"] == ["DTensor"]
        assert sorted(got["keyframe_full"]) == sorted(flat)
        for name, want in flat.items():
            np.testing.assert_array_equal(got["keyframe_full"][name],
                                          _bits(want), err_msg=name)
            np.testing.assert_array_equal(got["keyframe_local"][name],
                                          _bits(local[name][r]),
                                          err_msg=name)
            sharded_any |= got["keyframe_local"][name].shape != want.shape
        assert got["keyframe_decoded"] < total
    assert sharded_any


@pytest.mark.parametrize("devices", [[0], [0, 3]])
def test_restore_local_slices_equals_reference(world, devices):
    """Device-free, on (data 1, model 4) against the (data 2, model 2)
    save: the same numpy slices as the reference's, and the same decoded
    values, bytes and records; device 0 alone decodes fewer values than
    the manifest holds."""
    from repro_torch.checkpoint import sharded
    key = world.dir / "ref_ckpt" / "step_00000001"
    mesh = {"data": 1, "model": 4}
    jstats, stats = jsharded.RestoreStats(), sharded.RestoreStats()
    want = jsharded.restore_local_slices(
        str(key), jsharded.MeshSpec.from_any(mesh), devices, stats=jstats)
    got = sharded.restore_local_slices(str(key), MeshSpec.from_any(mesh),
                                       devices, stats=stats)
    assert sorted(got) == sorted(want)
    for name in want:
        for dev in devices:
            assert isinstance(got[name][dev], np.ndarray)
            np.testing.assert_array_equal(got[name][dev],
                                          _bits(want[name][dev]))
    assert stats.as_dict() == jstats.as_dict()
    if devices == [0]:
        total = sharded.manifest_total_values(
            sharded.load_manifest(str(key)))
        assert 0 < stats.decoded_values < total


def test_restore_on_mesh_delta_equals_reference(world):
    """The P-frame rebuilt on the host and placed on (data 2, model 2):
    ``full_tensor()`` equals the reference's ``restore_flat_delta`` bit
    for bit, each rank's part its box of it."""
    want = jdelta.restore_flat_delta(str(world.dir / "ref_ckpt"), 2)
    for r, res in enumerate(world.ranks):
        got = res["restores"]
        assert sorted(got["delta_full"]) == sorted(want)
        for name, w in want.items():
            np.testing.assert_array_equal(got["delta_full"][name], _bits(w),
                                          err_msg=name)
            np.testing.assert_array_equal(
                got["delta_local"][name],
                _bits(_local_want(np.asarray(w), name, r)), err_msg=name)


@pytest.mark.parametrize("step", [1, 2], ids=["keyframe", "delta"])
def test_manager_restore_on_a_mesh(world, step):
    """``CheckpointManager.restore(mesh=)`` of the reference's steps: the
    parameters are DTensors whose ``full_tensor()`` equals the reference's
    restore bit for bit, the rest of the state as saved; a monolithic step
    with ``mesh=`` raises the reference's ValueError."""
    root = str(world.dir / "ref_ckpt")
    want = (jsharded.restore_flat(root + "/step_00000001") if step == 1
            else jdelta.restore_flat_delta(root, 2))
    for res in world.ranks:
        got = res["restores"][f"manager_{step}"]
        assert got["types"] == ["DTensor"] and got["count"] == step
        for name, w in want.items():
            np.testing.assert_array_equal(got["params"][name], _bits(w),
                                          err_msg=name)
        mono = res["restores"]["monolithic"]
        assert mono.startswith("ValueError") and "needs a sharded" in mono


# ---------------------------------------------------------------------------
# serving from a mesh load
# ---------------------------------------------------------------------------

def _ref_backend_tree(world, name):
    jcfg = jconfigs.get("llama3-8b", smoke=True)
    be = jbackends.get_backend(name, mesh=jmesh.make_local_mesh(1, 1))
    return {k: np.asarray(v) for k, v in jflatten(be.load(
        jcfg, str(world.dir / "ref_ckpt" / "step_00000001"))).items()}


def test_bf16_backend_on_a_mesh_equals_reference(world):
    """``Bf16Backend(mesh=)`` on (data 2, model 2): every leaf is a
    DTensor of the template's dtype whose ``full_tensor()`` equals the
    reference's ``Bf16Backend(mesh=1 x 1)`` load bit for bit."""
    want = _ref_backend_tree(world, "bf16")
    for res in world.ranks:
        got = res["restores"]
        assert got["bf16_types"] == ["DTensor"]
        assert sorted(got["bf16"]) == sorted(want)
        for k, w in want.items():
            np.testing.assert_array_equal(got["bf16"][k], _bits(w),
                                          err_msg=k)


def test_q8_backend_ignores_the_mesh_as_the_reference(world):
    """The reference's q8 backend converts a manifest on the host whatever
    the mesh (its ``Q8Backend.load`` passes no mesh): the port's q8 load
    with ``mesh=`` gives plain q8 leaves (codes and scales), equal to its
    load without a mesh (itself held to the reference's in
    ``tests/test_torch_swap.py``)."""
    for res in world.ranks:
        got, want = res["restores"]["q8"], res["restores"]["q8_plain"]
        assert any(k.endswith("/q8") for k in want)
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_mesh_load_refuses_tracking_and_sharded_sessions(world):
    for res in world.ranks:
        got = res["restores"]
        assert got["tracking"].startswith("RuntimeError") and \
            "track_levels" in got["tracking"]
        assert got["session_sharded"].startswith("NotImplementedError") \
            and "not yet ported" in got["session_sharded"]


def test_session_on_a_mesh_of_one_equals_the_plain_load(world):
    """A bf16 backend with ``mesh=`` a mesh of one rank: the session takes
    each whole DTensor's local tensor and its greedy tokens equal those of
    the same manifest loaded without a mesh."""
    got = world.ranks[0]["session_one"]
    assert got["leaf_types"] == ["Tensor"]
    cfg = configs.get("llama3-8b", smoke=True)
    sess = ServeSession(cfg, str(world.dir / "ref_ckpt" / "step_00000001"),
                        backend="bf16",
                        serve_cfg=ServeConfig(slots=2, max_len=24),
                        device="cpu")
    prompts = [list(range(3, 11)), list(range(40, 46))]
    hs = [sess.submit(p, max_new_tokens=6) for p in prompts]
    sess.run()
    assert got["tokens"] == [h.tokens for h in hs]


def test_quantize_params_for_serving_matches_reference(world):
    """On the reference's smoke weights (those of its saved steps)."""
    flat = world.ref["p1"]
    jp = world.ref["tree"]({k: jax.numpy.asarray(v)
                            for k, v in flat.items()})
    want = {k: np.asarray(v) for k, v in
            jflatten(jquantized.quantize_params_for_serving(jp)).items()}
    got = flatten_tree(quantized.quantize_params_for_serving(
        params_from_numpy(flat, "cpu")))
    assert sorted(got) == sorted(want)
    assert any(k.endswith("/q8s") for k in want)
    for k, w in want.items():
        np.testing.assert_array_equal(_np(got[k]), _bits(w), err_msg=k)


def test_new_modules_and_the_worker_import_no_jax(world):
    """Every rank imported the new modules (the distribution package, the
    mesh restores, the launcher, ``serve.quantized``) and nothing of JAX
    or of the JAX package (the check of ``tests/test_torch_kernels.py``,
    extended to them)."""
    for res in world.ranks:
        assert res["jax_modules"] == []


def test_launcher_trains_on_every_rank_under_torchrun(world):
    """``torchrun --standalone --nproc-per-node 2 -m
    repro_torch.launch.train --smoke --device cpu`` (started with the
    world: ``_launcher``): a gloo world of two on a (data 2, model 1)
    mesh (the rendezvous on a free local port), the state sharded over
    data; only rank 0 prints the reference's summary line, and its losses
    equal a world of one's ``train_loop`` on the same global batches to
    the 4 decimals the line prints."""
    from repro_torch.train.loop import LoopConfig, train_loop
    try:
        out, err = world.launcher.communicate(timeout=300)
    except BaseException:
        world.launcher.kill()
        raise
    assert world.launcher.returncode == 0, err[-3000:]
    lines = [ln for ln in out.splitlines() if ln.startswith("steps=")]
    assert len(lines) == 1, out
    m = re.fullmatch(r"steps=3 first_loss=(\S+) last_loss=(\S+) "
                     r"stragglers=\d+", lines[0])
    assert m, lines[0]
    one = train_loop(configs.get("llama3-8b", smoke=True), None,
                     LoopConfig(total_steps=3, batch=B, seq=S),
                     AdamWConfig(lr=1e-3), CompressionConfig(enabled=True),
                     device="cpu")
    assert [float(v) for v in m.groups()] == \
        [float(f"{one.losses[0]:.4f}"), float(f"{one.losses[-1]:.4f}")]
