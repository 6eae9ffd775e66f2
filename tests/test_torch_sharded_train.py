"""The sharded train state on the CPU (``distributed.fsdp``,
``distributed.tensor_parallel``): a gloo world of two, on (data 2,
model 1) and (data 1, model 2), and one of four, on (data 2, model 2) and
(data 1, model 4), each spawned once (``tests/_torch_dist_worker.py
sharded``, one intra-op thread a rank, rendezvous through a
``FileStore``); the cases assert on what each rank wrote.

The reference's ``make_train_step`` fails on a mesh of several devices
under the installed jax, so the sharded step is held to the port's
mesh-free step (itself held to the reference in
``tests/test_torch_train.py``) with ``tests/test_torch_distributed.py``'s
constants, and to the reference's specs and ``device_box`` for where each
shard lives; the box q8 codec is held to the reference's ``q8_encode``.
Every tolerance is stated beside its assertion.
"""

import filecmp
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jax.config.update("jax_platforms", "cpu")

from repro.checkpoint import sharded as jsharded  # noqa: E402
from repro.compression import q8 as jq8  # noqa: E402
from repro.distributed import sharding as jsharding  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.arrays import to_storage  # noqa: E402
from repro_torch.checkpoint import CheckpointConfig, CheckpointManager  # noqa
from repro_torch.checkpoint.sharded import MeshSpec  # noqa: E402
from repro_torch.compression.tree import flatten_tree  # noqa: E402
from repro_torch.data.pipeline import make_batch  # noqa: E402
from repro_torch.distributed.compress import CompressionConfig  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.train.steps import (init_train_state,  # noqa: E402
                                     make_train_step)

REPO = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).with_name("_torch_dist_worker.py")
B, S = 4, 16                   # the worker's global batch
TOTAL, WARMUP, LR = 12, 2, 1e-2
DP_STEPS = 2
# tests/test_torch_distributed.py's constants
LOSS_RTOL = 1e-5
PARAM_RTOL = 1e-5
PARAM_TOL, EF_PART_SHARE = 1e-3, 1e-3      # its f32 moments + EF rule
Q8_PART_SHARE, CODE_TOL = 0.005, 2          # its 8-bit rule
MESHES = {2: ((2, 1), (1, 2)), 4: ((2, 2), (1, 4))}
RUNS = (("llama3-8b", "f32"), ("llama3-8b", "q8"), ("qwen1.5-4b", "f32"),
        ("qwen1.5-4b", "q8"))
# FSDP only: on (data 2, model 1)
MOE_RUNS = (("deepseek-moe-16b", "f32"), ("deepseek-moe-16b", "q8"))
# q_norm / k_norm, replicated but read on a rank's heads: on (data 1,
# model 2) and (data 1, model 4)
QK_NORM_RUNS = (("qwen3-8b", "f32"), ("qwen3-8b", "q8"))


# the q/k/v biases (qwen1.5-4b): zero at init, so a leaf's scale is
# AdamW's own step
BIASES = ("attn/bq", "attn/bk", "attn/bv")


def _runs_on(mesh):
    return RUNS + (MOE_RUNS if mesh[1] == 1 else
                   QK_NORM_RUNS if mesh[0] == 1 else ())


CASES = [(w, m, a, mode) for w, ms in MESHES.items() for m in ms
         for a, mode in _runs_on(m)]
# the smoke llama3-8b's leaves the box-codec checks encode: wq's 128
# columns (128-blocks cut by a model split), wk's 64 (one absmax scale),
# w_gate's 256
BOX_Q8 = {"layers/attn/wq": (2, 128, 128), "layers/attn/wk": (2, 128, 64),
          "layers/mlp/w_gate": (2, 128, 256)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return to_storage(t) if isinstance(t, torch.Tensor) else np.asarray(t)


def _configs(mode):
    quant = mode == "q8"
    return (AdamWConfig(lr=LR, quantized_moments=quant),
            CompressionConfig(enabled=quant))


def _mesh_free(arch, mode) -> dict:
    cfg = configs.get(arch, smoke=True)
    opt, comp = _configs(mode)
    state = init_train_state(cfg, opt, comp, seed=0, device="cpu")
    _, make = make_train_step(cfg, None, opt, comp, total_steps=TOTAL,
                              warmup=WARMUP)
    fn = make(state, None)
    losses = []
    for i in range(DP_STEPS):
        state, m = fn(state, make_batch(cfg, i, batch=B, seq=S, seed=0))
        losses.append(float(m["loss"]))
    return {"losses": losses,
            "state": {k: (_np(v) if isinstance(v, torch.Tensor) else int(v))
                      for k, v in flatten_tree(state).items()}}


def _bias_of(k: str):
    """The parameter name of a q/k/v bias's state leaf (the weight or
    one of its moments), else None."""
    for prefix in ("params/", "opt/moments/"):
        if k.startswith(prefix):
            rel = k[len(prefix):]
            name = rel if prefix == "params/" else rel.rsplit("/", 1)[0]
            if name.endswith(BIASES):
                return name
    return None


def _adam_step_change(want: dict, got: dict, name: str) -> np.ndarray:
    """LR times the first-order change of parameter ``name``'s
    bias-corrected AdamW ratio ``m^ / sqrt(v^)`` after DP_STEPS steps under
    the measured differences of its moments (``got`` against ``want``):
    ``f * (|dm| / sqrt(v) + |m| |dv| / (2 v^1.5))``, ``f = sqrt(1 - b2^c) /
    (1 - b1^c)``; 0 where ``v`` is 0."""
    opt = AdamWConfig(lr=LR)
    c = DP_STEPS
    f = np.sqrt(1.0 - opt.b2 ** c) / (1.0 - opt.b1 ** c)
    m, v = (want[f"opt/moments/{name}/{s}"].astype(np.float64)
            for s in ("m", "v"))
    dm, dv = (np.abs(got[f"opt/moments/{name}/{s}"] - x)
              for s, x in (("m", m), ("v", v)))
    sv = np.sqrt(np.where(v > 0, v, 1.0))
    return np.where(v > 0, LR * f * (dm / sv + np.abs(m) * dv /
                                     (2.0 * sv ** 3)), 0.0)


def _resume_world_one(d: Path) -> list:
    """A world of one restores the world of four's raw sharded step 2 and
    runs steps 2 and 3 with the loop's schedule (4 steps, warmup 100)."""
    cfg = configs.get("llama3-8b", smoke=True)
    opt, comp = _configs("q8")
    template = init_train_state(cfg, opt, comp, seed=5, device="cpu")
    state, _ = CheckpointManager(CheckpointConfig(
        str(d / "sh_raw"), params_mode="raw")).restore(template, step=2,
                                                       device="cpu")
    _, make = make_train_step(cfg, None, opt, comp, total_steps=4)
    fn = make(state, None)
    losses = []
    for i in (2, 3):
        state, m = fn(state, make_batch(cfg, i, batch=B, seq=S, seed=0))
        losses.append(float(m["loss"]))
    return losses


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds run at once; meanwhile the mesh-free steps of every
    (arch, moments) case."""
    rng = np.random.default_rng(17)
    box_in = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              for k, s in BOX_Q8.items()}
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(REPO / "src"), os.environ.get("PYTHONPATH", "")]),
        "OMP_NUM_THREADS": "1"}
    dirs, procs, logs = {}, [], []
    try:
        for size in MESHES:
            d = tmp_path_factory.mktemp(f"world{size}")
            torch.save({"box_q8": box_in}, d / "inputs.pt")
            dirs[size] = d
            for r in range(size):
                logs.append(open(d / f"rank{r}.log", "w"))
                procs.append((size, r, subprocess.Popen(
                    [sys.executable, str(WORKER), str(r), str(size), str(d),
                     "sharded"], env=env, cwd=REPO, stdout=logs[-1],
                    stderr=subprocess.STDOUT)))
        free = {(a, mode): _mesh_free(a, mode)
                for a, mode in RUNS + MOE_RUNS + QK_NORM_RUNS}
        for _, _, p in procs:
            p.wait(timeout=400)
    except BaseException:
        for _, _, p in procs:
            p.kill()
        raise
    finally:
        for f in logs:
            f.close()
    failed = [(s, r) for s, r, p in procs if p.returncode != 0]
    assert not failed, "\n".join(
        f"world {s} rank {r}:\n" +
        (dirs[s] / f"rank{r}.log").read_text()[-3000:] for s, r in failed)
    ranks = {s: [torch.load(dirs[s] / f"rank{r}.pt", weights_only=False)
                 for r in range(s)] for s in MESHES}
    return SimpleNamespace(dirs=dirs, ranks=ranks, free=free,
                           box_in={k: v.numpy() for k, v in box_in.items()},
                           resumed=_resume_world_one(dirs[4]))


def _run(worlds, world, mesh, arch, mode):
    return [res["runs"][(mesh, arch, mode)] for res in worlds.ranks[world]]


# ---------------------------------------------------------------------------
# the sharded step against the mesh-free step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world,mesh,arch,mode", CASES)
def test_sharded_step_matches_the_mesh_free_step(worlds, world, mesh, arch,
                                                 mode):
    """Two steps under the default rules against the mesh-free step on the
    whole batch, the state gathered whole.  Losses rel LOSS_RTOL on every
    rank.  f32 moments without EF: with no model axis (FSDP over data,
    only the gradient sums change order) every state tensor within
    PARAM_RTOL of its leaf's max magnitude, as the data-parallel test
    holds it; on a model axis the row-parallel products and the
    vocab-parallel loss also sum in another order, so a gradient near 0
    differs in more than its last bits and AdamW's normalisation carries
    that into its weight: a leaf may part beyond PARAM_RTOL in at most
    EF_PART_SHARE of its elements, none beyond PARAM_TOL of its max (the
    data-parallel test's f32 + EF rule; 1 of 65536 weights of w_down
    measured at 1.5e-5).  The q/k/v biases (BIASES) on a model axis: their
    gradient falls along the rotary dims (rope_theta 1e6) to 1e-8 of 1e-2
    at its smallest, where f32 rounds it at 1e-9 to 2e-8, and AdamW moves
    each element by about lr whatever its gradient, so that rounding
    reaches the weight divided by the element's own ``sqrt(v)`` (113 of
    256 elements of ``bk`` measured beyond PARAM_RTOL, up to 7.5e-3 of
    its max).  Their moments ``m`` and ``v``, the gradients' record, are
    held elementwise to PARAM_RTOL of the leaf's max (measured <= 1.5e-6),
    and each weight element to the larger of PARAM_RTOL of its max and
    LR times the first-order change of AdamW's ratio under the moments'
    measured differences (:func:`_adam_step_change`; measured <= 0.5 of
    it where an element parts).  8-bit moments with EF: the data-parallel
    test's 8-bit rule (a parameter leaf parts beyond PARAM_TOL in at
    most Q8_PART_SHARE, codes within CODE_TOL; the EF and the scales take
    the flipped codes and are not compared elementwise)."""
    runs = _run(worlds, world, mesh, arch, mode)
    want = worlds.free[(arch, mode)]
    for run in runs:
        np.testing.assert_allclose(run["losses"], want["losses"],
                                   rtol=LOSS_RTOL)
    got = runs[0]["whole"]
    assert sorted(got) == sorted(want["state"])
    for k, w in want["state"].items():
        g = got[k]
        if not isinstance(w, np.ndarray):
            assert g == w, k
            continue
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if mode == "f32":
            scale = float(np.abs(w).max())
            bias = _bias_of(k)
            if mesh[1] == 1 or (bias and not k.startswith("params/")):
                np.testing.assert_allclose(g, w, rtol=0,
                                           atol=PARAM_RTOL * scale,
                                           err_msg=k)
            elif bias:
                bound = np.maximum(PARAM_RTOL * scale, _adam_step_change(
                    want["state"], got, bias))
                assert (np.abs(g - w) <= bound).all(), (
                    k, float(np.max(np.abs(g - w) / bound)))
            else:
                far = np.abs(g - w) > PARAM_RTOL * scale
                assert far.mean() <= EF_PART_SHARE, (k, far.mean())
                np.testing.assert_allclose(g, w, rtol=0,
                                           atol=PARAM_TOL * scale,
                                           err_msg=k)
        elif k.startswith("params/"):
            far = np.abs(g - w) > PARAM_TOL * float(np.abs(w).max())
            assert far.mean() <= Q8_PART_SHARE, (k, far.mean())
        elif w.dtype == np.int8:
            assert int(np.abs(g.astype(np.int16) - w).max()) <= CODE_TOL, k


def _ref_boxes(whole: dict, mesh, flat: int) -> dict:
    """Flat state name -> [start, stop) box of the reference's
    ``build_param_specs`` (per subtree, the default rules) and
    ``device_box`` for device ``flat``."""
    jm = jsharded.MeshSpec.from_any({"data": mesh[0], "model": mesh[1]})
    out = {}
    for prefix in ("params/", "opt/moments/", "ef/"):
        names = {k[len(prefix):]: v for k, v in whole.items()
                 if k.startswith(prefix)}
        tree: dict = {}
        for name, v in names.items():
            *parents, last = name.split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[last] = np.empty(v.shape, np.int8)
        specs = jsharding.build_param_specs(tree, jm,
                                            jsharding.DEFAULT_RULES)
        for name, v in names.items():
            spec = specs
            for p in name.split("/"):
                spec = spec[p]
            axes = jsharded._spec_axes(spec, v.ndim)
            out[prefix + name] = jsharded.device_box(v.shape, axes, jm, flat)
    return out


@pytest.mark.parametrize("world,mesh,arch,mode", CASES)
def test_each_rank_holds_the_reference_box_of_every_leaf(worlds, world, mesh,
                                                         arch, mode):
    """Every state leaf (parameters, moments with ``m_s`` / ``v_s``, EF,
    counters): each rank's tensor is the whole state's box that the
    reference's ``build_param_specs`` and ``device_box`` give the rank's
    flat index, bit for bit (``tests/test_torch_distributed.py``'s
    ``_local_want``)."""
    runs = _run(worlds, world, mesh, arch, mode)
    whole = runs[0]["whole"]
    for r, (res, run) in enumerate(zip(worlds.ranks[world], runs)):
        assert res["flat_index"][mesh] == r
        boxes = _ref_boxes(whole, mesh, r)
        assert sorted(run["local"]) == sorted(whole)
        for k, w in whole.items():
            if k not in boxes:                    # step, opt/count
                assert np.array_equal(run["local"][k], w), k
                continue
            starts, stops = boxes[k]
            assert (tuple(run["boxes"][k][1]), tuple(run["boxes"][k][2])) \
                == (tuple(starts), tuple(stops)), k
            np.testing.assert_array_equal(
                run["local"][k],
                w[tuple(slice(a, b) for a, b in zip(starts, stops))],
                err_msg=k)


def test_init_on_a_mesh_is_the_mesh_free_init_cut_to_boxes(worlds):
    """``init_train_state(..., mesh=)`` (drawn leaf by leaf, each cut as
    it comes) equals ``shard_state`` of the mesh-free state from the same
    seed, bit for bit, on every rank of the four meshes (llama3-8b and
    qwen1.5-4b, 8-bit moments with EF)."""
    for size, shapes in MESHES.items():
        for res in worlds.ranks[size]:
            for shape in shapes:
                for arch in ("llama3-8b", "qwen1.5-4b"):
                    assert res["init_is_shard_state"][(shape, arch)], \
                        (size, res["rank"], shape, arch)


@pytest.mark.parametrize("world,mesh", [(2, (1, 2)), (4, (2, 2)),
                                        (4, (1, 4))])
def test_leaves_replicated_over_model_are_equal_across_model_ranks(
        worlds, world, mesh):
    """A leaf whose spec names no ``model`` axis (norms, a scale leaf the
    model split does not divide, the counters) is equal bit for bit on the
    ranks of each model group, in every run on the mesh."""
    t = mesh[1]
    for arch, mode in _runs_on(mesh):
        runs = _run(worlds, world, mesh, arch, mode)
        n = 0
        for k, (spec, _, _) in runs[0]["boxes"].items():
            if any(e == "model" or (isinstance(e, tuple) and "model" in e)
                   for e in spec):
                continue
            n += 1
            for r, run in enumerate(runs):
                first = runs[r - r % t]["local"][k]
                np.testing.assert_array_equal(run["local"][k], first,
                                              err_msg=(k, r))
        assert n > 0


def test_resident_state_is_a_quarter_on_data2_model2(worlds):
    """On (data 2, model 2) each rank holds at most 0.27 of the mesh-free
    state's bytes, every run (the norms, counters and scale leaves are
    replicated)."""
    for arch, mode in RUNS:
        whole = sum(v.nbytes for v in worlds.free[(arch, mode)][
            "state"].values() if isinstance(v, np.ndarray))
        for run in _run(worlds, 4, (2, 2), arch, mode):
            assert run["resident"] <= 0.27 * whole, (arch, mode,
                                                     run["resident"] / whole)


# ---------------------------------------------------------------------------
# the box q8 codec and the model-axis gathers
# ---------------------------------------------------------------------------

def _box_codes(worlds, world, name):
    """(rank, its box codec's result, the reference's whole-leaf codes
    and scales cut to the rank's boxes of the leaf and its ``m_s``)."""
    mesh = MESHES[world][1]
    x = worlds.box_in[name]
    codes, scale = (np.asarray(a) for a in jq8.q8_encode(x))
    sqrt_codes = np.asarray(jq8.q8_encode_sqrt(np.abs(x))[0])
    decoded = np.asarray(jq8.q8_decode(codes, scale))
    whole = {f"params/{name}": x,
             f"opt/moments/{name}/m_s": np.empty(scale.shape, np.float32)}
    out = []
    for r, res in enumerate(worlds.ranks[world]):
        boxes = _ref_boxes(whole, mesh, r)
        box = tuple(slice(a, b) for a, b in zip(*boxes[f"params/{name}"]))
        sbox = tuple(slice(a, b) for a, b in
                     zip(*boxes[f"opt/moments/{name}/m_s"]))
        out.append((r, res["box_q8"][name], codes[box], scale[sbox],
                    decoded[box], sqrt_codes[box]))
    return out


def _assert_box_codes(worlds, world, name, kind):
    for r, got, codes, scale, decoded, sqrt_codes in _box_codes(
            worlds, world, name):
        assert got["kind"] == kind, (r, got["kind"])
        np.testing.assert_array_equal(got["codes"], codes)
        np.testing.assert_array_equal(got["scale"], scale)
        np.testing.assert_array_equal(got["decoded"], decoded)
        np.testing.assert_array_equal(got["sqrt_codes"], sqrt_codes)


@pytest.mark.parametrize("world", [2, 4])
def test_straddling_blocks_take_the_whole_leafs_codes(worlds, world):
    """wq's 128 columns over model 2 (64 a rank) and 4 (32): the split cuts
    each 128-block, and the scale leaf ``m_s`` stays replicated on model
    while the codes shard.  Each rank's codes, its scales (every block of
    the row), its decode and its sqrt-space codes equal the reference's
    ``q8_encode`` of the whole leaf cut to its boxes bit for bit; in the
    8-bit run ``wq``'s codec is the straddling one and ``m_s`` names no
    model axis."""
    _assert_box_codes(worlds, world, "layers/attn/wq", "straddle")
    mesh = MESHES[world][1]
    run = _run(worlds, world, mesh, "llama3-8b", "q8")[0]
    assert run["codecs"]["layers/attn/wq"] == "straddle"
    assert "model" in run["boxes"]["opt/moments/layers/attn/wq/m_q"][0]
    assert "model" not in run["boxes"]["opt/moments/layers/attn/wq/m_s"][0]


@pytest.mark.parametrize("world", [2, 4])
def test_scalar_scale_leaf_takes_the_max_over_its_shards(worlds, world):
    """wk's 64 columns (not a multiple of 128: one absmax scale for the
    leaf) split over model: every rank's codes and 0-d scale equal the
    reference's whole-leaf ones."""
    _assert_box_codes(worlds, world, "layers/attn/wk", "scalar")
    mesh = MESHES[world][1]
    run = _run(worlds, world, mesh, "llama3-8b", "q8")[0]
    assert run["codecs"]["layers/attn/wk"] == "scalar"
    assert run["boxes"]["opt/moments/layers/attn/wk/m_s"][0] == ()


def test_whole_blocks_encode_on_the_box(worlds):
    """w_gate's 256 columns over model 2: 128 a rank, whole blocks, the
    scales split with the codes; over model 4 (64 a rank) they straddle."""
    _assert_box_codes(worlds, 2, "layers/mlp/w_gate", "whole")
    _assert_box_codes(worlds, 4, "layers/mlp/w_gate", "straddle")


def test_cut_kv_head_is_gathered_over_model(worlds):
    """(data 1, model 4) on the llama3-8b smoke model (2 key/value heads
    of 32): the rule splits wk's and wv's 64 columns 16 a rank, half a
    head.  The step gathers them over model and slices the head the
    rank's query head reads (rank r: head r // 2); the query heads and
    ``wo`` keep their boxes.  The run itself is held by
    ``test_sharded_step_matches_the_mesh_free_step[4-mesh3-...]``."""
    for r, run in enumerate(_run(worlds, 4, (1, 4), "llama3-8b", "q8")):
        for name in ("layers/attn/wk", "layers/attn/wv"):
            spec, starts, stops = run["boxes"]["params/" + name]
            assert stops[2] - starts[2] == 16
            gathered, summed, narrow = run["plans"][name]
            assert (2, "model") in gathered and "model" not in summed
            assert narrow == (2, (r // 2) * 32, 32)
        for name in ("layers/attn/wq", "layers/attn/wo"):
            gathered, _, narrow = run["plans"][name]
            assert narrow is None and all(a != "model" for _, a in gathered)


def test_families_without_tensor_parallelism_refuse_a_model_axis(worlds):
    """MoE (deepseek-moe-16b), MLA (deepseek-v3-671b), SSM (mamba2-2.7b)
    and hybrid (zamba2-2.7b) on (data 1, model 2): ``init_train_state``
    and ``make_train_step`` raise ``NotImplementedError`` naming the
    family; the prefill and decode steps raise on a model axis for every
    family."""
    for res in worlds.ranks[2]:
        ref = res["refusals"]
        for arch in ("deepseek-moe-16b", "deepseek-v3-671b", "mamba2-2.7b",
                     "zamba2-2.7b"):
            family = configs.get(arch).family
            for msg in ref[arch]:
                assert msg.startswith("NotImplementedError"), msg
                assert f"the {family} family" in msg and \
                    "not yet ported" in msg, msg
        for msg in ref["steps"]:
            assert msg.startswith("NotImplementedError") and \
                "not yet ported" in msg, msg


# ---------------------------------------------------------------------------
# checkpoints of the sharded state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["raw", "cabac"])
def test_sharded_save_is_byte_identical_to_a_single_process_save(
        worlds, tmp_path, mode):
    """``train_loop`` on (data 2, model 2) saves step 2 (gathered leaf by
    leaf to rank 0, written sharded over the mesh's shape); the state the
    same two steps reach, gathered by DTensor's own ``full_tensor()`` and
    saved by one process with the same config and save mesh, gives the
    same step directory byte for byte (raw leaves whole in device 0's
    file; CABAC shards cut from the whole leaf)."""
    d = worlds.dirs[4]
    state = torch.load(d / "sh_state2.pt", weights_only=False)
    cfg = CheckpointConfig(str(tmp_path), sharded=True,
                           params_mode="raw" if mode == "raw" else "cabac")
    CheckpointManager(cfg).save(state, 2, mesh=MeshSpec(("data", "model"),
                                                        (2, 2)))
    got = d / f"sh_{mode}" / "step_00000002"
    want = tmp_path / "step_00000002"
    names = sorted(os.listdir(want))
    assert sorted(os.listdir(got)) == names
    assert sum(n.startswith("shard_") for n in names) == \
        (1 if mode == "raw" else 4)
    for n in names:
        assert filecmp.cmp(got / n, want / n, shallow=False), n


def test_world_of_one_resumes_the_sharded_save(worlds):
    """A world of one restores step 2 and its steps 2 and 3 give the world
    of four's losses (rel LOSS_RTOL); the loop's first two losses are the
    same steps' by ``make_train_step`` on the mesh, bit for bit."""
    for res in worlds.ranks[4]:
        c = res["ckpt"]
        assert c["final"] == 4 and c["steps"] == [2, 4]
        assert c["losses"][:2] == c["step_losses"]
    np.testing.assert_allclose(worlds.resumed,
                               worlds.ranks[4][0]["ckpt"]["losses"][2:],
                               rtol=LOSS_RTOL)


def test_world_of_four_resumes_on_its_mesh(worlds):
    """``restore(mesh=layout)`` of step 2 on (data 2, model 2) gives every
    rank its boxes of the state the steps reached (parameters, moments with
    ``m_s`` / ``v_s``, EF, counters) bit for bit; ``train_loop`` resumed on
    the mesh from step 2 repeats the straight run's steps 2 and 3 bit for
    bit."""
    for res in worlds.ranks[4]:
        c = res["ckpt"]
        assert c["meta_step"] == 2
        assert sorted(c["restored"]) == sorted(c["local"])
        assert any(k.endswith("/m_s") for k in c["restored"])
        for k, v in c["local"].items():
            np.testing.assert_array_equal(c["restored"][k], v, err_msg=k)
        assert c["resumed_final"] == 4
        assert c["resumed"] == c["losses"][2:]


def test_new_modules_import_no_jax(worlds):
    """Every rank of both worlds ran ``distributed.fsdp`` and
    ``distributed.tensor_parallel`` with nothing of JAX or of the JAX
    package imported."""
    for size in MESHES:
        for res in worlds.ranks[size]:
            assert res["jax_modules"] == []
