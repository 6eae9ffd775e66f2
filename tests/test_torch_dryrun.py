"""The port's dry run on the CPU (``repro_torch.launch.dryrun`` and
``launch.hlo_analysis``, ``device="cpu"``).

(a) The reference's own functions: ``input_specs`` of every arch and
shape, the tables and ``_wire_bytes`` equal ``repro.launch.dryrun``'s.
(b) The fake trace against real execution: the reference's mini dry-run
cell (``tests/test_dryrun_mini.py``: the smoke llama3-8b at 4 / 2 heads,
a batch of 8 x 64) traced on a fake world of 4 on (data 2, model 2), and
the same step recorded by the same recorder on a real gloo world of 4.
(c) The FLOP arithmetic of the mesh-free step and of its split over the
mesh, and the arguments against the ``StateLayout`` boxes.  (d) The
reference's mini dry run on (pod 2, data 2, model 2) with compression,
held to its own arithmetic (the reference's test fails under the
installed jax), with the compressed cross-pod psum's gathers.  (e) Cells
the port lacks raise "not yet ported", and ``main`` records them; the
fake backend on a CUDA mesh.  (f) No kernel wrapper runs on a fake or
meta tensor.

The fake worlds run in one subprocess and the gloo world in four, all
started together (``tests/_torch_dryrun_worker.py``)."""

import os
import subprocess
import sys
from contextlib import nullcontext
from dataclasses import asdict
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jax.config.update("jax_platforms", "cpu")

from repro_torch import configs  # noqa: E402
from repro_torch.compression.q8 import q8_scale_shape  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models.transformer import (init_cache,  # noqa: E402
                                            param_specs)

REPO = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).with_name("_torch_dryrun_worker.py")
WIRE_N = (1, 2, 4, 16, 256, 512)
WIRE_BYTES = (0, 1, 4096, 3 * 2**20 + 7)
# the worker's mini cell (tests/test_dryrun_mini.py's)
MINI_B, MINI_S = 8, 64
FLOP_RTOL = 0.01
# a (data 2, model 2) rank's resident share of the state, smoke models
SHARE_RANGE = (0.2511, 0.2524)


@pytest.fixture(scope="module")
def ref():
    """``repro.launch.dryrun``: its import sets ``XLA_FLAGS`` to 512 host
    devices, so jax starts first with this worker's flags and the
    variable is put back after."""
    jax.devices()
    prev = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jdry
    finally:
        if prev is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = prev
    return jdry


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The fake worlds' process and the gloo world's four, at once."""
    d = tmp_path_factory.mktemp("dryrun")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(REPO / "src"), os.environ.get("PYTHONPATH", "")]),
        "OMP_NUM_THREADS": "1"}
    cmds = [["fake", str(d)]] + [["gloo", str(r), "4", str(d)]
                                 for r in range(4)]
    procs, logs = [], []
    try:
        for i, cmd in enumerate(cmds):
            logs.append(open(d / f"proc{i}.log", "w"))
            procs.append(subprocess.Popen(
                [sys.executable, str(WORKER), *cmd], env=env, cwd=REPO,
                stdout=logs[-1], stderr=subprocess.STDOUT))
        for p in procs:
            p.wait(timeout=300)
    except BaseException:
        for p in procs:
            p.kill()
        raise
    finally:
        for f in logs:
            f.close()
    failed = [i for i, p in enumerate(procs) if p.returncode != 0]
    assert not failed, "\n".join(
        (d / f"proc{i}.log").read_text()[-3000:] for i in failed)
    return SimpleNamespace(
        fake=torch.load(d / "fake.pt", weights_only=False),
        gloo=torch.load(d / "rank0.pt", weights_only=False))


# ---------------------------------------------------------------------------
# (a) the reference's own functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_input_specs_match_reference(ref, arch):
    for shape in configs.SHAPES:
        want = ref.input_specs(arch, shape)
        got = dryrun.input_specs(arch, shape)
        assert list(got) == list(want), (arch, shape)
        for k, v in want.items():
            assert tuple(got[k].shape) == tuple(v.shape), (arch, shape, k)
            assert str(got[k].dtype).split(".")[-1] == \
                np.dtype(v.dtype).name, (arch, shape, k)
            assert got[k].device.type == "meta"


def test_tables_match_reference(ref, monkeypatch, tmp_path):
    assert dryrun.Q8_MOMENT_ARCHS == ref.Q8_MOMENT_ARCHS
    assert dryrun._DTYPE_BYTES == ref._DTYPE_BYTES
    assert dryrun._COLL_KINDS == ref._COLL_KINDS
    from repro import configs as jconfigs
    assert configs.SHAPES == jconfigs.SHAPES
    assert configs.LONG_CTX_ARCHS == jconfigs.LONG_CTX_ARCHS
    monkeypatch.setattr(ref, "RESULTS_DIR", str(tmp_path / "ref"))
    monkeypatch.setattr(dryrun, "RESULTS_DIR", tmp_path / "port")
    for arch in configs.ARCH_IDS:
        assert configs.shapes_for(arch) == jconfigs.shapes_for(arch)
        assert asdict(dryrun.opt_config(arch)) == \
            asdict(ref.opt_config(arch)), arch
        for shape in configs.SHAPES:
            for mesh_kind in ("single", "multi"):
                for suffix in ("", "__int8"):
                    assert os.path.basename(dryrun.cell_path(
                        arch, shape, mesh_kind, suffix)) == \
                        os.path.basename(ref.cell_path(
                            arch, shape, mesh_kind, suffix))


@pytest.mark.parametrize("kind", ("all-reduce", "all-gather",
                                  "reduce-scatter", "all-to-all",
                                  "collective-permute"))
def test_wire_bytes_match_reference(ref, kind):
    for n in WIRE_N:
        for b in WIRE_BYTES:
            assert dryrun._wire_bytes(kind, b, n) == \
                ref._wire_bytes(kind, b, n), (kind, n, b)


# ---------------------------------------------------------------------------
# (b) the fake trace against a real gloo world
# ---------------------------------------------------------------------------

def test_fake_world_collectives_match_gloo_world(runs):
    fake, gloo = runs.fake["dm22"], runs.gloo
    assert gloo["loss_finite"]
    assert fake["collectives"] == gloo["collectives"]
    assert fake["events"] == gloo["events"]
    assert fake["collectives"]["op_counts"]["all-gather"] > 0
    assert fake["collectives"]["op_counts"]["reduce-scatter"] > 0
    assert fake["collectives"]["op_counts"]["all-reduce"] > 0


def test_fake_world_flops_bytes_memory_match_gloo_world(runs):
    fake, gloo = runs.fake["dm22"], runs.gloo
    assert fake["flops_per_device"] == gloo["flops_per_device"] > 0
    # gloo runs a reduce-scatter as an all-reduce and then copies this
    # rank's shard out of it: a split and a copy_ the recorder sees (2 x
    # the shard's bytes each), which the fake backend (and NCCL) never
    # issue.  Every other op and byte is equal.
    rs = fake["collectives"]["op_counts"]["reduce-scatter"]
    extra = {k: gloo["op_counts"].get(k, 0) - fake["op_counts"].get(k, 0)
             for k in set(gloo["op_counts"]) | set(fake["op_counts"])}
    assert {k: v for k, v in extra.items() if v} == \
        {"aten.split": rs, "aten.copy_": rs}
    shard_bytes = fake["collectives"]["per_device_bytes"]["reduce-scatter"]
    assert gloo["bytes_per_device"] == \
        fake["bytes_per_device"] + 2 * shard_bytes
    for rng, acc in fake["per_comp"].items():
        if rng != "fsdp/reduce":
            assert gloo["per_comp"][rng] == acc, rng
    assert fake["memory"] == gloo["memory"]
    assert fake["bytes_per_device_bf16"] == fake["bytes_per_device"]


# ---------------------------------------------------------------------------
# (c) arithmetic
# ---------------------------------------------------------------------------

def _mini_cfg():
    return configs.get("llama3-8b", smoke=True).replace(
        num_heads=4, num_kv_heads=2, d_model=128, d_ff=256)


def test_mesh_free_flops_match_the_bound_formula(runs):
    """6 x matmul params x tokens + 12 B S^2 d L: the scan computes every
    KV block (no causal block is skipped) and at S = kv_block = 64 pads
    none.  The formula's one difference, named: it counts the stacked
    (L, d) norm scales as matmul parameters."""
    cfg = _mini_cfg()
    specs = param_specs(cfg)
    tokens = MINI_B * MINI_S
    n_mm = sum(int(np.prod(s)) for k, (s, _) in specs.items()
               if len(s) >= 2 and k != "embed")
    norms = sum(int(np.prod(s)) for k, (s, _) in specs.items()
                if len(s) == 2 and k.startswith("layers/"))
    attn = 12 * MINI_B * MINI_S ** 2 * cfg.d_model * cfg.num_layers
    got = runs.fake["free"]["flops_per_device"]
    formula = 6 * n_mm * tokens + attn
    assert abs(got - formula) <= FLOP_RTOL * formula
    assert got == 6 * (n_mm - norms) * tokens + attn


def test_mesh_flops_split_evenly(runs):
    """On (data 2, model 2) each rank runs a quarter of the mesh-free
    step's products: its rows, its heads, its hidden units, its vocab."""
    assert runs.fake["dm22"]["flops_per_device"] * 4 == \
        runs.fake["free"]["flops_per_device"]


def test_argument_bytes_are_the_layout_boxes(runs):
    f = runs.fake
    mem = f["dm22"]["memory"]
    assert mem["argument_bytes"] == f["dm22_boxes"] + f["dm22_batch_rows"]
    assert mem["alias_bytes"] == f["dm22_boxes"] - 4     # all but step
    share = f["dm22_boxes"] / f["free_state"]
    assert SHARE_RANGE[0] <= share <= SHARE_RANGE[1], share
    assert mem["live_bytes_est"] == mem["peak_bytes"] > mem["argument_bytes"]
    free = f["free"]["memory"]
    assert free["argument_bytes"] == f["free_state"] + \
        2 * MINI_B * MINI_S * 8


# ---------------------------------------------------------------------------
# (d) the reference's mini dry run, held to its own arithmetic
# ---------------------------------------------------------------------------

def test_reference_mini_dryrun_accounted(runs):
    pod = runs.fake["pod"]
    assert pod["n_chips"] == 8
    assert pod["flops_per_device"] > 0
    assert pod["collectives"]["total_per_device_bytes"] > 0
    assert pod["flops_per_device"] * 2 == \
        runs.fake["dm22"]["flops_per_device"]         # half the rows


def test_compressed_psum_gathers_codes_and_scales(runs):
    ps = runs.fake["psum"]
    codes = 4 * 128                                    # int8
    scales = 4 * int(np.prod(q8_scale_shape((4, 128))))  # f32
    assert ps["shape"] == (2, 4, 128)
    assert [(e["kind"], e["group_size"], e["dtypes"], e["bytes"])
            for e in ps["events"]] == [
        ("all-gather", 2, ["int8"], 2 * codes),
        ("all-gather", 2, ["float32"], 2 * scales)]
    assert ps["stats"]["wire_bytes"] == codes + scales
    coll = dryrun.collective_bytes(ps["events"], 8)
    assert coll["wire_bytes"]["all-gather"] == codes + scales


# ---------------------------------------------------------------------------
# (e) cells not yet ported, main, the fake world
# ---------------------------------------------------------------------------

def test_moe_train_cell_not_yet_ported(runs):
    msg = runs.fake["moe_raise"]
    assert msg.startswith("NotImplementedError") and "not yet ported" in msg


def test_main_records_not_yet_ported_and_exits_1(runs):
    main = runs.fake["main"]
    assert main["exit"] == 1
    assert "[not yet ported]" in main["stdout"]
    assert "FAILURES:" in main["stdout"] and \
        "deepseek-moe-16b" in main["stdout"]


def test_check_mesh_takes_fake_and_refuses_gloo_on_cuda(runs):
    assert runs.fake["fake_cuda_mesh"] is None
    assert runs.fake["gloo_cuda_mesh"] == (
        "ValueError: a CUDA mesh needs NCCL process groups, got 'gloo'")


def test_decode_cell_mesh_free_on_the_cpu():
    """A decode cell on one device: the serve step is accounted (no
    collective; the caches it writes in place are its aliases)."""
    cfg = configs.get("llama3-8b", smoke=True)
    small = {k: getattr(cfg, k) for k in ("num_layers", "d_model",
                                          "num_heads", "num_kv_heads",
                                          "head_dim", "d_ff", "vocab_size")}
    tr = dryrun.trace_cell("llama3-8b", "decode_32k", None, small,
                           device="cpu")
    res = dryrun.analyze(tr, 1)
    seq, batch, _ = configs.SHAPES["decode_32k"]
    assert res["flops_per_device"] > 0
    assert res["collectives"]["total_per_device_bytes"] == 0
    caches = init_cache(configs.get("llama3-8b").replace(**small), batch,
                        seq, device="meta")
    assert res["memory"]["alias_bytes"] == sum(
        t.numel() * t.element_size() for t in caches.values())


# ---------------------------------------------------------------------------
# (f) no kernel wrapper runs on a fake or meta tensor
# ---------------------------------------------------------------------------

def _kernel_calls(dev):
    from repro_torch.kernels.dequant_matmul import ops as dm
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.rd_quant import ops as rq
    x = torch.empty((4, 64), device=dev)
    w = torch.empty((64, 32), dtype=torch.int8, device=dev)
    s = torch.empty((32,), device=dev)
    xg = torch.empty((2, 4, 64), device=dev)
    wg = torch.empty((2, 64, 32), dtype=torch.int8, device=dev)
    q = torch.empty((1, 128, 4, 64), device=dev)
    kv = torch.empty((1, 128, 2, 64), device=dev)
    return {
        "dequant_matmul": [lambda: dm.dequant_matmul(x, w, s),
                           lambda: dm.dequant_matmul_cuda(x, w, s)],
        "dequant_matmul_grouped": [
            lambda: dm.dequant_matmul_grouped(xg, wg, s),
            lambda: dm.dequant_matmul_grouped_cuda(xg, wg, s)],
        "flash_attention": [lambda: fa.flash_attention(q, kv, kv),
                            lambda: fa._flash_cuda(q, kv, kv)],
        "rd_quant": [
            lambda: rq.rd_quant(x, None, None, step=0.01, lam=0.0),
            lambda: rq.rd_quant_cuda(x.reshape(-1), None, None, None,
                                     step=0.01, lam=0.0, window=4,
                                     max_level=100, num_gr=2, passes=2)],
    }


@pytest.mark.parametrize("name", ("dequant_matmul", "dequant_matmul_grouped",
                                  "flash_attention", "rd_quant"))
@pytest.mark.parametrize("where", ("fake_cuda", "meta"))
def test_kernel_wrappers_refuse_fake_and_meta(name, where):
    from repro_torch.kernels import registry
    from torch._subclasses.fake_tensor import FakeTensorMode
    before = registry.launch_counts()
    ctx = FakeTensorMode() if where == "fake_cuda" else nullcontext()
    with ctx:
        calls = _kernel_calls("cuda" if where == "fake_cuda" else "meta")
        for call in calls[name]:
            with pytest.raises(NotImplementedError,
                               match=f"does not account kernel {name} yet"):
                call()
    assert registry.launch_counts() == before
