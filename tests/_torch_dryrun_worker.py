"""The processes ``tests/test_torch_dryrun.py`` spawns, one intra-op
thread each; each writes what it saw to a ``.pt`` file in the directory
it is given.  Imports nothing of JAX.

    python tests/_torch_dryrun_worker.py fake <directory>
        every fake-world trace of the test file, one after the other in
        this process (a fake world is torn down and started again);
    python tests/_torch_dryrun_worker.py gloo <rank> <world size> <dir>
        one rank of a real gloo world (rendezvous through a FileStore):
        the mini cell's step on (data 2, model 2) with real tensors under
        the dry run's own recorder.
"""

from __future__ import annotations

import contextlib
import datetime
import io
import math
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.data.pipeline import make_batch, to_device
from repro_torch.distributed.compress import (CompressionConfig,
                                              cross_pod_psum_compressed)
from repro_torch.distributed.fsdp import StateLayout
from repro_torch.distributed.sharding import check_mesh
from repro_torch.launch import dryrun
from repro_torch.launch.hlo_analysis import OpAccount
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.steps import (init_train_state, make_train_step,
                                     train_layout)

# the reference's mini dry run (tests/test_dryrun_mini.py): the smoke
# llama3-8b at 4 / 2 heads, d_model 128, d_ff 256, a global batch of 8 x 64
MINI_OVERRIDES = dict(num_heads=4, num_kv_heads=2, d_model=128, d_ff=256)
MINI_B, MINI_S = 8, 64
DM22 = dict(data=2, model=2)


def mini_cfg():
    return configs.get("llama3-8b", smoke=True).replace(**MINI_OVERRIDES)


def mini_inputs() -> dict:
    return {k: torch.empty((MINI_B, MINI_S), dtype=torch.int32,
                           device="meta") for k in ("tokens", "labels")}


def train_configs(compress: bool = False):
    """The train cells' optimizer and compression: ``opt_config`` of
    llama3-8b (f32 moments) and EF off, as ``lower_cell`` has them."""
    return dryrun.opt_config("llama3-8b"), CompressionConfig(enabled=compress)


def state_box_bytes(layout, whole: bool = False) -> int:
    """The bytes of this rank's train state by its ``StateLayout`` alone:
    every leaf's box (``whole``: every whole leaf, the mesh-free state)
    and the 4-byte ``step``."""
    return 4 + sum(
        math.prod(shape if whole else layout.boxes[name].local_shape)
        * dtype.itemsize for name, (shape, dtype) in layout.shapes.items())


def _raises(fn) -> str | None:
    try:
        fn()
    except Exception as e:     # the case asserts on type and message
        return f"{type(e).__name__}: {e}"
    return None


def _record(trace: dict, n: int) -> dict:
    res = dryrun.analyze(trace, n)
    res["events"] = trace["events"]
    res["op_counts"] = trace["op_counts"]
    return res


def psum_account(mesh) -> dict:
    """``cross_pod_psum_compressed`` of the reference's mini input (pod i's
    partial sum a (4, 128) block of i + 1) traced on fake tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard
    acct = OpAccount("cpu")
    stats: dict = {}
    with FakeTensorMode():
        local = torch.empty((1, 4, 128), dtype=torch.float32)
        x = DTensor.from_local(local, mesh, [Shard(0), Replicate(),
                                             Replicate()], run_check=False)
        with acct:
            out = cross_pod_psum_compressed(x, mesh, stats=stats)
        shape = tuple(out.shape)
    return {"events": acct.events, "stats": stats, "shape": shape}


def fake_main(d: Path) -> None:
    cfg = mini_cfg()
    opt, comp = train_configs()
    res: dict = {}
    res["free"] = _record(dryrun.trace_train(cfg, opt, comp, mini_inputs(),
                                             device="cpu"), 1)
    with dryrun.fake_world(make_local_mesh(**DM22), "cpu") as mesh:
        res["dm22"] = _record(dryrun.trace_train(
            cfg, opt, comp, mini_inputs(), mesh, device="cpu"), 4)
        layout = StateLayout(cfg, opt, comp, mesh)
        res["dm22_boxes"] = state_box_bytes(layout)
        res["free_state"] = state_box_bytes(layout, whole=True)
        # tokens and labels (int64) of this rank's rows: 4 of the 8
        res["dm22_batch_rows"] = 2 * (MINI_B // 2) * MINI_S * 8
    with dryrun.fake_world(make_local_mesh(pod=2, **DM22), "cpu") as mesh:
        opt_mini, comp_on = AdamWConfig(), CompressionConfig(enabled=True)
        res["pod"] = _record(dryrun.trace_train(
            cfg, opt_mini, comp_on, mini_inputs(), mesh, device="cpu"), 8)
        res["psum"] = psum_account(mesh)
    with dryrun.fake_world(make_production_mesh(), "cpu") as mesh:
        res["moe_raise"] = _raises(lambda: dryrun.trace_cell(
            "deepseek-moe-16b", "train_4k", mesh, device="cpu"))
        from torch.distributed.device_mesh import init_device_mesh
        cuda_mesh = init_device_mesh("cuda", (16, 16),
                                     mesh_dim_names=("data", "model"))
        res["fake_cuda_mesh"] = _raises(lambda: check_mesh(cuda_mesh,
                                                           "cuda"))
    buf, code = io.StringIO(), 0
    try:
        with contextlib.redirect_stdout(buf):
            dryrun.main(["--arch", "deepseek-moe-16b", "--shape", "train_4k",
                         "--mesh", "single", "--device", "cpu"])
    except SystemExit as e:
        code = e.code
    res["main"] = {"exit": code, "stdout": buf.getvalue()}
    # a CUDA mesh over gloo groups is still refused
    dist.init_process_group("gloo", store=dist.FileStore(str(d / "one"), 1),
                            rank=0, world_size=1)
    stub = SimpleNamespace(device_type="cuda",
                           get_all_groups=lambda: [dist.group.WORLD])
    res["gloo_cuda_mesh"] = _raises(lambda: check_mesh(stub, "cuda"))
    dist.destroy_process_group()
    torch.save(res, d / "fake.pt")


def gloo_main(rank: int, world: int, d: Path) -> None:
    from repro_torch.launch.mesh import device_mesh
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(d / "store"), world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=180))
    mesh = device_mesh(make_local_mesh(**DM22), "cpu")
    cfg = mini_cfg()
    opt, comp = train_configs()
    layout = train_layout(cfg, opt, comp, mesh)
    state = init_train_state(cfg, opt, comp, seed=0, device="cpu",
                             mesh=layout)
    batch = to_device(make_batch(cfg, 0, batch=MINI_B, seq=MINI_S, seed=0),
                      "cpu")
    _, jitted = make_train_step(cfg, layout, opt, comp)
    fn = jitted(state, batch)
    trace = dryrun.account_call(torch.device("cpu"),
                                lambda: fn(state, batch), state, batch,
                                1.0 / layout.group.size)
    res = _record(trace, world)
    res["loss_finite"] = bool(np.isfinite(float(trace["outputs"][1]["loss"])))
    dist.barrier()
    torch.save(res, d / f"rank{rank}.pt")
    dist.destroy_process_group()


if __name__ == "__main__":
    torch.set_num_threads(1)
    if sys.argv[1] == "fake":
        fake_main(Path(sys.argv[2]))
    else:
        gloo_main(int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]))
