"""One rank of the gloo worlds that ``tests/test_torch_distributed.py``
(four CPU processes) and ``tests/test_torch_sharded_train.py`` (``sharded``:
worlds of two and four) spawn, one intra-op thread each, rendezvous
through a ``FileStore``.  Every rank runs every check in the same order
and writes what it saw to ``rank<r>.pt`` in the world's directory; the
test files' cases assert on those results against the JAX package and
the port's single-process math.  Imports nothing of JAX.

    python tests/_torch_dist_worker.py <rank> <world size> <directory> \
        [sharded]
"""

from __future__ import annotations

import datetime
import os
import signal
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard, \
    distribute_tensor

from repro_torch import configs
from repro_torch.arrays import to_storage
from repro_torch.checkpoint import sharded
from repro_torch.checkpoint.delta import restore_on_mesh_delta
from repro_torch.checkpoint.manager import (CheckpointConfig,
                                            CheckpointManager)
from repro_torch.compression.tree import flatten_tree
from repro_torch.data.pipeline import make_batch
from repro_torch.distributed import sharding
from repro_torch.distributed.compress import (CompressionConfig,
                                              cross_pod_psum_compressed)
from repro_torch.distributed.fsdp import StateLayout, shard_state
from repro_torch.distributed.pipeline_stage import gpipe_apply
from repro_torch.launch.mesh import device_mesh, make_local_mesh
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.serve.backends import get_backend
from repro_torch.serve.session import ServeConfig, ServeSession
from repro_torch.train import loop as loop_mod
from repro_torch.train.steps import (init_train_state, make_decode_step,
                                     make_prefill_step, make_train_step)

ARCHS = ("llama3-8b", "deepseek-moe-16b")
B, S = 4, 16                  # the data-parallel steps' global batch
TOTAL, WARMUP, LR = 12, 2, 1e-2
DP_STEPS = 2
REPLICATED = {**sharding.DEFAULT_RULES, "fsdp": None}
# the sharded train steps: (mesh shape, arch, moments) of each world size;
# "f32" is f32 moments without EF, "q8" 8-bit moments with EF
SHARDED_MESHES = {2: ((2, 1), (1, 2)), 4: ((2, 2), (1, 4))}
SHARDED_RUNS = (("llama3-8b", "f32"), ("llama3-8b", "q8"),
                ("qwen1.5-4b", "f32"), ("qwen1.5-4b", "q8"))
# on (data 2, model 1) only
MOE_RUNS = (("deepseek-moe-16b", "f32"), ("deepseek-moe-16b", "q8"))
# on (data 1, model > 1) only: q_norm / k_norm read on a rank's heads
QK_NORM_RUNS = (("qwen3-8b", "f32"), ("qwen3-8b", "q8"))
NO_TP_ARCHS = ("deepseek-moe-16b", "deepseek-v3-671b", "mamba2-2.7b",
               "zamba2-2.7b")


def _np(t):
    return to_storage(t)


def _state_np(state) -> dict:
    return {k: (_np(v) if isinstance(v, torch.Tensor) else int(v))
            for k, v in flatten_tree(state).items()}


def _raises(fn) -> str | None:
    """``"Type: message"`` of what ``fn()`` raises, None if it returns."""
    try:
        fn()
    except Exception as e:     # the case asserts on type and message
        return f"{type(e).__name__}: {e}"
    return None


def _train(cfg, mesh, opt, comp, rules=None, steps=DP_STEPS, total=TOTAL,
           warmup=WARMUP):
    """``steps`` steps of ``make_train_step`` on ``mesh`` from the state
    ``init_train_state(..., mesh=)`` builds: (state, losses)."""
    state = init_train_state(cfg, opt, comp, seed=0, device="cpu",
                             mesh=mesh, rules=rules)
    _, make = make_train_step(cfg, mesh, opt, comp, rules=rules,
                              total_steps=total, warmup=warmup)
    fn = make(state, None)
    losses = []
    for i in range(steps):
        state, m = fn(state, make_batch(cfg, i, batch=B, seq=S, seed=0))
        losses.append(float(m["loss"]))
    return state, losses


def dp_train(mesh, arch, quant, ef, rules=None) -> dict:
    """The data-parallel cases: under the default rules the state is
    sharded (FSDP over data) and gathered whole on every rank before it
    is compared; under ``REPLICATED`` it is whole on every rank."""
    cfg = configs.get(arch, smoke=True)
    opt = AdamWConfig(lr=LR, quantized_moments=quant)
    comp = CompressionConfig(enabled=ef)
    state, losses = _train(cfg, mesh, opt, comp, rules)
    if rules is None:
        state = StateLayout(cfg, opt, comp, mesh).gather_state(state, True)
    return {"losses": losses, "state": _state_np(state)}


def placements(meshes, names, rules_sets) -> dict:
    out = {}
    for mkey, mesh in meshes.items():
        spec_mesh = sharded.MeshSpec.from_any(mesh)
        flat = sharding.mesh_flat_index(mesh)
        for rkey, rules in rules_sets.items():
            rows = []
            for name, shape in names:
                spec = sharding.spec_for(
                    shape, sharding.logical_axes_for_path(name, len(shape)),
                    spec_mesh, rules)
                full = torch.arange(float(torch.Size(shape).numel())) \
                    .reshape(shape)
                d = distribute_tensor(full, mesh,
                                      sharding.placements_for(spec, mesh))
                starts, stops = sharded.device_box(
                    shape, sharded._spec_axes(spec, len(shape)), spec_mesh,
                    flat)
                want = full[tuple(slice(a, b) for a, b in zip(starts,
                                                              stops))]
                rows.append((name, spec, bool(torch.equal(d.to_local(),
                                                          want))))
            out[(mkey, rkey)] = rows
    return out


def gpipe(mesh, axis, inp, key) -> dict:
    sends = []
    real = dist.batch_isend_irecv

    def counted(ops):
        sends.append(sum(op.op is dist.isend for op in ops))
        return real(ops)

    def stage_fn(p, x):
        return x + torch.tanh(x @ p["w1"]) @ p["w2"]

    dist.batch_isend_irecv = counted
    try:
        y = gpipe_apply(stage_fn, inp[f"gpipe_params_{key}"],
                        inp["gpipe_x"], mesh, axis=axis)
    finally:
        dist.batch_isend_irecv = real
    return {"y": y, "sends": sum(sends), "calls": len(sends),
            "sid": mesh.get_local_rank(axis)}


def psum(mesh, inp) -> dict:
    out = {}
    for key in ("block", "flat"):
        x = inp[f"psum_{key}_{mesh.size(0)}"]
        place = [Shard(0)] + [Replicate()] * (mesh.ndim - 1)
        stats: dict = {}
        y = cross_pod_psum_compressed(distribute_tensor(x, mesh, place),
                                      mesh, stats=stats)
        out[key] = {"full": y.full_tensor(), "local": y.to_local(),
                    "placements": [str(p) for p in y.placements],
                    "stats": stats}
    return out


def psum_rejects(mesh22, inp) -> dict:
    x2 = inp["psum_block_2"]
    x4 = inp["psum_block_4"]
    return {
        "leading": _raises(lambda: cross_pod_psum_compressed(
            distribute_tensor(x4, mesh22, [Shard(0), Replicate()]),
            mesh22)),
        "replicated": _raises(lambda: cross_pod_psum_compressed(
            distribute_tensor(x2, mesh22, [Replicate(), Replicate()]),
            mesh22)),
        "plain": _raises(lambda: cross_pod_psum_compressed(x2, mesh22)),
        "no_pod_axis": _raises(lambda: cross_pod_psum_compressed(
            x2, None)),
    }


def prefill_decode(mesh) -> dict:
    cfg = configs.get("llama3-8b", smoke=True)
    params = init_train_state(cfg, AdamWConfig(), seed=0,
                              device="cpu")["params"]
    toks = inp_tokens(cfg)
    pre = make_prefill_step(cfg, mesh, max_len=toks.shape[1] + 3)
    dec = make_decode_step(cfg, mesh)
    logits, caches = pre(params, {"tokens": toks})
    out = {"logits": [logits], "cache_rows": int(caches["k"].shape[1])}
    nxt = logits.argmax(-1)
    for i in range(2):
        pos = torch.full((B,), toks.shape[1] + i, dtype=torch.int32)
        logits, caches = dec(params, caches, {"tokens": nxt}, pos)
        out["logits"].append(logits)
        nxt = logits.argmax(-1)
    return out


def inp_tokens(cfg):
    g = torch.Generator().manual_seed(5)
    return torch.randint(0, cfg.vocab_size, (B, 8), generator=g)


def loops(d: Path, data2, pod: int, rank: int) -> dict:
    cfg = configs.get("llama3-8b", smoke=True)
    opt = AdamWConfig(lr=LR)
    comp = CompressionConfig(enabled=True)
    if pod == 0:
        # a world of 2 saves sharded raw steps 2 and 4; a second run
        # resumes on both ranks to 6
        ck = CheckpointConfig(str(d / "ckpt_w2"), params_mode="raw",
                              sharded=True, keep=10)
        res = loop_mod.train_loop(
            cfg, data2, loop_mod.LoopConfig(total_steps=4, batch=B, seq=S,
                                            ckpt_every=2),
            opt, comp, ck, device="cpu")
        more = loop_mod.train_loop(
            cfg, data2, loop_mod.LoopConfig(total_steps=6, batch=B, seq=S,
                                            ckpt_every=2),
            opt, comp, ck, device="cpu")
        return {"losses": res.losses, "final": res.final_step,
                "more_losses": more.losses, "more_final": more.final_step,
                "steps": CheckpointManager(ck).steps()}
    # SIGTERM on the data axis's second rank while step 2 runs
    ck = CheckpointConfig(str(d / "ckpt_sigterm"), params_mode="raw",
                          keep=10)
    real = loop_mod.make_batch

    def hooked(cfg_, step, **kw):
        if step == 1 and data2.get_local_rank("data") == 1:
            os.kill(os.getpid(), signal.SIGTERM)
        return real(cfg_, step, **kw)
    loop_mod.make_batch = hooked
    try:
        res = loop_mod.train_loop(
            cfg, data2, loop_mod.LoopConfig(total_steps=6, batch=B, seq=S,
                                            ckpt_every=100),
            opt, comp, ck, device="cpu")
    finally:
        loop_mod.make_batch = real
    return {"losses": res.losses, "final": res.final_step,
            "steps": CheckpointManager(ck).steps()}


def restores(d: Path, mesh, rank: int) -> dict:
    key, root = d / "ref_ckpt" / "step_00000001", d / "ref_ckpt"
    deadline = time.monotonic() + 300
    while not (d / "ref_ready").exists():   # the test writes them meanwhile
        if time.monotonic() > deadline:
            raise TimeoutError("the reference's steps were not written")
        time.sleep(0.05)
    cfg = configs.get("llama3-8b", smoke=True)
    out = {}
    stats = sharded.RestoreStats()
    placed = sharded.restore_on_mesh(str(key), mesh, stats=stats)
    out["keyframe_local"] = {k: _np(v.to_local()) for k, v in placed.items()}
    out["keyframe_full"] = {k: _np(v.full_tensor())
                            for k, v in placed.items()}
    out["keyframe_types"] = sorted({type(v).__name__
                                    for v in placed.values()})
    out["keyframe_decoded"] = stats.decoded_values
    delta = restore_on_mesh_delta(str(root), 2, mesh)
    out["delta_local"] = {k: _np(v.to_local()) for k, v in delta.items()}
    out["delta_full"] = {k: _np(v.full_tensor()) for k, v in delta.items()}
    template = {"params": init_train_state(cfg, AdamWConfig(), seed=1,
                                           device="cpu")["params"],
                "opt": {"count": torch.zeros((), dtype=torch.int32)}}
    mgr = CheckpointManager(CheckpointConfig(str(root)))
    for step in (1, 2):
        st, meta = mgr.restore(template, step=step, device="cpu", mesh=mesh)
        out[f"manager_{step}"] = {
            "params": {k: _np(v.full_tensor()) for k, v in
                       flatten_tree(st["params"]).items()},
            "types": sorted({type(v).__name__ for v in
                             flatten_tree(st["params"]).values()}),
            "count": int(st["opt"]["count"])}
    out["monolithic"] = _raises(lambda: CheckpointManager(CheckpointConfig(
        str(d / "ref_mono"))).restore(template, device="cpu", mesh=mesh))
    # the serving backends on the mesh
    tree = get_backend("bf16", mesh=mesh).load(cfg, str(key), device="cpu")
    out["bf16"] = {k: _np(v.full_tensor() if isinstance(v, DTensor) else v)
                   for k, v in flatten_tree(tree).items()}
    out["bf16_types"] = sorted({type(v).__name__
                                for v in flatten_tree(tree).values()})
    q8 = get_backend("q8", mesh=mesh).load(cfg, str(key), device="cpu")
    out["q8"] = {k: _np(v) for k, v in flatten_tree(q8).items()}
    plain = get_backend("q8").load(cfg, str(key), device="cpu")
    out["q8_plain"] = {k: _np(v) for k, v in flatten_tree(plain).items()}
    out["tracking"] = _raises(lambda: get_backend(
        "bf16", mesh=mesh, track_levels=True).load(cfg, str(key),
                                                   device="cpu"))
    out["session_sharded"] = _raises(lambda: ServeSession(
        cfg, str(key), backend=get_backend("bf16", mesh=mesh),
        device="cpu"))
    return out


def session_on_one(d: Path, mesh1) -> dict:
    cfg = configs.get("llama3-8b", smoke=True)
    key = d / "ref_ckpt" / "step_00000001"
    sess = ServeSession(cfg, str(key), backend=get_backend("bf16",
                                                           mesh=mesh1),
                        serve_cfg=ServeConfig(slots=2, max_len=24),
                        device="cpu")
    prompts = [list(range(3, 11)), list(range(40, 46))]
    hs = [sess.submit(p, max_new_tokens=6) for p in prompts]
    sess.run()
    return {"tokens": [h.tokens for h in hs],
            "leaf_types": sorted({type(v).__name__ for v in
                                  flatten_tree(sess.params).values()})}


# ---------------------------------------------------------------------------
# the sharded train state (tests/test_torch_sharded_train.py)
# ---------------------------------------------------------------------------

def _configs(mode):
    quant = mode == "q8"
    return (AdamWConfig(lr=LR, quantized_moments=quant),
            CompressionConfig(enabled=quant))


def sharded_run(mesh, arch, mode, first: bool) -> dict:
    """DP_STEPS steps on ``mesh`` under the default rules: the losses,
    this rank's boxes, the whole state gathered (kept by the first rank),
    each leaf's box and each parameter's gather plan and q8 codec."""
    cfg = configs.get(arch, smoke=True)
    opt, comp = _configs(mode)
    state, losses = _train(cfg, mesh, opt, comp)
    layout = StateLayout(cfg, opt, comp, mesh)
    whole = layout.gather_state(state, keep=first)
    local = _state_np(state)
    return {
        "losses": losses, "local": local,
        "whole": _state_np(whole) if first else None,
        "boxes": {k: (b.spec, b.starts, b.stops)
                  for k, b in layout.boxes.items()},
        "plans": {k: (p.gathered, p.summed, p.narrow)
                  for k, p in layout.plans.items()},
        "codecs": {k: layout.codec(k).kind for k in layout.plans},
        "resident": sum(v.nbytes for v in local.values()
                        if isinstance(v, np.ndarray)),
    }


def box_q8(mesh, inp) -> dict:
    """Each case's whole tensor cut to this rank's box of its leaf and
    encoded and decoded by the layout's codec (8-bit moments of the
    llama3-8b smoke model)."""
    cfg = configs.get("llama3-8b", smoke=True)
    opt, comp = _configs("q8")
    layout = StateLayout(cfg, opt, comp, mesh)
    out = {}
    for name, x in inp["box_q8"].items():
        q8 = layout.codec(name)
        box = layout.boxes["params/" + name]
        codes, scale = q8.encode(box.cut(x).contiguous())
        out[name] = {"kind": q8.kind, "codes": codes.numpy(),
                     "scale": scale.numpy(),
                     "decoded": q8.decode(codes, scale).numpy(),
                     "sqrt_codes": q8.encode_sqrt(
                         box.cut(x).abs().contiguous())[0].numpy()}
    return out


def _full(layout, state, mesh) -> dict:
    """The whole state by DTensor's own gather of each box (placed by
    ``placements_for`` of its spec), on every rank."""
    def walk(tree, prefix):
        out = {}
        for k, v in tree.items():
            name = prefix + k
            if isinstance(v, dict):
                out[k] = walk(v, name + "/")
            elif isinstance(v, torch.Tensor):
                b = layout.boxes[name]
                out[k] = DTensor.from_local(
                    v, mesh, sharding.placements_for(b.spec, mesh),
                    run_check=False, shape=torch.Size(b.shape),
                    stride=torch.empty(b.shape, device="meta").stride()
                ).full_tensor()
            else:
                out[k] = v
        return out
    return walk(state, "")


def ckpt_round_trip(d: Path, mesh, rank: int) -> dict:
    """On (data 2, model 2), 8-bit moments and EF: ``train_loop`` saves raw
    sharded steps 2 and 4 and, in another directory, a CABAC sharded step
    2; the same two steps by ``make_train_step`` gathered by DTensor (the
    first rank writes them for the single-process saves); a restore of
    step 2 onto the mesh; ``train_loop`` resumed on the mesh from a copy
    of step 2."""
    import shutil
    cfg = configs.get("llama3-8b", smoke=True)
    opt, comp = _configs("q8")
    loop = loop_mod.LoopConfig(total_steps=4, batch=B, seq=S, ckpt_every=2)
    raw = CheckpointConfig(str(d / "sh_raw"), params_mode="raw",
                           sharded=True, keep=10)
    a = loop_mod.train_loop(cfg, mesh, loop, opt, comp, raw, device="cpu")
    cabac = CheckpointConfig(str(d / "sh_cabac"), sharded=True, keep=10)
    loop_mod.train_loop(cfg, mesh, loop_mod.LoopConfig(
        total_steps=2, batch=B, seq=S, ckpt_every=2), opt, comp, cabac,
        device="cpu")
    state, losses = _train(cfg, mesh, opt, comp, total=4, warmup=100)
    layout = StateLayout(cfg, opt, comp, mesh)
    full = _full(layout, state, mesh)
    if rank == 0:
        torch.save(full, d / "sh_state2.pt")
        shutil.copytree(d / "sh_raw" / "step_00000002",
                        d / "sh_resume" / "step_00000002")
    dist.barrier()
    template = init_train_state(cfg, opt, comp, seed=7, device="cpu",
                                mesh=mesh)
    restored, meta = CheckpointManager(raw).restore(
        template, step=2, device="cpu", mesh=layout)
    resumed = loop_mod.train_loop(
        cfg, mesh, loop, opt, comp,
        CheckpointConfig(str(d / "sh_resume"), params_mode="raw",
                         sharded=True, keep=10), device="cpu")
    return {"losses": a.losses, "final": a.final_step,
            "steps": CheckpointManager(raw).steps(),
            "step_losses": losses, "local": _state_np(state),
            "restored": _state_np(restored), "meta_step": meta["step"],
            "resumed": resumed.losses, "resumed_final": resumed.final_step}


def sharded_main(rank: int, world: int, d: Path, inp: dict) -> dict:
    res: dict = {"rank": rank}
    meshes = {shape: device_mesh(make_local_mesh(*shape), "cpu")
              for shape in SHARDED_MESHES[world]}
    res["flat_index"] = {shape: sharding.mesh_flat_index(m)
                         for shape, m in meshes.items()}
    runs = {}
    for shape, mesh in meshes.items():
        extra = MOE_RUNS if shape[1] == 1 else \
            QK_NORM_RUNS if shape[0] == 1 else ()
        for arch, mode in SHARDED_RUNS + extra:
            runs[(shape, arch, mode)] = sharded_run(mesh, arch, mode,
                                                    rank == 0)
    res["runs"] = runs
    opt, comp = _configs("q8")
    res["init_is_shard_state"] = {}
    for shape, mesh in meshes.items():
        for arch in ("llama3-8b", "qwen1.5-4b"):
            cfg = configs.get(arch, smoke=True)
            boxes = _state_np(init_train_state(cfg, opt, comp, seed=3,
                                               device="cpu", mesh=mesh))
            cut = _state_np(shard_state(init_train_state(
                cfg, opt, comp, seed=3, device="cpu"), mesh))
            res["init_is_shard_state"][(shape, arch)] = \
                sorted(boxes) == sorted(cut) and all(
                    np.array_equal(boxes[k], cut[k]) for k in boxes)
    tp = meshes[SHARDED_MESHES[world][1]]
    res["box_q8"] = box_q8(tp, inp)
    if world == 2:
        res["refusals"] = {arch: [
            _raises(lambda: init_train_state(configs.get(arch, smoke=True),
                                             opt, comp, device="cpu",
                                             mesh=tp)),
            _raises(lambda: make_train_step(configs.get(arch, smoke=True),
                                            tp, opt, comp))]
            for arch in NO_TP_ARCHS}
        res["refusals"]["steps"] = [
            _raises(lambda: make(configs.get("llama3-8b", smoke=True), tp))
            for make in (make_prefill_step, make_decode_step)]
    else:
        res["ckpt"] = ckpt_round_trip(d, meshes[(2, 2)], rank)
    return res


def main(rank: int, world: int, d: Path) -> None:
    import importlib
    for m in ("repro_torch.launch.train", "repro_torch.serve.quantized"):
        importlib.import_module(m)      # the new modules, for the JAX check
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(d / "store"), world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=180))
    inp = torch.load(d / "inputs.pt", weights_only=False)
    if sys.argv[4:] == ["sharded"]:
        res = sharded_main(rank, world, d, inp)
        res["jax_modules"] = sorted(
            m for m in sys.modules if m in ("jax", "repro") or
            m.startswith(("jax.", "jaxlib", "repro.")))
        dist.barrier()
        torch.save(res, d / f"rank{rank}.pt")
        dist.destroy_process_group()
        return
    res = {"rank": rank}
    m4 = init_device_mesh("cpu", (4,), mesh_dim_names=("data",))
    m22 = init_device_mesh("cpu", (2, 2), mesh_dim_names=("pod", "data"))
    m22tp = device_mesh(make_local_mesh(data=2, model=2), "cpu")
    m221 = init_device_mesh("cpu", (2, 2, 1),
                            mesh_dim_names=("pod", "data", "model"))
    mpod4 = init_device_mesh("cpu", (4,), mesh_dim_names=("pod",))
    m41 = init_device_mesh("cpu", (4, 1), mesh_dim_names=("pod", "data"))
    data2, one = m22["data"], m41["data"]
    res["flat_index"] = {"m22tp": sharding.mesh_flat_index(m22tp),
                         "m22": sharding.mesh_flat_index(m22)}
    res["meshspec"] = sharded.MeshSpec.from_any(m22tp).shape

    res["placements"] = placements(
        {"data4": m4, "pod2data2": m22, "data2model2": m22tp},
        inp["placement_names"],
        {"default": sharding.DEFAULT_RULES, "serve": sharding.SERVE_RULES})
    res["batch_spec"] = sharding.placements_for(
        sharding.spec_for((8, 16), ("batch", "seq"),
                          sharded.MeshSpec.from_any(m22)), m22)
    res["batch_spec"] = [str(p) for p in res["batch_spec"]]

    res["gpipe"] = {4: gpipe(mpod4, "pod", inp, 4),
                    2: gpipe(m22, "pod", inp, 2)}
    res["psum"] = {2: psum(m22, inp), 4: psum(mpod4, inp)}
    res["psum_rejects"] = psum_rejects(m22, inp)

    res["errors"] = {
        "world_size": _raises(lambda: device_mesh(
            make_local_mesh(data=2), "cpu")),
        "model_axis": [_raises(lambda: make(m22tp)) for make in (
            lambda m: make_train_step(configs.get("deepseek-moe-16b",
                                                  smoke=True),
                                      m, AdamWConfig()),
            lambda m: make_prefill_step(configs.get("llama3-8b",
                                                    smoke=True), m),
            lambda m: make_decode_step(configs.get("llama3-8b",
                                                   smoke=True), m))],
        "device": _raises(lambda: sharding.check_mesh(m4, "meta")),
    }

    pod = m22.get_local_rank("pod")
    dp = {}
    for ef in (False, True):
        for arch in ARCHS:
            # FSDP over data with pod replicas, gathered
            dp[(4, arch, ef)] = dp_train(m221, arch, False, ef)
        # a world of 2: each pod trains one model on its data axis, the
        # state replicated ("fsdp": None)
        dp[(2, ARCHS[pod], ef)] = dp_train(data2, ARCHS[pod], False, ef,
                                           REPLICATED)
    dp[(2, ARCHS[pod], "q8")] = dp_train(data2, ARCHS[pod], True, True,
                                         REPLICATED)
    res["dp"] = dp
    res["prefill_decode"] = prefill_decode(
        device_mesh(make_local_mesh(data=4), "cpu"))
    res["loops"] = loops(d, data2, pod, rank)
    res["restores"] = restores(d, m22tp, rank)
    res["session_one"] = session_on_one(d, one) if rank == 0 else None
    res["jax_modules"] = sorted(
        m for m in sys.modules if m in ("jax", "repro") or
        m.startswith(("jax.", "jaxlib", "repro.")))
    dist.barrier()
    torch.save(res, d / f"rank{rank}.pt")
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]))
