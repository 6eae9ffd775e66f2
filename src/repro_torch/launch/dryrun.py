"""Multi-pod dry run of the port: what one rank of the production mesh
holds, computes and sends in each (arch x shape x mesh) cell, with no
device memory and no data (the port's counterpart of
``repro.launch.dryrun``).

The reference lowers and compiles each cell's jitted step against
``ShapeDtypeStruct`` stand-ins on 256 or 512 fake host devices and reads
``memory_analysis()``, ``cost_analysis()`` and the collectives of the
post-SPMD HLO.  The port has no HLO, so it runs its real step instead,
on fake tensors:

* :func:`fake_world` starts a process group on PyTorch's ``fake``
  backend (no data moves; every collective returns at once) with the
  mesh's world size, this process as rank 0, and builds the
  ``DeviceMesh`` (16 x 16, or 2 x 16 x 16 multi-pod).  Rank 0 stands for
  every rank: ``spec_for`` only picks an axis that divides a dim evenly,
  so every rank's box of a leaf has the same size.
* :func:`trace_cell` (the counterpart of ``lower_cell``) builds rank 0's
  state under ``FakeTensorMode`` from shapes alone (``fsdp._meta_state``
  cut to the ``StateLayout`` boxes; no ``init_params``) and runs one step
  of ``make_train_step`` (or the prefill / decode step) on it under
  ``hlo_analysis.OpAccount``, which counts the FLOPs, bytes, collectives
  and live memory of every aten op the step runs.  A layout the port
  lacks raises its ``NotImplementedError`` unchanged; a kernel wrapper
  refuses a fake tensor (the dry run does not account a kernel's cost
  yet).
* :func:`analyze` and :func:`run_cell` give the reference's JSON keys.
  ``lower_s`` and ``compile_s`` become one ``trace_s``;
  ``flops_per_device_xla`` and ``bytes_per_device_xla`` (XLA's own
  counts, which miss loop trips) have no counterpart and are left out.

With ``device="cuda"`` (the default, as for every entry point of the
port) the fake tensors take the card's branches and the trace allocates
nothing on the card; ``device="cpu"`` traces the CPU's branches.

Results land in ``build/dryrun/<arch>__<shape>__<mesh>[__int8].json``
under the checkout.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \
        --shape train_4k --mesh single [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--skip-existing]
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from .. import configs
from ..checkpoint.sharded import MeshSpec
from ..compression.tree import flatten_tree, unflatten
from ..configs import ARCH_IDS, SHAPES, shapes_for
from ..distributed.compress import CompressionConfig
from ..distributed.sharding import DEFAULT_RULES, PREFILL_RULES, SERVE_RULES
from ..kernels.registry import resolve_device
from ..optim.adamw import AdamWConfig
from .hlo_analysis import OpAccount
from .mesh import device_mesh, make_production_mesh

RESULTS_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"

# 8-bit Adam moments where the fp32-moment footprint does not fit 16 GB HBM
# at 256 chips (the reference's choice).
Q8_MOMENT_ARCHS = {"deepseek-v3-671b"}


def opt_config(arch: str) -> AdamWConfig:
    return AdamWConfig(quantized_moments=arch in Q8_MOMENT_ARCHS)


# ---------------------------------------------------------------------------
# Input specs (meta tensors: shapes and dtypes, no allocation)
# ---------------------------------------------------------------------------

def _sds(shape, dtype):
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def input_specs(arch: str, shape_name: str) -> dict:
    """Model inputs for one cell, as meta tensors (the reference's
    ``ShapeDtypeStruct`` s: the same keys, shapes and dtypes)."""
    cfg = configs.get(arch)
    seq, batch, kind = SHAPES[shape_name]
    compute = getattr(torch, cfg.compute_dtype)
    out: dict = {}
    if kind == "train":
        if cfg.embed_input:
            out["tokens"] = _sds((batch, seq), torch.int32)
        else:
            out["embeds"] = _sds((batch, seq, cfg.d_model), compute)
        out["labels"] = _sds((batch, seq), torch.int32)
        if cfg.m_rope:
            out["pos3d"] = _sds((3, batch, seq), torch.int32)
    elif kind == "prefill":
        if cfg.embed_input:
            out["tokens"] = _sds((batch, seq), torch.int32)
        else:
            out["embeds"] = _sds((batch, seq, cfg.d_model), compute)
        if cfg.m_rope:
            out["pos3d"] = _sds((3, batch, seq), torch.int32)
    else:  # decode: one new token against a seq_len KV/state cache
        if cfg.embed_input:
            out["tokens"] = _sds((batch,), torch.int32)
        else:
            out["embeds"] = _sds((batch, 1, cfg.d_model), compute)
        if cfg.m_rope:
            out["pos3d"] = _sds((3, batch, 1), torch.int32)
    return out


# ---------------------------------------------------------------------------
# Collective-bytes accounting
# ---------------------------------------------------------------------------

_DTYPE_BYTES = {"pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2,
                "bf16": 2, "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8,
                "f64": 8, "c64": 8, "c128": 16}
_COLL_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
# kinds the reference's HLO never holds (XLA lowers them to the above),
# which a torch.distributed step can issue
_EXTRA_KINDS = ("broadcast", "reduce", "gather", "scatter")


def _wire_bytes(kind: str, result_bytes: int, n: int) -> float:
    """Per-device ICI traffic estimate (ring algorithms).

    all-reduce: 2*S*(n-1)/n of the (operand==result) size S;
    all-gather: result holds the gathered array, each device receives
    S*(n-1)/n; reduce-scatter: operand = result*n, wire = result*(n-1);
    all-to-all: each device exchanges (n-1)/n of its data (result size);
    collective-permute: result size.
    The kinds the reference lacks: broadcast (S the broadcast tensor:
    n-1 of the n devices receive S, pipelined along a ring), reduce (its
    mirror image, S the reduced tensor), gather and scatter (S this
    rank's part) each move S*(n-1)/n per device.
    """
    if n <= 1:
        return 0.0
    f = (n - 1) / n
    if kind == "all-reduce":
        return 2.0 * result_bytes * f
    if kind == "all-gather":
        return result_bytes * f
    if kind == "reduce-scatter":
        return result_bytes * (n - 1)
    if kind == "all-to-all":
        return result_bytes * f
    if kind in _EXTRA_KINDS:
        return result_bytes * f
    return float(result_bytes)     # collective-permute


def collective_bytes(events: list, n_chips: int) -> dict:
    """Per-device collective traffic from the trace's collective events
    (``OpAccount.events``: kind, result bytes by the reference's
    conventions, group size; a collective without a known group spans
    ``n_chips``).  An eager step issues each collective once, so nothing
    is multiplied by a loop trip count.  Records both raw result bytes
    and a ring-algorithm wire estimate per kind."""
    kinds = _COLL_KINDS + _EXTRA_KINDS
    per_kind = {k: 0.0 for k in kinds}
    wire_kind = {k: 0.0 for k in kinds}
    counts = {k: 0 for k in kinds}
    for e in events:
        kind, b = e["kind"], e["bytes"]
        n = e.get("group_size") or n_chips
        per_kind[kind] += b
        wire_kind[kind] += _wire_bytes(kind, b, n)
        counts[kind] += 1
    return {"per_device_bytes": per_kind,
            "wire_bytes": wire_kind,
            "op_counts": counts,
            "total_per_device_bytes": sum(per_kind.values()),
            "total_wire_bytes": sum(wire_kind.values())}


# ---------------------------------------------------------------------------
# The fake world and rank 0's state
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def fake_world(mesh_spec, device="cuda"):
    """A process group on PyTorch's ``fake`` backend with the world size
    of ``mesh_spec`` (a ``MeshSpec`` or axis-size dict) and this process
    as rank 0; yields the mesh's ``DeviceMesh`` on ``device``'s type and
    destroys the group on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    spec = MeshSpec.from_any(mesh_spec)
    dev = resolve_device(device)
    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is already "
                           "initialised in this process")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=spec.size)
    try:
        yield device_mesh(spec, dev)
    finally:
        dist.destroy_process_group()


def fake_state(cfg, opt_cfg, comp_cfg, layout, device) -> dict:
    """``init_train_state``'s state as fake tensors on ``device`` (call
    under ``FakeTensorMode``): every leaf of ``fsdp._meta_state`` at its
    ``StateLayout`` box (``layout``; the whole leaf without one), the
    count a host ``np.int32`` and ``step`` a 0-d int32 tensor."""
    from ..distributed.fsdp import _TREES, _meta_state
    meta = _meta_state(cfg, opt_cfg, comp_cfg)
    trees: dict = {}
    for tree, prefix in _TREES:
        if meta[tree] is None:
            trees[tree] = None
            continue
        trees[tree] = unflatten({
            k: torch.empty(layout.boxes[prefix + k].local_shape
                           if layout is not None else tuple(leaf.shape),
                           dtype=leaf.dtype, device=device)
            for k, leaf in flatten_tree(meta[tree]).items()})
    return {"params": trees["params"],
            "opt": {"count": np.int32(0), "moments": trees["moments"]},
            "ef": trees["ef"],
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def fake_batch(inputs: dict, device) -> dict:
    """The cell's inputs as fake tensors on ``device`` (under
    ``FakeTensorMode``), with the dtypes ``data.pipeline.to_device`` gives
    the model: int64 token ids, labels and positions, f32 embeddings (the
    reference's int32 specs are the host batch's)."""
    return {k: torch.empty(tuple(v.shape), device=device,
                           dtype=(torch.float32 if v.dtype.is_floating_point
                                  else torch.int64))
            for k, v in inputs.items()}


def account_call(device, call, state, batch, share: float) -> dict:
    """Run ``call()`` (one step, on fake or real tensors) under an
    ``OpAccount`` with ``state`` (whole) and ``batch`` (at ``share`` of
    its bytes: this rank's rows) held as the step's arguments.  Returns
    the trace: ``cost``, ``events``, ``op_counts``, ``memory``,
    ``seconds`` and the call's ``outputs``.  ``alias_bytes`` are the
    argument storages among the outputs (the state the step updates in
    place), ``temp_bytes`` the high-water mark of everything else the
    step allocated."""
    acct = OpAccount(device)
    argument = acct.hold(state) + acct.hold(batch, share)
    held = acct.held_ids()
    # storages are freed by reference counts; pausing the cycle collector
    # spares the trace its passes over the many small objects it makes
    gc.collect()
    gc.disable()
    t0 = time.perf_counter()
    try:
        with acct:
            outputs = call()
    finally:
        seconds = time.perf_counter() - t0
        gc.enable()
    sizes = acct.storage_bytes(outputs)
    output = sum(sizes.values())
    alias = sum(n for k, n in sizes.items() if k in held)
    peak = acct.peak
    temp = peak - argument - (output - alias)
    return {"cost": acct.cost(), "events": acct.events,
            "op_counts": dict(acct.op_counts), "seconds": seconds,
            "peak_by_op": acct.peak_by_op(),
            "outputs": outputs,
            "memory": {"argument_bytes": argument, "output_bytes": output,
                       "temp_bytes": temp, "alias_bytes": alias,
                       "peak_bytes": peak,
                       "live_bytes_est": argument + output + temp - alias}}


def trace_train(cfg, opt_cfg, comp_cfg, inputs: dict, mesh=None, rules=None,
                device="cuda") -> dict:
    """One ``make_train_step`` step of ``cfg`` on rank 0 of ``mesh`` (a
    ``DeviceMesh``, or None for the mesh-free step) under ``rules``
    (default ``DEFAULT_RULES``), traced on fake tensors from the shapes
    of ``inputs`` (the global batch; the step runs rank 0's rows).  The
    state is updated in place, the counterpart of
    ``donate_argnums=(0,)``: its bytes are the trace's ``alias_bytes``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ..train.steps import make_train_step, train_layout
    dev = resolve_device(device)
    layout = train_layout(cfg, opt_cfg, comp_cfg, mesh, rules)
    with FakeTensorMode():
        state = fake_state(cfg, opt_cfg, comp_cfg, layout, dev)
        batch = fake_batch(inputs, dev)
        _, jitted = make_train_step(
            cfg, layout if layout is not None else mesh, opt_cfg, comp_cfg)
        fn = jitted(state, batch)
        share = 1.0 / (layout.group.size if layout is not None else 1)
        return account_call(dev, lambda: fn(state, batch), state, batch, share)


def _fake_params(cfg, device, int8_serving: bool) -> dict:
    from ..models.transformer import param_specs
    params = unflatten({k: torch.empty(s, dtype=dt, device=device)
                        for k, (s, dt) in param_specs(cfg).items()})
    if int8_serving:
        from ..serve.quantized import quantize_params_for_serving
        params = quantize_params_for_serving(params)
    return params


def trace_cell(arch: str, shape_name: str, mesh, cfg_overrides=None,
               int8_serving: bool = False, device="cuda") -> dict:
    """The counterpart of the reference's ``lower_cell``: the cell's step
    traced on rank 0 of ``mesh`` (a ``DeviceMesh``, e.g. from
    :func:`fake_world`; None for one device) on fake tensors.  Train
    cells run ``make_train_step`` with ``opt_config(arch)`` and
    ``CompressionConfig(enabled=False)``; prefill and decode cells
    ``make_prefill_step`` / ``make_decode_step`` under the reference's
    rules for the kind.  A layout the port lacks raises its
    ``NotImplementedError``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ..models.transformer import init_cache
    from ..train.steps import make_decode_step, make_prefill_step
    cfg = configs.get(arch)
    if cfg_overrides:
        cfg = cfg.replace(**cfg_overrides)
    seq, batch, kind = SHAPES[shape_name]
    if kind == "train":
        rules = DEFAULT_RULES
    elif kind == "prefill":
        rules = PREFILL_RULES
        if arch == "deepseek-v3-671b":
            # the reference's expert-bank rule for this model's prefill
            rules = {**PREFILL_RULES, "fsdp": "data"}
    else:
        rules = SERVE_RULES
    inputs = input_specs(arch, shape_name)
    if kind == "train":
        return trace_train(cfg, opt_config(arch),
                           CompressionConfig(enabled=False), inputs, mesh,
                           rules, device)
    dev = resolve_device(device)
    if int8_serving:
        cfg = cfg.replace(q8_cache=True)
    if kind == "prefill":
        step_fn = make_prefill_step(cfg, mesh, rules, max_len=seq)
    else:
        step_fn = make_decode_step(cfg, mesh, rules)
    with FakeTensorMode():
        params = _fake_params(cfg, dev, int8_serving)
        fb = fake_batch(inputs, dev)
        if kind == "prefill":
            return account_call(dev, lambda: step_fn(params, fb), params, fb,
                            1.0)
        caches = init_cache(cfg, batch, seq, device=dev)
        return account_call(dev, lambda: step_fn(params, caches, fb, seq - 1),
                        {"params": params, "caches": caches}, fb, 1.0)


def analyze(trace: dict, n_chips: int) -> dict:
    """The reference's per-cell record from a trace (:func:`trace_cell`)."""
    cost = trace["cost"]
    return {
        "flops_per_device": cost["flops"],
        "bytes_per_device": cost["bytes"],
        "bytes_per_device_bf16": cost["bytes_bf16"],
        "per_comp": cost["per_comp"],
        "collectives": collective_bytes(trace["events"], n_chips),
        "memory": dict(trace["memory"]),
        "peak_by_op": trace["peak_by_op"],
        "n_chips": n_chips,
    }


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             cfg_overrides=None, int8_serving: bool = False, *,
             device="cuda", mesh=None) -> dict:
    """One cell on the production mesh of ``mesh_kind`` (16 x 16, or
    2 x 16 x 16 for ``"multi"``): ``mesh``, that mesh's ``DeviceMesh`` in
    a :func:`fake_world` already open, or a fake world of its own."""
    spec = make_production_mesh(multi_pod=mesh_kind == "multi")
    if mesh is None:
        with fake_world(spec, device) as m:
            return run_cell(arch, shape_name, mesh_kind, cfg_overrides,
                            int8_serving, device=device, mesh=m)
    t0 = time.perf_counter()
    trace = trace_cell(arch, shape_name, mesh, cfg_overrides, int8_serving,
                       device)
    res = analyze(trace, spec.size)
    res.update({"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "trace_s": round(time.perf_counter() - t0, 2),
                "step_trace_s": round(trace["seconds"], 2),
                "op_counts": trace["op_counts"]})
    return res


def cell_path(arch, shape, mesh_kind, suffix=""):
    os.makedirs(RESULTS_DIR, exist_ok=True)
    return os.path.join(RESULTS_DIR,
                        f"{arch}__{shape}__{mesh_kind}{suffix}.json")


def summary(res: dict) -> str:
    """One line of a cell's per-rank numbers."""
    c, m = res["collectives"], res["memory"]
    kinds = ", ".join(f"{k} {n} ops {c['per_device_bytes'][k] / 1e9:.3f} GB"
                      for k, n in c["op_counts"].items() if n)
    return (f"flops/dev={res['flops_per_device']:.6e} "
            f"bytes/dev={res['bytes_per_device']:.6e} "
            f"coll={c['total_per_device_bytes'] / 1e9:.3f} GB/dev "
            f"(wire {c['total_wire_bytes'] / 1e9:.3f} GB: {kinds or 'none'}) "
            f"argument={m['argument_bytes'] / 2**30:.3f} GiB "
            f"peak={m['peak_bytes'] / 2**30:.3f} GiB (" + ", ".join(
                f"{k} {v / 2**30:.1f}" for k, v in
                list(res["peak_by_op"].items())[:4]) + ") "
            f"trace={res['trace_s']}s")


def _cells(args) -> list:
    if not args.all:
        if not (args.arch and args.shape):
            raise SystemExit("give --arch and --shape, or --all")
        return [(args.arch, args.shape, args.mesh, args.int8)]
    cells = []
    for arch in ARCH_IDS:
        for shape in shapes_for(arch):
            for mesh_kind in ("single", "multi"):
                cells.append((arch, shape, mesh_kind, False))
            # int8 fixed-point serving variant for the serve shapes
            if SHAPES[shape][2] == "decode":
                cells.append((arch, shape, "single", True))
    return cells


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--int8", action="store_true",
                    help="fixed-point serving (int8 weights + KV cache)")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="the branches the fake tensors take (cuda: the "
                         "card's; nothing is allocated there)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cells = _cells(args)

    failures = []
    for mesh_kind in ("single", "multi"):
        todo = []
        for arch, shape, mk, int8 in cells:
            suffix = "__int8" if int8 else ""
            if mk != mesh_kind:
                continue
            path = cell_path(arch, shape, mk, suffix)
            if args.skip_existing and os.path.exists(path):
                print(f"[skip] {arch} {shape} {mk}{suffix}")
                continue
            todo.append((arch, shape, int8, suffix, path))
        if not todo:
            continue
        spec = make_production_mesh(multi_pod=mesh_kind == "multi")
        t0 = time.perf_counter()
        with fake_world(spec, dev) as mesh:
            world_s = round(time.perf_counter() - t0, 2)
            print(f"[world] fake {spec.shape}: {world_s} s", flush=True)
            for arch, shape, int8, suffix, path in todo:
                print(f"=== {arch} | {shape} | {mesh_kind}{suffix} ===",
                      flush=True)
                try:
                    res = run_cell(arch, shape, mesh_kind, int8_serving=int8,
                                   device=dev, mesh=mesh)
                    res["int8_serving"] = int8
                    res["world_s"] = world_s
                    if dev.type == "cuda":
                        res["device_allocated_bytes"] = \
                            torch.cuda.memory_allocated()
                        if res["device_allocated_bytes"]:
                            raise RuntimeError(
                                f"the trace left "
                                f"{res['device_allocated_bytes']} bytes "
                                "allocated on the card")
                    with open(path, "w") as f:
                        json.dump(res, f, indent=1)
                    print(f"[ok] {summary(res)}", flush=True)
                except NotImplementedError as e:
                    failures.append((arch, shape, mesh_kind, repr(e)))
                    print(f"[not yet ported] {e}", flush=True)
                except Exception as e:  # noqa: BLE001 — record and go on
                    failures.append((arch, shape, mesh_kind, repr(e)))
                    traceback.print_exc()
    if failures:
        print("FAILURES:")
        for f in failures:
            print(" ", f)
        raise SystemExit(1)
    print("all cells accounted OK")


if __name__ == "__main__":
    main()
