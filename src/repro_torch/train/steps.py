"""Step factories: train_step / prefill / decode (the port's copy of
``repro.train.steps``).

The reference resolves parameter, optimizer, cache and batch shardings
from the logical rule tables and jits each step.  The port's spec
functions return the same per-dim mesh axes (tuples, as
``distributed.sharding`` gives them) for a checkpoint manifest or a
placement.  A step runs on one device (``mesh`` None, or a device-free
mesh of one device) or on a ``torch.distributed`` ``DeviceMesh``: each
rank runs its rows of the global batch over the batch axes (``pod``,
``data``: ``distributed.data_parallel.BatchGroup``).  On a mesh the
train step's state is sharded by ``state_specs``: each rank holds its
box of every leaf (``distributed.fsdp``: FSDP over ``data``, and for
the dense GQA family tensor parallelism over ``model``,
``distributed.tensor_parallel``); with ``"fsdp": None`` and a ``model``
axis of 1 every box is the whole leaf, the replicated data-parallel
step.  Another family on a ``model`` axis above 1, and the prefill and
decode steps on one, raise ``NotImplementedError``.
The train step updates its state in place (parameters, AdamW moments,
the error-feedback accumulators), the port's counterpart of the
reference's ``donate_argnums=(0,)``.

Under autograd attention takes the scan (the flash kernel has no
backward, nor has the reference's Pallas kernel); the prefill step runs
under ``torch.no_grad``, so its attention launches ``flash_attention``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..checkpoint.sharded import MeshSpec
from ..compression.tree import flatten_tree, unflatten
from ..data.pipeline import to_device
from ..distributed.compress import (CompressionConfig, ef_compress_update,
                                    init_error_feedback)
from ..distributed.data_parallel import BatchGroup
from ..distributed.fsdp import StateLayout
from ..distributed.sharding import (DEFAULT_RULES, PREFILL_RULES,
                                    SERVE_RULES, build_param_specs,
                                    check_mesh, spec_axes, spec_for)
from ..distributed.tensor_parallel import check_supported
from ..kernels.registry import resolve_device
from ..models.config import ModelConfig
from ..models.transformer import forward, init_cache, init_params, train_loss
from ..optim.adamw import AdamWConfig, adamw_init, adamw_update
from ..optim.schedule import linear_warmup_cosine

TrainState = dict  # {"params", "opt", "ef", "step"}


# ---------------------------------------------------------------------------
# Sharding resolution (device-free)
# ---------------------------------------------------------------------------

def _shape(x) -> tuple:
    return tuple(x.shape) if hasattr(x, "shape") else np.shape(x)


def batch_specs(batch: dict, mesh, rules=None) -> dict:
    def one(name, x):
        shape = _shape(x)
        if name == "pos3d":
            return spec_for(shape, (None, "batch", "seq"), mesh, rules)
        return spec_for(shape, ("batch", "seq", None)[:len(shape)], mesh,
                        rules)
    return {k: one(k, v) for k, v in batch.items()}


_CACHE_AXES = {
    "k": (None, "batch", "kv_seq", None, None),
    "v": (None, "batch", "kv_seq", None, None),
    "ckv": (None, "batch", "kv_seq", None),
    "kr": (None, "batch", "kv_seq", None),
    "x": (None, "batch", None, "tp"),
    "b": (None, "batch", None, "tp"),
    "c": (None, "batch", None, "tp"),
    "state": (None, "batch", "heads", None, None),
}


def cache_logical_specs(cache, mesh, rules=None) -> dict:
    """Specs of ``init_cache``'s tree, by each leaf's own key."""
    def leaf(name, x):
        shape = _shape(x)
        axes = _CACHE_AXES.get(name.rsplit("/", 1)[-1], (None,) * len(shape))
        return spec_for(shape, axes, mesh, rules)
    return unflatten({k: leaf(k, v) for k, v in flatten_tree(cache).items()})


def state_specs(state, mesh, rules=None) -> dict:
    return {
        "params": build_param_specs(state["params"], mesh, rules),
        "opt": {"count": (),
                "moments": build_param_specs(state["opt"]["moments"], mesh,
                                             rules)},
        "ef": (build_param_specs(state["ef"], mesh, rules)
               if state.get("ef") is not None else None),
        "step": (),
    }


def batch_group(mesh, rules, what: str, cfg=None) -> BatchGroup | None:
    """The data-parallel group a step runs over: None without a mesh or
    on a device-free mesh of one device, else the ``DeviceMesh``'s batch
    axes (``rules["batch"]``).  A ``model`` axis above 1 is the train
    step's tensor-parallel group where ``cfg`` is given
    (``tensor_parallel.check_supported`` raises for a family it does not
    split); any other axis of size > 1 raises ``NotImplementedError``."""
    if mesh is None:
        return None
    spec = MeshSpec.from_any(mesh)
    batch = spec_axes(rules["batch"])
    for name, size in spec.shape.items():
        if name not in batch and size > 1:
            if name == "model" and cfg is not None:
                check_supported(cfg, size)
                continue
            raise NotImplementedError(
                f"{what} on a mesh with {name!r} of size {size}: not yet "
                "ported (the port's prefill and decode steps are "
                "data-parallel over the batch axes; the reference shards "
                "their caches on kv_seq)")
    if getattr(mesh, "mesh_dim_names", None) is None:     # no DeviceMesh
        if spec.size > 1:
            raise ValueError(
                f"{what} on a mesh of {spec.size} devices needs a "
                "torch.distributed DeviceMesh (launch.mesh.device_mesh)")
        return None
    return BatchGroup(mesh, batch)


def train_layout(cfg: ModelConfig, opt_cfg: AdamWConfig, comp_cfg, mesh,
                 rules=None, what: str = "make_train_step"):
    """The sharded train state's ``fsdp.StateLayout`` on ``mesh``:
    ``mesh`` itself when it is one already (``train_loop`` builds one and
    passes it to the state init, the step and the restore), None where
    the step runs on one device (:func:`batch_group` gives no group),
    else a new one under ``rules`` (default ``DEFAULT_RULES``)."""
    if isinstance(mesh, StateLayout):
        return mesh
    rules = rules or DEFAULT_RULES
    if batch_group(mesh, rules, what, cfg) is None:
        return None
    return StateLayout(cfg, opt_cfg, comp_cfg, mesh, rules)


# ---------------------------------------------------------------------------
# State init
# ---------------------------------------------------------------------------

def init_train_state(cfg: ModelConfig, opt_cfg: AdamWConfig,
                     comp_cfg: CompressionConfig | None = None,
                     seed: int = 0, *, device="cuda", mesh=None,
                     rules=None) -> TrainState:
    """{"params", "opt", "ef", "step"} on ``device`` (the card unless
    ``"cpu"`` is asked for): ``init_params(cfg, seed)``, zero AdamW
    moments, zero error-feedback accumulators when ``comp_cfg`` enables
    compression (else ``None``), and ``step`` a 0-d int32 tensor.  On a
    ``DeviceMesh`` (``mesh``, under ``rules``, default ``DEFAULT_RULES``,
    or the ``fsdp.StateLayout`` already built on one: :func:`train_layout`)
    every leaf is this rank's box of it (``StateLayout.init_state``: the
    same draw, leaf by leaf, each cut as it comes)."""
    dev = resolve_device(device)
    layout = train_layout(cfg, opt_cfg, comp_cfg, mesh, rules,
                          "init_train_state")
    if layout is not None:
        check_mesh(layout.mesh, dev)
        return layout.init_state(seed, dev)
    params = init_params(cfg, seed, device=dev)
    return {
        "params": params,
        "opt": adamw_init(params, opt_cfg),
        "ef": (init_error_feedback(params)
               if comp_cfg and comp_cfg.enabled else None),
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def _batch_on(batch: dict, device) -> dict:
    """``make_batch``'s numpy batch as the model's tensors on ``device``;
    tensors are moved as they are."""
    host = {k: v for k, v in batch.items()
            if not isinstance(v, torch.Tensor)}
    out = {k: v.to(device) for k, v in batch.items()
           if isinstance(v, torch.Tensor)}
    out.update(to_device(host, device))
    return out


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------

def make_train_step(cfg: ModelConfig, mesh, opt_cfg: AdamWConfig,
                    comp_cfg: CompressionConfig | None = None,
                    rules=None, total_steps: int = 10000,
                    warmup: int = 100):
    """Returns ``(step_fn, jitted)``.  ``step_fn(state, batch) -> (state,
    {"loss", "lr_scale"})`` runs the reference's order: loss and
    gradients by autograd, error feedback when enabled, the warmup-cosine
    scale of ``state["step"]``, AdamW, ``step + 1``; it writes the
    parameters, moments and EF in place, so the returned state holds the
    same tensors and a new ``step``.

    On a ``DeviceMesh`` (or the ``fsdp.StateLayout`` already built on
    one: :func:`train_layout`) every rank passes the same global batch
    and runs its rows, and the state is this rank's boxes
    (``init_train_state(..., mesh=)``; ``fsdp.StateLayout``): each
    parameter is gathered for the forward and backward
    (``StateLayout.gather_params``), whose backward sums its gradient over
    the batch axes in f32 (a bf16 gradient is widened first, so the only
    rounding to bf16 is the one after the mean), divides it by the
    group's size and cuts it back to the box; on a ``model`` axis above 1
    the blocks run tensor-parallel.  EF and AdamW then update the boxes in
    place, with the whole tree's gradient norm and the whole leaves' 8-bit
    codes.  The loss is the group's mean; a MoE model's load-balance terms
    ``f_e`` and ``P_e`` are averaged over the group before their product
    (``aux_reduce``), so the step keeps the whole-batch loss.
    ``jitted(state, probe)`` returns ``fn(state, batch)``, which runs
    ``step_fn`` on the state's device and writes the new state into
    ``state``.  The steps
    carry ``torch.profiler.record_function`` ranges ``train_step/ef`` and
    ``train_step/adamw``."""
    comp_cfg = comp_cfg or CompressionConfig(enabled=False)
    layout = train_layout(cfg, opt_cfg, comp_cfg, mesh, rules)
    group = layout.group if layout is not None else None

    def step_fn(state: TrainState, batch: dict):
        params = state["params"]
        flat = flatten_tree(params)
        dev = next(iter(flat.values())).device
        if layout is not None:
            group.check(dev)
            batch = group.rows(batch)
        batch = _batch_on(batch, dev)
        leaves = [p.detach().requires_grad_(True) for p in flat.values()]
        with torch.enable_grad():
            work = dict(zip(flat, leaves))
            if layout is not None:
                work = layout.gather_params(work)
            loss = train_loss(unflatten(work), batch, cfg,
                              aux_reduce=group.mean if group else None,
                              tp=layout.tp if layout else None)
            grads = torch.autograd.grad(loss, leaves)
        del leaves, work
        with torch.no_grad():
            if group is not None:
                loss = group.mean_(loss.detach().clone())
            grads = unflatten(dict(zip(flat, grads)))
            ef = state["ef"]
            if comp_cfg.enabled:
                with torch.profiler.record_function("train_step/ef"):
                    grads, ef = ef_compress_update(grads, ef, comp_cfg,
                                                   layout)
            lr_scale = linear_warmup_cosine(state["step"], warmup,
                                            total_steps)
            with torch.profiler.record_function("train_step/adamw"):
                params, opt = adamw_update(grads, state["opt"], params,
                                           opt_cfg, lr_scale, layout)
        del grads
        new_state = {"params": params, "opt": opt, "ef": ef,
                     "step": state["step"] + 1}
        return new_state, {"loss": loss.detach(), "lr_scale": lr_scale}

    def jitted(state, batch):
        del batch                     # no shapes to specialise on
        if layout is not None:
            layout.check_state(state)

        def fn(st, b):
            new, metrics = step_fn(st, b)
            st.update(new)
            return st, metrics
        return fn

    return step_fn, jitted


def make_prefill_step(cfg: ModelConfig, mesh, rules=None, max_len=None):
    """``step_fn(params, batch) -> (last logits (B, V), caches)``: the
    prompt (``tokens`` (B, S), or ``embeds`` (B, S, d) with ``pos3d``)
    into fresh caches of ``max_len`` (default S) on the input's device.
    On a ``DeviceMesh`` each rank prefills its rows of the global batch
    into caches of those rows and returns every row's logits (gathered
    over the batch axes)."""
    group = batch_group(mesh, rules or PREFILL_RULES, "make_prefill_step")

    @torch.no_grad()
    def step_fn(params, batch):
        if group is not None:
            batch = group.rows(batch)
        tokens = batch.get("tokens")
        inp = tokens if tokens is not None else batch["embeds"]
        b, s = inp.shape[0], inp.shape[1]
        if group is not None:
            group.check(inp.device)
        caches = init_cache(cfg, b, max_len or s, device=inp.device)
        logits, new_caches, _ = forward(
            params, cfg, tokens=tokens, embeds=batch.get("embeds"),
            pos3d=batch.get("pos3d"), caches=caches, last_only=True,
            with_aux=False)
        logits = logits[:, 0, :]
        if group is not None:
            logits = group.gather_rows(logits)
        return logits, new_caches

    return step_fn


def make_decode_step(cfg: ModelConfig, mesh, rules=None):
    """serve_step: one new token against a filled KV/state cache;
    ``step_fn(params, caches, inputs, pos) -> (logits (B, V), caches)``,
    the caches written in place.  On a ``DeviceMesh`` ``inputs`` and a
    per-row ``pos`` are the global batch's, ``caches`` this rank's rows
    (the prefill step's), and every row's logits come back."""
    group = batch_group(mesh, rules or SERVE_RULES, "make_decode_step")

    @torch.no_grad()
    def step_fn(params, caches, inputs, pos):
        if group is not None:
            group.check(next(iter(flatten_tree(caches).values())).device)
            inputs = group.rows(inputs)
            if isinstance(pos, torch.Tensor) and pos.dim() == 1:
                pos = group.rows({"pos": pos})["pos"]
        logits, new_caches, _ = forward(
            params, cfg,
            tokens=(inputs["tokens"][:, None]
                    if "tokens" in inputs else None),
            embeds=inputs.get("embeds"), pos3d=inputs.get("pos3d"),
            caches=caches, cache_pos=pos, last_only=True, with_aux=False)
        logits = logits[:, 0, :]
        if group is not None:
            logits = group.gather_rows(logits)
        return logits, new_caches

    return step_fn
