"""The train state sharded by the reference's rules on a ``DeviceMesh``
(the port's own, as ``data_parallel`` is: the reference lets XLA's SPMD
partitioner gather and reduce what ``repro.distributed.sharding``'s
``"fsdp": "data"`` and ``"tp"`` / ``"heads"`` / ``"vocab"`` on
``"model"`` rules shard).

Every leaf of ``{"params", "opt", "ef", "step"}`` is held as this rank's
box of it under ``train.steps.state_specs`` (:class:`StateLayout`,
``sharding.leaf_box``).  A step gathers each parameter whole over the
axes of the batch group (``pod``, ``data``) it is split on
(:class:`_GatherLeaf`, ZeRO-3 style, the whole leaf for the whole forward
and backward); the backward reduce-scatters the gradient over the same
axes and all-reduces it over the batch axes the leaf is replicated on, in
f32, divides it by the group's size (a 0-d divisor) and casts it back,
so a gradient comes back as the rank's box, already the batch group's
mean.  On the ``model`` axis each rank keeps the part of a split leaf its
tensor-parallel block reads (``tensor_parallel``): a box that is that
part is used as it is; a box the rule cut elsewhere (a key/value head
split across ranks) is gathered over ``model`` too and sliced, its
gradient summed back to the box; a replicated leaf the block splits is
sliced, its gradient summed over ``model``, and so is the gradient of a
replicated leaf the block reads on the rank's heads only (``q_norm``,
``k_norm``).

The optimizer works on boxes: the gradient norm sums each leaf's squares
over the axes it is split on only (:meth:`StateLayout.sum_squares`), and
the 8-bit codes of the moments and the error feedback equal the whole
leaf's (:class:`BoxQ8`): a leaf under one absmax scale takes the max over
its shards, and 128-blocks a shard boundary cuts take theirs over the
axes that cut them.  A checkpoint gathers the state leaf by leaf
(:meth:`StateLayout.gather_state`); a restore cuts boxes
(``CheckpointManager.restore(mesh=layout)``).
"""

from __future__ import annotations

import math
from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist

from ..compression.q8 import (Q8_BLOCK, q8_blockable, q8_decode,
                              q8_encode, q8_scale_shape)
from ..compression.tree import flatten_tree, unflatten
from ..models.transformer import iter_params, param_specs
from ..optim.adamw import adamw_init
from .compress import init_error_feedback
from .data_parallel import BatchGroup
from .sharding import (DEFAULT_RULES, leaf_box, logical_axes_for_path,
                       mesh_axis_names, spec_axes, spec_for)
from .tensor_parallel import TensorParallel, model_size

# the state's tensor subtrees and their prefixes in a flat state name
_TREES = (("params", "params/"), ("moments", "opt/moments/"),
          ("ef", "ef/"))


def _meta_state(cfg, opt_cfg, comp_cfg) -> dict:
    """The whole state's tensor subtrees as meta tensors (shapes and
    dtypes, no memory)."""
    params = unflatten({k: torch.empty(s, dtype=dt, device="meta")
                        for k, (s, dt) in param_specs(cfg).items()})
    return {"params": params,
            "moments": adamw_init(params, opt_cfg)["moments"],
            "ef": (init_error_feedback(params)
                   if comp_cfg is not None and comp_cfg.enabled else None)}


def state_leaf_spec(name: str, shape, mesh_spec, rules) -> tuple:
    """The spec of flat state leaf ``name`` (``train.steps.state_specs``'
    entry): a parameter, moment or EF leaf takes its parameter's rule,
    ``step`` and the count are replicated."""
    for _, prefix in _TREES:
        if name.startswith(prefix):
            rel = name[len(prefix):]
            return spec_for(shape, logical_axes_for_path(rel, len(shape)),
                            mesh_spec, rules)
    return (None,) * len(shape)


def _reduce_scatter(x, group, out):
    fn = getattr(dist, "reduce_scatter_single", None) or \
        dist.reduce_scatter_tensor
    fn(out, x, group=group)


def all_gather_dim(t: torch.Tensor, dim: int, group, n: int):
    """Every rank's ``t`` of ``group`` joined along ``dim`` in group-rank
    order (through a flat buffer: gloo and NCCL take the same layout)."""
    if n == 1:
        return t.clone()
    out = torch.empty(n * t.numel(), dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out, t.contiguous().reshape(-1),
                                group=group)
    parts = out.view(n, *t.shape)
    return parts.reshape(n * t.shape[0], *t.shape[1:]) if dim == 0 else \
        torch.cat(parts.unbind(0), dim=dim)


def reduce_scatter_dim(g: torch.Tensor, dim: int, group, n: int):
    """``g`` summed over ``group`` and cut to this rank's ``1 / n`` of
    ``dim``."""
    if n == 1:
        return g
    # (n, ..., len, ...): rank r's part of dim is block r
    parts = g.reshape(*g.shape[:dim], n, g.shape[dim] // n,
                      *g.shape[dim + 1:]).movedim(dim, 0).contiguous()
    out = torch.empty(parts.shape[1:], dtype=g.dtype, device=g.device)
    _reduce_scatter(parts.reshape(-1), group, out.view(-1))
    return out


class _GatherLeaf(torch.autograd.Function):
    """A box gathered whole over ``gathers`` ((dim, group, size),
    minor axis of a dim first).  Backward: the gradient in f32,
    reduce-scattered back over the same axes, all-reduced over ``sums``,
    divided by ``div`` (the batch group's size) and cast to the box's
    dtype.  The two run in ``torch.profiler.record_function`` ranges
    ``fsdp/gather`` and ``fsdp/reduce``."""

    @staticmethod
    def forward(ctx, box, gathers, sums, div):
        ctx.gathers, ctx.sums, ctx.div = gathers, sums, div
        ctx.dtype = box.dtype
        t = box
        with torch.profiler.record_function("fsdp/gather"):
            for dim, group, n in gathers:
                t = all_gather_dim(t, dim, group, n)
        return t if gathers else box.view_as(box)

    @staticmethod
    def backward(ctx, grad):
        with torch.profiler.record_function("fsdp/reduce"):
            g = grad.to(torch.float32, copy=True)
            for dim, group, n in reversed(ctx.gathers):
                g = reduce_scatter_dim(g, dim, group, n)
            for group in ctx.sums:
                dist.all_reduce(g, group=group)
            g = g / torch.tensor(float(ctx.div), dtype=g.dtype,
                                 device=g.device)
            return g.to(ctx.dtype), None, None, None


class BoxQ8:
    """The q8 codes and scales (``compression.q8``) of this rank's box of
    a leaf, equal to the whole leaf's there: ``scale`` is the leaf's one
    absmax scale when its last dim is not a multiple of 128 (the max
    all-reduced over every axis the leaf is split on), else the box's
    blocks' scales; where a shard boundary cuts 128-blocks (the scale
    leaf replicated on the axes that split the last dim) the blocks'
    partial maxima are all-reduced over those axes and the scale holds
    every block of the last dim."""

    def __init__(self, box, scale_box, groups: dict):
        self.kind = "whole"
        self.groups: list = []
        if not q8_blockable(tuple(box.shape)):
            self.kind = "scalar"
            self.groups = [groups[a] for a in box.shard_axes]
            return
        n = box.local_shape[-1]
        if n % Q8_BLOCK == 0:
            return
        if scale_box.dim_axes[:-1] != box.dim_axes[:-1] or \
                scale_box.dim_axes[-1]:
            raise NotImplementedError(
                f"q8 blocks cut by the split {box.spec} with scales split "
                f"{scale_box.spec}")
        self.kind = "straddle"
        self.groups = [groups[a] for a in box.dim_axes[-1]]
        self.start, self.n = box.starts[-1], n
        self.blocks = box.shape[-1] // Q8_BLOCK

    def _ids(self, device):
        return (self.start + torch.arange(self.n, device=device)) // Q8_BLOCK

    def _max(self, t):
        for g in self.groups:
            dist.all_reduce(t, op=dist.ReduceOp.MAX, group=g)
        return t

    def encode(self, x: torch.Tensor):
        if self.kind == "whole" or (self.kind == "scalar" and
                                    not self.groups):
            return q8_encode(x)
        c127 = torch.tensor(127.0, dtype=x.dtype, device=x.device)
        if self.kind == "scalar":
            amax = self._max(x.abs().max())
            cols = scale = torch.maximum(
                amax / c127, torch.tensor(1e-12, dtype=x.dtype,
                                          device=x.device))
        else:
            ids = self._ids(x.device)
            part = torch.zeros(*x.shape[:-1], self.blocks, dtype=x.dtype,
                               device=x.device)
            part.scatter_reduce_(-1, ids.expand(x.shape), x.abs(), "amax")
            scale = torch.maximum(
                self._max(part) / c127,
                torch.tensor(1e-12, dtype=x.dtype, device=x.device))
            cols = scale[..., ids]
        codes = torch.clamp(torch.round(x / cols), -127, 127).to(torch.int8)
        return codes, scale.to(torch.float32)

    def decode(self, codes: torch.Tensor, scale: torch.Tensor):
        if self.kind == "straddle":
            return codes.to(torch.float32) * scale[..., self._ids(
                codes.device)]
        return q8_decode(codes, scale)

    def encode_sqrt(self, v):
        return self.encode(torch.sqrt(torch.clamp_min(v, 0.0)))

    def decode_sqrt(self, codes, scale):
        return torch.square(self.decode(codes, scale))


class StateLayout:
    """The train state of ``cfg`` (``opt_cfg``'s moments, EF when
    ``comp_cfg`` enables it) on ``mesh`` (a ``DeviceMesh``) under
    ``rules``: ``boxes`` maps every flat state name (``params/...``,
    ``opt/moments/...``, ``ef/...``, ``step``) to this rank's
    ``sharding.LeafBox``; ``group`` is the batch group and ``tp`` the
    tensor-parallel group (None on a model axis of 1)."""

    def __init__(self, cfg, opt_cfg, comp_cfg, mesh, rules=None):
        from ..checkpoint.sharded import MeshSpec
        self.cfg, self.mesh = cfg, mesh
        self.rules = rules or DEFAULT_RULES
        batch = self.rules["batch"]
        self.batch_axes = spec_axes(batch)
        self.group = BatchGroup(mesh, self.batch_axes)
        self.tp = (TensorParallel(mesh, cfg) if model_size(mesh) > 1
                   else None)
        names = mesh_axis_names(mesh)
        self.sizes = {a: int(mesh.size(i)) for i, a in enumerate(names)}
        self.groups = {a: mesh.get_group(a) for a in names}
        self.spec_mesh = MeshSpec.from_any(mesh)
        meta = _meta_state(cfg, opt_cfg, comp_cfg)
        self.shapes: dict = {}
        self.boxes: dict = {}
        for tree, prefix in _TREES:
            if meta[tree] is None:
                continue
            for k, leaf in flatten_tree(meta[tree]).items():
                self.shapes[prefix + k] = (tuple(leaf.shape), leaf.dtype)
                self.boxes[prefix + k] = self.box(prefix + k, leaf.shape)
        self.boxes["step"] = leaf_box((), (), mesh)
        self.plans = {k[len("params/"):]: self._plan(k[len("params/"):], b)
                      for k, b in self.boxes.items()
                      if k.startswith("params/")}
        self._codecs: dict = {}

    def box(self, name: str, shape):
        """This rank's box of state leaf ``name`` of the whole ``shape``."""
        return leaf_box(shape, state_leaf_spec(name, tuple(shape),
                                               self.spec_mesh, self.rules),
                        self.mesh)

    # -- the forward's whole leaves --------------------------------------
    def _gather(self, dim, axis):
        return (dim, self.groups[axis], self.sizes[axis])

    def _plan(self, name: str, box) -> SimpleNamespace:
        gathers, kept = [], []
        for dim, axes in enumerate(box.dim_axes):
            j = next((i for i, a in enumerate(axes)
                      if a in self.batch_axes), len(axes))
            gathers += [(dim, a) for a in reversed(axes[j:])]
            kept.append(axes[:j])
        sums = [a for a in self.batch_axes if a in box.replica_axes]
        narrow = None
        model_dims = [d for d, axes in enumerate(kept) if "model" in axes]
        split = self.tp.split(name, len(box.shape)) if self.tp else None
        if split is None:
            if model_dims:
                raise NotImplementedError(
                    f"{name}: split on the model axis by {box.spec}, but no "
                    "tensor-parallel block splits it")
            if self.tp is not None and self.tp.partial(name):
                sums.append("model")
        else:
            dim, what = split
            t = self.tp.size
            step = box.shape[dim] // t
            want = [self.tp.ranges(r)[what] for r in range(t)]
            aligned = (model_dims == [dim] and kept[dim] == ("model",) and
                       all(w == (r * step, (r + 1) * step)
                           for r, w in enumerate(want)))
            if not aligned:
                for d in model_dims:        # the kept axes, minor first
                    gathers += [(d, a) for a in reversed(kept[d])]
                if not model_dims:
                    sums.append("model")
                a, b = want[self.tp.rank]
                narrow = (dim, a, b - a)
        div = math.prod(self.sizes[a] for a in self.batch_axes
                        if a in self.sizes)
        return SimpleNamespace(
            gathers=tuple(self._gather(d, a) for d, a in gathers),
            sums=tuple(self.groups[a] for a in sums), narrow=narrow,
            div=div, gathered=tuple(gathers), summed=tuple(sums))

    def gather_params(self, boxes: dict) -> dict:
        """Flat name -> the tensor the rank's forward reads: each box
        gathered over its batch axes (and, where its model split is not
        the block's, over ``model``), then cut to the rank's
        tensor-parallel part.  Differentiable (:class:`_GatherLeaf`)."""
        out = {}
        for name, box in boxes.items():
            p = self.plans[name]
            t = _GatherLeaf.apply(box, p.gathers, p.sums, p.div)
            out[name] = t.narrow(*p.narrow) if p.narrow else t
        return out

    # -- the optimizer on boxes -----------------------------------------
    def codec(self, name: str) -> BoxQ8:
        """The box q8 codec of parameter ``name``'s moments and EF."""
        if name not in self._codecs:
            box = self.boxes["params/" + name]
            # the m_s leaf's box (the EF's codes have none: the box it
            # would have)
            scale = self.box(f"opt/moments/{name}/m_s",
                             q8_scale_shape(tuple(box.shape)))
            self._codecs[name] = BoxQ8(box, scale, self.groups)
        return self._codecs[name]

    def sum_squares(self, parts: dict) -> torch.Tensor:
        """The whole tree's sum of squares from each parameter box's
        (``parts``, flat name -> 0-d f32, in the tree's order): each sum
        all-reduced over the axes its leaf is split on, so a replicated
        leaf counts once; added in the tree's order, as the mesh-free
        ``global_norm`` adds them."""
        names = list(parts)
        vec = torch.stack([parts[n] for n in names])
        for axis, group in self.groups.items():
            mask = [axis in self.boxes["params/" + n].shard_axes
                    for n in names]
            if not any(mask):
                continue
            m = torch.tensor(mask, device=vec.device)
            tmp = torch.where(m, vec, torch.zeros_like(vec))
            dist.all_reduce(tmp, group=group)
            vec = torch.where(m, tmp, vec)
        return sum(vec.unbind(0))

    # -- state init, saves and restores ---------------------------------
    def init_state(self, seed: int, device) -> dict:
        """``init_train_state``'s state as this rank's boxes: parameters
        drawn leaf by leaf (``iter_params``, the mesh-free draw) and cut,
        so a rank holds at most one whole leaf; zero moments, EF and
        step of the boxes' shapes."""
        params = {}
        for name, leaf in iter_params(self.cfg, seed, device=device):
            box = self.boxes["params/" + name]
            params[name] = leaf if box.whole else box.cut(leaf).clone()
            del leaf

        def zeros(prefix):
            return unflatten({
                k[len(prefix):]: torch.zeros(self.boxes[k].local_shape,
                                             dtype=dt, device=device)
                for k, (_, dt) in self.shapes.items()
                if k.startswith(prefix)})
        ef = zeros("ef/") if any(k.startswith("ef/") for k in
                                 self.shapes) else None
        return {"params": unflatten(params),
                "opt": {"count": np.int32(0),
                        "moments": zeros("opt/moments/")},
                "ef": ef,
                "step": torch.zeros((), dtype=torch.int32, device=device)}

    def check_state(self, state: dict) -> None:
        """Raise unless every tensor of ``state`` is this rank's box of
        its leaf (``init_train_state(..., mesh=, rules=)``'s state)."""
        for name, v in flatten_tree(state).items():
            box = self.boxes.get(name)
            if isinstance(v, torch.Tensor) and box is not None and \
                    tuple(v.shape) != box.local_shape:
                raise ValueError(
                    f"{name}: shape {tuple(v.shape)}, but this rank's box "
                    f"of it on the mesh is {box.local_shape} (build the "
                    "state with init_train_state(..., mesh=, rules=))")

    def cut(self, name: str, whole):
        """This rank's box of state leaf ``name`` from its whole value
        (a tensor or numpy array; a leaf without a box is returned)."""
        box = self.boxes.get(name)
        return whole if box is None or box.whole else box.cut(whole)

    def gather_state(self, state: dict, keep: bool):
        """The whole state from every rank's boxes, gathered leaf by leaf
        (collectives on every rank); where ``keep`` the tree is returned
        (the writer's): a leaf the rank holds whole is the state's own
        tensor, a gathered one is copied to the host as it comes, so the
        device holds one gathered leaf at a time.  Else None.  ``None``
        subtrees stay None."""
        def walk(tree, prefix):
            out = {}
            for k, v in tree.items():
                name = prefix + k
                if isinstance(v, dict):
                    out[k] = walk(v, name + "/")
                    continue
                box = self.boxes.get(name)
                if isinstance(v, torch.Tensor) and box is not None and \
                        not box.whole:
                    for dim, axes in enumerate(box.dim_axes):
                        for a in reversed(axes):
                            v = all_gather_dim(v, dim, self.groups[a],
                                               self.sizes[a])
                    v = v.detach().to("cpu", copy=True) if keep else None
                out[k] = v
            return out
        whole = walk(state, "")
        return whole if keep else None


def shard_state(state: dict, mesh, rules=None) -> dict:
    """A whole state (``init_train_state`` without a mesh) as this rank's
    boxes on ``mesh`` (a ``DeviceMesh``) under ``rules`` (copies)."""
    from ..checkpoint.sharded import MeshSpec
    spec_mesh, rules = MeshSpec.from_any(mesh), rules or DEFAULT_RULES

    def walk(tree, prefix):
        out = {}
        for k, v in tree.items():
            name = prefix + k
            if isinstance(v, dict):
                out[k] = walk(v, name + "/")
            elif isinstance(v, torch.Tensor):
                spec = state_leaf_spec(name, tuple(v.shape), spec_mesh,
                                       rules)
                out[k] = leaf_box(v.shape, spec, mesh).cut(v).clone()
            else:
                out[k] = v
        return out
    return walk(state, "")
