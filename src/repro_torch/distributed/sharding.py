"""Logical-axis sharding rules -> per-dim mesh axes (the port's copy of
``logical_axes_for_path``, ``spec_for`` and ``build_param_specs`` from
``repro.distributed.sharding``).

Parameters are matched by flat name against a rule table of *logical*
axes; logical axes resolve to mesh axes through a rules dict, each checked
for divisibility against the mesh (a dim that does not divide falls back to
replication).  A spec is a plain tuple with one entry per dim (``None``, an
axis name or a tuple of names), as ``jax.sharding.PartitionSpec`` holds
them, and a mesh is anything with a ``.shape`` mapping of axis sizes
(``checkpoint.sharded.MeshSpec``): a save's shard grid needs no devices.

On a ``torch.distributed`` ``DeviceMesh`` a spec becomes DTensor
placements (:func:`placements_for`, the counterpart of the reference's
``named_shardings``); :func:`check_mesh` refuses a mesh that cannot hold
a tensor of a given device (no fallback to another device or backend).
:func:`leaf_box` gives a leaf's box on this rank and the axes it is split
and replicated on, from which the sharded train step
(``distributed.fsdp``) gathers and reduces it.  The reference's
``activation_sharding`` / ``constrain`` have no copy: the port's model is
not traced under SPMD, and its steps gather and reduce explicitly, so no
activation needs a layout constraint.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np

from ..compression.tree import flatten_tree, unflatten

DEFAULT_RULES: dict[str, object] = {
    "batch": ("pod", "data"),      # DP over pods x data
    "fsdp": "data",                # parameter sharding (ZeRO-3 style)
    "fsdp_pod": ("pod", "data"),   # wider FSDP for the largest models
    "tp": "model",                 # megatron-style tensor parallel
    "expert": "model",             # EP: expert banks
    "vocab": "model",              # embedding/logits vocab dim
    "kv_heads": "model",           # replicated automatically if kv < |model|
    "heads": "model",
    "seq": None,                   # set to "data" to enable SP
    "kv_seq": "model",             # decode KV-cache sequence sharding
    "moe_group": ("pod", "data"),  # MoE dispatch groups (== batch rows)
}

# Serving: no optimizer state, so parameters are TP-sharded and replicated
# over data; MoE expert banks span (data x model).
SERVE_RULES: dict[str, object] = {
    **DEFAULT_RULES,
    "fsdp": None,
    "fsdp_pod": None,
    "expert": ("data", "model"),
    "moe_group": None,             # tokens -> expert owners is the all-to-all
}

# Prefill: like serving, but MoE dispatch groups shard with the batch and
# experts stay on "model" (group-local dispatch).
PREFILL_RULES: dict[str, object] = {
    **SERVE_RULES,
    "expert": "model",
    "moe_group": ("pod", "data"),
}


def _mesh_axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        return int(np.prod([_mesh_axis_size(mesh, a) for a in axis]))
    return mesh.shape[axis] if axis in mesh.shape else 1


def _present(mesh, axis):
    """Drop mesh axes that don't exist on this mesh (e.g. 'pod' on 1 pod)."""
    if axis is None:
        return None
    if isinstance(axis, tuple):
        kept = tuple(a for a in axis if a in mesh.shape)
        return kept if len(kept) > 1 else (kept[0] if kept else None)
    return axis if axis in mesh.shape else None


def spec_for(shape, logical_axes, mesh, rules=None) -> tuple:
    """Resolve logical axes for ``shape`` with divisibility fallback.

    Tuple axes degrade gracefully: ("data","model") on a dim of 64 with a
    16x16 mesh falls back to ("model",) (64 % 256 != 0 but 64 % 16 == 0)
    before replicating."""
    rules = rules or DEFAULT_RULES
    out = []
    for dim, name in zip(shape, logical_axes):
        if name is None:
            out.append(None)
            continue
        axis = _present(mesh, rules.get(name))
        candidates = [axis]
        if isinstance(axis, tuple):
            candidates += [axis[i:] if len(axis[i:]) > 1 else axis[-1]
                           for i in range(1, len(axis))]
        chosen = None
        for cand in candidates:
            size = _mesh_axis_size(mesh, cand)
            if cand is not None and size > 1 and dim % size == 0:
                chosen = cand
                break
        out.append(chosen)
    return tuple(out)


# ---------------------------------------------------------------------------
# Parameter rules (regex on '/'-joined tree path, innermost dims)
# ---------------------------------------------------------------------------

PARAM_RULES: list[tuple[str, tuple]] = [
    (r"embed$", ("vocab", "fsdp")),
    (r"head$", ("fsdp", "vocab")),
    # attention (GQA)
    (r"attn/wq$", ("fsdp", "tp")),
    (r"attn/wk$", ("fsdp", "tp")),
    (r"attn/wv$", ("fsdp", "tp")),
    (r"attn/wo$", ("tp", "fsdp")),
    (r"attn/b[qkv]$", ("tp",)),
    (r"attn/[qk]_norm$", (None,)),
    # attention (MLA)
    (r"attn/w_dq$", ("fsdp", None)),
    (r"attn/w_uq$", (None, "tp")),
    (r"attn/w_dkv$", ("fsdp", None)),
    (r"attn/w_uk$", (None, "tp")),
    (r"attn/w_uv$", (None, "tp")),
    (r"attn/w_kr$", ("fsdp", None)),
    (r"attn/(q_norm|kv_norm)$", (None,)),
    # dense mlp
    (r"mlp/w_gate$", ("fsdp", "tp")),
    (r"mlp/w_up$", ("fsdp", "tp")),
    (r"mlp/w_down$", ("tp", "fsdp")),
    # moe
    (r"moe/router$", ("fsdp", None)),
    (r"moe/w_gate$", ("expert", "fsdp", None)),
    (r"moe/w_up$", ("expert", "fsdp", None)),
    (r"moe/w_down$", ("expert", None, "fsdp")),
    (r"moe/sh_gate$", ("fsdp", "tp")),
    (r"moe/sh_up$", ("fsdp", "tp")),
    (r"moe/sh_down$", ("tp", "fsdp")),
    # ssm
    (r"mixer/w_z$", ("fsdp", "tp")),
    (r"mixer/w_x$", ("fsdp", "tp")),
    (r"mixer/w_b$", ("fsdp", "tp")),
    (r"mixer/w_c$", ("fsdp", "tp")),
    (r"mixer/w_dt$", ("fsdp", "tp")),
    (r"mixer/conv_._w$", ("tp", None)),
    (r"mixer/conv_._b$", ("tp",)),
    (r"mixer/(a_log|dt_bias|d_skip)$", ("tp",)),
    (r"mixer/norm$", ("tp",)),
    (r"mixer/out_proj$", ("tp", "fsdp")),
    # norms / everything 1-D
    (r"(norm|scale|bias)$", (None,)),
]

_MOMENT_SUFFIXES = ("/m_q", "/v_q", "/m_s", "/v_s", "/m", "/v")


def logical_axes_for_path(path_str: str, ndim: int) -> tuple:
    """The logical axes of the leaf named ``path_str``.  Optimizer moments
    and int8 serving codes live under the param path plus a suffix and
    inherit the param's axes; q8s scales keep the rule's trailing axis."""
    tail_axes = False
    if path_str.endswith("/q8s"):
        path_str = path_str[:-4]
        tail_axes = True
    elif path_str.endswith("/q8"):
        path_str = path_str[:-3]
    else:
        for suf in _MOMENT_SUFFIXES:
            if path_str.endswith(suf):
                path_str = path_str[: -len(suf)]
                break
    for pat, axes in PARAM_RULES:
        if re.search(pat, path_str):
            if tail_axes:              # per-out-channel scale vector(s)
                axes = tuple(axes)[-1:]
            if len(axes) < ndim:       # stacked layer (and scale) lead dims
                return (None,) * (ndim - len(axes)) + tuple(axes)
            return tuple(axes[:ndim])
    return (None,) * ndim


def build_param_specs(params, mesh, rules=None) -> dict:
    """Specs (tuples) in ``params``' nested structure, one per leaf, by
    flat name; optimizer moments and error-feedback trees take their
    param's rule through the name.  Shapes only: no device is touched."""
    return unflatten({
        name: spec_for(tuple(leaf.shape),
                       logical_axes_for_path(name, len(leaf.shape)), mesh,
                       rules)
        for name, leaf in flatten_tree(params).items()})


# ---------------------------------------------------------------------------
# DeviceMesh placement (torch.distributed)
# ---------------------------------------------------------------------------

def mesh_axis_names(mesh) -> tuple:
    """A ``DeviceMesh``'s axis names (``mesh_dim_names``, required)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if not names:
        raise ValueError("a DeviceMesh needs mesh_dim_names (the spec's "
                         "axis names)")
    return tuple(names)


def placements_for(spec, device_mesh) -> list:
    """DTensor placements of a spec tuple on ``device_mesh``: a dim whose
    entry names mesh axes is ``Shard(dim)`` on each of them, every other
    mesh dim ``Replicate()``.  A dim split over two mesh axes is split in
    mesh-dim order by DTensor and in the tuple's order by JAX, so the
    tuple must name them in mesh order (it does for every rule:
    ``("pod", "data")``, ``("data", "model")``)."""
    from torch.distributed.tensor import Replicate, Shard
    names = mesh_axis_names(device_mesh)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        axes = spec_axes(entry)
        idx = []
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {spec}: axis {a!r} is not on the "
                                 f"mesh {names}")
            if not isinstance(out[names.index(a)], Replicate):
                raise ValueError(f"spec {spec}: mesh axis {a!r} shards two "
                                 "dims")
            idx.append(names.index(a))
        if idx != sorted(idx):
            raise ValueError(
                f"spec {spec}: dim {dim} is split over {axes}, not in the "
                f"mesh's order {names}; DTensor would split it in mesh "
                "order and JAX in the tuple's")
        for i in idx:
            out[i] = Shard(dim)
    return out


def mesh_device(mesh):
    """The device this rank holds on ``mesh``: the current card of a CUDA
    mesh."""
    import torch
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def mesh_flat_index(mesh) -> int:
    """This rank's flat index on ``mesh`` (C order over its axes), the
    numbering of ``checkpoint.sharded.device_box``."""
    flat = 0
    for size, c in zip(mesh.shape, mesh.get_coordinate()):
        flat = flat * int(size) + int(c)
    return flat


def spec_axes(entry) -> tuple:
    """A spec entry (None, an axis name or a tuple of names) as a tuple
    of mesh axis names."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


@dataclass(frozen=True)
class LeafBox:
    """Where a leaf of ``shape`` lives on a ``DeviceMesh`` under ``spec``:
    this rank's ``[starts, stops)`` box of it (the box that
    ``checkpoint.sharded.device_box`` gives the rank's flat index, and
    ``placements_for`` gives DTensor), the mesh axes each dim is split on
    (``dim_axes``, first axis major) and the mesh axes the leaf is
    replicated on (``replica_axes``), both in mesh order."""

    shape: tuple
    spec: tuple
    starts: tuple
    stops: tuple
    dim_axes: tuple
    replica_axes: tuple

    @property
    def local_shape(self) -> tuple:
        return tuple(b - a for a, b in zip(self.starts, self.stops))

    @property
    def shard_axes(self) -> tuple:
        """Every mesh axis the leaf is split on, in mesh order of the
        dims' entries."""
        return tuple(a for axes in self.dim_axes for a in axes)

    @property
    def whole(self) -> bool:
        return self.local_shape == tuple(self.shape)

    def cut(self, whole):
        """This rank's box of the whole leaf (a view)."""
        return whole[tuple(slice(a, b) for a, b in zip(self.starts,
                                                         self.stops))]


def leaf_box(shape, spec, mesh) -> LeafBox:
    """This rank's :class:`LeafBox` of a leaf of ``shape`` under ``spec``
    (a spec tuple, as :func:`spec_for` gives it) on ``mesh`` (a
    ``DeviceMesh``).  A dim split over ``(a1, a2)`` takes shard
    ``c1 * |a2| + c2`` of ``|a1| * |a2|``, as JAX and ``device_box``
    number them."""
    names = mesh_axis_names(mesh)
    sizes = {a: int(mesh.size(i)) for i, a in enumerate(names)}
    coords = dict(zip(names, (int(c) for c in mesh.get_coordinate())))
    shape = tuple(int(s) for s in shape)
    dim_axes = [spec_axes(e) for e in spec] + [()] * (len(shape) - len(spec))
    starts, stops = [], []
    for dim, axes in zip(shape, dim_axes):
        n, idx = 1, 0
        for a in axes:
            if a not in sizes:
                raise ValueError(f"spec {spec}: axis {a!r} is not on the "
                                 f"mesh {names}")
            n *= sizes[a]
            idx = idx * sizes[a] + coords[a]
        if dim % n:
            raise ValueError(f"spec {spec}: dim {dim} does not split over "
                             f"{axes} ({n} shards)")
        starts.append(idx * (dim // n))
        stops.append((idx + 1) * (dim // n))
    used = {a for axes in dim_axes for a in axes}
    return LeafBox(shape, tuple(spec), tuple(starts), tuple(stops),
                   tuple(dim_axes), tuple(a for a in names if a not in used))


def check_mesh(mesh, device) -> None:
    """Raise unless ``mesh`` (a ``DeviceMesh``) can hold tensors of
    ``device``: the same device type, and a CUDA mesh's groups on NCCL,
    or on the ``fake`` backend, which moves no data and which only the
    dry run (``launch.dryrun.fake_world``) starts.  Nothing falls back to
    another device or backend."""
    import torch
    import torch.distributed as dist
    dev = torch.device(device)
    if mesh.device_type != dev.type:
        raise ValueError(f"the mesh is on {mesh.device_type!r} but the "
                         f"tensors are on {dev.type!r}")
    if dev.type == "cuda":
        for g in mesh.get_all_groups():
            if dist.get_backend(g) not in ("nccl", "fake"):
                raise ValueError(
                    f"a CUDA mesh needs NCCL process groups, got "
                    f"{dist.get_backend(g)!r}")
