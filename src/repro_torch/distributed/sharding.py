"""Logical-axis sharding rules -> per-dim mesh axes (the port's copy of
``logical_axes_for_path`` and ``spec_for`` from
``repro.distributed.sharding``).

Parameters are matched by flat name against a rule table of *logical*
axes; logical axes resolve to mesh axes through a rules dict, each checked
for divisibility against the mesh (a dim that does not divide falls back to
replication).  A spec is a plain tuple with one entry per dim (``None``, an
axis name or a tuple of names), as ``jax.sharding.PartitionSpec`` holds
them, and a mesh is anything with a ``.shape`` mapping of axis sizes
(``checkpoint.sharded.MeshSpec``): a save's shard grid needs no devices.
"""

from __future__ import annotations

import re

import numpy as np

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
