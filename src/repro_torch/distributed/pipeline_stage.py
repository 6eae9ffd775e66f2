"""GPipe-style pipeline parallelism over a mesh axis (the port's copy of
``repro.distributed.pipeline_stage``, over ``torch.distributed``
point-to-point).

Layers split into ``S = |axis|`` stages, one per rank along the axis;
microbatches stream through the GPipe schedule: stage ``s`` runs
microbatch ``m`` at tick ``t = s + m``, over ``M + S - 1`` ticks (bubble
fraction ``(S - 1) / (M + S - 1)``).  As in the reference, every stage
runs ``stage_fn`` at every tick (stage 0 on the clamped microbatch, the
others on the carry they received, zeros before the first) and every
stage boundary carries exactly one send of the activations per tick, one
``batch_isend_irecv`` on the axis's group.  The last stage's outputs are
broadcast over the axis, so every rank returns the same ``(M, ...)``, as
the reference returns ``stacked[-1]``.  With ``S = 1`` the reference's
ppermute is a self-copy: the carry stays local (NCCL cannot send to its
own rank).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from ..compression.tree import flatten_tree, unflatten
from .sharding import check_mesh


def gpipe_apply(stage_fn: Callable, stage_params, x_mb: torch.Tensor,
                mesh, axis: str = "pod") -> torch.Tensor:
    """Run ``S`` parameter stages over ``M`` microbatches.

    ``stage_fn(params, x) -> y`` with x and y of one shape (a layer
    block).  ``stage_params``: a tree of tensors with a leading stage dim
    of size ``S = mesh.size(axis)``; this rank runs ``stage_params[sid]``,
    ``sid`` its coordinate on ``axis``.  ``x_mb``: ``(M, *batch_shape)``
    microbatches, the same on every rank.  Returns ``(M, *batch_shape)``,
    every microbatch after all ``S`` stages in order, on every rank."""
    check_mesh(mesh, x_mb.device)
    s = mesh.size(mesh.mesh_dim_names.index(axis))
    m = x_mb.shape[0]
    flat = flatten_tree(stage_params)
    for name, p in flat.items():
        if p.shape[0] != s:
            raise ValueError(f"stage_params/{name}: leading dim "
                             f"{p.shape[0]} != {s} stages on {axis!r}")
    group = mesh.get_group(axis)
    ranks = dist.get_process_group_ranks(group)
    sid = mesh.get_local_rank(axis)
    local = unflatten({k: p[sid] for k, p in flat.items()})

    carry = torch.zeros_like(x_mb[0])
    outputs = torch.zeros_like(x_mb)
    for t in range(m + s - 1):
        inp = x_mb[min(t, m - 1)] if sid == 0 else carry
        out = stage_fn(local, inp)
        m_idx = t - (s - 1)         # the last stage finishes it at tick t
        if sid == s - 1 and 0 <= m_idx < m:
            outputs[m_idx] = out
        if s == 1:
            carry = out
            continue
        ops = []
        if sid < s - 1:
            ops.append(dist.P2POp(dist.isend, out.contiguous(),
                                  ranks[sid + 1], group=group))
        if sid > 0:
            carry = torch.empty_like(out)
            ops.append(dist.P2POp(dist.irecv, carry, ranks[sid - 1],
                                  group=group))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    if s > 1:
        dist.broadcast(outputs, src=ranks[s - 1], group=group)
    return outputs


def split_stages(stacked_layers, n_stages: int):
    """Reshape (L, ...) stacked layer params into (S, L/S, ...) stages."""
    def r(a):
        return a.reshape(n_stages, a.shape[0] // n_stages, *a.shape[1:])
    return unflatten({k: r(a) for k, a in flatten_tree(stacked_layers)
                      .items()})
