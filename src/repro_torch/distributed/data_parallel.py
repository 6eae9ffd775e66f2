"""The batch axes of a ``DeviceMesh`` as one data-parallel group.

The reference shards a step's batch over ``("pod", "data")`` and lets
XLA insert the collectives.  The port runs each rank on its own rows and
reduces explicitly: :class:`BatchGroup` names the rank's rows (the
global batch split evenly in rank order: pod-major, then data), sums and
averages tensors over the batch axes (one all-reduce per axis, so a mesh
with both ``pod`` and ``data`` needs no flattened group), gathers rows
back in order, and agrees on a flag or a barrier across the whole mesh.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from .sharding import check_mesh, mesh_axis_names, mesh_device


class _AllReduceSum(torch.autograd.Function):
    """Sum over ``groups`` (one all-reduce each) whose backward sums the
    incoming gradients the same way: the gradient of a replicated result
    with respect to each rank's part."""

    @staticmethod
    def forward(ctx, t, groups):
        ctx.groups = groups
        out = t.clone()
        for g in groups:
            dist.all_reduce(out, group=g)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = grad.clone()
        for g in ctx.groups:
            dist.all_reduce(out, group=g)
        return out, None


class BatchGroup:
    """``mesh``'s axes in ``batch_axes`` (``rules["batch"]``) as one group
    of ``size`` ranks; this rank is number ``index`` of it.  Every other
    axis of the mesh has size 1 (the callers refuse the rest)."""

    def __init__(self, mesh, batch_axes):
        names = mesh_axis_names(mesh)
        self.mesh = mesh
        self.axes = [a for a in names if a in batch_axes]
        sizes = [mesh.size(names.index(a)) for a in self.axes]
        self.size = math.prod(sizes)
        self.index = 0
        for a, n in zip(self.axes, sizes):
            self.index = self.index * n + mesh.get_local_rank(a)
        self.groups = [mesh.get_group(a) for a in self.axes]
        self.mesh_groups = [mesh.get_group(a) for a in names]
        self.first = all(c == 0 for c in mesh.get_coordinate())
        self._checked: set = set()

    def check(self, device) -> None:
        """``check_mesh`` of the mesh against ``device``, once a device."""
        dev = torch.device(device)
        if dev not in self._checked:
            check_mesh(self.mesh, dev)
            self._checked.add(dev)

    def rows(self, batch: dict) -> dict:
        """This rank's rows of a global batch (numpy arrays or tensors;
        ``pos3d`` carries its rows on axis 1)."""
        out = {}
        for k, v in batch.items():
            axis = 1 if k == "pos3d" else 0
            b = v.shape[axis]
            if b % self.size:
                raise ValueError(f"batch {k} of {b} rows does not split "
                                 f"over {self.size} ranks")
            n = b // self.size
            sl = slice(self.index * n, (self.index + 1) * n)
            out[k] = v[:, sl] if axis else v[sl]
        return out

    def _div(self, t: torch.Tensor) -> torch.Tensor:
        # a 0-d divisor: CUDA turns a Python scalar into a reciprocal product
        return t / torch.tensor(float(self.size), dtype=t.dtype,
                                device=t.device)

    def mean_(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the group in place, then divided by its
        size (no autograd)."""
        for g in self.groups:
            dist.all_reduce(t, group=g)
        return t.copy_(self._div(t))

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        """The group's mean of ``t``, differentiable: the gradient of
        each rank's part is the sum of every rank's gradient of the mean
        over the group size."""
        return self._div(_AllReduceSum.apply(t, self.groups))

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's rows (axis 0) in rank order, on every rank."""
        for g in reversed(self.groups):
            n = dist.get_world_size(g)
            out = torch.empty(n * t.numel(), dtype=t.dtype, device=t.device)
            dist.all_gather_into_tensor(out, t.reshape(-1).contiguous(),
                                        group=g)
            t = out.view(n * t.shape[0], *t.shape[1:])
        return t

    def any(self, flag: bool) -> bool:
        """True on every rank of the mesh when ``flag`` is on any."""
        t = torch.tensor([int(flag)], dtype=torch.int32,
                         device=mesh_device(self.mesh))
        for g in self.mesh_groups:
            dist.all_reduce(t, op=dist.ReduceOp.MAX, group=g)
        return bool(t.item())

    def barrier(self) -> None:
        self.any(False)
