"""Gradient compression with error feedback (the port's copy of
``repro.distributed.compress``).

:func:`ef_compress_update` quantizes the update stream to int8 codes with
blockwise scales (``compression/q8.py``) and keeps a persistent
per-parameter f32 error accumulator (EF-SGD): what a step's codes leave
out is added to the next step's gradient.  The accumulator is written in
place, as the port's AdamW writes its moments.  Wire bytes are accounted
by the entropy of the codes (:func:`code_entropy_bits_per_param`), the
rate a CABAC pass would approach.

:func:`cross_pod_psum_compressed` is the explicit collective: each pod
quantizes its partial sum to int8 codes and blockwise f32 scales,
all-gathers that payload over the pod axis's process group (about 1.03
bytes a value on the wire against 4 for f32), and every rank decodes and
sums all parts.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..compression.q8 import WHOLE_Q8, q8_decode, q8_encode
from ..compression.tree import flatten_tree, unflatten


@dataclass(frozen=True)
class CompressionConfig:
    enabled: bool = False
    ef_decay: float = 1.0          # error-feedback memory (1.0 = full EF)


def init_error_feedback(params):
    """Zero f32 accumulators shaped like ``params``, on their devices."""
    return unflatten({k: torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device)
                      for k, p in flatten_tree(params).items()})


def ef_compress_update(grads, ef, cfg: CompressionConfig, layout=None):
    """Returns (compressed grads, error-feedback state); the state's
    tensors are updated in place.  With ``layout``
    (``distributed.fsdp.StateLayout``) the tensors are this rank's boxes
    and their codes the whole leaf's (``layout.codec``)."""
    if not cfg.enabled:
        return grads, ef
    flat_e = flatten_tree(ef)
    out = {}
    for name, g in flatten_tree(grads).items():
        t = flat_e[name]
        t.mul_(cfg.ef_decay).add_(g.to(torch.float32))
        q8 = WHOLE_Q8 if layout is None else layout.codec(name)
        codes, scale = q8.encode(t)
        deq = q8.decode(codes, scale)
        del codes, scale
        t.sub_(deq)
        out[name] = deq.to(g.dtype)
    return unflatten(out), ef


def cross_pod_psum_compressed(x, mesh, pod_axis: str = "pod", *,
                              stats: dict | None = None):
    """Quantized hierarchical sum over the pod axis.

    Shape contract (explicit; validated): ``x`` is a DTensor on ``mesh``
    (a ``DeviceMesh``) whose **leading dim** has the global size
    ``mesh.size(pod_axis)`` and is sharded over ``pod_axis`` (``Shard(0)``
    there), so slice ``x[i]`` is pod *i*'s partial sum and each pod's
    local part is ``(1, ...)``.  The result, f32 as the reference's, has
    the same global shape and placements: every pod's slice holds the
    dequantized cross-pod sum.

    Payload on the wire: int8 codes + f32 scales per 128-block, about 1.03
    B/param against 4 B/param f32.  ``stats``, a dict, gains this rank's
    ``wire_bytes`` (codes plus scales it contributes to the all-gather)
    and ``elements`` (values of its part)."""
    from torch.distributed.tensor import DTensor, Shard

    from .sharding import check_mesh
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    if pod_axis not in names:
        raise ValueError(f"cross_pod_psum_compressed: the mesh {names} has "
                         f"no pod axis {pod_axis!r}")
    n_pods = mesh.size(names.index(pod_axis))
    if x.dim() < 1 or x.shape[0] != n_pods:
        raise ValueError(
            f"cross_pod_psum_compressed: leading axis of x {tuple(x.shape)} "
            f"must be the pod axis (size {n_pods}); got "
            f"{x.shape[0] if x.dim() else 'scalar'}")
    if not isinstance(x, DTensor) or x.device_mesh != mesh or \
            x.placements[names.index(pod_axis)] != Shard(0):
        raise ValueError(
            "cross_pod_psum_compressed: x must be a DTensor on the mesh "
            "with its leading axis sharded over the pod axis "
            f"{pod_axis!r}")
    local = x.to_local()
    check_mesh(mesh, local.device)
    # this pod's contribution without its size-1 pod slice, so the code
    # and scale shapes do not depend on the pod
    codes, scale = q8_encode(local[0].to(torch.float32))
    group = mesh.get_group(pod_axis)
    codes_all = _all_gather(codes, n_pods, group)
    scale_all = _all_gather(scale, n_pods, group)
    total = q8_decode(codes_all[0], scale_all[0])
    for i in range(1, n_pods):
        total = total + q8_decode(codes_all[i], scale_all[i])
    if stats is not None:
        stats["wire_bytes"] = stats.get("wire_bytes", 0) + \
            codes.numel() * codes.element_size() + \
            scale.numel() * scale.element_size()
        stats["elements"] = stats.get("elements", 0) + local[0].numel()
    return DTensor.from_local(total[None], mesh,
                              x.placements, run_check=False,
                              shape=x.shape, stride=x.stride())


def _all_gather(t: torch.Tensor, n: int, group) -> torch.Tensor:
    """``(n, *t.shape)``: every rank's ``t`` in group-rank order, gathered
    as flat buffers (gloo and NCCL take the same layout)."""
    out = torch.empty(n * t.numel(), dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out, t.reshape(-1).contiguous(), group=group)
    return out.view(n, *t.shape)


def code_entropy_bits_per_param(codes) -> float:
    """EPMD entropy of int8 codes — the wire rate a CABAC pass achieves
    (upper bound; context adaptation goes below)."""
    c = (codes.detach().cpu().numpy() if isinstance(codes, torch.Tensor)
         else np.asarray(codes)).ravel()
    _, counts = np.unique(c, return_counts=True)
    p = counts / counts.sum()
    return float(-(p * np.log2(p)).sum())
