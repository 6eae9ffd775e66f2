"""Mesh shapes (the port's copy of ``repro.launch.mesh``).

The reference builds ``jax.make_mesh`` device meshes; the port's
``make_*_mesh`` build the device-free shape, a
``checkpoint.sharded.MeshSpec`` (axis names and sizes), which is what the
sharding rules and a sharded save need.  :func:`device_mesh` places such
a shape on the current ``torch.distributed`` world as a ``DeviceMesh``
(one rank per device)."""

from __future__ import annotations

from ..checkpoint.sharded import MeshSpec


def make_production_mesh(*, multi_pod: bool = False) -> MeshSpec:
    """16x16 = 256 chips per pod; 2 pods = 512 chips multi-pod."""
    if multi_pod:
        return MeshSpec(("pod", "data", "model"), (2, 16, 16))
    return MeshSpec(("data", "model"), (16, 16))


def make_local_mesh(data: int = 1, model: int = 1,
                    pod: int | None = None) -> MeshSpec:
    """Small mesh for tests and examples."""
    if pod:
        return MeshSpec(("pod", "data", "model"), (pod, data, model))
    return MeshSpec(("data", "model"), (data, model))


def device_mesh(spec, device):
    """The ``DeviceMesh`` of ``spec`` (a ``MeshSpec`` or axis-size dict)
    over the current process group, on ``device``'s type (``"cuda"``:
    each rank on its ``torch.cuda.current_device()``), with the spec's
    axis names.  The world must hold exactly ``spec.size`` ranks, and a
    CUDA mesh NCCL groups (``distributed.sharding.check_mesh``)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from ..distributed.sharding import check_mesh
    spec = MeshSpec.from_any(spec)
    if not dist.is_initialized():
        raise RuntimeError("device_mesh needs an initialised process group")
    if dist.get_world_size() != spec.size:
        raise ValueError(f"the world has {dist.get_world_size()} ranks but "
                         f"the mesh {spec.shape} has {spec.size}")
    dev = torch.device(device)
    mesh = init_device_mesh(dev.type, tuple(spec.axis_sizes),
                            mesh_dim_names=tuple(spec.axis_names))
    check_mesh(mesh, dev)
    return mesh
