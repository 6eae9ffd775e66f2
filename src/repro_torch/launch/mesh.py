"""Mesh shapes (the port's copy of ``repro.launch.mesh``).

The reference builds ``jax.make_mesh`` device meshes; the port builds the
device-free shape, a ``checkpoint.sharded.MeshSpec`` (axis names and
sizes), which is what the sharding rules and a sharded save need.
Placement on a mesh of cards waits for the distribution slice."""

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
