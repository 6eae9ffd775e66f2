"""Nested parameter dicts <-> flat ``{"a/b/c": tensor}`` maps.

Flat names equal ``repro.compression.tree.flatten_tree`` output on the
reference's parameter trees (dict keys joined with "/"), so one set of
names addresses either package's parameters.  A ``None`` value is no leaf,
as in a JAX pytree (a train state's ``"ef": None``)."""

from __future__ import annotations

import torch


def flatten_tree(tree, prefix: str = "") -> dict:
    out = {}
    for key in sorted(tree):
        val = tree[key]
        name = f"{prefix}{key}"
        if val is None:
            continue
        if isinstance(val, dict):
            out.update(flatten_tree(val, name + "/"))
        else:
            out[name] = val
    return out


def unflatten(flat: dict) -> dict:
    tree: dict = {}
    for name, leaf in flat.items():
        *parents, last = name.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return tree


def unflatten_like(flat: dict, template: dict, device=None) -> dict:
    """Rebuild ``template``'s nested structure from a flat dict, moving
    each tensor to ``device`` (default: the template leaf's device) and
    the leaf's dtype, and checking shapes.
    Quantized representations (a record with ``dequantize`` that is not a
    tensor: every tensor has that method) are placed as they are; a
    ``DTensor`` stays on its mesh, cast to the leaf's dtype."""
    from torch.distributed.tensor import DTensor
    out = {}
    for key, leaf in flatten_tree(template).items():
        if key not in flat:
            raise KeyError(f"checkpoint missing tensor {key}")
        arr = flat[key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: checkpoint shape {tuple(arr.shape)} "
                             f"!= state {tuple(leaf.shape)}")
        if isinstance(arr, DTensor):
            out[key] = arr.to(leaf.dtype)
        elif not isinstance(arr, torch.Tensor) and hasattr(arr,
                                                           "dequantize"):
            out[key] = arr
        else:
            out[key] = arr.to(leaf.device if device is None else device,
                              leaf.dtype)
    return unflatten(out)
