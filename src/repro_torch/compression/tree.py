"""Nested parameter dicts <-> flat ``{"a/b/c": tensor}`` maps.

Flat names equal ``repro.compression.tree.flatten_tree`` output on the
reference's parameter trees (dict keys joined with "/"), so one set of
names addresses either package's parameters."""

from __future__ import annotations


def flatten_tree(tree, prefix: str = "") -> dict:
    out = {}
    for key in sorted(tree):
        val = tree[key]
        name = f"{prefix}{key}"
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
    Quantized representations (anything with ``dequantize``) are placed
    as they are."""
    out = {}
    for key, leaf in flatten_tree(template).items():
        if key not in flat:
            raise KeyError(f"checkpoint missing tensor {key}")
        arr = flat[key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: checkpoint shape {tuple(arr.shape)} "
                             f"!= state {tuple(leaf.shape)}")
        out[key] = (arr if hasattr(arr, "dequantize")
                    else arr.to(leaf.device if device is None else device,
                                leaf.dtype))
    return unflatten(out)
