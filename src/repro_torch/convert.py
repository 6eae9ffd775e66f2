"""Carry parameters across from numpy: ``params_from_numpy(flat, device)``
turns a flat ``{"a/b/c": ndarray}`` map (the reference's
``flatten_tree`` output, raw or q8) into the port's nested tree."""

from __future__ import annotations

import numpy as np
import torch

from .compression.tree import unflatten
from .kernels.registry import resolve_device


def tensor_from_numpy(arr: np.ndarray, device) -> torch.Tensor:
    """One array as a tensor on ``device``.  ``ml_dtypes.bfloat16`` arrays
    (which ``torch.from_numpy`` refuses) go through a uint16 view."""
    arr = np.array(arr, copy=True, order="C")   # never alias the caller's
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def params_from_numpy(flat: dict, device="cuda") -> dict:
    dev = resolve_device(device)
    return unflatten({name: tensor_from_numpy(arr, dev)
                      for name, arr in flat.items()})


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """The inverse of :func:`tensor_from_numpy` (bf16 -> ml_dtypes)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()
