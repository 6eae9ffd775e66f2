"""Carry parameters across from numpy: ``params_from_numpy(flat, device)``
turns a flat ``{"a/b/c": ndarray}`` map (the reference's
``flatten_tree`` output, raw or q8) into the port's nested tree.  bf16
goes through :mod:`repro_torch.arrays` (uint16 bits, no ``ml_dtypes``)."""

from __future__ import annotations

import numpy as np
import torch

from .arrays import from_storage, to_storage
from .compression.tree import unflatten
from .kernels.registry import resolve_device


def tensor_from_numpy(arr: np.ndarray, device) -> torch.Tensor:
    """One array as a tensor on ``device`` (an ``ml_dtypes.bfloat16``
    array becomes a bf16 tensor)."""
    return from_storage(arr).to(device)


def params_from_numpy(flat: dict, device="cuda") -> dict:
    dev = resolve_device(device)
    return unflatten({name: tensor_from_numpy(arr, dev)
                      for name, arr in flat.items()})


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host numpy copy of ``t``; a bf16 tensor comes back as its uint16
    bits (view them as ``ml_dtypes.bfloat16`` to talk to the reference)."""
    return to_storage(t)
