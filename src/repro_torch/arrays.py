"""Host arrays of the port, without ``ml_dtypes``.

numpy has no bfloat16, so a bf16 tensor crosses to numpy and to bytes as
its bit pattern (a ``uint16`` view), and every dtype is named by the same
string the reference writes into DCBC records (``"float32"``,
``"bfloat16"``, ...).  Numpy arrays of ``ml_dtypes.bfloat16`` (the JAX
package's representation) are recognised by their dtype name, so this
module never imports ``ml_dtypes``.
"""

from __future__ import annotations

import numpy as np
import torch

BF16 = "bfloat16"

_TORCH_DTYPES = {
    "float64": torch.float64, "float32": torch.float32,
    "float16": torch.float16, BF16: torch.bfloat16,
    "int64": torch.int64, "int32": torch.int32, "int16": torch.int16,
    "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool,
}
_FLOAT_NAMES = frozenset({"float64", "float32", "float16", BF16})


def dtype_name(dt) -> str:
    """The record name of a torch dtype, a numpy dtype or a dtype name."""
    if isinstance(dt, torch.dtype):
        return str(dt).removeprefix("torch.")
    return str(np.dtype(dt)) if not isinstance(dt, str) else dt


def torch_dtype(name) -> torch.dtype:
    name = dtype_name(name)
    if name not in _TORCH_DTYPES:
        raise TypeError(f"dtype {name!r} has no torch counterpart here")
    return _TORCH_DTYPES[name]


def is_float_dtype(dt) -> bool:
    """True for the float dtypes, bfloat16 included."""
    return dtype_name(dt) in _FLOAT_NAMES


def to_storage(t: torch.Tensor) -> np.ndarray:
    """A host numpy copy of ``t``; bf16 comes back as its uint16 bits."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy()
    return t.numpy()


def from_storage(arr: np.ndarray, name: str | None = None) -> torch.Tensor:
    """A CPU tensor that owns a copy of ``arr``.  ``name`` (or an array of
    ``ml_dtypes.bfloat16``) marks uint16 bits as bf16."""
    arr = np.array(arr, copy=True, order="C")   # never alias the caller's
    if (name or arr.dtype.name) == BF16:
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def raw_bytes(arr) -> tuple[bytes, str]:
    """(payload, dtype name) of a raw record: the little-endian bytes of a
    torch tensor (any device) or numpy array, as the reference writes
    ``np.ascontiguousarray(arr).tobytes()``."""
    if isinstance(arr, torch.Tensor):
        return to_storage(arr).tobytes(), dtype_name(arr.dtype)
    arr = np.ascontiguousarray(arr)
    return arr.tobytes(), arr.dtype.name


def tensor_from_bytes(buf, name: str, shape) -> torch.Tensor:
    """Inverse of :func:`raw_bytes`: a CPU tensor of dtype ``name``."""
    np_dt = np.uint16 if name == BF16 else np.dtype(name)
    arr = np.frombuffer(buf, dtype=np_dt).reshape(tuple(shape))
    return from_storage(arr, name)


def cast_host(x: np.ndarray, name: str) -> torch.Tensor:
    """``x.astype(dtype)`` as the reference computes it, as a CPU tensor.
    bf16 rounds through f32 (two round-to-nearest-even steps), which is
    what ``ml_dtypes`` does for an f64 or f32 source."""
    if name == BF16:
        return torch.from_numpy(np.ascontiguousarray(
            x, dtype=np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(x.astype(np.dtype(name))))
