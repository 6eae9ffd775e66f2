"""Serving weight backends (port of the in-memory part of
``repro.serve.backends``).

    ``bf16``  full-precision leaves: the tree passes through.
    ``q8``    fixed-point serving: eligible matmul weights become
              ``{"q8", "q8s"}`` leaves that every projection and the
              untied head read through ``dequant_matmul``.

Both take in-memory parameter trees.  DCBC container blobs and sharded
manifests need the host codec, which is not ported yet: they raise."""

from __future__ import annotations

import os

from .quantized import quantize_tree_q8

_NOT_PORTED = "container backend: not yet ported"


class WeightBackend:
    """Strategy interface: one weight source -> serving parameter tree."""

    name = "?"

    def load(self, cfg, source):
        raise NotImplementedError

    @staticmethod
    def _check_source(source) -> None:
        if isinstance(source, (bytes, bytearray, memoryview, str,
                               os.PathLike)):
            raise NotImplementedError(_NOT_PORTED)
        if not isinstance(source, dict):
            raise TypeError(f"weight source must be a parameter dict; got "
                            f"{type(source).__name__}")


class Bf16Backend(WeightBackend):
    name = "bf16"

    def load(self, cfg, source):
        self._check_source(source)
        return source


class Q8Backend(WeightBackend):
    name = "q8"

    def load(self, cfg, source):
        self._check_source(source)
        return quantize_tree_q8(source)


_BACKENDS: dict = {"bf16": Bf16Backend, "q8": Q8Backend}


def available_backends() -> list[str]:
    return sorted(_BACKENDS)


def get_backend(name: str) -> WeightBackend:
    if name == "container":
        raise NotImplementedError(_NOT_PORTED)
    if name not in _BACKENDS:
        raise KeyError(f"unknown weight backend {name!r}; available: "
                       f"{available_backends()}")
    return _BACKENDS[name]()


def resolve_backend(backend) -> WeightBackend:
    if isinstance(backend, WeightBackend):
        return backend
    return get_backend(backend)
