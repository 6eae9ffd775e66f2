"""Architecture registry of the port: ``get(name, smoke=)``.

Only the architectures whose path has been ported are registered; every
other id the reference knows raises "not yet ported"."""

from __future__ import annotations

import importlib

from ..models.config import ModelConfig

# the reference's registry order, less the SSM and hybrid architectures
ARCH_IDS = [
    "llama3-8b", "qwen1.5-4b", "mistral-nemo-12b", "qwen3-8b",
    "deepseek-v3-671b", "deepseek-moe-16b", "musicgen-medium",
    "qwen2-vl-7b",
]

# the reference's other architectures, queued for a later slice
_NOT_YET_PORTED = ["mamba2-2.7b", "zamba2-2.7b"]

_MOD = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def names() -> list[str]:
    """Registered architecture ids, in registry order."""
    return list(ARCH_IDS)


def get(name: str, *, smoke: bool = False) -> ModelConfig:
    """Look up a ported architecture config by string id; ``smoke=True``
    returns the tiny CPU-runnable variant."""
    if name in _NOT_YET_PORTED:
        raise NotImplementedError(f"config {name!r}: not yet ported")
    if name not in _MOD:
        raise KeyError(
            f"unknown config {name!r}; available: {', '.join(ARCH_IDS)}")
    mod = importlib.import_module(f".{_MOD[name]}", __name__)
    return mod.SMOKE if smoke else mod.CONFIG
