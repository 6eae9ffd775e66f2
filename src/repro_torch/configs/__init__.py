"""Architecture registry of the port: ``get(name, smoke=)``, every
architecture the reference registers, in its order."""

from __future__ import annotations

import importlib

from ..models.config import ModelConfig

# the reference's registry order
ARCH_IDS = [
    "llama3-8b", "qwen1.5-4b", "mistral-nemo-12b", "qwen3-8b",
    "deepseek-v3-671b", "deepseek-moe-16b", "mamba2-2.7b",
    "musicgen-medium", "qwen2-vl-7b", "zamba2-2.7b",
]

# ids the reference knows whose path is not ported yet (none)
_NOT_YET_PORTED: list = []

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
