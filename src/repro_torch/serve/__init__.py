# The serving classes load lazily (PEP 562): models.transformer imports
# serve.quantized, and session/backends import the model back.

_LAZY = {
    "ServeEngine": "engine",
    "ServeSession": "session",
    "ServeConfig": "session",
    "RequestHandle": "session",
    "eager_steps": "graphs",
    "StepGraphs": "graphs",
    "WeightBackend": "backends",
    "get_backend": "backends",
    "available_backends": "backends",
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    submodule = _LAZY.get(name)
    if submodule is None:
        raise AttributeError(name)
    import importlib
    return getattr(importlib.import_module(f".{submodule}", __name__), name)
