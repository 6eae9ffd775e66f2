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
    "register_backend": "backends",
    "KVColdStore": "backends",
    "get_kv_store": "backends",
    "register_kv_store": "backends",
    "available_kv_stores": "backends",
    "PagedKV": "kv",
    "kv_cache_bytes": "kv",
    "ShardStore": "zoo",
    "ModelZoo": "zoo",
    "ZooConfig": "zoo",
    "ZooRouter": "zoo",
    "ZooHandle": "zoo",
    "ZooError": "zoo",
    "AdmissionStall": "zoo",
    "model_resident_bytes": "zoo",
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    submodule = _LAZY.get(name)
    if submodule is None:
        raise AttributeError(name)
    import importlib
    return getattr(importlib.import_module(f".{submodule}", __name__), name)
