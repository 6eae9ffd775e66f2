"""Compression API of the port (quantizer x entropy coder), the copy of
``repro.compression``:

    from repro_torch import compression
    art = compression.get("deepcabac-rd", policy_table=table).compress(params)
    tree = compression.decompress(art.blob, like=params)

Registered codecs: ``deepcabac-v2``, ``deepcabac-v3``, ``deepcabac-rd``,
``deepcabac-delta``, ``ckpt-nearest``, ``serve-q8``, ``huffman``, ``raw``
and ``kv-q8-cabac`` (KV pages, ``kv_pages``).  The strategy and registry
modules load lazily, so ``models`` can import the q8 quantizer without
pulling in the codec."""

from .q8 import (Q8_BLOCK, q8_blockable, q8_decode,  # noqa: F401
                 q8_decode_sqrt, q8_encode, q8_encode_sqrt, q8_scale_shape)
from .quantizers import (  # noqa: F401
    quantize_leaf, quantize_tree_q8, serve_q8_policy)
from .tree import flatten_tree, unflatten, unflatten_like  # noqa: F401

_LAZY = {
    "Artifact": "artifact",
    "Codec": "codec",
    "DeltaCodec": "codec",
    "decompress": "codec",
    "iter_decompress": "codec",
    "DecodeOptions": "codec",
    "EntropyCoder": "coders",
    "CabacCoder": "coders",
    "CabacV3Coder": "coders",
    "CabacDeltaCoder": "coders",
    "HuffmanCoder": "coders",
    "RawLevelCoder": "coders",
    "KVPageCodec": "kv_pages",
    "Quantizer": "quantizers",
    "RDGridQuantizer": "quantizers",
    "NearestStdQuantizer": "quantizers",
    "PerChannelInt8Quantizer": "quantizers",
    "PolicyFn": "quantizers",
    "ndim_float_policy": "quantizers",
    "relative_step": "quantizers",
    "get": "registry",
    "register": "registry",
    "available": "registry",
    "TensorRule": "rd_search",
    "TensorPolicy": "rd_search",
    "PolicyQuantizer": "rd_search",
    "resolve_policy": "rd_search",
    "rd_assign_levels": "rd_search",
    "TaskProxy": "rd_search",
    "RDSearchConfig": "rd_search",
    "RDPoint": "rd_search",
    "RDSweepResult": "rd_search",
    "pareto_front": "rd_search",
    "fisher_for": "rd_search",
    "rd_sweep": "rd_search",
}


def __getattr__(name: str):
    submodule = _LAZY.get(name)
    if submodule is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(f".{submodule}", __name__), name)
