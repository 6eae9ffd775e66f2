"""String registry of codec factories: ``get("deepcabac-v3", delta=...)``
(the port's copy of ``repro.compression.registry``).

``get`` is the single entry point and, by default, strict: an override
the factory does not accept raises ``TypeError`` naming the accepted
parameters.  With ``strict=False`` unknown overrides are dropped and
recorded in ``hyperparams["dropped_overrides"]``.  Every codec the
reference registers is registered here under the same name.
"""

from __future__ import annotations

import inspect
from typing import Callable

from ..core import binarization as B
from ..core.codec import DEFAULT_CHUNK
from .coders import (CabacCoder, CabacDeltaCoder, CabacV3Coder, HuffmanCoder,
                     RawLevelCoder)
from .codec import Codec, DeltaCodec
from .quantizers import (NearestStdQuantizer, PerChannelInt8Quantizer,
                         RDGridQuantizer, ndim_float_policy, relative_step,
                         serve_q8_policy)

_REGISTRY: dict[str, Callable[..., Codec]] = {}


def register(name: str, factory: Callable[..., Codec]) -> None:
    _REGISTRY[name] = factory


def available() -> list[str]:
    return sorted(_REGISTRY)


def get(name: str, *, strict: bool = True, **overrides) -> Codec:
    """Build a registered codec, applying keyword overrides to its factory
    (``strict=False`` drops and records unknown overrides)."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown codec {name!r}; available: {available()}")
    factory = _REGISTRY[name]
    params = inspect.signature(factory).parameters
    dropped: list[str] = []
    unknown = sorted(set(overrides) - set(params))
    if unknown:
        if strict:
            raise TypeError(
                f"codec {name!r} does not accept override(s) "
                f"{unknown}; accepted: {sorted(params)} "
                f"(pass strict=False to forward a generic config and "
                f"record the drop)")
        dropped = unknown
        overrides = {k: v for k, v in overrides.items() if k not in unknown}
    codec = factory(**overrides)
    if dropped:
        codec.hyperparams = {**codec.hyperparams,
                             "dropped_overrides": dropped}
    return codec


# ---------------------------------------------------------------------------
# Built-in codecs
# ---------------------------------------------------------------------------

def _rd_grid_quantizer(delta: float, delta_rel: float | None, lam: float,
                       num_gr: int) -> tuple[RDGridQuantizer, dict]:
    """A global ``delta``, or — with ``delta_rel`` — the per-tensor
    relative step Delta = delta_rel * std(w)."""
    if delta_rel is not None:
        quantizer = RDGridQuantizer(
            lam=lam, num_gr=num_gr,
            step_for=lambda name, w: relative_step(w, delta_rel))
        return quantizer, {"delta_rel": delta_rel, "lam": lam,
                           "num_gr": num_gr}
    return (RDGridQuantizer(delta=delta, lam=lam, num_gr=num_gr),
            {"delta": delta, "lam": lam, "num_gr": num_gr})


def _deepcabac_v2(delta: float = 0.01, lam: float = 0.0,
                  num_gr: int = B.DEFAULT_NUM_GR, min_ndim: int = 2,
                  chunk_size: int = DEFAULT_CHUNK,
                  delta_rel: float | None = None) -> Codec:
    """Paper DC-v2: global-Delta RD grid (eq. 11) + chunk-parallel CABAC."""
    quantizer, hyperparams = _rd_grid_quantizer(delta, delta_rel, lam, num_gr)
    return Codec("deepcabac-v2",
                 coder=CabacCoder(num_gr=num_gr, chunk_size=chunk_size),
                 quantizer=quantizer, policy=ndim_float_policy(min_ndim),
                 hyperparams=hyperparams)


def _deepcabac_v3(delta: float = 0.01, lam: float = 0.0,
                  num_gr: int = B.DEFAULT_NUM_GR, min_ndim: int = 2,
                  chunk_size: int = DEFAULT_CHUNK,
                  delta_rel: float | None = None,
                  backend: str = "auto") -> Codec:
    """DC-v2 quantization + lane-scheduled CABAC (container v3)."""
    quantizer, hyperparams = _rd_grid_quantizer(delta, delta_rel, lam, num_gr)
    return Codec("deepcabac-v3",
                 coder=CabacV3Coder(num_gr=num_gr, chunk_size=chunk_size,
                                    backend=backend),
                 quantizer=quantizer, policy=ndim_float_policy(min_ndim),
                 hyperparams=hyperparams)


def _deepcabac_rd(policy_table=None, num_gr: int = B.DEFAULT_NUM_GR,
                  min_ndim: int = 2, chunk_size: int = DEFAULT_CHUNK,
                  backend: str = "auto", assign: str = "auto") -> Codec:
    """Per-tensor mixed precision from a :class:`TensorPolicy` table: each
    covered tensor is RD-assigned on its own (step, lambda) through
    ``rd_assign_levels`` (``assign="auto"``: the ``rd_quant`` kernel for
    tensors on the card, the host oracle for tensors on the CPU);
    uncovered tensors stay raw; records are lane-scheduled v3."""
    from .rd_search import PolicyQuantizer, resolve_policy
    if policy_table is None:
        raise ValueError(
            "deepcabac-rd needs policy_table= (a TensorPolicy, its dict "
            "form, or a JSON path)")
    table = resolve_policy(policy_table)
    base_policy = ndim_float_policy(min_ndim)

    def policy(name, w):
        return table.rule_for(name) is not None and base_policy(name, w)

    return Codec("deepcabac-rd",
                 coder=CabacV3Coder(num_gr=num_gr, chunk_size=chunk_size,
                                    backend=backend),
                 quantizer=PolicyQuantizer(table=table, num_gr=num_gr,
                                           assign=assign),
                 policy=policy,
                 hyperparams={"num_gr": num_gr,
                              "policy_tensors": len(table.rules),
                              **({"policy_meta": dict(table.meta)}
                                 if table.meta else {})})


def _ckpt_nearest(delta_rel: float = 1e-3, min_ndim: int = 2,
                  num_gr: int = B.DEFAULT_NUM_GR,
                  chunk_size: int = DEFAULT_CHUNK) -> Codec:
    """Checkpoint codec: nearest level on Delta = delta_rel * std(w) +
    CABAC."""
    return Codec("ckpt-nearest",
                 coder=CabacCoder(num_gr=num_gr, chunk_size=chunk_size),
                 quantizer=NearestStdQuantizer(delta_rel=delta_rel),
                 policy=ndim_float_policy(min_ndim),
                 hyperparams={"delta_rel": delta_rel})


def _serve_q8() -> Codec:
    """Fixed-point serving artifact: per-out-channel int8 levels + scales,
    stored raw."""
    return Codec("serve-q8", coder=RawLevelCoder(),
                 quantizer=PerChannelInt8Quantizer(), policy=serve_q8_policy)


def _huffman(delta_rel: float = 1e-3, min_ndim: int = 2) -> Codec:
    """Scalar Huffman baseline (paper §IV-B-2): the checkpoint codec's
    nearest-level grid, coded with an explicit two-part Huffman code."""
    return Codec("huffman",
                 coder=HuffmanCoder(),
                 quantizer=NearestStdQuantizer(delta_rel=delta_rel),
                 policy=ndim_float_policy(min_ndim),
                 hyperparams={"delta_rel": delta_rel})


def _deepcabac_delta(delta_rel: float = 1e-3, min_ndim: int = 2,
                     num_gr: int = B.DEFAULT_NUM_GR,
                     chunk_size: int = DEFAULT_CHUNK,
                     backend: str = "auto") -> DeltaCodec:
    """Temporal delta ("P-frame") codec: ``compress`` is a nearest-level
    keyframe codec with lane-scheduled v3 records; ``compress_delta``
    quantizes a new frame on the base frame's grids and codes the
    integer-level residuals with temporal-context CABAC (container v4).
    The chain linkage lives in the delta manifest
    (``repro_torch.checkpoint.delta``)."""
    return DeltaCodec(
        "deepcabac-delta",
        coder=CabacV3Coder(num_gr=num_gr, chunk_size=chunk_size,
                           backend=backend),
        quantizer=NearestStdQuantizer(delta_rel=delta_rel),
        policy=ndim_float_policy(min_ndim),
        hyperparams={"delta_rel": delta_rel, "num_gr": num_gr,
                     "chunk_size": chunk_size},
        delta_coder=CabacDeltaCoder(num_gr=num_gr, chunk_size=chunk_size,
                                    backend=backend))


def _raw() -> Codec:
    """Lossless passthrough — every leaf stored verbatim."""
    return Codec("raw")


def _kv_q8_cabac(step: float = 1.0, num_gr: int = B.DEFAULT_NUM_GR,
                 chunk_size: int | None = None, backend: str = "auto"):
    """KV-cache page codec (the paged serving cache's eviction format):
    int8 cache pages CABAC-coded losslessly, float pages q8
    block-quantized first (``compression.q8``) with raw f32 scale
    records.  Not a tree-policy :class:`Codec` (pages are dense
    activation tiles); it has the same ``compress``/``decompress``
    surface.  See :mod:`repro_torch.compression.kv_pages`."""
    from .kv_pages import KV_PAGE_CHUNK, KVPageCodec
    return KVPageCodec(step=step, num_gr=num_gr,
                       chunk_size=KV_PAGE_CHUNK if chunk_size is None
                       else chunk_size, backend=backend)


register("deepcabac-v2", _deepcabac_v2)
register("deepcabac-delta", _deepcabac_delta)
register("deepcabac-v3", _deepcabac_v3)
register("deepcabac-rd", _deepcabac_rd)
register("ckpt-nearest", _ckpt_nearest)
register("serve-q8", _serve_q8)
register("huffman", _huffman)
register("raw", _raw)
register("kv-q8-cabac", _kv_q8_cabac)
