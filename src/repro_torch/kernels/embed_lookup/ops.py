"""int8 embedding-row gather (port of ``repro.kernels.embed_lookup.ops``).

Not a kernel of its own: the ``gather`` impl, a torch index gather, reads
B*S int8 rows and dequantizes them, so the (V, d) table is only ever read
as int8; the ``ref`` impl dequantizes the whole table first.  Both orders
multiply the same rows by the same per-column scale, so the results are
bit-identical."""

from __future__ import annotations

import torch

from ..registry import Impl, OpSpec, register_op


def is_q8_leaf(leaf) -> bool:
    return isinstance(leaf, dict) and "q8" in leaf and "q8s" in leaf


def embed_lookup_q8(embed_leaf, tokens: torch.Tensor,
                    dtype: torch.dtype) -> torch.Tensor:
    """Gather rows first, dequantize after."""
    if is_q8_leaf(embed_leaf):
        rows = embed_leaf["q8"][tokens]
        return (rows.to(torch.float32) * embed_leaf["q8s"]).to(dtype)
    return embed_leaf[tokens].to(dtype)


def embed_lookup_ref(embed_leaf, tokens: torch.Tensor,
                     dtype: torch.dtype) -> torch.Tensor:
    """Dequantize-then-gather oracle (numerically identical)."""
    if is_q8_leaf(embed_leaf):
        table = embed_leaf["q8"].to(torch.float32) * embed_leaf["q8s"]
        return table[tokens].to(dtype)
    return embed_leaf[tokens].to(dtype)


def _shape_info(embed_leaf, tokens, dtype) -> dict:
    arr = embed_leaf["q8"] if is_q8_leaf(embed_leaf) else embed_leaf
    return {"vocab": arr.shape[0], "d": arr.shape[-1],
            "q8": is_q8_leaf(embed_leaf)}


@register_op
def _embed_lookup_spec() -> OpSpec:
    return OpSpec(
        name="embed_lookup_q8",
        impls={
            "gather": Impl("gather", embed_lookup_q8, uses_tiles=False),
            "ref": Impl("ref", embed_lookup_ref, uses_tiles=False),
        },
        defaults={"*": "gather"},
        fallbacks=("ref",),
        shape_info=_shape_info,
        oracle=embed_lookup_ref,
    )
