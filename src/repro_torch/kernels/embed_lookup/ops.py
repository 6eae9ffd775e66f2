"""int8 embedding-row gather (port of ``repro.kernels.embed_lookup.ops``).

Not a kernel of its own: a torch index gather reads B*S int8 rows and
dequantizes them, so the (V, d) table is only ever read as int8."""

from __future__ import annotations

import torch


def is_q8_leaf(leaf) -> bool:
    return isinstance(leaf, dict) and "q8" in leaf and "q8s" in leaf


def embed_lookup_q8(embed_leaf, tokens: torch.Tensor,
                    dtype: torch.dtype) -> torch.Tensor:
    """Gather rows first, dequantize after."""
    if is_q8_leaf(embed_leaf):
        rows = embed_leaf["q8"][tokens]
        return (rows.to(torch.float32) * embed_leaf["q8s"]).to(dtype)
    return embed_leaf[tokens].to(dtype)
