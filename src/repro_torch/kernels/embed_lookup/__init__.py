from .ops import embed_lookup_q8, is_q8_leaf  # noqa: F401
