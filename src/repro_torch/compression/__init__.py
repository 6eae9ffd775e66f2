from .quantizers import (  # noqa: F401
    quantize_leaf, quantize_tree_q8, serve_q8_policy)
from .tree import flatten_tree, unflatten  # noqa: F401
