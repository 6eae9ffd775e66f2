from .ops import dequant_matmul  # noqa: F401
