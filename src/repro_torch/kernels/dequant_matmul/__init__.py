from .ops import dequant_matmul, dequant_matmul_grouped  # noqa: F401
