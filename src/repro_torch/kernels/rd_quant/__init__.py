from .ops import rd_quant  # noqa: F401
