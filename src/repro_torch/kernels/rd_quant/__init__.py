from .coeffs import pack_coeffs  # noqa: F401
from .ops import rd_quant  # noqa: F401
