from .ops import attention, flash_attention  # noqa: F401
