"""Optimizers of the port (the copy of ``repro.optim``)."""

from .adamw import AdamWConfig, adamw_init, adamw_update  # noqa: F401
from .schedule import cosine_schedule, linear_warmup_cosine  # noqa: F401
