"""Kernels of the port.  ``dequant_matmul``, ``dequant_matmul_grouped``,
``flash_attention`` and ``rd_quant`` are hand-written CUDA C++ for sm_90a
(``*/csrc/*.cu``, built by ``_build`` on first use); each keeps its plain
PyTorch version beside it for CPU tensors.  ``embed_lookup_q8`` is a torch
gather."""

from .registry import (  # noqa: F401
    clear_dispatch_report, dispatch_report, launch_counts, record_event,
    reset_launch_counts, resolve_device)
from .dequant_matmul import dequant_matmul, dequant_matmul_grouped  # noqa: F401
from .embed_lookup import embed_lookup_q8, is_q8_leaf  # noqa: F401
from .flash_attention import attention, flash_attention  # noqa: F401
from .rd_quant import rd_quant  # noqa: F401
