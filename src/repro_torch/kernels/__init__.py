"""Kernels of the port, behind one registry (``registry.py``; the
reference's ``repro.kernels`` API):

    rd_quant               eq. (11) RD assignment (encoder hot-spot)
    dequant_matmul         int8-level dequantize fused into the serving
                           matmul
    dequant_matmul_grouped the same, one product per MoE expert
    flash_attention        causal attention (cuda / scan / ref)
    embed_lookup_q8        int8 embedding-row gather (a torch gather)

The first four are hand-written CUDA C++ for sm_90a (``*/csrc/*.cu``,
built by ``_build`` on first use); each keeps its plain PyTorch version
beside it.  Each subpackage's ``ops.py`` holds the wrapper and registers
the op's ``OpSpec``.  Call sites outside this package go through
``kernels.get(name)(..., policy=cfg.kernels)``; direct subpackage imports
are for tests and benchmarks.  ``tune.py`` holds the autotuner and its
persistent cache."""

from . import registry, tune  # noqa: F401  (registry first: specs need it)
from .registry import (  # noqa: F401
    DEFAULT_POLICY, BoundOp, DispatchPlan, Impl, KernelDispatchError,
    KernelPolicy, OpSpec, available_ops, clear_dispatch_report,
    dispatch_report, get, launch_counts, record_event, register_op,
    reset_launch_counts, resolve_device, spec)
from .tune import TuningCache, autotune  # noqa: F401

# importing the subpackages registers their OpSpecs
from .dequant_matmul import dequant_matmul, dequant_matmul_grouped  # noqa: F401
from .embed_lookup import embed_lookup_q8, is_q8_leaf  # noqa: F401
from .flash_attention import flash_attention  # noqa: F401
from .rd_quant import pack_coeffs, rd_quant  # noqa: F401
