"""Dispatch bookkeeping of the port's kernels (lean counterpart of
``repro.kernels.registry``).

Two records make a run's path visible:

* the event report — constraint-driven fallbacks and loop-body
  dequantizes, with the reference's record schema
  ({op, platform, requested, impl, reason, kind});
* one plain-integer launch counter per hand-written kernel, bumped by the
  kernel's wrapper at the point where it launches the CUDA kernel and
  nowhere else.  A CUDA-graph capture launches nothing, so the launches
  its wrappers count are taken back (:func:`captured_launches`), and
  every replay of the graph credits them (:func:`credit_launches`): a
  replay runs no Python.

Tuning and per-op impl pins are not ported yet."""

from __future__ import annotations

import contextlib
from collections import deque

import torch

_REPORT: deque = deque(maxlen=512)

# kernel name -> launches since the last reset_launch_counts()
LAUNCHES: dict[str, int] = {"dequant_matmul": 0,
                             "dequant_matmul_grouped": 0,
                             "flash_attention": 0, "rd_quant": 0}


def dispatch_report() -> list[dict]:
    """Fallbacks and loop-dequant events observed so far (most recent
    last).  Each record: {op, platform, requested, impl, reason, kind}."""
    return list(_REPORT)


def clear_dispatch_report() -> None:
    _REPORT.clear()


def record_event(*, op: str, platform: str, impl: str, reason: str,
                 requested: str | None = None, kind: str = "event") -> None:
    """Append one event (``kind`` is "fallback", "loop_dequant", ...)."""
    _REPORT.append({"op": op, "platform": platform, "requested": requested,
                    "impl": impl, "reason": reason, "kind": kind})


def count_launch(name: str) -> None:
    LAUNCHES[name] += 1


def launch_counts() -> dict[str, int]:
    return dict(LAUNCHES)


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@contextlib.contextmanager
def captured_launches():
    """Take the launches counted inside the block back out of the counts
    and hand them to the caller in the dict this yields ({kernel: n}, the
    kernels launched only): the block is a CUDA-graph capture, which runs
    no kernel."""
    before = dict(LAUNCHES)
    taken: dict[str, int] = {}
    try:
        yield taken
    finally:
        for name, n in before.items():
            if LAUNCHES[name] != n:
                taken[name] = LAUNCHES[name] - n
            LAUNCHES[name] = n


def credit_launches(counts: dict[str, int]) -> None:
    """Count the launches of one replay of a captured graph."""
    for name, n in counts.items():
        LAUNCHES[name] += n


def platform_of(t: torch.Tensor) -> str:
    return "cuda" if t.is_cuda else "cpu"


def resolve_device(device) -> torch.device:
    """Entry points run on the card unless the caller asks for the CPU.
    Asking for a card that is not there raises: nothing carries on on the
    CPU behind the caller's back."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev
