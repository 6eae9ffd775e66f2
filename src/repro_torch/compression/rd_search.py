"""Per-tensor RD operating points and their level assignment (the port's
copy of ``TensorRule``, ``TensorPolicy``, ``resolve_policy``,
``rd_assign_levels`` and ``PolicyQuantizer`` from
``repro.compression.rd_search``; the Pareto sweep itself waits).

A :class:`TensorPolicy` maps each flat tensor name to its own (step,
lambda, quantizer kind); the ``deepcabac-rd`` codec and the serving
backends' ``policy_table=`` consume it.  :func:`rd_assign_levels` routes
the eq. (11) assignment: through the ``rd_quant`` kernel for a tensor on
the card, through the numpy f64 oracle on the host otherwise.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

import numpy as np
import torch

from ..arrays import dtype_name
from ..core import binarization as B
from ..core.codec import QuantizedTensor
from ..core.quant import nearest_level, rd_assign
from ..core.rate_model import (build_rate_table, estimate_bin_probs,
                               estimate_bin_probs_torch)
from .quantizers import PerChannelInt8Quantizer, Quantizer, host_f64

RULE_KINDS = ("rd-grid", "q8", "raw")
POLICY_FORMAT = "repro-tensor-policy"
POLICY_VERSION = 1
NEAREST_CHUNK = 1 << 26


@dataclass(frozen=True)
class TensorRule:
    """One tensor's operating point: grid step, RD lambda, quantizer kind
    (``rd-grid`` | ``q8`` | ``raw``)."""

    step: float
    lam: float = 0.0
    kind: str = "rd-grid"

    def __post_init__(self):
        if self.kind not in RULE_KINDS:
            raise ValueError(f"unknown rule kind {self.kind!r}; "
                             f"expected one of {RULE_KINDS}")


@dataclass
class TensorPolicy:
    """Flat-name -> :class:`TensorRule` table + provenance metadata; its
    JSON form is the reference's, so one file serves both packages."""

    rules: dict[str, TensorRule] = field(default_factory=dict)
    meta: dict = field(default_factory=dict)

    def rule_for(self, name: str) -> TensorRule | None:
        return self.rules.get(name)

    def to_dict(self) -> dict:
        return {
            "format": POLICY_FORMAT,
            "version": POLICY_VERSION,
            "meta": dict(self.meta),
            "rules": {name: {"step": r.step, "lam": r.lam, "kind": r.kind}
                      for name, r in sorted(self.rules.items())},
        }

    @classmethod
    def from_dict(cls, d: dict) -> "TensorPolicy":
        if d.get("format") != POLICY_FORMAT:
            raise ValueError(
                f"not a tensor-policy payload (format="
                f"{d.get('format')!r}, want {POLICY_FORMAT!r})")
        if int(d.get("version", -1)) > POLICY_VERSION:
            raise ValueError(
                f"tensor-policy version {d['version']} is newer than "
                f"this reader ({POLICY_VERSION})")
        rules = {name: TensorRule(step=float(r["step"]),
                                  lam=float(r.get("lam", 0.0)),
                                  kind=str(r.get("kind", "rd-grid")))
                 for name, r in d.get("rules", {}).items()}
        return cls(rules=rules, meta=dict(d.get("meta", {})))

    def save(self, path: str | os.PathLike) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, sort_keys=True)

    @classmethod
    def load(cls, path: str | os.PathLike) -> "TensorPolicy":
        with open(path) as f:
            return cls.from_dict(json.load(f))


def resolve_policy(obj) -> TensorPolicy:
    """Coerce a :class:`TensorPolicy`, its ``to_dict`` payload, or a JSON
    path."""
    if isinstance(obj, TensorPolicy):
        return obj
    if isinstance(obj, dict):
        return TensorPolicy.from_dict(obj)
    if isinstance(obj, (str, os.PathLike)):
        return TensorPolicy.load(obj)
    raise TypeError(
        f"policy_table must be a TensorPolicy, dict payload, or JSON "
        f"path; got {type(obj).__name__}")


# ---------------------------------------------------------------------------
# Level assignment: one entry point over the kernel and the host oracle
# ---------------------------------------------------------------------------

def _use_kernel(assign: str, w: torch.Tensor) -> bool:
    if assign == "host":
        return False
    if assign == "kernel":
        return True
    if assign != "auto":
        raise ValueError(f"assign must be auto|kernel|host, got {assign!r}")
    return w.is_cuda


def nearest_level_f64(flat: torch.Tensor, step: float
                      ) -> tuple[torch.Tensor, int]:
    """``rint(w / step)`` in f64 on ``flat``'s device, chunked, as int32,
    with max|level| — the host oracle's seed, where the weights are."""
    step_t = torch.tensor(step, dtype=torch.float64, device=flat.device)
    out = torch.empty(flat.numel(), dtype=torch.int32, device=flat.device)
    amax = torch.zeros((), dtype=torch.float64, device=flat.device)
    for s in range(0, flat.numel(), NEAREST_CHUNK):
        lv = torch.round(flat[s:s + NEAREST_CHUNK].to(torch.float64)
                         / step_t)
        amax = torch.maximum(amax, lv.abs().max())
        out[s:s + NEAREST_CHUNK] = lv.to(torch.int32)
    amax = float(amax)
    if amax >= 2 ** 31:
        raise ValueError(f"nearest level {amax:.0f} exceeds int32; the "
                         f"step {step} is too fine for this tensor")
    return out, int(amax)


def rd_assign_levels(w: torch.Tensor, step: float, lam: float,
                     fim: torch.Tensor | None = None, *,
                     num_gr: int = B.DEFAULT_NUM_GR, assign: str = "auto",
                     window: int = 4, passes: int = 2,
                     refinements: int = 1) -> torch.Tensor:
    """Eq.-11 level assignment: nearest-level seed -> statistics ->
    assignment, ``1 + refinements`` times.

    ``assign="auto"`` takes the ``rd_quant`` kernel for a CUDA tensor and
    the numpy f64 oracle (``core.quant.rd_assign``) for a CPU tensor;
    ``"kernel"`` takes the kernel op (on a CPU tensor, its plain
    version); ``"host"`` always the oracle.  On the kernel route the seed
    (the first statistics and ``max_level = max|nn| + window + 1``) is
    the f64 nearest level, computed where ``w`` is; each pass recomputes
    its own f32 nearest level; levels stay on the device between passes
    and refinements, and only the statistics' counts come to the host.
    Returns levels with ``w``'s shape: int32 on ``w``'s device (kernel
    route) or int64 on the host (oracle).
    """
    shape = tuple(w.shape)
    if not _use_kernel(assign, w):
        flat = host_f64(w).ravel()
        nn = nearest_level(flat, step)
        if lam == 0.0:
            return torch.from_numpy(nn.reshape(shape))
        max_level = int(np.abs(nn).max()) + window + 1
        fl = None if fim is None else host_f64(fim).ravel()
        levels = nn
        for _ in range(1 + max(refinements, 0)):
            table = build_rate_table(estimate_bin_probs(levels, num_gr),
                                     max_level)
            levels = rd_assign(flat, fl, step, lam, table, window=window,
                               max_level=max_level, passes=passes)
        return torch.from_numpy(levels.reshape(shape))
    from ..kernels.rd_quant import rd_quant
    flat = w.reshape(-1)
    nn, amax = nearest_level_f64(flat, step)
    if lam == 0.0:
        return nn.reshape(shape)        # RD reduces to nearest-neighbour
    max_level = amax + window + 1
    fl = None if fim is None else fim.reshape(-1).to(w.device, torch.float32)
    levels = nn
    for _ in range(1 + max(refinements, 0)):
        probs = estimate_bin_probs_torch(levels, num_gr)
        del levels                        # one level buffer at a time
        levels = rd_quant(flat, fl, probs, step=step, lam=lam,
                          window=window, max_level=max_level, passes=passes)
    return levels.reshape(shape)


@dataclass
class PolicyQuantizer(Quantizer):
    """Per-tensor mixed precision: each leaf is quantized on its
    :class:`TensorRule` — ``rd-grid`` through :func:`rd_assign_levels` at
    the rule's own (step, lambda), ``q8`` through the per-channel int8
    serving quantizer.  The ``deepcabac-rd`` codec's policy keeps
    uncovered and ``raw`` leaves away from here."""

    table: TensorPolicy = field(default_factory=TensorPolicy)
    num_gr: int = B.DEFAULT_NUM_GR
    assign: str = "auto"
    window: int = 4
    passes: int = 2
    refinements: int = 1

    def quantize(self, name: str, w: torch.Tensor):
        rule = self.table.rule_for(name)
        if rule is None or rule.kind == "raw":
            raise ValueError(
                f"PolicyQuantizer reached {name!r} without an applicable "
                f"rule — the codec policy fn must exclude it")
        if rule.kind == "q8":
            return PerChannelInt8Quantizer().quantize(name, w)
        levels = rd_assign_levels(
            w, rule.step, rule.lam, num_gr=self.num_gr, assign=self.assign,
            window=self.window, passes=self.passes,
            refinements=self.refinements)
        return QuantizedTensor(levels=levels.cpu().numpy().astype(np.int64),
                               step=rule.step, dtype=dtype_name(w.dtype))
