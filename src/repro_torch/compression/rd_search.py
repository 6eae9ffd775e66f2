"""Rate-distortion Pareto search and its deployable artifact (the port's
copy of ``repro.compression.rd_search``).

A :class:`TensorPolicy` maps each flat tensor name to its own (step,
lambda, quantizer kind); the ``deepcabac-rd`` codec and the serving
backends' ``policy_table=`` consume it.  :func:`rd_assign_levels` routes
the eq. (11) assignment: through the ``rd_quant`` kernel for a tensor on
the card, through the numpy f64 oracle on the host otherwise.

:func:`rd_sweep` produces a policy, where the parameters are:

1. **Global grid** — for each (delta_rel, lambda) point, RD-assign every
   covered tensor, entropy-code the full tree into a lane-scheduled v3
   container, decode it back, and measure greedy-token disagreement and
   last-position logit KL against the uncompressed model through
   ``ServeSession`` (:class:`TaskProxy`).
2. **Pareto front** — :func:`pareto_front` marks the non-dominated
   (bytes, distortion) points; the winner is the cheapest point within the
   token-error budget.
3. **Per-tensor refinement** — from the winner's operating point, coarsen
   the steps of the tensors with the best rate saving per unit of
   FIM-weighted distortion (F from :func:`fisher_for`, the empirical
   Fisher diagonal) until a distortion budget relative to the winner is
   spent; re-validate end to end and revert wholesale if the token-error
   budget is left.  Level assignment itself stays F = 1, so the deployed
   ``deepcabac-rd`` encode is what the sweep measured.

On the card every assignment takes the ``rd_quant`` kernel, the bin
statistics, rate estimates and distortion sums stay on the device, and
the proxy serves every candidate from the card (prefill through the
``flash_attention`` kernel).  A policy re-applied through
``get("deepcabac-rd", policy_table=...)`` reproduces the swept container
byte for byte.
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
                               estimate_bin_probs_torch,
                               estimate_level_bits_torch)
from ..kernels.registry import resolve_device
from .codec import Codec, decompress
from .coders import CabacV3Coder
from .quantizers import (PerChannelInt8Quantizer, Quantizer, host_f64,
                         ndim_float_policy, relative_step)
from .tree import flatten_tree, unflatten

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
    from .. import kernels
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
        levels = kernels.get("rd_quant")(
            flat, fl, probs, step=step, lam=lam, window=window,
            max_level=max_level, passes=passes)
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
        return _quantized(w, rule.step, rd_assign_levels(
            w, rule.step, rule.lam, num_gr=self.num_gr, assign=self.assign,
            window=self.window, passes=self.passes,
            refinements=self.refinements))


def _quantized(w: torch.Tensor, step: float,
               levels: torch.Tensor) -> QuantizedTensor:
    """Levels from :func:`rd_assign_levels` (int32 on the card, int64 on the
    host) as the host int64 entry the codec writes."""
    return QuantizedTensor(levels=levels.cpu().numpy().astype(np.int64),
                           step=step, dtype=dtype_name(w.dtype))


# ---------------------------------------------------------------------------
# Task-proxy distortion through the serving path
# ---------------------------------------------------------------------------

class TaskProxy:
    """Distortion oracle: greedy-token disagreement and last-position logit
    KL of a candidate weight tree against the uncompressed reference,
    measured through the request path (``ServeSession`` on the ``bf16``
    backend, greedy decode) on ``device``.  Each measurement opens a new
    session and frees it (its graphs with it) before it returns."""

    def __init__(self, cfg, ref_params, *, prompts: int = 4,
                 prompt_len: int = 8, decode_steps: int = 8, seed: int = 0,
                 device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.decode_steps = decode_steps
        rng = np.random.default_rng(seed)
        self.prompts = [
            rng.integers(0, cfg.vocab_size, prompt_len).astype(np.int32)
            for _ in range(prompts)]
        self.ref_tokens = self._greedy_tokens(ref_params)
        self.ref_logp = self._log_probs(ref_params)

    def _on_device(self, params):
        return unflatten({k: v.to(self.device)
                          for k, v in flatten_tree(params).items()})

    def _greedy_tokens(self, params) -> list[list[int]]:
        from ..serve.session import ServeConfig, ServeSession
        scfg = ServeConfig(slots=len(self.prompts),
                           max_len=len(self.prompts[0]) + self.decode_steps)
        session = ServeSession(self.cfg, self._on_device(params),
                               backend="bf16", serve_cfg=scfg,
                               device=self.device)
        handles = [session.submit(p, max_new_tokens=self.decode_steps)
                   for p in self.prompts]
        session.run()
        return [[int(t) for t in h.tokens] for h in handles]

    def _log_probs(self, params) -> np.ndarray:
        """log-softmax of the last position's f32 logits, then f64 on the
        host (the reference's order: an f64 log-softmax differs)."""
        from ..models.transformer import prefill
        tokens = torch.from_numpy(np.stack(self.prompts)).to(self.device)
        logits, _ = prefill(self._on_device(params), self.cfg, tokens=tokens)
        return torch.log_softmax(logits.to(torch.float32), dim=-1).cpu(
        ).numpy().astype(np.float64)

    def measure(self, cand_params) -> dict:
        """-> {"token_err", "logit_kl"} of the candidate tree."""
        cand_tokens = self._greedy_tokens(cand_params)
        total = sum(len(t) for t in self.ref_tokens)
        wrong = sum(a != b for ref, got in zip(self.ref_tokens, cand_tokens)
                    for a, b in zip(ref, got))
        cand_logp = self._log_probs(cand_params)
        kl = float(np.mean(np.sum(
            np.exp(self.ref_logp) * (self.ref_logp - cand_logp), axis=-1)))
        return {"token_err": wrong / max(total, 1),
                "logit_kl": max(kl, 0.0)}


# ---------------------------------------------------------------------------
# The sweep
# ---------------------------------------------------------------------------

@dataclass
class RDSearchConfig:
    """Sweep knobs.  The defaults are smoke-scale; benches widen the
    grids."""

    delta_rels: tuple = (2e-3, 6e-3, 2e-2)   # relative grid steps
    lambdas: tuple = (0.0, 3e-4, 1e-3)       # RD trade-off points
    num_gr: int = B.DEFAULT_NUM_GR
    min_ndim: int = 2                         # tensors below stay raw
    prompts: int = 4
    prompt_len: int = 8
    decode_steps: int = 8
    seed: int = 0
    token_err_budget: float = 0.0             # winner must stay within
    refine: bool = True                       # stage-B per-tensor search
    refine_factors: tuple = (2.0, 4.0)        # coarser steps to try
    refine_dist_growth: float = 1.0           # stage-B FIM-weighted
    # distortion budget, as a fraction of the winner's own distortion
    fim_batches: int = 2                      # 0 => F_i = 1 refinement
    fim_batch: int = 2
    fim_seq: int = 16
    assign: str = "auto"                      # rd_assign_levels routing


@dataclass
class RDPoint:
    """One measured grid point of the bytes-vs-distortion plane."""

    delta_rel: float
    lam: float
    bytes: int
    token_err: float
    logit_kl: float
    on_front: bool = False

    def to_dict(self) -> dict:
        return {"delta_rel": self.delta_rel, "lam": self.lam,
                "bytes": self.bytes, "token_err": round(self.token_err, 6),
                "logit_kl": round(self.logit_kl, 8),
                "on_front": self.on_front}


@dataclass
class RDSweepResult:
    points: list[RDPoint]
    policy: TensorPolicy
    winner: RDPoint
    policy_bytes: int
    policy_token_err: float
    policy_logit_kl: float
    refined_tensors: int        # rules coarsened past the winner's step
    reverted: bool              # stage-B left the budget and was undone


def _distortion_key(p: RDPoint) -> tuple:
    return (p.token_err, p.logit_kl)


def pareto_front(points: list[RDPoint]) -> list[RDPoint]:
    """Mark and return the non-dominated points of the (bytes,
    (token_err, logit_kl)) plane, cheapest first.  q dominates p when it
    is <= on both axes and strictly better on one."""
    for p in points:
        p.on_front = not any(
            q is not p and q.bytes <= p.bytes
            and _distortion_key(q) <= _distortion_key(p)
            and (q.bytes < p.bytes or _distortion_key(q) < _distortion_key(p))
            for q in points)
    return sorted((p for p in points if p.on_front),
                  key=lambda p: (p.bytes, _distortion_key(p)))


def fisher_for(cfg, params, *, batches: int = 2, batch: int = 2,
               seq: int = 16, seed: int = 0):
    """Empirical Fisher diagonal of ``params`` on the synthetic training
    stream (``data.pipeline.make_batch``), where the parameters are — the
    F_i of eq. 11."""
    from ..core.fim import empirical_fisher_diag
    from ..data.pipeline import make_batch, to_device
    from ..models.transformer import train_loss

    device = next(iter(flatten_tree(params).values())).device
    bs = [to_device(make_batch(cfg, i, batch=batch, seq=seq, seed=seed),
                    device)
          for i in range(max(batches, 1))]
    return empirical_fisher_diag(lambda p, b: train_loss(p, b, cfg),
                                 params, bs, max_batches=len(bs))


def _sweep_codec(num_gr: int) -> Codec:
    return Codec("rd-sweep", coder=CabacV3Coder(num_gr=num_gr))


def _measure_entries(codec: Codec, entries: dict, like, proxy: TaskProxy):
    """Encode a full entry dict into a real container, decode it back onto
    ``like``'s devices, and score it: bytes and distortion both come from
    the artifact a deployment would ship."""
    blob = codec.compress_entries(entries).blob
    d = proxy.measure(decompress(blob, like=like))
    return len(blob), d


def rd_sweep(cfg, params, search: RDSearchConfig | None = None,
             fim=None) -> RDSweepResult:
    """Sweep the RD grid for one model config where ``params`` lie (see the
    module docstring for the three stages).  ``fim`` (a tree matching
    ``params``) overrides the empirical-Fisher computation."""
    search = search or RDSearchConfig()
    flat = flatten_tree(params)
    proxy = TaskProxy(cfg, params, prompts=search.prompts,
                      prompt_len=search.prompt_len,
                      decode_steps=search.decode_steps, seed=search.seed,
                      device=next(iter(flat.values())).device)
    covered_by = ndim_float_policy(search.min_ndim)
    covered = {name: w for name, w in flat.items()
               if w.numel() > 0 and covered_by(name, w)}
    if not covered:
        raise ValueError(f"config {cfg.name!r}: no tensors pass the "
                         f"min_ndim={search.min_ndim} policy")
    codec = _sweep_codec(search.num_gr)

    def assign(name: str, rule: TensorRule) -> torch.Tensor:
        return rd_assign_levels(covered[name], rule.step, rule.lam,
                                num_gr=search.num_gr, assign=search.assign)

    def entries_for(rules: dict[str, TensorRule]) -> dict:
        out = dict(flat)
        for name, rule in rules.items():
            out[name] = _quantized(covered[name], rule.step,
                                   assign(name, rule))
        return out

    # -- stage A: global (delta_rel, lambda) grid ------------------------
    points: list[RDPoint] = []
    rules_at: dict[tuple, dict[str, TensorRule]] = {}
    for dr in search.delta_rels:
        steps = {name: relative_step(w, dr) for name, w in covered.items()}
        for lam in search.lambdas:
            rules = {name: TensorRule(step=steps[name], lam=lam)
                     for name in covered}
            size, d = _measure_entries(codec, entries_for(rules), params,
                                       proxy)
            rules_at[(dr, lam)] = rules
            points.append(RDPoint(delta_rel=dr, lam=lam, bytes=size,
                                  token_err=d["token_err"],
                                  logit_kl=d["logit_kl"]))

    front = pareto_front(points)
    in_budget = [p for p in front if p.token_err <= search.token_err_budget]
    winner = (min(in_budget, key=lambda p: (p.bytes, p.logit_kl))
              if in_budget
              else min(front, key=lambda p: (_distortion_key(p), p.bytes)))

    # -- stage B: distortion-budgeted per-tensor refinement ---------------
    rules = dict(rules_at[(winner.delta_rel, winner.lam)])
    refined, reverted = 0, False
    if search.refine and search.refine_factors:
        fim_flat = (flatten_tree(fim) if fim is not None
                    else flatten_tree(fisher_for(
                        cfg, params, batches=search.fim_batches,
                        batch=search.fim_batch, seq=search.fim_seq,
                        seed=search.seed))
                    if search.fim_batches > 0 else {})

        def wdist(name: str, step: float, levels: torch.Tensor) -> float:
            """sum_i F_i (w_i - step * k_i)^2 in f64, where w lies."""
            w = covered[name].to(torch.float64)
            d = torch.square(w - levels.to(w.device, torch.float64) * step)
            f = fim_flat.get(name)
            if f is not None:
                d = f.to(w.device, torch.float64) * d
            return float(d.sum())

        # candidate coarsenings: (bits saved) / (FIM-weighted distortion
        # added), at most one step change per tensor
        total_base_dist = 0.0
        cands: list[tuple[float, float, str, TensorRule]] = []
        for name in covered:
            base = rules[name]
            base_levels = assign(name, base)
            base_bits = estimate_level_bits_torch(base_levels, search.num_gr)
            base_dist = wdist(name, base.step, base_levels)
            del base_levels
            total_base_dist += base_dist
            for fac in search.refine_factors:
                rule2 = TensorRule(step=base.step * fac, lam=base.lam)
                levels2 = assign(name, rule2)
                saved = base_bits - estimate_level_bits_torch(levels2,
                                                              search.num_gr)
                grown = wdist(name, rule2.step, levels2) - base_dist
                del levels2
                if saved > 0:
                    eff = saved / max(grown, 1e-30)
                    cands.append((eff, grown, name, rule2))

        budget = search.refine_dist_growth * total_base_dist
        taken: set[str] = set()
        for eff, grown, name, rule in sorted(cands, key=lambda c: -c[0]):
            if name in taken or grown > budget:
                continue
            budget -= grown
            rules[name] = rule
            taken.add(name)
        refined = len(taken)

        if refined:
            size, d = _measure_entries(codec, entries_for(rules), params,
                                       proxy)
            err_budget = max(search.token_err_budget, winner.token_err)
            if d["token_err"] > err_budget:
                rules = dict(rules_at[(winner.delta_rel, winner.lam)])
                refined, reverted = 0, True

    policy = TensorPolicy(
        rules=rules,
        meta={"arch": cfg.name, "delta_rel": winner.delta_rel,
              "lam": winner.lam, "num_gr": search.num_gr,
              "min_ndim": search.min_ndim, "seed": search.seed,
              "refined_tensors": refined,
              "grid": {"delta_rels": list(search.delta_rels),
                       "lambdas": list(search.lambdas)}})

    # -- final validation through the registered codec itself ------------
    from .registry import get as _get
    rd_codec = _get("deepcabac-rd", policy_table=policy,
                    num_gr=search.num_gr, min_ndim=search.min_ndim,
                    assign=search.assign)
    blob = rd_codec.compress(params).blob
    d = proxy.measure(decompress(blob, like=params))
    return RDSweepResult(points=points, policy=policy, winner=winner,
                         policy_bytes=len(blob),
                         policy_token_err=d["token_err"],
                         policy_logit_kl=d["logit_kl"],
                         refined_tensors=refined, reverted=reverted)
