"""Kernel-op registry of the port: one dispatch point for every kernel
(the counterpart of ``repro.kernels.registry``).

Every op (``dequant_matmul``, ``dequant_matmul_grouped``,
``flash_attention``, ``rd_quant``, ``embed_lookup_q8``) registers an
:class:`OpSpec` with :func:`register_op`: named implementations (``cuda``,
the hand-written kernel; ``ref``, the plain PyTorch version; ``scan`` for
attention, ``gather`` for the embedding), a tile search space, shape
constraints and a plain oracle.  Call sites then do::

    from repro_torch import kernels
    out = kernels.get("dequant_matmul")(x, w_q, scale, policy=cfg.kernels)

and dispatch picks the impl by platform (a CUDA tensor -> ``cuda``, a CPU
tensor -> ``ref``; attention's CPU default is ``scan``), honours one
:class:`KernelPolicy` (per-op impl pins, tile pins, ``strict``), reads the
persistent tuning cache (:mod:`.tune`) for tile parameters, and records
every constraint-driven fallback in :func:`dispatch_report` instead of
downgrading silently.  A pinned impl that cannot run raises under
``KernelPolicy(strict=True)``.  An impl that raises is never caught: a
kernel that fails to build or launch raises under every policy.

Dispatch runs in Python on every call, so plans are memoized by (op,
platform, policy, shape info, tuning-cache generation); a plan reads no
device value.  A CUDA-graph capture freezes the plans of the step it
captures, as the reference's ``jax.jit`` freezes them at trace time.

Two more records make a run's path visible:

* the event report also holds loop-body dequantizes and tile clamps
  (:func:`record_event`), with the reference's record schema
  ({op, platform, requested, impl, reason, kind});
* one plain-integer launch counter per hand-written kernel, bumped by the
  kernel's wrapper at the point where it launches the CUDA kernel and
  nowhere else.  A CUDA-graph capture launches nothing, so the launches
  its wrappers count are taken back (:func:`captured_launches`), and
  every replay of the graph credits them (:func:`credit_launches`): a
  replay runs no Python.
"""

from __future__ import annotations

import contextlib
import dataclasses
from collections import deque
from dataclasses import dataclass, field
from typing import Callable

import torch
from torch._subclasses.fake_tensor import is_fake


class KernelDispatchError(RuntimeError):
    """An explicitly requested impl cannot run under the given policy."""


# ---------------------------------------------------------------------------
# Policy
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class KernelPolicy:
    """Session-wide kernel selection policy (hashable; lives on ModelConfig).

    platform        "auto" (the device of the op's first tensor) or a pin
                    ("cuda" / "cpu": plans for that platform, card or not).
    strict          a constraint-driven fallback on an *explicitly
                    requested* impl raises instead of downgrading.
    use_tuning_cache  consult the persistent tuning cache for tile params.
    overrides       ((op, impl), ...) per-op impl pins.
    tile_overrides  ((op, ((param, value), ...)), ...) per-op tile pins
                    (win over both defaults and the tuning cache).
    """

    platform: str = "auto"
    strict: bool = False
    use_tuning_cache: bool = True
    overrides: tuple = ()
    tile_overrides: tuple = ()

    def impl_for(self, op: str) -> str | None:
        for name, impl in self.overrides:
            if name == op:
                return impl
        return None

    def tiles_for(self, op: str) -> dict:
        for name, tiles in self.tile_overrides:
            if name == op:
                return dict(tiles)
        return {}

    def override(self, op: str, impl: str) -> "KernelPolicy":
        """Return a policy with ``op`` pinned to ``impl`` (replaces any
        existing pin for the same op — idempotent)."""
        kept = tuple((n, i) for n, i in self.overrides if n != op)
        return dataclasses.replace(self, overrides=kept + ((op, impl),))

    def with_tiles(self, op: str, **tiles) -> "KernelPolicy":
        kept = tuple((n, t) for n, t in self.tile_overrides if n != op)
        pin = (op, tuple(sorted(tiles.items())))
        return dataclasses.replace(self, tile_overrides=kept + (pin,))


DEFAULT_POLICY = KernelPolicy()


# ---------------------------------------------------------------------------
# Op specification
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Impl:
    """One named implementation of an op.

    fn          callable with the op's public signature, plus the op's tile
                parameters as keyword arguments when ``uses_tiles``.
    platforms   platforms the impl runs on ("cuda", "cpu").
    constraint  shapes-dict -> None (ok) or a human-readable reason string.
    """

    name: str
    fn: Callable
    platforms: tuple = ("cpu", "cuda")
    constraint: Callable | None = None
    uses_tiles: bool = True


@dataclass
class OpSpec:
    """Registered kernel op: impls, platform defaults, tile search space.

    defaults     platform -> impl name; "*" is the required catch-all.
    route        optional shape-based routing hook consulted before
                 ``defaults`` when no impl is pinned: (shapes, platform)
                 -> impl name or None, for *designed* routes (decode ->
                 scan) that are no constraint fallback and record nothing.
    fallbacks    ordered impl names to try when the primary choice fails
                 its constraint or platform check.
    tile_space   tile param -> candidate values (the autotune sweep), or a
                 callable of the shapes dict giving them.
    default_tiles  shapes-dict -> tile dict (shape-adaptive defaults).
    tile_ok      (shapes, tiles) -> bool: what the launch takes.
    shape_info   (*args, **kwargs) -> shapes dict (hashable values) fed to
                 constraints, default_tiles and bucket.
    bucket       shapes-dict -> tuning-cache key segment.
    example_inputs  (shape tuple, device) -> (args, kwargs) for autotune.
    oracle       plain reference callable (differential tests).
    tune_impls   platform -> impl name the autotuner times ("*" catch-all).
    """

    name: str
    impls: dict
    defaults: dict
    route: Callable | None = None
    fallbacks: tuple = ()
    tile_space: dict = field(default_factory=dict)
    default_tiles: Callable | None = None
    tile_ok: Callable | None = None
    shape_info: Callable = lambda *a, **k: {}
    bucket: Callable | None = None
    example_inputs: Callable | None = None
    oracle: Callable | None = None
    tune_impls: dict = field(default_factory=dict)


_OPS: dict[str, OpSpec] = {}
_REPORT: deque = deque(maxlen=512)
_PLANS: dict = {}                 # memo: see BoundOp.plan
_MAX_PLANS = 4096


def register_op(build: Callable[[], OpSpec]) -> Callable[[], OpSpec]:
    """Decorator: ``build`` returns an OpSpec, registered at import time."""
    op = build()
    _OPS[op.name] = op
    _PLANS.clear()
    return build


def available_ops() -> list[str]:
    return sorted(_OPS)


def spec(name: str) -> OpSpec:
    if name not in _OPS:
        raise KeyError(
            f"unknown kernel op {name!r}; available: {available_ops()}")
    return _OPS[name]


def dispatch_report() -> list[dict]:
    """Fallbacks, tile clamps and loop-dequant events observed so far (most
    recent last).  Each record: {op, platform, requested, impl, reason,
    kind}; ``requested`` is the impl the policy asked for (None when the
    platform default fell back), ``impl`` what actually ran."""
    return list(_REPORT)


def clear_dispatch_report() -> None:
    _REPORT.clear()


def record_event(*, op: str, platform: str, impl: str, reason: str,
                 requested: str | None = None, kind: str = "event") -> None:
    """Append one event (``kind`` is "fallback", "tile_clamp",
    "loop_dequant", ...) to the report."""
    _REPORT.append({"op": op, "platform": platform, "requested": requested,
                    "impl": impl, "reason": reason, "kind": kind})


# ---------------------------------------------------------------------------
# Launch counters
# ---------------------------------------------------------------------------

# kernel name -> launches since the last reset_launch_counts()
LAUNCHES: dict[str, int] = {"dequant_matmul": 0,
                             "dequant_matmul_grouped": 0,
                             "flash_attention": 0, "rd_quant": 0}


def count_launch(name: str) -> None:
    LAUNCHES[name] += 1


def refuse_traced(name: str, *tensors) -> None:
    """Raise ``NotImplementedError`` when a fake or meta tensor reaches
    kernel ``name``'s wrapper (the dry run's trace, ``launch.dryrun``):
    the kernel must not launch on data that is not there, and its plain
    version's step-by-step arithmetic is not the kernel's cost."""
    for t in tensors:
        if isinstance(t, torch.Tensor) and (t.is_meta or is_fake(t)):
            raise NotImplementedError(
                f"{name}: the dry run does not account kernel {name} yet "
                "(a fake or meta tensor reached its wrapper)")


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


# ---------------------------------------------------------------------------
# Devices
# ---------------------------------------------------------------------------

def platform_of(t: torch.Tensor) -> str:
    return "cuda" if t.is_cuda else "cpu"


def tensors_in(args):
    """The tensors among ``args``, dicts of them (a q8 leaf) walked."""
    for a in args:
        if isinstance(a, torch.Tensor):
            yield a
        elif isinstance(a, dict):
            yield from tensors_in(a.values())


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


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class DispatchPlan:
    """What :class:`BoundOp` decided for one call, without executing it."""

    op: str
    platform: str
    requested: str | None        # explicit policy pin, if any
    impl: str                    # impl that will run
    tiles: tuple                 # ((param, value), ...) sorted
    fallback_reason: str | None  # why the primary choice was downgraded
    cache_hit: bool              # tiles came from the tuning cache
    tile_clamp: str | None = None  # why cached/pinned tiles were dropped


class BoundOp:
    """Callable handle returned by :func:`get`; dispatches on call."""

    def __init__(self, op_spec: OpSpec):
        self.spec = op_spec

    def __repr__(self):
        return f"BoundOp({self.spec.name!r}, impls={sorted(self.spec.impls)})"

    def plan(self, *args, policy: KernelPolicy | None = None,
             **kwargs) -> DispatchPlan:
        """Resolve platform, impl and tiles for these arguments."""
        s = self.spec
        policy = policy or DEFAULT_POLICY
        platform = policy.platform
        if platform == "auto":
            t = next(tensors_in(args), None)
            platform = "cpu" if t is None else platform_of(t)
        shapes = s.shape_info(*args, **kwargs)
        cache = None
        if policy.use_tuning_cache and s.tile_space:
            from . import tune
            cache = tune.get_cache()
        key = (s.name, platform, policy, tuple(shapes.items()),
               None if cache is None else cache.generation)
        hit = _PLANS.get(key)
        if hit is None:
            hit = self._plan(shapes, platform, policy, cache)
            if len(_PLANS) >= _MAX_PLANS:
                _PLANS.clear()
            _PLANS[key] = hit
        return hit

    def _plan(self, shapes: dict, platform: str, policy: KernelPolicy,
              cache) -> DispatchPlan:
        s = self.spec
        requested = policy.impl_for(s.name)
        if requested is not None and requested not in s.impls:
            raise KeyError(
                f"{s.name}: unknown impl {requested!r}; "
                f"available: {sorted(s.impls)}")
        primary = requested
        if primary is None and s.route is not None:
            primary = s.route(shapes, platform)
        if primary is None:
            primary = s.defaults.get(platform, s.defaults["*"])

        reason = None
        chosen = None
        for cand in [primary] + [f for f in s.fallbacks if f != primary]:
            impl = s.impls.get(cand)
            if impl is None:
                continue
            if platform not in impl.platforms:
                why = f"impl {cand!r} unavailable on platform {platform!r}"
            else:
                why = impl.constraint(shapes) if impl.constraint else None
            if why is None:
                chosen = cand
                break
            if cand == primary:
                reason = why
        if chosen is None:
            raise KernelDispatchError(
                f"{s.name}: no feasible impl on {platform!r} "
                f"(primary {primary!r}: {reason})")

        tiles: dict = {}
        cache_hit = False
        clamp = None
        if s.impls[chosen].uses_tiles and s.tile_space:
            default = dict(s.default_tiles(shapes)) if s.default_tiles \
                else {}
            tiles.update(default)
            if cache is not None and s.bucket is not None:
                got = cache.lookup(s.name, platform, s.bucket(shapes))
                if got:
                    tiles.update(got)
                    cache_hit = True
            tiles.update(policy.tiles_for(s.name))
            if s.tile_ok is not None and tiles != default and \
                    not s.tile_ok(shapes, tiles):
                clamp = (f"tiles {tiles} do not fit {shapes}: the default "
                         f"{default} runs (cached/pinned tile)")
                tiles = default
        return DispatchPlan(
            op=s.name, platform=platform, requested=requested, impl=chosen,
            tiles=tuple(sorted(tiles.items())),
            fallback_reason=reason if chosen != primary else None,
            cache_hit=cache_hit, tile_clamp=clamp)

    def __call__(self, *args, policy: KernelPolicy | None = None, **kwargs):
        plan = self.plan(*args, policy=policy, **kwargs)
        if plan.fallback_reason is not None:
            record_event(op=plan.op, platform=plan.platform,
                         requested=plan.requested, impl=plan.impl,
                         reason=plan.fallback_reason, kind="fallback")
            if (policy is not None and policy.strict
                    and plan.requested is not None):
                raise KernelDispatchError(
                    f"{plan.op}: requested impl {plan.requested!r} cannot "
                    f"run ({plan.fallback_reason}) and policy is strict")
        if plan.tile_clamp is not None:
            record_event(op=plan.op, platform=plan.platform,
                         requested=plan.requested, impl=plan.impl,
                         reason=plan.tile_clamp, kind="tile_clamp")
        impl = self.spec.impls[plan.impl]
        tiles = dict(plan.tiles) if impl.uses_tiles else {}
        return impl.fn(*args, **kwargs, **tiles)


def get(name: str) -> BoundOp:
    """Look up a registered op; the returned handle dispatches per call."""
    return BoundOp(spec(name))
