"""Kernel autotuner with a persistent JSON tuning cache (the port's
counterpart of ``repro.kernels.tune``).

:func:`autotune` sweeps an op's tile space over a list of shapes, times
each feasible config on the card, and persists the winners keyed by
``(op, platform, shape-bucket)``.  Registry dispatch
(:meth:`registry.BoundOp.plan`) reads the cache when it plans a call, so
a tuned session picks the winning tiles with no per-call cost.

Cache location: ``$REPRO_TORCH_KERNEL_TUNE_CACHE`` if set, else
``~/.cache/repro_torch/kernel_tune.json``.  The format is the
reference's (version 1), so either package reads the other's file::

    {"version": 1,
     "entries": {"dequant_matmul/cuda/m4_k7168_n64":
                     {"tiles": {"bm": 4, "kc": 896},
                      "time_us": 10.9, "shape": [4, 7168, 64]}}}

Shape buckets round the data-dependent axes (rows, sequence lengths) to
the next power of two, so a cache tuned at batch 8 serves batch 5..8.  The
cache loads once per process (a new path in the env var loads that file);
each load and change gives it a new ``generation`` (unique in the
process), which the registry's plan memo keys on.  Only the card has
tunable impls: ``autotune`` raises on the CPU, as the reference raises
for a platform without one.
"""

from __future__ import annotations

import itertools
import json
import math
import os
import time
from pathlib import Path

import torch

from .registry import captured_launches, tensors_in

ENV_VAR = "REPRO_TORCH_KERNEL_TUNE_CACHE"
CACHE_VERSION = 1
GRAPH_MS = 2.0       # a timed graph replays calls for about this long
MAX_GRAPH_CALLS = 200
ROTATE_BYTES = 120e6  # inputs rotated through per timed call on the card
MAX_COPIES = 256      # (more than twice an H100's 50 MB L2 cache)
_GENERATIONS = itertools.count(1)   # unique over every cache's contents


def default_cache_path() -> Path:
    env = os.environ.get(ENV_VAR)
    if env:
        return Path(env)
    return Path.home() / ".cache" / "repro_torch" / "kernel_tune.json"


def pow2_bucket(n: int) -> int:
    """Smallest power of two >= n (shape-bucket rounding)."""
    n = max(int(n), 1)
    return 1 << (n - 1).bit_length()


class TuningCache:
    """Persisted winners of past autotune sweeps."""

    def __init__(self, path: str | Path | None = None):
        self.path = Path(path) if path is not None else default_cache_path()
        self.entries: dict[str, dict] = {}
        self.generation = next(_GENERATIONS)
        self._load()

    def _load(self) -> None:
        try:
            raw = json.loads(self.path.read_text())
        except (OSError, ValueError):
            return
        if raw.get("version") == CACHE_VERSION:
            self.entries = dict(raw.get("entries", {}))

    @staticmethod
    def key(op: str, platform: str, bucket: str) -> str:
        return f"{op}/{platform}/{bucket}"

    def lookup(self, op: str, platform: str, bucket: str) -> dict | None:
        entry = self.entries.get(self.key(op, platform, bucket))
        return dict(entry["tiles"]) if entry else None

    def store(self, op: str, platform: str, bucket: str, tiles: dict,
              time_us: float, shape=None) -> None:
        self.entries[self.key(op, platform, bucket)] = {
            "tiles": dict(tiles), "time_us": round(float(time_us), 3),
            "shape": list(shape) if shape is not None else None}
        self.generation = next(_GENERATIONS)

    def save(self) -> None:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        tmp = self.path.with_suffix(".tmp")
        tmp.write_text(json.dumps(
            {"version": CACHE_VERSION, "entries": self.entries},
            indent=1, sort_keys=True))
        tmp.replace(self.path)


_cache: TuningCache | None = None
_cache_env: str | None = None


def get_cache() -> TuningCache:
    """Process-wide cache singleton; loads anew if the env path changed."""
    global _cache, _cache_env
    env = os.environ.get(ENV_VAR)
    if _cache is None or env != _cache_env:
        _cache, _cache_env = TuningCache(default_cache_path()), env
    return _cache


def invalidate_cache() -> None:
    global _cache
    _cache = None


def lookup(op: str, platform: str, bucket: str) -> dict | None:
    return get_cache().lookup(op, platform, bucket)


# ---------------------------------------------------------------------------
# Autotune
# ---------------------------------------------------------------------------

def tile_candidates(op_spec, shapes: dict) -> list[dict]:
    """Cartesian product of the op's tile space, filtered by ``tile_ok``.
    A callable entry of the space gives its values for these shapes."""
    keys = list(op_spec.tile_space)
    spaces = [op_spec.tile_space[k] for k in keys]
    spaces = [s(shapes) if callable(s) else s for s in spaces]
    out = []
    for vals in itertools.product(*spaces):
        tiles = dict(zip(keys, vals))
        if op_spec.tile_ok is None or op_spec.tile_ok(shapes, tiles):
            out.append(tiles)
    if not out and op_spec.default_tiles is not None:
        out = [dict(op_spec.default_tiles(shapes))]
    return out


def _input_sets(op_spec, shape, platform, first) -> list:
    """``first`` (the example inputs of ``shape``) and, on the card, as
    many copies as take ROTATE_BYTES (at most MAX_COPIES), which the timed
    calls take in turn, so that they read their inputs from HBM as a
    serving step reads its weights."""
    if platform != "cuda":
        return [first]
    nbytes = sum(t.numel() * t.element_size()
                 for t in tensors_in(first[0]))
    copies = max(1, min(MAX_COPIES, math.ceil(ROTATE_BYTES
                                              / max(nbytes, 1))))
    return [first] + [op_spec.example_inputs(shape, platform)
                      for _ in range(copies - 1)]


def _time_config(fn, sets, tiles, *, repeats: int, warmup: int) -> float:
    """Seconds per call of ``fn(*args, **kwargs, **tiles)``, the best of
    ``repeats``, each call on the next (args, kwargs) of ``sets``.  On the
    card: CUDA events after ``warmup`` calls; a call shorter than GRAPH_MS
    is timed as replays of one CUDA graph of as many calls as take about
    GRAPH_MS (an eager loop of a call of a few us would time Python's
    issue rate), a longer one call by call.  On the CPU: the host
    clock."""
    turn = itertools.cycle(sets)

    def call():
        args, kwargs = next(turn)
        return fn(*args, **kwargs, **tiles)

    first = next(tensors_in(sets[0][0]), None)
    if first is None or not first.is_cuda:
        for _ in range(warmup):
            call()
        best = math.inf
        for _ in range(repeats):
            t0 = time.perf_counter()
            call()
            best = min(best, time.perf_counter() - t0)
        return best
    for _ in range(max(warmup, 1)):
        call()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    call()
    end.record()
    end.synchronize()
    est_ms = start.elapsed_time(end)
    reps, run = 1, call
    graph = None
    if est_ms < GRAPH_MS:
        reps = max(1, min(MAX_GRAPH_CALLS, int(GRAPH_MS / max(est_ms,
                                                              1e-3))))
        graph = torch.cuda.CUDAGraph()
        with captured_launches(), torch.cuda.graph(graph):
            for _ in range(reps):
                call()
        run = graph.replay
        run()
    best = math.inf
    for _ in range(repeats):
        start.record()
        run()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    del graph
    return best / 1e3


def autotune(op: str, shapes, *, policy=None, impl: str | None = None,
             repeats: int = 3, warmup: int = 1, cache: TuningCache | None =
             None, save: bool = True, force: bool = False,
             max_configs: int = 64, verify=None) -> dict:
    """Sweep ``op``'s tile space over ``shapes``; persist winners.

    ``shapes`` is a list of op-specific shape tuples (see the op's
    ``example_inputs``), made on the platform's device (on the card, in
    copies the timed calls rotate through).  The impl timed is
    ``impl`` if given, else the policy's pin, else the op's ``tune_impls``
    entry for this platform ("auto": the card if there is one).  The
    default tiles are always among the candidates.  ``verify(shape,
    tiles, out)``, if given, sees every candidate's output before it is
    timed (and raises to reject it).  Existing cache entries are kept
    unless ``force``.  Returns ``{bucket: {"tiles", "time_us", "configs",
    "default_tiles", "default_time_us", "shape"}}``.
    """
    from . import registry

    op_spec = registry.spec(op)
    if op_spec.example_inputs is None or not op_spec.tile_space:
        raise ValueError(f"op {op!r} has no tunable tile space")
    policy = policy or registry.DEFAULT_POLICY
    platform = policy.platform
    if platform == "auto":
        platform = "cuda" if torch.cuda.is_available() else "cpu"
    impl_name = (impl or policy.impl_for(op)
                 or op_spec.tune_impls.get(platform)
                 or op_spec.tune_impls.get("*"))
    if impl_name is None or impl_name not in op_spec.impls:
        raise ValueError(
            f"{op}: no tunable impl for platform {platform!r} "
            f"(got {impl_name!r})")
    impl_spec = op_spec.impls[impl_name]
    if platform not in impl_spec.platforms:
        raise ValueError(f"{op}: impl {impl_name!r} does not run on "
                         f"{platform!r}")
    cache = cache or get_cache()

    results: dict[str, dict] = {}
    for shape in shapes:
        args, kwargs = op_spec.example_inputs(shape, platform)
        sh = op_spec.shape_info(*args, **kwargs)
        if impl_spec.constraint is not None:
            why = impl_spec.constraint(sh)
            if why is not None:
                results[str(shape)] = {"skipped": why}
                continue
        bucket = op_spec.bucket(sh) if op_spec.bucket else str(shape)
        if not force and cache.lookup(op, platform, bucket) is not None:
            results[bucket] = {"tiles": cache.lookup(op, platform, bucket),
                               "cached": True}
            continue
        default = (dict(op_spec.default_tiles(sh)) if op_spec.default_tiles
                   else None)
        cands = tile_candidates(op_spec, sh)[:max_configs]
        if default is not None and default not in cands:
            cands.insert(0, default)
        sets = _input_sets(op_spec, shape, platform, (args, kwargs))
        best_tiles, best_t, default_t = None, math.inf, None
        for tiles in cands:
            if verify is not None:
                verify(shape, tiles, impl_spec.fn(*args, **kwargs, **tiles))
            t = _time_config(impl_spec.fn, sets, tiles, repeats=repeats,
                             warmup=warmup)
            if tiles == default:
                default_t = t
            if t < best_t:
                best_tiles, best_t = tiles, t
        if best_tiles is None:
            results[bucket] = {"skipped": "no feasible tile config"}
            continue
        shape_l = list(shape) if isinstance(shape, (list, tuple)) \
            else [shape]
        cache.store(op, platform, bucket, best_tiles, best_t * 1e6,
                    shape=shape_l)
        results[bucket] = {
            "tiles": best_tiles, "time_us": round(best_t * 1e6, 3),
            "configs": len(cands), "default_tiles": default,
            "default_time_us": (None if default_t is None
                                else round(default_t * 1e6, 3)),
            "shape": shape_l}
    if save:
        cache.save()
    return results
