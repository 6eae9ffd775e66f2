"""Multi-tenant model-zoo serving (port of ``repro.serve.zoo``): a
manifest-addressed registry, cross-model shard dedup and cold-start-aware
admission under a device-memory budget.

DeepCABAC makes whole networks cheap to store and ship; the zoo serves
many of them from one card:

* :class:`ShardStore` — a content-addressed object pool.  Checkpoint
  steps are ingested by the per-file SHA-256 their sharded / delta
  manifests already pin (``checkpoint.delta.chain_files``), so N finetune
  variants chained to one base keyframe cost one copy of the base shards
  plus N small delta streams on disk.  Each model gets a hardlinked
  *view* directory that looks exactly like a checkpoint root, so every
  chain-resolving restore path works unchanged against shared bytes.
  Objects are refcounted (:class:`~.backends.BlobGC`): removing one
  variant never drops shards another still references.
* :class:`ModelZoo` — model id -> manifest registry plus the resident
  :class:`~.session.ServeSession` set on one device, sized by a budget
  (weights from ``models.transformer.param_specs`` and KV from
  :func:`~.kv.kv_cache_bytes`, both without allocating).  Each resident
  model is charged its whole :func:`model_resident_bytes`, also where a
  warm variant shares leaves with its base.  Admission is
  cold-start-aware: victims are the *cheapest to bring back* (measured
  admit seconds, seeded from ``cold_priors``), only idle sessions are
  evicted, and a delta variant whose chain prefix is already resident
  warms by forking the base backend's tracked levels and applying only
  its own delta steps (``WeightBackend.warm_from``) instead of decoding
  the whole chain from disk.  An eviction closes the session
  (``ServeSession.close``), which drops its device tensors at once.
* :class:`ZooRouter` — the request front end.  ``submit(model_id,
  prompt, ...)`` queues for cold models, admission is triggered by
  demand, and tokens stream through :class:`ZooHandle` with the same
  per-request guarantees ``ServeSession`` gives a single model.

Admission seconds come from ``time.perf_counter()`` through this module's
``time``.
"""

from __future__ import annotations

import hashlib
import math
import os
import shutil
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from ..checkpoint import delta as delta_mod
from ..checkpoint.sharded import MANIFEST_NAME
from ..kernels.registry import resolve_device
from .backends import BlobGC, get_backend
from .kv import kv_cache_bytes
from .session import RequestHandle, ServeConfig, ServeSession


class ZooError(RuntimeError):
    """Structural model-zoo misuse (unknown model, impossible budget)."""


class AdmissionStall(ZooError):
    """The budget cannot host the model *right now* — every resident
    session still has work in flight.  Routers retry on a later step."""


# ---------------------------------------------------------------------------
# Content-addressed shard store
# ---------------------------------------------------------------------------

def _copy_verified(src: str, dst: str, sha256: str) -> None:
    """Copy ``src`` to ``dst`` hashing as we go; one pass does both the
    ingest and the integrity check against the manifest-pinned hash."""
    h = hashlib.sha256()
    tmp = dst + ".tmp"
    with open(src, "rb") as f, open(tmp, "wb") as out:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
            out.write(block)
    if h.hexdigest() != sha256:
        os.remove(tmp)
        raise ValueError(
            f"{src}: content hash {h.hexdigest()[:12]}... does not match "
            f"the manifest-pinned {sha256[:12]}... — refusing to ingest a "
            f"corrupt or substituted shard")
    os.replace(tmp, dst)


class ShardStore:
    """Content-addressed checkpoint storage with per-model views.

    Layout under ``root``::

        objects/<sha256>                     one copy of each unique file
        views/<model_id>/step_NNNNNNNN/...   hardlinks into objects/

    ``add`` ingests a step's whole base chain (keyframe included) keyed
    by the per-file sha256 the manifests pin, so identical files across
    models and variants are stored once; the returned record's ``"tip"``
    is a view directory any chain-resolving restore accepts verbatim.
    ``remove`` releases the model's object references — an object's
    bytes are deleted only when its last referencing model leaves.
    """

    def __init__(self, root: str):
        self.root = str(root)
        self._objects = os.path.join(self.root, "objects")
        self._views = os.path.join(self.root, "views")
        os.makedirs(self._objects, exist_ok=True)
        os.makedirs(self._views, exist_ok=True)
        self._gc = BlobGC(self._drop_object)
        self._models: dict[str, dict] = {}
        self.stats = {"objects_ingested": 0, "objects_deduped": 0,
                      "bytes_ingested": 0, "bytes_deduped": 0}

    def _obj_path(self, sha: str) -> str:
        return os.path.join(self._objects, sha)

    def _drop_object(self, sha: str) -> None:
        try:
            os.remove(self._obj_path(sha))
        except OSError:
            pass

    def _ingest(self, src: str, sha: str, nbytes: int) -> bool:
        """Store ``src`` as object ``sha`` unless it is there already;
        True when this call wrote it."""
        obj = self._obj_path(sha)
        if os.path.exists(obj):
            self.stats["objects_deduped"] += 1
            self.stats["bytes_deduped"] += nbytes
            return False
        _copy_verified(src, obj, sha)
        self.stats["objects_ingested"] += 1
        self.stats["bytes_ingested"] += nbytes
        return True

    def add(self, model_id: str, source: str) -> dict:
        """Ingest ``source`` (a checkpoint step directory — keyframe or
        delta-chain tip) for ``model_id`` and build its view.  Returns
        the model record: ``tip`` (view step dir to load / restore from),
        ``steps`` (base-first view step dirs), ``chain_keys`` (per-link
        pinned payload hashes — the chain's identity, used for warm-
        admission prefix matching) and byte accounting.  A file whose
        bytes do not hash to the manifest's pin raises ``ValueError``;
        the objects this call wrote and the model's view are removed
        first, so a refused ingest leaves nothing behind."""
        if model_id in self._models:
            raise ZooError(f"model {model_id!r} already in the store")
        links = delta_mod.chain_files(str(source))
        view_root = os.path.join(self._views, model_id)
        os.makedirs(view_root, exist_ok=True)
        shas: set[str] = set()
        written: list[str] = []
        chain_keys: list[str] = []
        steps: list[str] = []
        logical = 0
        try:
            for link in links:
                vdir = os.path.join(view_root, os.path.basename(link["dir"]))
                os.makedirs(vdir, exist_ok=True)
                for fname, info in link["files"].items():
                    sha = info["sha256"]
                    if self._ingest(os.path.join(link["dir"], fname), sha,
                                    info["bytes"]):
                        written.append(sha)
                    dst = os.path.join(vdir, fname)
                    if not os.path.exists(dst):
                        try:
                            os.link(self._obj_path(sha), dst)
                        except OSError:     # cross-device view root
                            shutil.copyfile(self._obj_path(sha), dst)
                    shas.add(sha)
                    logical += info["bytes"]
                pin = (MANIFEST_NAME if MANIFEST_NAME in link["files"]
                       else delta_mod.PARAMS_FILE)
                chain_keys.append(link["files"][pin]["sha256"])
                steps.append(vdir)
        except BaseException:
            for sha in written:
                self._drop_object(sha)
            shutil.rmtree(view_root, ignore_errors=True)
            raise
        for sha in shas:
            self._gc.hold(sha)
        rec = {"model_id": model_id, "tip": steps[-1], "steps": steps,
               "chain_keys": chain_keys, "objects": sorted(shas),
               "logical_bytes": int(logical)}
        self._models[model_id] = rec
        return rec

    def remove(self, model_id: str) -> None:
        """Drop a model: its view directory and its object references.
        Objects still referenced by other models keep their bytes."""
        rec = self._models.pop(model_id, None)
        if rec is None:
            return
        for sha in rec["objects"]:
            self._gc.release(sha)
        shutil.rmtree(os.path.join(self._views, model_id),
                      ignore_errors=True)

    def __contains__(self, model_id: str) -> bool:
        return model_id in self._models

    def record(self, model_id: str) -> dict:
        return self._models[model_id]

    def object_count(self) -> int:
        return len(self._gc.live())

    def physical_bytes(self) -> int:
        return sum(os.path.getsize(self._obj_path(sha))
                   for sha in self._gc.live())

    def logical_bytes(self) -> int:
        return sum(r["logical_bytes"] for r in self._models.values())

    def report(self) -> dict:
        logical, physical = self.logical_bytes(), self.physical_bytes()
        return {
            "models": len(self._models),
            "objects": self.object_count(),
            "logical_bytes": int(logical),
            "physical_bytes": int(physical),
            "dedup_ratio": round(logical / physical, 4) if physical else 0.0,
            "stats": dict(self.stats),
        }

    def close(self) -> None:
        for model_id in list(self._models):
            self.remove(model_id)


# ---------------------------------------------------------------------------
# Model zoo: registry + resident set + admission policy
# ---------------------------------------------------------------------------

def model_resident_bytes(cfg, serve_cfg: ServeConfig,
                         backend=None) -> int:
    """Device bytes a resident model costs: weight bytes plus its
    session's KV (slot cache, or the paged pool), from shapes and dtypes
    alone (``param_specs``; the policy sees meta tensors), nothing
    allocated.

    ``backend`` (registry name or instance) picks the weight accounting:
    a q8-resident backend (``WeightBackend.q8_resident``, e.g. ``"q8"``)
    holds serve-quantized leaves as ``{"q8", "q8s"}`` — int8 levels plus
    f32 per-channel scales — so eligible tensors cost 1 B a value plus
    the scales.  ``None`` keeps the full-precision accounting (right for
    bf16 and container residency)."""
    from ..compression.quantizers import serve_q8_policy
    from ..models.transformer import param_specs
    from .backends import resolve_backend

    q8_res = (resolve_backend(backend).q8_resident
              if backend is not None else False)
    wb = 0
    for name, (shape, dtype) in param_specs(cfg).items():
        n = math.prod(shape)
        if q8_res and serve_q8_policy(
                name, torch.empty(shape, dtype=dtype, device="meta")):
            # {"q8","q8s"} leaf: int8 levels + f32 per-out-channel Delta
            # (stacked ndim>=3 tensors carry one scale row per layer)
            scales = (shape[0] * shape[-1] if len(shape) >= 3
                      else shape[-1])
            wb += n + 4 * scales
        else:
            wb += n * dtype.itemsize
    if serve_cfg.kv_page_size is not None:
        page = serve_cfg.kv_page_size
        n_max = -(-serve_cfg.max_len // page)
        pool = serve_cfg.kv_pool_pages or serve_cfg.slots * n_max + 1
        kb = kv_cache_bytes(cfg, pool, page)
    else:
        kb = kv_cache_bytes(cfg, serve_cfg.slots, serve_cfg.max_len)
    return int(wb + kb)


@dataclass
class ZooConfig:
    """Admission-policy knobs for a :class:`ModelZoo`."""

    hbm_budget: int                      # bytes for every resident model's
                                         # weights + device KV together
    backend: str = "container"           # WeightBackend registry name
    serve: ServeConfig = field(default_factory=ServeConfig)
    track_levels: bool = True            # keep levels resident: enables
                                         # delta-warm admission + live swap
    cold_priors: dict = field(default_factory=dict)   # model_id -> seconds;
    # seeds the victim scoring before a model's first measured admit
    policy_table: object | None = None   # TensorPolicy / dict / JSON path:
    # per-tensor mixed-precision policy applied by the weight backend to
    # pytree admissions (see compression.rd_search); checkpoint
    # admissions carry their quantization in the artifact itself


class ModelZoo:
    """Registry + resident-session fleet under one device-memory budget,
    on ``device`` (the card unless the caller asks for the CPU)."""

    def __init__(self, store: ShardStore | str, cfg: ZooConfig, *,
                 device="cuda"):
        self.device = resolve_device(device)
        self.store = ShardStore(store) if isinstance(store, str) else store
        self.cfg = cfg
        self._registry: dict[str, dict] = {}
        self._resident: dict[str, ServeSession] = {}
        self._admit_s: dict[str, float] = {}    # last measured admit cost
        self._last_kind: dict[str, str] = {}
        self._clock = 0
        self._last_used: dict[str, int] = {}
        self.stats = {"admits_cold": 0, "admits_warm": 0, "evictions": 0,
                      "admit_s_cold": 0.0, "admit_s_warm": 0.0}

    # -- registry -----------------------------------------------------------

    def register(self, model_id: str, config, source: str) -> dict:
        """Register ``model_id``: ``config`` is a ``ModelConfig`` (or a
        ``repro_torch.configs`` registry name), ``source`` a checkpoint
        step directory (keyframe or delta-chain tip).  The step's whole
        chain is ingested into the content-addressed store; nothing is
        decoded until admission."""
        if model_id in self._registry:
            raise ZooError(f"model {model_id!r} already registered")
        if isinstance(config, str):
            from .. import configs
            config = configs.get(config)
        rec = self.store.add(model_id, source)
        self._registry[model_id] = {
            "cfg": config,
            "rec": rec,
            "bytes": model_resident_bytes(config, self.cfg.serve,
                                          backend=self.cfg.backend),
        }
        return rec

    def models(self) -> list[str]:
        return sorted(self._registry)

    def resident(self) -> list[str]:
        return sorted(self._resident)

    def resident_bytes(self) -> int:
        return sum(self._registry[m]["bytes"] for m in self._resident)

    def session(self, model_id: str) -> ServeSession | None:
        return self._resident.get(model_id)

    def touch(self, model_id: str) -> None:
        self._clock += 1
        self._last_used[model_id] = self._clock

    # -- admission / eviction -----------------------------------------------

    def admit(self, model_id: str) -> ServeSession:
        """Make ``model_id`` resident (no-op if it already is), evicting
        idle victims as needed to fit the budget.  Raises
        :class:`AdmissionStall` when only busy sessions hold the budget,
        :class:`ZooError` when the model cannot fit an empty zoo."""
        sess = self._resident.get(model_id)
        if sess is not None:
            self.touch(model_id)
            return sess
        ent = self._registry.get(model_id)
        if ent is None:
            raise ZooError(f"model {model_id!r} is not registered; "
                           f"known: {self.models()}")
        if ent["bytes"] > self.cfg.hbm_budget:
            raise ZooError(
                f"model {model_id!r} needs {ent['bytes']} B resident but "
                f"the zoo budget is {self.cfg.hbm_budget} B")
        while self.resident_bytes() + ent["bytes"] > self.cfg.hbm_budget:
            if not self._evict_one():
                raise AdmissionStall(
                    f"cannot admit {model_id!r}: every resident model "
                    f"({self.resident()}) still has requests in flight")
        t0 = time.perf_counter()
        warm = self._warm_base(ent)
        backend = get_backend(self.cfg.backend,
                              track_levels=self.cfg.track_levels,
                              policy_table=self.cfg.policy_table)
        if warm is not None:
            base_id, steps = warm
            base_sess = self._resident[base_id]
            params = backend.warm_from(ent["cfg"], base_sess.backend,
                                       base_sess.params, steps,
                                       device=self.device)
            kind = "warm"
        else:
            entries = delta_mod.restore_levels(ent["rec"]["tip"])
            params = backend.load_entries(ent["cfg"], entries,
                                          device=self.device)
            kind = "cold"
        sess = ServeSession.from_loaded(ent["cfg"], params, backend=backend,
                                        serve_cfg=self.cfg.serve,
                                        device=self.device)
        dt = time.perf_counter() - t0
        self._resident[model_id] = sess
        self._admit_s[model_id] = dt
        self._last_kind[model_id] = kind
        self.stats[f"admits_{kind}"] += 1
        self.stats[f"admit_s_{kind}"] += dt
        self.touch(model_id)
        return sess

    def _warm_base(self, ent: dict) -> tuple[str, list[str]] | None:
        """Find the resident model whose chain is the longest proper
        prefix of ``ent``'s (matched by the manifest-pinned per-link
        hashes): the delta variant can then warm from its levels by
        applying only the suffix steps.  None -> cold start."""
        if not self.cfg.track_levels:
            return None
        keys = ent["rec"]["chain_keys"]
        best: tuple[str, list[str]] | None = None
        best_len = 0
        for mid, sess in self._resident.items():
            other = self._registry[mid]
            if other["cfg"] != ent["cfg"]:
                continue
            okeys = other["rec"]["chain_keys"]
            n = len(okeys)
            if (n < len(keys) and keys[:n] == okeys and n > best_len
                    and sess.backend.track_levels):
                best = (mid, ent["rec"]["steps"][n:])
                best_len = n
        return best

    def _evict_one(self) -> bool:
        """Evict the idle resident model that is cheapest to bring back
        (measured admit seconds, ``cold_priors`` before the first
        measurement; ties fall to least-recently-used)."""
        idle = [m for m, s in self._resident.items()
                if not s.pending and s.num_parked == 0]
        if not idle:
            return False
        victim = min(idle, key=lambda m: (
            self._admit_s.get(m, self.cfg.cold_priors.get(m, 0.0)),
            self._last_used.get(m, 0)))
        self.evict(victim)
        return True

    def evict(self, model_id: str) -> None:
        """Close ``model_id``'s session: its device tensors are dropped at
        once, except the leaves a resident warm variant shares."""
        sess = self._resident.pop(model_id, None)
        if sess is None:
            return
        sess.close()
        self.stats["evictions"] += 1

    # -- reporting ----------------------------------------------------------

    def zoo_report(self) -> dict:
        """One-stop accounting: on-disk dedup (the ShardStore report),
        residency against the budget, and per-model admission economics
        (measured cost + how the last admit ran)."""
        per_model = {}
        for mid, ent in self._registry.items():
            per_model[mid] = {
                "resident": mid in self._resident,
                "resident_bytes": ent["bytes"],
                "chain_len": len(ent["rec"]["chain_keys"]),
                "disk_bytes": ent["rec"]["logical_bytes"],
                "admit_s": round(self._admit_s[mid], 6)
                           if mid in self._admit_s else None,
                "last_admit": self._last_kind.get(mid),
            }
        return {
            "hbm_budget": int(self.cfg.hbm_budget),
            "resident_bytes": int(self.resident_bytes()),
            "resident": self.resident(),
            "store": self.store.report(),
            "models": per_model,
            "stats": dict(self.stats),
        }

    def close(self) -> None:
        for mid in list(self._resident):
            self.evict(mid)


# ---------------------------------------------------------------------------
# Routing front end
# ---------------------------------------------------------------------------

class ZooHandle:
    """Client-side view of one routed request.  Mirrors
    :class:`~.session.RequestHandle` (``done`` / ``new_tokens`` /
    ``result`` / ``finish_reason``); tokens start flowing once the
    model is admitted and the inner session request exists."""

    def __init__(self, model_id: str, prompt, max_new_tokens: int,
                 temperature: float, seed):
        self.model_id = model_id
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.seed = seed
        self._inner: RequestHandle | None = None

    @property
    def admitted(self) -> bool:
        return self._inner is not None

    @property
    def done(self) -> bool:
        return self._inner is not None and self._inner.done

    @property
    def finish_reason(self) -> str | None:
        return self._inner.finish_reason if self._inner is not None else None

    def new_tokens(self) -> list:
        return self._inner.new_tokens() if self._inner is not None else []

    def result(self) -> np.ndarray:
        if not self.done:
            raise RuntimeError(
                f"request to {self.model_id!r} still in flight; run "
                f"router.step()")
        return self._inner.result()


class ZooRouter:
    """Route requests to a :class:`ModelZoo` by model id.

    ``submit`` never blocks: requests for cold models queue here and
    trigger admission on the next :meth:`step` (FIFO per model, so a
    zoo-routed model sees exactly the request order a dedicated session
    would).  Admission stalls (budget full of busy models) retry on
    later steps once residents drain."""

    def __init__(self, zoo: ModelZoo):
        self.zoo = zoo
        self._waiting: deque[ZooHandle] = deque()

    def submit(self, model_id: str, prompt, max_new_tokens: int,
               temperature: float = 0.0, seed=None) -> ZooHandle:
        if model_id not in self.zoo._registry:
            raise ZooError(f"model {model_id!r} is not registered; "
                           f"known: {self.zoo.models()}")
        handle = ZooHandle(model_id, prompt, max_new_tokens, temperature,
                           seed)
        self._waiting.append(handle)
        return handle

    @property
    def pending(self) -> bool:
        return bool(self._waiting) or any(
            s.pending for s in self.zoo._resident.values())

    def step(self) -> None:
        """One routing tick: hand waiting requests to their (admitted-
        on-demand) sessions, then advance every resident session that
        has work.  A request whose admission stalls stays queued; later
        requests for *other* models still flow (no head-of-line block
        across models), while FIFO order within each model holds."""
        still: deque[ZooHandle] = deque()
        stalled: set[str] = set()
        for handle in self._waiting:
            if handle.model_id in stalled:
                still.append(handle)        # keep per-model FIFO order
                continue
            try:
                sess = self.zoo.admit(handle.model_id)
            except AdmissionStall:
                stalled.add(handle.model_id)
                still.append(handle)
                continue
            handle._inner = sess.submit(
                handle.prompt, max_new_tokens=handle.max_new_tokens,
                temperature=handle.temperature, seed=handle.seed)
        self._waiting = still
        for mid, sess in list(self.zoo._resident.items()):
            if sess.pending:
                sess.step()
                self.zoo.touch(mid)

    def run(self, max_steps: int | None = None) -> None:
        """Step until every routed request finished (or ``max_steps``)."""
        steps = 0
        while self.pending:
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break

    def close(self) -> None:
        self.zoo.close()
