"""Request-level serving with continuous batching (port of
``repro.serve.session``).

Clients ``submit(prompt, max_new_tokens, temperature)`` and get
:class:`RequestHandle`\\ s.  Each tick admits queued requests, runs one
batched decode step and evicts requests that hit EOS or their length.
Sampling is the reference's host numpy code, so greedy and temperature
tokens match it.  The session serves token models, as the reference's
does: a model that takes embeddings (``embed_input=False``) is refused,
and runs through ``prefill`` / ``decode_step`` with ``embeds=``.

Two cache layouts:

* **Slot mode** (default): ``init_cache(cfg, slots, max_len)`` once.  The
  FIFO prefix of the queue that shares one (bucketed) prompt length
  prefills as one batch, padded prompts gathering their last real
  position, and its caches are placed into free slots; decode runs over
  every slot with per-slot ragged positions.  The slot caches are the GQA
  cache's (L, B, Smax, G, D) tensors, MLA's (L, B, Smax, R) latents, an
  SSM model's state (L, B, H, P, N) in f32 and conv tails (L, B, W-1, C)
  in the compute dtype, or a hybrid's SSM state beside the attention
  cache of its groups: axis 1 is the slot axis in every one.  A decode
  step runs over every slot, so a free slot's SSM state moves on too; an
  admission overwrites all of the slot's caches.
* **Paged mode** (``ServeConfig.kv_page_size``, attention families only):
  the cache is a page pool and a page table per slot
  (:mod:`repro_torch.serve.kv`).  Resumes are admitted before fresh
  requests; each admission prefills alone (page tables are per request):
  the whole (bucketed) prompt into a contiguous cache scattered to its
  pages, or, on a shared-prefix hit, only the suffix over the gathered
  prefix pages.  A fresh admission may park a victim slot to make room,
  never while resumes wait.  Decode batches are compacted to the active
  slots, padded to a power of two over the scratch page, so free slots
  burn no decode rows.  Cold pages are entropy-coded (``kv-q8-cabac``)
  to a host cold store: a slot the pool cannot grow parks itself and
  resumes when pressure clears, and :meth:`ServeSession.park` /
  :meth:`~ServeSession.resume` do it by hand.

On the card, every step replays a CUDA graph (``serve.graphs``), as the
reference runs it through ``jax.jit``, captured on the second use of its
shape: in slot mode one decode graph (decode always runs over every slot)
and one prefill graph per (rows, bucket length, padded); in paged mode
one decode graph per compacted batch (its static inputs the tokens, the
positions and the (bs, n_max) page table), one admission-prefill graph
per (cache length, length, padded) with the page ids as an input, and one
partial-prefill graph per (prefix pages, suffix length).  A step writes
into the session's own tensors: the slot caches or page pools and one
logits buffer.  These and the parameters are written in place, never
reallocated, since the graphs hold their addresses: parks, resumes and
restores copy pages into the existing pools, so nothing is recaptured.
A graph keeps no output of its own, so more shapes mean more graphs but
no more device memory than the largest step's temporaries.
``eager_steps()`` runs the steps eagerly.

:meth:`ServeSession.swap_weights` swaps a delta ("P-frame") checkpoint
step into a running session between steps: each updated tensor is written
into the resident one in place (``copy_``, same shape and dtype by
construction), so the captured graphs replay with the new weights and
nothing is recaptured.  A leaf the session shares with another session's
tree (``WeightBackend.warm_from``) is replaced by a new tensor instead, so
the other session's weights stay as they were, and this session's graphs
are dropped to capture again (``stats["graph_resets"]``).
"""

from __future__ import annotations

import functools
import itertools
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from ..compression.tree import flatten_tree, unflatten
from ..kernels.registry import resolve_device
from ..models.config import ModelConfig
from ..models.transformer import decode_step, forward, init_cache, prefill
from .backends import resolve_backend
from .graphs import StepGraphs, eager_steps  # noqa: F401
from .kv import PagedKV, kv_cache_bytes


def require_token_input(cfg: ModelConfig) -> None:
    """Raise ValueError for a model without a token embedding: the session
    feeds tokens, and such a model takes embeddings."""
    if not cfg.embed_input:
        raise ValueError(
            f"{cfg.name} takes embeddings (embed_input=False), and the "
            "serving session feeds tokens: run it through "
            "models.transformer.prefill / decode_step with embeds=")


@dataclass(frozen=True)
class ServeConfig:
    """Session knobs (model shape/quantization stays on ModelConfig)."""

    slots: int = 4                 # concurrent requests in the KV cache
    max_len: int = 512             # per-slot KV capacity (prompt + new)
    eos_token: int | None = None   # evict a request when it emits this id
    kv_cache_delta: float | None = None   # override the int8 KV grid step
    seed: int = 0                  # base seed for temperature sampling
    prefill_buckets: tuple = ()    # sorted prompt-length buckets: pad each
    # admission prefill up to the next bucket (dense family only)

    # -- paged KV cache ----------------------------------------------------
    kv_page_size: int | None = None   # tokens per page; None = slot mode
    kv_pool_pages: int | None = None  # hot pool size; None sizes it for
    # every slot at max_len (no eviction pressure)
    kv_cold_store: str = "host"       # KVColdStore registry name/instance
    kv_evict_codec: str = "kv-q8-cabac"   # compression codec for cold pages
    kv_prefix_sharing: bool = True    # share page-aligned prompt prefixes
    kv_restore_workers: int = 0       # >0: entropy-decode restores on a
    # worker pool, so the decode hides behind the admission path


@dataclass
class RequestHandle:
    """Client-side view of one submitted request."""

    id: int
    prompt: np.ndarray             # (S,) int32
    max_new_tokens: int
    temperature: float = 0.0
    seed: object = None            # per-request sampling seed (int/tuple)
    tokens: list = field(default_factory=list)   # generated ids (incl. EOS)
    done: bool = False
    finish_reason: str | None = None     # "eos" | "length" | "cancelled"
    _stream_cursor: int = 0

    def new_tokens(self) -> list:
        """Drain this request's token stream (ids since the last call)."""
        out = self.tokens[self._stream_cursor:]
        self._stream_cursor = len(self.tokens)
        return out

    def result(self) -> np.ndarray:
        if not self.done:
            raise RuntimeError("request still in flight; run session.step()")
        return np.asarray(self.tokens, dtype=np.int32)


class _Slot:
    __slots__ = ("req", "pos", "next_token")

    def __init__(self):
        self.req: RequestHandle | None = None
        self.pos = 0               # where next_token's KV will be written
        self.next_token = 0        # token to feed on the next decode step

    def clear(self):
        self.req, self.pos, self.next_token = None, 0, 0


def _local_tree(tree, device):
    """``tree`` with each ``DTensor`` leaf (a backend's load onto a
    ``DeviceMesh``) replaced by its local tensor, which must be the whole
    tensor (a mesh of one, or replicated) on ``device``: serving a tree
    sharded across ranks is not yet ported."""
    from torch.distributed.tensor import DTensor
    flat = flatten_tree(tree)
    if not any(isinstance(v, DTensor) for v in flat.values()):
        return tree
    out = {}
    for name, leaf in flat.items():
        if isinstance(leaf, DTensor):
            local = leaf.to_local()
            if tuple(local.shape) != tuple(leaf.shape):
                raise NotImplementedError(
                    f"{name}: a tree sharded across ranks ({leaf.placements}"
                    f" on a mesh of {leaf.device_mesh.size()}): serving it "
                    "is not yet ported")
            if local.device.type != device.type:
                raise ValueError(f"{name}: on {local.device}, the session "
                                 f"on {device}")
            leaf = local
        out[name] = leaf
    return unflatten(out)


class ServeSession:
    """Continuous-batching serving session over a slot or paged KV
    cache.  A tree of ``DTensor`` leaves is served where every leaf is
    whole on this rank (:func:`_local_tree`)."""

    def __init__(self, cfg: ModelConfig, weights, *, backend="bf16",
                 serve_cfg: ServeConfig | None = None, device="cuda",
                 preloaded: bool = False):
        serve_cfg = serve_cfg or ServeConfig()
        if serve_cfg.slots < 1 or serve_cfg.max_len < 1:
            raise ValueError(
                f"ServeConfig needs slots >= 1 and max_len >= 1; got "
                f"slots={serve_cfg.slots}, max_len={serve_cfg.max_len}")
        require_token_input(cfg)
        if serve_cfg.kv_cache_delta is not None:
            cfg = cfg.replace(kv_cache_delta=serve_cfg.kv_cache_delta)
        if serve_cfg.prefill_buckets and cfg.family != "dense":
            raise ValueError(
                "prefill_buckets pads prompts, which only dense-family "
                f"models ignore; got family {cfg.family!r}")
        if any(b > serve_cfg.max_len for b in serve_cfg.prefill_buckets):
            raise ValueError(
                f"prefill bucket exceeds max_len {serve_cfg.max_len}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.serve_cfg = serve_cfg
        self.backend = resolve_backend(backend)
        # preloaded: ``weights`` is already this backend's serving tree
        # (built by load_entries or warm_from); loading it again would
        # clobber the backend's tracked levels
        self.params = _local_tree(
            weights if preloaded else
            self.backend.load(cfg, weights, device=self.device),
            self.device)

        self._slots = [_Slot() for _ in range(serve_cfg.slots)]
        self._queue: deque[RequestHandle] = deque()
        self._ids = itertools.count()
        self._rngs: dict[int, np.random.Generator] = {}
        self.stats = {
            "decode_steps": 0, "decode_rows": 0, "free_slot_rows": 0,
            "padded_rows": 0, "skipped_all_free_steps": 0,
            "prefill_tokens": 0, "prefix_reused_tokens": 0,
            "parks": 0, "resumes": 0, "admit_stalls": 0,
            "swaps": 0, "graph_resets": 0,
        }
        self._paged = serve_cfg.kv_page_size is not None
        if self._paged:
            self._caches = None        # no slot cache allocated
            self._kv = PagedKV(
                cfg, slots=serve_cfg.slots, max_len=serve_cfg.max_len,
                page_size=serve_cfg.kv_page_size,
                pool_pages=serve_cfg.kv_pool_pages,
                cold_store=serve_cfg.kv_cold_store,
                codec=serve_cfg.kv_evict_codec,
                prefix_sharing=serve_cfg.kv_prefix_sharing,
                restore_workers=serve_cfg.kv_restore_workers,
                device=self.device)
            self._resume_q: deque = deque()     # (req, parked, pos, next)
            self._parked: dict = {}             # manual parks, by req id
        else:
            self._kv = None
            self._caches = init_cache(cfg, serve_cfg.slots,
                                      serve_cfg.max_len, device=self.device)
        # the last step's logits, rows [:k] after a k-row prefill
        self.logits = torch.empty((serve_cfg.slots, cfg.vocab_size),
                                  dtype=torch.float32, device=self.device)
        self.graphs = StepGraphs(self.device)

    @classmethod
    def from_container(cls, cfg: ModelConfig, blob: bytes, *,
                       backend="container",
                       serve_cfg: ServeConfig | None = None,
                       device="cuda") -> "ServeSession":
        """Build a session straight from a DCBC deployment artifact."""
        return cls(cfg, blob, backend=backend, serve_cfg=serve_cfg,
                   device=device)

    @classmethod
    def from_loaded(cls, cfg: ModelConfig, params, *, backend,
                    serve_cfg: ServeConfig | None = None,
                    device="cuda") -> "ServeSession":
        """Wrap an already-built serving tree.  ``backend`` must be the
        instance that produced ``params`` (its tracked levels, if any,
        describe exactly this tree), so delta swaps keep working."""
        return cls(cfg, params, backend=backend, serve_cfg=serve_cfg,
                   device=device, preloaded=True)

    # -- client API ----------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int,
               temperature: float = 0.0, seed=None) -> RequestHandle:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("prompt must contain at least one token")
        if prompt.size + max_new_tokens > self.serve_cfg.max_len:
            raise ValueError(
                f"prompt ({prompt.size}) + max_new_tokens "
                f"({max_new_tokens}) exceeds slot capacity "
                f"{self.serve_cfg.max_len}")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        req = RequestHandle(id=next(self._ids), prompt=prompt,
                            max_new_tokens=max_new_tokens,
                            temperature=temperature, seed=seed)
        self._queue.append(req)
        return req

    @property
    def num_queued(self) -> int:
        return len(self._queue)

    @property
    def num_active(self) -> int:
        return sum(s.req is not None for s in self._slots)

    @property
    def num_parked(self) -> int:
        """Requests evicted to the compressed cold store (paged mode):
        auto-parked ones waiting to resume, plus manual :meth:`park`\\ s."""
        if not self._paged:
            return 0
        return len(self._resume_q) + len(self._parked)

    @property
    def pending(self) -> bool:
        active = bool(self._queue) or self.num_active > 0
        if self._paged:
            # manual parks wait for an explicit resume(); auto-parked
            # requests re-admit themselves, so they count
            return active or bool(self._resume_q)
        return active

    def park(self, handle: RequestHandle) -> None:
        """Evict ``handle``'s slot to the compressed cold store.  The
        request keeps its sampling state and resumes token-identically
        (int8 caches round-trip bit-exactly) after :meth:`resume`."""
        if not self._paged:
            raise ValueError("park() needs the paged KV cache "
                             "(ServeConfig.kv_page_size)")
        idx = self._slot_of(handle)
        slot = self._slots[idx]
        parked = self._kv.park(idx)
        self._parked[handle.id] = (handle, parked, slot.pos,
                                   slot.next_token)
        slot.clear()
        self.stats["parks"] += 1

    def resume(self, handle: RequestHandle) -> None:
        """Queue a manually parked request for re-admission; its pages
        restore through the lane-parallel decoder on the next steps."""
        rec = self._parked.pop(handle.id, None)
        if rec is None:
            raise ValueError(f"request {handle.id} is not parked")
        self._kv.prefetch(rec[1])
        self._resume_q.append(rec)

    def cancel(self, handle: RequestHandle) -> bool:
        """Abort a request wherever it lives (queued, active, manually
        parked or waiting to resume), releasing its slot or pages and, for
        a parked request, dropping its cold-store blob.  Finished
        requests are left alone (returns False)."""
        if handle.done:
            return False
        for i, req in enumerate(self._queue):
            if req is handle:
                del self._queue[i]
                return self._finish_cancelled(handle)
        if self._paged:
            rec = self._parked.pop(handle.id, None)
            if rec is not None:
                self._kv.discard(rec[1])
                return self._finish_cancelled(handle)
            for i, rec in enumerate(self._resume_q):
                if rec[0] is handle:
                    del self._resume_q[i]
                    self._kv.discard(rec[1])
                    return self._finish_cancelled(handle)
        for i, s in enumerate(self._slots):
            if s.req is handle:
                if self._paged:
                    self._kv.release(i)
                s.clear()
                return self._finish_cancelled(handle)
        raise ValueError(f"request {handle.id} is not known to this session")

    def _slot_of(self, handle: RequestHandle) -> int:
        for i, s in enumerate(self._slots):
            if s.req is handle:
                return i
        raise ValueError(f"request {handle.id} holds no slot")

    def _finish_cancelled(self, handle: RequestHandle) -> bool:
        handle.done = True
        handle.finish_reason = "cancelled"
        self._rngs.pop(handle.id, None)
        return True

    def swap_weights(self, source) -> int:
        """Swap in a delta ("P-frame") checkpoint step between steps: the
        backend decodes the step's records against its tracked base
        levels (``WeightBackend.apply_delta``) and each updated tensor is
        written into the resident one in place.  In-flight requests keep
        their slots and caches; the next step decodes with the new
        weights, and the captured graphs replay without a recapture.  A
        shape or dtype that differs from the resident leaf's raises.  A
        leaf shared with another session (``backend.shared``) is replaced
        instead, and this session's graphs are dropped.  Returns the
        number of updated tensors."""
        updates = self.backend.apply_delta(self.cfg, source,
                                           device=self.device)
        replaced = False
        for name, leaf in updates.items():
            *parents, last = name.split("/")
            node = self.params
            for p in parents:
                node = node[p]
            if name in self.backend.shared:
                _check_like(name, node[last], leaf)
                node[last] = leaf
                self.backend.shared.discard(name)
                replaced = True
            else:
                _copy_into(name, node[last], leaf)
        if replaced:
            self.graphs.reset()
            self.stats["graph_resets"] += 1
        self.stats["swaps"] += 1
        return len(updates)

    def run(self, max_steps: int | None = None) -> None:
        """Step until every submitted request finished (or max_steps)."""
        steps = 0
        while self.pending:
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break

    def close(self) -> None:
        """Release what the session holds on the device: the captured
        graphs (with their memory pool), the slot caches or the page pools
        (the paged cold store is closed first), the logits buffer and the
        reference to the parameter tree.  Nothing is freed, resized or
        written: a leaf another session shares (``warm_from``) keeps its
        storage and values.  A closed session serves no more; closing it
        again is a no-op."""
        if self.params is None:
            return
        if self._paged:
            self._kv.close()
        self.graphs = None
        self._kv = self._caches = self.logits = self.params = None

    # -- capacity accounting -------------------------------------------------

    def kv_bytes_per_slot(self) -> int:
        """Device KV bytes one request at full ``max_len`` costs, from the
        real cache shapes on the meta device (``serve.kv.kv_cache_bytes``),
        never recomputed by hand."""
        return kv_cache_bytes(self.cfg, 1, self.serve_cfg.max_len)

    def kv_report(self) -> dict:
        """Total-KV accounting: device-resident bytes plus compressed
        host bytes, the per-slot cost and the scheduler counters."""
        if self._paged:
            r = self._kv.report()
        else:
            r = {"mode": "slots",
                 "device_bytes": int(sum(
                     t.numel() * t.element_size()
                     for t in flatten_tree(self._caches).values())),
                 "host_compressed_bytes": 0}
        r["slots"] = len(self._slots)
        r["max_len"] = self.serve_cfg.max_len
        r["bytes_per_slot"] = self.kv_bytes_per_slot()
        r["scheduler"] = dict(self.stats)
        return r

    # -- scheduler -----------------------------------------------------------

    def step(self) -> None:
        """One tick: admit onto free slots, one batched decode step, evict
        finished requests.  In slot mode the decode batch spans every
        slot; in paged mode it is compacted to the active ones."""
        if self._paged:
            return self._step_paged()
        self._admit()
        if self.num_active == 0:
            self.stats["skipped_all_free_steps"] += 1
            return
        tok = np.zeros(len(self._slots), np.int32)
        pos = np.zeros(len(self._slots), np.int32)
        for i, slot in enumerate(self._slots):
            if slot.req is not None:
                tok[i] = slot.next_token
                pos[i] = slot.pos
        self.stats["decode_steps"] += 1
        self.stats["decode_rows"] += len(self._slots)
        self.stats["free_slot_rows"] += len(self._slots) - self.num_active
        self.graphs.run(("decode",), self._decode, (tok, pos))
        logits = self._host(len(self._slots))
        for i, slot in enumerate(self._slots):
            if slot.req is None:
                continue
            slot.pos += 1
            nxt = self._sample(logits[i], slot.req)
            slot.req.tokens.append(nxt)
            slot.next_token = nxt
            self._maybe_evict(slot, i)

    def _admit(self) -> None:
        """Admit queued requests onto free slots; the FIFO prefix sharing
        one (bucketed) length prefills as a single batch."""
        while self._queue:
            free = [i for i, s in enumerate(self._slots) if s.req is None]
            if not free:
                return
            length = self._bucket_len(self._queue[0].prompt.size)
            group = []
            for req in itertools.islice(self._queue, len(free)):
                if self._bucket_len(req.prompt.size) != length:
                    break
                group.append(req)
            for _ in group:
                self._queue.popleft()
            slots_idx = free[:len(group)]

            toks = np.zeros((len(group), length), np.int32)
            for j, req in enumerate(group):
                toks[j, :req.prompt.size] = req.prompt
            inputs = (np.asarray(slots_idx, np.int64), toks)
            if any(req.prompt.size < length for req in group):
                inputs += (np.asarray([r.prompt.size - 1 for r in group],
                                      np.int32),)
            self.graphs.run(("prefill", len(group), length, len(inputs) == 3),
                            self._prefill, inputs)
            logits = self._host(len(group))
            for j, req in enumerate(group):
                slot = self._slots[slots_idx[j]]
                first = self._sample(logits[j], req)
                req.tokens.append(first)
                slot.req = req
                slot.pos = req.prompt.size
                slot.next_token = first
                self.stats["prefill_tokens"] += length
                self._maybe_evict(slot, slots_idx[j])

    def _place(self, caches_g: dict, slots_idx: torch.Tensor) -> None:
        """Copy a batch-k prefill's caches into slots ``slots_idx`` ((k,)
        int64 on the device): axis 1 of every cache leaf is the slot axis,
        in a flat {"k", "v"} or {"ckv", "kr"} tree, a MoE model's nested
        {"dense": ..., "main": ...} one, an SSM model's {"conv": {"x", "b",
        "c"}, "state"} or a hybrid's {"ssm": ..., "attn": ...}."""
        part = flatten_tree(caches_g)
        for name, full in flatten_tree(self._caches).items():
            full.index_copy_(1, slots_idx, part[name].to(full.dtype))

    def _maybe_evict(self, slot: _Slot, idx: int) -> None:
        req = slot.req
        eos = self.serve_cfg.eos_token
        if eos is not None and req.tokens[-1] == eos:
            req.finish_reason = "eos"
        elif len(req.tokens) >= req.max_new_tokens:
            req.finish_reason = "length"
        elif slot.pos >= self.serve_cfg.max_len:
            req.finish_reason = "length"
        else:
            return
        req.done = True
        self._rngs.pop(req.id, None)
        if self._paged:
            self._kv.release(idx)
        slot.clear()

    # -- paged scheduler -----------------------------------------------------

    def _step_paged(self) -> None:
        self._admit_paged()
        active = [i for i, s in enumerate(self._slots) if s.req is not None]
        if not active:
            self.stats["skipped_all_free_steps"] += 1
            return
        # page-boundary allocation; a slot the pool cannot grow parks
        # itself (compressed to the host) and re-admits when pressure clears
        still = []
        for i in active:
            if self._kv.ensure_writable(i, self._slots[i].pos):
                still.append(i)
            else:
                self._auto_park(i)
        active = still
        if not active:
            return
        bs = min(1 << (len(active) - 1).bit_length(), len(self._slots))
        tok = np.zeros(bs, np.int32)
        pos = np.zeros(bs, np.int32)
        pages = np.zeros((bs, self._kv.n_max), np.int32)   # pads -> scratch
        for j, i in enumerate(active):
            tok[j] = self._slots[i].next_token
            pos[j] = self._slots[i].pos
            pages[j] = self._kv.page_row(i)
        self.stats["decode_steps"] += 1
        self.stats["decode_rows"] += bs
        self.stats["padded_rows"] += bs - len(active)
        self.graphs.run(("decode_paged", bs), self._decode_paged,
                        (tok, pos, pages))
        logits = self._host(bs)
        for j, i in enumerate(active):
            slot = self._slots[i]
            slot.pos += 1
            nxt = self._sample(logits[j], slot.req)
            slot.req.tokens.append(nxt)
            slot.next_token = nxt
            self._maybe_evict(slot, i)

    def _admit_paged(self) -> None:
        """Resumes first (FIFO), then fresh admissions, one batch-1
        prefill each, since page tables are per request."""
        while self._resume_q:
            free = [i for i, s in enumerate(self._slots) if s.req is None]
            if not free:
                return
            req, parked, pos, next_token = self._resume_q[0]
            if not self._kv.resume(free[0], parked):
                self.stats["admit_stalls"] += 1
                break                      # pool pressure; retry next step
            self._resume_q.popleft()
            slot = self._slots[free[0]]
            slot.req, slot.pos, slot.next_token = req, pos, next_token
            self.stats["resumes"] += 1
        while self._queue:
            free = [i for i, s in enumerate(self._slots) if s.req is None]
            if not free:
                return
            req = self._queue[0]
            # fresh admissions may park a victim slot to make room, but
            # never while resumes are waiting (no priority inversion)
            make_room = self._park_victim if not self._resume_q else None
            min_len = self._bucket_len(req.prompt.size)
            ctx_len = self._kv.admit(free[0], req.prompt, min_len=min_len,
                                     make_room=make_room)
            if ctx_len is None:
                self.stats["admit_stalls"] += 1
                return
            self._queue.popleft()
            logits_row = self._prefill_paged(free[0], req, ctx_len)
            self._kv.publish(free[0])
            slot = self._slots[free[0]]
            first = self._sample(logits_row, req)
            req.tokens.append(first)
            slot.req = req
            slot.pos = req.prompt.size
            slot.next_token = first
            self._maybe_evict(slot, free[0])

    def _prefill_paged(self, idx: int, req: RequestHandle,
                       ctx_len: int) -> np.ndarray:
        """Prefill into the slot's fresh page table.  On a shared-prefix
        hit only the suffix runs (a partial prefill over the gathered
        prefix pages); otherwise the whole (bucketed) prompt prefills into
        a contiguous cache that is scattered to the pages."""
        prompt = req.prompt
        page = self._kv.page
        ids = np.asarray(self._kv.slot_ids(idx), np.int64)
        if ctx_len > 0:
            n_ctx = ctx_len // page
            suffix = np.ascontiguousarray(prompt[None, ctx_len:])
            self.graphs.run(("partial_prefill", n_ctx, suffix.shape[1]),
                            functools.partial(self._partial_prefill, n_ctx),
                            (ids, suffix))
            self.stats["prefix_reused_tokens"] += ctx_len
            self.stats["prefill_tokens"] += prompt.size - ctx_len
            return self._host(1)[0]
        length = self._bucket_len(prompt.size)
        toks = np.zeros((1, length), np.int32)
        toks[0, :prompt.size] = prompt
        inputs = (ids, toks)
        if prompt.size < length:
            inputs += (np.asarray([prompt.size - 1], np.int32),)
        self.graphs.run(("prefill_paged", len(ids) * page, length,
                         len(inputs) == 3), self._prefill_pages, inputs)
        self.stats["prefill_tokens"] += length
        return self._host(1)[0]

    def _auto_park(self, idx: int) -> None:
        slot = self._slots[idx]
        parked = self._kv.park(idx)
        rec = (slot.req, parked, slot.pos, slot.next_token)
        self._kv.prefetch(parked)
        self._resume_q.append(rec)
        slot.clear()
        self.stats["parks"] += 1

    def _park_victim(self) -> bool:
        """Pool-pressure callback: auto-park the active slot holding the
        most pages (ties to the youngest request, keeping older requests
        running).  False when no slot can be parked."""
        cands = [(len(self._kv.slot_ids(i)), self._slots[i].req.id, i)
                 for i, s in enumerate(self._slots) if s.req is not None]
        if not cands:
            return False
        _, _, idx = max(cands)
        self._auto_park(idx)
        return True

    # -- steps (what the graphs capture) ------------------------------------

    def _decode(self, tok, pos):
        logits, _ = decode_step(self.params, self.cfg, self._caches, pos,
                                tokens=tok)
        self.logits.copy_(logits)

    def _prefill(self, slots_idx, toks, last_index=None):
        logits, caches_g = prefill(self.params, self.cfg, tokens=toks,
                                   max_len=self.serve_cfg.max_len,
                                   last_index=last_index)
        self._place(caches_g, slots_idx)
        self.logits[:toks.shape[0]].copy_(logits)

    def _decode_paged(self, tok, pos, pages):
        logits, _ = decode_step(self.params, self.cfg, self._kv.pools, pos,
                                tokens=tok, cache_pages=pages)
        self.logits[:tok.shape[0]].copy_(logits)

    def _prefill_pages(self, ids, toks, last_index=None):
        """A whole-prompt admission: prefill into a contiguous batch-1
        cache of ``len(ids)`` pages, then copy it into pool pages
        ``ids``."""
        page = self._kv.page
        logits, caches = prefill(self.params, self.cfg, tokens=toks,
                                 max_len=ids.shape[0] * page,
                                 last_index=last_index)
        part = flatten_tree(caches)
        for name, pool in self._kv.leaves.items():
            c = part[name]
            pool.index_copy_(1, ids, c.reshape(
                c.shape[0], ids.shape[0], page, *c.shape[3:]).to(pool.dtype))
        self.logits[:1].copy_(logits)

    def _partial_prefill(self, n_ctx, ids, toks):
        """A suffix prefill over a shared prefix: gather the slot's pages
        into a contiguous (L, 1, n * page, ...) view, run the suffix at
        ``cache_pos = n_ctx * page`` (the S > 1 cache write with a ragged
        ``kv_len``: the scan, recorded), and copy back only the suffix
        pages; the shared prefix pages are read only."""
        page = self._kv.page
        n = ids.shape[0]
        contig = {}
        for name, pool in self._kv.leaves.items():
            g = pool.index_select(1, ids)
            contig[name] = g.reshape(g.shape[0], 1, n * page, *g.shape[3:])
        logits, _, _ = forward(self.params, self.cfg, tokens=toks,
                               caches=unflatten(contig),
                               cache_pos=n_ctx * page, last_only=True,
                               with_aux=False)
        for name, pool in self._kv.leaves.items():
            c = contig[name].reshape(pool.shape[0], n, page, *pool.shape[3:])
            pool.index_copy_(1, ids[n_ctx:], c[:, n_ctx:])
        self.logits[:1].copy_(logits[:, 0])

    # -- helpers -------------------------------------------------------------

    def _host(self, rows: int) -> np.ndarray:
        """The last step's logits of ``rows`` rows on the host (on the CPU
        a view of the buffer: read it before the next step)."""
        return self.logits[:rows].cpu().numpy()

    def _bucket_len(self, n: int) -> int:
        """Smallest configured prefill bucket >= n (n itself if none)."""
        fits = [b for b in self.serve_cfg.prefill_buckets if b >= n]
        return min(fits) if fits else n

    def _sample(self, logits_row: np.ndarray, req: RequestHandle) -> int:
        if req.temperature <= 0.0:
            return int(np.argmax(logits_row))
        rng = self._rngs.get(req.id)
        if rng is None:
            # per-request seed (reproducible across sessions) or a
            # session-seed + request-id derivation
            key = (req.seed if req.seed is not None
                   else (self.serve_cfg.seed, req.id))
            rng = np.random.default_rng(key)
            self._rngs[req.id] = rng
        z = logits_row.astype(np.float64) / req.temperature
        return int(np.argmax(z + rng.gumbel(size=z.shape)))


def _pairs(name: str, old, new) -> list:
    """(name, resident tensor, update) per tensor of a leaf: a q8 leaf is
    a ``{"q8", "q8s"}`` dict."""
    if isinstance(old, dict) or isinstance(new, dict):
        if not (isinstance(old, dict) and isinstance(new, dict)
                and old.keys() == new.keys()):
            raise ValueError(f"{name}: the update's structure differs "
                             "from the resident leaf's")
        return [(f"{name}/{k}", old[k], new[k]) for k in sorted(old)]
    return [(name, old, new)]


def _check_like(name: str, old, new) -> list:
    pairs = _pairs(name, old, new)
    for n, o, t in pairs:
        if o.shape != t.shape or o.dtype != t.dtype:
            raise ValueError(
                f"{n}: update {tuple(t.shape)} {t.dtype} does not match "
                f"the resident {tuple(o.shape)} {o.dtype}")
    return pairs


def _copy_into(name: str, old, new) -> None:
    """Write ``new`` into the resident leaf ``old`` in place (the graphs
    hold its address)."""
    for _, o, t in _check_like(name, old, new):
        o.copy_(t)
