"""Request-level serving with continuous batching, slot mode (port of
``repro.serve.session``).

Clients ``submit(prompt, max_new_tokens, temperature)`` and get
:class:`RequestHandle`\\ s.  The session preallocates
``init_cache(cfg, slots, max_len)`` once.  Each tick admits queued
requests onto free slots — the FIFO prefix that shares one (bucketed)
prompt length prefills as one batch, padded prompts gathering their last
real position — then runs one decode step over every slot with per-slot
ragged positions, then evicts requests that hit EOS or their length.
Sampling is the reference's host numpy code, so greedy and temperature
tokens match it.  The paged KV cache (``kv_page_size``) is not ported.
The session serves token models, as the reference's does: a model that
takes embeddings (``embed_input=False``) is refused, and runs through
``prefill`` / ``decode_step`` with ``embeds=``.  The slot caches are the
GQA cache's (L, B, Smax, G, D) tensors, MLA's (L, B, Smax, R) latents,
an SSM model's state (L, B, H, P, N) in f32 and conv tails (L, B, W-1, C)
in the compute dtype, or a hybrid's SSM state beside the attention cache
of its groups: axis 1 is the slot axis in every one.  A decode step runs
over every slot, so a free slot's SSM state moves on too; an admission
overwrites all of the slot's caches.

On the card, prefill and decode replay CUDA graphs (``serve.graphs``), as
the reference runs them through ``jax.jit``: one decode graph (decode
always runs over every slot) and one prefill graph per (rows, bucket
length, padded) shape, each captured on the shape's second use.  A step
writes into the session's own tensors: the slot caches (a prefill places
its rows through a slot-index input) and one logits buffer.  These and
the parameters are written in place, never reallocated, since the graphs
hold their addresses; a graph keeps no output of its own, so more prompt
lengths mean more graphs but no more device memory than the largest
step's temporaries.  ``eager_steps()`` runs the steps eagerly.

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

import itertools
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from ..compression.tree import flatten_tree
from ..kernels.registry import resolve_device
from ..models.config import ModelConfig
from ..models.transformer import decode_step, init_cache, prefill
from .backends import resolve_backend
from .graphs import StepGraphs, eager_steps  # noqa: F401


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
    kv_page_size: int | None = None   # paged KV: not yet ported


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


class ServeSession:
    """Continuous-batching serving session over a slot KV cache."""

    def __init__(self, cfg: ModelConfig, weights, *, backend="bf16",
                 serve_cfg: ServeConfig | None = None, device="cuda",
                 preloaded: bool = False):
        serve_cfg = serve_cfg or ServeConfig()
        if serve_cfg.slots < 1 or serve_cfg.max_len < 1:
            raise ValueError(
                f"ServeConfig needs slots >= 1 and max_len >= 1; got "
                f"slots={serve_cfg.slots}, max_len={serve_cfg.max_len}")
        if serve_cfg.kv_page_size is not None:
            raise NotImplementedError("paged KV cache: not yet ported")
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
        self.params = (weights if preloaded else
                       self.backend.load(cfg, weights, device=self.device))

        self._slots = [_Slot() for _ in range(serve_cfg.slots)]
        self._queue: deque[RequestHandle] = deque()
        self._ids = itertools.count()
        self._rngs: dict[int, np.random.Generator] = {}
        self.stats = {"decode_steps": 0, "decode_rows": 0,
                      "free_slot_rows": 0, "skipped_all_free_steps": 0,
                      "prefill_tokens": 0, "swaps": 0, "graph_resets": 0}
        self._caches = init_cache(cfg, serve_cfg.slots, serve_cfg.max_len,
                                  device=self.device)
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
    def pending(self) -> bool:
        return bool(self._queue) or self.num_active > 0

    def cancel(self, handle: RequestHandle) -> bool:
        """Abort a queued or active request, freeing its slot.  Finished
        requests are left alone (returns False)."""
        if handle.done:
            return False
        for i, req in enumerate(self._queue):
            if req is handle:
                del self._queue[i]
                return self._finish_cancelled(handle)
        for s in self._slots:
            if s.req is handle:
                s.clear()
                return self._finish_cancelled(handle)
        raise ValueError(f"request {handle.id} is not known to this session")

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

    # -- scheduler -----------------------------------------------------------

    def step(self) -> None:
        """One tick: admit onto free slots, one batched decode step over
        every slot, evict finished requests."""
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
            self._maybe_evict(slot)

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
                self._maybe_evict(slot)

    def _place(self, caches_g: dict, slots_idx: torch.Tensor) -> None:
        """Copy a batch-k prefill's caches into slots ``slots_idx`` ((k,)
        int64 on the device): axis 1 of every cache leaf is the slot axis,
        in a flat {"k", "v"} or {"ckv", "kr"} tree, a MoE model's nested
        {"dense": ..., "main": ...} one, an SSM model's {"conv": {"x", "b",
        "c"}, "state"} or a hybrid's {"ssm": ..., "attn": ...}."""
        part = flatten_tree(caches_g)
        for name, full in flatten_tree(self._caches).items():
            full.index_copy_(1, slots_idx, part[name].to(full.dtype))

    def _maybe_evict(self, slot: _Slot) -> None:
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
        slot.clear()

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
