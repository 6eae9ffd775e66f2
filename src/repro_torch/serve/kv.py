"""Paged KV cache with entropy-coded eviction and prefix sharing (the
port's copy of ``repro.serve.kv``).

``PagedKV`` replaces the session's slot-indexed KV tensors with three
pieces:

* a **hot page pool**: ``init_cache(cfg, pool_pages, page_size)``, so
  every cache leaf is a pool of fixed-size token pages (L, P, page, ...),
  the layer axis leading as in the slot caches it replaces.  Pool page 0
  is a scratch page: it is never allocated, and the padding rows of a
  compacted decode batch aim all their reads and writes at it.
* a **page table**: per slot, an ordered list of pool page ids covering
  the slot's written positions; decode hands the model a dense
  (B, n_max) ``cache_pages`` map (``models.attention._paged_update_load``).
* a **compressed cold store**: cold pages (idle shared prefixes, parked
  requests) are coded by the ``kv-q8-cabac`` codec (int8 cache levels
  CABAC-coded losslessly; float caches q8-block-quantized first) into
  v3-chunked DCBC records and moved to a :class:`~.backends.KVColdStore`.
  Restores decode every chunk through the lane-parallel batched decoder,
  optionally on a worker thread (``restore_workers``).

The pools are allocated once and only ever written in place: a park reads
its pages with ``index_select`` and copies them to the host (a sync, which
is fine: parks happen between steps), and a restore writes the decoded
pages back with ``index_copy_``.  The session's captured CUDA graphs hold
the pools' addresses, so nothing is recaptured after a park or a restore.

Prefix sharing is copy-on-write by construction: only *full, page-aligned
prompt pages strictly before the last prompt token* are published to the
share index, so the page a slot writes into is always private (asserted
per step in :meth:`PagedKV.ensure_writable`).  Two requests with the same
system prompt attach the same page ids and prefill only their suffixes.

Refcounting: ``page_refs[pid]`` counts holders (each slot whose table
holds the page, plus one for the share index if the page is published).
A page frees when its count reaches zero; the share index spills its
sole-held (refs == 1) pages to the cold store under LRU pressure and
restores them on the next prefix hit.
"""

from __future__ import annotations

import hashlib
import time
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np
import torch

from ..compression.registry import get as _get_codec
from ..compression.tree import flatten_tree, unflatten
from ..models.transformer import init_cache


class PageError(RuntimeError):
    """The page pool cannot satisfy a request it must (misconfiguration)."""


def kv_cache_bytes(cfg, batch: int, max_len: int) -> int:
    """Device bytes of ``init_cache(cfg, batch, max_len)`` without
    allocating it (the cache is built on the meta device): the one source
    of truth for capacity accounting."""
    shapes = init_cache(cfg, batch, max_len, device="meta")
    return int(sum(t.numel() * t.element_size()
                   for t in flatten_tree(shapes).values()))


@dataclass
class ParkedPages:
    """What :meth:`PagedKV.park` hands back: enough to rebuild the slot's
    page table.  ``prefix_keys`` re-attach through the share index;
    ``cold_key`` names the jointly-coded private pages in the store."""

    cold_key: str
    prefix_keys: tuple
    n_private: int
    _future: object = field(default=None, repr=False)


class _SharedPage:
    __slots__ = ("pid",)

    def __init__(self, pid):
        self.pid: int | None = pid     # None => spilled to the cold store


def _page_keys(prompt: np.ndarray, page: int) -> list[str]:
    """Share-index keys for every *full* prompt page strictly before the
    last prompt token: capping at ``(len-1) // page`` leaves at least one
    suffix token to prefill, and the published pages can never be a
    slot's write target.  Each key hashes the whole prefix (a sha256
    chain), as the reference's do."""
    n = (prompt.size - 1) // page
    h = hashlib.sha256()
    keys = []
    for i in range(n):
        h.update(np.ascontiguousarray(
            prompt[i * page:(i + 1) * page], np.int32).tobytes())
        keys.append(h.hexdigest())
    return keys


class PagedKV:
    """Page table + hot pool + compressed cold store for one session.

    The session owns scheduling (which slot parks, when resumes run);
    this class owns every page: allocation and refcounts, the share index,
    compression to and restoration from the cold store, and the pool
    gather and scatter.  ``slot`` arguments are the session's slot
    indices."""

    def __init__(self, cfg, *, slots: int, max_len: int, page_size: int,
                 pool_pages: int | None = None, cold_store="host",
                 codec: str = "kv-q8-cabac", prefix_sharing: bool = True,
                 restore_workers: int = 0, decode_opts=None,
                 device="cuda"):
        from ..compression.codec import DecodeOptions
        from .backends import BlobGC, resolve_kv_store

        if cfg.family not in ("dense", "moe"):
            raise ValueError(
                "paged KV serving needs an attention-family cache; the "
                f"{cfg.family!r} state cache has no token axis to page")
        if page_size < 1:
            raise ValueError(f"kv_page_size must be >= 1; got {page_size}")
        self.cfg = cfg
        self.page = int(page_size)
        self.n_max = -(-max_len // self.page)        # page-table width
        if pool_pages is None:
            # every slot at max_len plus the scratch page: no eviction
            # pressure; deployments shrink it
            pool_pages = slots * self.n_max + 1
        if pool_pages < self.n_max + 1:
            raise PageError(
                f"kv_pool_pages={pool_pages} cannot hold one full-length "
                f"slot ({self.n_max} pages) + the scratch page")
        self.pool_pages = int(pool_pages)
        self.pools = init_cache(cfg, self.pool_pages, self.page,
                                device=device)
        self.device = next(iter(flatten_tree(self.pools).values())).device
        self.prefix_sharing = bool(prefix_sharing)

        self.page_refs = np.zeros(self.pool_pages, np.int32)
        self.page_refs[0] = 1                        # scratch: never freed
        self._free: list[int] = list(range(self.pool_pages - 1, 0, -1))
        self._pages: dict[int, list[int]] = {}       # slot -> page ids
        self._keys: dict[int, list[str]] = {}        # slot -> prompt keys
        self._index: OrderedDict[str, _SharedPage] = OrderedDict()

        # strict=False: ``codec`` is user-chosen (kv_evict_codec) and the
        # grid-step override applies only to step-taking page codecs
        self.codec = _get_codec(codec, strict=False,
                                step=cfg.kv_cache_delta)
        self.store = resolve_kv_store(cold_store)
        # every cold blob (parked private pages, spilled shared pages) is
        # held through the refcounted GC, so a request that goes away
        # while parked drops its blob instead of leaking it in the store
        self._gc = BlobGC(self.store.drop)
        self.decode_opts = decode_opts or DecodeOptions()
        self._executor = (ThreadPoolExecutor(max_workers=restore_workers)
                          if restore_workers > 0 else None)
        self._park_seq = 0
        self.leaves = flatten_tree(self.pools)       # name -> pool tensor
        self.stats = {
            "pages_evicted": 0, "pages_restored": 0, "restores": 0,
            "restore_s": 0.0, "bytes_to_host": 0, "bytes_from_host": 0,
            "prefix_hits": 0, "prefix_pages_reused": 0, "spills": 0,
        }

    # -- allocation ---------------------------------------------------------

    def free_pages(self) -> int:
        return len(self._free)

    def _alloc(self, n: int) -> list[int] | None:
        if len(self._free) < n:
            return None
        ids = [self._free.pop() for _ in range(n)]
        for pid in ids:
            self.page_refs[pid] = 1
        return ids

    def _deref(self, pid: int) -> None:
        self.page_refs[pid] -= 1
        assert self.page_refs[pid] >= 0, f"page {pid} over-released"
        if self.page_refs[pid] == 0:
            self._free.append(pid)

    def _ensure_free(self, n: int, pin=frozenset(), make_room=None) -> bool:
        """Spill sole-held shared pages (LRU, except ``pin``), then ask the
        session's ``make_room`` (park a victim slot), until ``n`` pages are
        free.  False when neither can free more."""
        while len(self._free) < n:
            if self._spill_one(pin):
                continue
            if make_room is not None and make_room():
                continue
            return False
        return True

    def _spill_one(self, pin=frozenset()) -> bool:
        for key, entry in self._index.items():
            if (entry.pid is not None and key not in pin
                    and self.page_refs[entry.pid] == 1):
                blob = self._compress([entry.pid])
                self.store.put("share:" + key, blob)
                self._gc.hold("share:" + key)
                self._deref(entry.pid)
                entry.pid = None
                self.stats["spills"] += 1
                return True
        return False

    # -- compression to / from the cold store -------------------------------

    def _ids(self, ids: list[int]) -> torch.Tensor:
        return torch.tensor(ids, dtype=torch.int64).to(self.device)

    def gather(self, ids: list[int]) -> dict:
        """Pool pages ``ids`` on the host: {leaf name: (L, n, page, ...)}
        (one ``index_select`` per leaf on the device, then a copy)."""
        idx = self._ids(ids)
        return {name: pool.index_select(1, idx).cpu()
                for name, pool in self.leaves.items()}

    def _compress(self, ids: list[int]) -> bytes:
        art = self.codec.compress(unflatten(self.gather(ids)))
        self.stats["pages_evicted"] += len(ids)
        self.stats["bytes_to_host"] += len(art.blob)
        return art.blob

    def _decode(self, blob: bytes) -> tuple:
        """Entropy-decode one page blob to ({leaf name: CPU tensor},
        seconds, bytes): the slow, lane-parallel part, which touches no
        shared state, so it runs on a worker thread too."""
        t0 = time.perf_counter()
        flat = self.codec.decompress(blob, opts=self.decode_opts)
        return flat, time.perf_counter() - t0, len(blob)

    def _decoded(self, decoded: tuple) -> dict:
        """Account a finished decode (on the caller's thread)."""
        flat, seconds, nbytes = decoded
        self.stats["restore_s"] += seconds
        self.stats["restores"] += 1
        self.stats["bytes_from_host"] += nbytes
        return flat

    def _decompress(self, blob: bytes) -> dict:
        return self._decoded(self._decode(blob))

    def _restore(self, leaves: dict, ids: list[int]) -> None:
        """Write decoded pages into pool pages ``ids`` in place."""
        idx = self._ids(ids)
        for name, pool in self.leaves.items():
            pool.index_copy_(1, idx, leaves[name].to(self.device,
                                                     pool.dtype))
        self.stats["pages_restored"] += len(ids)

    # -- admission ----------------------------------------------------------

    def admit(self, slot: int, prompt: np.ndarray, *, min_len: int = 0,
              make_room=None) -> int | None:
        """Build ``slot``'s page table for ``prompt``: attach the longest
        shared prefix in the index (restoring spilled pages) and allocate
        private pages for the rest (at least ``min_len`` positions when no
        prefix hit: a bucketed prefill's padding needs its positions
        page-backed).  Returns the attached prefix length in tokens, or
        None when the pool cannot provide the pages."""
        assert slot not in self._pages, f"slot {slot} already has pages"
        keys = _page_keys(prompt, self.page) if self.prefix_sharing else []
        chain = 0
        while chain < len(keys) and keys[chain] in self._index:
            chain += 1
        ctx_keys = keys[:chain]
        ctx_len = chain * self.page
        total_len = (max(int(prompt.size), int(min_len)) if chain == 0
                     else int(prompt.size))
        n_suffix = -(-(total_len - ctx_len) // self.page)
        n_cold = sum(1 for k in ctx_keys if self._index[k].pid is None)
        if not self._ensure_free(n_cold + n_suffix, pin=set(ctx_keys),
                                 make_room=make_room):
            return None
        ctx_ids = self._attach(ctx_keys)
        suffix_ids = self._alloc(n_suffix)
        assert suffix_ids is not None   # _ensure_free reserved them
        self._pages[slot] = ctx_ids + suffix_ids
        self._keys[slot] = keys
        if chain:
            self.stats["prefix_hits"] += 1
            self.stats["prefix_pages_reused"] += chain
        return ctx_len

    def _attach(self, keys: list[str]) -> list[int]:
        """Take a slot hold on each shared page, restoring spilled ones
        (the caller reserved their pages)."""
        ids = []
        for key in keys:
            entry = self._index[key]
            if entry.pid is None:
                [pid] = self._alloc(1)        # this hold = the index's
                self._restore(
                    self._decompress(self.store.get("share:" + key)), [pid])
                self._gc.release("share:" + key)
                entry.pid = pid
            self.page_refs[entry.pid] += 1    # the slot's hold
            self._index.move_to_end(key)
            ids.append(entry.pid)
        return ids

    def publish(self, slot: int) -> None:
        """After the admission prefill: publish the slot's full prompt
        pages to the share index so later requests attach them."""
        if not self.prefix_sharing:
            return
        ids, keys = self._pages[slot], self._keys[slot]
        for i, key in enumerate(keys):
            if key in self._index:
                continue                      # attached at admission
            self._index[key] = _SharedPage(ids[i])
            self.page_refs[ids[i]] += 1
            self._index.move_to_end(key)

    # -- decode-time paging -------------------------------------------------

    def slot_ids(self, slot: int) -> list[int]:
        return list(self._pages[slot])

    def page_row(self, slot: int) -> np.ndarray:
        """Dense (n_max,) page-table row; unwritten logical pages point at
        the scratch page (their reads are masked by ``kv_len``)."""
        row = np.zeros(self.n_max, np.int32)
        ids = self._pages[slot]
        row[:len(ids)] = ids
        return row

    def ensure_writable(self, slot: int, pos: int, make_room=None) -> bool:
        """Make position ``pos`` writable for ``slot`` (allocate the next
        page at a boundary).  False => pool pressure: the caller parks."""
        ids = self._pages[slot]
        wp = pos // self.page
        if wp == len(ids):
            if not self._ensure_free(1, make_room=make_room):
                return False
            ids.extend(self._alloc(1))
        # copy-on-write invariant: the write target is never shared
        assert self.page_refs[ids[wp]] == 1, \
            f"CoW violation: slot {slot} writing into shared page {ids[wp]}"
        return True

    # -- park / resume / release --------------------------------------------

    def park(self, slot: int) -> ParkedPages:
        """Evict the slot's pages: prefix pages that live in the share
        index just drop this slot's hold; the private tail is jointly
        entropy-coded to the cold store.  The slot's table is cleared."""
        ids = self._pages.pop(slot)
        keys = self._keys.pop(slot)
        n_shared = 0
        while n_shared < len(keys) and keys[n_shared] in self._index:
            n_shared += 1
        private = ids[n_shared:]
        assert private, "a parked slot always has at least its write page"
        self._park_seq += 1
        cold_key = f"park:{self._park_seq}"
        self.store.put(cold_key, self._compress(private))
        self._gc.hold(cold_key)
        for pid in ids:
            self._deref(pid)
        return ParkedPages(cold_key=cold_key,
                           prefix_keys=tuple(keys[:n_shared]),
                           n_private=len(private))

    def prefetch(self, parked: ParkedPages) -> None:
        """Start entropy-decoding the parked pages on a worker thread so
        the restore hides behind admission and decode; a no-op without
        ``restore_workers``."""
        if self._executor is not None and parked._future is None:
            blob = self.store.get(parked.cold_key)
            parked._future = self._executor.submit(self._decode, blob)

    def resume(self, slot: int, parked: ParkedPages, *,
               make_room=None) -> bool:
        """Re-admit parked pages into ``slot``.  False when the pool
        cannot host them yet (the caller retries on a later step)."""
        assert slot not in self._pages
        n_cold = sum(1 for k in parked.prefix_keys
                     if self._index[k].pid is None)
        if not self._ensure_free(n_cold + parked.n_private,
                                 pin=set(parked.prefix_keys),
                                 make_room=make_room):
            return False
        ctx_ids = self._attach(list(parked.prefix_keys))
        leaves = (self._decoded(parked._future.result())
                  if parked._future is not None
                  else self._decompress(self.store.get(parked.cold_key)))
        priv_ids = self._alloc(parked.n_private)
        assert priv_ids is not None
        self._restore(leaves, priv_ids)
        self._gc.release(parked.cold_key)
        self._pages[slot] = ctx_ids + priv_ids
        self._keys[slot] = list(parked.prefix_keys)
        return True

    def release(self, slot: int) -> None:
        """The slot's request finished: drop all its page holds (shared
        pages stay alive through the index for later prefix hits)."""
        for pid in self._pages.pop(slot):
            self._deref(pid)
        self._keys.pop(slot, None)

    def discard(self, parked: ParkedPages) -> None:
        """A parked request will never resume (cancelled): drop its cold
        blob now instead of leaking it until the store closes, and any
        prefetch result with it."""
        if parked._future is not None:
            parked._future.cancel()
            parked._future = None
        self._gc.release(parked.cold_key)

    # -- accounting ---------------------------------------------------------

    def device_bytes(self) -> int:
        return int(sum(t.numel() * t.element_size()
                       for t in self.leaves.values()))

    def report(self) -> dict:
        dev = self.device_bytes()
        hot_shared = sum(1 for e in self._index.values()
                         if e.pid is not None)
        return {
            "mode": "paged", "page_size": self.page,
            "page_table_width": self.n_max,
            "pool_pages": self.pool_pages, "free_pages": len(self._free),
            "shared_pages_hot": hot_shared,
            "shared_pages_cold": len(self._index) - hot_shared,
            "device_bytes": dev,
            "page_bytes": dev // self.pool_pages,
            "host_compressed_bytes": int(self.store.nbytes()),
            "stats": dict(self.stats),
        }

    def close(self) -> None:
        if self._executor is not None:
            self._executor.shutdown(wait=True)
        self._gc.clear()
        self.store.close()
