"""Fault-tolerant checkpointing with DeepCABAC-compressed parameters (the
port's copy of ``repro.checkpoint.manager``).

Responsibilities:
* atomic writes (tmp dir + fsync + rename) — a crash mid-save never corrupts
  the latest checkpoint;
* retention (keep last N, never a base a kept P-frame chains to);
* compression of the weight payload through the ``repro_torch.compression``
  Codec registry (default ``ckpt-nearest``: per-tensor step size
  Delta = delta_rel * std(w); quantization is deterministic, so resumed
  runs are bit-reproducible given the same stream);
* async save: the host-side quantize+encode runs on a worker thread over a
  host snapshot while the card keeps training.  The snapshot is a copy
  made before ``save`` returns: the port's optimizer updates parameters in
  place, so a later step cannot reach the tensors being encoded.

The state is a tree of torch tensors (on any device) and numpy or Python
scalars.  ``params`` go through the codec; the rest is stored verbatim in
``state.npz`` through ``repro_torch.arrays`` (a bf16 tensor as its uint16
bits, since numpy has no bfloat16, restored by the template's dtype).

Sharded checkpoints (``CheckpointConfig.sharded=True``): one DCBC container
file per owning device of the save mesh (a ``sharded.MeshSpec``, no
devices needed) plus ``params.manifest.json``; restore assembles each
tensor from the manifest on the host.  Placing it on a mesh of cards waits
for the multi-card slice.

Delta ("P-frame") checkpoints (``CheckpointConfig.delta_every=K`` with a
delta-capable codec, e.g. ``codec="deepcabac-delta"``): every K-th save
is a full keyframe (honoring ``sharded``); the saves between are
P-frames — integer-level residuals against the previous save,
temporal-context CABAC coded into one container-v4 ``delta_00000.dcbc``
plus a version-2 manifest whose ``"base"`` block names (and SHA-256 pins)
the base step.  Chained reconstruction is bit-identical to a direct
encode of the same step-locked frame.  ``restore`` resolves chains
(``repro_torch.checkpoint.delta``); ``ServeSession.swap_weights`` is the
serving-side consumer.  Step directories are byte-identical to the
reference's (payload files and manifests) for the same state.
"""

from __future__ import annotations

import io
import json
import os
import shutil
import tempfile
import threading
from dataclasses import dataclass

import numpy as np
import torch

from ..arrays import BF16, from_storage, to_storage
from ..compression import decompress
from ..compression.tree import flatten_tree, unflatten, unflatten_like
from ..kernels.registry import resolve_device
from . import delta as delta_mod
from . import sharded


@dataclass
class CheckpointConfig:
    directory: str
    keep: int = 3
    params_mode: str = "cabac"     # legacy alias: cabac | raw
    codec: str | None = None       # compression-registry name; overrides
                                   # params_mode when set (e.g. "serve-q8")
    delta_rel: float = 1e-3        # Delta = delta_rel * std(w)
    min_quant_ndim: int = 2        # 1-D tensors stored raw (paper protocol)
    async_save: bool = False
    sharded: bool = False          # per-shard container files + manifest
    shard_workers: int = 0         # thread pool for per-shard encode /
                                   # per-slice decode (0 = inline)
    delta_every: int = 0           # 0 = every save is a keyframe; K >= 1 =
                                   # I-frame every K saves, P-frames between
                                   # (needs a delta-capable codec, e.g.
                                   # "deepcabac-delta")
    policy_table: object | None = None  # TensorPolicy / dict / JSON path for
                                   # per-tensor mixed precision (pairs with
                                   # codec="deepcabac-rd"; see
                                   # compression.rd_search)


class CheckpointManager:
    def __init__(self, cfg: CheckpointConfig):
        self.cfg = cfg
        os.makedirs(cfg.directory, exist_ok=True)
        self._worker: threading.Thread | None = None
        # (step, quantized entries) of the last save — the next P-frame's
        # base without a disk round-trip; rebuilt via the chain on miss.
        # Populated only when delta_every > 0 (it holds model-sized
        # int64 levels).
        self._base_cache: tuple[int, dict] | None = None

    # -- discovery ----------------------------------------------------------
    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.cfg.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    # -- save ----------------------------------------------------------------
    def _codec(self):
        """Resolve the params codec from cfg (registry name or legacy
        params_mode alias).  This is a generic-config-at-any-codec
        forwarder, so it uses ``get(..., strict=False)``: delta_rel /
        min_quant_ndim / policy_table reach any codec whose factory
        accepts them; the rest drop them with the drop recorded in the
        codec's hyperparams (and hence in the checkpoint metadata)."""
        from ..compression import get
        name = self.cfg.codec
        if name is None:
            name = "ckpt-nearest" if self.cfg.params_mode == "cabac" else "raw"
        overrides = {"delta_rel": self.cfg.delta_rel,
                     "min_ndim": self.cfg.min_quant_ndim}
        if self.cfg.policy_table is not None:
            overrides["policy_table"] = self.cfg.policy_table
        return get(name, strict=False, **overrides)

    def _write(self, payloads: dict[str, bytes], meta: dict, step: int):
        final = os.path.join(self.cfg.directory, f"step_{step:08d}")
        tmp = tempfile.mkdtemp(prefix=f"step_{step:08d}.tmp.",
                               dir=self.cfg.directory)
        try:
            for fname, blob in payloads.items():
                path = os.path.join(tmp, fname)
                with open(path, "wb") as f:
                    f.write(blob)
                    f.flush()
                    os.fsync(f.fileno())
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
                f.flush()
                os.fsync(f.fileno())
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._retain()

    def _chain_depth(self, step: int) -> int:
        """P-frames above the keyframe at ``step`` (0 for a keyframe) —
        from meta.json when available, else by resolving the chain."""
        meta_path = os.path.join(self.cfg.directory, f"step_{step:08d}",
                                 "meta.json")
        try:
            with open(meta_path) as f:
                depth = json.load(f).get("chain_depth")
            if depth is not None:
                return int(depth)
        except (OSError, ValueError):
            pass
        return len(delta_mod.resolve_chain(self.cfg.directory, step)) - 1

    def _delta_base(self) -> int | None:
        """The step the next save should delta against, or None when a
        keyframe is due (no previous step, chain at the delta_every
        cadence, or an unreadable/broken chain — start fresh)."""
        latest = self.latest_step()
        if latest is None:
            return None
        try:
            depth = self._chain_depth(latest)
        except (OSError, ValueError):
            return None
        if depth + 1 >= self.cfg.delta_every:
            return None
        return latest

    def _base_entries(self, base_step: int) -> dict:
        """Quantized entries of the base frame: the last save's, cached
        in memory, or chain-reconstructed from disk on a cache miss (e.g.
        a manager restarted mid-chain)."""
        if self._base_cache is not None and self._base_cache[0] == base_step:
            return self._base_cache[1]
        return delta_mod.restore_levels(self.cfg.directory, base_step)

    def _base_step_of(self, step: int) -> int | None:
        """The step ``step`` chains to (delta manifests name it), or None
        for keyframes / unreadable steps."""
        try:
            return delta_mod.base_step_of(self.cfg.directory, step)
        except (OSError, ValueError):
            return None

    def _retain(self):
        """Keep the last ``keep`` steps plus the transitive closure of
        their base chains — a base referenced by a live P-frame chain is
        never GC'd, no matter how old it is."""
        steps = self.steps()
        live = set(steps[-self.cfg.keep:]) if self.cfg.keep else set(steps)
        frontier = list(live)
        while frontier:
            base = self._base_step_of(frontier.pop())
            if base is not None and base not in live:
                live.add(base)
                frontier.append(base)
        for s in steps:
            if s not in live:
                shutil.rmtree(os.path.join(self.cfg.directory,
                                           f"step_{s:08d}"),
                              ignore_errors=True)

    def save(self, state, step: int, extra_meta: dict | None = None,
             blocking: bool | None = None, mesh=None):
        """Snapshot to host, then encode+write (optionally off-thread).
        The snapshot (a host copy of every tensor) is complete when this
        returns, so the caller may update ``state`` in place at once.

        With ``cfg.sharded``, ``mesh`` (a ``sharded.MeshSpec`` or an
        axis-size dict) is the save mesh whose specs assign tensor shards
        to per-device container files; omitting it writes a single-device
        (one-file) sharded checkpoint."""
        snapshot = _snapshot(state)
        blocking = (not self.cfg.async_save) if blocking is None else blocking
        codec = self._codec()
        if self.cfg.delta_every > 0 and not hasattr(codec, "compress_delta"):
            raise ValueError(
                f"delta_every={self.cfg.delta_every} needs a delta-capable "
                f"codec (e.g. codec='deepcabac-delta'), got {codec.name!r}")

        def work():
            flat_p = flatten_tree(snapshot["params"])
            rest = {k: v for k, v in snapshot.items() if k != "params"}
            other = flatten_tree(rest)
            buf = {}
            bio = io.BytesIO()
            np.savez(bio, **{k: _host_array(v) for k, v in other.items()})
            buf["state.npz"] = bio.getvalue()
            meta_extra = {}
            base_step = self._delta_base() if self.cfg.delta_every > 0 \
                else None
            if base_step is not None:
                coder = codec.coder
                base_entries = self._base_entries(base_step)
                dentries = codec.delta_entries(flat_p, base_entries)
                payloads, manifest = delta_mod.write_delta(
                    dentries, codec_name=codec.name,
                    base=delta_mod.base_ref(self.cfg.directory, base_step),
                    num_gr=coder.num_gr, chunk_size=coder.chunk_size,
                    workers=self.cfg.shard_workers)
                buf.update(payloads)
                buf[sharded.MANIFEST_NAME] = json.dumps(
                    manifest, indent=1).encode()
                compressed = sum(len(b) for b in payloads.values())
                self._base_cache = (step,
                                    codec.reconstruct_entries(dentries))
                meta_extra = {"kind": "delta", "base_step": base_step,
                              "chain_depth":
                                  self._chain_depth(base_step) + 1}
            elif self.cfg.sharded:
                kw = {}
                coder = getattr(codec, "coder", None)
                for attr in ("num_gr", "chunk_size"):
                    if coder is not None and hasattr(coder, attr):
                        kw[attr] = getattr(coder, attr)
                entries = codec.quantize_entries(flat_p)
                payloads, manifest = sharded.write_sharded(
                    entries, mesh, codec_name=codec.name,
                    workers=self.cfg.shard_workers, **kw)
                buf.update(payloads)
                buf[sharded.MANIFEST_NAME] = json.dumps(
                    manifest, indent=1).encode()
                compressed = sum(len(b) for b in payloads.values())
                meta_extra = {"sharded": True,
                              "shard_files": len(payloads),
                              "save_mesh": manifest["mesh"]}
                if self.cfg.delta_every > 0:
                    self._base_cache = (step, entries)
                    meta_extra = {**meta_extra, "kind": "keyframe",
                                  "chain_depth": 0}
            else:
                artifact = codec.compress(flat_p)
                buf["params.dcbc"] = artifact.blob
                compressed = len(buf["params.dcbc"])
                if self.cfg.delta_every > 0:
                    self._base_cache = (step, artifact.quantized)
                    meta_extra = {"kind": "keyframe", "chain_depth": 0}
            raw_bytes = sum(v.numel() * v.element_size()
                            for v in flat_p.values())
            # record only what was actually used: a config knob the chosen
            # codec ignores (delta_rel, or params_mode once codec= is set)
            # must not be recorded as if it shaped the payload
            meta = {"step": step, "codec": codec.name,
                    "codec_hyperparams": codec.hyperparams,
                    "params_raw_bytes": raw_bytes,
                    "params_compressed_bytes": compressed,
                    **meta_extra, **(extra_meta or {})}
            if self.cfg.codec is None:
                meta["params_mode"] = self.cfg.params_mode
            if "delta_rel" in codec.hyperparams:
                meta["delta_rel"] = codec.hyperparams["delta_rel"]
            self._write(buf, meta, step)

        if blocking:
            work()
        else:
            self.wait()
            self._worker = threading.Thread(target=work, daemon=True)
            self._worker.start()

    def wait(self):
        if self._worker is not None:
            self._worker.join()
            self._worker = None

    # -- restore --------------------------------------------------------------
    def restore(self, template_state, step: int | None = None,
                device="cuda"):
        """Rebuild ``template_state``'s tree from disk: every tensor with
        its template leaf's shape and dtype on ``device`` (the card unless
        ``"cpu"`` is asked for; an absent card raises), scalars as the
        template's types.  Cold-start decode is batched (every CABAC chunk
        of a monolithic container joins one lane batch); sharded steps
        are assembled from their manifest and delta steps resolve their
        chain.  Returns ``(state, meta)``."""
        dev = resolve_device(device)
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError("no checkpoints found")
        d = os.path.join(self.cfg.directory, f"step_{step:08d}")
        if os.path.exists(os.path.join(d, sharded.MANIFEST_NAME)):
            if sharded.load_manifest(d).get("base") is not None:
                # chained (P-frame) step: resolve the base chain and apply
                # the residuals
                flat = delta_mod.restore_flat_delta(
                    self.cfg.directory, step,
                    workers=self.cfg.shard_workers)
            else:
                flat = sharded.restore_flat(
                    d, workers=self.cfg.shard_workers)
        else:
            with open(os.path.join(d, "params.dcbc"), "rb") as f:
                flat = decompress(f.read(), batched=True)
        params = unflatten_like(flat, template_state["params"], device=dev)
        with open(os.path.join(d, "state.npz"), "rb") as f:
            other = dict(np.load(f, allow_pickle=False))
        rest_t = {k: v for k, v in template_state.items() if k != "params"}
        state = {"params": params, **_restore_rest(other, rest_t, dev)}
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        return state, meta


def _snapshot(state):
    """A host copy of every tensor of ``state`` (a tree of dicts), made
    now: a CPU tensor is cloned, a card tensor copied to the host; numpy
    and Python scalars are immutable and kept."""
    if isinstance(state, dict):
        return {k: _snapshot(v) for k, v in state.items()}
    if isinstance(state, torch.Tensor):
        return state.detach().to("cpu", copy=True)
    if isinstance(state, np.ndarray):
        return state.copy()
    return state


def _host_array(v):
    """A ``state.npz`` entry: a tensor as its host storage (bf16 as uint16
    bits), anything else as numpy makes it."""
    return to_storage(v) if isinstance(v, torch.Tensor) else v


def _restore_rest(other: dict, template: dict, device) -> dict:
    """The non-param state from ``state.npz``, shaped like ``template``:
    tensors take the template leaf's dtype (uint16 bits back to bf16) and
    go to ``device``; scalars take the template's type."""
    out = {}
    for key, leaf in flatten_tree(template).items():
        if key not in other:
            raise KeyError(f"checkpoint missing state entry {key}")
        arr = other[key]
        if tuple(np.shape(arr)) != tuple(np.shape(leaf)):
            raise ValueError(f"{key}: checkpoint shape {np.shape(arr)} != "
                             f"state {tuple(np.shape(leaf))}")
        if isinstance(leaf, torch.Tensor):
            name = BF16 if leaf.dtype == torch.bfloat16 else None
            out[key] = from_storage(arr, name).to(device, leaf.dtype)
        elif isinstance(leaf, np.ndarray):
            out[key] = np.asarray(arr, dtype=leaf.dtype)
        elif isinstance(leaf, np.generic):
            out[key] = leaf.dtype.type(arr)
        else:
            out[key] = type(leaf)(arr)
    return unflatten(out)
