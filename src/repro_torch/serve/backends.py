"""Serving weight backends: how a ServeSession gets its parameters (port of
``repro.serve.backends`` for in-memory trees, DCBC container blobs and
checkpoint manifests).

    ``bf16``       full-precision leaves: a tree passes through; a blob is
                   decoded record by record to the model's param dtype.
    ``q8``         fixed-point serving: eligible matmul weights become
                   ``{"q8", "q8s"}`` leaves that every projection and the
                   untied head read through ``dequant_matmul``; a blob's
                   entropy-coded records are dequantized to the param
                   dtype and re-quantized with ``quantize_leaf``.
    ``container``  the paper's deployment artifact: a blob streamed record
                   by record; ``serve-q8`` records stay int8 and feed
                   ``dequant_matmul``, entropy-coded records dequantize to
                   the param dtype.

Blob and manifest loads keep the reference's layer-bound contract: one
decoded record is on the host at a time, moved to the device before the
next is decoded, and the template comes from the model's shapes and dtypes
alone, leaf by leaf (``models.transformer.param_specs``: a MoE router and
a Mamba2 mixer's ``a_log`` and ``dt_bias`` stay f32 in a bf16 model).
A manifest source is a path: the directory of a sharded checkpoint step
(``repro_torch.checkpoint``) or its ``params.manifest.json``; its
tensors are assembled one at a time on the host
(``checkpoint.sharded``).  With ``mesh=`` (a ``torch.distributed``
``DeviceMesh``) on the ``bf16`` and ``container`` backends, a manifest's
entropy-coded and raw tensors skip the conversion and arrive as
``DTensor``\\ s of the template's dtype, each rank decoding only its
box (``sharded.restore_tensor_on_mesh``); ``q8`` records are still
converted.  The ``q8`` backend converts every manifest tensor on the
host and ignores the mesh, as the reference's does.  A ``serve-q8``
record of a stacked 4-D expert bank (L, E, K, N) keeps its (L, N)
scale, so each layer hands ``dequant_matmul_grouped`` the shared (N,)
form.  ``policy_table=``
applies a per-tensor RD policy to *tree* sources (quantize, then
dequantize back), so a tree session equals one cold-started from the
matching ``deepcabac-rd`` container.

Live weight swap: a backend built with ``track_levels=True`` keeps the
integer levels of every entropy-decoded tensor on the host, so
:meth:`WeightBackend.apply_delta` can patch the serving weights from a
delta ("P-frame") checkpoint step: residuals are applied in level space,
and the new leaves are bit-identical to a cold start of the new frame
(on ``q8`` a tracked tensor is dequantized to the template dtype and
re-quantized with ``quantize_leaf``, as at a cold start).
``ServeSession.swap_weights`` writes them into the resident tensors.
:meth:`WeightBackend.warm_from` builds a variant on a resident base whose
leaves it shares (``shared``) until a swap replaces them.
"""

from __future__ import annotations

import os

import torch

from ..compression.codec import DecodeOptions, iter_decompress
from ..compression.quantizers import (quantize_leaf, quantize_tree_q8,
                                      serve_q8_policy)
from ..compression.tree import flatten_tree, unflatten
from ..core.codec import (Q8Tensor, QuantizedTensor, decode_delta_record,
                          decode_record)
from ..core.container import ENC_CABAC_DELTA, ContainerReader
from ..distributed.sharding import check_mesh

_BLOB = (bytes, bytearray, memoryview)


class WeightBackend:
    """Strategy interface: one weight source -> serving parameter tree.

    ``decode`` tunes the entropy decode of container blobs and manifests;
    ``policy_table`` (a ``TensorPolicy``, its dict payload or a JSON path)
    applies to tree sources only.

    ``track_levels`` keeps each entropy-decoded tensor's integer levels on
    the host next to the converted leaf, which :meth:`apply_delta` needs
    to patch the weights from a delta ("P-frame") checkpoint step.  It
    costs one int64 copy of the quantized model on the host; leave it off
    for static deployments.  ``shared`` names the leaves this backend's
    tree shares with another's (:meth:`warm_from`).  ``mesh`` scopes
    manifest cold starts to a serving ``DeviceMesh`` (see the module's
    docstring); tracked levels need host-visible levels, so
    ``track_levels`` with a mesh refuses a manifest load."""

    name = "?"
    # True when the resident tree holds serve-quantized tensors as
    # {"q8", "q8s"} leaves (int8 levels + f32 scales): admission
    # accounting (zoo.model_resident_bytes) sizes those leaves at int8
    # width instead of the param dtype
    q8_resident = False

    def __init__(self, decode: DecodeOptions | None = None, mesh=None,
                 track_levels: bool = False, policy_table=None):
        self.decode = decode or DecodeOptions()
        self.mesh = mesh
        self.policy_table = policy_table
        self.track_levels = track_levels
        self._levels: dict[str, QuantizedTensor] | None = (
            {} if track_levels else None)
        self.shared: set[str] = set()

    def load(self, cfg, source, device=None):
        """``device`` places the leaves of a blob or manifest source
        (default: the card); tree sources stay where they are."""
        raise NotImplementedError

    def _convert(self, name: str, rec, dtype, device):
        """One decoded record -> this backend's resident leaf."""
        return _to_tensor(rec, dtype, device)

    def _fold(self, name: str, rec, dtype, device):
        """The convert hook the loads call: track the quantized levels
        (when enabled) before handing the record to :meth:`_convert`."""
        if self._levels is not None and isinstance(rec, QuantizedTensor):
            self._levels[name] = rec
        return self._convert(name, rec, dtype, device)

    def _check_mesh_tracking(self, source) -> None:
        if (self.track_levels and self.mesh is not None
                and _is_manifest(source)):
            raise RuntimeError(
                "track_levels=True needs host-visible quantized levels, "
                "but a manifest load with mesh= set assembles tensors "
                "straight onto the mesh without materializing them — "
                "load without mesh, or without track_levels")

    # -- delta ("P-frame") live patching ------------------------------------

    def apply_delta(self, cfg, source, device=None) -> dict:
        """The weight updates of a delta (P-frame) checkpoint step, for a
        swap without a full reload.

        ``source`` is the delta step directory (or its
        ``params.manifest.json``).  Residual (``ENC_CABAC_DELTA``) records
        are decoded against the tracked base levels and applied in integer
        level space, so the updated tensors are bit-identical to a cold
        start of the new frame; full records in the same container
        replace their leaf outright.  The tracked levels advance to the
        new frame, so chains of swaps keep working.

        Returns the flat ``{name: leaf}`` updates, converted to this
        backend's representation on ``device`` (default: the card);
        ``ServeSession.swap_weights`` installs them between steps."""
        from ..checkpoint import delta as delta_mod
        from ..checkpoint import sharded
        if not self._levels:
            raise RuntimeError(
                f"{self.name} backend has no tracked base levels — build "
                f"it with track_levels=True and load the base frame from "
                f"a container blob or checkpoint manifest before applying "
                f"deltas")
        directory = sharded.manifest_dir(str(source))
        if not os.path.exists(os.path.join(directory,
                                           sharded.MANIFEST_NAME)):
            raise ValueError(
                f"{directory}: no {sharded.MANIFEST_NAME} — not a delta "
                f"(P-frame) step; full frames go through load()")
        manifest = sharded.load_manifest(str(source))
        if manifest.get("base") is None:
            raise ValueError(
                f"{directory}: not a delta (P-frame) manifest — full "
                f"frames go through load()")
        path = os.path.join(directory, delta_mod.DELTA_FILE)
        if not os.path.exists(path):
            raise delta_mod.DeltaBaseMissingError(
                f"{directory}: manifest present but {delta_mod.DELTA_FILE} "
                f"is missing")
        with open(path, "rb") as f:
            blob = f.read()
        dev = _device(device)
        specs = _specs(cfg)
        updates: dict = {}
        for hdr, payload in ContainerReader(blob):
            spec = specs.get(hdr.name)
            if spec is None:
                continue                   # not part of this model
            shape, dtype = spec
            if tuple(hdr.shape) != tuple(shape):
                raise ValueError(
                    f"{hdr.name}: delta record shape {tuple(hdr.shape)} "
                    f"!= model {tuple(shape)}")
            if hdr.encoding == ENC_CABAC_DELTA:
                base = self._levels.get(hdr.name)
                if base is None:
                    raise RuntimeError(
                        f"{hdr.name}: residual record has no tracked base "
                        f"levels — the resident weights were not loaded "
                        f"from this chain's base frame")
                rec = decode_delta_record(hdr, payload, base.levels,
                                          dequantize=False, opts=self.decode)
            else:
                rec = decode_record(hdr, payload, dequantize=False,
                                    opts=self.decode)
            updates[hdr.name] = self._fold(hdr.name, rec, dtype, dev)
        return updates

    def load_entries(self, cfg, entries: dict, device=None) -> dict:
        """Build the serving tree from flat reconstructed quantized
        entries (``checkpoint.delta.restore_levels`` output: name ->
        ``QuantizedTensor`` | ``Q8Tensor`` | raw tensor).

        The cold start of a delta chain's tip, which no single container
        holds: the chain is reconstructed on the host first, and each
        entry folded through the same template-checked hook a blob load
        uses (tracked levels included)."""
        dev = _device(device)
        specs = _specs(cfg)
        flat: dict = {}
        for name, rec in entries.items():
            spec = specs.get(name)
            if spec is None:
                continue                   # not part of this model
            if tuple(rec.shape) != tuple(spec[0]):
                raise ValueError(
                    f"{name}: entry shape {tuple(rec.shape)} != model "
                    f"{tuple(spec[0])}")
            flat[name] = self._fold(name, rec, spec[1], dev)
        _check_complete(specs, flat, "entries")
        return unflatten(flat)

    def warm_from(self, cfg, base_backend: "WeightBackend", base_params,
                  steps, device=None) -> dict:
        """Warm-start a delta variant from an already-resident base.

        Instead of decoding the variant's whole chain from disk, copy the
        base backend's tracked levels (residual decode builds new level
        arrays, it never changes the base's) and apply only the variant's
        own delta steps: ``steps`` is the base-exclusive suffix of its
        chain, in order.  ``base_params`` leaves are shared, not copied,
        in a fresh dict structure; patched tensors replace their leaf.
        The names of the leaves still shared are recorded in ``shared``,
        so a later swap installs new tensors there instead of writing into
        the base's.  Returns the variant's serving tree; this backend's
        levels advance to the variant frame."""
        if not self.track_levels:
            raise RuntimeError(
                f"{self.name}: warm_from needs track_levels=True on the "
                f"warming backend")
        if not base_backend._levels:
            raise RuntimeError(
                f"{self.name}: base backend has no tracked levels to warm "
                f"from — it must be built with track_levels=True and hold "
                f"a loaded frame")
        self._levels = dict(base_backend._levels)
        tree = _copy_structure(base_params)
        self.shared = set(_specs(cfg)) & set(_leaf_names(tree))
        for step in steps:
            for name, leaf in self.apply_delta(cfg, step, device).items():
                _insert(tree, name, leaf)
                self.shared.discard(name)
        return tree

    def _apply_policy_tree(self, tree):
        """Quantize-dequantize a tree through ``policy_table`` (no-op
        without one): each covered float leaf is quantized on its rule
        where it lies (the ``rd_quant`` kernel on the card) and
        dequantized back to its dtype on its device."""
        if self.policy_table is None:
            return tree
        from ..compression.rd_search import PolicyQuantizer, resolve_policy
        table = resolve_policy(self.policy_table)
        quant = PolicyQuantizer(table=table)
        out = {}
        for name, leaf in flatten_tree(tree).items():
            rule = table.rule_for(name)
            if (rule is None or rule.kind == "raw" or leaf.numel() == 0
                    or not leaf.is_floating_point()):
                out[name] = leaf
                continue
            rec = quant.quantize(name, leaf)
            out[name] = rec.dequantize().to(leaf.device, leaf.dtype)
        return unflatten(out)

    def _decoded_tree(self, cfg, source, device, mesh=None):
        if _is_manifest(source):
            dev = _device(device)
            if mesh is not None:
                check_mesh(mesh, dev)
            return _manifest_tree(cfg, source, self._fold, dev,
                                  decode=self.decode, mesh=mesh)
        return _stream_tree(cfg, bytes(source), self._fold,
                            _device(device), decode=self.decode)


def _device(device) -> torch.device:
    from ..kernels.registry import resolve_device
    return resolve_device("cuda" if device is None else device)


def _to_tensor(record, dtype, device) -> torch.Tensor:
    """Decoded record -> tensor in the template dtype on ``device``."""
    t = record.dequantize() if hasattr(record, "dequantize") else record
    return t.to(device=device, dtype=dtype)


def _q8_leaf(record: Q8Tensor, device) -> dict:
    return {"q8": torch.from_numpy(record.levels).to(device),
            "q8s": torch.from_numpy(record.scale).to(device, torch.float32)}


def _specs(cfg) -> dict:
    from ..models.transformer import param_specs
    return param_specs(cfg)


def _check_complete(specs: dict, flat: dict, what: str) -> None:
    missing = sorted(set(specs) - set(flat))
    if missing:
        raise KeyError(
            f"{what} missing {len(missing)} model tensor(s), e.g. "
            f"{missing[:3]}")


def _insert(tree: dict, name: str, leaf) -> None:
    parts = name.split("/")
    node = tree
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = leaf


def _copy_structure(tree):
    """A new nested dict (the q8 leaf dicts included) over the same
    tensors."""
    if isinstance(tree, dict):
        return {k: _copy_structure(v) for k, v in tree.items()}
    return tree


def _leaf_names(tree: dict) -> list:
    """Flat names of the serving leaves: a ``{"q8", "q8s"}`` dict is one
    leaf."""
    out = []
    for name, leaf in flatten_tree(tree).items():
        out.append(name.rsplit("/", 1)[0]
                   if name.endswith(("/q8", "/q8s")) else name)
    return list(dict.fromkeys(out))


def _is_manifest(source) -> bool:
    return isinstance(source, (str, os.PathLike))


def _stream_tree(cfg, blob: bytes, convert, device,
                 decode: DecodeOptions | None = None) -> dict:
    """Fold the per-record decode iterator into a nested params dict,
    checked against the model's template: records the model does not
    expect are skipped, a shape mismatch raises, and a container missing
    a template tensor raises.  Each decoded record is converted (and
    moved to ``device``) before the next one is decoded."""
    specs = _specs(cfg)
    flat: dict = {}
    for name, record in iter_decompress(blob, dequantize=False, opts=decode):
        spec = specs.get(name)
        if spec is None:
            continue                       # not part of this model
        shape, dtype = spec
        if tuple(record.shape) != tuple(shape):
            raise ValueError(
                f"{name}: container shape {tuple(record.shape)} != model "
                f"{tuple(shape)}")
        flat[name] = convert(name, record, dtype, device)
        del record
    _check_complete(specs, flat, "container")
    return unflatten(flat)


def _manifest_tree(cfg, source, convert, device,
                   decode: DecodeOptions | None = None, mesh=None) -> dict:
    """Cold start from a checkpoint manifest: the same template contract
    as :func:`_stream_tree`, each tensor assembled from its shards on the
    host (``checkpoint.sharded.assemble_slice``) and converted before the
    next.  With ``mesh``, entropy-coded and raw tensors skip ``convert``
    and arrive as ``DTensor``\\ s of the template's dtype built from only
    the shards this rank's box covers."""
    from ..checkpoint import sharded
    directory = sharded.manifest_dir(str(source))
    manifest = sharded.load_manifest(str(source))
    num_gr = manifest.get("num_gr")
    specs = _specs(cfg)
    flat: dict = {}
    for name, tinfo in sorted(manifest["tensors"].items()):
        spec = specs.get(name)
        if spec is None:
            continue                       # not part of this model
        shape, dtype = spec
        if tuple(tinfo["shape"]) != tuple(shape):
            raise ValueError(
                f"{name}: manifest shape {tuple(tinfo['shape'])} != model "
                f"{tuple(shape)}")
        if mesh is not None and tinfo["encoding"] != "q8":
            flat[name] = sharded.restore_tensor_on_mesh(
                directory, name, tinfo, mesh, opts=decode, num_gr=num_gr,
                dtype=dtype)
            continue
        rec = sharded.assemble_slice(directory, name, tinfo, opts=decode,
                                     num_gr=num_gr, dequantize=False)
        flat[name] = convert(name, rec, dtype, device)
        del rec
    _check_complete(specs, flat, "manifest")
    return unflatten(flat)


class Bf16Backend(WeightBackend):
    name = "bf16"

    def load(self, cfg, source, device=None):
        self._check_mesh_tracking(source)
        if isinstance(source, _BLOB) or _is_manifest(source):
            return self._decoded_tree(cfg, source, device, mesh=self.mesh)
        return self._apply_policy_tree(source)


class Q8Backend(WeightBackend):
    name = "q8"
    q8_resident = True

    def _convert(self, name, rec, dtype, device):
        if isinstance(rec, Q8Tensor):
            return _q8_leaf(rec, device)
        t = _to_tensor(rec, dtype, device)
        return quantize_leaf(t) if serve_q8_policy(name, t) else t

    def load(self, cfg, source, device=None):
        # host-side conversion: every decoded tensor becomes a q8 leaf or
        # a float one on ``device``, so a mesh does not apply here
        if isinstance(source, _BLOB) or _is_manifest(source):
            return self._decoded_tree(cfg, source, device)
        return quantize_tree_q8(self._apply_policy_tree(source))


class ContainerBackend(WeightBackend):
    name = "container"

    def _convert(self, name, rec, dtype, device):
        if isinstance(rec, Q8Tensor):
            return _q8_leaf(rec, device)
        return _to_tensor(rec, dtype, device)

    def load(self, cfg, source, device=None):
        if not (isinstance(source, _BLOB) or _is_manifest(source)):
            raise TypeError(
                "container backend loads DCBC blobs (bytes) or a "
                "checkpoint manifest path; got "
                f"{type(source).__name__} — use the 'bf16' or 'q8' backend "
                "for in-memory trees")
        self._check_mesh_tracking(source)
        return self._decoded_tree(cfg, source, device, mesh=self.mesh)


_BACKENDS: dict = {"bf16": Bf16Backend, "q8": Q8Backend,
                   "container": ContainerBackend}


def available_backends() -> list[str]:
    return sorted(_BACKENDS)


def get_backend(name: str, **overrides) -> WeightBackend:
    if name not in _BACKENDS:
        raise KeyError(f"unknown weight backend {name!r}; available: "
                       f"{available_backends()}")
    return _BACKENDS[name](**overrides)


def resolve_backend(backend) -> WeightBackend:
    if isinstance(backend, WeightBackend):
        return backend
    return get_backend(backend)


def register_backend(name: str, factory) -> None:
    _BACKENDS[name] = factory


# ---------------------------------------------------------------------------
# Refcounted blob GC
# ---------------------------------------------------------------------------

class BlobGC:
    """Refcounted key lifetimes over a drop callback.

    A blob written for a consumer that later goes away (a parked KV slot
    whose request is cancelled) leaks unless something counts its
    holders: ``hold(key)`` takes a reference, ``release(key)`` gives one
    back and calls ``drop(key)`` exactly when the last holder leaves.
    Unknown keys release as no-ops, so cleanup paths may repeat."""

    def __init__(self, drop):
        self._drop = drop
        self._refs: dict[str, int] = {}

    def hold(self, key: str) -> int:
        self._refs[key] = self._refs.get(key, 0) + 1
        return self._refs[key]

    def release(self, key: str) -> bool:
        """Give back one reference; True when this release was the last
        one and the key's blob was dropped."""
        n = self._refs.get(key)
        if n is None:
            return False
        if n > 1:
            self._refs[key] = n - 1
            return False
        del self._refs[key]
        self._drop(key)
        return True

    def refs(self, key: str) -> int:
        return self._refs.get(key, 0)

    def live(self) -> list[str]:
        return sorted(self._refs)

    def clear(self) -> None:
        """Drop every held key (store teardown)."""
        for key in list(self._refs):
            del self._refs[key]
            self._drop(key)


# ---------------------------------------------------------------------------
# KV cold stores: where the paged cache's evicted pages live
# ---------------------------------------------------------------------------

class KVColdStore:
    """Host-side blob store for entropy-coded KV pages.

    The paged serving cache (``repro_torch.serve.kv``) evicts cold pages as
    ``kv-q8-cabac`` containers keyed by an opaque string; this registry
    lets a deployment swap the eviction target (host memory, a spill
    directory, ...) without touching the scheduler.  A store owns its
    blobs: ``close()`` releases everything it holds."""

    name = "base"

    def put(self, key: str, blob: bytes) -> None:
        raise NotImplementedError

    def get(self, key: str) -> bytes:
        raise NotImplementedError

    def drop(self, key: str) -> None:
        raise NotImplementedError

    def __contains__(self, key: str) -> bool:
        raise NotImplementedError

    def nbytes(self) -> int:
        """Total compressed bytes currently held (capacity accounting)."""
        raise NotImplementedError

    def close(self) -> None:
        pass


class HostKVStore(KVColdStore):
    """In-process host-RAM store (the default): a dict of blobs."""

    name = "host"

    def __init__(self):
        self._blobs: dict[str, bytes] = {}

    def put(self, key, blob):
        self._blobs[key] = bytes(blob)

    def get(self, key):
        return self._blobs[key]

    def drop(self, key):
        self._blobs.pop(key, None)

    def __contains__(self, key):
        return key in self._blobs

    def nbytes(self):
        return sum(len(b) for b in self._blobs.values())

    def close(self):
        self._blobs.clear()


class DirKVStore(KVColdStore):
    """Spill-to-directory store: one file per key under ``root`` (a
    private temporary directory when unset, removed on ``close``)."""

    name = "dir"

    def __init__(self, root=None):
        import tempfile
        self._own = root is None
        self._root = root or tempfile.mkdtemp(prefix="repro-torch-kv-")
        os.makedirs(self._root, exist_ok=True)
        self._sizes: dict[str, int] = {}

    def _path(self, key: str) -> str:
        import hashlib
        return os.path.join(
            self._root, hashlib.sha256(key.encode()).hexdigest() + ".dcbc")

    def put(self, key, blob):
        with open(self._path(key), "wb") as f:
            f.write(blob)
        self._sizes[key] = len(blob)

    def get(self, key):
        with open(self._path(key), "rb") as f:
            return f.read()

    def drop(self, key):
        if self._sizes.pop(key, None) is not None:
            try:
                os.remove(self._path(key))
            except OSError:
                pass

    def __contains__(self, key):
        return key in self._sizes

    def nbytes(self):
        return sum(self._sizes.values())

    def close(self):
        for key in list(self._sizes):
            self.drop(key)
        if self._own:
            import shutil
            shutil.rmtree(self._root, ignore_errors=True)


_KV_STORES: dict = {}


def register_kv_store(name: str, factory) -> None:
    _KV_STORES[name] = factory


def available_kv_stores() -> list[str]:
    return sorted(_KV_STORES)


def get_kv_store(name: str, **overrides) -> KVColdStore:
    if name not in _KV_STORES:
        raise KeyError(f"unknown KV cold store {name!r}; "
                       f"available: {available_kv_stores()}")
    return _KV_STORES[name](**overrides)


def resolve_kv_store(store) -> KVColdStore:
    """Accept a registry name or an already-built store instance."""
    if isinstance(store, KVColdStore):
        return store
    return get_kv_store(store)


register_kv_store("host", HostKVStore)
register_kv_store("dir", DirKVStore)
