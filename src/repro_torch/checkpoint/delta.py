"""Temporal delta-coded ("P-frame") checkpoint steps (the port's copy of
``repro.checkpoint.delta``).

A delta step stores checkpoint step N+1 as integer-level *residuals*
against the quantized levels of a base step N — the video-codec I/P-frame
idea applied to training checkpoints:

* the new frame is quantized on the **base tensor's grid** (step
  locking), so ``resid = new_levels - base_levels`` lives entirely in
  integer quantization-level space and base + a chain of residuals
  reconstructs each frame **bit-identically** to its direct (monolithic)
  encoding — zero drift at any chain depth;
* residuals are entropy-coded with **temporal-context CABAC**
  (``ENC_CABAC_DELTA``, container v4): each element's context bank is
  selected by the significance class of its co-located base-frame level
  (zero / small / large — ``core.cabac.temporal_classes``);
* the chain linkage lives in a **version-2 dcbc-manifest**: a delta
  step's ``params.manifest.json`` carries a top-level ``"base"`` block
  naming the base step directory, its payload file and that file's
  SHA-256, so :func:`resolve_chain` can walk P-frames back to the
  keyframe and detect a missing or substituted base *before* decoding.

Directory layout (inside a ``CheckpointManager`` root)::

    step_00000010/params.manifest.json   v1 manifest  (keyframe, sharded)
                  shard_00000.dcbc ...
    step_00000011/params.manifest.json   v2 manifest, "base": step 10
                  delta_00000.dcbc       v4 container (ENC_CABAC_DELTA)
    step_00000012/params.manifest.json   v2 manifest, "base": step 11
                  delta_00000.dcbc

Keyframes may equally be monolithic (``params.dcbc``); the base
reference then pins that blob's hash.  Restore always resolves the whole
chain: :func:`restore_levels` reconstructs the quantized entries (what a
serving backend cold-starts a chain's tip from) and
:func:`restore_flat_delta` full host tensors, which
:func:`restore_on_mesh_delta` places on a ``DeviceMesh``.  The
files, manifests and error messages are the reference's, so a chain
written by either package restores in the other.

Keyframe cadence and chain-aware retention are the
``CheckpointManager``'s job (``CheckpointConfig.delta_every``).
"""

from __future__ import annotations

import hashlib
import os
import re
from concurrent.futures import ThreadPoolExecutor

from ..arrays import dtype_name
from ..core import binarization as B
from ..core.codec import (DEFAULT_CHUNK, DecodeOptions, DeltaTensor,
                          QuantizedTensor, decode_delta_record, decode_record,
                          decode_state_dict_batched,
                          encode_delta_chunks_batched,
                          encode_level_chunks_batched)
from ..core.container import ENC_CABAC_DELTA, ContainerReader, ContainerWriter
from .sharded import (MANIFEST_FORMAT, MANIFEST_NAME, MANIFEST_VERSION_DELTA,
                      _is_raw, load_manifest, place_on_mesh, restore_flat,
                      verify_files)

DELTA_FILE = "delta_00000.dcbc"
PARAMS_FILE = "params.dcbc"            # monolithic keyframe payload
DEFAULT_MAX_DEPTH = 64

_STEP_RE = re.compile(r"^step_(\d+)$")


class DeltaBaseMissingError(FileNotFoundError):
    """A delta step's base frame is gone from disk — most likely retained
    away (``CheckpointConfig.keep``) by a manager that did not know about
    the chain, or deleted by hand.  The chain is unrecoverable."""


class DeltaChainError(ValueError):
    """The delta chain is structurally invalid: a base hash mismatch
    (substituted/rewritten base), a cycle, or a depth past ``max_depth``."""


# ---------------------------------------------------------------------------
# Step-directory naming
# ---------------------------------------------------------------------------

def step_dir(root: str, step: int) -> str:
    return os.path.join(root, f"step_{step:08d}")


def _root_and_step(directory: str, step: int | None) -> tuple[str, int]:
    """Accept either ``(checkpoint_root, step)`` or a step directory with
    ``step=None`` (the error-message-friendly spelling)."""
    if step is not None:
        return str(directory), int(step)
    base = os.path.basename(os.path.normpath(str(directory)))
    m = _STEP_RE.match(base)
    if not m:
        raise ValueError(
            f"{directory}: pass (checkpoint_root, step) or a "
            f"step_NNNNNNNN directory")
    return os.path.dirname(os.path.normpath(str(directory))), int(m.group(1))


def _payload_name(d: str) -> str:
    """The file a base reference pins: the manifest for sharded/delta
    steps, the monolithic container otherwise."""
    if os.path.exists(os.path.join(d, MANIFEST_NAME)):
        return MANIFEST_NAME
    return PARAMS_FILE


# Per-process memo of verified file hashes.  Resolving several chains over
# the same keyframe would otherwise re-read and re-hash the (large) base
# payload each time.  Keyed by file
# *identity* — (device, inode, size, mtime_ns) — so hardlinked views of
# one content-addressed object share an entry, while a rewritten base
# (new inode, or same inode with changed size/mtime) misses the cache
# and is re-hashed, preserving the substituted-base detection in
# :func:`resolve_chain`.
_HASH_CACHE: dict[tuple[int, int, int, int], str] = {}
_HASH_STATS = {"hits": 0, "misses": 0}


def hash_cache_stats() -> dict:
    """Copy of the per-process sha256 memo counters (tests/benches)."""
    return dict(_HASH_STATS)


def clear_hash_cache() -> None:
    _HASH_CACHE.clear()
    _HASH_STATS["hits"] = 0
    _HASH_STATS["misses"] = 0


def _sha256_file(path: str) -> str:
    st = os.stat(path)
    key = (st.st_dev, st.st_ino, st.st_size, st.st_mtime_ns)
    cached = _HASH_CACHE.get(key)
    if cached is not None:
        _HASH_STATS["hits"] += 1
        return cached
    _HASH_STATS["misses"] += 1
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    digest = h.hexdigest()
    _HASH_CACHE[key] = digest
    return digest


def base_ref(root: str, step: int) -> dict:
    """Build the ``"base"`` block a delta manifest carries: the base step
    number, its directory name, which file inside it is the pinned
    payload, and that file's SHA-256 (for sharded/delta bases this is the
    manifest, whose own ``files`` hashes transitively pin every shard)."""
    d = step_dir(root, step)
    name = _payload_name(d)
    path = os.path.join(d, name)
    if not os.path.exists(path):
        raise DeltaBaseMissingError(
            f"cannot reference step {step} as a delta base: "
            f"{path} does not exist")
    return {"step": int(step),
            "dir": os.path.basename(d),
            "manifest": name,
            "sha256": _sha256_file(path)}


# ---------------------------------------------------------------------------
# Write: delta entries -> v4 container + v2 manifest
# ---------------------------------------------------------------------------

def write_delta(dentries: dict, *, codec_name: str, base: dict,
                num_gr: int = B.DEFAULT_NUM_GR,
                chunk_size: int = DEFAULT_CHUNK,
                encode_backend: str = "auto",
                workers: int = 0) -> tuple[dict[str, bytes], dict]:
    """Build a delta step's payload set from ``DeltaCodec.delta_entries``
    output (flat name -> ``DeltaTensor`` | ``QuantizedTensor`` | raw
    tensor).

    Residual entries become ``ENC_CABAC_DELTA`` records (temporal-context
    CABAC, container v4); tensors without a compatible base are full
    intra ``cabac_v3`` records; the rest are raw.  Returns ``(payloads,
    manifest)`` exactly like ``sharded.write_sharded`` — payloads is
    ``{DELTA_FILE: blob}`` and the manifest is a version-2 dcbc-manifest
    whose ``"base"`` block is the caller-provided :func:`base_ref`.
    ``workers`` > 1 runs the per-tensor entropy encodes on a thread pool.
    """
    items = list(dentries.items())

    def encode(item):
        name, e = item
        if isinstance(e, DeltaTensor):
            return encode_delta_chunks_batched(
                e.resid, e.base, num_gr, chunk_size, backend=encode_backend)
        if isinstance(e, QuantizedTensor):
            return encode_level_chunks_batched(
                e.levels, num_gr, chunk_size, backend=encode_backend)
        return None

    if workers > 1 and len(items) > 1:
        with ThreadPoolExecutor(max_workers=workers) as ex:
            encoded = list(ex.map(encode, items))
    else:
        encoded = [encode(i) for i in items]

    writer = ContainerWriter()
    tensors: dict = {}
    for (name, e), enc in zip(items, encoded):
        if isinstance(e, DeltaTensor):
            chunks, counts = enc
            writer.add_cabac_delta(name, e.dtype, e.shape, e.step,
                                   num_gr, chunk_size, chunks, counts)
            encoding = "cabac_delta"
            shape, dtype, step = e.shape, e.dtype, float(e.step)
        elif isinstance(e, QuantizedTensor):
            chunks, counts = enc
            writer.add_cabac_v3(name, e.dtype, e.shape, e.step,
                                num_gr, chunk_size, chunks, counts)
            encoding = "cabac_v3"
            shape, dtype, step = e.shape, e.dtype, float(e.step)
        elif _is_raw(e):
            writer.add_raw(name, e)
            encoding = "raw"
            shape, dtype, step = tuple(e.shape), dtype_name(e.dtype), None
            counts = None
        else:                                   # Q8Tensor
            writer.add_q8(name, e.dtype, e.levels, e.scale)
            encoding = "q8"
            shape, dtype, step, counts = e.shape, e.dtype, None, None
        tinfo = {
            "shape": list(shape),
            "dtype": dtype,
            "encoding": encoding,
            "spec": [[] for _ in shape],
            "grid": [1] * len(shape),
            "shards": [],
        }
        if step is not None:
            tinfo["step"] = step
        tensors[name] = (tinfo, counts)

    blob = writer.tobytes()
    for ((name, _e), _enc), (off, length) in zip(
            zip(items, encoded), writer.record_spans()):
        tinfo, counts = tensors[name]
        shape = tinfo["shape"]
        shard = {"index": [0] * len(shape), "start": [0] * len(shape),
                 "stop": list(shape), "file": DELTA_FILE, "record": name,
                 "offset": off, "length": length}
        if counts is not None:
            shard["chunk_counts"] = [int(c) for c in counts]
        tinfo["shards"].append(shard)

    manifest = {
        "format": MANIFEST_FORMAT,
        "manifest_version": MANIFEST_VERSION_DELTA,
        "codec": codec_name,
        "mesh": {"axes": ["data"], "shape": [1]},
        "num_gr": int(num_gr),
        "chunk_size": int(chunk_size),
        "base": dict(base),
        "tensors": {name: tinfo for name, (tinfo, _c) in tensors.items()},
        "files": {DELTA_FILE: {"bytes": len(blob),
                               "sha256": hashlib.sha256(blob).hexdigest()}},
    }
    return {DELTA_FILE: blob}, manifest


# ---------------------------------------------------------------------------
# Chain resolution
# ---------------------------------------------------------------------------

def _manifest_or_none(d: str) -> dict | None:
    if os.path.exists(os.path.join(d, MANIFEST_NAME)):
        return load_manifest(d)
    return None


def base_step_of(directory: str, step: int | None = None) -> int | None:
    """The step a delta step chains to, or ``None`` for a keyframe."""
    root, step = _root_and_step(directory, step)
    manifest = _manifest_or_none(step_dir(root, step))
    if manifest is None or manifest.get("base") is None:
        return None
    return int(manifest["base"]["step"])


def resolve_chain(directory: str, step: int | None = None,
                  max_depth: int = DEFAULT_MAX_DEPTH) -> list[dict]:
    """Walk a step's base chain back to its keyframe, validating every
    link, and return it **base-first**: a list of
    ``{"step", "dir", "kind" ("keyframe"|"delta"), "manifest" (or None)}``.

    Raises :class:`DeltaBaseMissingError` when a referenced base step (or
    its pinned payload file) is gone — the descriptive version of the
    bare ``FileNotFoundError`` a naive restore would hit — and
    :class:`DeltaChainError` on a base-hash mismatch, a chain longer than
    ``max_depth`` links, or a cycle."""
    root, step = _root_and_step(directory, step)
    chain: list[dict] = []
    seen: set[int] = set()
    cur: int | None = step
    expect: dict | None = None          # the base block that led us here
    while True:
        d = step_dir(root, cur)
        if not os.path.isdir(d):
            raise DeltaBaseMissingError(
                f"delta chain for step {step} is broken: base step {cur} "
                f"({d}) does not exist — it was likely removed by "
                f"retention that predates chain-aware GC, or deleted by "
                f"hand; the P-frames above it cannot be reconstructed")
        name = _payload_name(d)
        path = os.path.join(d, name)
        if not os.path.exists(path):
            raise DeltaBaseMissingError(
                f"delta chain for step {step} is broken: step {cur} has "
                f"no payload ({path} missing)")
        if expect is not None:
            digest = _sha256_file(path)
            if digest != expect.get("sha256"):
                raise DeltaChainError(
                    f"delta chain for step {step}: step {cur}'s {name} "
                    f"hash {digest[:12]}... does not match the "
                    f"{expect['sha256'][:12]}... its dependent P-frame "
                    f"pinned — the base was rewritten after the delta "
                    f"was saved")
        if cur in seen:
            raise DeltaChainError(
                f"delta chain for step {step} revisits step {cur} — "
                f"cyclic base references")
        seen.add(cur)
        manifest = _manifest_or_none(d)
        base = manifest.get("base") if manifest else None
        chain.append({"step": cur, "dir": d,
                      "kind": "delta" if base is not None else "keyframe",
                      "manifest": manifest})
        if base is None:
            break
        if len(chain) > max_depth:
            raise DeltaChainError(
                f"delta chain for step {step} exceeds max_depth="
                f"{max_depth} P-frames without reaching a keyframe")
        expect = base
        cur = int(base["step"])
    chain.reverse()
    return chain


def chain_files(directory: str, step: int | None = None,
                max_depth: int = DEFAULT_MAX_DEPTH) -> list[dict]:
    """Per-link payload inventory of a step's base chain, base-first.

    Each entry extends :func:`resolve_chain`'s link dict with a
    ``"files"`` map: every file the link's step directory contributes —
    manifest ``files`` entries (shards or the delta container) with
    their recorded bytes/sha256, plus the manifest itself (hashed here)
    or, for monolithic keyframes, the bare ``params.dcbc``.  This is the
    unit a content-addressed store ingests: the sha256 values are the
    object keys, so two variants chaining to one keyframe list identical
    hashes for the shared shard files."""
    chain = resolve_chain(directory, step, max_depth=max_depth)
    out = []
    for link in chain:
        d = link["dir"]
        manifest = link["manifest"]
        files: dict[str, dict] = {}
        if manifest is not None:
            for fname, info in manifest.get("files", {}).items():
                files[fname] = {"bytes": int(info["bytes"]),
                                "sha256": str(info["sha256"])}
            mpath = os.path.join(d, MANIFEST_NAME)
            files[MANIFEST_NAME] = {"bytes": os.path.getsize(mpath),
                                    "sha256": _sha256_file(mpath)}
        else:
            ppath = os.path.join(d, PARAMS_FILE)
            files[PARAMS_FILE] = {"bytes": os.path.getsize(ppath),
                                  "sha256": _sha256_file(ppath)}
        out.append({**link, "files": files})
    return out


# ---------------------------------------------------------------------------
# Restore: chain -> levels -> tensors
# ---------------------------------------------------------------------------

def _apply_delta_file(entries: dict, d: str, opts: DecodeOptions | None,
                      step: int) -> dict:
    """Decode one delta step's container on top of ``entries`` (the
    reconstructed previous frame, quantized): residual records patch the
    co-named base entry, full records replace it."""
    path = os.path.join(d, DELTA_FILE)
    if not os.path.exists(path):
        raise DeltaBaseMissingError(
            f"delta step {step}: {path} missing (manifest present but "
            f"payload gone — partial delete?)")
    with open(path, "rb") as f:
        blob = f.read()
    for hdr, payload in ContainerReader(blob):
        if hdr.encoding == ENC_CABAC_DELTA:
            base = entries.get(hdr.name)
            if not isinstance(base, QuantizedTensor):
                raise DeltaChainError(
                    f"delta step {step}: record {hdr.name!r} is a "
                    f"residual but the reconstructed base frame has no "
                    f"quantized tensor of that name")
            entries[hdr.name] = decode_delta_record(
                hdr, payload, base.levels, dequantize=False, opts=opts)
        else:
            entries[hdr.name] = decode_record(hdr, payload,
                                              dequantize=False, opts=opts)
    return entries


def restore_levels(directory: str, step: int | None = None, *,
                   opts: DecodeOptions | None = None,
                   max_depth: int = DEFAULT_MAX_DEPTH,
                   workers: int = 0, verify: bool = False) -> dict:
    """Reconstruct a (possibly delta) step's flat quantized entries —
    name -> ``QuantizedTensor`` | ``Q8Tensor`` | raw CPU tensor — by
    resolving the chain, decoding the keyframe, and applying each
    P-frame's residuals in order.  Bit-identical to decoding a direct
    (monolithic) encode of the same step-locked frame."""
    root, step = _root_and_step(directory, step)
    chain = resolve_chain(root, step, max_depth=max_depth)
    key = chain[0]
    if key["manifest"] is not None:
        if verify:
            verify_files(key["dir"], key["manifest"])
        entries = restore_flat(key["dir"], opts=opts, dequantize=False,
                               workers=workers)
    else:
        with open(os.path.join(key["dir"], PARAMS_FILE), "rb") as f:
            entries = decode_state_dict_batched(f.read(), dequantize=False,
                                                opts=opts)
    for link in chain[1:]:
        if verify:
            verify_files(link["dir"], link["manifest"])
        entries = _apply_delta_file(entries, link["dir"], opts, link["step"])
    return entries


def _dequantized(entries: dict) -> dict:
    return {name: (e if _is_raw(e) else e.dequantize())
            for name, e in entries.items()}


def restore_flat_delta(directory: str, step: int | None = None, *,
                       opts: DecodeOptions | None = None,
                       max_depth: int = DEFAULT_MAX_DEPTH,
                       workers: int = 0, verify: bool = False) -> dict:
    """Full host-side restore of a delta step: resolve the chain and
    return dequantized ``{name: CPU tensor}`` — the delta-aware
    counterpart of ``sharded.restore_flat``.  Works on keyframes too."""
    return _dequantized(restore_levels(directory, step, opts=opts,
                                       max_depth=max_depth, workers=workers,
                                       verify=verify))


def restore_on_mesh_delta(directory: str, step: int | None, mesh, *,
                          rules=None, opts: DecodeOptions | None = None,
                          max_depth: int = DEFAULT_MAX_DEPTH,
                          workers: int = 0, verify: bool = False) -> dict:
    """Restore a delta step as ``DTensor``\\ s on any target
    ``DeviceMesh`` (elastic: the mesh need not match any save mesh in the
    chain).  Residual reconstruction is inherently full-frame — every
    P-frame element needs its co-located base level — so tensors are
    chain-reconstructed on the host, then each placed with its spec on
    the target mesh (the same rule table the training specs use): this
    rank keeps its box."""
    flat = restore_flat_delta(directory, step, opts=opts,
                              max_depth=max_depth, workers=workers,
                              verify=verify)
    return {name: place_on_mesh(name, arr, mesh, rules=rules)
            for name, arr in flat.items()}
