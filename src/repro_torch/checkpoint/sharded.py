"""Sharded DCBC checkpoints: per-shard container files + a JSON manifest
(the port's copy of ``repro.checkpoint.sharded``).

Parameters are split into tensor shards along their
:mod:`repro_torch.distributed.sharding` specs, each (owner device,
tensor-shard) becomes one record in that owner's own DCBC container file,
and a JSON manifest records everything a restore needs:

* the global shape / dtype / codec of every tensor,
* per shard: grid index, global [start, stop) box, owning file, the
  record's (byte offset, length) within that file (so restore preads one
  record instead of mapping the file — ``core.container.read_record_at``),
  and the per-chunk value counts of the v3 CABAC record,
* per file: size + SHA-256 content hash.

A save mesh is a :class:`MeshSpec`, axis names and sizes only: the shard
grid needs no devices, so a single card writes the files a multi-card save
would.  The files and the manifest are byte-identical to the reference's
for the same entries and mesh.  Quantization happens on the *full* tensor
before sharding (the step size is a global per-tensor quantity), so a
sharded save restores bit-identically to the monolithic path.  Restore is
manifest-driven and host-side (:func:`restore_flat`, :func:`assemble_slice`:
only the v3 chunk ranges a box needs are decoded); placing slices on a mesh
of cards (``restore_on_mesh`` and its helpers) waits for the multi-card
slice.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np

import torch

from ..arrays import dtype_name
from ..core import binarization as B
from ..core.codec import (DEFAULT_CHUNK, DecodeOptions, QuantizedTensor,
                          decode_level_chunks_batched, decode_record,
                          encode_level_chunks_batched)
from ..core.container import ContainerWriter, read_record_at
from ..distributed.sharding import logical_axes_for_path, spec_for

MANIFEST_NAME = "params.manifest.json"
MANIFEST_FORMAT = "dcbc-manifest"
MANIFEST_VERSION = 1
# Manifest version 2 adds codec chaining: a "base" block naming the frame
# a delta step applies to (repro.checkpoint.delta).  Plain sharded saves
# keep writing version 1; readers here accept both but refuse to restore
# a chained manifest without its chain (see _reject_delta).
MANIFEST_VERSION_DELTA = 2
MANIFEST_MAX_VERSION = MANIFEST_VERSION_DELTA


# ---------------------------------------------------------------------------
# Mesh description (no devices required)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MeshSpec:
    """A mesh's *shape* — axis names and sizes, no device objects.

    Shard-grid math only needs sizes, so a save runs on a host that cannot
    see the fleet's devices; an axis-size dict, or anything with a
    ``.shape`` mapping, converts via :meth:`from_any`.
    """

    axis_names: tuple
    axis_sizes: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return int(np.prod(self.axis_sizes)) if self.axis_sizes else 1

    @classmethod
    def from_any(cls, mesh) -> "MeshSpec":
        if isinstance(mesh, MeshSpec):
            return mesh
        if mesh is None:
            return cls(("data",), (1,))
        shape = mesh.shape if hasattr(mesh, "shape") else mesh
        return cls(tuple(shape.keys()),
                   tuple(int(v) for v in shape.values()))


def _is_raw(entry) -> bool:
    return isinstance(entry, (torch.Tensor, np.ndarray))


def _axes_of(entry) -> tuple:
    """Spec entry -> tuple of mesh axis names."""
    if entry is None:
        return ()
    if isinstance(entry, (tuple, list)):
        return tuple(entry)
    return (entry,)


def _spec_axes(spec, ndim: int) -> list[tuple]:
    axes = [_axes_of(e) for e in spec]
    return axes + [()] * (ndim - len(axes))


def shard_grid(spec_axes: list[tuple], mesh: MeshSpec) -> tuple[int, ...]:
    """Shard counts per dim: the product of the dim's mesh-axis sizes."""
    shape = mesh.shape
    return tuple(int(np.prod([shape.get(a, 1) for a in axes]))
                 if axes else 1 for axes in spec_axes)


def shard_box(shape, grid, index) -> tuple[tuple, tuple]:
    """Global [start, stop) box of shard ``index`` on the shard grid."""
    starts, stops = [], []
    for dim, n, i in zip(shape, grid, index):
        if dim % n:
            raise ValueError(
                f"dim {dim} not divisible by shard count {n} "
                f"(specs are resolved with divisibility fallback, so this "
                f"indicates a manifest/mesh mismatch)")
        sz = dim // n
        starts.append(i * sz)
        stops.append((i + 1) * sz)
    return tuple(starts), tuple(stops)


def _owner_device(spec_axes: list[tuple], mesh: MeshSpec, index) -> int:
    """Flat index (C order over mesh axes) of the first device owning the
    shard — the replica at coordinate 0 of every unmentioned axis.  This
    is the device whose file the shard is written to, deduplicating
    replicated shards."""
    coords = {a: 0 for a in mesh.axis_names}
    for axes, idx in zip(spec_axes, index):
        rem = int(idx)
        for pos in range(len(axes) - 1, -1, -1):
            a = axes[pos]
            size = mesh.shape.get(a, 1)
            coords[a] = rem % size
            rem //= size
    flat = 0
    for a in mesh.axis_names:
        flat = flat * mesh.shape[a] + coords[a]
    return flat


def spec_axes_for(name: str, shape, mesh: MeshSpec,
                  rules=None) -> list[tuple]:
    """Resolve a tensor's per-dim mesh axes from the shared rule table
    (``logical_axes_for_path`` + ``spec_for``), so save and restore can
    never disagree on geometry."""
    spec = spec_for(shape, logical_axes_for_path(name, len(shape)),
                    mesh, rules)
    return _spec_axes(spec, len(shape))


# ---------------------------------------------------------------------------
# Save: entries -> per-shard container files + manifest
# ---------------------------------------------------------------------------

def write_sharded(entries: dict, mesh, *, codec_name: str, rules=None,
                  num_gr: int = B.DEFAULT_NUM_GR,
                  chunk_size: int = DEFAULT_CHUNK,
                  encode_backend: str = "auto",
                  workers: int = 0) -> tuple[dict[str, bytes], dict]:
    """Build the sharded payload set from quantized entries.

    ``entries`` is the ``Codec.quantize_entries`` output — flat name ->
    ``QuantizedTensor`` | ``Q8Tensor`` | raw tensor (torch or numpy).
    Quantized (scalar step) tensors are sharded along their resolved
    specs and each
    shard encoded as one v3 CABAC record in its owner device's container
    file; raw and per-channel-int8 entries are written as a single shard
    in device 0's file (they are small or carry per-channel scales that
    do not slice along the grid).

    Returns ``(payloads, manifest)``: payloads maps file name -> bytes
    (one ``shard_NNNNN.dcbc`` per owning device plus nothing else — the
    caller persists the manifest itself), ready for an atomic
    tmp-dir+rename write.  ``workers`` > 1 runs the per-shard entropy
    encodes on a thread pool (the C lane engine releases the GIL).
    """
    mesh = MeshSpec.from_any(mesh)
    jobs = []          # (name, entry, index, starts, stops, owner, record)
    tensors: dict = {}
    for name, entry in entries.items():
        if isinstance(entry, QuantizedTensor):
            shape = entry.shape
            axes = spec_axes_for(name, shape, mesh, rules)
            grid = shard_grid(axes, mesh)
            encoding = "cabac_v3"
        else:
            arr = entry if _is_raw(entry) else entry.levels
            shape = tuple(arr.shape)
            axes = [()] * len(shape)
            grid = (1,) * len(shape)
            encoding = "raw" if _is_raw(entry) else "q8"
        tensors[name] = {
            "shape": list(shape),
            "dtype": (dtype_name(entry.dtype) if _is_raw(entry)
                      else entry.dtype),
            "encoding": encoding,
            "spec": [list(a) for a in axes],
            "grid": list(grid),
            "shards": [],
        }
        if encoding == "cabac_v3":
            tensors[name]["step"] = float(entry.step)
        for index in np.ndindex(*grid) if grid else [()]:
            starts, stops = shard_box(shape, grid, index)
            owner = _owner_device(axes, mesh, index)
            record = (name if all(g == 1 for g in grid)
                      else f"{name}#{'.'.join(map(str, index))}")
            jobs.append((name, entry, tuple(index), starts, stops,
                         owner, record))

    def encode(job):
        name, entry, index, starts, stops, owner, record = job
        if not isinstance(entry, QuantizedTensor):
            return job, None
        box = tuple(slice(a, b) for a, b in zip(starts, stops))
        chunks, counts = encode_level_chunks_batched(
            entry.levels[box], num_gr, chunk_size, backend=encode_backend)
        return job, (chunks, counts)

    if workers > 1 and len(jobs) > 1:
        with ThreadPoolExecutor(max_workers=workers) as ex:
            encoded = list(ex.map(encode, jobs))
    else:
        encoded = [encode(j) for j in jobs]

    # Group records by owner in deterministic (owner, add) order.
    by_owner: dict[int, list] = {}
    for job, enc in encoded:
        by_owner.setdefault(job[5], []).append((job, enc))

    payloads: dict[str, bytes] = {}
    for owner in sorted(by_owner):
        fname = f"shard_{owner:05d}.dcbc"
        writer = ContainerWriter()
        placed = []
        for (name, entry, index, starts, stops, _o, record), enc \
                in by_owner[owner]:
            if isinstance(entry, QuantizedTensor):
                chunks, counts = enc
                shard_shape = tuple(b - a for a, b in zip(starts, stops))
                writer.add_cabac_v3(record, entry.dtype, shard_shape,
                                    entry.step, num_gr, chunk_size,
                                    chunks, counts)
                placed.append((name, index, starts, stops, record, counts))
            elif _is_raw(entry):
                writer.add_raw(record, entry)
                placed.append((name, index, starts, stops, record, None))
            else:                                   # Q8Tensor
                writer.add_q8(record, entry.dtype, entry.levels, entry.scale)
                placed.append((name, index, starts, stops, record, None))
        blob = writer.tobytes()
        for (name, index, starts, stops, record, counts), (off, length) \
                in zip(placed, writer.record_spans()):
            shard = {"index": list(index), "start": list(starts),
                     "stop": list(stops), "file": fname, "record": record,
                     "offset": off, "length": length}
            if counts is not None:
                shard["chunk_counts"] = [int(c) for c in counts]
            tensors[name]["shards"].append(shard)
        payloads[fname] = blob

    manifest = {
        "format": MANIFEST_FORMAT,
        "manifest_version": MANIFEST_VERSION,
        "codec": codec_name,
        "mesh": {"axes": list(mesh.axis_names),
                 "shape": [int(s) for s in mesh.axis_sizes]},
        "num_gr": int(num_gr),
        "chunk_size": int(chunk_size),
        "tensors": tensors,
        "files": {fname: {"bytes": len(blob),
                          "sha256": hashlib.sha256(blob).hexdigest()}
                  for fname, blob in payloads.items()},
    }
    return payloads, manifest


# ---------------------------------------------------------------------------
# Restore: manifest -> slices / full tensors
# ---------------------------------------------------------------------------

class RestoreStats:
    """What a manifest-driven restore actually touched — the honesty
    counter behind 'a sub-mesh restore decodes strictly fewer bytes'."""

    def __init__(self):
        self._lock = threading.Lock()
        self.decoded_values = 0     # entropy-decoded quantized values
        self.read_bytes = 0         # shard-file bytes pread
        self.records_read = 0

    def add(self, values: int = 0, read: int = 0, records: int = 0):
        with self._lock:
            self.decoded_values += int(values)
            self.read_bytes += int(read)
            self.records_read += int(records)

    def as_dict(self) -> dict:
        return {"decoded_values": self.decoded_values,
                "read_bytes": self.read_bytes,
                "records_read": self.records_read}


def load_manifest(directory: str) -> dict:
    path = (directory if str(directory).endswith(".json")
            else os.path.join(directory, MANIFEST_NAME))
    with open(path) as f:
        manifest = json.load(f)
    if manifest.get("format") != MANIFEST_FORMAT:
        raise ValueError(f"{path}: not a {MANIFEST_FORMAT} manifest")
    if manifest.get("manifest_version", 0) > MANIFEST_MAX_VERSION:
        raise ValueError(
            f"{path}: manifest version {manifest['manifest_version']} "
            f"(this reader handles <= {MANIFEST_MAX_VERSION})")
    return manifest


def _reject_delta(manifest: dict, directory: str, caller: str) -> None:
    """Chained (delta) manifests cannot be restored standalone — their
    records are residuals against the base frame the manifest names."""
    if manifest.get("base") is not None:
        raise ValueError(
            f"{directory}: this manifest is a delta (P-frame) step chained "
            f"to base step {manifest['base'].get('step')!r}; {caller} "
            f"cannot restore it standalone — use "
            f"repro_torch.checkpoint.delta.restore_flat_delta, which "
            f"resolves the chain")


def manifest_dir(directory: str) -> str:
    return (os.path.dirname(str(directory))
            if str(directory).endswith(".json") else str(directory))


def verify_files(directory: str, manifest: dict) -> None:
    """Full-file SHA-256 check against the manifest (reads every byte —
    integrity tooling, not the restore hot path)."""
    for fname, info in manifest["files"].items():
        path = os.path.join(directory, fname)
        h = hashlib.sha256()
        with open(path, "rb") as f:
            for block in iter(lambda: f.read(1 << 20), b""):
                h.update(block)
        if h.hexdigest() != info["sha256"]:
            raise ValueError(
                f"shard file {fname} content hash mismatch "
                f"(expected {info['sha256'][:12]}..., "
                f"got {h.hexdigest()[:12]}...) — corrupt or partial write")


def _read_span(directory: str, shard: dict, stats: RestoreStats | None):
    """pread one shard record via its manifest byte-range (no whole-file
    read) and parse it with ``read_record_at``."""
    path = os.path.join(directory, shard["file"])
    with open(path, "rb") as f:
        f.seek(shard["offset"])
        buf = f.read(shard["length"])
    if len(buf) < shard["length"]:
        raise ValueError(
            f"truncated shard file {shard['file']}: record "
            f"{shard['record']!r} at offset {shard['offset']} wants "
            f"{shard['length']} bytes, file provides {len(buf)}")
    if stats is not None:
        stats.add(read=len(buf), records=1)
    return read_record_at(buf)


def _intersect(a_start, a_stop, b_start, b_stop):
    starts = tuple(max(a, b) for a, b in zip(a_start, b_start))
    stops = tuple(min(a, b) for a, b in zip(a_stop, b_stop))
    if any(b <= a for a, b in zip(starts, stops)):
        return None
    return starts, stops


def _decode_shard_box(directory, tinfo, shard, starts, stops,
                      opts, num_gr, stats) -> np.ndarray:
    """Decode the [starts, stops) sub-box of one saved shard, entropy-
    decoding only the v3 chunk range that covers it."""
    hdr, payload = _read_span(directory, shard, stats)
    shard_shape = tuple(b - a for a, b in zip(shard["start"], shard["stop"]))
    rel_start = tuple(a - b for a, b in zip(starts, shard["start"]))
    rel_stop = tuple(a - b for a, b in zip(stops, shard["start"]))
    counts = np.asarray(shard.get("chunk_counts") or hdr.chunk_counts,
                        dtype=np.int64)
    ends = np.cumsum(counts)
    chunk_starts = ends - counts
    if shard_shape:
        lo = int(np.ravel_multi_index(rel_start, shard_shape))
        hi = int(np.ravel_multi_index(
            tuple(s - 1 for s in rel_stop), shard_shape)) + 1
    else:
        lo, hi = 0, 1
    c0 = int(np.searchsorted(ends, lo, side="right"))
    c1 = int(np.searchsorted(chunk_starts, hi, side="left"))
    # materialize only the selected chunk range's bytes (not the record)
    lens = np.asarray(hdr.chunk_lens, dtype=np.int64)
    byte_ends = np.cumsum(lens)
    byte_starts = byte_ends - lens
    chunks = [bytes(payload[byte_starts[k]:byte_ends[k]])
              for k in range(c0, c1)]
    span = decode_level_chunks_batched(
        chunks, counts[c0:c1].tolist(), num_gr or hdr.num_gr, opts)
    if stats is not None:
        stats.add(values=int(counts[c0:c1].sum()))
    if not shard_shape:
        return span.reshape(())
    if rel_start == (0,) * len(shard_shape) and rel_stop == shard_shape:
        return span.reshape(shard_shape)      # the whole shard
    base = int(chunk_starts[c0]) if c1 > c0 else 0
    idx = np.ravel_multi_index(
        np.ix_(*[np.arange(a, b) for a, b in zip(rel_start, rel_stop)]),
        shard_shape)
    return span[idx - base]


def assemble_slice(directory: str, name: str, tinfo: dict,
                   start=None, stop=None, *, opts: DecodeOptions | None = None,
                   num_gr: int | None = None, dequantize: bool = True,
                   stats: RestoreStats | None = None):
    """Assemble one tensor's global [start, stop) box from its covering
    shards, decoding only the chunk ranges the box needs."""
    shape = tuple(tinfo["shape"])
    start = tuple(start) if start is not None else (0,) * len(shape)
    stop = tuple(stop) if stop is not None else shape
    box_shape = tuple(b - a for a, b in zip(start, stop))
    encoding = tinfo["encoding"]

    if encoding != "cabac_v3":
        # raw / q8 entries are single-shard by construction: decode the
        # record, then slice (q8 per-channel scales don't slice on the
        # level grid, so partial boxes require dequantization)
        shard = tinfo["shards"][0]
        hdr, payload = _read_span(directory, shard, stats)
        full = start == (0,) * len(shape) and stop == shape
        if full:
            return decode_record(hdr, payload, dequantize=dequantize,
                                 opts=opts)
        if encoding == "q8" and not dequantize:
            raise ValueError(
                f"{name}: partial restore of 'q8' records requires "
                f"dequantize=True (per-channel scales don't slice)")
        rec = decode_record(hdr, payload, dequantize=True, opts=opts)
        return rec[tuple(slice(a, b) for a, b in zip(start, stop))]

    out = np.empty(box_shape, dtype=np.int64)
    filled = 0
    for shard in tinfo["shards"]:
        inter = _intersect(start, stop, shard["start"], shard["stop"])
        if inter is None:
            continue
        istart, istop = inter
        levels = _decode_shard_box(directory, tinfo, shard, istart, istop,
                                   opts, num_gr, stats)
        dest = tuple(slice(a - s, b - s)
                     for a, b, s in zip(istart, istop, start))
        out[dest] = levels
        filled += levels.size
    if filled != out.size:
        raise ValueError(
            f"{name}: shards cover {filled} of {out.size} elements of "
            f"box {start}..{stop} — manifest does not tile the tensor")
    qt = QuantizedTensor(out, float(tinfo["step"]), tinfo["dtype"])
    return qt.dequantize() if dequantize else qt


def _pool_map(fn, jobs, workers: int):
    if workers > 1 and len(jobs) > 1:
        with ThreadPoolExecutor(max_workers=workers) as ex:
            return list(ex.map(fn, jobs))
    return [fn(j) for j in jobs]


def restore_flat(directory: str, *, opts: DecodeOptions | None = None,
                 dequantize: bool = True, workers: int = 0,
                 stats: RestoreStats | None = None, verify: bool = False
                 ) -> dict:
    """Full host-side restore: every tensor assembled whole (single-host
    deployments / template-driven checkpoint loads)."""
    directory = manifest_dir(directory)
    manifest = load_manifest(directory)
    _reject_delta(manifest, directory, "restore_flat")
    if verify:
        verify_files(directory, manifest)
    items = sorted(manifest["tensors"].items())

    def job(item):
        name, tinfo = item
        return name, assemble_slice(
            directory, name, tinfo, opts=opts,
            num_gr=manifest.get("num_gr"), dequantize=dequantize,
            stats=stats)
    return dict(_pool_map(job, items, workers))


def restore_tensor_on_mesh(*args, **kwargs):
    """Placement of one tensor's slices on a mesh of cards: waits for the
    multi-card slice."""
    raise NotImplementedError("restore_tensor_on_mesh: not yet ported")


def restore_on_mesh(*args, **kwargs):
    """Elastic restore onto a mesh of cards: waits for the multi-card
    slice."""
    raise NotImplementedError("restore_on_mesh: not yet ported")


def restore_local_slices(*args, **kwargs):
    """The slices a subset of a target mesh's devices owns: waits for the
    multi-card slice."""
    raise NotImplementedError("restore_local_slices: not yet ported")


def manifest_total_values(manifest: dict) -> int:
    """Entropy-coded values across every cabac shard (monolithic-restore
    decode cost, for sub-mesh comparisons)."""
    total = 0
    for tinfo in manifest["tensors"].values():
        for shard in tinfo["shards"]:
            total += int(sum(shard.get("chunk_counts") or []))
    return total


def manifest_files(manifest: dict) -> dict[str, dict]:
    """The manifest's payload-file inventory: file name ->
    ``{"bytes", "sha256"}``.  These hashes are content-address keys — a
    dedup store ingests exactly this set (plus the manifest itself)."""
    return {fname: {"bytes": int(info["bytes"]),
                    "sha256": str(info["sha256"])}
            for fname, info in manifest.get("files", {}).items()}


def manifest_payload_bytes(manifest: dict) -> int:
    """Total on-disk payload bytes the manifest pins (shards or delta
    container; the manifest's own JSON is not counted)."""
    return sum(f["bytes"] for f in manifest_files(manifest).values())
