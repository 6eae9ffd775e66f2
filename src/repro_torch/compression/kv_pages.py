"""KV-page codec: the paper's quantize -> CABAC stack pointed at KV pages
(the port's copy of ``repro.compression.kv_pages``).

``KVPageCodec`` (registered as ``kv-q8-cabac``) turns a tree of gathered
KV-cache pages into one v3-chunked DCBC container and back.  It is the
eviction format of the paged serving cache (``repro_torch.serve.kv``):
cold pages are entropy-coded to the host, and a restore decodes every
chunk of a record through the lane-parallel engine
(``decode_level_chunks_batched``), as a container cold start does.

Two leaf encodings, chosen by the page's storage dtype:

* int8 pages (``cfg.q8_cache=True``: levels on the ``kv_cache_delta``
  grid) are coded **losslessly**: the levels go straight through CABAC,
  so an evict/restore round trip is bit-exact and a paged session stays
  token-identical to an unpaged one.
* float pages (bf16/f32 caches) are q8 block-quantized first
  (``compression.q8``, per-128-block absmax scales): the codes are
  CABAC-coded and the f32 scales ride along as a raw ``<name>#scale``
  record.  The restore is the q8 reconstruction.

A blob equals the reference's byte for byte for the same pages, and each
package decodes the other's.  Pages may be torch tensors on any device
(a float page is q8-coded where it lies, then its codes and scales come
to the host) or numpy arrays (bf16 as ``ml_dtypes.bfloat16``, recognised
by its dtype name); decode gives CPU tensors.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..arrays import dtype_name, from_storage, torch_dtype
from ..core import binarization as B
from ..core.codec import (DecodeOptions, decode_record,
                          encode_level_chunks_batched)
from ..core.container import ContainerReader, ContainerWriter
from .artifact import Artifact
from .q8 import q8_decode, q8_encode
from .tree import flatten_tree, unflatten_like

# Flat page names join key paths with "/", so "#" cannot collide.
SCALE_SUFFIX = "#scale"

# Pages are small (a few hundred KiB to a few MiB); smaller chunks than the
# weight codecs' DEFAULT_CHUNK keep enough lanes in flight per record.
KV_PAGE_CHUNK = 1 << 14


def _as_tensor(arr) -> torch.Tensor:
    return arr if isinstance(arr, torch.Tensor) else from_storage(
        np.asarray(arr))


@dataclass
class KVPageCodec:
    """Compress/decompress a tree of KV pages (see the module docstring).

    ``step`` records the int8 cache's ``kv_cache_delta`` in each header:
    informational for int8 pages (decode returns the levels; the model
    dequantizes them), unused for float pages.
    """

    step: float = 1.0
    num_gr: int = B.DEFAULT_NUM_GR
    chunk_size: int = KV_PAGE_CHUNK
    backend: str = "auto"
    name: str = "kv-q8-cabac"

    def compress(self, pages) -> Artifact:
        flat = flatten_tree(pages)
        writer = ContainerWriter()
        raw_bytes = 0
        for tname, arr in flat.items():
            t = _as_tensor(arr).detach()
            raw_bytes += t.numel() * t.element_size()
            if t.dtype == torch.int8:
                codes = t.cpu().numpy()
            else:
                codes, scale = q8_encode(t)
                codes = codes.cpu().numpy()
                writer.add_raw(tname + SCALE_SUFFIX, scale.cpu())
            chunks, counts = encode_level_chunks_batched(
                codes.astype(np.int64), self.num_gr, self.chunk_size,
                self.backend)
            writer.add_cabac_v3(tname, dtype_name(t.dtype), tuple(t.shape),
                                self.step, self.num_gr, self.chunk_size,
                                chunks, counts)
        blob = writer.tobytes()
        report = {"tensors": len(flat), "raw_bytes": raw_bytes,
                  "compressed_bytes": len(blob),
                  "ratio": len(blob) / max(raw_bytes, 1)}
        return Artifact(blob=blob, report=report,
                        hyperparams={"codec": self.name, "step": self.step,
                                     "num_gr": self.num_gr,
                                     "chunk_size": self.chunk_size})

    def decompress(self, blob: bytes, like=None,
                   opts: DecodeOptions | None = None):
        """blob -> flat ``{name: CPU tensor}`` (or ``like``'s structure).

        int8 records come back as the stored int8 levels; float records as
        the q8 reconstruction in their original dtype.  All CABAC chunks
        decode through the lane engine that ``opts`` selects."""
        opts = opts or DecodeOptions()
        tensors: dict = {}
        scales: dict = {}
        for hdr, payload in ContainerReader(blob):
            rec = decode_record(hdr, payload, dequantize=False, opts=opts)
            if hdr.name.endswith(SCALE_SUFFIX):
                scales[hdr.name[:-len(SCALE_SUFFIX)]] = rec
            else:
                tensors[hdr.name] = rec
        out: dict = {}
        for tname, qt in tensors.items():
            codes = torch.from_numpy(qt.levels.astype(np.int8))
            if tname in scales:
                out[tname] = q8_decode(codes, scales[tname]).to(
                    torch_dtype(qt.dtype))
            else:
                out[tname] = codes
        if like is not None:
            return unflatten_like(out, like, device="cpu")
        return out
