"""CSR-Huffman baseline ([38] Deep Compression, paper §IV-B-3) + bzip2,
the port's copy of ``repro.core.csr`` (numpy host code).

CSR-Huffman stores a sparse matrix as (row_ptr, col-index deltas, values) and
Huffman-codes the delta and value streams.  As in Deep Compression, column
deltas are capped at ``2**delta_bits - 1`` with zero-valued padding symbols
for longer runs.
"""

from __future__ import annotations

import bz2

import numpy as np

from .huffman import build_huffman, huffman_payload_bits


def csr_streams(levels2d: np.ndarray, delta_cap: int = 255
                ) -> tuple[np.ndarray, np.ndarray, int]:
    """Return (delta_stream, value_stream, num_rows) with padding symbols."""
    m = np.asarray(levels2d)
    if m.ndim == 1:
        m = m[None, :]
    elif m.ndim > 2:
        m = m.reshape(m.shape[0], -1)
    deltas: list[int] = []
    values: list[int] = []
    for row in m:
        (nz,) = np.nonzero(row)
        prev = -1
        for c in nz.tolist():
            d = c - prev
            while d > delta_cap:          # padding: emit zero value
                deltas.append(delta_cap)
                values.append(0)
                d -= delta_cap
            deltas.append(d)
            values.append(int(row[c]))
            prev = c
    return (np.asarray(deltas, dtype=np.int64),
            np.asarray(values, dtype=np.int64), m.shape[0])


def csr_huffman_size_bits(levels2d: np.ndarray, delta_cap: int = 255) -> int:
    deltas, values, nrows = csr_streams(levels2d, delta_cap)
    bits = 32 * (nrows + 1)               # row_ptr
    if deltas.size:
        dc = build_huffman(deltas)
        vc = build_huffman(values)
        bits += huffman_payload_bits(deltas, dc) + dc.table_bits
        bits += huffman_payload_bits(values, vc) + vc.table_bits
    return bits


def _min_int_dtype(levels: np.ndarray) -> np.dtype:
    a = np.asarray(levels)
    amax = int(np.abs(a).max()) if a.size else 0
    if amax < 128:
        return np.dtype(np.int8)
    if amax < (1 << 15):
        return np.dtype(np.int16)
    return np.dtype(np.int32)


def bzip2_size_bits(levels: np.ndarray) -> int:
    """bzip2 over the narrowest integer packing of the level array."""
    a = np.asarray(levels).astype(_min_int_dtype(levels))
    return 8 * len(bz2.compress(a.tobytes(), 9))
