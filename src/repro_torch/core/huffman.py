"""Scalar Huffman coding baseline (paper algs. 1-3, §IV-B-2), the port's
copy of ``repro.core.huffman``: writer and reader of the canonical-Huffman
records (ENC_HUFF) of version 2 containers, byte for byte the reference's.

Canonical Huffman codes with an explicitly accounted two-part header
(the paper's point: unlike backward-adaptive CABAC, Huffman must transmit
its probability model).
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass

import numpy as np


@dataclass
class HuffmanCode:
    symbols: np.ndarray          # unique symbol values (sorted)
    lengths: np.ndarray          # code length per symbol
    codes: dict[int, tuple[int, int]]  # symbol -> (bits, length)

    @property
    def table_bits(self) -> int:
        """Two-part-code header: symbol values (32b each) + lengths (8b)."""
        return int(self.symbols.size * (32 + 8))


def canonical_codes(vals: np.ndarray,
                    lengths: np.ndarray) -> dict[int, tuple[int, int]]:
    """Canonical code assignment from (symbol, length) pairs — the part of
    the two-part code a decoder rebuilds from the transmitted header."""
    order = np.lexsort((vals, lengths))
    codes: dict[int, tuple[int, int]] = {}
    code, prev_len = 0, 0
    for idx in order:
        ln = int(lengths[idx])
        code <<= (ln - prev_len)
        codes[int(vals[idx])] = (code, ln)
        code += 1
        prev_len = ln
    return codes


def build_huffman(values: np.ndarray) -> HuffmanCode:
    vals, counts = np.unique(np.asarray(values).ravel(), return_counts=True)
    if vals.size == 0:
        lengths = np.zeros(0, dtype=np.int64)
    elif vals.size == 1:
        lengths = np.array([1])
    else:
        # heap of (count, tiebreak, node); node = symbol index or [l, r]
        heap: list = [(int(c), i, i) for i, c in enumerate(counts)]
        heapq.heapify(heap)
        tie = len(heap)
        while len(heap) > 1:
            c1, _, n1 = heapq.heappop(heap)
            c2, _, n2 = heapq.heappop(heap)
            heapq.heappush(heap, (c1 + c2, tie, [n1, n2]))
            tie += 1
        lengths = np.zeros(vals.size, dtype=np.int64)

        def walk(node, depth):
            if isinstance(node, list):
                walk(node[0], depth + 1)
                walk(node[1], depth + 1)
            else:
                lengths[node] = max(depth, 1)
        walk(heap[0][2], 0)

    return HuffmanCode(symbols=vals, lengths=lengths,
                       codes=canonical_codes(vals, lengths))


def huffman_payload_bits(values: np.ndarray, code: HuffmanCode) -> int:
    vals, counts = np.unique(np.asarray(values).ravel(), return_counts=True)
    total = 0
    for v, c in zip(vals.tolist(), counts.tolist()):
        total += code.codes[int(v)][1] * c
    return total


def huffman_encode(values: np.ndarray, code: HuffmanCode) -> bytes:
    out = bytearray()
    acc, nbits = 0, 0
    for v in np.asarray(values).ravel().tolist():
        bits, ln = code.codes[int(v)]
        acc = (acc << ln) | bits
        nbits += ln
        while nbits >= 8:
            nbits -= 8
            out.append((acc >> nbits) & 0xFF)
            acc &= (1 << nbits) - 1
    if nbits:
        out.append((acc << (8 - nbits)) & 0xFF)
    return bytes(out)


def huffman_decode(data: bytes, count: int, code: HuffmanCode) -> np.ndarray:
    # decode via a (code, length) -> symbol map; canonical codes are prefix-free
    rev = {(bits, ln): sym for sym, (bits, ln) in code.codes.items()}
    out = np.empty(count, dtype=np.int64)
    acc, ln, pos = 0, 0, 0
    it = iter(data)
    bitpos = 0
    byte = 0
    for i in range(count):
        while True:
            if bitpos == 0:
                byte = next(it, None)
                if byte is None:
                    raise ValueError(
                        f"huffman bitstream truncated: decoded {i} of "
                        f"{count} values")
                bitpos = 8
            bitpos -= 1
            acc = (acc << 1) | ((byte >> bitpos) & 1)
            ln += 1
            sym = rev.get((acc, ln))
            if sym is not None:
                out[i] = sym
                acc, ln = 0, 0
                break
    return out


PAYLOAD_HEADER = "<I"   # u32 nsym | i32 symbols | u8 lengths | bitstream


def pack_payload(values: np.ndarray, code: HuffmanCode) -> bytes:
    """Serialize the two-part code (table in-band) + canonical bitstream.
    The single source of truth for the ENC_HUFF container wire format."""
    import struct
    if code.symbols.size:
        if (code.symbols.max() > np.iinfo(np.int32).max
                or code.symbols.min() < np.iinfo(np.int32).min):
            raise ValueError("huffman symbols exceed the i32 range")
        if code.lengths.max() > 255:
            raise ValueError("huffman code depth exceeds u8")
    return (struct.pack(PAYLOAD_HEADER, code.symbols.size)
            + code.symbols.astype("<i4").tobytes()
            + code.lengths.astype("<u1").tobytes()
            + huffman_encode(values, code))


def unpack_payload(payload: bytes, count: int) -> np.ndarray:
    """Inverse of :func:`pack_payload`: rebuild the canonical code from the
    in-band table and decode ``count`` values."""
    import struct
    (nsym,) = struct.unpack_from(PAYLOAD_HEADER, payload, 0)
    off = struct.calcsize(PAYLOAD_HEADER)
    symbols = np.frombuffer(payload, dtype="<i4", count=nsym,
                            offset=off).astype(np.int64)
    off += 4 * nsym
    lengths = np.frombuffer(payload, dtype="<u1", count=nsym,
                            offset=off).astype(np.int64)
    off += nsym
    code = HuffmanCode(symbols=symbols, lengths=lengths,
                       codes=canonical_codes(symbols, lengths))
    return huffman_decode(payload[off:], count, code)


def scalar_huffman_size_bits(values: np.ndarray,
                             include_table: bool = True) -> int:
    code = build_huffman(values)
    bits = huffman_payload_bits(values, code)
    return bits + (code.table_bits if include_table else 0)


def epmd_entropy_bits(values: np.ndarray) -> float:
    """i.i.d. entropy of the empirical PMF, in bits *total* (n * H)."""
    _, counts = np.unique(np.asarray(values).ravel(), return_counts=True)
    p = counts / counts.sum()
    return float(-np.sum(p * np.log2(p)) * np.asarray(values).size)
