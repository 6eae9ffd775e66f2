"""Reader of canonical-Huffman records (ENC_HUFF), the decode half of
``repro.core.huffman``: version 2 containers decode in the port.  The
Huffman encoder and its registry codec wait with the baselines."""

from __future__ import annotations

import struct

import numpy as np

PAYLOAD_HEADER = "<I"   # u32 nsym | i32 symbols | u8 lengths | bitstream


def canonical_codes(vals: np.ndarray,
                    lengths: np.ndarray) -> dict[int, tuple[int, int]]:
    """Canonical code assignment from (symbol, length) pairs."""
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


def huffman_decode(data: bytes, count: int,
                   codes: dict[int, tuple[int, int]]) -> np.ndarray:
    rev = {(bits, ln): sym for sym, (bits, ln) in codes.items()}
    out = np.empty(count, dtype=np.int64)
    acc, ln = 0, 0
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


def unpack_payload(payload: bytes, count: int) -> np.ndarray:
    """Rebuild the canonical code from the in-band table and decode
    ``count`` values."""
    (nsym,) = struct.unpack_from(PAYLOAD_HEADER, payload, 0)
    off = struct.calcsize(PAYLOAD_HEADER)
    symbols = np.frombuffer(payload, dtype="<i4", count=nsym,
                            offset=off).astype(np.int64)
    off += 4 * nsym
    lengths = np.frombuffer(payload, dtype="<u1", count=nsym,
                            offset=off).astype(np.int64)
    off += nsym
    return huffman_decode(payload[off:], count,
                          canonical_codes(symbols, lengths))
