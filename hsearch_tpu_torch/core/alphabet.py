"""Amino-acid alphabet and integer encodings (own copy of the parts of
hsearch_tpu/core/alphabet.py that the motif-search CLI needs).

A protein/k-mer is a ``uint8``/``int32`` array of AA indices in the
canonical BLOSUM62 order ``ARNDCQEGHILKMFPSTWYV``.
"""

from __future__ import annotations

import numpy as np

AA20 = "ARNDCQEGHILKMFPSTWYV"

#: Sentinel for characters that are not one of the 20 canonical AAs.
INVALID = 255

# byte -> AA index lookup (uppercase and lowercase), INVALID elsewhere.
_BYTE_TO_INDEX = np.full(256, INVALID, dtype=np.uint8)
for _i, _c in enumerate(AA20):
    _BYTE_TO_INDEX[ord(_c)] = _i
    _BYTE_TO_INDEX[ord(_c.lower())] = _i

_INDEX_TO_BYTE = np.frombuffer(AA20.encode(), dtype=np.uint8).copy()


def encode(seq: str | bytes) -> np.ndarray:
    """String -> uint8 index array (INVALID for non-AA20 letters)."""
    if isinstance(seq, str):
        seq = seq.encode()
    return _BYTE_TO_INDEX[np.frombuffer(seq, dtype=np.uint8)]


def decode(idx: np.ndarray) -> str:
    """Index array -> string ('X' for INVALID)."""
    idx = np.asarray(idx)
    out = np.full(idx.shape, ord("X"), dtype=np.uint8)
    ok = idx < 20
    out[ok] = _INDEX_TO_BYTE[idx[ok]]
    return out.tobytes().decode()


def randomize_unknown_at(idx: np.ndarray, seed: int,
                         offset: int = 0) -> np.ndarray:
    """Position-keyed INVALID replacement (splitmix64 of seed + position):
    each replacement depends only on (seed, absolute position)."""
    idx = np.asarray(idx)
    bad = np.nonzero(idx == INVALID)[0]
    if bad.size == 0:
        return idx
    idx = idx.copy()
    with np.errstate(over="ignore"):
        z = (bad.astype(np.uint64) + np.uint64(offset)
             + np.uint64(seed) * np.uint64(0xD1B54A32D192ED03)
             + np.uint64(0x9E3779B97F4A7C15))
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        z = z ^ (z >> np.uint64(31))
    idx[bad] = ((z >> np.uint64(8)) % np.uint64(20)).astype(np.uint8)
    return idx
