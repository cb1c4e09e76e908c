"""Amino-acid alphabet and integer encodings (own copy of the parts of
hsearch_tpu/core/alphabet.py that the search and clustering tools need).

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


def decode_all(idx: np.ndarray) -> np.ndarray:
    """(N, L) index matrix -> (N,) array of strings, vectorized."""
    idx = np.ascontiguousarray(idx)
    l = idx.shape[1]
    out = np.full(idx.shape, ord("X"), dtype=np.uint8)
    ok = idx < 20
    out[ok] = _INDEX_TO_BYTE[idx[ok]]
    return out.view(f"S{l}").ravel().astype(str)


def kmer_view(idx: np.ndarray, k: int, stride: int = 1) -> np.ndarray:
    """All length-k windows of a 1-D index array as an (n, k) strided view."""
    idx = np.ascontiguousarray(idx)
    n = idx.shape[0] - k + 1
    if n <= 0:
        return np.empty((0, k), dtype=idx.dtype)
    view = np.lib.stride_tricks.sliding_window_view(idx, k)
    return view[::stride]


def randomize_unknown(idx: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Replace INVALID entries with uniform-random AA indices drawn from a
    seeded numpy rng (the reference's read-time replacement,
    protein.hpp:59-63, made reproducible)."""
    idx = np.asarray(idx)
    bad = idx == INVALID
    n_bad = int(bad.sum())
    if n_bad:
        idx = idx.copy()
        idx[bad] = rng.integers(0, 20, size=n_bad, dtype=np.uint8)
    return idx


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


# 8-group alphabet of the pcluster pre-clustering 3-mer histogram
# ([A S T][R K E D Q][N H][C][G][I V L M][F Y W][P], util.hpp:101-105).
# Canonical order:  A  R  N  D  C  Q  E  G  H  I  L  K  M  F  P  S  T  W  Y  V
HIST8 = np.array([0, 1, 2, 1, 3, 1, 1, 4, 2, 5, 5, 1, 5, 6, 7, 0, 0, 6, 6, 5],
                 dtype=np.int8)
HIST8_SIZE = 8
HASHLEN = 3  # 3-mers -> 8**3 = 512 features (pcluster util.hpp:92)


def reduced_kmer_ids(idx: np.ndarray, k: int = HASHLEN,
                     alphabet: np.ndarray = HIST8,
                     base: int = HIST8_SIZE) -> np.ndarray:
    """All k-mer feature ids of a protein under a reduced alphabet:
    sum_i group(aa_i) * base**i (``Kmer2Integer``, pcluster
    util.hpp:244-250, little-endian digit order)."""
    groups = alphabet[np.asarray(idx)]
    wins = kmer_view(groups, k)
    weights = base ** np.arange(k)
    return wins.astype(np.int64) @ weights
