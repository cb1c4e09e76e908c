"""BLOSUM62 and the similarity -> metric-distance transform (own copy of
hsearch_tpu/core/blosum.py's table and helpers).

d(i,j) = B(i,i) + B(j,j) - 2*B(i,j) satisfies the triangle inequality over
the 20 amino acids, so it embeds into Euclidean space (reference:
BLOSUM-Metric/src/BLOSUM-metric/distance_matrix.hpp:13-51).  Rows/columns
in the canonical order ARNDCQEGHILKMFPSTWYV (NCBI standard table;
reference pcluster/src/pcluster/weight.hpp:22-45).
"""

from __future__ import annotations

import numpy as np

BLOSUM62 = np.array([
    #A   R   N   D   C   Q   E   G   H   I   L   K   M   F   P   S   T   W   Y   V
    [ 4, -1, -2, -2,  0, -1, -1,  0, -2, -1, -1, -1, -1, -2, -1,  1,  0, -3, -2,  0],  # A
    [-1,  5,  0, -2, -3,  1,  0, -2,  0, -3, -2,  2, -1, -3, -2, -1, -1, -3, -2, -3],  # R
    [-2,  0,  6,  1, -3,  0,  0,  0,  1, -3, -3,  0, -2, -3, -2,  1,  0, -4, -2, -3],  # N
    [-2, -2,  1,  6, -3,  0,  2, -1, -1, -3, -4, -1, -3, -3, -1,  0, -1, -4, -3, -3],  # D
    [ 0, -3, -3, -3,  9, -3, -4, -3, -3, -1, -1, -3, -1, -2, -3, -1, -1, -2, -2, -1],  # C
    [-1,  1,  0,  0, -3,  5,  2, -2,  0, -3, -2,  1,  0, -3, -1,  0, -1, -2, -1, -2],  # Q
    [-1,  0,  0,  2, -4,  2,  5, -2,  0, -3, -3,  1, -2, -3, -1,  0, -1, -3, -2, -2],  # E
    [ 0, -2,  0, -1, -3, -2, -2,  6, -2, -4, -4, -2, -3, -3, -2,  0, -2, -2, -3, -3],  # G
    [-2,  0,  1, -1, -3,  0,  0, -2,  8, -3, -3, -1, -2, -1, -2, -1, -2, -2,  2, -3],  # H
    [-1, -3, -3, -3, -1, -3, -3, -4, -3,  4,  2, -3,  1,  0, -3, -2, -1, -3, -1,  3],  # I
    [-1, -2, -3, -4, -1, -2, -3, -4, -3,  2,  4, -2,  2,  0, -3, -2, -1, -2, -1,  1],  # L
    [-1,  2,  0, -1, -3,  1,  1, -2, -1, -3, -2,  5, -1, -3, -1,  0, -1, -3, -2, -2],  # K
    [-1, -1, -2, -3, -1,  0, -2, -3, -2,  1,  2, -1,  5,  0, -2, -1, -1, -1, -1,  1],  # M
    [-2, -3, -3, -3, -2, -3, -3, -3, -1,  0,  0, -3,  0,  6, -4, -2, -2,  1,  3, -1],  # F
    [-1, -2, -2, -1, -3, -1, -1, -2, -2, -3, -3, -1, -2, -4,  7, -1, -1, -4, -3, -2],  # P
    [ 1, -1,  1,  0, -1,  0,  0,  0, -1, -2, -2,  0, -1, -2, -1,  4,  1, -3, -2, -2],  # S
    [ 0, -1,  0, -1, -1, -1, -1, -2, -2, -1, -1, -1, -1, -2, -1,  1,  5, -2, -2,  0],  # T
    [-3, -3, -4, -4, -2, -2, -3, -2, -2, -3, -2, -3, -1,  1, -4, -3, -2, 11,  2, -3],  # W
    [-2, -2, -2, -3, -2, -1, -2, -3,  2, -1, -1, -2, -1,  3, -3, -2, -2,  2,  7, -1],  # Y
    [ 0, -3, -3, -3, -1, -2, -2, -3, -3,  3,  1, -2,  1, -1, -2, -2,  0, -3, -1,  4],  # V
], dtype=np.int32)


def similarity_to_distance(B: np.ndarray = BLOSUM62) -> np.ndarray:
    """d(i,j) = B(i,i) + B(j,j) - 2 B(i,j) (distance_matrix.hpp:18)."""
    diag = np.diag(B)
    return diag[:, None] + diag[None, :] - 2 * B


def triangle_inequality_violations(D: np.ndarray) -> int:
    """Count of (i,j,k) triples with D[i,j] + D[j,k] < D[i,k] (the
    all-triples check of distance_matrix.hpp:36-50)."""
    s = D[:, :, None] + D[None, :, :]       # s[i,j,k] = D[i,j] + D[j,k]
    return int((s < D[:, None, :]).sum())


#: The metric distance matrix used everywhere downstream
#: (equals BLOSUM.m:3-22's hard-coded D).
BLOSUM_DISTANCE = similarity_to_distance(BLOSUM62)


def score_kmers(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Ungapped BLOSUM62 score of equal-length index k-mers (broadcast).

    a: (..., L), b: (..., L) -> (...,) summed substitution score.
    """
    return BLOSUM62[a, b].sum(axis=-1)
