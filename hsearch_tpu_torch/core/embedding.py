"""The BLOSUM62-metric Euclidean embedding of amino acids / k-mers.

Own copy of hsearch_tpu/core/embedding.py (same float64 constants): each
amino acid is a point in R^8, a length-L k-mer the concatenation of its
residue coordinates, and the squared distance between two k-mers
decomposes per position as ``sum_l DISTANCE_SQUARE[a_l, b_l]``.

Rows are in the canonical order ARNDCQEGHILKMFPSTWYV; the 20x8 table is
the d=8 MDS output of the reference (IGC/distance2coordinate/BLOSUM.m,
recorded at hclust/src/hclust/util.hpp:21-42).
"""

from __future__ import annotations

import numpy as np

#: Per-AA coordinate dimension.
AA_DIM = 8

#: 20x8 MDS embedding of the BLOSUM62 metric.
COORDINATES = np.array([
    [-0.876280,  3.598596,  2.554616, -0.729216,  0.698828,  1.221507, -2.765205, -3.163091],  # A
    [-4.111404, -1.936791, -2.682295,  0.942498,  6.924314, -1.195785, -1.639269,  0.615381],  # R
    [-7.471612, -2.468058,  0.932738, -4.488355,  0.553080, -3.081577,  0.368010,  4.223792],  # N
    [-8.317871, -0.848602,  1.752372, -1.407818, -4.874022, -1.493568,  5.256411, -2.561758],  # D
    [ 5.421664, 11.791877,  2.675596, -5.622478,  4.322457,  3.946839,  2.229597, -1.901479],  # C
    [-3.771796, -2.525005, -1.567736,  2.619391,  2.781873,  0.952486,  3.947072, -0.954304],  # Q
    [-6.585010, -2.752755, -1.649014,  1.605597, -1.833933, -0.730211,  2.313328, -3.239486],  # E
    [-3.978253, -1.155062,  9.994796, -0.195264, -1.110059, -2.860194, -4.952672, -1.495210],  # G
    [-2.630176, -8.283034, -4.773107, -6.479084,  0.070359,  4.318067, -1.847373, -0.086451],  # H
    [ 4.548022,  5.189698, -3.999001, -0.186966, -3.275059, -1.882387, -0.627095,  0.049364],  # I
    [ 5.341899,  4.436639, -3.552811,  1.250614,  0.266899, -2.609335, -0.694939,  0.812004],  # L
    [-5.742562, -1.207887, -2.587323,  2.866228,  4.169821, -1.991698, -1.941954, -0.747156],  # K
    [ 4.241223,  2.474317, -2.658336,  2.946054,  2.011534, -3.254331,  1.266004, -0.186966],  # M
    [ 9.340442, -3.359172, -0.635377, -2.878570, -3.255191, -2.200202, -1.104637, -0.062654],  # F
    [-6.150933,  3.182318,  0.122393,  7.788554, -3.094076,  6.831600, -1.992627,  1.807240],  # P
    [-2.523437,  1.824168,  3.256463, -2.386830,  0.439791,  1.024198,  0.486894,  1.190316],  # S
    [-0.823028,  3.115233,  2.075337, -0.585875, -1.471153,  0.518398,  1.846290,  6.269577],  # T
    [13.592409, -8.961858,  6.548108,  4.623650,  2.128797,  0.808588,  2.631353,  0.521535],  # W
    [ 7.173223, -6.765800, -2.811202, -1.654989, -1.878135,  3.104673, -1.272146, -0.635970],  # Y
    [ 3.323480,  4.651177, -2.996218,  1.972858, -3.576126, -1.427066, -1.507041, -0.454682],  # V
], dtype=np.float64)


def _pairwise_sq(c: np.ndarray) -> np.ndarray:
    d = c[:, None, :] - c[None, :, :]
    return (d * d).sum(-1)


#: 20x20 squared Euclidean distances between AA coordinates.
DISTANCE_SQUARE = _pairwise_sq(COORDINATES)


def embed_kmers(kmers: np.ndarray, coords: np.ndarray = COORDINATES,
                dtype=np.float32) -> np.ndarray:
    """(N, L) AA-index array -> (N, 8L) embedded points (host-side)."""
    kmers = np.asarray(kmers)
    n, l = kmers.shape
    return coords[kmers].reshape(n, l * coords.shape[1]).astype(dtype)


def kmer_sq_distance(a: np.ndarray, b: np.ndarray,
                     dsq: np.ndarray = DISTANCE_SQUARE) -> np.ndarray:
    """Exact squared embedding distance between index k-mers (broadcast).

    a: (..., L), b: (..., L) -> (...,), by the per-position decomposition.
    """
    return dsq[a, b].sum(axis=-1)
