"""Published statistics of protein sequence that the database is drawn
from (frozen copies, rows and columns in the order ARNDCQEGHILKMFPSTWYV).

- ``BACKGROUND``: amino-acid frequencies of Robinson & Robinson 1991
  (PNAS 88:8880, doi:10.1073/pnas.88.20.8880), the background NCBI BLAST
  uses, per thousand residues.
- ``BLOSUM62``: Henikoff & Henikoff 1992 (PNAS 89:10915,
  doi:10.1073/pnas.89.22.10915), in half-bit units.
- ``substitution()``: where a residue ``a`` is replaced, the probability
  of each other residue ``b``, from the target frequencies that BLOSUM62
  implies over this background, q_ab = p_a p_b 2^(s_ab / 2) (Altschul 1991,
  J Mol Biol 219:555): P(b | a, b != a) proportional to p_b 2^(s_ab / 2).
"""

from __future__ import annotations

import numpy as np

BACKGROUND = np.array([
    # A     R      N      D      C      Q      E      G      H      I
    78.05, 51.29, 44.87, 53.64, 19.25, 42.64, 62.95, 73.77, 21.99, 51.42,
    # L     K      M      F      P      S      T      W      Y      V
    90.19, 57.44, 22.43, 38.56, 52.03, 71.20, 58.41, 13.30, 32.16, 64.41,
], dtype=np.float64) / 1000.0

BLOSUM62 = np.array([
    [4, -1, -2, -2, 0, -1, -1, 0, -2, -1, -1, -1, -1, -2, -1, 1, 0, -3, -2, 0],
    [-1, 5, 0, -2, -3, 1, 0, -2, 0, -3, -2, 2, -1, -3, -2, -1, -1, -3, -2, -3],
    [-2, 0, 6, 1, -3, 0, 0, 0, 1, -3, -3, 0, -2, -3, -2, 1, 0, -4, -2, -3],
    [-2, -2, 1, 6, -3, 0, 2, -1, -1, -3, -4, -1, -3, -3, -1, 0, -1, -4, -3,
     -3],
    [0, -3, -3, -3, 9, -3, -4, -3, -3, -1, -1, -3, -1, -2, -3, -1, -1, -2, -2,
     -1],
    [-1, 1, 0, 0, -3, 5, 2, -2, 0, -3, -2, 1, 0, -3, -1, 0, -1, -2, -1, -2],
    [-1, 0, 0, 2, -4, 2, 5, -2, 0, -3, -3, 1, -2, -3, -1, 0, -1, -3, -2, -2],
    [0, -2, 0, -1, -3, -2, -2, 6, -2, -4, -4, -2, -3, -3, -2, 0, -2, -2, -3,
     -3],
    [-2, 0, 1, -1, -3, 0, 0, -2, 8, -3, -3, -1, -2, -1, -2, -1, -2, -2, 2, -3],
    [-1, -3, -3, -3, -1, -3, -3, -4, -3, 4, 2, -3, 1, 0, -3, -2, -1, -3, -1, 3],
    [-1, -2, -3, -4, -1, -2, -3, -4, -3, 2, 4, -2, 2, 0, -3, -2, -1, -2, -1, 1],
    [-1, 2, 0, -1, -3, 1, 1, -2, -1, -3, -2, 5, -1, -3, -1, 0, -1, -3, -2, -2],
    [-1, -1, -2, -3, -1, 0, -2, -3, -2, 1, 2, -1, 5, 0, -2, -1, -1, -1, -1, 1],
    [-2, -3, -3, -3, -2, -3, -3, -3, -1, 0, 0, -3, 0, 6, -4, -2, -2, 1, 3, -1],
    [-1, -2, -2, -1, -3, -1, -1, -2, -2, -3, -3, -1, -2, -4, 7, -1, -1, -4, -3,
     -2],
    [1, -1, 1, 0, -1, 0, 0, 0, -1, -2, -2, 0, -1, -2, -1, 4, 1, -3, -2, -2],
    [0, -1, 0, -1, -1, -1, -1, -2, -2, -1, -1, -1, -1, -2, -1, 1, 5, -2, -2, 0],
    [-3, -3, -4, -4, -2, -2, -3, -2, -2, -3, -2, -3, -1, 1, -4, -3, -2, 11, 2,
     -3],
    [-2, -2, -2, -3, -2, -1, -2, -3, 2, -1, -1, -2, -1, 3, -3, -2, -2, 2, 7,
     -1],
    [0, -3, -3, -3, -1, -2, -2, -3, -3, 3, 1, -2, 1, -1, -2, -2, 0, -3, -1, 4],
], dtype=np.float64)


def background() -> np.ndarray:
    """(20,) residue probabilities, summing to 1."""
    return BACKGROUND / BACKGROUND.sum()


def substitution() -> np.ndarray:
    """(20, 20): row ``a`` is the distribution of the residue that replaces
    ``a``; the diagonal is 0 and every row sums to 1."""
    w = background()[None, :] * np.exp2(BLOSUM62 / 2.0)
    np.fill_diagonal(w, 0.0)
    return w / w.sum(axis=1, keepdims=True)
