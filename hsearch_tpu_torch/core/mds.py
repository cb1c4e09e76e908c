"""Multidimensional scaling: the AA embedding regenerated from first
principles (own copy of hsearch_tpu/core/mds.py, numpy only).

The reference ran MATLAB's ``mdscale`` (metric stress MDS) offline on the
BLOSUM62-derived distance matrix for d = 1..50 and picked d = 8
(IGC/distance2coordinate/BLOSUM.m:24-33):

  * ``classical_mds`` — eigendecomposition of the double-centered squared
    distance matrix (cmdscale),
  * ``smacof`` — iterative stress majorization (mdscale),
  * ``mds_sweep`` — the per-dimension L1/L2 reconstruction errors
    (BLOSUM.m:24-30, error functions BLOSUM.m:36-52).
"""

from __future__ import annotations

import numpy as np


def classical_mds(D: np.ndarray, dim: int) -> np.ndarray:
    """Classical (Torgerson) MDS of a distance matrix into R^dim."""
    D = np.asarray(D, dtype=np.float64)
    n = D.shape[0]
    J = np.eye(n) - np.ones((n, n)) / n
    B = -0.5 * J @ (D * D) @ J
    w, v = np.linalg.eigh(B)
    order = np.argsort(w)[::-1][:dim]
    w = np.clip(w[order], 0.0, None)
    return v[:, order] * np.sqrt(w)[None, :]


def _pairwise(X: np.ndarray) -> np.ndarray:
    d = X[:, None, :] - X[None, :, :]
    return np.sqrt((d * d).sum(-1))


def smacof(D: np.ndarray, dim: int, n_iter: int = 500,
           tol: float = 1e-9, init: np.ndarray | None = None) -> np.ndarray:
    """Metric-stress MDS by SMACOF majorization (mdscale equivalent)."""
    D = np.asarray(D, dtype=np.float64)
    n = D.shape[0]
    X = classical_mds(D, dim) if init is None else np.asarray(init, float)
    prev = np.inf
    for _ in range(n_iter):
        pd = _pairwise(X)
        stress = ((D - pd) ** 2).sum()
        if prev - stress < tol * max(prev, 1.0):
            break
        prev = stress
        with np.errstate(divide="ignore", invalid="ignore"):
            ratio = np.where(pd > 0, D / pd, 0.0)
        Bmat = -ratio
        Bmat[np.arange(n), np.arange(n)] = ratio.sum(1)
        X = Bmat @ X / n
    return X


def l1_error(D: np.ndarray, X: np.ndarray) -> float:
    """Sum |D_ij - ||x_i - x_j||| over all pairs (BLOSUM.m:45-52)."""
    return float(np.abs(D - _pairwise(X)).sum())


def l2_error(D: np.ndarray, X: np.ndarray) -> float:
    """Sum (D_ij - ||x_i - x_j||)^2 over all pairs (BLOSUM.m:36-43)."""
    return float(((D - _pairwise(X)) ** 2).sum())


def mds_sweep(D: np.ndarray, dims: range = range(1, 51)) -> list[dict]:
    """Per-dimension reconstruction errors, as in BLOSUM.m:24-30."""
    out = []
    for d in dims:
        X = smacof(D, d)
        out.append({"dim": d, "l1": l1_error(D, X), "l2": l2_error(D, X)})
    return out
