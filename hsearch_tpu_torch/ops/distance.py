"""Distance and score matrices as float32 matrix products.

Counterpart of hsearch_tpu/ops/distance.py.  Every pairwise form is one
large product:

  * real points:   ||a-b||^2 = ||a||^2 + ||b||^2 - 2 a.b      (one GEMM)
  * index k-mers:  d2(q, p) = sum_l DSQ[q_l, p_l]
                  = onehot(q) (C, 20L)  @  DSQ-gathered(20L, N)  (one GEMM)
  * BLOSUM score:  the same contraction against BLOSUM62.

The products run in full float32: the package's device policy
(``_device.set_precision``) turns TF32 off, because TF32 rounding flips
the ``d2 <= R^2`` test near the radius.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .. import _device
from ..core import blosum, embedding


_CONSTANTS = {"dsq": embedding.DISTANCE_SQUARE,
              "coords": embedding.COORDINATES,
              "blosum62": blosum.BLOSUM62}


@functools.lru_cache(maxsize=None)
def const(name: str, device: torch.device) -> torch.Tensor:
    """A float32 constant table ("dsq", "coords", "blosum62") on ``device``.

    Cached per device: a fresh host->device copy inside the search loop
    would synchronise the stream and serialise dispatch with compute.
    Callers must not modify the returned tensor.
    """
    return torch.as_tensor(_CONSTANTS[name], dtype=torch.float32,
                           device=device)


def sq_distance_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(C, D), (N, D) -> (C, N) squared Euclidean distances."""
    a2 = torch.sum(a * a, dim=-1, keepdim=True)          # (C, 1)
    b2 = torch.sum(b * b, dim=-1)                        # (N,)
    ab = a @ b.T
    return torch.clamp_min(a2 + b2[None, :] - 2.0 * ab, 0.0)


def _expand_table(kmers: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """(N, L) indices -> (N, L*A): out[n, l*A + a] = table[a, kmers[n, l]]."""
    g = table.T[kmers.long()]                            # (N, L, A)
    n, l, a = g.shape
    return g.reshape(n, l * a)


def _onehot_flat(kmers: torch.Tensor, num_classes: int = 20) -> torch.Tensor:
    n, l = kmers.shape
    return F.one_hot(kmers.long(), num_classes).to(torch.float32) \
        .reshape(n, l * num_classes)


def kmer_sq_distance_matrix(q: torch.Tensor, db: torch.Tensor,
                            dsq: torch.Tensor | None = None) -> torch.Tensor:
    """(C, L), (N, L) int k-mers -> (C, N) exact squared embedding distances
    (one-hot contraction against the DISTANCE_SQUARE table)."""
    if dsq is None:
        dsq = const("dsq", db.device)
    return _onehot_flat(q) @ _expand_table(db, dsq).T


def kmer_sq_distance_matrix_fast(q: torch.Tensor,
                                 db: torch.Tensor) -> torch.Tensor:
    """(C, L), (N, L) int k-mers -> (C, N) squared embedding distances by
    the norm identity on embedded points: an 8L-wide GEMM instead of the
    20L-wide one-hot contraction (absolute error ~1e-3 on d2 from float32
    cancellation; fine for search, not for bit-exact oracles)."""
    coords = const("coords", db.device)
    c2 = torch.sum(coords * coords, dim=-1)                  # (20,)
    n, l = db.shape
    d = coords.shape[1]
    qi, di = q.long(), db.long()
    qe = coords[qi].reshape(-1, l * d)
    de = coords[di].reshape(n, l * d)
    cross = qe @ de.T
    q2 = torch.sum(c2[qi], dim=-1)
    p2 = torch.sum(c2[di], dim=-1)
    return torch.clamp_min(q2[:, None] + p2[None, :] - 2.0 * cross, 0.0)


def kmer_blosum_score_matrix(q: torch.Tensor,
                             db: torch.Tensor) -> torch.Tensor:
    """(C, L), (N, L) -> (C, N) ungapped BLOSUM62 scores (one GEMM)."""
    b62 = const("blosum62", db.device)
    return _onehot_flat(q) @ _expand_table(db, b62).T


def point_vs_kmer_sq_distance(points: torch.Tensor,
                              db: torch.Tensor) -> torch.Tensor:
    """(C, 8L) real points vs (N, L) int k-mers -> (C, N) squared distances.

    d2(x, p) = ||x||^2 + sum_l ||c[p_l]||^2 - 2 sum_l x_l . c[p_l]
    """
    coords = const("coords", db.device)        # (20, 8)
    c2 = torch.sum(coords * coords, dim=-1)
    n, l = db.shape
    di = db.long()
    x = points.to(torch.float32)
    g = coords[di].reshape(n, l * coords.shape[1])           # (N, 8L)
    cross = x @ g.T
    x2 = torch.sum(x * x, dim=-1)
    p2 = torch.sum(c2[di], dim=-1)
    return torch.clamp_min(x2[:, None] + p2[None, :] - 2.0 * cross, 0.0)


def ptable_distances(ptab: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """P-table candidate distances: (C, L, 20) tables x (C, M, L) k-mers.

    d2[c, m] = sum_l ptab[c, l, cand[c, m, l]], summed in order l = 0..L-1
    as L (C, M) gathers.  This is the plain version of the ptable_verify
    kernel (ops/cuda_kernels.py), which keeps the same summation order.
    """
    c, m, l = cand.shape
    d2 = torch.zeros((c, m), dtype=torch.float32, device=cand.device)
    for pos in range(l):
        idx = cand[:, :, pos].long()
        d2 = d2 + torch.gather(ptab[:, pos, :], 1, idx)
    return d2


def ptable_distances_mxu(ptab: torch.Tensor, cand: torch.Tensor,
                         chunk: int = 512) -> torch.Tensor:
    """One-hot form of ``ptable_distances``: the candidates are one-hot
    expanded per chunk and contracted against the flattened tables.  The
    one-hot operand is exact, so the product is a float32 sum of the same
    table entries up to addition order."""
    c, m, l = cand.shape
    pt = ptab.reshape(c, l * 20)
    out = []
    for s in range(0, m, chunk):
        oh = _onehot_flat(cand[:, s:s + chunk].reshape(-1, l)) \
            .reshape(c, -1, l * 20)
        out.append(torch.einsum("cma,ca->cm", oh, pt))
    return torch.cat(out, dim=1)


def blocked_kmer_sq_distance(q: np.ndarray, db: np.ndarray,
                             block: int = 65536,
                             device: str | torch.device = "cuda"
                             ) -> np.ndarray:
    """Host-streaming exact (C, N) distance for large N: database blocks
    go through the GEMM one at a time; returns a host (C, N) float32 array.
    """
    dev = _device.resolve(device)
    qt = torch.as_tensor(np.asarray(q), device=dev)
    out = [kmer_sq_distance_matrix(
               qt, torch.as_tensor(np.asarray(db[s:s + block]), device=dev))
           .cpu().numpy() for s in range(0, db.shape[0], block)]
    if not out:
        return np.zeros((q.shape[0], 0), np.float32)
    return np.concatenate(out, axis=1)
