"""BLOSUM-Metric validation: k-best peptide enumeration and agreement
(counterpart of hsearch_tpu/metric.py).

The reference's BLOSUM-Metric subproject enumerates the k best peptides of
a query through a layered DAG with per-node priority queues
(k_nearest_neighbor_similarity.cpp:5-128, k_nearest_neighbor_distance.cpp)
to check that similarity ranking and metric-distance ranking agree
(evaluate.cpp:60-121), plus a similarity-vs-distance correlation dump
(evaluate_correlation.cpp:43-69, whose ``s2[i]-'B'`` indexing bug, :29,38,
is not reproduced).

The objective is separable across positions, so an exact top-k beam works:
keep the k best partial peptides, extend each by all 20 residues, keep the
k best again.  The JAX package runs the beam as one ``lax.scan``; here it
is a host loop over positions on the device, each step one stable
descending sort of the (k*20,) candidates, so that ties keep the lower
flat index first, as ``lax.top_k`` does (``torch.topk`` makes no such
promise).  Exactness: scores are sums of independent per-position terms,
so every prefix of a full-length top-k member is a top-k prefix.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _device
from .core import blosum, embedding

# the initial score of the k-1 empty beam slots: below every real score,
# and still finite after adding a table entry in float32
_NEG = -3e38


def k_best_peptides(query, k: int, mode: str = "similarity",
                    device: str | torch.device = "cuda"):
    """The k peptides of len(query) ranking best against ``query``.

    mode='similarity': maximize sum BLOSUM62[q_l, x_l]
    mode='distance':   minimize sum metric-squared-distance (embedding
                       DISTANCE_SQUARE, the Euclidean side of the check)
    mode='metric':     minimize sum BLOSUM_DISTANCE[q_l, x_l]

    Returns (scores (k,) f32, peptides (k, L) int32) on ``device``, best
    first.
    """
    if mode == "similarity":
        table, sign = blosum.BLOSUM62, 1.0
    elif mode == "distance":
        table, sign = embedding.DISTANCE_SQUARE, -1.0
    elif mode == "metric":
        table, sign = blosum.BLOSUM_DISTANCE, -1.0
    else:
        raise ValueError(mode)
    dev = _device.resolve(device)
    q = torch.as_tensor(np.asarray(query, np.int64), device=dev)
    l = q.shape[0]
    tab = torch.as_tensor(np.asarray(table, np.float32), device=dev)
    per_pos = sign * tab[q]                                  # (L, 20)
    scores = torch.full((k,), _NEG, dtype=torch.float32, device=dev)
    scores[0] = 0.0
    seqs = torch.zeros((k, l), dtype=torch.int32, device=dev)
    for pos in range(l):
        flat = (scores[:, None] + per_pos[pos][None, :]).reshape(-1)
        top = torch.sort(flat, descending=True, stable=True)
        scores, idx = top.values[:k], top.indices[:k]
        seqs = seqs[torch.div(idx, 20, rounding_mode="floor")]
        seqs[:, pos] = (idx % 20).to(torch.int32)
    return sign * scores, seqs


def topk_agreement(rng: np.random.Generator, length: int, k: int,
                   n_queries: int = 100,
                   device: str | torch.device = "cuda") -> float:
    """Mean overlap fraction between similarity-top-k and distance-top-k
    candidate sets over random queries (evaluate.cpp:60-95)."""
    total = 0.0
    for _ in range(n_queries):
        q = rng.integers(0, 20, length).astype(np.int32)
        _, sim = k_best_peptides(q, k, "similarity", device)
        _, dis = k_best_peptides(q, k, "distance", device)
        a = {tuple(r) for r in sim.cpu().numpy().tolist()}
        b = {tuple(r) for r in dis.cpu().numpy().tolist()}
        total += len(a & b) / k
    return total / n_queries


def correlation_samples(rng: np.random.Generator, length: int,
                        n_pairs: int = 10000):
    """(similarity scores, metric distances) for random peptide pairs
    (evaluate_correlation.cpp:43-69, indexing bug fixed)."""
    a = rng.integers(0, 20, (n_pairs, length))
    b = rng.integers(0, 20, (n_pairs, length))
    sim = blosum.BLOSUM62[a, b].sum(axis=1)
    dis = np.sqrt(embedding.DISTANCE_SQUARE[a, b].sum(axis=1))
    return sim.astype(np.float64), dis.astype(np.float64)
