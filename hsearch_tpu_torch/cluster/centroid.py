"""Centroid-merging hierarchical clustering, hclust v1 (counterpart of
hsearch_tpu/cluster/centroid.py).

Reference semantics (hclust.cpp:186-310): clusters start as singletons;
each round hashes the cluster centroids with a fresh LSH table; within a
bucket, a cluster stays intact if (distance of its centroid to the bucket
centroid) + (its own radius) > R/2, otherwise all such "close" clusters
merge into one, whose centroid and radius (largest member distance to the
centroid) are recomputed (ClustingBucket, hclust.cpp:186-235).

On the device, cluster ids are fixed slots 0..N-1; a cluster's state is
its member-point sum, member count and radius.  Per round: one projection
GEMM over the centroids (chunked over slots), bucket grouping by a stable
argsort of the packed codes, and segment sums, maxima and minima as
``index_add_`` / ``scatter_reduce``.  Merged clusters take the smallest
merged id of their bucket, the same merge set as the reference's "collect
all close clusters into one".  Only the final (N,) labels reach the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import _device
from ..core import embedding
from ..ops import distance, segment


@dataclasses.dataclass(frozen=True)
class CentroidConfig:
    hash_k: int = 16
    hash_l: int = 32
    w: float = 50.0
    radius: float = 200.0


def _segment_sum(x: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    out = torch.zeros((n,) + x.shape[1:], dtype=x.dtype, device=x.device)
    return out.index_add_(0, seg, x)


def _segment_reduce(x: torch.Tensor, seg: torch.Tensor, n: int, fill,
                    reduce: str) -> torch.Tensor:
    out = torch.full((n,), fill, dtype=x.dtype, device=x.device)
    return out.scatter_reduce_(0, seg, x, reduce=reduce, include_self=True)


def _cluster_rounds(km: torch.Tensor, a_all: torch.Tensor,
                    b_all: torch.Tensor, w: float, half_r: float,
                    n_rounds: int, pack_bits: int = 7,
                    chunk: int = 8192) -> torch.Tensor:
    """Run every clustering round on km's device; returns (N,) labels.

    a_all (rounds, D, K), b_all (rounds, K).  Row chunks of ``chunk``
    bound the (rows, D) temporaries; every row's arithmetic is the same
    whatever the chunk.
    """
    dev = km.device
    n, l = km.shape
    coords = distance.const("coords", dev)
    d = l * coords.shape[1]
    imax = torch.iinfo(torch.int32).max
    w = float(np.float32(w))
    half_r = float(np.float32(half_r))
    kml = km.long()
    chunks = [(s, min(s + chunk, n)) for s in range(0, n, chunk)]

    def embed(lo, hi):
        return coords[kml[lo:hi]].reshape(hi - lo, d)

    def centroids(sums, counts, lo, hi):
        # divide before the dot, as the JAX package: (sums @ a) / c
        # reassociates and can move a boundary code
        return sums[lo:hi] / torch.clamp_min(counts[lo:hi], 1.0)[:, None]

    def radii_of(label, sums, counts):
        """sqrt(largest member distance^2 to its cluster centroid)."""
        acc = torch.full((n,), float("-inf"), device=dev)
        for lo, hi in chunks:
            lab = label[lo:hi]
            cent = sums[lab] / torch.clamp_min(counts[lab], 1.0)[:, None]
            diff = embed(lo, hi) - cent
            d2 = torch.sum(diff * diff, dim=-1)
            acc = torch.maximum(acc, _segment_reduce(
                d2, lab, n, float("-inf"), "amax"))
        return torch.sqrt(torch.clamp_min(acc, 0.0))

    label = torch.arange(n, dtype=torch.int64, device=dev)
    sums = torch.cat([embed(lo, hi) for lo, hi in chunks]) if n else \
        torch.zeros((0, d), device=dev)
    counts = torch.ones(n, dtype=torch.float32, device=dev)
    radii = torch.zeros(n, dtype=torch.float32, device=dev)
    ids = torch.arange(n, dtype=torch.int64, device=dev)
    for rnd in range(n_rounds):
        a_r, b_r = a_all[rnd], b_all[rnd]                   # (D, K), (K,)
        alive = counts > 0
        proj = torch.cat([centroids(sums, counts, lo, hi) @ a_r
                          for lo, hi in chunks]) + b_r[None, :]
        code = segment.pack_codes(torch.floor(proj / w).to(torch.int32),
                                  pack_bits)
        code = torch.where(alive, code, imax)
        # bucket grouping: stable sort, segment boundaries, scatter back
        order = torch.sort(code, stable=True).indices
        sc = code[order]
        newb = torch.ones(n, dtype=torch.bool, device=dev)
        newb[1:] = sc[1:] != sc[:-1]
        bucket = torch.empty(n, dtype=torch.int64, device=dev)
        bucket[order] = torch.cumsum(newb.long(), 0) - 1
        # weighted bucket centroid over the underlying points
        # (hclust.cpp:190): cents * counts == sums
        bc = _segment_sum(sums, bucket, n) \
            / torch.clamp_min(_segment_sum(counts, bucket, n), 1.0)[:, None]
        dist = torch.cat([torch.sqrt(torch.sum(
            (centroids(sums, counts, lo, hi) - bc[bucket[lo:hi]]) ** 2,
            dim=-1)) for lo, hi in chunks])
        keep = (dist + radii > half_r) | ~alive              # hclust.cpp:205
        # merged clusters adopt the smallest merged id in their bucket
        rep = _segment_reduce(torch.where(keep, n, ids), bucket, n, n,
                              "amin")
        newid = torch.where(keep, ids, rep[bucket])
        label = newid[label]
        sums = _segment_sum(sums, newid, n)
        counts = _segment_sum(counts, newid, n)
        radii = radii_of(label, sums, counts)
    return label


def cluster_centroid(kmers: np.ndarray, generator: torch.Generator | None,
                     config: CentroidConfig = CentroidConfig(),
                     a_all: np.ndarray | None = None,
                     b_all: np.ndarray | None = None,
                     device: str | torch.device = "cuda"):
    """Returns a list of member-id arrays (final clusters), ordered by
    their smallest member.

    The hash_l rounds' projections (a_all (hash_l, D, K)) and offsets
    (b_all (hash_l, K)) are drawn from ``generator`` (a CPU
    torch.Generator) unless given.
    """
    dev = _device.resolve(device)
    n, l = kmers.shape
    d = l * embedding.AA_DIM
    if a_all is None:
        a_all = torch.randn((config.hash_l, d, config.hash_k),
                            generator=generator, dtype=torch.float32)
    if b_all is None:
        b_all = torch.rand((config.hash_l, config.hash_k),
                           generator=generator, dtype=torch.float32) \
            * np.float32(config.w)
    label = _cluster_rounds(
        torch.as_tensor(np.asarray(kmers), device=dev),
        torch.as_tensor(np.array(a_all, np.float32), device=dev),
        torch.as_tensor(np.array(b_all, np.float32), device=dev),
        config.w, config.radius / 2.0, config.hash_l,
        chunk=min(8192, max(256, n))).cpu().numpy()
    order = np.argsort(label, kind="stable")
    sl = label[order]
    cuts = np.nonzero(sl[1:] != sl[:-1])[0] + 1
    return [g.astype(np.int64) for g in np.split(order, cuts)]
