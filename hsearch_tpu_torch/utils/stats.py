"""Bucket and block statistics of an index (own copy of
hsearch_tpu/utils/stats.py, on numpy copies of the index's tensors).

The reference hides bucket-size histograms behind ``#ifdef BUCKETSIZE``
recompiles (pcluster.cpp:38-66); here they are a function call, and
``index-build`` prints them.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class BucketStats:
    num_buckets: int
    num_items: int
    mean: float
    p50: float
    p90: float
    p99: float
    max: int
    histogram: dict   # size -> count of buckets of that size


def bucket_stats(codes: np.ndarray) -> BucketStats:
    """Per-table or flattened bucket-size statistics from hash codes."""
    codes = np.asarray(codes).reshape(-1)
    _, counts = np.unique(codes, return_counts=True)
    hist: dict[int, int] = {}
    for c in counts:
        hist[int(c)] = hist.get(int(c), 0) + 1
    return BucketStats(
        num_buckets=len(counts), num_items=int(counts.sum()),
        mean=float(counts.mean()), p50=float(np.percentile(counts, 50)),
        p90=float(np.percentile(counts, 90)),
        p99=float(np.percentile(counts, 99)), max=int(counts.max()),
        histogram=dict(sorted(hist.items())))


def index_stats(index) -> dict:
    """Summary stats for a MotifIndex (per-table buckets), an IVFIndex
    (block radii, padding) or a SegmentedIVF (segments, host bytes,
    resident fraction)."""
    from ..search import ivf, motif, stream
    if isinstance(index, motif.MotifIndex):
        sc = index.tables.sorted_codes.cpu().numpy()
        per_table = [bucket_stats(sc[t]) for t in range(sc.shape[0])]
        return {"kind": "motif", "num_tables": sc.shape[0],
                "cand_max": index.cand_max,
                "tables": [dataclasses.asdict(s) for s in per_table]}
    if isinstance(index, ivf.IVFIndex):
        rad = index.block_radius.cpu().numpy()
        order = index.order.cpu().numpy()
        pad = float((order >= index.n_points).mean())
        return {"kind": "ivf", "num_blocks": index.num_blocks,
                "block_size": index.block_size,
                "padding_fraction": pad,
                "radius": {"mean": float(rad.mean()),
                           "p50": float(np.percentile(rad, 50)),
                           "p90": float(np.percentile(rad, 90)),
                           "max": float(rad.max())}}
    if isinstance(index, stream.SegmentedIVF):
        return {"kind": "segivf", "n_points": index.n_points,
                "num_segments": index.num_segments,
                "block_size": index.block_size,
                "host_bytes": sum(s.nbytes for s in index.segments),
                "resident_fraction": index.resident_fraction()}
    raise TypeError(type(index))
