"""Brute-force exact search: the oracle every accelerated path is tested
against (counterpart of hsearch_tpu/search/exact.py).

All centers x all k-mers exact squared embedding distances as one float32
GEMM per center block, hits <= R.  With ``max_hits`` the hits are
compacted on the device (nearest max_hits per center) and shipped as one
packed buffer (ops/compact); past ``db_chunk`` database rows the distance
matrix is streamed one database chunk at a time with a running top-k.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from .. import _device
from ..ops import compact, distance


def _center_blocks(centers: np.ndarray, block: int):
    for s in range(0, centers.shape[0], block):
        yield s, centers[s:s + block]


def _as_centers(blk: np.ndarray, is_kmers: bool, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(blk, np.int32 if is_kmers
                                      else np.float32), device=dev)


def _dist_block(centers, db, is_kmers: bool, fast: bool = False):
    if is_kmers:
        if fast:
            return distance.kmer_sq_distance_matrix_fast(centers, db)
        return distance.kmer_sq_distance_matrix(centers, db)
    return distance.point_vs_kmer_sq_distance(centers, db)


def _radius_block_compact(centers, db, r2: float, is_kmers: bool,
                          max_hits: int, fast: bool = False):
    """Distance block + on-device hit compaction (top max_hits by distance).

    Returns (packed buffer, ids (C, k) with sentinel N, d2 (C, k)).
    """
    d2 = _dist_block(centers, db, is_kmers, fast)
    n = d2.shape[1]
    hits = d2 <= r2
    n_hits = torch.sum(hits, dim=1).to(torch.int32)
    d2m = torch.where(hits, d2, torch.full_like(d2, float("inf")))
    neg, sel = torch.topk(-d2m, min(max_hits, n), dim=1)
    ids = torch.where(torch.isfinite(neg), sel, torch.full_like(sel, n))
    packed = compact.pack_hits(ids, -neg, n, meta_vecs=(n_hits,))
    return packed, ids, -neg


def _radius_scan_compact(centers, db_blocks, n_true: int, r2: float,
                         is_kmers: bool, max_hits: int, fast: bool = False):
    """Streamed variant of _radius_block_compact for large databases.

    db_blocks: (NB, CHUNK, L) — the distance matrix exists only one chunk
    at a time; a running (C, max_hits) nearest-hit set merges per chunk.
    """
    c = centers.shape[0]
    nb, chunk, _ = db_blocks.shape
    n_pad = nb * chunk
    dev = db_blocks.device
    best_d2 = torch.full((c, max_hits), float("inf"), device=dev)
    best_ids = torch.full((c, max_hits), n_pad, dtype=torch.int64,
                          device=dev)
    n_hits = torch.zeros(c, dtype=torch.int32, device=dev)
    for b in range(nb):
        d2 = _dist_block(centers, db_blocks[b], is_kmers, fast)
        ids = b * chunk + torch.arange(chunk, device=dev)
        hits = (ids < n_true)[None, :] & (d2 <= r2)
        n_hits = n_hits + torch.sum(hits, dim=1).to(torch.int32)
        d2m = torch.where(hits, d2, torch.full_like(d2, float("inf")))
        cat_d = torch.cat([best_d2, d2m], dim=1)
        cat_i = torch.cat([best_ids, ids.expand(c, chunk)], dim=1)
        neg, sel = torch.topk(-cat_d, max_hits, dim=1)
        best_d2 = -neg
        best_ids = torch.gather(cat_i, 1, sel)
    ids = torch.where(torch.isfinite(best_d2), best_ids,
                      torch.full_like(best_ids, n_pad))
    packed = compact.pack_hits(ids, best_d2, n_true, meta_vecs=(n_hits,),
                               id_bound=n_pad)
    return packed, ids, best_d2


def search_radius(db_kmers: np.ndarray, centers: np.ndarray, radius: float,
                  center_block: int = 256, max_hits: int | None = None,
                  fast: bool = False, db_chunk: int = 1 << 18,
                  device: str | torch.device = "cuda"):
    """All (center, kmer) pairs with embedding distance <= radius.

    db_kmers: (N, L) int; centers: (C, L) int k-mers or (C, 8L) real points.
    Returns (center_idx, kmer_idx, dist) int64/int64/float32 host arrays,
    sorted by (center, kmer) on the dense path.

    With ``max_hits`` set, hits are compacted on the device (nearest
    max_hits per center) and only the packed buffer is transferred; a
    warning reports centers whose true hit count exceeded the cap.
    The radius is squared in double and then rounded to float32, as the
    JAX package does.
    """
    dev = _device.resolve(device)
    db = torch.as_tensor(np.asarray(db_kmers), device=dev)
    n = db_kmers.shape[0]
    is_kmers = centers.ndim == 2 and centers.shape[1] == db_kmers.shape[1] \
        and np.issubdtype(centers.dtype, np.integer)
    r2 = float(np.float32(radius * radius))
    db_blocks = None
    if max_hits is not None and n > db_chunk:
        pad_n = (-n) % db_chunk
        db_blocks = torch.cat([db, db.new_zeros((pad_n, db.shape[1]))]) \
            .reshape(-1, db_chunk, db.shape[1])
    ci, ki, dd = [], [], []
    truncated = 0
    for s, blk in _center_blocks(centers, center_block):
        cb = _as_centers(blk, is_kmers, dev)
        if max_hits is None:
            d2 = _dist_block(cb, db, is_kmers, fast)
            hit = torch.nonzero(d2 <= r2)
            hit_c, hit_k = hit[:, 0], hit[:, 1]
            ci.append(hit_c.cpu().numpy() + s)
            ki.append(hit_k.cpu().numpy())
            dd.append(torch.sqrt(d2[hit_c, hit_k]).cpu().numpy())
            continue
        if db_blocks is not None:
            packed, ids, d2 = _radius_scan_compact(
                cb, db_blocks, n, r2, is_kmers, max_hits, fast)
        else:
            packed, ids, d2 = _radius_block_compact(
                cb, db, r2, is_kmers, max_hits, fast)
        hits, (n_hits,) = compact.unpack_hits(packed.cpu().numpy(),
                                              (blk.shape[0],))
        truncated += int((n_hits > max_hits).sum())
        if hits is not None:
            hc, hk, hd = hits
        else:
            # packed capacity overflowed: the full buffers transfer now
            hc, hk, hd, _ = compact.full_hits(ids, d2, n)
        ci.append(hc.astype(np.int64) + s)
        ki.append(hk.astype(np.int64))
        dd.append(np.sqrt(np.maximum(hd, 0.0)))
    if truncated:
        warnings.warn(f"{truncated} centers exceeded max_hits={max_hits}; "
                      "nearest hits kept")
    if not ci:
        return (np.empty(0, np.int64), np.empty(0, np.int64),
                np.empty(0, np.float32))
    return (np.concatenate(ci).astype(np.int64),
            np.concatenate(ki).astype(np.int64),
            np.concatenate(dd).astype(np.float32))


def search_topk(db_kmers: np.ndarray, centers: np.ndarray, k: int,
                center_block: int = 256,
                device: str | torch.device = "cuda"):
    """k nearest database k-mers per center by exact embedding distance.

    Returns (dists (C, k) f32, ids (C, k) int32).
    """
    dev = _device.resolve(device)
    db = torch.as_tensor(np.asarray(db_kmers), device=dev)
    k = min(k, db_kmers.shape[0])
    is_kmers = np.issubdtype(centers.dtype, np.integer)
    out_d, out_i = [], []
    for _, blk in _center_blocks(centers, center_block):
        d2 = _dist_block(_as_centers(blk, is_kmers, dev), db, is_kmers)
        vals, idx = torch.topk(-d2, k, dim=1)
        out_d.append(np.sqrt(torch.abs(vals).cpu().numpy()))
        out_i.append(idx.to(torch.int32).cpu().numpy())
    return np.concatenate(out_d), np.concatenate(out_i)


def search_topk_blosum(db_kmers: np.ndarray, queries: np.ndarray, k: int,
                       center_block: int = 256,
                       device: str | torch.device = "cuda"):
    """k best database k-mers per query by ungapped BLOSUM62 score.

    Returns (scores (C, k) f32, ids (C, k) int32).
    """
    dev = _device.resolve(device)
    db = torch.as_tensor(np.asarray(db_kmers), device=dev)
    k = min(k, db_kmers.shape[0])
    out_s, out_i = [], []
    for _, blk in _center_blocks(queries, center_block):
        s = distance.kmer_blosum_score_matrix(
            _as_centers(blk, True, dev), db)
        vals, idx = torch.topk(s, k, dim=1)
        out_s.append(vals.cpu().numpy())
        out_i.append(idx.to(torch.int32).cpu().numpy())
    return np.concatenate(out_s), np.concatenate(out_i)
