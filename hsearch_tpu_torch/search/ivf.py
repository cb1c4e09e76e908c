"""Block-pruned exact search on the GPU (counterpart of
hsearch_tpu/search/ivf.py).

  build:  sample cell centers from the data, assign every embedded k-mer
          point to its nearest center with a blocked GEMM and argmin, sort
          the database by cell, cut cell-aligned blocks of ``block_size``
          points and record each block's centroid and covering radius.
  query:  per center block, the ``sq_distance_prune`` kernel computes the
          distance to every block centroid and keeps a block only if
          d(q, centroid) <= R + block_radius (triangle inequality); the
          min-cascade picks the k_blocks nearest survivors, their k-mers are
          gathered and verified by the ``ptable_verify`` kernel, and the
          hits are compacted into one packed buffer (ops/compact).

Two operating points, as in the JAX package: ``retry_overflow=False`` with
a recall-measured k_blocks (``autotune_k_blocks``), whose correctness rests
on measured weighted recall; and ``retry_overflow=True``, the exactness
contract, where centers whose surviving blocks overflow k_blocks re-run with
a 4x cap until none overflow.

Random draws come from an explicit CPU ``torch.Generator``: the centroid
sample is drawn on the CPU and moved to the device, so one seed builds the
same index on the CPU and on the card.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch
import torch.nn.functional as F

from .. import _device
from ..core import embedding
from ..ops import compact, cuda_kernels, distance
from .motif import _center_ptables


@dataclasses.dataclass
class IVFIndex:
    """Block-sorted database with per-block bounding balls."""

    db_sorted: torch.Tensor       # (B, bs*L) int8, cell-sorted + padded
    order: torch.Tensor           # (B, bs) int32 original ids, sentinel N
    block_centroid: torch.Tensor  # (B, D) f32 embedded block centroids
    block_radius: torch.Tensor    # (B,) f32 covering radius per block
    n_points: int
    # host-side (N, L) int8 k-mer copy: lets search() ship hits as ONE
    # int32 word each and recompute d2 on the host; None -> the 2-word
    # layout (and an explicit transfer_d2=False raises)
    host_kmers: np.ndarray | None = None
    kmer_len: int = 0

    @property
    def num_blocks(self) -> int:
        return self.db_sorted.shape[0]

    @property
    def block_size(self) -> int:
        return self.db_sorted.shape[1] // self.kmer_len

    @property
    def device(self) -> torch.device:
        return self.db_sorted.device


def _check_kmers(kmers: np.ndarray, what: str) -> None:
    """Reject k-mer entries outside the 20 amino-acid indices: the verify
    kernel indexes its shared-memory P-table with them unchecked."""
    if kmers.size and (kmers.min() < 0 or kmers.max() >= 20):
        raise ValueError(f"{what} must hold amino-acid indices in [0, 20); "
                         f"got values in [{kmers.min()}, {kmers.max()}]")


def _sample_centroids(km: torch.Tensor, generator: torch.Generator,
                      n_cells: int) -> torch.Tensor:
    """Uniformly sampled cell centroids, embedded: (n_cells, 8L) f32.

    Without replacement (``randperm``) unless there are fewer points than
    cells; drawn on the CPU generator and moved to ``km``'s device.
    """
    n, l = km.shape
    if n < n_cells:
        idx = torch.randint(0, n, (n_cells,), generator=generator)
    else:
        idx = torch.randperm(n, generator=generator)[:n_cells]
    coords = distance.const("coords", km.device)
    return coords[km[idx.to(km.device)].long()].reshape(
        n_cells, l * coords.shape[1])


# rows per assignment call.  The JAX package split here for a TPU
# watchdog; the split is result-invariant (per-row argmin) and bounds the
# working set, so the port keeps it
_ASSIGN_SUPER = 1 << 21


def _assign_cells_kmers(km: torch.Tensor, generator: torch.Generator,
                        n_cells: int, block: int = 8192,
                        cell_chunk: int | None = None) -> torch.Tensor:
    """Sample-assign cells directly from integer k-mers: sample centroids
    once, then assign row superblocks of <= _ASSIGN_SUPER rows.  The (N, 8L)
    float embedding never materializes; each row block is embedded on the
    fly."""
    centroids = _sample_centroids(km, generator, n_cells)
    return torch.cat([_assign_rows(km[s:s + _ASSIGN_SUPER], centroids,
                                   n_cells, block, cell_chunk)
                      for s in range(0, km.shape[0], _ASSIGN_SUPER)])


def _assign_rows(km: torch.Tensor, centroids: torch.Tensor, n_cells: int,
                 block: int = 8192,
                 cell_chunk: int | None = None) -> torch.Tensor:
    """One assignment superblock: nearest sampled centroid per row (first
    minimum on ties).

    cell_chunk: when set (and smaller than n_cells), the (block, n_cells)
    distance matrix is also chunked along the cell axis with a running
    argmin; a strict < keeps the earliest chunk on ties, matching the
    global argmin's first-minimum semantics.
    """
    n, l = km.shape
    coords = distance.const("coords", km.device)
    d = l * coords.shape[1]
    out = []
    for s in range(0, n, block):
        pts = coords[km[s:s + block].long()].reshape(-1, d)
        if cell_chunk is None or n_cells <= cell_chunk:
            out.append(torch.argmin(
                distance.sq_distance_matrix(pts, centroids), dim=1))
            continue
        bd = torch.full((pts.shape[0],), float("inf"), device=km.device)
        bi = torch.zeros(pts.shape[0], dtype=torch.int64, device=km.device)
        for c0 in range(0, n_cells, cell_chunk):
            d2 = distance.sq_distance_matrix(
                pts, centroids[c0:c0 + cell_chunk])
            j = torch.argmin(d2, dim=1)
            dmin = torch.gather(d2, 1, j[:, None])[:, 0]
            upd = dmin < bd
            bd = torch.where(upd, dmin, bd)
            bi = torch.where(upd, j + c0, bi)
        out.append(bi)
    if not out:
        return torch.zeros(0, dtype=torch.int32, device=km.device)
    return torch.cat(out).to(torch.int32)


def _cell_aligned_groups(cells: np.ndarray, n_cells: int,
                         group: int, sentinel: int) -> np.ndarray:
    """Cut cell-aligned fixed-size groups (host, vectorized).

    Sort item ids by cell, pad each cell's run to a ``group`` multiple
    with ``sentinel``: returns (n_groups, group) item ids where no group
    spans two cells."""
    n = len(cells)
    order = np.argsort(cells, kind="stable").astype(np.int32)
    sorted_cells = cells[order]
    counts = np.bincount(sorted_cells, minlength=n_cells)
    padded = -(-counts // group) * group          # per-cell capacity
    pad_base = np.concatenate([[0], np.cumsum(padded)])
    cell_base = np.concatenate([[0], np.cumsum(counts)])
    rank = np.arange(n) - cell_base[sorted_cells]
    flat = np.full(int(pad_base[-1]), sentinel, np.int32)
    flat[pad_base[sorted_cells] + rank] = order
    return flat.reshape(-1, group)


def _stage2(km8: torch.Tensor, order_blocks: torch.Tensor, n: int,
            block_size: int, bchunk: int = 4096):
    """Gather the block-sorted database and bound each block, in chunks of
    ``bchunk`` blocks so the (chunk, bs, 8L) embedding stays small.

    Returns (db_sorted (B, bs*L) int8, centroid (B, 8L) f32, radius (B,)).
    """
    l = km8.shape[1]
    coords = distance.const("coords", km8.device)
    km_pad = torch.cat([km8, km8.new_zeros((1, l))])
    db_out, cent_out, rad_out = [], [], []
    for s in range(0, order_blocks.shape[0], bchunk):
        ob_c = order_blocks[s:s + bchunk]
        db_c = km_pad[ob_c.long()]                       # (m, bs, l) int8
        emb = coords[db_c.long()].reshape(ob_c.shape[0], block_size,
                                          l * coords.shape[1])
        valid = (ob_c < n)[:, :, None]
        cnt = torch.clamp_min(valid.sum(dim=1), 1)
        cent = torch.sum(emb * valid, dim=1) / cnt
        d2 = torch.sum((emb - cent[:, None, :]) ** 2, dim=-1)
        d2 = torch.where(valid[..., 0], d2, torch.zeros_like(d2))
        db_out.append(db_c.reshape(-1, block_size * l))
        cent_out.append(cent)
        rad_out.append(torch.sqrt(torch.amax(d2, dim=1)))
    return torch.cat(db_out), torch.cat(cent_out), torch.cat(rad_out)


def build_index(db_kmers: np.ndarray, generator: torch.Generator,
                block_size: int = 32, n_cells: int | None = None,
                kmeans_iters: int = 0,
                device: str | torch.device = "cuda") -> IVFIndex:
    """Sample-assign cells, sort, cut cell-aligned blocks, bound each.

    Cell centers are sampled uniformly from the data (n_cells defaults to
    N/block_size); one blocked assignment GEMM gives cell ids.  Blocks
    never span cells, so a dense natural cluster yields tight blocks.
    ``generator`` is a CPU ``torch.Generator`` (the seed of the build).
    """
    if kmeans_iters:
        raise NotImplementedError(
            "Lloyd refinement (kmeans_iters > 0) is not ported yet "
            "(ROADMAP A.3a)")
    dev = _device.resolve(device)
    n, l = db_kmers.shape
    _check_kmers(db_kmers, "db_kmers")
    host_km = np.asarray(db_kmers, np.int8)
    km = torch.as_tensor(host_km, device=dev)
    if n_cells is None:
        n_cells = max(1, n // block_size)
    # past 2^18 cells the (block, n_cells) assignment matrix is chunked
    # along cells (the JAX package's rule, kept unchanged)
    cc = 16384 if n_cells > (1 << 18) else None
    cells = _assign_cells_kmers(km, generator, n_cells,
                                cell_chunk=cc).cpu().numpy()
    order_blocks = torch.as_tensor(
        _cell_aligned_groups(cells, n_cells, block_size, n), device=dev)
    db_sorted, cent, rad = _stage2(km, order_blocks, n, block_size)
    return IVFIndex(db_sorted=db_sorted, order=order_blocks,
                    block_centroid=cent, block_radius=rad, n_points=n,
                    host_kmers=host_km, kmer_len=l)


def _cascade_top_blocks(key: torch.Tensor, kb: int, group: int):
    """EXACT nearest-kb block select in O(B/group) select work.

    Stage 1 reduces the (C, B) keys to per-group minima over ``group``
    consecutive blocks and top-k's the kb smallest groups; stage 2 top-k's
    the kb smallest blocks inside the selected groups.  If a true top-kb
    block sat in an unselected group, each of the kb selected groups would
    hold a distinct block at least as close — so the result is the same
    block set as the flat top-k (tie order may differ).
    """
    c, b = key.shape
    pad = (-b) % group
    kp = F.pad(key, (0, pad), value=float("inf"))
    ng = kp.shape[1] // group
    kg = kp.reshape(c, ng, group)
    gmin = torch.amin(kg, dim=2)                               # (C, B/G)
    ks = min(kb, ng)
    _, gsel = torch.topk(-gmin, ks, dim=1)                     # (C, ks)
    gkeys = torch.gather(kg, 1, gsel[:, :, None].expand(c, ks, group)) \
        .reshape(c, ks * group)
    neg, sel = torch.topk(-gkeys, min(kb, ks * group), dim=1)
    blk = gsel[:, :, None] * group + torch.arange(group, device=key.device)
    blk_ids = torch.gather(blk.reshape(c, ks * group), 1, sel)
    return neg, blk_ids


# blocks per stage-1 select group of the cascade
_SELECT_GROUP = 64


def _search_block(index: IVFIndex, centers: torch.Tensor,
                  centers_emb: torch.Tensor, r: np.float32, k_blocks: int,
                  max_hits: int, cap_frac: int = 4, with_d2: bool = True):
    """One center block: prune blocks, gather survivors, exact verify.

    Returns (packed flat int32 buffer — ops/compact layout with
    meta = [n_hits (C), n_alive (C)]; ids (C, max_hits) sentinel-N and
    d2 (C, max_hits) as the lossless overflow fallback).  Every step is
    queued on the device without a host synchronisation.
    """
    n = index.n_points
    bs = index.block_size
    l = index.kmer_len
    c = centers.shape[0]
    key = cuda_kernels.sq_distance_prune(
        centers_emb, index.block_centroid, index.block_radius, float(r))
    n_alive = torch.sum(torch.isfinite(key), dim=1).to(torch.int32)
    kb = min(k_blocks, key.shape[1])
    if key.shape[1] >= 4 * _SELECT_GROUP:
        neg, blk_ids = _cascade_top_blocks(key, kb, _SELECT_GROUP)
    else:
        neg, blk_ids = torch.topk(-key, kb, dim=1)           # (C, kb)
    blk_alive = torch.isfinite(neg)
    safe_ids = torch.where(blk_alive, blk_ids, torch.zeros_like(blk_ids))
    cand = index.db_sorted[safe_ids].reshape(c, -1, l)       # (C, kb*bs, L)
    gids = index.order[safe_ids].reshape(c, -1)
    gids = torch.where(torch.repeat_interleave(blk_alive, bs, dim=1), gids,
                       torch.full_like(gids, n))
    ptab = _center_ptables(centers, l)
    d2 = cuda_kernels.ptable_verify(ptab, cand)              # (C, kb*bs)
    # r is float32 and squared in float32, as the JAX package does
    hits = (gids < n) & (d2 <= float(r * r))
    n_hits = torch.sum(hits, dim=1).to(torch.int32)
    d2m = torch.where(hits, d2, torch.full_like(d2, float("inf")))
    negd, sel = torch.topk(-d2m, min(max_hits, d2m.shape[1]), dim=1)
    out_ids = torch.where(torch.isfinite(negd), torch.gather(gids, 1, sel),
                          torch.full_like(sel, n, dtype=gids.dtype))
    out_d2 = -negd
    packed = compact.pack_hits(out_ids, out_d2, n,
                               meta_vecs=(n_hits, n_alive),
                               cap_frac=cap_frac, with_d2=with_d2)
    return packed, out_ids, out_d2


def autotune_k_blocks(index: IVFIndex, sample_centers: np.ndarray,
                      radius: float, target_recall: float = 0.99,
                      candidates: tuple = (32, 64, 128, 192, 256, 384),
                      max_hits: int = 512) -> int:
    """Smallest k_blocks reaching ``target_recall`` (weighted recall against
    the exact oracle) on a query sample; the largest candidate if none
    does."""
    from . import evaluate, exact

    gci, gki, gd = exact.search_radius(_index_kmers(index), sample_centers,
                                       radius, max_hits=max_hits,
                                       device=index.device)
    for kb in sorted(candidates):
        ci, ki, _ = search(index, sample_centers, radius,
                           k_blocks=min(kb, index.num_blocks),
                           max_hits=max_hits, retry_overflow=False)
        rep = evaluate.recall_from_indices(gci, gki, gd, ci, ki, radius)
        if rep.recall >= target_recall:
            return min(kb, index.num_blocks)
    return min(max(candidates), index.num_blocks)


def unsort_blocks(order, db_sorted, n: int, l: int,
                  dtype=np.int32) -> np.ndarray:
    """Invert the cell-sorted block layout: scatter rows back to their
    original ids (padding rows carry the sentinel id ``n`` and drop)."""
    order = np.asarray(order).reshape(-1)
    db = np.asarray(db_sorted).reshape(-1, l)
    out = np.zeros((n, l), dtype)
    real = order < n
    out[order[real]] = db[real]
    return out


def _index_kmers(index: IVFIndex) -> np.ndarray:
    """Recover the original (N, L) k-mer array from the block layout."""
    if index.host_kmers is not None:
        return index.host_kmers.astype(np.int32)
    return unsort_blocks(index.order.cpu().numpy(),
                         index.db_sorted.cpu().numpy(),
                         index.n_points, index.kmer_len)


def search(index: IVFIndex, centers: np.ndarray, radius: float,
           k_blocks: int = 64, max_hits: int = 256,
           center_block: int = 256, retry_overflow: bool = True,
           stats_out: dict | None = None, pack_cap_frac: int = 4,
           approx_select: bool | None = None,
           transfer_d2: bool | None = None):
    """All (center, kmer) pairs within ``radius`` — exact, block-pruned.

    Runs on the index's device.  Returns (center_idx, kmer_idx, dist) host
    arrays, the contract of search.exact.search_radius.

    With ``retry_overflow`` (the default) centers whose surviving blocks
    exceed ``k_blocks`` (or whose hits exceed ``max_hits``) re-run with a
    4x block cap (2x hit cap) and a 4x smaller center block until none
    overflow: the result is then exact.  With ``retry_overflow=False``
    the caller gates on measured recall; ``stats_out`` receives
    ``over_blocks``/``over_hits``/``max_alive`` (else a warning reports
    overflows).

    ``pack_cap_frac`` divides the packed buffer's capacity
    (C*max_hits // cap_frac); a block whose hits overflow it is
    re-dispatched with a capacity that fits.  ``transfer_d2=False`` (the
    default with integer centers and an index holding host k-mers) ships
    one word per hit and recomputes d2 on the host.

    ``approx_select`` is accepted for the JAX package's signature; the
    block select is always exact here (the approximate select exists only
    on a TPU backend there).
    """
    dev = index.device
    c_total = centers.shape[0]
    centers = np.asarray(centers)
    is_kmers = np.issubdtype(centers.dtype, np.integer)
    if is_kmers:
        _check_kmers(centers, "centers")
    cemb_all = embedding.embed_kmers(centers) if is_kmers \
        else centers.astype(np.float32)
    n = index.n_points
    host_km = index.host_kmers
    if transfer_d2 is None:
        transfer_d2 = not (is_kmers and host_km is not None)
    elif not transfer_d2 and (not is_kmers or host_km is None):
        raise ValueError(
            "transfer_d2=False needs integer k-mer centers and an index "
            "with host_kmers (build_index sets it; checkpoint round-trips "
            f"it) — got is_kmers={is_kmers}, host_kmers="
            f"{'present' if host_km is not None else 'absent'}")
    kb_used = min(k_blocks, index.num_blocks)
    r = np.float32(radius)
    cdtype = np.int32 if is_kmers else np.float32
    # pad to whole center blocks and upload once: a host->device copy
    # inside the dispatch loop would wait for the blocks already queued
    pad_total = (-c_total) % center_block
    cpad = np.pad(centers.astype(cdtype),
                  ((0, pad_total),) + ((0, 0),) * (centers.ndim - 1))
    epad = np.pad(cemb_all, ((0, pad_total), (0, 0)))
    cdev = torch.as_tensor(cpad, device=dev)
    edev = torch.as_tensor(epad, device=dev)
    ci, ki, dd = [], [], []
    redo: list[np.ndarray] = []      # center ids that lost the guarantee
    over_blocks = over_hits = 0
    # two passes: queue every center block first, then harvest — block
    # i's device->host copy overlaps the device work of the later blocks
    pending = []
    for s in range(0, c_total, center_block):
        real = min(center_block, c_total - s)
        pending.append((s, real, _search_block(
            index, cdev[s:s + center_block], edev[s:s + center_block], r,
            k_blocks, max_hits, pack_cap_frac, transfer_d2)))
    max_alive = 0
    for s, real, (packed, ids, d2) in pending:
        packed_np = packed.cpu().numpy()
        hits, (n_hits, n_alive) = compact.unpack_hits(
            packed_np, (center_block, center_block))
        if hits is None and pack_cap_frac > 1:
            # packed-capacity escalation: re-dispatch the SAME block with
            # the buffer sized to the now-known total (cap_frac=1 holds
            # every possible hit) instead of pulling the full buffers
            total = int(packed_np[2])
            k_sel = min(max_hits, kb_used * index.block_size)
            cap = pack_cap_frac
            while cap > 1 and (center_block * k_sel) // cap < total:
                cap //= 4
            cap = max(cap, 1)
            packed, ids, d2 = _search_block(
                index, cdev[s:s + center_block], edev[s:s + center_block],
                r, k_blocks, max_hits, cap, transfer_d2)
            hits, (n_hits, n_alive) = compact.unpack_hits(
                packed.cpu().numpy(), (center_block, center_block))
        bad = ((n_alive[:real] > kb_used)
               | (n_hits[:real] > max_hits))
        over_blocks += int((n_alive[:real] > kb_used).sum())
        over_hits += int((n_hits[:real] > max_hits).sum())
        if real:
            max_alive = max(max_alive, int(n_alive[:real].max()))
        if retry_overflow:
            redo.append(np.nonzero(bad)[0] + s)
        if hits is not None:
            hc0, hk0, hd0 = hits
            keep = hc0 < real                  # drop padding-center rows
            hc = hc0[keep].astype(np.int64)
            hk = hk0[keep].astype(np.int64)
            if hd0 is None:
                # 1-word layout: d2 recomputed from the host k-mers
                # (sum_l DSQ[q_l, p_l] — the exact verify metric)
                hd = embedding.DISTANCE_SQUARE[centers[hc + s],
                                               host_km[hk]].sum(
                    axis=1, dtype=np.float64).astype(np.float32)
            else:
                hd = hd0[keep]
        else:
            # packed capacity overflowed: the full buffers transfer now
            idsh = ids.cpu().numpy().copy()
            d2h = d2.cpu().numpy()
            idsh[real:, :] = n
            hc, hm = np.nonzero(idsh < n)
            hk = idsh[hc, hm].astype(np.int64)
            hd = d2h[hc, hm]
        ci.append(hc + s)
        ki.append(hk)
        dd.append(np.sqrt(np.maximum(hd, 0.0)))
    if not ci:
        return (np.empty(0, np.int64), np.empty(0, np.int64),
                np.empty(0, np.float32))
    out_c = np.concatenate(ci)
    out_k = np.concatenate(ki)
    out_d = np.concatenate(dd).astype(np.float32)
    redo_ids = np.concatenate(redo) if redo else np.empty(0, np.int64)
    can_grow = kb_used < index.num_blocks or over_hits
    if retry_overflow and redo_ids.size and can_grow:
        # lossless overflow retry: re-search ONLY the overflowed centers
        # with a 4x block cap and a center block 4x smaller, so the
        # (cb, kb*bs, L) candidate gather stays within the main pass's
        # memory; kb is bounded by the block count, so this terminates
        kb2 = min(4 * kb_used, index.num_blocks)
        cb2 = max(1, (center_block * kb_used) // kb2)
        keep = ~np.isin(out_c, redo_ids)
        sub_stats: dict = {}
        rc, rk, rd = search(
            index, centers[redo_ids], radius, k_blocks=kb2,
            max_hits=2 * max_hits if over_hits else max_hits,
            center_block=cb2, retry_overflow=True,
            stats_out=sub_stats, pack_cap_frac=pack_cap_frac,
            approx_select=approx_select, transfer_d2=transfer_d2)
        out_c = np.concatenate([out_c[keep], redo_ids[rc]])
        out_k = np.concatenate([out_k[keep], rk])
        out_d = np.concatenate([out_d[keep], rd]).astype(np.float32)
        if stats_out is not None:
            stats_out.update(
                max_alive=max(max_alive, sub_stats.get("max_alive", 0)),
                retried=int(redo_ids.size) + sub_stats.get("retried", 0),
                retry_depth=1 + sub_stats.get("retry_depth", 0),
                over_blocks=sub_stats.get("over_blocks", 0),
                over_hits=sub_stats.get("over_hits", 0))
        return out_c, out_k, out_d
    elif (over_blocks or over_hits) and stats_out is None:
        if over_blocks:
            warnings.warn(
                f"{over_blocks} centers had more than k_blocks="
                f"{kb_used} surviving blocks; raise k_blocks for "
                "guaranteed-exact results")
        if over_hits:
            warnings.warn(
                f"{over_hits} centers exceeded max_hits={max_hits}; "
                "nearest hits kept")
    if stats_out is not None:
        stats_out.setdefault("max_alive", max_alive)
        stats_out.setdefault("retried", 0)
        stats_out.setdefault("retry_depth", 0)
        stats_out["over_blocks"] = over_blocks
        stats_out["over_hits"] = over_hits
    return out_c, out_k, out_d
