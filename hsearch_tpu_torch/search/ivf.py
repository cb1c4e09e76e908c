"""Block-pruned exact search on the GPU (counterpart of
hsearch_tpu/search/ivf.py).

  build:  sample cell centers from the data, assign every embedded k-mer
          point to its nearest center with a blocked GEMM and argmin, sort
          the database by cell (optionally after Lloyd iterations), cut
          cell-aligned blocks of ``block_size`` points and record each
          block's centroid and covering radius.
  query:  per center block, the ``sq_distance_prune`` kernel computes the
          distance to every block centroid and keeps a block only if
          d(q, centroid) <= R + block_radius (triangle inequality); the
          min-cascade picks the k_blocks nearest survivors from the
          kernel's keys and group minima, the ``ptable_verify`` kernel
          reads their k-mers from the block-sorted database and verifies
          them exactly, and the hits are compacted into one packed buffer
          (ops/compact).

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

from .. import _device
from ..core import embedding
from ..ops import compact, cuda_kernels, distance
from .motif import _center_ptables, _check_kmers


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


def _sample_ids(n: int, n_cells: int,
                generator: torch.Generator) -> torch.Tensor:
    """Uniformly sampled row ids of the cell centroids, drawn on the CPU
    generator: without replacement (``randperm``) unless there are fewer
    points than cells."""
    if n < n_cells:
        return torch.randint(0, n, (n_cells,), generator=generator)
    return torch.randperm(n, generator=generator)[:n_cells]


def _sample_centroids(km: torch.Tensor, generator: torch.Generator,
                      n_cells: int) -> torch.Tensor:
    """Uniformly sampled cell centroids, embedded: (n_cells, 8L) f32,
    moved to ``km``'s device."""
    n, l = km.shape
    idx = _sample_ids(n, n_cells, generator)
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


def _block_bounds(db_c: torch.Tensor, valid: torch.Tensor,
                  coords: torch.Tensor):
    """(m, bs, L) int8 rows and their (m, bs) validity -> each block's
    embedded centroid (m, 8L) f32 and covering radius (m,).

    Per position, the centroid is the residue counts (exact integers)
    times the coordinate table over the row count, and a row's squared
    distance to it is a sum of L entries of a (m, L, 20) table of each
    residue's squared distance to the centroid's position: no (m, bs, 8L)
    embedding is made.  The one formula for both the build (``_stage2``)
    and the segmented engine's bounds pass after an upload
    (search/stream.py), so a streamed segment is bounded bitwise like a
    resident one.
    """
    m, bs, l = db_c.shape
    a = db_c.long().transpose(1, 2)                          # (m, L, bs)
    w = valid[:, None, :].expand(m, l, bs).to(coords.dtype)
    counts = torch.zeros((m, l, coords.shape[0]), dtype=coords.dtype,
                         device=coords.device).scatter_add_(2, a, w)
    cnt = torch.clamp_min(valid.sum(dim=1), 1).to(coords.dtype)
    cent = (counts @ coords) / cnt[:, None, None]            # (m, L, 8)
    diff = coords[None, None] - cent[:, :, None, :]          # (m, L, 20, 8)
    tab = torch.sum(diff * diff, dim=-1)                     # (m, L, 20)
    d2 = torch.gather(tab, 2, a).sum(dim=1)                  # (m, bs)
    d2 = torch.where(valid, d2, torch.zeros_like(d2))
    return cent.reshape(m, -1), torch.sqrt(torch.amax(d2, dim=1))


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
        cent, rad = _block_bounds(db_c, ob_c < n, coords)
        db_out.append(db_c.reshape(-1, block_size * l))
        cent_out.append(cent)
        rad_out.append(rad)
    return torch.cat(db_out), torch.cat(cent_out), torch.cat(rad_out)


def _assign_points(points: torch.Tensor, centroids: torch.Tensor,
                   block: int = 8192) -> torch.Tensor:
    """Nearest centroid of each (N, D) point in full float32, in blocks of
    ``block`` rows; the first minimum on ties.  (N,) int32."""
    out = torch.empty(points.shape[0], dtype=torch.int32,
                      device=points.device)
    for s in range(0, points.shape[0], block):
        out[s:s + block] = torch.argmin(
            distance.sq_distance_matrix(points[s:s + block], centroids),
            dim=1)
    return out


def _lloyd(points: torch.Tensor, centroids: torch.Tensor, iters: int,
           block: int = 8192):
    """Lloyd k-means from given initial centroids (the refinement of
    hsearch_tpu/search/ivf.py's ``_kmeans_cells``, whose random draw of
    the initial centroids the caller makes).

    Each iteration assigns every point to its nearest centroid and moves
    each centroid to the mean of its points (a segment sum with
    ``index_add_``); an empty cell keeps its centroid.  On a CUDA device
    the float sums are atomic, so their last bits depend on the order the
    points arrive in.  Returns (assignment (N,) int32, final centroids).
    """
    n_cells = centroids.shape[0]
    for _ in range(iters):
        a = _assign_points(points, centroids, block).long()
        sums = torch.zeros_like(centroids).index_add_(0, a, points)
        cnt = torch.bincount(a, minlength=n_cells).to(points.dtype)
        centroids = torch.where(cnt[:, None] > 0,
                                sums / torch.clamp_min(cnt, 1.0)[:, None],
                                centroids)
    return _assign_points(points, centroids, block), centroids


def build_index(db_kmers: np.ndarray, generator: torch.Generator,
                block_size: int = 32, n_cells: int | None = None,
                kmeans_iters: int = 0,
                device: str | torch.device = "cuda") -> IVFIndex:
    """Sample-assign cells, sort, cut cell-aligned blocks, bound each.

    Cell centers are sampled uniformly from the data (n_cells defaults to
    N/block_size); one blocked assignment GEMM gives cell ids, and
    ``kmeans_iters`` Lloyd iterations refine them (``_lloyd``; this path
    embeds all N points, (N, 8L) float32, on the device).  Blocks never
    span cells, so a dense natural cluster yields tight blocks.
    ``generator`` is a CPU ``torch.Generator`` (the seed of the build).
    """
    dev = _device.resolve(device)
    n, l = db_kmers.shape
    _check_kmers(db_kmers, "db_kmers")
    host_km = np.asarray(db_kmers, np.int8)
    km = torch.as_tensor(host_km, device=dev)
    if n_cells is None:
        n_cells = max(1, n // block_size)
    if kmeans_iters:
        coords = distance.const("coords", dev)
        points = coords[km.long()].reshape(n, l * coords.shape[1])
        init = points[_sample_ids(n, n_cells, generator).to(dev)]
        cells = _lloyd(points, init, kmeans_iters)[0].cpu().numpy()
        del points, init
    else:
        # past 2^18 cells the (block, n_cells) assignment matrix is
        # chunked along cells (the JAX package's rule, kept unchanged)
        cc = 16384 if n_cells > (1 << 18) else None
        cells = _assign_cells_kmers(km, generator, n_cells,
                                    cell_chunk=cc).cpu().numpy()
    order_blocks = torch.as_tensor(
        _cell_aligned_groups(cells, n_cells, block_size, n), device=dev)
    db_sorted, cent, rad = _stage2(km, order_blocks, n, block_size)
    return IVFIndex(db_sorted=db_sorted, order=order_blocks,
                    block_centroid=cent, block_radius=rad, n_points=n,
                    host_kmers=host_km, kmer_len=l)


def _cascade_top_blocks(key: torch.Tensor, gmin: torch.Tensor, kb: int):
    """EXACT nearest-kb block select in O(B/group) select work.

    ``key`` (C, Bp) holds the inf-padded keys and ``gmin`` (C, Bp/group)
    each group's minimum over ``group`` consecutive blocks, both from the
    prune kernel.  Stage 1 top-k's the kb smallest groups; stage 2 top-k's
    the kb smallest blocks inside the selected groups.  If a true top-kb
    block sat in an unselected group, each of the kb selected groups would
    hold a distinct block at least as close — so the result is the same
    block set as the flat top-k (tie order may differ).
    """
    c, bp = key.shape
    ng = gmin.shape[1]
    group = bp // ng
    kg = key.view(c, ng, group)
    ks = min(kb, ng)
    _, gsel = torch.topk(-gmin, ks, dim=1)                     # (C, ks)
    gkeys = torch.gather(kg, 1, gsel[:, :, None].expand(c, ks, group)) \
        .reshape(c, ks * group)
    neg, sel = torch.topk(-gkeys, min(kb, ks * group), dim=1)
    blk = gsel[:, :, None] * group + torch.arange(group, device=key.device)
    blk_ids = torch.gather(blk.reshape(c, ks * group), 1, sel)
    return neg, blk_ids


# blocks per stage-1 select group of the cascade: the prune kernel's group
_SELECT_GROUP = cuda_kernels.PRUNE_GROUP


def _search_block_hits(index: IVFIndex, centers: torch.Tensor,
                       centers_emb: torch.Tensor, r: np.float32,
                       k_blocks: int, max_hits: int):
    """One center block: prune blocks, select the nearest survivors, exact
    verify, keep each center's nearest ``max_hits`` hits.

    Returns (ids (C, k) int32 sentinel-N, d2 (C, k) f32, n_hits (C,),
    n_alive (C,)), k = min(max_hits, kb * bs).  Every step is queued on
    the device without a host synchronisation.
    """
    n = index.n_points
    bs = index.block_size
    b = index.num_blocks
    key, gmin, n_alive = cuda_kernels.sq_distance_prune(
        centers_emb, index.block_centroid, index.block_radius, float(r))
    kb = min(k_blocks, b)
    if b >= 4 * _SELECT_GROUP:
        neg, blk_ids = _cascade_top_blocks(key, gmin, kb)
    else:
        neg, blk_ids = torch.topk(-key[:, :b], kb, dim=1)    # (C, kb)
    ptab = _center_ptables(centers, index.kmer_len)
    # r is float32 and squared in float32, as the JAX package does
    d2m, n_hits = cuda_kernels.ptable_verify(
        ptab, index.db_sorted, index.order, blk_ids, neg, float(r * r), n)
    negd, sel = torch.topk(-d2m, min(max_hits, d2m.shape[1]), dim=1)
    found = torch.isfinite(negd)
    # the hit's id: row sel % bs of the selected block sel // bs
    slot = torch.gather(blk_ids, 1, sel // bs) * bs + sel % bs
    out_ids = torch.where(found,
                          index.order.view(-1)[torch.where(found, slot, 0)],
                          torch.full_like(sel, n, dtype=index.order.dtype))
    return out_ids, -negd, n_hits, n_alive


def _search_block(index: IVFIndex, centers: torch.Tensor,
                  centers_emb: torch.Tensor, r: np.float32, k_blocks: int,
                  max_hits: int, cap_frac: int = 4, with_d2: bool = True):
    """``_search_block_hits`` and the packed transfer: returns (packed flat
    int32 buffer — ops/compact layout with meta = [n_hits (C),
    n_alive (C)]; ids (C, max_hits) sentinel-N and d2 (C, max_hits) as
    the lossless overflow fallback)."""
    out_ids, out_d2, n_hits, n_alive = _search_block_hits(
        index, centers, centers_emb, r, k_blocks, max_hits)
    packed = compact.pack_hits(out_ids, out_d2, index.n_points,
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
           transfer_d2: bool | None = None, after_dispatch=None):
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
    on a TPU backend there).  ``after_dispatch()``, when given, is called
    once every center block's device work is queued and before any result
    is read back: the segmented engine queues its next upload there, so
    the copy runs under this search's kernels.
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
    if after_dispatch is not None:
        after_dispatch()
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
        # (cb, kb*bs) verify output stays within the main pass's memory;
        # kb is bounded by the block count, so this terminates
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
