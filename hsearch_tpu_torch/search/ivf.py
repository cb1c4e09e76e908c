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
a 4x cap until none overflow.  ``approx_select`` (the JAX package's
``approx_max_k`` switch) makes the cascade's stage-1 group select
approximate on the card and voids that contract.

Random draws come from an explicit CPU ``torch.Generator``: the centroid
sample is drawn on the CPU and moved to the device, so one seed builds the
same index on the CPU and on the card.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import os
import warnings

import numpy as np
import torch
import torch.nn.functional as F

from .. import _device, native_ext
from ..core import embedding
from ..ops import compact, cuda_kernels, distance
from ..utils import profiling
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


def _block_bounds(db_sorted: torch.Tensor, order: torch.Tensor, n: int,
                  bchunk: int = 4096):
    """(B, bs*L) int8 block-sorted rows and their (B, bs) order map -> each
    block's embedded centroid (B, 8L) f32 and covering radius (B,), rows
    with order >= n left out (a block with none: radius -inf, centroid 0).

    ``cuda_kernels.block_bounds``: one kernel launch on a CUDA device, its
    plain version in chunks of ``bchunk`` blocks on the CPU.  The one path
    for both the build (``_stage2``) and the segmented engine's bounds
    pass after an upload (search/stream.py), so a streamed segment is
    bounded bitwise like a resident one.
    """
    return cuda_kernels.block_bounds(
        db_sorted, order, n, distance.const("coords", db_sorted.device),
        bchunk)


def _stage2(km8: torch.Tensor, order_blocks: torch.Tensor, n: int,
            block_size: int, bchunk: int = 4096):
    """Gather the block-sorted database and bound each block
    (``_block_bounds``; ``bchunk`` sizes the CPU version's chunks).

    Returns (db_sorted (B, bs*L) int8, centroid (B, 8L) f32, radius (B,)).
    """
    l = km8.shape[1]
    km_pad = torch.cat([km8, km8.new_zeros((1, l))])
    db_sorted = km_pad[order_blocks.long()].reshape(-1, block_size * l)
    cent, rad = _block_bounds(db_sorted, order_blocks, n, bchunk)
    return db_sorted, cent, rad


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
    # C-contiguous: the host d2 pass reads it in place at every search
    host_km = np.ascontiguousarray(db_kmers, np.int8)
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


# lanes of the TPU tile that XLA's approximate top-k reduces a rank-2
# operand's row in
_APPROX_TILE = 128


def _approx_bins(n: int, k: int, recall_target: float = 0.95) -> int:
    """Bins that ``jax.lax.approx_max_k(..., aggregate_to_topk=False)``
    reduces a length-``n`` row to for the top ``k``: XLA's
    ApproxTopKReductionOutputSize for a rank-2 operand.

    A row of at most one tile is not reduced, nor one whose reduction
    would be 1.  For k = 1 the row is reduced to one tile.  Otherwise the
    window count M at which a top-k element collides with another with
    probability 1 - recall is (k - 1) / -ln(recall), at least one tile;
    the row shrinks by the largest power of two 2^s <= n / M, in whole
    tiles: L = ceil(ceil(n / 128) / 2^s) * 128.  ``recall_target`` is
    taken as float32, as XLA takes it.
    """
    t = _APPROX_TILE
    if n <= t:
        return n
    if k == 1:
        return t
    m = min(max(int((1.0 - k) / math.log(float(np.float32(recall_target)))),
                t), n)
    s = (n // m).bit_length() - 1
    if s <= 0:
        return n
    return -(-(-(-n // t)) // (1 << s)) * t


def _approx_topk_min(vals: torch.Tensor, ks: int,
                     recall_target: float = 0.95):
    """The ``ks`` smallest of each row of ``vals`` (C, n), approximately:
    the counterpart of ``jax.lax.approx_max_k(-vals, ks, recall_target)``.
    Returns (neg, idx) in the layout of ``torch.topk(-vals, ks)``.

    XLA's TPU lowering reduces each row to L = ``_approx_bins(n, ks)``
    bins, keeping each bin's best element, and then takes the exact top-k
    of the bins.  Here the row is padded with +inf to m*L and viewed as
    (m, L), so element j falls in bin j mod L: the strided PartialReduce
    layout of "TPU-KNN: K Nearest Neighbor Search at Peak FLOP/s" (Chern
    et al., 2022), which also spreads the neighbouring groups of one IVF
    cell over different bins.  Each bin keeps its minimum and, on ties,
    its lowest index (so an all-+inf bin still names a real element);
    then ``torch.topk`` takes the ks best bins.  Two of the ks smallest
    that share a bin cost the select one of them: that is the recall
    loss.  XLA's CPU lowering is an exact sort, so the TPU's own bin
    layout cannot be observed off the TPU; the layout here is the
    paper's.  When L >= n the reduction is the identity and the result
    is exactly ``torch.topk(-vals, ks)``.
    """
    c, n = vals.shape
    nb = _approx_bins(n, ks, recall_target)
    if nb >= n:
        return torch.topk(-vals, ks, dim=1)
    m = -(-n // nb)
    binned = F.pad(vals, (0, m * nb - n), value=float("inf")).view(c, m, nb)
    bmin, row = torch.min(binned, dim=1)                       # (C, L)
    neg, pos = torch.topk(-bmin, ks, dim=1)
    return neg, torch.gather(row, 1, pos) * nb + pos


def _select_nearest(vals: torch.Tensor, k: int, approx: bool):
    """``torch.topk(-vals, k)``, or the approximate select where ``approx``
    and the domain holds at least 8k entries (the JAX package's gate)."""
    if approx and k * 8 <= vals.shape[1]:
        return _approx_topk_min(vals, k)
    return torch.topk(-vals, k, dim=1)


def _cascade_top_blocks(key: torch.Tensor, gmin: torch.Tensor, kb: int,
                        approx: bool = False):
    """EXACT nearest-kb block select in O(B/group) select work.

    ``key`` (C, Bp) holds the inf-padded keys and ``gmin`` (C, Bp/group)
    each group's minimum over ``group`` consecutive blocks, both from the
    prune kernel.  Stage 1 top-k's the kb smallest groups; stage 2 top-k's
    the kb smallest blocks inside the selected groups.  If a true top-kb
    block sat in an unselected group, each of the kb selected groups would
    hold a distinct block at least as close — so the result is the same
    block set as the flat top-k (tie order may differ).

    ``approx`` makes stage 1 the approximate select (``_select_nearest``)
    and voids that proof: a group it misses loses its blocks.  Stage 2
    stays exact over the chosen groups' blocks.
    """
    c, bp = key.shape
    ng = gmin.shape[1]
    group = bp // ng
    kg = key.view(c, ng, group)
    ks = min(kb, ng)
    _, gsel = _select_nearest(gmin, ks, approx)                # (C, ks)
    gkeys = torch.gather(kg, 1, gsel[:, :, None].expand(c, ks, group)) \
        .reshape(c, ks * group)
    neg, sel = torch.topk(-gkeys, min(kb, ks * group), dim=1)
    blk = gsel[:, :, None] * group + torch.arange(group, device=key.device)
    blk_ids = torch.gather(blk.reshape(c, ks * group), 1, sel)
    return neg, blk_ids


# blocks per stage-1 select group of the cascade: the prune kernel's group
_SELECT_GROUP = cuda_kernels.PRUNE_GROUP


def _block_steps(index: IVFIndex, r: np.float32, k_blocks: int,
                 max_hits: int, approx_select: bool,
                 cap_frac: int | None = None, with_d2: bool = True):
    """One center block's device chain as (span, step) pairs, in order.

    A step reads its inputs from the dict it is given and stores its
    outputs there, dropping the inputs no later step reads: ``centers``
    (C, L) int or (C, 8L) f32 and ``emb`` (C, 8L) f32 go in; ``ids`` (C, k)
    int32 sentinel-N, ``d2`` (C, k) f32, ``n_hits`` (C,) and ``n_alive``
    (C,) come out, k = min(max_hits, kb * bs), and with ``cap_frac`` the
    ``pack`` step folds the last two into ``packed``.  No step
    synchronises the host, and every shape is fixed by the index, C, kb,
    ``max_hits`` and ``cap_frac``, so the steps can run eagerly or be
    captured as CUDA graphs (``_search_block``).
    """
    n = index.n_points
    bs = index.block_size
    b = index.num_blocks
    kb = min(k_blocks, b)
    # the steps read the index's tensors, never the index: a graph cache
    # held by the index must not hold the index
    cent, rad = index.block_centroid, index.block_radius
    db_sorted, order, kmer_len = index.db_sorted, index.order, index.kmer_len

    def prune(v):
        v["key"], v["gmin"], v["n_alive"] = cuda_kernels.sq_distance_prune(
            v["emb"], cent, rad, float(r))

    def select(v):
        key, gmin = v.pop("key"), v.pop("gmin")
        if b >= 4 * _SELECT_GROUP:
            v["neg"], v["blk_ids"] = _cascade_top_blocks(key, gmin, kb,
                                                         approx_select)
        else:
            v["neg"], v["blk_ids"] = _select_nearest(key[:, :b], kb,
                                                     approx_select)

    def verify(v):
        ptab = _center_ptables(v["centers"], kmer_len)
        # r is float32 and squared in float32, as the JAX package does
        v["d2m"], v["n_hits"] = cuda_kernels.ptable_verify(
            ptab, db_sorted, order, v["blk_ids"], v.pop("neg"),
            float(r * r), n)

    def top_hits(v):
        d2m, blk_ids = v.pop("d2m"), v.pop("blk_ids")
        negd, sel = torch.topk(-d2m, min(max_hits, d2m.shape[1]), dim=1)
        found = torch.isfinite(negd)
        # the hit's id: row sel % bs of the selected block sel // bs
        slot = torch.gather(blk_ids, 1, sel // bs) * bs + sel % bs
        v["ids"] = torch.where(
            found, order.view(-1)[torch.where(found, slot, 0)],
            torch.full_like(sel, n, dtype=order.dtype))
        v["d2"] = -negd

    def pack(v):
        v["packed"] = compact.pack_hits(
            v["ids"], v["d2"], n, meta_vecs=(v.pop("n_hits"),
                                             v.pop("n_alive")),
            cap_frac=cap_frac, with_d2=with_d2)

    steps = [("ivf.prune", prune), ("ivf.select", select),
             ("ivf.verify", verify), ("ivf.top_hits", top_hits)]
    if cap_frac is not None:
        steps.append(("ivf.pack", pack))
    return steps


def _run_steps(steps, v: dict) -> dict:
    """Run ``_block_steps`` eagerly, each in its span."""
    for name, step in steps:
        with profiling.span(name):
            step(v)
    return v


def _search_block_hits(index: IVFIndex, centers: torch.Tensor,
                       centers_emb: torch.Tensor, r: np.float32,
                       k_blocks: int, max_hits: int,
                       approx_select: bool = False):
    """One center block: prune blocks, select the nearest survivors, exact
    verify, keep each center's nearest ``max_hits`` hits.  With
    ``approx_select`` the block select is approximate (``_select_nearest``)
    on whatever device the index is on; ``search`` decides where it runs.

    Returns (ids (C, k) int32 sentinel-N, d2 (C, k) f32, n_hits (C,),
    n_alive (C,)), k = min(max_hits, kb * bs).  Every step is queued on
    the device without a host synchronisation.
    """
    v = _run_steps(_block_steps(index, r, k_blocks, max_hits, approx_select),
                   {"centers": centers, "emb": centers_emb})
    return v["ids"], v["d2"], v["n_hits"], v["n_alive"]


def _search_block(index: IVFIndex, centers: torch.Tensor,
                  centers_emb: torch.Tensor, r: np.float32, k_blocks: int,
                  max_hits: int, cap_frac: int = 4, with_d2: bool = True,
                  approx_select: bool = False):
    """The block's chain with the packed transfer, queued eagerly: returns
    (packed flat int32 buffer — ops/compact layout with meta = [n_hits (C),
    n_alive (C)]; ids (C, max_hits) sentinel-N and d2 (C, max_hits) as
    the lossless overflow fallback)."""
    with profiling.span("ivf.block"):
        v = _run_steps(_block_steps(index, r, k_blocks, max_hits,
                                    approx_select, cap_frac, with_d2),
                       {"centers": centers, "emb": centers_emb})
    return v["packed"], v["ids"], v["d2"]


def _capture_cuda(steps, v: dict, dev: torch.device) -> list:
    """Capture each step as its own CUDA graph, all in one private memory
    pool (``torch.cuda.graph`` captures on a side stream, after handing
    back the memory the caching allocator holds unallocated).  Capturing
    queues nothing; the graphs read ``v``'s tensors at their addresses and
    write the tensors the steps leave in ``v``.  Returns (span, replay)
    pairs; the replays run on the current stream, in order.
    """
    pool = torch.cuda.graph_pool_handle()
    replays = []
    with torch.cuda.device(dev):
        for name, step in steps:
            g = torch.cuda.CUDAGraph()
            with profiling.span(name), torch.cuda.graph(g, pool=pool):
                step(v)
            replays.append((name, g.replay))
    return replays


# how a center block's device chain is captured, by device type; a device
# without an entry runs the chain eagerly
_CAPTURE = {"cuda": _capture_cuda}

# graph keys an index keeps, the most recently used: each captured key
# holds one block's working memory in its pool, which goes with the key
_GRAPH_KEYS = 2


class _BlockGraphs:
    """One graph key's state in an index's cache: the calls seen, and
    after the capture the static tensors, the per-span replays (empty
    where the capture ran out of memory) and the kernel launches one
    replay makes."""

    def __init__(self):
        self.calls = 0
        self.v: dict = {}
        self.replays: list | None = None
        self.launches: dict = {}


def keep_eager(index: IVFIndex) -> IVFIndex:
    """Have ``index`` run every center block eagerly and hold no CUDA
    graphs: for an index whose device memory a budget plans without a
    graph pool (``stream``'s segments)."""
    vars(index)["_block_graphs"] = None
    return index


def _graph_entry(index: IVFIndex, key: tuple) -> _BlockGraphs | None:
    """``key``'s entry in the index's cache, its call counted, or None for
    an index kept eager.  The cache holds the ``_GRAPH_KEYS`` keys used
    last and drops older ones with their graphs and pool."""
    cache = vars(index).setdefault("_block_graphs",
                                   collections.OrderedDict())
    if cache is None:
        return None
    entry = cache.pop(key, None) or _BlockGraphs()
    cache[key] = entry
    if len(cache) > _GRAPH_KEYS:
        cache.popitem(last=False)
    entry.calls += 1
    return entry


def _capture_block(entry: _BlockGraphs, capture, steps,
                   centers: torch.Tensor, centers_emb: torch.Tensor) -> None:
    """Capture ``steps`` into ``entry`` with copies of the block's centers
    as the graphs' inputs.  Capturing launches nothing: what the wrappers
    count meanwhile is what each replay launches, and comes off their
    counts again, whether or not the capture completes.  A capture the
    card has no memory for leaves the key eager (``replays`` empty)."""
    v = entry.v
    v.update(centers=centers.clone(), emb=centers_emb.clone())
    before = cuda_kernels.launch_counts()
    try:
        entry.replays = capture(steps, v, centers.device)
    except torch.OutOfMemoryError:
        entry.replays = []
        v.clear()
    finally:
        entry.launches = {k: c - before[k] for k, c in
                          cuda_kernels.launch_counts().items()
                          if c != before[k]}
        cuda_kernels.count_launches(
            {k: -c for k, c in entry.launches.items()})


def _graphed_block(index: IVFIndex, centers: torch.Tensor,
                   centers_emb: torch.Tensor, r: np.float32, k_blocks: int,
                   max_hits: int, cap_frac: int, with_d2: bool,
                   approx_select: bool, copy_out: bool = True):
    """``_search_block``, replayed from CUDA graphs where the index has run
    the block's shape before: returns its three outputs and how it ran
    (None eagerly, "capture" or "replay").

    On a device in ``_CAPTURE`` the chain is keyed by the center block's
    shape and dtype, kb, ``max_hits``, ``cap_frac``, ``with_d2``, the
    select flag and r, in a cache the index holds (and frees with it;
    ``_graph_entry``).  The first call with a key runs eagerly, the second
    captures the chain (one graph per span) and launches it, and later
    calls copy the block into the graphs' input tensors and replay them.
    The same kernels run in the same order, so the hits are those of the
    eager chain, bit for bit.  A graph's outputs live in its memory, which
    its next replay overwrites: ``copy_out`` copies them out, and a caller
    that reads them before it queues the same key again may pass False.
    The cache is not for use from several threads at once.
    """
    capture = _CAPTURE.get(centers.device.type)
    entry = None if capture is None else _graph_entry(index, (
        tuple(centers.shape), centers.dtype, min(k_blocks, index.num_blocks),
        max_hits, cap_frac, with_d2, approx_select, float(r)))
    if entry is not None and entry.calls > 1 and entry.replays != []:
        with profiling.span("ivf.block"):
            v = entry.v
            if entry.replays is None:
                how = "capture"
                _capture_block(entry, capture, _block_steps(
                    index, r, k_blocks, max_hits, approx_select, cap_frac,
                    with_d2), centers, centers_emb)
            else:
                how = "replay"
                v["centers"].copy_(centers)
                v["emb"].copy_(centers_emb)
            if entry.replays:
                for name, replay in entry.replays:
                    with profiling.span(name):
                        replay()
                cuda_kernels.count_launches(entry.launches)
                out = v["packed"], v["ids"], v["d2"]
                if copy_out:
                    out = tuple(t.clone() for t in out)
                return (*out, how)
    return (*_search_block(index, centers, centers_emb, r, k_blocks,
                           max_hits, cap_frac, with_d2, approx_select), None)


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


def _approximates(dev: torch.device) -> bool:
    """Whether ``search`` runs the approximate select on ``dev``: on the
    card only, as the JAX package runs it only on its TPU backend."""
    return dev.type == "cuda"


@profiling.spanned("ivf.search")
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
    one word per hit and recomputes d2 on the host, as the JAX package
    does: a table sum of L entries is cheaper to recompute than to move.
    The recompute is the host library's prefetching pass
    ``native_ext.hit_sq_distance``, bitwise its numpy twin
    ``embedding.hit_sq_distance_np``; like every binding it raises where
    the library does not build.  It reads ``host_kmers`` in place, which
    ``build_index`` and the checkpoint loaders hold C-contiguous int8.  On
    the H100's host, for 82,000 hits into 2^22 25-mers (a 1,024-center
    batch), the pass takes 1.5-2.4 ms on 4 OpenMP threads and 3.2-5.7 ms
    on one, the numpy twin 29-30 ms.

    ``approx_select=True`` makes the block select approximate
    (``_approx_topk_min``, the counterpart of ``jax.lax.approx_max_k`` at
    recall_target 0.95): the cascade's stage-1 group select when
    ks * 8 <= groups, the flat select when kb * 8 <= blocks.  Up to ~5% of
    the surviving groups may be missed, never a false positive: the hits
    are still verified exactly, but the exactness contract is void, so
    gate on measured recall.  ``None`` reads ``HSEARCH_APPROX_SELECT=1``
    once per call, as the JAX package does.  It acts only on a CUDA index:
    the JAX package approximates only on its accelerator (the TPU) and
    gives the exact select on its CPU, and so does this package.
    ``after_dispatch()``, when given, is called
    once every center block's device work is queued and before any result
    is read back: the segmented engine queues its next upload there, so
    the copy runs under this search's kernels.

    ``stats_out`` also receives ``d2h_bytes`` (every buffer read back:
    the packed buffers, a re-dispatch's, the full fallback buffers),
    ``h2d_bytes`` (the padded centers and their embedding),
    ``host_d2_hits`` (hits whose d2 the host recomputed) and
    ``host_d2_native_hits`` (of those, the hits the library's pass
    recomputed: all of them, since the pass has no fallback),
    ``graph_captures`` (center blocks whose device chain was captured as
    CUDA graphs) and ``graph_replays`` (center blocks served by replaying
    graphs captured before them), the retry's included.

    On a CUDA index a center block's device chain (prune, select, verify,
    top hits, packing) is replayed from CUDA graphs once the index has run
    the same block shape twice: the third and every later center block
    with the same center block size, kb, ``max_hits``, packed capacity,
    d2 layout, select flag and float32 radius copies its centers into the
    graphs' inputs and launches one graph per span (five) instead of
    queueing each of the chain's kernels from Python; the second captures
    them.  The graphs run the same kernels in the same order, so the hits
    never change; an index searched with a shape only once never captures.
    An index keeps the two shapes it used last, each holding one block's
    working memory on the card, and frees an older shape's graphs (and all
    of them with the index); a capture the card has no memory for leaves
    its shape eager, and the segmented engine's segments always run
    eagerly (``keep_eager``).  The rest of the call (read back,
    unpacking, the host d2, a re-dispatch, the retry) runs as before.  A
    CPU index always runs the chain eagerly.  In a recording
    ``torch.profiler`` trace the call is the span ``ivf.search``:
    ``ivf.centers``, per center block ``ivf.block``
    (``ivf.prune``, ``ivf.select``, ``ivf.verify``, ``ivf.top_hits``,
    ``ivf.pack``), then per block ``ivf.d2h``, ``ivf.unpack`` and
    ``ivf.host_d2`` (or ``ivf.redispatch``, ``ivf.fallback``), then
    ``ivf.assemble`` and ``ivf.retry``.
    """
    dev = index.device
    c_total = centers.shape[0]
    centers = np.asarray(centers)
    is_kmers = np.issubdtype(centers.dtype, np.integer)
    if is_kmers:
        _check_kmers(centers, "centers")
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
    if not transfer_d2:
        centers_i8 = np.ascontiguousarray(centers, np.int8)
    host_d2_hits = host_d2_native = 0
    kb_used = min(k_blocks, index.num_blocks)
    if approx_select is None:
        approx_select = os.environ.get("HSEARCH_APPROX_SELECT", "0") == "1"
    approx = bool(approx_select) and _approximates(dev)
    r = np.float32(radius)
    cdtype = np.int32 if is_kmers else np.float32
    with profiling.span("ivf.centers"):
        cemb_all = embedding.embed_kmers(centers) if is_kmers \
            else centers.astype(np.float32)
        # pad to whole center blocks and upload once: a host->device copy
        # inside the dispatch loop would wait for the blocks already queued
        pad_total = (-c_total) % center_block
        cpad = np.pad(centers.astype(cdtype),
                      ((0, pad_total),) + ((0, 0),) * (centers.ndim - 1))
        epad = np.pad(cemb_all, ((0, pad_total), (0, 0)))
        cdev = torch.as_tensor(cpad, device=dev)
        edev = torch.as_tensor(epad, device=dev)
    h2d_bytes = cpad.nbytes + epad.nbytes
    d2h_bytes = 0
    ci, ki, dd = [], [], []
    redo: list[np.ndarray] = []      # center ids that lost the guarantee
    over_blocks = over_hits = 0
    # two passes: queue every center block first, then harvest — block
    # i's device->host copy overlaps the device work of the later blocks
    pending = []
    graph_runs: collections.Counter = collections.Counter()
    for s in range(0, c_total, center_block):
        real = min(center_block, c_total - s)
        # every block is harvested after the last one is queued: only the
        # last may leave its outputs in a graph's memory
        *block, how = _graphed_block(
            index, cdev[s:s + center_block], edev[s:s + center_block], r,
            k_blocks, max_hits, pack_cap_frac, transfer_d2, approx,
            copy_out=s + center_block < c_total)
        graph_runs[how] += 1
        pending.append((s, real, block))
    if after_dispatch is not None:
        after_dispatch()
    max_alive = 0
    for s, real, (packed, ids, d2) in pending:
        with profiling.span("ivf.d2h"):
            packed_np = packed.cpu().numpy()
        d2h_bytes += packed_np.nbytes
        with profiling.span("ivf.unpack"):
            hits, (n_hits, n_alive) = compact.unpack_hits(
                packed_np, (center_block, center_block))
        if hits is None and pack_cap_frac > 1:
            # packed-capacity escalation: re-dispatch the SAME block with
            # the buffer sized to the now-known total (cap_frac=1 holds
            # every possible hit) instead of pulling the full buffers
            with profiling.span("ivf.redispatch"):
                total = int(packed_np[2])
                k_sel = min(max_hits, kb_used * index.block_size)
                cap = pack_cap_frac
                while cap > 1 and (center_block * k_sel) // cap < total:
                    cap //= 4
                cap = max(cap, 1)
                packed, ids, d2 = _search_block(
                    index, cdev[s:s + center_block],
                    edev[s:s + center_block], r, k_blocks, max_hits, cap,
                    transfer_d2, approx)
                packed_np = packed.cpu().numpy()
                d2h_bytes += packed_np.nbytes
                hits, (n_hits, n_alive) = compact.unpack_hits(
                    packed_np, (center_block, center_block))
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
            with profiling.span("ivf.host_d2"):
                if hd0 is None:
                    # 1-word layout: d2 recomputed from the host k-mers
                    # (sum_l DSQ[q_l, p_l] — the exact verify metric)
                    hd = native_ext.hit_sq_distance(centers_i8, hc + s,
                                                    host_km, hk)
                    host_d2_hits += len(hd)
                    host_d2_native += len(hd)
                else:
                    hd = hd0[keep]
        else:
            # packed capacity overflowed: the full buffers transfer now
            with profiling.span("ivf.fallback"):
                idsh = ids.cpu().numpy().copy()
                d2h = d2.cpu().numpy()
                d2h_bytes += idsh.nbytes + d2h.nbytes
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
    with profiling.span("ivf.assemble"):
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
        sub_stats: dict = {}
        with profiling.span("ivf.retry"):
            keep = ~np.isin(out_c, redo_ids)
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
                over_hits=sub_stats.get("over_hits", 0),
                d2h_bytes=d2h_bytes + sub_stats["d2h_bytes"],
                h2d_bytes=h2d_bytes + sub_stats["h2d_bytes"],
                host_d2_hits=host_d2_hits + sub_stats["host_d2_hits"],
                host_d2_native_hits=host_d2_native
                + sub_stats["host_d2_native_hits"],
                graph_captures=graph_runs["capture"]
                + sub_stats["graph_captures"],
                graph_replays=graph_runs["replay"]
                + sub_stats["graph_replays"])
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
        stats_out["d2h_bytes"] = d2h_bytes
        stats_out["h2d_bytes"] = h2d_bytes
        stats_out["host_d2_hits"] = host_d2_hits
        stats_out["host_d2_native_hits"] = host_d2_native
        stats_out["graph_captures"] = graph_runs["capture"]
        stats_out["graph_replays"] = graph_runs["replay"]
    return out_c, out_k, out_d
