"""Database-sharded LSH and IVF motif search over a (data, db) device mesh
(counterpart of hsearch_tpu/parallel/sharded.py).

The (N, L) k-mer database is cut into ``db`` shards of n_local =
ceil(N / db) rows each (the last ones hold fewer real rows, or none), and
each shard gets its own single-device index: the LSH tables of
search/motif.py with parameters shared by every shard, or the
block-pruned index of search/ivf.py.  Global ids are shard * n_local +
local id.  A search runs, on every shard, the single-device engine's block
step (``motif._probe_verify_hits``: the ``ptable_verify`` kernel at block
size 1; ``ivf._search_block_hits``: the ``sq_distance_prune`` and
``ptable_verify`` kernels) and keeps each center's ``max_hits`` nearest
hits; the shards' (C, max_hits) blocks are then concatenated along db,
packed (ops/compact) and shipped to the host, with a lossless fallback
when the packed capacity overflows.  A center's truncation is judged by
its worst single shard, never by the sum over shards.

There is no SPMD program: a process loops over its own shards, each on
its device.  Data-parallel rows of the mesh hold replicas of the shards
(the same objects where the device repeats) and take turns at the center
blocks.  Across processes (parallel/multihost.py) the per-shard blocks are
all-gathered by a ``gather`` callable before the merge, and host-local
maxima are folded by ``reduce_max``.

Semantics match the single-device engines: the verify is exact, so
sharding only re-partitions which candidates each shard's tables surface;
an index built with the same LSH parameters gives the single index's hit
set, and the IVF search at k_blocks = blocks_per_shard the exact one.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from .. import _device
from ..core import embedding
from ..lsh import pstable
from ..ops import compact, segment
from ..search import exact, ivf, motif
from ..utils import checkpoint
from . import mesh as mesh_lib

DATA, DB = mesh_lib.DATA_AXIS, mesh_lib.DB_AXIS


def shard_rows(n_points: int, n_local: int, shard: int) -> int:
    """Real (not padding) rows of global db shard ``shard``."""
    return int(min(max(n_points - shard * n_local, 0), n_local))


def shard_generator(base: int, shard: int) -> torch.Generator:
    """Global db shard ``shard``'s build generator: a function of (base,
    shard) only, so a shard builds the same index in any process layout."""
    seed = np.random.SeedSequence([base, shard]).generate_state(1,
                                                                np.uint64)
    return torch.Generator().manual_seed(int(seed[0]))


def _local_rows(db_kmers: np.ndarray, mesh: mesh_lib.Mesh) -> list:
    """(N, L) host rows -> this process's per-shard (n_local, L) int8
    tensors on each shard's first-row device, zero-padded."""
    _check_local(mesh)
    ndb = mesh.shape[DB]
    padded, _ = mesh_lib.pad_to_multiple(np.asarray(db_kmers, np.int8), ndb)
    n_local = padded.shape[0] // ndb
    return [torch.as_tensor(padded[j * n_local:(j + 1) * n_local],
                            device=mesh.devices[0][j])
            for j in range(ndb)]


def _check_local(mesh: mesh_lib.Mesh, gather=None) -> None:
    if mesh.spans_processes and gather is None:
        raise ValueError("the mesh spans processes: use the "
                         "parallel/multihost.py entry points")


def _replicas(row0: list, mesh: mesh_lib.Mesh, move) -> list:
    """[data][db_local] shard grid: row 0 as built, the other data rows
    the same objects where their device repeats, else moved copies."""
    grid = [row0]
    for i in range(1, mesh.shape[DATA]):
        grid.append([None if s is None else
                     s if mesh.devices[i][j] == mesh.devices[0][j]
                     else move(s, mesh.devices[i][j])
                     for j, s in enumerate(row0)])
    return grid


def _move_motif(s: motif.MotifIndex, dev) -> motif.MotifIndex:
    return motif.MotifIndex(
        params=s.params.to(dev),
        tables=segment.SortedTables(sorted_codes=s.tables.sorted_codes.to(dev),
                                    perm=s.tables.perm.to(dev)),
        db_kmers=s.db_kmers.to(dev), cand_max=s.cand_max)


def _move_ivf(s: ivf.IVFIndex, dev) -> ivf.IVFIndex:
    return dataclasses.replace(
        s, db_sorted=s.db_sorted.to(dev), order=s.order.to(dev),
        block_centroid=s.block_centroid.to(dev),
        block_radius=s.block_radius.to(dev))


# --------------------------------------------------------------------------
# LSH
# --------------------------------------------------------------------------

@dataclasses.dataclass
class ShardedMotifIndex:
    """Per-shard LSH sub-indexes over a device mesh.

    ``shards[i][j]`` is local db column j's MotifIndex on data row i (None
    for a shard without real rows); its ids are local, 0..n_local-1, and
    rows n_real[j].. are padding that is never a hit.
    """

    mesh: mesh_lib.Mesh
    shards: list                    # [data][db_local] MotifIndex | None
    n_real: list                    # real rows per local shard
    n_local: int                    # rows per shard: the global id stride
    cand_max: int
    n_points: int                   # true (unpadded) database size
    max_hits: int = 256             # per-shard hit cap before the merge
    probes: int = 1                 # multiprobe fan-out


def build_index(db_kmers: np.ndarray, generator: torch.Generator,
                mesh: mesh_lib.Mesh,
                config: motif.MotifSearchConfig = motif.MotifSearchConfig(),
                cand_max: int | None = None) -> ShardedMotifIndex:
    """Shard the database over ``db`` and build per-shard sorted tables.

    ``generator`` (a CPU torch.Generator) draws the LSH parameters, as
    motif.build_index does."""
    motif._check_kmers(np.asarray(db_kmers), "db_kmers")
    return build_index_from_global(_local_rows(db_kmers, mesh),
                                   db_kmers.shape[0], generator, mesh,
                                   config, cand_max)


def build_index_from_global(km: list, n_points: int,
                            generator: torch.Generator, mesh: mesh_lib.Mesh,
                            config: motif.MotifSearchConfig
                            = motif.MotifSearchConfig(),
                            cand_max: int | None = None,
                            reduce_max=None) -> ShardedMotifIndex:
    """Per-shard table build over already-placed shard rows: ``km`` holds
    this process's (n_local, L) int8 tensors, one per local db column, on
    the column's first-row device (the entry point shared with
    parallel/multihost.py, where no process sees the whole database).

    cand_max defaults to the largest bucket over all shards, folded across
    processes by ``reduce_max`` (callable(int) -> int; None = this
    process), clamped to [1, config.cand_limit]."""
    n_local, l = km[0].shape
    params = pstable.init(generator, l * embedding.AA_DIM, config.hash_k,
                          config.hash_l, config.w)
    row0, n_real, maxb = [], [], 1
    for j, rows in enumerate(km):
        nr = shard_rows(n_points, n_local, mesh.db_first + j)
        n_real.append(nr)
        if nr == 0:
            row0.append(None)
            continue
        s = motif.build_index(rows[:nr].cpu().numpy(), None, config,
                              cand_max=1, params=params, device=rows.device)
        maxb = max(maxb, segment.max_bucket_size(s.tables.sorted_codes))
        row0.append(s)
    if cand_max is None:
        cand_max = config.cand_max
    if cand_max is None:
        cand_max = reduce_max(maxb) if reduce_max else maxb
        cand_max = min(max(1, cand_max), config.cand_limit)   # skew bound
    for s in row0:
        if s is not None:
            s.cand_max = int(cand_max)
    return ShardedMotifIndex(
        mesh=mesh, shards=_replicas(row0, mesh, _move_motif),
        n_real=n_real, n_local=n_local, cand_max=int(cand_max),
        n_points=n_points, max_hits=config.max_hits,
        probes=max(1, config.probes))


def motif_index_from_arrays(mesh: mesh_lib.Mesh, a, b, w: float,
                            pack_bits: int, sorted_codes, perm, db_kmers,
                            cand_max: int, n_points: int,
                            max_hits: int = 256,
                            probes: int = 1) -> ShardedMotifIndex:
    """A ShardedMotifIndex from the JAX sharded index's fields as numpy:
    ``params.a/b/w/pack_bits``, the (T, S*n_local) sorted codes and local
    perm of every shard side by side, and the (S*n_local, L) padded
    k-mers.  The tables keep the zero-filled padding rows they were built
    with; the shard's real row count keeps them from being hits."""
    db = np.asarray(db_kmers)
    ndb = mesh.shape[DB]
    n_local = db.shape[0] // ndb
    row0, n_real = [], []
    for j in range(mesh.db_local):
        g = mesh.db_first + j
        cols = slice(g * n_local, (g + 1) * n_local)
        padded = np.zeros((n_local + 1, db.shape[1]), np.int8)
        padded[:-1] = db[cols]
        row0.append(motif.index_from_arrays(
            a, b, w, pack_bits, np.asarray(sorted_codes)[:, cols],
            np.asarray(perm)[:, cols], padded, cand_max,
            mesh.devices[0][j]))
        n_real.append(shard_rows(n_points, n_local, g))
    return ShardedMotifIndex(
        mesh=mesh, shards=_replicas(row0, mesh, _move_motif), n_real=n_real,
        n_local=n_local, cand_max=int(cand_max), n_points=int(n_points),
        max_hits=max_hits, probes=max(1, probes))


def search(index: ShardedMotifIndex, centers: np.ndarray,
           radius: float = 200.0, center_block: int = 128, gather=None,
           stats_out: dict | None = None):
    """All (center, kmer) pairs within ``radius``, merged across shards.

    Returns (center_idx, kmer_idx, dist) host arrays, the contract of
    search.motif.search.  ``center_block`` centers go to each data row at
    a time; ``gather`` is parallel/multihost.py's all-gather of the
    per-shard blocks (None: the mesh is this process's alone).  Centers
    whose hits fill a shard's max_hits slots (nearest kept) or that probe
    a bucket larger than cand_max on some shard (candidates truncated)
    are counted: into ``stats_out`` as ``truncated`` / ``skewed`` when
    given, else as warnings.
    """
    centers = np.asarray(centers)
    is_kmers = np.issubdtype(centers.dtype, np.integer)
    if is_kmers:
        motif._check_kmers(centers, "centers")
    # R*R in double, then rounded to float32, as the single-device engine
    r2 = float(np.float32(radius * radius))

    def per_shard(s, j, cblk):
        qcodes = motif._query_codes(s, cblk, is_kmers, index.probes)
        return motif._probe_verify_hits(s, cblk, qcodes, r2, index.cand_max,
                                        index.max_hits, index.n_real[j])[:4]

    arr = centers.astype(np.int32 if is_kmers else np.float32)
    ci, ki, dd, (n_hits, n_dropped) = _search_sharded(
        index, arr, None, center_block, per_shard, gather, 2)
    truncated = int((n_hits > index.max_hits).sum())
    skewed = int((n_dropped > 0).sum())
    if stats_out is not None:
        stats_out.update(truncated=truncated, skewed=skewed)
    else:
        if truncated:
            warnings.warn(
                f"{truncated} centers filled a shard's max_hits="
                f"{index.max_hits} slots; nearest hits kept — raise "
                "max_hits for the full set")
        if skewed:
            warnings.warn(
                f"{skewed} centers probed buckets larger than cand_max="
                f"{index.cand_max} on some shard (bucket skew); their "
                "candidate lists were truncated")
    return ci, ki, dd


def _search_sharded(index, arr, emb, center_block, per_shard, gather,
                    n_meta):
    """The search loop both engines share.

    Each center block (``center_block`` centers per data row) runs
    ``per_shard(shard, j, centers[, emb])`` -> (local ids (c, k) with
    every id >= n_real[j] a miss, d2 (c, k), *metas (c,)) on every local
    shard of its data row; ids become global, blocks are padded to
    max_hits, stacked (db, c, max_hits), gathered across processes,
    concatenated along db, packed and harvested.  Every block is queued
    before any is read back.  Returns (ci, ki, dd, metas: each meta's max
    over shards per center)."""
    mesh = index.mesh
    _check_local(mesh, gather)
    ndata = mesh.shape[DATA]
    ndb = mesh.shape[DB]
    n_total = index.n_local * ndb
    mh = index.max_hits
    c_total = arr.shape[0]
    # upload the centers once per distinct device: a host->device copy in
    # the dispatch loop would wait for the work already queued
    up = {}
    for d in mesh.flat():
        if d not in up:
            up[d] = (torch.as_tensor(arr, device=d), None if emb is None
                     else torch.as_tensor(emb, device=d))
    pending = []
    for s0 in range(0, c_total, center_block * ndata):
        for i in range(ndata):
            lo = s0 + i * center_block
            hi = min(lo + center_block, c_total)
            if lo >= hi:
                break
            merge_dev = mesh.devices[i][0]
            blocks = []
            for j, s in enumerate(index.shards[i]):
                c = hi - lo
                if s is None:
                    blocks.append((torch.full((c, mh), n_total,
                                              dtype=torch.int64,
                                              device=merge_dev),
                                   torch.full((c, mh), float("inf"),
                                              device=merge_dev),
                                   torch.zeros((n_meta, c), dtype=torch.int32,
                                               device=merge_dev)))
                    continue
                cen, em = up[mesh.devices[i][j]]
                args = (cen[lo:hi],) if em is None \
                    else (cen[lo:hi], em[lo:hi])
                ids, d2, *metas = per_shard(s, j, *args)
                g = mesh.db_first + j
                gids = torch.where(ids < index.n_real[j],
                                   ids.long() + g * index.n_local, n_total)
                pad = mh - gids.shape[1]
                gids = torch.nn.functional.pad(gids, (0, pad), value=n_total)
                d2 = torch.nn.functional.pad(d2, (0, pad),
                                             value=float("inf"))
                blocks.append((gids.to(merge_dev), d2.to(merge_dev),
                               torch.stack([m.to(torch.int32)
                                            for m in metas]).to(merge_dev)))
            pending.append((lo, hi, blocks))
    out_c, out_k, out_d = [], [], []
    meta_max = [[] for _ in range(n_meta)]
    for lo, hi, blocks in pending:
        ids = torch.stack([b[0] for b in blocks])       # (db_local, c, mh)
        d2 = torch.stack([b[1] for b in blocks])
        metas = torch.stack([b[2] for b in blocks])     # (db_local, m, c)
        if gather is not None:
            ids, d2, metas = gather(ids), gather(d2), gather(metas)
        c = hi - lo
        gids = ids.permute(1, 0, 2).reshape(c, -1)      # shard order
        gd2 = d2.permute(1, 0, 2).reshape(c, -1)
        worst = torch.amax(metas, dim=0)                # (m, c)
        packed = compact.pack_hits(gids, gd2, index.n_points,
                                   meta_vecs=tuple(worst))
        hits, mv = compact.unpack_hits(packed.cpu().numpy(), (c,) * n_meta)
        for q, m in zip(meta_max, mv):
            q.append(m)
        if hits is not None:
            hc, hk, hd = hits
        else:
            # packed capacity overflowed: the full buffers transfer now
            hc, hk, hd, _ = compact.full_hits(gids, gd2, index.n_points)
        out_c.append(hc.astype(np.int64) + lo)
        out_k.append(hk.astype(np.int64))
        out_d.append(np.sqrt(np.maximum(hd, 0.0)))
    metas = [np.concatenate(q) if q else np.zeros(0, np.int32)
             for q in meta_max]
    if not out_c:
        return (np.empty(0, np.int64), np.empty(0, np.int64),
                np.empty(0, np.float32), metas)
    return (np.concatenate(out_c), np.concatenate(out_k),
            np.concatenate(out_d).astype(np.float32), metas)


# --------------------------------------------------------------------------
# IVF
# --------------------------------------------------------------------------

@dataclasses.dataclass
class ShardedIVFIndex:
    """Per-shard IVF sub-indexes over the ``db`` mesh axis.

    ``shards[i][j]`` is local db column j's IVFIndex on data row i (None
    for a shard without real rows), over local ids with n_points = the
    shard's real row count, so the verify kernel's ``order < n`` test
    drops padding rows.  Block counts differ between shards; the JAX
    package's never-alive dummy blocks (radius -inf) are not needed.
    """

    mesh: mesh_lib.Mesh
    shards: list                 # [data][db_local] IVFIndex | None
    n_real: list                 # real rows per local shard
    n_local: int                 # rows per shard: the global id stride
    n_points: int
    blocks_per_shard: int        # the most blocks of any shard
    max_hits: int = 256


def build_ivf_index(db_kmers: np.ndarray, generator: torch.Generator,
                    mesh: mesh_lib.Mesh, block_size: int = 32,
                    max_hits: int = 256) -> ShardedIVFIndex:
    """Shard the database over ``db`` and build one IVF index per shard;
    shard s builds from ``shard_generator(base, s)``, base one draw of
    ``generator``."""
    motif._check_kmers(np.asarray(db_kmers), "db_kmers")
    return build_ivf_index_from_global(_local_rows(db_kmers, mesh),
                                       db_kmers.shape[0], generator, mesh,
                                       block_size, max_hits)


def build_ivf_index_from_global(km: list, n_points: int,
                                generator: torch.Generator,
                                mesh: mesh_lib.Mesh, block_size: int = 32,
                                max_hits: int = 256,
                                reduce_max=None) -> ShardedIVFIndex:
    """Per-shard IVF builds over already-placed shard rows (see
    ``build_index_from_global``); ``reduce_max`` folds the most blocks of
    any shard across processes."""
    n_local = km[0].shape[0]
    # every process draws the same base from the same generator state
    base = int(torch.randint(0, 1 << 62, (1,), generator=generator))
    row0, n_real, b_max = [], [], 1
    for j, rows in enumerate(km):
        g = mesh.db_first + j
        nr = shard_rows(n_points, n_local, g)
        n_real.append(nr)
        if nr == 0:
            row0.append(None)
            continue
        s = ivf.build_index(rows[:nr].cpu().numpy(),
                            shard_generator(base, g), block_size=block_size,
                            device=rows.device)
        b_max = max(b_max, s.num_blocks)
        row0.append(s)
    b_max = reduce_max(b_max) if reduce_max else b_max
    return ShardedIVFIndex(mesh=mesh, shards=_replicas(row0, mesh, _move_ivf),
                           n_real=n_real, n_local=n_local,
                           n_points=n_points, blocks_per_shard=int(b_max),
                           max_hits=max_hits)


def ivf_index_from_arrays(mesh: mesh_lib.Mesh, db_sorted, order,
                          block_centroid, block_radius, n_points: int,
                          n_local: int, max_hits: int = 256
                          ) -> ShardedIVFIndex:
    """A ShardedIVFIndex from the JAX sharded index's fields as numpy:
    ``db_sorted`` (S*B, bs, L), ``order`` (S*B, bs) local ids with sentinel
    n_local, ``block_centroid`` (S*B, D), ``block_radius`` (S*B,).  Each
    shard's dummy blocks (radius -inf, never alive) are dropped."""
    ds = np.asarray(db_sorted)
    ndb = mesh.shape[DB]
    b = ds.shape[0] // ndb
    l = ds.shape[2]
    row0, n_real, b_max = [], [], 1
    for j in range(mesh.db_local):
        g = mesh.db_first + j
        blk = slice(g * b, (g + 1) * b)
        rad = np.asarray(block_radius)[blk]
        keep = np.isfinite(rad)
        nr = shard_rows(n_points, n_local, g)
        n_real.append(nr)
        row0.append(checkpoint.index_from_arrays(
            ds[blk][keep], np.asarray(order)[blk][keep],
            np.asarray(block_centroid)[blk][keep], rad[keep], nr, l,
            mesh.devices[0][j]) if nr else None)
        b_max = max(b_max, int(keep.sum()))
    return ShardedIVFIndex(mesh=mesh, shards=_replicas(row0, mesh, _move_ivf),
                           n_real=n_real, n_local=int(n_local),
                           n_points=int(n_points), blocks_per_shard=b_max,
                           max_hits=max_hits)


def search_ivf(index: ShardedIVFIndex, centers: np.ndarray, radius: float,
               k_blocks: int = 64, center_block: int = 128, gather=None,
               stats_out: dict | None = None):
    """Sharded block-pruned exact search; the contract of ``search``.

    Each shard keeps its k_blocks nearest live blocks.  Centers with more
    live blocks than that on some shard, or more hits than max_hits, are
    counted: into ``stats_out`` as ``over_blocks`` / ``over_hits`` when
    given, else as warnings."""
    ci, ki, dd, n_hits, n_alive = _search_ivf_flags(
        index, centers, radius, k_blocks, center_block, gather)
    over_blocks = int((n_alive > k_blocks).sum())
    over_hits = int((n_hits > index.max_hits).sum())
    if stats_out is not None:
        stats_out.update(over_blocks=over_blocks, over_hits=over_hits,
                         max_alive=int(n_alive.max()) if n_alive.size else 0)
    else:
        if over_blocks:
            warnings.warn(f"{over_blocks} centers had more than k_blocks="
                          f"{k_blocks} surviving blocks on some shard; raise "
                          "k_blocks for guaranteed-exact results")
        if over_hits:
            warnings.warn(f"{over_hits} centers filled a shard's max_hits="
                          f"{index.max_hits} slots; nearest hits kept")
    return ci, ki, dd


def _search_ivf_flags(index: ShardedIVFIndex, centers: np.ndarray,
                      radius: float, k_blocks: int, center_block: int,
                      gather=None):
    """``search_ivf``'s search, returning beside the hits each center's
    (C,) most hits and most live blocks on any shard: what an overflow
    retry needs to pick the centers to re-search."""
    centers = np.asarray(centers)
    is_kmers = np.issubdtype(centers.dtype, np.integer)
    if is_kmers:
        motif._check_kmers(centers, "centers")
    arr = centers.astype(np.int32 if is_kmers else np.float32)
    emb = embedding.embed_kmers(arr) if is_kmers else arr
    r = np.float32(radius)

    def per_shard(s, j, cblk, eblk):
        return ivf._search_block_hits(s, cblk, eblk, r, k_blocks,
                                      index.max_hits)

    ci, ki, dd, (n_hits, n_alive) = _search_sharded(
        index, arr, emb, center_block, per_shard, gather, 2)
    return ci, ki, dd, n_hits, n_alive


def exact_topk(db_kmers: np.ndarray, centers: np.ndarray, k: int,
               mesh: mesh_lib.Mesh):
    """Sharded brute-force top-k: per-shard exact P-table distances
    (search/exact.py) and a local top-k of min(k, rows) on each db shard,
    then a global top-k over the shards' blocks.  Center blocks are dealt
    over the data rows.

    Returns (idx (C, k) int64, dist (C, k) f32) host arrays; k is capped
    at N.
    """
    _check_local(mesh)
    db = np.asarray(db_kmers)
    n = db.shape[0]
    k = min(k, n)
    km = _local_rows(db, mesh)
    n_local = km[0].shape[0]
    ndata = mesh.shape[DATA]
    c = centers.shape[0]
    per_row = -(-c // ndata)
    out_i, out_d = [], []
    for i in range(ndata):
        blk = np.asarray(centers[i * per_row:(i + 1) * per_row], np.int32)
        if not blk.shape[0]:
            break
        merge_dev = _device.resolve(mesh.devices[i][0])
        negs, gis = [], []
        for j in range(mesh.db_local):
            dev = _device.resolve(mesh.devices[i][j])
            nr = shard_rows(n, n_local, j)
            if not nr:
                continue
            rows = km[j][:nr].to(dev)
            d2 = exact._dist_block(torch.as_tensor(blk, device=dev), rows,
                                   True)
            neg, li = torch.topk(-d2, min(k, nr), dim=1)
            negs.append(neg.to(merge_dev))
            gis.append((li + j * n_local).to(merge_dev))
        neg2, sel = torch.topk(torch.cat(negs, dim=1), k, dim=1)
        out_i.append(torch.gather(torch.cat(gis, dim=1), 1, sel).cpu().numpy())
        out_d.append(np.sqrt(np.maximum(-neg2.cpu().numpy(), 0.0)))
    return (np.concatenate(out_i).astype(np.int64),
            np.concatenate(out_d).astype(np.float32))
