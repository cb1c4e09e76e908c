"""LSH motif search (counterpart of hsearch_tpu/search/motif.py).

  build:  hash every database k-mer into hash_L tables -> sorted-code index
  probe:  hash each center (with multiprobe, the home bucket and its
          nearest boundary flips), locate its bucket in every table
  verify: exact squared distance to every deduplicated bucket member,
          emit pairs with d <= R

On the card, each center block is probed, gathered and deduplicated with
torch ops, then verified by the ``ptable_verify`` kernel
(ops/cuda_kernels.py) at block size 1: the index's k-mers are its
``db_sorted`` rows (N+1, L) int8 with ``order`` = arange(N+1), row N
being a zero sentinel that ``order < n`` masks, and the deduplicated ids
are the selected "blocks".  The kernel returns the P-table distance
sum_l P[c, l, kmer_l] in order l = 0..L-1 with the hit test applied; the
``max_hits`` top-k and the packed transfer follow as torch ops.

The verify is exact, so LSH parameters only trade recall for speed.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from .. import _device
from ..core import embedding
from ..lsh import pstable
from ..ops import compact, cuda_kernels, distance, segment


def _check_kmers(kmers: np.ndarray, what: str) -> None:
    """Reject k-mer entries outside the 20 amino-acid indices: the verify
    kernel indexes its shared-memory P-table with them unchecked."""
    if kmers.size and (kmers.min() < 0 or kmers.max() >= 20):
        raise ValueError(f"{what} must hold amino-acid indices in [0, 20); "
                         f"got values in [{kmers.min()}, {kmers.max()}]")


@dataclasses.dataclass(frozen=True)
class MotifSearchConfig:
    """Operating point; defaults follow the reference
    (motif_both_points.cpp: hash_K = hash_L = 4, W = 50, R = 200)."""

    hash_k: int = 4
    hash_l: int = 4
    w: float = 50.0
    radius: float = 200.0
    center_block: int = 128
    cand_max: int | None = None   # None -> max bucket size, capped below
    # ceiling on cand_max when it defaults to the max bucket size; centers
    # that probe a truncated bucket are counted and reported by search()
    cand_limit: int = 8192
    # per-center hit cap of the on-device compaction (nearest kept)
    max_hits: int = 256
    # buckets probed per (center, table): the home bucket plus the
    # nearest boundary flips (lsh.pstable.multiprobe_codes)
    probes: int = 1


@dataclasses.dataclass
class MotifIndex:
    """Device-resident LSH index over an integer k-mer database."""

    params: pstable.PStableParams
    tables: segment.SortedTables
    db_kmers: torch.Tensor        # (N+1, L) int8; row N is all-zero padding
    cand_max: int
    # (N+1, 1) int32 arange: the ids of db_kmers' rows when the verify
    # kernel reads them as blocks of size 1
    order: torch.Tensor = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        self.order = torch.arange(self.db_kmers.shape[0], dtype=torch.int32,
                                  device=self.db_kmers.device).view(-1, 1)

    @property
    def num_points(self) -> int:
        return self.db_kmers.shape[0] - 1

    @property
    def kmer_len(self) -> int:
        return self.db_kmers.shape[1]

    @property
    def device(self) -> torch.device:
        return self.db_kmers.device


def _padded_kmers(db_kmers: np.ndarray, dev: torch.device) -> torch.Tensor:
    km = np.asarray(db_kmers)
    _check_kmers(km, "db_kmers")
    pad = np.zeros((km.shape[0] + 1, km.shape[1]), np.int8)
    pad[:-1] = km
    return torch.as_tensor(pad, device=dev)


def build_index(db_kmers: np.ndarray, generator: torch.Generator,
                config: MotifSearchConfig = MotifSearchConfig(),
                cand_max: int | None = None,
                params: pstable.PStableParams | None = None,
                device: str | torch.device = "cuda") -> MotifIndex:
    """Hash and sort the database into a MotifIndex.

    ``generator`` (a CPU torch.Generator) draws the LSH parameters unless
    ``params`` carries them (for instance the JAX package's, through
    ``pstable.params_from_arrays``).
    """
    dev = _device.resolve(device)
    n, l = db_kmers.shape
    if params is None:
        params = pstable.init(generator, l * embedding.AA_DIM,
                              config.hash_k, config.hash_l, config.w)
    params = params.to(dev)
    padded = _padded_kmers(db_kmers, dev)
    codes = pstable.hash_codes(padded[:n], params, is_kmers=True)
    tables = segment.build_tables(codes)
    del codes
    cm = cand_max if cand_max is not None else config.cand_max
    if cm is None:
        cm = min(segment.max_bucket_size(tables.sorted_codes),
                 config.cand_limit)
    return MotifIndex(params=params, tables=tables, db_kmers=padded,
                      cand_max=int(cm))


def index_from_arrays(a: np.ndarray, b: np.ndarray, w: float,
                      pack_bits: int, sorted_codes: np.ndarray,
                      perm: np.ndarray, db_kmers: np.ndarray,
                      cand_max: int,
                      device: str | torch.device = "cuda") -> MotifIndex:
    """A MotifIndex from the JAX index's arrays as numpy (its ``.npz`` or
    ``np.asarray`` of its fields).  ``db_kmers`` is the padded (N+1, L)
    array with the zero sentinel row."""
    dev = _device.resolve(device)
    km = np.asarray(db_kmers)
    _check_kmers(km, "db_kmers")
    return MotifIndex(
        params=pstable.params_from_arrays(a, b, w, pack_bits, dev),
        tables=segment.SortedTables(
            sorted_codes=torch.as_tensor(np.array(sorted_codes, np.int32),
                                         device=dev),
            perm=torch.as_tensor(np.array(perm, np.int32), device=dev)),
        db_kmers=torch.as_tensor(km.astype(np.int8), device=dev),
        cand_max=int(cand_max))


def _center_ptables(centers: torch.Tensor, kmer_len: int) -> torch.Tensor:
    """(C, L) int or (C, 8L) float centers -> (C, L, 20) P-tables.

    P[c, l, aa] = squared distance between the center's l-th 8-dim slice
    and the coordinates of amino acid ``aa``; for integer centers this is
    exactly DISTANCE_SQUARE[center_l, aa] (in float32).
    """
    dev = centers.device
    if not torch.is_floating_point(centers):
        dsq = distance.const("dsq", dev)
        return dsq[centers.long()]                               # (C, L, 20)
    coords = distance.const("coords", dev)                      # (20, 8)
    c = centers.shape[0]
    x = centers.to(torch.float32).reshape(c, kmer_len, embedding.AA_DIM)
    diff = x[:, :, None, :] - coords[None, None, :, :]           # (C, L, 20, 8)
    return torch.sum(diff * diff, dim=-1)


def _query_codes(index: MotifIndex, centers: torch.Tensor, is_kmers: bool,
                 probes: int) -> torch.Tensor:
    """(C, T) or, with multiprobe, (C, T, P) query codes."""
    if probes > 1:
        return pstable.multiprobe_codes(centers, index.params, is_kmers,
                                        probes).permute(1, 0, 2)
    return pstable.hash_codes(centers, index.params, is_kmers).T


def _candidates(index: MotifIndex, qcodes: torch.Tensor, cand_max: int):
    """Probe all tables, gather up to cand_max ids per bucket, dedup.

    Returns (ids (C, M) int64 with sentinel N, n_dropped (C,) int32: the
    candidates each center lost to cand_max, its observable bucket skew).
    """
    start, count = segment.probe(index.tables, qcodes)
    over = torch.clamp_min(count - cand_max, 0)
    n_dropped = over.reshape(over.shape[0], -1).sum(dim=1).to(torch.int32)
    count = torch.clamp_max(count, cand_max)
    ids = segment.gather_candidates(index.tables, start, count, cand_max)
    return segment.dedup_sorted(ids, sentinel=index.num_points), n_dropped


def _probe_verify(index: MotifIndex, centers: torch.Tensor,
                  qcodes: torch.Tensor, r2: float, cand_max: int,
                  max_hits: int = 256):
    """One center block: probe all tables, dedup, exact-verify, compact.

    Returns (packed flat int32 buffer in the ops/compact layout with
    meta = [n_hits (C), n_dropped (C)]; ids (C, k) sentinel-N and d2
    (C, k), the lossless fallback on packed-capacity overflow).  Nothing
    here waits for the device.
    """
    n = index.num_points
    ids, n_dropped = _candidates(index, qcodes, cand_max)
    # the verify kernel at block size 1: a dead "block" is a sentinel id
    neg = torch.where(ids < n, 0.0, float("inf"))
    ptab = _center_ptables(centers, index.kmer_len)
    d2m, n_hits = cuda_kernels.ptable_verify(ptab, index.db_kmers,
                                             index.order, ids, neg, r2, n)
    negd, sel = torch.topk(-d2m, min(max_hits, d2m.shape[1]), dim=1)
    found = torch.isfinite(negd)
    hit_ids = torch.where(found, torch.gather(ids, 1, sel), n)
    hit_d2 = -negd
    packed = compact.pack_hits(hit_ids, hit_d2, n,
                               meta_vecs=(n_hits, n_dropped))
    return packed, hit_ids, hit_d2


def search_protein_db(db, centers: np.ndarray, generator: torch.Generator,
                      config: MotifSearchConfig = MotifSearchConfig(),
                      kmer_len: int | None = None,
                      device: str | torch.device = "cuda"):
    """Best (center, distance) per database position (the reference's
    kmer_search semantic).

    db: core.io.ProteinDB.  Returns (best_center (P,) int32 with -1 for
    no hit, best_dist (P,) f32) over all valid k-mer positions, plus the
    (P,) flat position array.
    """
    from ..core import alphabet
    l = kmer_len or centers.shape[1]
    seq = np.asarray(db.seq)
    starts = np.asarray(db.starts)
    wins = alphabet.kmer_view(seq.astype(np.int64), l)
    pos = np.arange(len(wins))
    pid = np.searchsorted(starts, pos, side="right") - 1
    ok = (pos + l <= starts[pid + 1]) & (wins < 20).all(axis=1)
    km = wins[ok].astype(np.int32)
    positions = pos[ok]
    index = build_index(km, generator, config, device=device)
    ci, ki, dd = search(index, centers, config)
    best_center = np.full(len(km), -1, np.int32)
    best_dist = np.full(len(km), np.inf, np.float32)
    if len(ki):
        # per-kmer argmin: sort hits by (kmer, distance), keep each first
        order = np.lexsort((dd, ki))
        ks, ds, cs = ki[order], dd[order], ci[order]
        first = np.concatenate([[True], ks[1:] != ks[:-1]])
        best_dist[ks[first]] = ds[first]
        best_center[ks[first]] = cs[first]
    return best_center, best_dist, positions


def search(index: MotifIndex, centers: np.ndarray,
           config: MotifSearchConfig = MotifSearchConfig(),
           stats_out: dict | None = None):
    """LSH search on the index's device: all (center, kmer) pairs found in
    the probed buckets with exact distance <= radius.

    centers: (C, L) int k-mers or (C, 8L) real points.  Returns
    (center_idx, kmer_idx, dist) host arrays.  Centers whose hits exceed
    ``max_hits`` (nearest kept) or whose probed buckets exceed cand_max
    (candidates truncated) are counted: into ``stats_out`` as
    ``truncated`` / ``skewed`` when given, else as warnings.
    """
    centers = np.asarray(centers)
    is_kmers = np.issubdtype(centers.dtype, np.integer)
    if is_kmers:
        _check_kmers(centers, "centers")
    dev = index.device
    # R*R in double, then rounded to float32, as the JAX package does
    r2 = float(np.float32(config.radius * config.radius))
    cb = config.center_block
    n = index.num_points
    c_total = centers.shape[0]
    # pad to whole center blocks and upload once: a host->device copy in
    # the dispatch loop would wait for the blocks already queued
    pad_total = (-c_total) % cb
    cpad = np.pad(centers.astype(np.int32 if is_kmers else np.float32),
                  ((0, pad_total),) + ((0, 0),) * (centers.ndim - 1))
    cdev = torch.as_tensor(cpad, device=dev)
    ci_all, ki_all, dd_all = [], [], []
    truncated = skewed = 0
    # two passes: queue every center block, then harvest, so block i's
    # device->host copy overlaps the device work of the later blocks
    pending = []
    for s in range(0, c_total, cb):
        cblk = cdev[s:s + cb]
        qcodes = _query_codes(index, cblk, is_kmers, config.probes)
        pending.append((s, min(cb, c_total - s), _probe_verify(
            index, cblk, qcodes, r2, index.cand_max, config.max_hits)))
    for s, real, (packed, hit_ids, d2) in pending:
        hits, (n_hits, n_dropped) = compact.unpack_hits(
            packed.cpu().numpy(), (cb, cb))
        truncated += int((n_hits[:real] > config.max_hits).sum())
        skewed += int((n_dropped[:real] > 0).sum())
        if hits is not None:
            hc0, hk0, hd0 = hits
            keep = hc0 < real                  # drop padding-center rows
            hc = hc0[keep].astype(np.int64)
            hk = hk0[keep].astype(np.int64)
            hd = hd0[keep]
        else:
            # packed capacity overflowed: the full buffers transfer now
            idsh = hit_ids.cpu().numpy().copy()
            d2h = d2.cpu().numpy()
            idsh[real:, :] = n
            hc, hm = np.nonzero(idsh < n)
            hk = idsh[hc, hm].astype(np.int64)
            hd = d2h[hc, hm]
        ci_all.append(hc + s)
        ki_all.append(hk)
        dd_all.append(np.sqrt(np.maximum(hd, 0.0)))
    if stats_out is not None:
        stats_out["truncated"] = truncated
        stats_out["skewed"] = skewed
    else:
        if truncated:
            warnings.warn(
                f"{truncated} centers exceeded max_hits={config.max_hits}; "
                "nearest hits kept, raise config.max_hits for the full set")
        if skewed:
            warnings.warn(
                f"{skewed} centers probed buckets larger than cand_max="
                f"{index.cand_max} (bucket skew); their candidate lists "
                "were truncated — raise cand_max/cand_limit or dedup the "
                "database for the full set")
    if not ci_all:
        return (np.empty(0, np.int64), np.empty(0, np.int64),
                np.empty(0, np.float32))
    return (np.concatenate(ci_all), np.concatenate(ki_all),
            np.concatenate(dd_all).astype(np.float32))
