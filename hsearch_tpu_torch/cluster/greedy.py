"""Greedy center-based k-mer clustering, hclust2/hclust3 (counterpart of
hsearch_tpu/cluster/greedy.py).

Reference semantics (hclust2.cpp:86-152; hclust3 is the same algorithm):

  state per k-mer: 0 = unprocessed, 1 = center, 2 = absorbed
  for each of hash_L rounds: hash all non-absorbed k-mers with a fresh
  single-table LSH; within each bucket, walk members in order — an
  unprocessed point joins the FIRST candidate center within R (candidate
  list = already-centers in bucket order, then points promoted earlier in
  this bucket's walk); otherwise it is promoted to candidate itself.

Each point lands in exactly one bucket per round, so buckets are
independent within a round and every election reads the round-start
state.  On the device:

  hash      -> fused gather-sum projection + packed codes (lsh/pstable.py)
  bucketing -> stable sort of the codes, then size-classed bucket rows
               (widths 4, 16, 64, ..., bucket_max) built by scatter
  walk      -> "first-fit leader election" over the B bucket positions of
               each row, with the (rows, B, B) in-bucket distances from
               one batched norm-identity GEMM in full float32: on the
               card one launch of the ``elect`` CUDA kernel per slab
               (csrc/elect.cu, one block per row), on the CPU
               ``_elect_plain``, a loop over the positions on (rows, B)
               tensors
  update    -> parent / state scatters; slot N absorbs the padding's.

``_elect_reference`` encodes the reference walk directly and is the
parity oracle of the election; ``_elect_plain`` is the kernel's plain
version.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .. import _device
from ..core import embedding
from ..lsh import pstable
from ..ops import cuda_kernels, distance


@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    """Defaults follow hclust2.cpp:185-194."""

    hash_k: int = 16
    hash_l: int = 32
    w: float = 50.0
    radius: float = 200.0
    bucket_max: int = 256     # buckets larger than this are chunked
    # the JAX package's scan step (widest-class buckets per step); kept
    # for its signature: here each slab is elected in one batch
    bucket_chunk: int = 32
    slab_elems: int = 1 << 20  # id slots per device dispatch


# ---------------------------------------------------------------------------
# leader election
# ---------------------------------------------------------------------------

def _elect_reference(d: np.ndarray, state: np.ndarray, valid: np.ndarray,
                     radius: float) -> np.ndarray:
    """Sequential in-bucket walk (hclust2.cpp:107-132). Parity oracle.

    d: (B, B) distances; state: (B,) 0/1; valid: (B,) padding mask.
    Returns parent_local: (B,) index of the absorbing member, or -1.
    """
    b = d.shape[0]
    pre = [j for j in range(b) if valid[j] and state[j] == 1]
    promoted: list[int] = []
    parent = np.full(b, -1, np.int64)
    for p in range(b):
        if not valid[p] or state[p] != 0:
            continue
        hit = -1
        for j in pre + promoted:
            if d[p, j] <= radius:
                hit = j
                break
        if hit >= 0:
            parent[p] = hit
        else:
            promoted.append(p)
    return parent


def _elect_device(d: torch.Tensor, state: torch.Tensor, valid: torch.Tensor,
                  radius: float) -> torch.Tensor:
    """Batched first-fit leader election: ``_elect_plain`` on the CPU, one
    launch of the CUDA kernel on the card (``cuda_kernels.elect``)."""
    return cuda_kernels.elect(d, state, valid, radius)


def _elect_plain(d: torch.Tensor, state: torch.Tensor, valid: torch.Tensor,
                 radius: float) -> torch.Tensor:
    """Batched first-fit leader election as a host loop over the B
    positions.

    d: (NB, B, B) distances, state: (NB, B) 0/1, valid: (NB, B) bool.
    Matching priority = pre-existing centers in bucket order, then
    promoted points in promotion (= bucket) order: key_j = pos_j + B *
    promoted_j.  Returns (NB, B) int64 parent slots, -1 where none.
    """
    nb, b, _ = d.shape
    r = float(np.float32(radius))
    pos = torch.arange(b, dtype=torch.int64, device=d.device)
    pre = (state == 1) & valid
    key_base = torch.where(pre, pos, pos + b)            # (NB, B)
    unproc = (state == 0) & valid
    avail = pre.clone()
    parents = torch.empty((nb, b), dtype=torch.int64, device=d.device)
    for p in range(b):
        match = avail & (d[:, p, :] <= r)
        kmin, best = torch.min(torch.where(match, key_base, 2 * b), dim=1)
        any_match = kmin < 2 * b
        parents[:, p] = torch.where(unproc[:, p] & any_match, best, -1)
        avail[:, p] |= unproc[:, p] & ~any_match
    return parents


def _bucket_distances(bucket_kmers: torch.Tensor) -> torch.Tensor:
    """(NB, B, L) int k-mers -> (NB, B, B) exact distances (not squared),
    by the norm identity ||a||^2 + ||b||^2 - 2 a.b on the embedded points,
    as the JAX package computes them."""
    nb, b, l = bucket_kmers.shape
    coords = distance.const("coords", bucket_kmers.device)
    emb = coords[bucket_kmers.long()].reshape(nb, b, l * coords.shape[1])
    sq = torch.sum(emb * emb, dim=-1)
    d2 = sq[:, :, None] + sq[:, None, :] - 2.0 * torch.bmm(
        emb, emb.transpose(1, 2))
    return torch.sqrt(torch.clamp_min(d2, 0.0))


# ---------------------------------------------------------------------------
# bucketing
# ---------------------------------------------------------------------------

def _class_sizes(bucket_max: int) -> tuple[int, ...]:
    """Pow-4 bucket-width ladder up to bucket_max, e.g. (4, 16, 64, 256)."""
    cs = []
    c = 4
    while c < bucket_max:
        cs.append(c)
        c *= 4
    cs.append(bucket_max)
    return tuple(cs)


def _starts(x: torch.Tensor) -> torch.Tensor:
    """Run starts of a sorted 1-D tensor: True where x[i] != x[i-1]."""
    new = torch.ones_like(x, dtype=torch.bool)
    new[1:] = x[1:] != x[:-1]
    return new


def _bucket_class_matrices(codes: torch.Tensor, active_ids: torch.Tensor,
                           bucket_max: int, n_sentinel: int):
    """Group active ids into per-bucket rows, padded to the nearest size
    class instead of uniformly to bucket_max, on the tensors' device.

    codes (A,) int32 and active_ids (A,) int64 of the active points.
    Returns [(ids int64 (NB_c, C), valid bool)] per size class C.  Class
    padding bounds the overhead at <4x the member count.  Ordering
    matches the reference walk (hclust2.cpp:107-132): buckets ascend by
    code, members ascend by id within a bucket (a stable sort over ids
    given in ascending order); buckets larger than bucket_max are chunked
    into full rows plus a remainder row (rows with <2 members are
    dropped — nothing to absorb).  The layout is the JAX package's
    ``_bucket_class_matrices``, element for element."""
    dev = codes.device
    sc, order = torch.sort(codes, stable=True)
    sid = active_ids[order]
    if sid.numel() == 0:
        return []
    grp = torch.cumsum(_starts(sc).long(), 0) - 1
    keep = torch.bincount(grp)[grp] >= 2   # singletons absorb nothing
    sid, grp = sid[keep], grp[keep]
    if sid.numel() == 0:
        return []
    grp = torch.cumsum(_starts(grp).long(), 0) - 1         # renumber densely
    counts = torch.bincount(grp)
    gstart = torch.cumsum(counts, 0) - counts
    rank = torch.arange(sid.numel(), device=dev) - gstart[grp]
    classes = torch.tensor(_class_sizes(bucket_max), device=dev)
    full_rows = counts // bucket_max
    rem = counts - full_rows * bucket_max
    in_full = rank < full_rows[grp] * bucket_max
    has_rem = rem >= 2
    cls = torch.where(has_rem, classes[torch.clamp_max(
        torch.searchsorted(classes, rem), len(classes) - 1)], 0)
    row_base = torch.cumsum(full_rows, 0) - full_rows
    nfull_all = int(full_rows.sum())
    out = []
    for c in _class_sizes(bucket_max):
        rbuck = torch.nonzero(cls == c)[:, 0]
        nfull = nfull_all if c == bucket_max else 0
        nrows = nfull + rbuck.numel()
        if nrows == 0:
            continue
        ids = torch.full((nrows, c), n_sentinel, dtype=torch.int64,
                         device=dev)
        if nfull:
            m = in_full
            ids[row_base[grp[m]] + rank[m] // c, rank[m] % c] = sid[m]
        if rbuck.numel():
            row_of = torch.full((counts.numel(),), -1, dtype=torch.int64,
                                device=dev)
            row_of[rbuck] = nfull + torch.arange(rbuck.numel(), device=dev)
            m = ~in_full & (cls[grp] == c)
            ids[row_of[grp[m]],
                rank[m] - full_rows[grp[m]] * bucket_max] = sid[m]
        out.append((ids, ids < n_sentinel))
    return out


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ClusterResult:
    parent: np.ndarray    # (N,) absorbing point id, or -1 for cluster heads
    merged: np.ndarray    # (N,) final state 0/1/2

    def clusters(self) -> list[np.ndarray]:
        """Cluster member lists, head first (hclust2.cpp:137-150 order)."""
        heads = np.nonzero(self.merged != 2)[0]
        child = np.nonzero(self.parent >= 0)[0]
        par = self.parent[child]
        order = np.argsort(par, kind="stable")   # ids ascend within head
        child, par = child[order], par[order]
        pieces = np.split(child, np.searchsorted(par, heads[1:]))
        return [np.concatenate([[h], c]) if len(c) else
                np.asarray([h], np.int64)
                for h, c in zip(heads, pieces)]


def _round_params(rnd: int, generator: torch.Generator, dim: int,
                  config: ClusterConfig, round_params, dev: torch.device
                  ) -> pstable.PStableParams:
    """Round ``rnd``'s single-table LSH: drawn from ``generator``, or the
    given (a, b) pair (for instance the JAX package's draw)."""
    if round_params is None:
        return pstable.init(generator, dim, config.hash_k, 1, config.w, dev)
    a, b = round_params[rnd]
    return pstable.params_from_arrays(
        np.reshape(a, (1, dim, config.hash_k)),
        np.reshape(b, (1, config.hash_k)), config.w, device=dev)


def _elect_rows(km_pad: torch.Tensor, state_pad: torch.Tensor,
                ids: torch.Tensor, valid: torch.Tensor, radius: float):
    """The elections of one slab of bucket rows against the round-start
    state: (rows, B) int64 parent slots (-1 where none).  ``valid`` may
    be a strided view (a process's rows r % nproc == pid); the kernel
    reads it contiguous."""
    state = torch.where(valid, state_pad[ids], 2)
    return _elect_device(_bucket_distances(km_pad[ids]), state,
                         valid.contiguous(), radius)


def _elect_edges(km_pad: torch.Tensor, state_pad: torch.Tensor, mats,
                 config: ClusterConfig, pid: int = 0, nproc: int = 1):
    """One round's elections over the bucket rows r with r % nproc == pid
    of each size class, in slabs of ``config.slab_elems`` id slots, all
    against the round-start state: flat (absorbed, absorber) int64
    tensors, the sentinel N (the padding slot) where nothing was
    absorbed."""
    n = km_pad.shape[0] - 1
    absorbed, absorber = [], []
    for ids, valid in mats:
        ids, valid = ids[pid::nproc], valid[pid::nproc]
        rows = max(1, config.slab_elems // ids.shape[1])
        for s in range(0, ids.shape[0], rows):
            bids = ids[s:s + rows]
            par = _elect_rows(km_pad, state_pad, bids, valid[s:s + rows],
                              config.radius)
            hit = par >= 0
            absorbed.append(torch.where(hit, bids, n).reshape(-1))
            absorber.append(torch.where(
                hit, torch.gather(bids, 1, torch.clamp_min(par, 0)),
                n).reshape(-1))
    if not absorbed:
        empty = torch.zeros(0, dtype=torch.int64, device=km_pad.device)
        return empty, empty
    return torch.cat(absorbed), torch.cat(absorber)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def cluster_greedy(kmers: np.ndarray, generator: torch.Generator | None,
                   config: ClusterConfig = ClusterConfig(),
                   round_params=None,
                   device: str | torch.device = "cuda",
                   stats_out: dict | None = None) -> ClusterResult:
    """Run hash_L greedy rounds over the (N, L) k-mer set.

    Each round draws a single-table LSH from ``generator`` (a CPU
    torch.Generator), or takes ``round_params[rnd]``, an (a, b) numpy pair
    of shapes (D, K) / (K,) or (1, D, K) / (1, K).  Every round runs on
    the device: hashing, grouping, elections, and the parent/state
    updates; parent and state reach the host once, at the end.

    ``stats_out`` receives the seconds spent over all rounds in hashing,
    grouping and elections (the device is synchronised at each stage's
    end for the count), and the bucket rows elected.
    """
    dev = _device.resolve(device)
    kmers = np.asarray(kmers)
    n, l = kmers.shape
    dim = l * embedding.AA_DIM
    km_pad = torch.zeros((n + 1, l), dtype=torch.int8, device=dev)
    km_pad[:n] = torch.as_tensor(kmers.astype(np.int8), device=dev)
    # slot N takes the updates of padding slots; it reads "absorbed"
    merged = torch.zeros(n + 1, dtype=torch.uint8, device=dev)
    merged[n] = 2
    parent = torch.full((n + 1,), -1, dtype=torch.int64, device=dev)
    secs = {"hash_s": 0.0, "group_s": 0.0, "elect_s": 0.0}
    n_rows = 0
    timed = stats_out is not None
    for rnd in range(config.hash_l):
        t0 = time.perf_counter()
        params = _round_params(rnd, generator, dim, config, round_params,
                               dev)
        codes = pstable.hash_codes(km_pad[:n], params, is_kmers=True)[0]
        if timed:
            _sync(dev)
        t1 = time.perf_counter()
        active_ids = torch.nonzero(merged[:n] != 2)[:, 0]
        mats = _bucket_class_matrices(codes[active_ids], active_ids,
                                      config.bucket_max, n)
        if timed:
            _sync(dev)
        t2 = time.perf_counter()
        secs["hash_s"] += t1 - t0
        secs["group_s"] += t2 - t1
        if not mats:
            continue
        n_rows += sum(ids.shape[0] for ids, _ in mats)
        # buckets are disjoint within a round, so every election reads the
        # round-start state, and the absorbed and absorber sets of a round
        # are disjoint
        absorbed, absorber = _elect_edges(km_pad, merged.clone(), mats,
                                          config)
        parent[absorbed] = absorber
        merged[absorbed] = 2
        # "to be the real center" (hclust2.cpp:122)
        merged[absorber] = 1
        merged[n] = 2
        parent[n] = -1
        if timed:
            _sync(dev)
        secs["elect_s"] += time.perf_counter() - t2
    if stats_out is not None:
        stats_out.update(secs, bucket_rows=n_rows)
    return ClusterResult(parent=parent[:n].cpu().numpy(),
                         merged=merged[:n].cpu().numpy())
