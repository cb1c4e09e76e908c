"""Host passes of the aligner: the numpy twins of the port's C++ host
library, and the probe passes as torch ops.

The main path runs these passes through ``hsearch_tpu_torch.native_ext``
(csrc/hostops.cpp, OpenMP): ``searchsorted_right``, ``argsort_u64``,
``argsort_u32``, ``seed_codes``, ``probe_sorted``, ``pair_prep``,
``align_gapped``.  The numpy versions here are their plain versions: the
same results, single-threaded, which the tests hold the library bitwise
equal to.

On a CUDA device the seed probe and the pair preparation dominated a
pcluster run on the host (118 of 142 s at 100,000 proteins on an H100
host), so they also run on the card: ``bucket_counts_torch``,
``probe_sorted_torch`` and ``pair_prep_torch`` are the same passes as
torch ops on the device of their inputs (int64 keys: the uint64
composite keys stay below 2^63; stable sorts), bitwise equal to the
numpy versions, which stay their plain versions.

Also here: the seed geometry the passes share (``seed_index`` re-exports
it) and the same-diagonal run collapse of the pair preparation.
"""

from __future__ import annotations

import numpy as np
import torch

MER = 6           # m_unMer (hash_search.cpp:31)
SUFFIX = 4        # narrowing residues after the 6-mer (:212-248)
NARROW = 3        # suffix residues packed into the sorted code
SEED_LEN = MER + SUFFIX   # unLocalSeed = 10 (:330)
PAD = 15          # past-end nibble (ONEBYTE padding, :466-468)
G10_PASS = 15     # "subject has no 4th suffix residue": matches anything


def searchsorted_right(a: np.ndarray, q: np.ndarray) -> np.ndarray:
    """np.searchsorted(a, q, side="right") over int64."""
    return np.searchsorted(np.asarray(a, np.int64), np.asarray(q, np.int64),
                           side="right")


def argsort_u64(keys: np.ndarray) -> np.ndarray:
    """Stable argsort of uint64 keys (int64 order)."""
    return np.argsort(np.asarray(keys, np.uint64), kind="stable")


def argsort_u32(keys: np.ndarray) -> np.ndarray:
    """Stable argsort of uint32 keys -> int32 order (n < 2^31)."""
    keys = np.asarray(keys, np.uint32)
    if len(keys) >= (1 << 31):
        raise ValueError("argsort_u32 requires n < 2^31")
    return np.argsort(keys, kind="stable").astype(np.int32)


def host_codes_np(seq: np.ndarray, starts: np.ndarray,
                  group21: np.ndarray):
    """Per position: (code uint32, valid6, valid10, qgrp10 int32).

    code = murphy10 6-mer key * 16^3 + 3 suffix nibbles (PAD past the
    owning sequence's end); valid6 is the db-side rule (a valid 6-mer),
    valid10 the query-side rule (all 10 seed residues valid and
    in-sequence); qgrp10 the group at seed position + 9."""
    seq = np.asarray(seq)
    starts = np.asarray(starts)
    s = len(seq)
    g = group21[np.minimum(seq, 20)]
    idx = np.arange(s)
    pid = np.searchsorted(starts, idx, side="right") - 1
    seq_end = starts[pid + 1] if s else np.zeros(0, np.int64)

    def shifted(i):
        # length-s always, even when the whole sequence is shorter than
        # the shift (unpadded queries may be shorter than one seed)
        return np.concatenate(
            [g[i:], np.full(min(i, s), 10, g.dtype)]) if i else g

    key = np.zeros(s, np.int64)
    valid6 = np.ones(s, bool)
    for i in range(MER):
        gg = shifted(i)
        key = key * 10 + gg
        valid6 &= (gg < 10) & (idx + i < seq_end)
    code = key.astype(np.uint32) * np.uint32(16 ** NARROW)
    for i in range(NARROW):
        gg = shifted(MER + i)
        in_seq = idx + MER + i < seq_end
        nib = np.where(in_seq, gg, PAD).astype(np.uint32)
        code = code + nib * np.uint32(16 ** (NARROW - 1 - i))
    valid10 = valid6.copy()
    for i in range(MER, SEED_LEN):           # query needs all 10 residues
        gg = shifted(i)
        valid10 &= (gg < 10) & (idx + i < seq_end)
    off = MER + NARROW
    qgrp10 = np.concatenate(
        [g[off:], np.full(min(off, s), 10, g.dtype)]).astype(np.int32)
    return code, valid6, valid10, qgrp10


def g10_table(seq: np.ndarray, starts: np.ndarray,
              group21: np.ndarray) -> np.ndarray:
    """(S,) int8: group of the 4th suffix residue at each position, or
    G10_PASS where that residue falls past the owning sequence."""
    seq = np.asarray(seq)
    starts = np.asarray(starts)
    s = len(seq)
    pid = np.searchsorted(starts, np.arange(s), side="right") - 1
    seq_end = starts[pid + 1]
    idx9 = np.arange(s) + MER + NARROW
    g = group21[np.minimum(seq, 20)]
    out = np.full(s, G10_PASS, np.int8)
    m = idx9 < seq_end
    out[m] = g[idx9[m]]
    return out


def seed_codes(seq: np.ndarray, starts: np.ndarray, group21: np.ndarray):
    """(code, valid6, valid10, qgrp10, g10) of every position."""
    code, v6, v10, qg = host_codes_np(seq, starts, group21)
    return code, v6, v10, qg, g10_table(seq, starts, group21)


def probe_sorted(keys: np.ndarray, positions: np.ndarray,
                 qkeys: np.ndarray, g10_at: np.ndarray, qgrp10: np.ndarray,
                 cand_max: int):
    """Sorted-range probe with the 4th-suffix-group filter: every
    position whose key equals a probe key (the first cand_max of each
    bucket), as (rows, dpos, n_over), pairs in (row, bucket) order."""
    lo = np.searchsorted(keys, qkeys, side="left")
    hi = np.searchsorted(keys, qkeys, side="right")
    cnt = hi - lo
    n_over = int(np.sum(cnt > cand_max))
    cnt = np.minimum(cnt, cand_max)
    total = int(cnt.sum())
    if total == 0:
        return (np.zeros(0, np.int64), np.zeros(0, np.int64), n_over)
    rows = np.repeat(np.arange(len(qkeys), dtype=np.int64), cnt)
    first = np.cumsum(cnt) - cnt
    offs = np.arange(total, dtype=np.int64) - np.repeat(first, cnt)
    ids = positions[np.repeat(lo, cnt) + offs]
    g10 = g10_at[ids]
    ok = (g10 == G10_PASS) | (g10 == np.asarray(qgrp10)[rows])
    return rows[ok], ids[ok], n_over


def collapse_diag_runs(qpos, dpos, qpid, dpid, tol: int,
                       argsort=argsort_u64):
    """Keep one seed per same-diagonal run.

    Seeds of one (query, subject) pair on the same diagonal whose query
    positions step by <= tol sit inside one exact-match region: the
    extension from any of them reaches the same HSP, and assembly dedups
    identical extents.  Returns a keep-index into the inputs (sorted by
    (qpid, dpid, diag, qpos), one stable ``argsort`` of uint64 keys per
    composite key: numpy's here, the library's radix on the main
    path)."""
    qpos = qpos.astype(np.int64)
    dpos = dpos.astype(np.int64)
    s = int(max(qpos.max(), dpos.max())) + 1 if len(qpos) else 1
    diag = qpos - dpos
    k1 = qpid.astype(np.int64) * (int(dpid.max()) + 1 if len(dpid) else 1) \
        + dpid
    k2 = (diag + s) * s + qpos
    # both keys are nonnegative, so int64 bit patterns order as uint64
    o1 = argsort(k2.view(np.uint64))
    order = o1[argsort(np.ascontiguousarray(k1[o1]).view(np.uint64))]
    q = qpos[order]
    k1s, dgs = k1[order], diag[order]
    new_run = np.ones(len(q), bool)
    if len(q) > 1:
        same = (k1s[1:] == k1s[:-1]) & (dgs[1:] == dgs[:-1])
        close = (q[1:] - q[:-1]) <= tol
        new_run[1:] = ~(same & close)
    return order[new_run]


def pair_prep(rows: np.ndarray, dpos: np.ndarray, qidx: np.ndarray,
              starts: np.ndarray, gids: np.ndarray,
              exclude: np.ndarray | None, tol: int):
    """Probe pairs -> (six (6, n) int32 [qpos, dpos, qlo, qhi, dlo, dhi],
    qpid, dpid): the qpos gather, protein-id lookups, the full-seed
    subject filter (hash_search.cpp:538-540), the sorted-exclude-key
    filter, the same-diagonal run collapse (tol > 0) and the packed
    extension layout, survivors in ascending pair order."""
    qpos = qidx[rows]
    dpid = searchsorted_right(starts, dpos) - 1
    ok = starts[dpid + 1] - dpos >= SEED_LEN
    qpos, dpos, dpid = qpos[ok], dpos[ok], dpid[ok]
    qpid = searchsorted_right(starts, qpos) - 1
    if exclude is not None and len(qpos):
        pk = (gids[qpid].astype(np.uint64) << np.uint64(32)) \
            | gids[dpid].astype(np.uint64)
        at = np.searchsorted(exclude, pk)
        at = np.minimum(at, max(len(exclude) - 1, 0))
        known = (exclude[at] == pk) if len(exclude) \
            else np.zeros(len(pk), bool)
        qpos, dpos = qpos[~known], dpos[~known]
        qpid, dpid = qpid[~known], dpid[~known]
    if tol and len(qpos):
        keep = collapse_diag_runs(qpos, dpos, qpid, dpid, tol)
        keep.sort()    # keep qpos ascending for slicing
        qpos, dpos = qpos[keep], dpos[keep]
        qpid, dpid = qpid[keep], dpid[keep]
    six = np.empty((6, len(qpos)), np.int32)
    for i, arr in enumerate((qpos, dpos, starts[qpid], starts[qpid + 1],
                             starts[dpid], starts[dpid + 1])):
        six[i] = arr
    return six, qpid, dpid


def bucket_counts_torch(keys: torch.Tensor, qkeys: torch.Tensor,
                        cand_max: int) -> torch.Tensor:
    """Capped bucket size of each probe key (int64 tensors, ``keys``
    sorted): ``seed_index.bucket_counts``'s pass."""
    hi = torch.searchsorted(keys, qkeys, right=True)
    lo = torch.searchsorted(keys, qkeys, right=False)
    return (hi - lo).clamp(max=cand_max)


def probe_sorted_torch(keys: torch.Tensor, positions: torch.Tensor,
                       qkeys: torch.Tensor, g10_at: torch.Tensor,
                       qgrp10: torch.Tensor, cand_max: int):
    """``probe_sorted`` as torch ops: (rows, dpos, n_over) with rows and
    dpos int64 tensors on the device of the inputs."""
    dev = qkeys.device
    lo = torch.searchsorted(keys, qkeys, right=False)
    cnt = torch.searchsorted(keys, qkeys, right=True) - lo
    n_over = int((cnt > cand_max).sum())
    cnt = cnt.clamp(max=cand_max)
    total = int(cnt.sum())
    if total == 0:
        z = torch.zeros(0, dtype=torch.int64, device=dev)
        return z, z, n_over
    rows = torch.repeat_interleave(
        torch.arange(len(qkeys), device=dev), cnt, output_size=total)
    first = torch.cumsum(cnt, 0) - cnt
    offs = torch.arange(total, device=dev) \
        - torch.repeat_interleave(first, cnt, output_size=total)
    ids = positions[torch.repeat_interleave(lo, cnt, output_size=total)
                    + offs]
    g10 = g10_at[ids].long()
    ok = (g10 == G10_PASS) | (g10 == qgrp10.long()[rows])
    return rows[ok], ids[ok], n_over


def collapse_diag_runs_torch(qpos, dpos, qpid, dpid, tol: int):
    """``collapse_diag_runs`` as torch ops (stable sorts on the same
    nonnegative int64 keys)."""
    s = int(torch.maximum(qpos.max(), dpos.max())) + 1
    diag = qpos - dpos
    k1 = qpid * (int(dpid.max()) + 1) + dpid
    k2 = (diag + s) * s + qpos
    o1 = torch.sort(k2, stable=True).indices
    order = o1[torch.sort(k1[o1], stable=True).indices]
    q = qpos[order]
    k1s, dgs = k1[order], diag[order]
    new_run = torch.ones(len(q), dtype=torch.bool, device=q.device)
    new_run[1:] = ~((k1s[1:] == k1s[:-1]) & (dgs[1:] == dgs[:-1])
                    & (q[1:] - q[:-1] <= tol))
    return order[new_run]


def pair_prep_torch(rows: torch.Tensor, dpos: torch.Tensor,
                    qidx: torch.Tensor, starts: torch.Tensor,
                    gids: torch.Tensor, exclude: torch.Tensor | None,
                    tol: int):
    """``pair_prep`` as torch ops on int64 tensors (``exclude``: the
    sorted uint64 keys as int64): (six (6, n) int32, qpid, dpid) on the
    device of the inputs."""
    qpos = qidx[rows]
    dpid = torch.searchsorted(starts, dpos, right=True) - 1
    ok = starts[dpid + 1] - dpos >= SEED_LEN
    qpos, dpos, dpid = qpos[ok], dpos[ok], dpid[ok]
    qpid = torch.searchsorted(starts, qpos, right=True) - 1
    if exclude is not None and len(qpos):
        pk = (gids[qpid] << 32) | gids[dpid]
        if len(exclude):
            at = torch.searchsorted(exclude, pk).clamp(max=len(exclude) - 1)
            new = exclude[at] != pk
            qpos, dpos, qpid, dpid = qpos[new], dpos[new], qpid[new], \
                dpid[new]
    if tol and len(qpos):
        keep = torch.sort(collapse_diag_runs_torch(qpos, dpos, qpid, dpid,
                                                   tol)).values
        qpos, dpos, qpid, dpid = qpos[keep], dpos[keep], qpid[keep], \
            dpid[keep]
    six = torch.stack([qpos, dpos, starts[qpid], starts[qpid + 1],
                       starts[dpid], starts[dpid + 1]]).to(torch.int32)
    return six, qpid, dpid


def align_gapped(q, d, sub21, gap_open: int = 11, gap_ext: int = 1,
                 drop: int = 27, band: int = 32):
    """Banded affine-gap alignment with traceback: global from (0, 0)
    within the diagonal band |j - i| <= band, best cell floored at 0,
    first-best in row-major order, x-drop row abandonment for rows i > 1.

    Returns (score, ops uint8 [0=M, 1=gap-in-d, 2=gap-in-q], q_extent,
    d_extent)."""
    m, nn = len(q), len(d)
    NEG = -(1 << 28)
    w = 2 * band + 1
    H = np.full((m + 1, w), NEG, np.int64)
    E = np.full((m + 1, w), NEG, np.int64)
    F = np.full((m + 1, w), NEG, np.int64)
    bt = np.full((m + 1, w), 255, np.uint8)
    best, bi, bj = 0, 0, 0
    for jj in range(band, w):
        j = jj - band
        if j > nn:
            break
        H[0, jj] = 0 if j == 0 else -(gap_open + (j - 1) * gap_ext)
        bt[0, jj] = 3 if j == 0 else 2
    for i in range(1, m + 1):
        alive = False
        for jj in range(w):
            j = i - band + jj
            if j < 0 or j > nn:
                continue
            e = f = NEG
            h, op = NEG, 255
            if jj > 0 and j > 0:
                e = max(H[i, jj - 1] - gap_open, E[i, jj - 1] - gap_ext)
            if jj + 1 < w:
                f = max(H[i - 1, jj + 1] - gap_open,
                        F[i - 1, jj + 1] - gap_ext)
            if j > 0 and H[i - 1, jj] > NEG:
                diag = H[i - 1, jj] + int(sub21[q[i - 1], d[j - 1]])
                if diag >= e and diag >= f:
                    h, op = diag, 0
            if op == 255:
                if e >= f:
                    h, op = e, 2
                else:
                    h, op = f, 1
            E[i, jj], F[i, jj] = e, f
            if h <= NEG // 2:
                continue
            H[i, jj], bt[i, jj] = h, op
            if h > best:
                best, bi, bj = h, i, jj
            if h >= best - drop:
                alive = True
        if not alive and i > 1:
            break
    i, jj = bi, bj
    rev = []
    while not (i == 0 and i - band + jj == 0):
        op = bt[i, jj]
        if op in (255, 3):
            break
        rev.append(int(op))
        if op == 0:
            i -= 1
        elif op == 1:
            i -= 1
            jj += 1
        else:
            jj -= 1
    ops = np.asarray(rev[::-1], np.uint8)
    return int(best), ops, int(bi), int(bi - band + bj)
