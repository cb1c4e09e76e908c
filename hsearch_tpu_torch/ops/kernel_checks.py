"""How closely each CUDA kernel must agree with its plain version.

One place for the tolerance rules (and the verify kernel's test inputs)
that chip_smoke.py and tests/test_torch_kernels.py both hold the kernels
of ops/cuda_kernels.py to.
"""

from __future__ import annotations

import numpy as np
import torch

from . import distance


def prune_agreement(q: torch.Tensor, cent: torch.Tensor,
                    rad: torch.Tensor, r: float, got, want) -> dict:
    """Verdict on ``got`` = sq_distance_prune's (key, gmin, n_alive) against
    ``want`` = sq_distance_prune_plain's, on the same inputs.

    key: each finite key within rtol 1e-4 / atol 1e-3 in d, or within
    1e-3 + 1e-5 * (|q|^2 + |cent|^2) in d^2; the finite/inf masks agree
    except within 1e-3 of r + radius (flips); the padding columns are inf.
    gmin and n_alive: exactly the group minima and finite counts of the
    kernel's own keys; n_alive differs from the plain version's by at
    most the row's flips.

    The d^2 form is for keys near 0: both versions compute
    d^2 = |q|^2 + |c|^2 - 2 q.c in float32 with different summation
    orders, so they differ by a few ulps of the norms (~2e-3 at norms
    ~4e3), and the sqrt turns that into ~0.04 in d when d is ~0.
    """
    key, gmin, n_alive = got
    wkey, _, wn = want
    b = cent.shape[0]
    group = key.shape[1] // gmin.shape[1]
    self_ok = (bool(torch.equal(gmin, torch.amin(
                   key.view(key.shape[0], -1, group), dim=2)))
               and bool(torch.equal(n_alive, torch.isfinite(key).sum(1)
                                    .to(torch.int32)))
               and bool((key[:, b:] == float("inf")).all()))
    key, wkey = key[:, :b], wkey[:, :b]
    fin, wfin = torch.isfinite(key), torch.isfinite(wkey)
    both = fin & wfin
    err = (key - wkey).abs()[both]
    scale = (torch.sum(q * q, dim=1)[:, None]
             + torch.sum(cent * cent, dim=1)[None, :])[both]
    err2 = (key[both] ** 2 - wkey[both] ** 2).abs()
    tol_ok = bool(((err <= 1e-3 + 1e-4 * wkey[both].abs())
                   | (err2 <= 1e-3 + 1e-5 * scale)).all())
    flip = fin != wfin
    n_flip = int(flip.sum())
    flips_ok = True
    if n_flip:
        d = torch.sqrt(distance.sq_distance_matrix(q, cent))
        thr = float(np.float32(r)) + rad[None, :].expand_as(d)
        flips_ok = bool(((d - thr)[flip].abs() <= 1e-3).all())
    alive_ok = bool(((n_alive - wn).abs() <= flip.sum(1)).all())
    return {"max_abs_err": float(err.max()) if err.numel() else 0.0,
            "max_d2_err_over_norms": float((err2 / scale).max())
            if err2.numel() else 0.0,
            "n_finite": int(both.sum()), "mask_flips": n_flip,
            "n_alive_diff": int((n_alive - wn).abs().sum()),
            "gmin_n_alive_self_consistent": self_ok,
            "ok": (tol_ok and flips_ok and self_ok and alive_ok
                   and int(both.sum()) > 0)}


def verify_agreement(got, want) -> dict:
    """Verdict on ptable_verify's (d2m, n_hits) against
    ptable_verify_plain's: both bitwise equal, and some hits."""
    bitwise = bool(torch.equal(got[0], want[0])
                   and torch.equal(got[1], want[1]))
    fin = torch.isfinite(want[0])
    max_err = float((got[0] - want[0])[fin].abs().max()) \
        if bool(fin.any()) else 0.0
    n_hits = int(want[1].sum())
    return {"max_abs_err": max_err, "bitwise": bitwise, "n_hits": n_hits,
            "ok": bitwise and n_hits > 0}


def verify_inputs(rng: np.random.Generator, c: int, kb: int, bs: int,
                  l: int, nblk: int = 50, n: int = 1000):
    """Random verify arguments (ptab, db_sorted, order, blk_ids, neg, r2, n)
    as numpy arrays: index arrays of ``nblk`` blocks with sentinel rows
    (order == n) and a select result with dead blocks (neg = -inf).
    r2 = 0.45 L sits below the mean d2 of L uniform table entries."""
    ptab = rng.random((c, l, 20)).astype(np.float32)
    db_sorted = rng.integers(0, 20, (nblk, bs * l)).astype(np.int8)
    order = rng.integers(0, n, (nblk, bs)).astype(np.int32)
    order[rng.random((nblk, bs)) < 0.2] = n
    blk_ids = rng.integers(0, nblk, (c, kb)).astype(np.int64)
    neg = -rng.random((c, kb)).astype(np.float32)
    neg[rng.random((c, kb)) < 0.25] = -np.inf
    return ptab, db_sorted, order, blk_ids, neg, 0.45 * l, n


# residue indices (alphabet ARNDCQEGHILKMFPSTWYV) of extend_tie_inputs:
# BLOSUM62 (A, S) = +1, (A, R) = -1, (W, W) = +11, (W, P) = -4; A, S and
# R lie in three murphy10 groups, so such a pair ends greedy extension
_A, _R, _P, _S, _W = 0, 1, 14, 15, 17


def extend_tie_inputs(rng: np.random.Generator, b: int = 256):
    """Seed pairs (seq, six) whose x-drop scans tie their running maximum
    across chunk boundaries, as numpy int32.  Lane k owns a query and a
    subject protein of one length, each [backward run reversed, 10
    residues of seed, forward run]: a run of m pairs alternating
    (A, S) = +1 and (A, R) = -1 (m from 3 to 80) returns to its maximum
    every other residue, so ties fall on both sides of the 8-, 16- and
    32-residue chunk boundaries; half the runs hold a (W, W) = +11 pair at
    a random place (a new maximum after ties); half end in 5 pairs
    (W, P) = -4 (the drop stops the scan at drop 9), the rest at the
    protein's end (the past-bound score stops it).  Seeds are 10 W, or,
    in every eighth lane, unknown residues (gate score -50, below
    MINSCORE: no x-drop)."""

    def run():
        m = int(rng.integers(3, 81))
        q = np.full(m, _A)
        d = np.where(np.arange(m) % 2 == 0, _S, _R)
        if rng.random() < 0.5:
            k = int(rng.integers(1, m))
            q[k] = d[k] = _W
        if rng.random() < 0.5:
            q = np.concatenate([q, np.full(5, _W)])
            d = np.concatenate([d, np.full(5, _P)])
        return q, d

    seq, six, pos = [], [], 0
    for k in range(b):
        (fq, fd), (bq, bd) = run(), run()
        seed = rng.choice([20, 21, 25], 10) if k % 8 == 7 \
            else np.full(10, _W)
        qp = np.concatenate([bq[::-1], seed, fq])
        dp = np.concatenate([bd[::-1], seed, fd])
        n = len(qp)
        seq += [qp, dp]
        six.append([pos + len(bq), pos + n + len(bd), pos, pos + n, pos + n,
                    pos + 2 * n])
        pos += 2 * n
    return (np.concatenate(seq).astype(np.int32),
            np.ascontiguousarray(np.array(six, np.int64).T, np.int32))


def extend_agreement(got: torch.Tensor, want: torch.Tensor) -> dict:
    """Verdict on extend_pairs's (8, B) result against extend_pairs_plain's
    (or any form the plain one equals): bitwise equal in all 8 fields, on
    some lanes."""
    same = got.shape == want.shape
    differ = (got != want).any(dim=0) if same else None
    return {"lanes": int(want.shape[1]),
            "lanes_differ": int(differ.sum()) if same else -1,
            "max_abs_err": float((got - want).abs().max())
            if same and want.numel() else 0.0,
            "bitwise": bool(same and torch.equal(got, want)),
            "ok": bool(same and torch.equal(got, want)
                       and want.shape[1] > 0)}


def bounds_agreement(got, want, coords: torch.Tensor) -> dict:
    """Verdict on block_bounds's (centroid, radius) against
    block_bounds_plain's, on the same inputs.

    Blocks with no valid row (plain radius -inf): radius -inf and centroid
    0, exactly.  Elsewhere, with s the largest |coordinate| and D = 8L the
    embedding width: each centroid component within 1e-6 (|plain| + s) and
    each radius within 1e-6 (plain + sqrt(D) s), both ways, so a radius is
    never smaller than the plain one by more than that.  The scale terms
    are for values that cancel toward 0: a centroid component is a sum of
    20 products of residue counts and coordinates, rounded in another
    order than the plain version's matrix product (a few ulps of s), and a
    radius moves by at most sqrt(D) times the centroid's error.
    """
    (cent, rad), (wcent, wrad) = got, want
    s = float(coords.abs().max())
    pad = torch.isneginf(wrad)
    real = ~pad
    pad_ok = bool(torch.equal(torch.isneginf(rad), pad)
                  and (cent[pad] == 0).all())
    ce = (cent[real] - wcent[real]).abs()
    re_ = (rad[real] - wrad[real]).abs()
    cent_ok = bool((ce <= 1e-6 * (wcent[real].abs() + s)).all())
    rad_ok = bool((re_ <= 1e-6 * (wrad[real] + (cent.shape[1] ** 0.5) * s))
                  .all())
    bitwise = bool(torch.equal(cent, wcent) and torch.equal(rad, wrad))
    rel = (re_ / wrad[real].clamp_min(1e-30)) if re_.numel() else re_
    return {"blocks": int(rad.shape[0]), "padding_blocks": int(pad.sum()),
            "max_abs_err": max(float(ce.max()) if ce.numel() else 0.0,
                               float(re_.max()) if re_.numel() else 0.0),
            "max_cent_abs_err": float(ce.max()) if ce.numel() else 0.0,
            "max_rad_rel_err": float(rel.max()) if rel.numel() else 0.0,
            "min_rad_diff": float((rad[real] - wrad[real]).min())
            if re_.numel() else 0.0,
            "bitwise": bitwise,
            "ok": pad_ok and cent_ok and rad_ok and int(real.sum()) > 0}


def extend_inputs(rng: np.random.Generator, n_prot: int = 24,
                  plen: int = 96, b: int = 512):
    """Seed pairs (seq, six) for the extension, as numpy int32: a corpus of
    ``n_prot`` proteins of ``plen`` residues, half copies of one base with
    3 substitutions each, half random with unknown residues (20, 21, 25),
    the last all unknown; ``b`` lanes (qpos, dpos, qlo, qhi, dlo, dhi) of
    random seeds, same-offset family seeds (long greedy and x-drop runs),
    seeds at a protein's first residue (no backward room) and ending at
    its last (no forward room), and seeds inside the unknown protein
    (gate score below MINSCORE)."""
    base = rng.integers(0, 20, plen)
    prots = []
    for i in range(n_prot):
        if i < n_prot // 2:
            p = base.copy()
            p[rng.integers(0, plen, 3)] = rng.integers(0, 20, 3)
        else:
            p = rng.integers(0, 20, plen)
            p[rng.random(plen) < 0.05] = rng.choice([20, 21, 25])
        prots.append(p)
    prots[-1] = rng.choice([20, 21, 25], plen)
    seq = np.concatenate(prots).astype(np.int32)
    starts = np.arange(n_prot + 1) * plen
    pid_q = rng.integers(0, n_prot, b)
    pid_d = rng.integers(0, n_prot, b)
    off_q = rng.integers(0, plen - 9, b)
    off_d = rng.integers(0, plen - 9, b)
    q = b // 8
    fam = rng.integers(0, n_prot // 2, (2, 2 * q))
    pid_q[:2 * q], pid_d[:2 * q] = fam
    off_d[:q] = off_q[:q]                      # same offset: long runs
    off_q[q:2 * q] = off_d[q:2 * q] = rng.integers(0, 2, q) * (plen - 10)
    off_q[2 * q:3 * q] = 0                     # seed at qlo
    off_d[3 * q:4 * q] = plen - 10             # seed ends at dhi
    pid_q[4 * q:4 * q + 8] = n_prot - 1        # gate < MINSCORE
    pid_d[4 * q:4 * q + 8] = n_prot - 1
    qpos, dpos = starts[pid_q] + off_q, starts[pid_d] + off_d
    six = np.stack([qpos, dpos, starts[pid_q], starts[pid_q] + plen,
                    starts[pid_d], starts[pid_d] + plen])
    return seq, six.astype(np.int32)
