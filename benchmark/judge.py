"""The comparison that decides ``correct``.

Every hit the window returned, (batch, center, k-mer id, distance), is
held against the plain reference's exact hits of the pool
(``reference.radius_hits``):

  recall     the reference's weighted recall of the window's hits: the
             weight of the true hits returned, summed over every batch,
             over the weight of the true hits of every center sent.  The
             configuration states its limit (``recall_min``).
  hit_error  the worst returned hit: max over hits of
             max(|d2 - d2_ref|, d2_ref - R^2, 0) / R^2, with d2 the square
             of the distance the program returned and d2_ref the
             reference's for that (center, k-mer).  A wrong distance and a
             hit outside the radius both read here; a k-mer id or center
             outside the data reads inf.  ``hit_error_max`` in the
             configuration is set from the program's readings and the
             control's (PERF.md).
  duplicates hits that a batch returned more than once, the same (center,
             k-mer) pair twice (limit 0): recall counts such a hit once,
             so only this number sees it.
  failed     batches that raised: an answer that never came (limit 0).

The sums run on the device where the reference ran, after the program's
state is freed.
"""

from __future__ import annotations

import numpy as np
import torch

from . import recall, reference


def compare(log, truth, db: torch.Tensor, pool: torch.Tensor,
            radius: float) -> dict:
    """(recall, hit_error) of the window's hits (a ``hitlog.HitLog``)
    against ``truth`` = (center, row, d2) of ``reference.radius_hits``
    over the pool."""
    dev = db.device
    n, p = db.shape[0], pool.shape[0]
    r2 = float(radius) ** 2
    tc, tr, td2 = truth
    tkey = tc * n + tr                                   # sorted
    tw = torch.as_tensor(recall.weight_array(
        np.sqrt(td2.cpu().numpy())), device=dev)
    w_center = torch.zeros(p, dtype=torch.float64, device=dev) \
        .index_add_(0, tc, tw)
    times_sent = torch.bincount(torch.as_tensor(log.sent_ids(), device=dev),
                                minlength=p).to(torch.float64)
    want = float((times_sent * w_center).sum())

    bid, pid, ki, d = log.tensors(dev)
    valid = (pid >= 0) & (ki >= 0) & torch.isfinite(d)
    key = torch.where(valid, pid * n + ki, -1)
    if tkey.numel():
        pos = torch.searchsorted(tkey, key).clamp(max=tkey.numel() - 1)
        found = valid & (tkey[pos] == key)
    else:
        pos, found = torch.zeros_like(key), torch.zeros_like(valid)
    # recall: each true hit counts once per batch that returned it
    first = torch.ones_like(found)
    if found.any():
        bkey = bid * (p * n) + key
        order = torch.argsort(bkey)
        dup = torch.zeros_like(found)
        dup[order[1:]] = bkey[order[1:]] == bkey[order[:-1]]
        first = ~dup
    got = float(tw[pos[found & first]].sum())
    vb = torch.sort((bid * (p * n) + key)[valid]).values
    duplicates = int((vb[1:] == vb[:-1]).sum()) if vb.numel() > 1 else 0
    rec = got / want if want > 0 else 1.0

    d2p = d * d
    d2r = torch.full_like(d2p, float("inf"))
    d2r[found] = td2[pos[found]]
    other = valid & ~found
    if other.any():
        d2r[other] = reference.pair_d2(db, pool, pid[other], ki[other])
    err = torch.maximum((d2p - d2r).abs(), d2r - r2).clamp_min(0.0) / r2
    err = torch.where(valid, err, torch.full_like(err, float("inf")))
    hit_error = float(err.max()) if err.numel() else 0.0
    return {"recall": rec, "hit_error": hit_error,
            "hits": int(d.numel()), "true_hits_sent": int(
                (times_sent * torch.bincount(tc, minlength=p)).sum()),
            "outside_truth": int((~found).sum()),
            "duplicates": duplicates}


def checks(numbers: dict, failed: int, cfg: dict) -> dict:
    """Each number compared beside its limit, and whether it holds."""
    lim = cfg["correct"]
    return {
        "recall": {"value": numbers["recall"], "limit": lim["recall_min"],
                   "ok": numbers["recall"] >= lim["recall_min"]},
        "hit_error": {"value": numbers["hit_error"],
                      "limit": lim["hit_error_max"],
                      "ok": numbers["hit_error"] <= lim["hit_error_max"]},
        "duplicates": {"value": numbers["duplicates"], "limit": 0,
                       "ok": numbers["duplicates"] == 0},
        "failed_batches": {"value": failed, "limit": 0, "ok": failed == 0},
    }
