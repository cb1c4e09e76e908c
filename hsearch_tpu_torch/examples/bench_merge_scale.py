"""Center-distance merge at scale: the quality/cost frontier past 2^20.

    python -m hsearch_tpu_torch.examples.bench_merge_scale [log2_n]
        [--kbs=64,128] [--hash-l=8] [--device cuda]

``merge_by_center_distance`` (hclust v1's centroid merge composed onto
hclust2's greedy labels, cluster/postprocess.py) measured, at a chosen
scale (default 2^20) on the bench family corpus:

  * the greedy baseline (k-mers/s, clusters, family-pair recall),
  * the merge pass per k_blocks cap (merge seconds, resulting clusters,
    recall, clusters per true family): union-find needs only one
    surviving edge per cluster pair, so lower caps may buy most of the
    recall at a fraction of the search bill.

One JSON line per row on stdout.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from .. import _device
from ..bench import card, protein_like_db
from ..cluster import greedy, postprocess

L, RADIUS = 25, 35.0


def adjacent_pair_recall(labels, fam_of) -> float:
    """Same-family pairs of rows adjacent in family order that share a
    label."""
    order = np.argsort(fam_of, kind="stable")
    f = fam_of[order]
    a = np.arange(len(f) - 1)
    b = a + 1
    m = f[a] == f[b]
    ra, rb = order[a[m]], order[b[m]]
    return float((labels[ra] == labels[rb]).mean())


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("log2_n", nargs="?", type=int, default=20)
    ap.add_argument("--kbs", default="64,128",
                    help="comma-separated k_blocks caps of the merge")
    ap.add_argument("--hash-l", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)
    kbs = [int(x) for x in args.kbs.split(",")]
    n = 1 << args.log2_n
    rng = np.random.default_rng(0)
    db, _, fam_of = protein_like_db(rng, n, L, return_families=True)
    n_fam = int(fam_of.max()) + 1
    print(f"# n=2^{args.log2_n} on {card(dev)}", file=sys.stderr,
          flush=True)
    rows = []

    t0 = time.perf_counter()
    cfg = greedy.ClusterConfig(hash_k=16, hash_l=args.hash_l, w=50.0,
                               radius=RADIUS)
    res = greedy.cluster_greedy(db, torch.Generator().manual_seed(1), cfg,
                                device=dev)
    g_s = time.perf_counter() - t0
    lab = np.where(res.parent >= 0, res.parent, np.arange(n))
    rows.append({
        "bench": "merge_scale", "engine": f"greedy_L{args.hash_l}", "n": n,
        "true_families": n_fam, "greedy_s": round(g_s, 1),
        "kmers_per_s": round(n / g_s, 1),
        "clusters": int(len(np.unique(lab))),
        "family_pair_recall": round(adjacent_pair_recall(lab, fam_of), 4)})
    print(json.dumps(rows[-1]), flush=True)

    for kb in kbs:
        t0 = time.perf_counter()
        mlab = postprocess.merge_by_center_distance(
            db, lab, RADIUS, torch.Generator().manual_seed(3), k_blocks=kb,
            device=dev)
        m_s = time.perf_counter() - t0
        n_clusters = int(len(np.unique(mlab)))
        rows.append({
            "bench": "merge_scale", "engine": f"greedy_L{args.hash_l}+merge",
            "n": n, "kb": kb, "merge_s": round(m_s, 1),
            "effective_kmers_per_s": round(n / (g_s + m_s), 1),
            "clusters": n_clusters,
            "over_fragmentation": round(n_clusters / n_fam, 3),
            "family_pair_recall": round(adjacent_pair_recall(mlab, fam_of),
                                        4)})
        print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
