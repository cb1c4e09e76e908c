"""Secondary benchmark: every engine on the bench workload, one process.

    python -m hsearch_tpu_torch.examples.bench_engines [log2_n]
        [--ref-point] [--merge] [--device cuda]

Measures, on the same family-structured corpus as ``hsearch_tpu_torch.bench``
(default 2^18 rows, 256 centers, L = 25, R = 35):
  * LSH motif search q/s (the reference's namesake algorithm) and its
    weighted recall against the exact oracle, at the reference's point
    (K=4 L=4 W=50) and the tuned point (K=8 L=8 W=105 P=8, cand_max 2048,
    center blocks of 32; verify at block size 1);
  * IVF q/s (kb 128, retry off, center blocks of 512);
  * hclust2 greedy clustering k-mers/s (K=16 L=8 W=50; ``--ref-point``
    adds the reference's L=32), with ``--merge`` the center-distance
    merge after it;
  * hclust (centroid) k-mers/s.
Writes one JSON line per row on stdout.
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
from ..cluster import centroid, greedy, postprocess
from ..search import evaluate, exact, ivf, motif

L, RADIUS, N_CENTERS, ITERS = 25, 35.0, 256, 3


def lsh_points(radius: float = RADIUS):
    """The two LSH rows as (tag, config, cand_max).  The tuned point's
    verify bill is L*P*cand_max slots per query, so it runs cand_max 2048
    in center blocks of 32 (bounded memory, more dispatches)."""
    return (("lsh_ref", motif.MotifSearchConfig(
                hash_k=4, hash_l=4, w=50.0, radius=radius,
                center_block=256, max_hits=512), None),
            ("lsh_tuned", motif.MotifSearchConfig(
                hash_k=8, hash_l=8, w=105.0, radius=radius, probes=8,
                center_block=32, max_hits=512), 2048))


def pair_recall(labels, fam_sub, n_pairs=200_000):
    """Fraction of sampled same-family row pairs sharing a label."""
    prng = np.random.default_rng(1)
    order = np.argsort(fam_sub, kind="stable")
    f = fam_sub[order]
    starts = np.searchsorted(f, np.arange(f.max() + 2))
    sizes = np.diff(starts)
    ok_fam = np.nonzero(sizes >= 2)[0]
    fs = prng.choice(ok_fam, n_pairs)
    a = starts[fs] + (prng.random(n_pairs) * sizes[fs]).astype(int)
    b = starts[fs] + (prng.random(n_pairs) * sizes[fs]).astype(int)
    m = a != b
    ra, rb = order[a[m]], order[b[m]]
    return float((labels[ra] == labels[rb]).mean())


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def lsh_row(db, centers, truth, tag, cfg, cand_max, dev, params=None,
            log=print):
    """One LSH row: build (the tables drawn from seed 0, or ``params``
    such as the JAX package's draws), one warm-up search, ITERS timed
    searches, weighted recall against ``truth``.  Prints the row and
    returns it with the last search's (center, kmer, dist) hits."""
    t0 = time.perf_counter()
    index = motif.build_index(db, _gen(0), cfg, cand_max=cand_max,
                              params=params, device=dev)
    log(f"# {tag} build {time.perf_counter() - t0:.1f}s cand_max="
        f"{index.cand_max}")
    motif.search(index, centers, cfg)                  # warm-up
    t0 = time.perf_counter()
    for _ in range(ITERS):
        hits = motif.search(index, centers, cfg)
    qps = centers.shape[0] / ((time.perf_counter() - t0) / ITERS)
    rep = evaluate.recall_from_indices(*truth, hits[0], hits[1], RADIUS)
    row = {"engine": tag, "n": int(db.shape[0]), "qps": round(qps, 1),
           "weighted_recall": round(rep.recall, 4),
           "cand_max": index.cand_max}
    print(json.dumps(row), flush=True)
    return row, hits


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("log2_n", nargs="?", type=int, default=18)
    ap.add_argument("--ref-point", action="store_true",
                    help="also cluster at the reference's L=32")
    ap.add_argument("--merge", action="store_true",
                    help="add the center-distance merge after greedy")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)
    log2n = args.log2_n
    n = 1 << log2n
    rng = np.random.default_rng(0)
    db, centers, fam = protein_like_db(rng, n, L, query_n=N_CENTERS,
                                       return_families=True)
    c = centers.shape[0]

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    log(f"# workload n=2^{log2n} c={c} l={L} R={RADIUS} on {card(dev)}")
    # the oracle for recall, shared by both engines
    gci, gki, gd = exact.search_radius(db, centers, RADIUS,
                                       center_block=256, max_hits=2048,
                                       device=dev)

    for tag, cfg, cand_max in lsh_points():
        lsh_row(db, centers, (gci, gki, gd), tag, cfg, cand_max, dev,
                log=log)

    # IVF side by side, at the bench's operating point (retry off)
    t0 = time.perf_counter()
    iidx = ivf.build_index(db, _gen(0), block_size=32, device=dev)
    log(f"# ivf build {time.perf_counter() - t0:.1f}s")
    kw = dict(k_blocks=128, max_hits=512, center_block=512,
              retry_overflow=False, stats_out={})
    ivf.search(iidx, centers, RADIUS, **kw)                  # warm-up
    t0 = time.perf_counter()
    for _ in range(ITERS):
        ci2, ki2, _ = ivf.search(iidx, centers, RADIUS, **kw)
    ivf_qps = c / ((time.perf_counter() - t0) / ITERS)
    rep2 = evaluate.recall_from_indices(gci, gki, gd, ci2, ki2, RADIUS)
    print(json.dumps({"engine": "ivf", "n": n, "qps": round(ivf_qps, 1),
                      "weighted_recall": round(rep2.recall, 4)}),
          flush=True)
    del iidx

    # clustering throughput and family-pair recall
    nc = min(n, 1 << min(log2n, 23))
    fam_sub = fam[:nc]
    points = [("L8", 8)] + ([("L32", 32)] if args.ref_point else [])
    for tag, hl in points:
        t0 = time.perf_counter()
        cfg2 = greedy.ClusterConfig(hash_k=16, hash_l=hl, w=50.0,
                                    radius=RADIUS)
        res = greedy.cluster_greedy(db[:nc], _gen(1), cfg2, device=dev)
        g_kps = nc / (time.perf_counter() - t0)
        lab = np.where(res.parent >= 0, res.parent, np.arange(nc))
        print(json.dumps({"engine": f"hclust2_greedy_{tag}", "n": nc,
                          "kmers_per_s": round(g_kps, 1),
                          "clusters": int((res.merged != 2).sum()),
                          "family_pair_recall":
                              round(pair_recall(lab, fam_sub), 4)}),
              flush=True)
        if args.merge:
            t0 = time.perf_counter()
            mlab = postprocess.merge_by_center_distance(
                db[:nc], lab, RADIUS, _gen(3), device=dev)
            m_s = time.perf_counter() - t0
            print(json.dumps({
                "engine": f"hclust2_greedy_{tag}+merge", "n": nc,
                "merge_s": round(m_s, 1),
                "kmers_per_s": round(nc / (nc / g_kps + m_s), 1),
                "clusters": int(len(np.unique(mlab))),
                "family_pair_recall":
                    round(pair_recall(mlab, fam_sub), 4)}), flush=True)

        t0 = time.perf_counter()
        ccfg = centroid.CentroidConfig(hash_k=16, hash_l=hl, w=50.0,
                                       radius=RADIUS)
        members = centroid.cluster_centroid(db[:nc], _gen(2), ccfg,
                                            device=dev)
        c_kps = nc / (time.perf_counter() - t0)
        clab = np.empty(nc, np.int64)
        for ci_, grp in enumerate(members):
            clab[grp] = ci_
        print(json.dumps({"engine": f"hclust_centroid_{tag}", "n": nc,
                          "kmers_per_s": round(c_kps, 1),
                          "clusters": len(members),
                          "family_pair_recall":
                              round(pair_recall(clab, fam_sub), 4)}),
              flush=True)


if __name__ == "__main__":
    main()
