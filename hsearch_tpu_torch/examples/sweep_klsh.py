"""KLSH operating-point sweep: bits x sigma x tables against family recall.

    python -m hsearch_tpu_torch.examples.sweep_klsh [n_proteins]
        [--tables=2] [--device cuda]

Sweeps the code width (12, 16, 20, 24 bits) and kernel bandwidth (sigma
0.1, 0.2, 0.3) at a fixed table count on the bench_pcluster_mp family
corpus and reports family-pair recall, alignment hits, clusters,
pre-groups and wall time per point: the data for choosing a cheaper
default.  One JSON line per point on stdout.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from .. import _device
from ..bench import card
from ..cluster import pcluster
from .bench_pcluster_mp import _DB, family_recall, make_corpus

BITS, SIGMAS = (12, 16, 20, 24), (0.1, 0.2, 0.3)


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n_proteins", nargs="?", type=float, default=100000)
    ap.add_argument("--tables", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)
    n = int(args.n_proteins)
    seqs, n_fam = make_corpus(n)
    db = _DB(seqs)
    print(f"# {n} proteins on {card(dev)}", file=sys.stderr, flush=True)
    rows = []
    for bits in BITS:
        for sigma in SIGMAS:
            t0 = time.perf_counter()
            res = pcluster.cluster_proteins(
                db, torch.Generator().manual_seed(0), tables=args.tables,
                bits=bits, sigma=sigma, device=dev)
            wall = time.perf_counter() - t0
            rows.append({
                "bits": bits, "sigma": sigma, "tables": args.tables,
                "proteins": n, "hits": len(res.hits),
                "clusters": len(set(res.labels.tolist())),
                "groups": len(res.pre_groups),
                "family_pair_recall": round(
                    family_recall(res.labels, n_fam), 4),
                "total_s": round(wall, 1)})
            print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
