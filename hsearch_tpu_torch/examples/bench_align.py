"""Aligner throughput: ProteinSearcher.search_all on a family corpus.

    python -m hsearch_tpu_torch.examples.bench_align [n_proteins]
        [--cluster-only] [--tables=4] [--pair-batch=8192] [--stages]
        [--device cuda]

Measures proteins/s for the batched all-vs-all group search (the pcluster
inner loop) and for the full cluster_proteins pipeline, with the planted
family-pair recall.  ``--cluster-only`` skips search_all: all-vs-all over
one undivided group is quadratic in N on a family corpus (every query
extends into every family's seed buckets), which is exactly the blowup
the KLSH pre-grouping exists to avoid; at N >= 1e5 measure
cluster_proteins.  ``--stages`` prints utils/profiling's stage report.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from .. import _device
from ..align import pipeline as apipe
from ..bench import card
from ..cluster import pcluster
from ..core import io as hio
from ..utils import profiling


def protein_families(n, plen=120, seed=0):
    """The JAX package's bench_align corpus, same numpy calls: n // 4
    families of 4 copies of a plen-residue base (protein i belongs to
    family i % (n // 4)), 4 substitutions each; proteins past the last
    whole family random.  Returns (ProteinDB, number of families)."""
    rng = np.random.default_rng(seed)
    n_fam = max(1, n // 4)
    seqs = []
    for i in range(n):
        if i < n_fam * 4:
            s = np.random.default_rng(1000 + i % n_fam).integers(
                0, 20, plen).astype(np.int32)
            pos = rng.choice(plen, 4, replace=False)
            s[pos] = rng.integers(0, 20, 4)
        else:
            s = rng.integers(0, 20, plen).astype(np.int32)
        seqs.append(s)
    starts = np.concatenate([[0], np.cumsum([len(s) for s in seqs])])
    return hio.ProteinDB(names=[f"p{i}" for i in range(n)],
                         seq=np.concatenate(seqs).astype(np.uint8),
                         starts=starts), n_fam


def family_pair_recall(labels, n_fam):
    """Fraction of within-family protein pairs in one cluster (families
    are the proteins i with the same i % n_fam)."""
    lab = labels[np.arange(n_fam * 4).reshape(4, n_fam).T]
    pairs = [(a, b) for a in range(4) for b in range(a + 1, 4)]
    return float(sum(int((lab[:, a] == lab[:, b]).sum()) for a, b in pairs)
                 / max(n_fam * len(pairs), 1))


def bench_search_all(db, n, dev) -> dict:
    t0 = time.perf_counter()
    searcher = apipe.ProteinSearcher(db, device=dev)
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    hits = searcher.search_all()
    t_search = time.perf_counter() - t0
    row = {"bench": "search_all", "proteins": n, "hits": len(hits),
           "build_s": round(t_build, 2), "search_s": round(t_search, 2),
           "proteins_per_s": round(n / t_search, 1)}
    print(json.dumps(row), flush=True)
    return row


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n_proteins", nargs="?", type=int, default=1000)
    ap.add_argument("--cluster-only", action="store_true")
    ap.add_argument("--tables", type=int, default=4)
    ap.add_argument("--pair-batch", type=int, default=8192)
    ap.add_argument("--stages", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)
    n = args.n_proteins
    db, n_fam = protein_families(n)
    print(f"# {n} proteins on {card(dev)}", file=sys.stderr, flush=True)
    rows = [] if args.cluster_only else [bench_search_all(db, n, dev)]
    params = apipe.SearchParams(pair_batch=args.pair_batch)
    t0 = time.perf_counter()
    res = pcluster.cluster_proteins(db, torch.Generator().manual_seed(0),
                                    params, tables=args.tables, device=dev)
    t_pc = time.perf_counter() - t0
    rows.append({
        "bench": "cluster_proteins", "proteins": n, "tables": args.tables,
        "backend": dev.type,
        "clusters": len(set(res.labels.tolist())),
        "hits": len(res.hits), "total_s": round(t_pc, 2),
        "proteins_per_s": round(n / t_pc, 1),
        "family_pair_recall": round(family_pair_recall(res.labels, n_fam),
                                    4)})
    print(json.dumps(rows[-1]), flush=True)
    if args.stages:
        profiling.print_report()
    return rows


if __name__ == "__main__":
    main()
