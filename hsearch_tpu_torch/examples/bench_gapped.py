"""Gapped-refinement A/B: cluster_proteins with gapped=True against False.

    python -m hsearch_tpu_torch.examples.bench_gapped [n_proteins]
        [--tables=1] [--bits=12] [--sigma=0.1] [--indels] [--device cuda]

Runs the full pcluster pipeline twice on the SAME corpus (bench_pcluster_mp's
family corpus: n//4 families x 4 members, 120 aa, 4 substitutions;
``--indels`` shifts a suffix of about half the members by 1-3 positions)
and reports:

  * wall and proteins/s for both runs (the gapped overhead),
  * how many (query, subject) pairs the gapped pass improved (score
    strictly above the ungapped one),
  * e-value / identity / alignment-length deltas over improved pairs,
  * family-pair recall for both runs (does refinement change clustering?).

One JSON line on stdout.  HSEARCH_THREADS (default: every core) sets
torch's host threads and the C++ host library's OpenMP pool.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from .. import _device, native_ext
from ..bench import card
from ..cluster import pcluster
from .bench_pcluster_mp import _DB, family_recall, make_corpus


def add_indels(seqs: np.ndarray, n_fam: int, p: float = 0.5,
               seed: int = 11) -> np.ndarray:
    """Shift a suffix of ~half the family members by 1-3 positions
    (fixed-length frameshift = an indel against the family base), so the
    gapped pass has real gaps to recover.  The substitution-only corpus
    never rewards a gap."""
    rng = np.random.default_rng(seed)
    out = seqs.copy()
    n, plen = seqs.shape
    n_mem = n_fam * 4
    for i in range(n_mem):
        if rng.random() >= p:
            continue
        pos = int(rng.integers(15, plen - 15))
        g = int(rng.integers(1, 4))
        if rng.random() < 0.5:      # deletion: suffix slides left
            out[i, pos:plen - g] = seqs[i, pos + g:]
            out[i, plen - g:] = rng.integers(0, 20, g)
        else:                       # insertion: suffix slides right
            out[i, pos + g:] = seqs[i, pos:plen - g]
            out[i, pos:pos + g] = rng.integers(0, 20, g)
    return out


def best_by_pair(hits):
    out = {}
    for h in hits:
        k = (int(h.query), int(h.subject))
        if k not in out or h.score > out[k].score:
            out[k] = h
    return out


def _mean(xs, digits):
    return round(float(np.mean(xs)), digits) if xs else 0.0


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n_proteins", nargs="?", type=float, default=100000)
    ap.add_argument("--tables", type=int, default=1)
    ap.add_argument("--bits", type=int, default=12)
    ap.add_argument("--sigma", type=float, default=0.1)
    ap.add_argument("--indels", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)
    native_ext.pin_threads(int(os.environ.get(
        "HSEARCH_THREADS", native_ext.default_process_threads(1))))
    n = int(args.n_proteins)
    seqs, n_fam = make_corpus(n)
    if args.indels:
        seqs = add_indels(seqs, n_fam)
    db = _DB(seqs)
    print(f"# {n} proteins on {card(dev)}", file=sys.stderr, flush=True)
    rows, res = {}, {}
    for gapped in (False, True):
        t0 = time.perf_counter()
        r = pcluster.cluster_proteins(
            db, torch.Generator().manual_seed(0), tables=args.tables,
            bits=args.bits, sigma=args.sigma, gapped=gapped, device=dev)
        wall = time.perf_counter() - t0
        res[gapped] = r
        rows[gapped] = {
            "wall_s": round(wall, 2),
            "proteins_per_s": round(n / wall, 1),
            "hits": len(r.hits),
            "clusters": len(set(r.labels.tolist())),
            "family_pair_recall": round(family_recall(r.labels, n_fam), 4)}

    base = best_by_pair(res[False].hits)
    ref = best_by_pair(res[True].hits)
    improved = [(base[k], ref[k]) for k in base
                if k in ref and ref[k].score > base[k].score]
    # e-values underflow to 0.0 on this corpus (scores are large); the
    # log10 ratio is only meaningful where both sides are nonzero
    d_log10e = [np.log10(r.evalue) - np.log10(b.evalue)
                for b, r in improved if r.evalue > 0 and b.evalue > 0]
    out = {
        "bench": "gapped_ab", "proteins": n, "tables": args.tables,
        "bits": args.bits, "sigma": args.sigma, "indels": args.indels,
        "device": dev.type,
        "ungapped": rows[False], "gapped": rows[True],
        "wall_overhead_pct": round(
            100.0 * (rows[True]["wall_s"] / rows[False]["wall_s"] - 1), 1)
        if rows[False]["wall_s"] > 0 else None,
        "pairs": len(base),
        "pairs_improved": len(improved),
        "pairs_with_gaps": sum(1 for _, r in improved if r.gap_open > 0),
        "mean_identity_delta": _mean([r.identity - b.identity
                                      for b, r in improved], 2),
        "mean_aln_len_delta": _mean([r.aln_len - b.aln_len
                                     for b, r in improved], 2),
        "mean_score_delta": _mean([r.score - b.score
                                   for b, r in improved], 1),
        "mean_bits_delta": _mean([r.bits - b.bits for b, r in improved], 1),
        "mean_log10_evalue_delta": round(float(np.mean(d_log10e)), 2)
        if d_log10e else None,
        "pairs_evalue_underflow": sum(1 for b, r in improved
                                      if r.evalue == 0 or b.evalue == 0),
        "recall_delta": round(rows[True]["family_pair_recall"]
                              - rows[False]["family_pair_recall"], 4)}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
