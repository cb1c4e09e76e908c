"""The segmented index at out-of-memory scale, under resident budgets.

    python -m hsearch_tpu_torch.examples.bench_stream27 [--log2n=27]
        [--segment-log2=24] [--budgets=0,2,4] [--queries=1024]
        [--oracle-segments=2] [--kbs=128] [--save=PATH] [--load=PATH]
        [--device cuda]

2^27 family-structured k-mer points (about 3.4 GB of int8) indexed as
segments of 2^24 points (search/stream.py) and searched with the exact
min-cascade select at kb 128 (HSEARCH_STREAM_KB or ``--kbs`` change it).
Reports, per resident-segment budget (the number of leading segments
kept on the card; the rest stream through it, double-buffered):

  * q/s for a ``--queries``-center batch,
  * the per-segment byte size and the build (or checkpoint load) time,
  * sample weighted recall against the exact oracle over the first
    ``--oracle-segments`` segments and 64 queries (the oracle decomposes
    over segments as the engine does, so a subset gives an unbiased recall
    denominator for the sampled part of the database).

``--save`` writes the built index as a ``segivf`` checkpoint and
``--load`` reuses one (queries are drawn again from the family matrix
alone).  One JSON line per (budget, kb) on stdout.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from .. import _device
from ..bench import card
from ..search import evaluate, exact, stream
from ..utils import checkpoint

K = 25
RADIUS = 35.0
FAMILY = 64


def _queries(fam: np.ndarray, seed: int) -> np.ndarray:
    # a dedicated query rng: the --load path draws the queries again
    # without replaying the corpus draws
    qrng = np.random.default_rng(seed + 1)
    return fam[qrng.choice(len(fam), min(4096, len(fam)),
                           replace=False)].astype(np.int32)


def make_kmers(n: int, seed: int = 27) -> tuple[np.ndarray, np.ndarray]:
    """Family-structured rows (bench.protein_like_db's shape, in chunks of
    2^22 rows so the temporaries stay bounded at 2^27) and 4096 family
    centers as queries."""
    rng = np.random.default_rng(seed)
    nfam = max(1, n // FAMILY)
    fam = rng.integers(0, 20, (nfam, K), dtype=np.int8)
    out = np.empty((n, K), np.int8)
    step = 1 << 22
    for lo in range(0, n, step):
        m = min(step, n - lo)
        which = rng.integers(0, nfam, m)
        rows = fam[which]
        flips = rng.poisson(2.0, m).clip(0, K)
        ranks = np.argsort(rng.random((m, K)), axis=1)
        mask = ranks < flips[:, None]
        sub = rng.integers(0, 20, (m, K), dtype=np.int8)
        out[lo:lo + m] = np.where(mask, sub, rows)
    return out, _queries(fam, seed)


def load_queries(n: int, seed: int = 27) -> np.ndarray:
    """make_kmers' queries without the corpus."""
    rng = np.random.default_rng(seed)
    fam = rng.integers(0, 20, (max(1, n // FAMILY), K), dtype=np.int8)
    return _queries(fam, seed)


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--log2n", type=int, default=27)
    ap.add_argument("--segment-log2", type=int, default=24,
                    help="points per segment, log2")
    ap.add_argument("--budgets", default="0",
                    help="comma-separated resident segment counts")
    ap.add_argument("--queries", type=int, default=1024)
    ap.add_argument("--oracle-segments", type=int, default=2)
    ap.add_argument("--kbs", default=os.environ.get("HSEARCH_STREAM_KB",
                                                    "128"))
    ap.add_argument("--save", default=None)
    ap.add_argument("--load", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)
    budgets = [int(x) for x in args.budgets.split(",")]
    kbs = [int(x) for x in args.kbs.split(",")]
    n = 1 << args.log2n
    seg_pts = min(1 << args.segment_log2, n)

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    log(f"# n=2^{args.log2n} on {card(dev)}")
    if args.load and os.path.exists(args.load):
        # build once, search many: the host byte set reloads in seconds
        t0 = time.perf_counter()
        sidx = checkpoint.load_index(args.load, device=dev)
        build_s = time.perf_counter() - t0
        if sidx.n_points != n:
            raise SystemExit(f"{args.load} holds {sidx.n_points} points, "
                             f"not 2^{args.log2n}")
        queries = load_queries(n)[:args.queries]
        log(f"# segmented index reloaded from {args.load} ({build_s:.0f}s)")
    else:
        t0 = time.perf_counter()
        km, queries = make_kmers(n)
        queries = queries[:args.queries]
        log(f"# workload {km.shape} gen={time.perf_counter() - t0:.0f}s")
        t0 = time.perf_counter()
        sidx = stream.build_segmented(
            km, torch.Generator().manual_seed(0), segment_points=seg_pts,
            progress=lambda i, off: log(
                f"# built segment {i} ({off} pts, "
                f"{time.perf_counter() - t0:.0f}s)"), device=dev)
        build_s = time.perf_counter() - t0
        del km
        if args.save:
            t1 = time.perf_counter()
            checkpoint.save_index(args.save, sidx)
            log(f"# checkpoint -> {args.save} "
                f"({time.perf_counter() - t1:.0f}s)")
    seg_bytes = [s.nbytes for s in sidx.segments]
    log(f"# segmented build/load {build_s:.0f}s segments="
        f"{sidx.num_segments} bytes/seg~{seg_bytes[0] / 1e6:.0f}MB")

    # the oracle on a segment subset: the global truth restricted to those
    # segments' points is the union of the per-segment oracles
    orc_segs = min(args.oracle_segments, sidx.num_segments)
    oc = min(64, len(queries))
    parts = []
    for seg in sidx.segments[:orc_segs]:
        c0, k0, d0 = exact.search_radius(seg.host_kmers, queries[:oc],
                                         RADIUS, max_hits=2048, device=dev)
        parts.append((c0, k0 + seg.offset, d0))
    gci, gki, gd = (np.concatenate(x) for x in zip(*parts))
    last = sidx.segments[orc_segs - 1]
    orc_hi = last.offset + last.n_points
    log(f"# oracle over {orc_segs} segments: {len(gci)} hits")

    rows = []
    for nres in budgets:
        sidx2 = stream.SegmentedIVF(
            segments=sidx.segments, n_points=sidx.n_points,
            kmer_len=sidx.kmer_len, block_size=sidx.block_size,
            resident=[stream.upload_segment(s, dev) if i < nres else None
                      for i, s in enumerate(sidx.segments)], device=dev)
        for kb in kbs:
            st: dict = {}
            stream.search_segmented(sidx2, queries[:64], RADIUS,
                                    k_blocks=kb, max_hits=512)   # warm-up
            t0 = time.perf_counter()
            ci, ki, _ = stream.search_segmented(
                sidx2, queries, RADIUS, k_blocks=kb, max_hits=512,
                center_block=1024, retry_overflow=False, stats_out=st)
            wall = time.perf_counter() - t0
            m = (ci < oc) & (ki < orc_hi)
            rep = evaluate.recall_from_indices(gci, gki, gd, ci[m], ki[m],
                                               RADIUS)
            rows.append({
                "bench": "stream_scale", "n": n, "kb": kb,
                "segments": sidx.num_segments,
                "resident_fraction": round(sidx2.resident_fraction(), 3),
                "queries": int(len(queries)), "wall_s": round(wall, 3),
                "qps": round(len(queries) / wall, 1),
                "sample_recall": round(rep.recall, 4),
                "hits": int(len(ci)), "build_s": round(build_s, 1),
                "bytes_per_segment": int(seg_bytes[0]),
                "stats": {k: int(v) if isinstance(v, (int, np.integer))
                          else v for k, v in st.items()}})
            print(json.dumps(rows[-1]), flush=True)
        del sidx2
    return rows


if __name__ == "__main__":
    main()
