"""A large query batch streamed through ivf.search.

    python -m hsearch_tpu_torch.examples.bench_stream [log2_n] [--c=4096]
        [--cb=1024] [--kb=128] [--device cuda]

Streams C >= 4096 queries in center blocks of ``cb`` (the per-call host
costs amortize across C/cb blocks) on the bench workload (default 2^20
rows) and reports q/s (best of 3 calls after one warm-up), per-query wall
ms, weighted recall on a 256-query sample against the exact oracle, and
the effective FLOP/s of the prune and verify work, counted as the JAX
package's script counts it:

    prune:  2 * D * B        flop/query   (D = 8L dims, B = blocks)
    verify: 2 * 20L * kb*bs  flop/query   (the one-hot P-table contraction)

On the card the same rate is also given as a share of the H100's
published float32 peak (67 TFLOP/s, SXM data sheet); on the CPU that
share is null.
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
from ..search import evaluate, exact, ivf

# published peak of one H100 SXM (NVIDIA data sheet): float32 outside the
# tensor cores
PEAK_F32_FLOPS = 67e12
L, RADIUS, SAMPLE = 25, 35.0, 256


def flops_per_query(l: int, num_blocks: int, kb: int, bs: int = 32) -> float:
    d = 8 * l
    return 2.0 * d * num_blocks + 2.0 * (20 * l) * kb * bs


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("log2_n", nargs="?", type=int, default=20)
    ap.add_argument("--c", type=int, default=4096, help="queries")
    ap.add_argument("--cb", type=int, default=1024, help="center block")
    ap.add_argument("--kb", type=int, default=128, help="k_blocks")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)
    log2n, cb, kb = args.log2_n, args.cb, args.kb
    rng = np.random.default_rng(0)
    db, centers = protein_like_db(rng, 1 << log2n, L, query_n=args.c)
    c = centers.shape[0]
    index = ivf.build_index(db, torch.Generator().manual_seed(0),
                            block_size=32, device=dev)
    print(f"# built n=2^{log2n} B={index.num_blocks} c={c} cb={cb} kb={kb} "
          f"on {card(dev)}", file=sys.stderr, flush=True)
    kw = dict(k_blocks=kb, max_hits=512, center_block=cb,
              retry_overflow=False, stats_out={})
    ivf.search(index, centers[:cb], RADIUS, **kw)             # warm-up
    best = None
    for _ in range(3):
        t0 = time.perf_counter()
        ci, ki, _ = ivf.search(index, centers, RADIUS, **kw)
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    qps = c / best
    sample = centers[:SAMPLE]
    gci, gki, gd = exact.search_radius(db, sample, RADIUS, max_hits=2048,
                                       device=dev)
    m = ci < SAMPLE
    rep = evaluate.recall_from_indices(gci, gki, gd, ci[m], ki[m], RADIUS)
    rate = qps * flops_per_query(L, index.num_blocks, kb)
    print(json.dumps({
        "bench": "stream", "n_log2": log2n, "c": c, "cb": cb, "kb": kb,
        "qps": round(qps, 1), "ms_per_query": round(1000 * best / c, 3),
        "gemm_gflops": round(rate / 1e9, 1),
        "f32_peak_share": rate / PEAK_F32_FLOPS if dev.type == "cuda"
        else None,
        "sample_recall": round(rep.recall, 4),
        "hits": int(len(ci)), "device": card(dev)}), flush=True)


if __name__ == "__main__":
    main()
