"""Headline benchmark of the port: motif-search throughput on one card.

    python -m hsearch_tpu_torch.bench [--log2n 20] [--centers 4096]
                                      [--device cuda]

The workload of the JAX package's ``bench.py``: a family-structured k-mer
corpus (motif families with Poisson(2) substitutions, the IGC/Pfam shape)
at the reference's motif length L = 25 and radius R = 35, made from
``numpy.random.default_rng(0)``.  The engine under test is the
block-pruned IVF engine (``search/ivf.py``, both CUDA kernels on the
card): ``k_blocks`` climbs the ladder 128 -> 256 -> 512 until weighted
recall against the exact oracle reaches 0.99, with the lossless retry off,
then 3 calls are timed.  The baseline is the port's exact oracle
(``search/exact.py``) on the same device and workload.

Prints ONE JSON line on stdout:
    {"metric": "motif_search_throughput", "value": qps,
     "unit": "center queries/s/chip", "vs_baseline": speedup}
and a summary on stderr: the chosen kb, weighted recall, hits, each timed
call's ms (min/median/max), kernel launches per call, and the card's name
and power limit.  A failure (no CUDA device without ``--device cpu``, a
kernel that does not build, recall below 0.99 at the top of the ladder)
exits non-zero; nothing falls back to the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

from . import _device
from .ops import cuda_kernels
from .search import evaluate, exact, ivf

N_LOG2, N_CENTERS, L, RADIUS = 20, 4096, 25, 35.0
BLOCK_SIZE, CENTER_BLOCK, MAX_HITS, ORACLE_BLOCK = 32, 1024, 512, 256
# the oracle's cap is 4x the engine's, so a center with more than MAX_HITS
# true hits cannot silently shrink the recall denominator
ORACLE_MAX_HITS = 4 * MAX_HITS
KB_LADDER, RECALL_GATE, ITERS, PACK_CAP_FRAC = (128, 256, 512), 0.99, 3, 4


def protein_like_db(rng, n, l, family_size=64, query_n=256,
                    return_families=False):
    """Motif families (centers + Poisson-flip members), realistic shape.

    The same numpy calls as the JAX package's ``bench.protein_like_db``,
    so one ``rng`` gives the same arrays.  return_families=True also
    returns each row's family id (for clustering-quality gates)."""
    nfam = max(1, n // family_size)
    query_n = min(query_n, nfam)     # tiny sizes have few families
    fam = rng.integers(0, 20, (nfam, l), dtype=np.int32)
    which = rng.integers(0, nfam, n)
    db = fam[which].copy()
    # vectorized per-row substitutions: flip positions where a per-cell
    # uniform draw ranks below the row's Poisson flip count
    flips = rng.poisson(2.0, n).clip(0, l)
    ranks = np.argsort(rng.random((n, l)), axis=1)
    mask = ranks < flips[:, None]
    sub = rng.integers(0, 20, (n, l))
    db = np.where(mask, sub, db).astype(np.int32)
    q = fam[rng.choice(nfam, query_n, replace=False)]
    if return_families:
        return db, q, which
    return db, q


def card(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi reports them
    (``torch.cuda.get_device_name`` where nvidia-smi is absent), or
    ``"cpu"``."""
    if dev.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.splitlines()
        return out[dev.index or 0].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(dev)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@dataclasses.dataclass
class LadderResult:
    """``record``: JSON-ready numbers of the run; ``truth``: the oracle's
    (center, kmer, dist) arrays; ``rungs``: (kb, (center, kmer, dist)) of
    each ladder rung searched."""
    record: dict
    truth: tuple
    rungs: list


def run_ladder(index: ivf.IVFIndex, db: np.ndarray, centers: np.ndarray,
               radius: float = RADIUS, center_block: int = CENTER_BLOCK,
               ladder=KB_LADDER, iters: int = ITERS, log=None
               ) -> LadderResult:
    """The bench's measurement on a built index.

    The exact oracle (one untimed warm-up over the first ORACLE_BLOCK
    centers, then one timed call), the k_blocks ladder to weighted recall
    >= RECALL_GATE (retry off; its calls are the engine's warm-up), then
    ``iters`` timed calls at the chosen kb.  ``center_block`` is capped at
    the number of centers.  Kernel launches are read as differences of
    ``cuda_kernels.launch_counts()``, which this function never resets.
    """
    log = log or (lambda msg: None)
    dev = index.device
    c = int(centers.shape[0])
    cb = min(center_block, c)
    exact.search_radius(db, centers[:ORACLE_BLOCK], radius,
                        center_block=ORACLE_BLOCK,
                        max_hits=ORACLE_MAX_HITS, device=dev)
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as wlog:
        warnings.simplefilter("always")
        truth = exact.search_radius(db, centers, radius,
                                    center_block=ORACLE_BLOCK,
                                    max_hits=ORACLE_MAX_HITS, device=dev)
    oracle_s = time.perf_counter() - t0
    truncated = [str(w.message) for w in wlog
                 if "max_hits" in str(w.message)]
    for msg in truncated:
        log(f"# ORACLE TRUNCATED: {msg} - recall denominator incomplete")
    gci, gki, gd = truth

    def search(kb, stats):
        return ivf.search(index, centers, radius, k_blocks=kb,
                          max_hits=MAX_HITS, center_block=cb,
                          retry_overflow=False, stats_out=stats,
                          pack_cap_frac=PACK_CAP_FRAC)

    rungs, rows = [], []
    rep = kb = stats = None
    for kb in ladder:
        stats = {}
        hits = search(kb, stats)
        rep = evaluate.recall_from_indices(gci, gki, gd, hits[0], hits[1],
                                           radius)
        rungs.append((kb, hits))
        rows.append({"kb": kb, "recall": rep.recall, "hits": len(hits[0]),
                     "stats": stats})
        log(f"# kb={kb} recall={rep.recall:.6f} stats={stats}")
        if rep.recall >= RECALL_GATE:
            break
    before = cuda_kernels.launch_counts()
    call_s = []
    for _ in range(iters):
        _sync(dev)
        t0 = time.perf_counter()
        search(kb, {})
        call_s.append(time.perf_counter() - t0)
    after = cuda_kernels.launch_counts()
    qps = c / (sum(call_s) / iters)
    record = {
        "n": int(db.shape[0]), "c": c, "l": int(db.shape[1]),
        "radius": radius, "center_block": cb,
        "blocks": index.num_blocks, "kb": kb, "recall": rep.recall,
        "ladder": rows, "hits": len(rungs[-1][1][0]),
        "truth_hits": int(len(gci)), "oracle_truncated": truncated,
        "oracle_s": oracle_s, "oracle_qps": c / oracle_s,
        "call_s": call_s, "qps": qps, "stats": stats,
        "launches_per_call": {k: (after[k] - before[k]) / iters
                              for k in after},
        "device": str(dev)}
    return LadderResult(record, truth, rungs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="motif-search throughput of the IVF engine")
    ap.add_argument("--log2n", type=int, default=N_LOG2,
                    help="database rows, log2 (default %(default)s)")
    ap.add_argument("--centers", type=int, default=N_CENTERS,
                    help="query centers (default %(default)s; clamped to "
                         "the family count)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    rng = np.random.default_rng(0)
    db, centers = protein_like_db(rng, 1 << args.log2n, L,
                                  query_n=args.centers)
    log(f"# workload ready n={db.shape[0]} c={centers.shape[0]} on {dev}")
    if dev.type == "cuda":
        cuda_kernels.build()
    t0 = time.perf_counter()
    index = ivf.build_index(db, torch.Generator().manual_seed(0),
                            block_size=BLOCK_SIZE, device=dev)
    _sync(dev)
    build_s = time.perf_counter() - t0
    log(f"# build done {build_s:.3f}s B={index.num_blocks}")
    res = run_ladder(index, db, centers, log=log).record
    if res["recall"] < RECALL_GATE:
        raise SystemExit(f"weighted recall {res['recall']} < {RECALL_GATE} "
                         f"at the top of the kb ladder {KB_LADDER}")
    vs = res["qps"] / res["oracle_qps"]
    print(json.dumps({
        "metric": "motif_search_throughput",
        "value": round(res["qps"], 2),
        "unit": "center queries/s/chip",
        "vs_baseline": round(vs, 3),
    }), flush=True)
    ms = sorted(1e3 * s for s in res["call_s"])
    log(f"# n={res['n']} c={res['c']} l={L} R={RADIUS} kb={res['kb']} "
        f"build={build_s:.3f}s ivf={res['qps']:.1f} q/s "
        f"card_brute={res['oracle_qps']:.1f} q/s "
        f"weighted_recall={res['recall']:.6f} "
        f"hits={res['hits']}/{res['truth_hits']} "
        f"call_ms min/median/max={ms[0]:.3f}/{ms[len(ms) // 2]:.3f}/"
        f"{ms[-1]:.3f} launches_per_call="
        f"{json.dumps(res['launches_per_call'])} card={card(dev)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
