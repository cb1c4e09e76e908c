"""Distributed protein-clustering throughput: cluster_proteins_distributed
over an N-process torch.distributed cluster on one machine.

    python -m hsearch_tpu_torch.examples.bench_pcluster_mp [n_proteins]
        [--nproc=2] [--tables=4] [--single] [--logdir=DIR]
        [--timeout=3600] [--device cuda]

Each process generates the SAME family corpus (deterministic, vectorized:
4-member families of 120 aa with 4 substitutions, the bench_align
workload), joins the cluster, and runs the distributed pipeline: KLSH
codes everywhere, groups bin-packed across processes, per-process group
alignment, one (query, subject, union_flag) edge all-gather per table,
union-find everywhere.  Process 0 reports wall time, proteins/s, cluster
count and planted family-pair recall.  ``--single`` runs the
single-process pipeline on the same corpus for a direct A/B.

The processes compute on ``--device`` (every rank on the one card when
there is one) and exchange edge rows over gloo: NCCL refuses two ranks on
one card.  A rank that has not finished within ``--timeout`` seconds fails
the run, and every process is killed.  Environment knobs, as in the JAX
package's script: HSEARCH_THREADS (torch host threads and the C++ host
library's OpenMP pool per process, default an even share of the cores),
HSEARCH_KLSH_BITS / HSEARCH_KLSH_SIGMA (the KLSH point), HSEARCH_STREAM=1 (hits stream through a counting sink,
strings unrendered).
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

from .. import _device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MODULE = "hsearch_tpu_torch.examples.bench_pcluster_mp"


def make_corpus(n: int):
    """Vectorized twin of bench_align's corpus (families differ in rng
    detail; same structure: n//4 families x 4 members, 120 aa, 4 subs)."""
    rng = np.random.default_rng(7)
    n_fam = max(1, n // 4)
    plen = 120
    bases = rng.integers(0, 20, (n_fam, plen), dtype=np.int32)
    fam_of = np.arange(n) % n_fam
    seqs = bases[fam_of].copy()
    sub_pos = rng.integers(0, plen, (n, 4))
    sub_aa = rng.integers(0, 20, (n, 4), dtype=np.int32)
    seqs[np.arange(n)[:, None], sub_pos] = sub_aa
    tail = n - n_fam * 4
    if tail > 0:
        seqs[n_fam * 4:] = rng.integers(0, 20, (tail, plen), dtype=np.int32)
    return seqs, n_fam


class _DB:
    def __init__(self, seqs):
        n, plen = seqs.shape
        self.names = [f"p{i}" for i in range(n)]
        # a view, not an astype copy: at 9.9M proteins the copy is 4.7 GB
        self.seq = np.ascontiguousarray(seqs, np.int32).reshape(-1)
        self.starts = (np.arange(n + 1, dtype=np.int64) * plen)
        self.num_proteins = n

    def protein(self, i):
        return self.seq[self.starts[i]:self.starts[i + 1]]


def family_recall(labels: np.ndarray, n_fam: int) -> float:
    members = np.arange(n_fam * 4).reshape(4, n_fam).T
    lab = labels[members]
    pairs = recovered = 0
    for a in range(4):
        for b in range(a + 1, 4):
            pairs += n_fam
            recovered += int((lab[:, a] == lab[:, b]).sum())
    return recovered / max(pairs, 1)


def child_main(pid, nproc, port, n, tables, device, timeout_s):
    import resource

    import torch
    import torch.distributed as dist

    from .. import native_ext
    from ..cluster import pcluster, pcluster_dist
    from ..parallel import multihost

    native_ext.pin_threads(int(os.environ.get(
        "HSEARCH_THREADS", native_ext.default_process_threads(nproc))))
    bits = int(os.environ.get("HSEARCH_KLSH_BITS", pcluster.DEFAULT_BITS))
    sigma = float(os.environ.get("HSEARCH_KLSH_SIGMA",
                                 pcluster.DEFAULT_SIGMA))
    stream = bool(int(os.environ.get("HSEARCH_STREAM", "0")))
    if nproc > 1:
        multihost.initialize(f"127.0.0.1:{port}", nproc, pid, device="cpu",
                             timeout_s=timeout_s)
    try:
        seqs, n_fam = make_corpus(n)
        db = _DB(seqs)
        del seqs
        t0 = time.perf_counter()
        n_stream_hits = 0

        # the corpus-scale operating point (HSEARCH_STREAM=1): hits stream
        # through a counting sink (union edges taken as they pass),
        # strings unrendered, so each process holds O(slice + index)
        def _count(chunk_hits):
            nonlocal n_stream_hits
            n_stream_hits += len(chunk_hits)

        kw = dict(tables=tables, bits=bits, sigma=sigma, device=device)
        if stream:
            kw.update(hit_sink=_count, render=False)
        gen = torch.Generator().manual_seed(0)
        if nproc > 1:
            res = pcluster_dist.cluster_proteins_distributed(db, gen, **kw)
        else:
            res = pcluster.cluster_proteins(db, gen, **kw)
        wall = time.perf_counter() - t0
    finally:
        if nproc > 1:
            dist.destroy_process_group()
    out = {"bench": "cluster_proteins_mp", "proteins": n,
           "nproc": nproc, "pid": pid, "tables": tables,
           "bits": bits, "sigma": sigma, "stream": stream,
           "device": device,
           "peak_rss_gb": round(resource.getrusage(
               resource.RUSAGE_SELF).ru_maxrss / 1e6, 2),
           "local_hits": n_stream_hits if stream else len(res.hits),
           "total_s": round(wall, 2),
           "proteins_per_s": round(n / wall, 1)}
    if pid == 0:
        out["clusters"] = len(set(res.labels.tolist()))
        out["family_pair_recall"] = round(family_recall(res.labels, n_fam),
                                          4)
    print("CHILD " + json.dumps(out), flush=True)


def run_cluster(n, nproc, tables, device, logdir, timeout_s):
    """Start the ``nproc`` processes, wait for all of them (killing every
    one when ``timeout_s`` passes or one fails), and return each one's
    output."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    paths = [os.path.join(logdir, f"child{p}.log") for p in range(nproc)]
    logs = [open(p, "w") for p in paths]
    procs = []
    try:
        for p in range(nproc):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", MODULE, "--child", str(p),
                 str(nproc), str(port), str(n), str(tables), device,
                 str(timeout_s)],
                env=env, stdout=logs[p], stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout_s
        while any(pr.poll() is None for pr in procs):
            if time.monotonic() > deadline or any(
                    pr.returncode not in (None, 0) for pr in procs):
                break
            time.sleep(0.2)
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
            pr.wait()
        for f in logs:
            f.close()
    outs = [open(p).read() for p in paths]
    bad = [i for i, pr in enumerate(procs) if pr.returncode != 0]
    if bad:
        print("\n---\n".join(outs), file=sys.stderr)
        raise SystemExit(f"children failed or timed out: {bad}")
    return outs


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "--child":
        pid, nproc, port, n, tables = map(int, argv[1:6])
        child_main(pid, nproc, port, n, tables, argv[6], float(argv[7]))
        return {}
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n_proteins", nargs="?", type=float, default=10000)
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--tables", type=int, default=4)
    ap.add_argument("--single", action="store_true",
                    help="one process running cluster_proteins")
    ap.add_argument("--logdir", default=None,
                    help="keep each process's output in DIR/child<p>.log")
    ap.add_argument("--timeout", type=float, default=3600.0,
                    help="seconds before a rank that has not finished "
                         "fails the run")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)
    n = int(args.n_proteins)
    nproc = 1 if args.single else args.nproc
    t0 = time.perf_counter()
    if args.logdir:
        os.makedirs(args.logdir, exist_ok=True)
        outs = run_cluster(n, nproc, args.tables, dev.type, args.logdir,
                           args.timeout)
    else:
        with tempfile.TemporaryDirectory() as logdir:
            outs = run_cluster(n, nproc, args.tables, dev.type, logdir,
                               args.timeout)
    wall = time.perf_counter() - t0
    rows = []
    for o in outs:
        for line in o.splitlines():
            if line.startswith("CHILD "):
                rows.append(json.loads(line[6:]))
            else:
                print(line, file=sys.stderr)
    head = next(r for r in rows if r["pid"] == 0)
    summary = {
        "bench": "cluster_proteins_mp", "proteins": n, "nproc": nproc,
        "tables": args.tables, "device": dev.type,
        "wall_s": round(wall, 2), "proteins_per_s": round(n / wall, 1),
        "slowest_child_s": max(r["total_s"] for r in rows),
        "total_hits": sum(r["local_hits"] for r in rows),
        "clusters": head.get("clusters"),
        "family_pair_recall": head.get("family_pair_recall")}
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
