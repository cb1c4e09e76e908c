"""Self-check of distributed protein clustering on a local cluster
(counterpart of hsearch_tpu/cluster/_mp_pcluster_check.py).

Run as a module it is one process of the cluster:

    python -m hsearch_tpu_torch.cluster._mp_pcluster_check <pid> <nproc> <port>

Each process runs ``cluster_proteins_distributed`` over the same corpus and
asserts, against single-process ``cluster_proteins`` on the same draws
(computed in-process, or given):

  * the labels are identical (and so identical on every process);
  * the pre-group lists are identical;
  * the union of every process's hits, gathered by one more all-gather,
    is the single-process hit set, every numeric field equal;

and, with more than one process and more than one group, that no process
aligned every query.  It prints ``MP_CHECK_OK p<pid>`` with the partition
modes when every assertion held.

The collectives run on gloo (CPU tensors); environment knobs choose the
rest:

  PCLUSTER_CHECK_{N,TABLES,SIGMA,BITS}  synthetic workload and KLSH point
  PCLUSTER_CHECK_DEVICE                 compute device (default cpu)
  PCLUSTER_CHECK_DB                     an .npz corpus (``seq``,
                                        ``starts``) instead
  PCLUSTER_CHECK_NPZ                    an .npz with any of: ``w``
                                        (T, F, bits), ``t`` and ``b``
                                        (T, bits), the KLSH draws to carry
                                        (such as the JAX package's); the
                                        expected ``labels``, ``pre_groups``
                                        (concatenated) with
                                        ``pre_group_sizes``, and ``hit_rows``
                                        (``_hit_rows``), which replace the
                                        in-process reference
"""

from __future__ import annotations

import os
import sys

import numpy as np

N_PROTEINS = int(os.environ.get("PCLUSTER_CHECK_N", "240"))
N_FAMILIES = max(N_PROTEINS // 4, 1)
PROT_LEN = 100
TABLES = int(os.environ.get("PCLUSTER_CHECK_TABLES", "3"))
# sigma 0.1 forms a handful of giant pre-groups (query mode); the default
# forms many small ones (group mode)
SIGMA = float(os.environ.get("PCLUSTER_CHECK_SIGMA", "0.2"))
BITS = int(os.environ.get("PCLUSTER_CHECK_BITS", "16"))
SEED = 11


class _DB:
    """A minimal ProteinDB-shaped corpus (names, seq, starts, protein)."""

    def __init__(self, prots=None, seq=None, starts=None):
        if prots is not None:
            seq = np.concatenate(prots)
            starts = np.concatenate([[0], np.cumsum([len(p)
                                                     for p in prots])])
        self.seq = np.asarray(seq).astype(np.int32)
        self.starts = np.asarray(starts).astype(np.int64)
        self.num_proteins = len(self.starts) - 1
        self.names = [f"p{i}" for i in range(self.num_proteins)]

    def protein(self, i):
        return self.seq[self.starts[i]:self.starts[i + 1]]


def _workload() -> _DB:
    rng = np.random.default_rng(20260819)
    prots = []
    for _ in range(N_FAMILIES):
        base = rng.integers(0, 20, PROT_LEN, dtype=np.int32)
        for _ in range(N_PROTEINS // N_FAMILIES):
            p = base.copy()
            sub = rng.integers(0, PROT_LEN, 3)
            p[sub] = rng.integers(0, 20, 3)
            prots.append(p)
    return _DB(prots[:N_PROTEINS])


def _hit_rows(hits) -> np.ndarray:
    """Hits as sortable int32 rows (the e-value as its float32 bits)."""
    n = len(hits)
    cols = [np.fromiter((getattr(h, f) for h in hits), np.int64, n)
            for f in ("query", "subject", "score", "q_beg", "q_end",
                      "d_beg", "d_end")]
    ev = np.fromiter((h.evalue for h in hits), np.float64, n)
    cols.append(ev.astype(np.float32).view(np.int32))
    return np.stack(cols, axis=1).astype(np.int32).reshape(n, 8)


def _canon(rows: np.ndarray) -> np.ndarray:
    return rows[np.lexsort(rows.T[::-1])] if len(rows) else rows


def child_main(pid: int, nproc: int, port: int) -> None:
    import time

    import torch
    import torch.distributed as dist

    from hsearch_tpu_torch import native_ext
    from hsearch_tpu_torch.cluster import pcluster, pcluster_dist
    from hsearch_tpu_torch.parallel import multihost

    native_ext.pin_threads(int(os.environ.get(
        "HSEARCH_THREADS", native_ext.default_process_threads(nproc))))

    multihost.initialize(f"127.0.0.1:{port}", nproc, pid, device="cpu",
                         timeout_s=600)
    try:
        assert multihost.process_count() == nproc
        dev = os.environ.get("PCLUSTER_CHECK_DEVICE", "cpu")
        path = os.environ.get("PCLUSTER_CHECK_DB")
        db = _DB(**{k: v for k, v in np.load(path).items()}) if path \
            else _workload()
        npz = os.environ.get("PCLUSTER_CHECK_NPZ")
        extra = dict(np.load(npz)) if npz else {}
        kp = [pcluster.klsh_params_from_arrays(*x) for x in
              zip(extra["w"], extra["t"], extra["b"])] if "w" in extra \
            else None
        tables = len(kp) if kp else TABLES
        kw = dict(bits=BITS, sigma=SIGMA, tables=tables, render=False,
                  klsh_params=kp, device=dev)

        def gen():
            return None if kp else torch.Generator().manual_seed(SEED)

        ref_s = None
        if "labels" in extra:
            labels = extra["labels"]
            cuts = np.cumsum(extra["pre_group_sizes"])[:-1]
            pre_groups = np.split(extra["pre_groups"], cuts)
            want = extra["hit_rows"]
        else:
            # the reference first: it also warms the device up
            t0 = time.perf_counter()
            ref = pcluster.cluster_proteins(db, gen(), **kw)
            ref_s = round(time.perf_counter() - t0, 3)
            labels, pre_groups = ref.labels, ref.pre_groups
            want = _hit_rows(ref.hits)
        st: dict = {}
        t0 = time.perf_counter()
        got = pcluster_dist.cluster_proteins_distributed(db, gen(), **kw,
                                                         stats_out=st)
        dist_s = time.perf_counter() - t0

        np.testing.assert_array_equal(got.labels, labels)
        assert len(got.pre_groups) == len(pre_groups), \
            (len(got.pre_groups), len(pre_groups))
        for a, b in zip(got.pre_groups, pre_groups):
            np.testing.assert_array_equal(a, b)
        # the union of every process's hits is the single-process hit set
        mine = _hit_rows(got.hits)
        merged = pcluster_dist._allgather_rows(mine, 8)
        np.testing.assert_array_equal(_canon(merged), _canon(want))
        if nproc > 1 and len(pre_groups) > 1:
            assert len(mine) < len(want), "one process did all the work"
        print(f"MP_CHECK_OK p{pid}/{nproc} labels={len(set(labels.tolist()))}"
              f" hits_local={len(mine)}/{len(want)} modes="
              f"{','.join(st['modes'])} seconds={dist_s:.3f} "
              f"ref_seconds={ref_s}", flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    child_main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]))
