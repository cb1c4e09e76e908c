"""Self-check of distributed greedy k-mer clustering on a local cluster
(counterpart of hsearch_tpu/cluster/_mp_greedy_check.py).

Run as a module it is one process of the cluster:

    python -m hsearch_tpu_torch.cluster._mp_greedy_check <pid> <nproc> <port>

Each process runs single-process ``cluster_greedy`` and then
``cluster_greedy_distributed`` over the same k-mers and draws, and
asserts parent / merged bit-identical and the cluster sizes equal; then
that ``postprocess.merge_by_center_distance`` gives the same labels from
either result.  It prints ``MP_CHECK_OK p<pid>`` when every assertion
held, with the seconds of each run (the first one includes the
process's warm-up).  ``parallel._mp_check.run_local_cluster(module=...)``
spawns it.

The collectives run on gloo (CPU tensors); environment knobs choose the
rest:

  GREEDY_CHECK_N, GREEDY_CHECK_L   synthetic workload rows, rounds
  GREEDY_CHECK_DEVICE              compute device (default cpu)
  GREEDY_CHECK_KMERS               an (N, L) .npy of k-mers instead
  GREEDY_CHECK_NPZ                 an .npz with any of: ``config``
                                   [hash_k, hash_l, w, radius], ``seed``
                                   (of the rounds' generator), ``round_a``
                                   (hash_l, D, K) and ``round_b``
                                   (hash_l, K) (draws to carry, such as
                                   the JAX package's), and the expected
                                   ``parent`` / ``merged``
  GREEDY_CHECK_MERGE_RADIUS        the merge check's radius (0 skips it)
"""

from __future__ import annotations

import os
import sys

import numpy as np

N_POINTS = int(os.environ.get("GREEDY_CHECK_N", "4096"))
KMER_LEN = 8
N_FAMILIES = 48
HASH_L = int(os.environ.get("GREEDY_CHECK_L", "6"))
SEED = 5


def _workload() -> np.ndarray:
    rng = np.random.default_rng(20260820)
    fam = rng.integers(0, 20, (N_FAMILIES, KMER_LEN), dtype=np.int32)
    which = rng.integers(0, N_FAMILIES, N_POINTS)
    km = fam[which].copy()
    flip = rng.integers(0, KMER_LEN, N_POINTS)
    km[np.arange(N_POINTS), flip] = rng.integers(0, 20, N_POINTS)
    return km


def child_main(pid: int, nproc: int, port: int) -> None:
    import time

    import torch
    import torch.distributed as dist

    from hsearch_tpu_torch import native_ext
    from hsearch_tpu_torch.cluster import greedy, greedy_dist, postprocess
    from hsearch_tpu_torch.parallel import multihost

    native_ext.pin_threads(int(os.environ.get(
        "HSEARCH_THREADS", native_ext.default_process_threads(nproc))))

    multihost.initialize(f"127.0.0.1:{port}", nproc, pid, device="cpu",
                         timeout_s=600)
    try:
        assert multihost.process_count() == nproc
        dev = os.environ.get("GREEDY_CHECK_DEVICE", "cpu")
        path = os.environ.get("GREEDY_CHECK_KMERS")
        km = np.load(path) if path else _workload()
        npz = os.environ.get("GREEDY_CHECK_NPZ")
        extra = dict(np.load(npz)) if npz else {}
        cfg = greedy.ClusterConfig(hash_l=HASH_L)
        if "config" in extra:
            k, l, w, r = extra["config"].tolist()
            cfg = greedy.ClusterConfig(hash_k=int(k), hash_l=int(l), w=w,
                                       radius=r)
        seed = int(extra.get("seed", SEED))
        rp = list(zip(extra["round_a"], extra["round_b"])) \
            if "round_a" in extra else None

        def gen():
            return None if rp else torch.Generator().manual_seed(seed)

        # the reference first: it also warms the device up, so the
        # distributed run's seconds are warm
        t0 = time.perf_counter()
        ref = greedy.cluster_greedy(km, gen(), cfg, rp, device=dev)
        ref_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = greedy_dist.cluster_greedy_distributed(km, gen(), cfg, rp,
                                                     device=dev)
        dist_s = time.perf_counter() - t0
        np.testing.assert_array_equal(got.parent, ref.parent)
        np.testing.assert_array_equal(got.merged, ref.merged)
        if "parent" in extra:
            np.testing.assert_array_equal(got.parent, extra["parent"])
            np.testing.assert_array_equal(got.merged, extra["merged"])
        sizes = sorted(len(c) for c in got.clusters())
        assert sizes == sorted(len(c) for c in ref.clusters())

        merge_r = float(os.environ.get("GREEDY_CHECK_MERGE_RADIUS", "20"))
        n_merged = None
        if merge_r:
            # the --merge-radius pass on the distributed labels equals the
            # single-process pipeline's on every process
            def merged(res):
                lab = np.where(res.parent >= 0, res.parent,
                               np.arange(len(res.parent)))
                return postprocess.merge_by_center_distance(
                    km, lab, merge_r, torch.Generator().manual_seed(6),
                    device=dev)

            lab_d = merged(got)
            np.testing.assert_array_equal(lab_d, merged(ref))
            n_merged = len(np.unique(lab_d))
            assert n_merged <= len(sizes)
        print(f"MP_CHECK_OK p{pid}/{nproc} greedy clusters={len(sizes)} "
              f"merged={n_merged} seconds={dist_s:.3f} "
              f"ref_seconds={ref_s:.3f}", flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    child_main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]))
