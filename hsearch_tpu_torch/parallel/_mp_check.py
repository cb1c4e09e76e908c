"""Self-check of the multi-process runtime on a local gloo cluster
(counterpart of hsearch_tpu/parallel/_mp_check.py).

Run as a module it is one process of the cluster:

    python -m hsearch_tpu_torch.parallel._mp_check <pid> <nproc> <port>

Each process builds the multi-process LSH index from only its own
database rows through the streamed ingest, and the IVF index from its
local rows; it searches across the cluster and asserts that the merged
hits equal the single-process references computed in-process (LSH: the
single index with the same parameters; IVF: the exact oracle, with every
shard bitwise the one-process build's).  It also checks the padded row
all-gather and the data-parallel train step against one device on the
whole batch, then prints ``MP_CHECK_OK p<pid>``.

``run_local_cluster()`` spawns the processes (CPU tensors, gloo
collectives, ``MP_CHECK_NDEV`` logical devices each); the tests use it.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

# MP_CHECK_N overrides (tests exercise an uneven N: shards then carry
# ragged padding rows through the whole build/search/merge path)
N_POINTS = int(os.environ.get("MP_CHECK_N", "1536"))
KMER_LEN = 8
RADIUS = 22.0
N_CENTERS = 24


def _workload():
    rng = np.random.default_rng(12345)
    fam = rng.integers(0, 20, (N_CENTERS, KMER_LEN), dtype=np.int32)
    which = rng.integers(0, N_CENTERS, N_POINTS)
    db = fam[which].copy()
    flip = rng.integers(0, KMER_LEN, N_POINTS)
    db[np.arange(N_POINTS), flip] = rng.integers(0, 20, N_POINTS)
    return db, fam


def child_main(pid: int, nproc: int, port: int) -> None:
    import torch
    import torch.distributed as dist

    from hsearch_tpu_torch.parallel import (mesh as mesh_lib, multihost,
                                            sharded, train)
    from hsearch_tpu_torch.search import exact, motif

    multihost.initialize(f"127.0.0.1:{port}", nproc, pid, device="cpu",
                         timeout_s=60)
    try:
        assert multihost.process_count() == nproc
        ndev = int(os.environ.get("MP_CHECK_NDEV", "2"))
        mesh = multihost.host_mesh(local_devices=["cpu"] * ndev)
        db, centers = _workload()

        # stream-to-shard ingest: feed global-order chunks, keep local rows
        chunks = (db[s:s + 200] for s in range(0, N_POINTS, 200))
        local = multihost.collect_local_rows(chunks, N_POINTS, mesh)
        lo, hi, _ = multihost.shard_range(N_POINTS, mesh)
        np.testing.assert_array_equal(local, db[lo:hi])

        cfg = motif.MotifSearchConfig(hash_k=4, hash_l=4, w=50.0,
                                      radius=RADIUS, max_hits=512)
        # the LSH build through the streamed ingest (per-shard tensors)
        chunks = (db[s:s + 200] for s in range(0, N_POINTS, 200))
        lsh = multihost.build_lsh_index_streamed(
            chunks, N_POINTS, torch.Generator().manual_seed(7), mesh,
            KMER_LEN, cfg)
        ci, ki, _ = multihost.search(lsh, centers, RADIUS)
        # the single index with the same parameters: the shard merge must
        # equal it (verified hits are exact; sharding only re-partitions
        # the candidates)
        ref = motif.build_index(db, torch.Generator().manual_seed(7), cfg,
                                device="cpu")
        rc, rk, _ = motif.search(ref, centers, cfg)
        assert set(zip(ci.tolist(), ki.tolist())) == \
            set(zip(rc.tolist(), rk.tolist())), "LSH shard merge != single"

        ivf = multihost.build_ivf_index(
            local, N_POINTS, torch.Generator().manual_seed(8), mesh,
            block_size=16, max_hits=512, kmer_len=KMER_LEN)
        ic, ik, idd = multihost.search_ivf(ivf, centers, RADIUS,
                                           k_blocks=96)
        gc, gk, gd = exact.search_radius(db, centers, RADIUS, device="cpu")
        assert set(zip(ic.tolist(), ik.tolist())) == \
            set(zip(gc.tolist(), gk.tolist())), "IVF shard merge != oracle"
        # each shard is bitwise the one a single process builds over the
        # same db shards (shard seeds depend on the global shard only)
        one = sharded.build_ivf_index(
            db, torch.Generator().manual_seed(8),
            mesh_lib.make_mesh(devices=["cpu"] * mesh.shape["db"], data=1),
            block_size=16, max_hits=512)
        for j, s in enumerate(ivf.shards[0]):
            o = one.shards[0][mesh.db_first + j]
            assert (s is None) == (o is None)
            assert s is None or (torch.equal(s.order, o.order)
                                 and torch.equal(s.db_sorted, o.db_sorted))
        om = {(a, b): d for a, b, d in zip(gc, gk, gd)}
        for a, b, d in zip(ic, ik, idd):
            assert abs(om[(a, b)] - d) < 1e-4

        # the padded all-gather: process p contributes p + 1 rows
        rows = multihost.allgather_rows(np.full((pid + 1, 3), pid), 3)
        assert rows[:, 0].tolist() == [p for p in range(nproc)
                                       for _ in range(p + 1)]

        # the data-parallel train step: each process steps on its slice
        # of the batch, all-reduced, as one device on the whole batch
        rng = np.random.default_rng(3)
        c0 = rng.normal(0, 1, (20, 8)).astype(np.float32)
        per = 32 * ndev
        xa, xb, d2 = train.sample_pair_batch(rng, per * nproc, 4)
        mine = slice(pid * per, (pid + 1) * per)
        got, want = (torch.tensor(c0, requires_grad=True) for _ in "ab")
        train.make_train_step(torch.optim.Adam([got], lr=3e-2), mesh)(
            *(torch.as_tensor(x[mine]) for x in (xa, xb, d2)))
        train.make_train_step(torch.optim.Adam([want], lr=3e-2))(
            *(torch.as_tensor(x) for x in (xa, xb, d2)))
        assert float((got - want).abs().max()) <= 1e-5
        print(f"MP_CHECK_OK p{pid}/{nproc} lsh={len(ci)} ivf={len(ic)}",
              flush=True)
    finally:
        dist.destroy_process_group()


def run_local_cluster(nproc: int = 2, ndev_per_proc: int = 2,
                      timeout: float = 120.0,
                      module: str = "hsearch_tpu_torch.parallel._mp_check",
                      extra_env: dict | None = None) -> None:
    """Spawn an nproc-process gloo CPU cluster running ``module``'s
    child_main (via ``python -m module pid nproc port``); raises on any
    nonzero exit or when ``timeout`` seconds pass.  ``extra_env`` sets
    child environment variables (workload knobs such as MP_CHECK_N)."""
    import socket
    import subprocess

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    repo_root = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ)
    env["MP_CHECK_NDEV"] = str(ndev_per_proc)
    # an even split of the cores, so the children's thread pools do not
    # fight
    env["OMP_NUM_THREADS"] = str(max(1, (os.cpu_count() or 1) // nproc))
    if extra_env:
        env.update({k: str(v) for k, v in extra_env.items()})
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, "-m", module, str(p), str(nproc), str(port)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for p in range(nproc)]
    outs = []
    deadline = time.monotonic() + timeout
    try:
        for pr in procs:
            out, _ = pr.communicate(
                timeout=max(0.0, deadline - time.monotonic()))
            outs.append(out)
    except subprocess.TimeoutExpired:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
            pr.communicate()
        raise RuntimeError("multi-process check timed out\n"
                           + "\n".join(outs))
    bad = [i for i, pr in enumerate(procs) if pr.returncode != 0]
    if bad:
        raise RuntimeError(
            "multi-process check failed on process(es) "
            f"{bad}:\n" + "\n---\n".join(outs))
    for i, out in enumerate(outs):
        if f"MP_CHECK_OK p{i}" not in out:
            raise RuntimeError(f"process {i} did not report: {out}")


if __name__ == "__main__":
    child_main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]))
