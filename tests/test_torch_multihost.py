"""hsearch_tpu_torch.parallel.multihost on torch.distributed: the ingest
and mesh helpers in one process, and real gloo clusters of 2 and 3
processes (parallel/_mp_check.py) whose shard-merged results equal a
single process's.  Mirrors tests/test_multihost.py."""

import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

from hsearch_tpu_torch.parallel import (_mp_check, mesh as mesh_lib,
                                        multihost, sharded)
from hsearch_tpu_torch.search import exact, motif

# each cluster must finish well inside this (a hang fails, it never runs
# the suite into its limit); the workload takes seconds
CLUSTER_TIMEOUT_S = 120


def _host_mesh(db_per_host=4):
    return multihost.host_mesh(db_per_host, local_devices=["cpu"] * 8)


def test_host_mesh_single_process():
    mesh = multihost.host_mesh(local_devices=["cpu"] * 8)
    # 8 logical devices, 1 process -> data axis = 8, db axis = 1
    assert mesh.shape == {"data": 8, "db": 1}
    mesh2 = _host_mesh(4)
    assert mesh2.shape == {"data": 2, "db": 4}
    assert mesh2.db_first == 0 and not mesh2.spans_processes
    with pytest.raises(ValueError, match="does not divide"):
        multihost.host_mesh(3, local_devices=["cpu"] * 8)


def test_shard_ranges_partition_rows():
    # process p of 3 owns db columns [2p, 2p + 2) of 6
    grid = ((torch.device("cpu"),) * 2,)
    n = 1531
    spans = []
    for p in range(3):
        mesh = mesh_lib.Mesh(grid, db_first=2 * p, db_size=6)
        lo, hi, n_local = multihost.shard_range(n, mesh, process_id=p)
        assert n_local == 256
        spans.append((lo, hi))
    assert spans == [(0, 512), (512, 1024), (1024, 1531)]


def test_collect_local_rows_covers_all(rng):
    mesh = _host_mesh()
    n = 103
    rows = rng.integers(0, 20, (n, 6)).astype(np.int32)
    chunks = [rows[s:s + 17] for s in range(0, n, 17)]
    local = multihost.collect_local_rows(iter(chunks), n, mesh)
    lo, hi, _ = multihost.shard_range(n, mesh)
    np.testing.assert_array_equal(local, rows[lo:hi])
    assert lo == 0 and hi == n         # one process owns every row


def test_build_and_search_from_local_rows(rng):
    """Single-process multihost wrappers == the single-device engines."""
    mesh = _host_mesh()
    n = 1024
    db = rng.integers(0, 20, (n, 8)).astype(np.int32)
    centers = db[::111][:8]
    cfg = motif.MotifSearchConfig(hash_k=4, hash_l=3, w=50.0, radius=22.0)
    idx = multihost.build_lsh_index(db, n, torch.Generator().manual_seed(0),
                                    mesh, cfg)
    ci, ki, _ = multihost.search(idx, centers, 22.0)
    ref = motif.build_index(db, torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    rc, rk, _ = motif.search(ref, centers, cfg)
    assert set(zip(ci.tolist(), ki.tolist())) == \
        set(zip(rc.tolist(), rk.tolist()))
    iv = multihost.build_ivf_index(db, n, torch.Generator().manual_seed(1),
                                   mesh, block_size=16)
    ic, ik, _ = multihost.search_ivf(iv, centers, 22.0, k_blocks=64)
    gc, gk, _ = exact.search_radius(db, centers, 22.0, device="cpu")
    assert set(zip(ic.tolist(), ik.tolist())) == \
        set(zip(gc.tolist(), gk.tolist()))


def test_streamed_ingest_equals_staged(rng):
    """put_rows_streamed (one shard staged at a time) places the same
    shard tensors as put_local_rows, and builds the same indexes."""
    mesh = _host_mesh()
    n, l = 1000, 8
    db = rng.integers(0, 20, (n, l)).astype(np.int32)
    centers = db[::131][:6]
    chunks = (db[s:s + 97] for s in range(0, n, 97))
    km_s = multihost.put_rows_streamed(chunks, n, mesh, l)
    km_d = multihost.put_local_rows(db, n, mesh)
    assert len(km_s) == len(km_d) == 4
    for a, b in zip(km_s, km_d):
        assert a.dtype == torch.int8 and torch.equal(a, b)
    cfg = motif.MotifSearchConfig(hash_k=4, hash_l=3, w=50.0, radius=22.0)
    chunks = (db[s:s + 97] for s in range(0, n, 97))
    idx = multihost.build_lsh_index_streamed(
        chunks, n, torch.Generator().manual_seed(0), mesh, l, cfg)
    ref = motif.build_index(db, torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    assert set(zip(*multihost.search(idx, centers, 22.0)[:2])) == \
        set(zip(*motif.search(ref, centers, cfg)[:2]))
    chunks = (db[s:s + 97] for s in range(0, n, 97))
    iv = multihost.build_ivf_index_streamed(
        chunks, n, torch.Generator().manual_seed(1), mesh, l, block_size=16)
    staged = multihost.build_ivf_index(db, n, torch.Generator().manual_seed(1),
                                       mesh, block_size=16)
    for a, b in zip(iv.shards[0], staged.shards[0]):
        assert torch.equal(a.db_sorted, b.db_sorted)
    gc, gk, _ = exact.search_radius(db, centers, 22.0, device="cpu")
    assert set(zip(*multihost.search_ivf(iv, centers, 22.0,
                                         k_blocks=64)[:2])) == \
        set(zip(gc.tolist(), gk.tolist()))


def test_world_of_one_equals_sharded(rng):
    """initialize() on a loopback port (gloo, one process): the
    multi-process search equals the single-process sharded one."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    multihost.initialize(f"127.0.0.1:{port}", 1, 0, device="cpu",
                         timeout_s=60)
    try:
        assert multihost.process_count() == 1
        mesh = _host_mesh()
        db = rng.integers(0, 20, (500, 8)).astype(np.int32)
        centers = db[:5]
        iv = multihost.build_ivf_index(db, 500,
                                       torch.Generator().manual_seed(2),
                                       mesh, block_size=16)
        got = multihost.search_ivf(iv, centers, 22.0, k_blocks=64)
        one = sharded.build_ivf_index(db, torch.Generator().manual_seed(2),
                                      mesh, block_size=16)
        want = sharded.search_ivf(one, centers, 22.0, k_blocks=64)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(
            multihost.allgather_rows(np.ones((2, 3)), 3), np.ones((2, 3)))
    finally:
        dist.destroy_process_group()


def test_sharded_entry_points_refuse_a_multiprocess_mesh(rng):
    mesh = mesh_lib.Mesh(((torch.device("cpu"),) * 2,), db_first=2,
                         db_size=4)
    with pytest.raises(ValueError, match="spans processes"):
        sharded.build_ivf_index(rng.integers(0, 20, (64, 6)),
                                torch.Generator(), mesh)


def test_two_process_cluster_matches_single_host():
    """A real 2-process gloo cluster: every process asserts that its
    shard-merged results equal a single process's (LSH and IVF)."""
    _mp_check.run_local_cluster(nproc=2, ndev_per_proc=2,
                                timeout=CLUSTER_TIMEOUT_S)


def test_two_process_cluster_uneven_shards():
    """The same cluster with an N that does not divide the db shards:
    ragged padding rows ride ingest, build, search and merge."""
    _mp_check.run_local_cluster(nproc=2, ndev_per_proc=2,
                                timeout=CLUSTER_TIMEOUT_S,
                                extra_env={"MP_CHECK_N": 1531})


def test_three_process_cluster_uneven_shards():
    """Three processes: shard_range's uneven tails at an odd count."""
    _mp_check.run_local_cluster(nproc=3, ndev_per_proc=2,
                                timeout=CLUSTER_TIMEOUT_S,
                                extra_env={"MP_CHECK_N": 1531})
