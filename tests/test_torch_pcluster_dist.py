"""hsearch_tpu_torch/cluster/pcluster_dist.py against single-process
cluster_proteins and the JAX package's distributed function on the CPU: the
query partitioner, the one-process case, hit_sink streaming, and spawned
gloo clusters of 2 and 3 processes in both partition modes
(cluster/_mp_pcluster_check.py); every case of tests/test_pcluster_dist.py.

The KLSH draws of the JAX package cross over as arrays
(``klsh_params_from_arrays``) on a corpus with no code bit within 1e-5 of
its threshold, where two float32 GEMMs could disagree.  The synthetic
corpus's 100-residue proteins have similar 3-mer histograms, so at the
JAX checks' sigma 0.2 every table forms a few large groups (query mode);
group mode is reached at sigma 0.3, whose codes spread the families."""

import jax
import numpy as np
import pytest
import torch

from hsearch_tpu.cluster import _mp_pcluster_check as jchk
from hsearch_tpu.cluster import pcluster as jpc, pcluster_dist as jpd
from hsearch_tpu_torch.align import pipeline
from hsearch_tpu_torch.cluster import _mp_pcluster_check as chk
from hsearch_tpu_torch.cluster import pcluster, pcluster_dist
from hsearch_tpu_torch.parallel import _mp_check

MODULE = "hsearch_tpu_torch.cluster._mp_pcluster_check"
NEAR_TIE = 1e-5


def _jax_params(seed, tables, bits=16, sigma=0.2):
    keys = jax.random.split(jax.random.PRNGKey(seed), tables)
    return [jpc.klsh_init(keys[t], jpc.FEATURE_SIZE, bits, sigma)
            for t in range(tables)]


def _assert_no_near_tie(db, params):
    """No cos(x.w + b) + t within NEAR_TIE of 0 for any protein and bit."""
    feats = jpc.protein_histograms(db).astype(np.float64)
    for p in params:
        m = np.cos(feats @ np.asarray(p.w, np.float64)
                   + np.asarray(p.b, np.float64)) + np.asarray(p.t)
        assert np.abs(m).min() > NEAR_TIE


def _ported(params):
    return [pcluster.klsh_params_from_arrays(np.asarray(p.w),
                                             np.asarray(p.t),
                                             np.asarray(p.b))
            for p in params]


def _modes(outs):
    return [o.split("modes=")[1].split()[0].split(",") for o in outs]


def test_partition_queries_deterministic_and_balanced(rng):
    w = rng.random(1000)
    a1 = pcluster_dist.partition_queries(w, 3)
    np.testing.assert_array_equal(a1, pcluster_dist.partition_queries(w, 3))
    np.testing.assert_array_equal(a1, jpd.partition_queries(w, 3))
    counts = np.bincount(a1, minlength=3)
    assert counts.max() - counts.min() <= 1
    # per-process total weight balanced to within one max-weight row
    loads = np.array([w[a1 == p].sum() for p in range(3)])
    assert loads.max() - loads.min() <= w.max() + 1e-9
    assert (pcluster_dist.partition_queries(w, 1) == 0).all()


def test_partition_queries_balances_giant_group_regime():
    """One giant group: its query rows spread over the processes."""
    assign = pcluster_dist.partition_queries(np.full(1000, 5000.0), 2)
    counts = np.bincount(assign, minlength=2)
    assert counts.max() - counts.min() <= 1


def test_search_all_query_rows_partitions_exactly():
    """Hits of query slices union to the full run, each query's identical
    (the property the query partition rests on)."""
    db = chk._workload()
    kp = pcluster.klsh_init(torch.Generator().manual_seed(11))
    groups = pcluster.table_groups(
        pcluster.klsh_codes_all(db, [kp], device="cpu")[0], set())
    subset = np.concatenate(groups)
    group_of = np.repeat(np.arange(len(groups)), [len(g) for g in groups])
    s = pipeline.ProteinSearcher(db, subset=subset, groups=group_of,
                                 device="cpu")
    full = chk._hit_rows(s.search_all())
    rows = np.arange(len(subset))
    parts = np.concatenate([chk._hit_rows(s.search_all(query_rows=sl))
                            for sl in (rows[0::3], rows[1::3], rows[2::3])])
    assert len(full) > 100
    assert sorted(map(tuple, full.tolist())) == \
        sorted(map(tuple, parts.tolist()))


def test_single_process_equals_cluster_proteins_and_jax():
    db = chk._workload()
    got = pcluster_dist.cluster_proteins_distributed(
        db, torch.Generator().manual_seed(11), tables=2, device="cpu")
    ref = pcluster.cluster_proteins(db, torch.Generator().manual_seed(11),
                                    tables=2, device="cpu")
    np.testing.assert_array_equal(got.labels, ref.labels)
    assert chk._hit_rows(got.hits).tolist() == \
        chk._hit_rows(ref.hits).tolist()
    assert got.pairs_extended == ref.pairs_extended
    # the JAX package's function in one process, its draws carried
    jdb = jchk._workload()
    jps = _jax_params(11, 2)
    _assert_no_near_tie(jdb, jps)
    want = jpd.cluster_proteins_distributed(jdb, jax.random.PRNGKey(11),
                                            tables=2)
    got = pcluster_dist.cluster_proteins_distributed(
        db, None, tables=2, klsh_params=_ported(jps), device="cpu")
    np.testing.assert_array_equal(got.labels, want.labels)
    assert [g.tolist() for g in got.pre_groups] == \
        [g.tolist() for g in want.pre_groups]
    assert chk._hit_rows(got.hits).tolist() == \
        jchk._hit_rows(want.hits).tolist()


def test_hit_sink_streaming_identical_labels_and_edges():
    """hit_sink (two tables): labels equal the resident-hits run's, the
    streamed hits its hit rows, and nothing accumulates in ``hits``."""
    db = chk._workload()

    def gen():
        return torch.Generator().manual_seed(11)

    ref = pcluster.cluster_proteins(db, gen(), tables=2, device="cpu")
    streamed: list = []
    got = pcluster_dist.cluster_proteins_distributed(
        db, gen(), tables=2, hit_sink=streamed.extend, render=False,
        device="cpu")
    np.testing.assert_array_equal(got.labels, ref.labels)
    assert got.hits == []
    assert chk._hit_rows(streamed).tolist() == \
        chk._hit_rows(ref.hits).tolist()
    assert streamed and not any(h.q_aln for h in streamed)
    with pytest.raises(ValueError, match="hit_sink requires gapped=False"):
        pcluster_dist.cluster_proteins_distributed(
            db, gen(), gapped=True, hit_sink=streamed.extend, device="cpu")


def test_gapped_single_process_equals_cluster_proteins():
    db = chk._workload()
    kw = dict(tables=2, sigma=0.1, gapped=True, device="cpu")
    got = pcluster_dist.cluster_proteins_distributed(
        db, torch.Generator().manual_seed(11), **kw)
    ref = pcluster.cluster_proteins(db, torch.Generator().manual_seed(11),
                                    **kw)
    np.testing.assert_array_equal(got.labels, ref.labels)
    assert chk._hit_rows(got.hits).tolist() == \
        chk._hit_rows(ref.hits).tolist()


def test_two_process_group_mode():
    """A real 2-process gloo cluster in group mode (sigma 0.3, 20 bits):
    every process asserts labels, pre-groups and the union of hits equal
    single-process cluster_proteins."""
    outs = _mp_check.run_local_cluster(
        nproc=2, ndev_per_proc=1, module=MODULE, timeout=120,
        extra_env={"PCLUSTER_CHECK_SIGMA": 0.3, "PCLUSTER_CHECK_BITS": 20})
    assert all(m == ["group"] * 3 for m in _modes(outs))


def test_two_process_query_mode_equals_jax(tmp_path):
    """The giant-group regime (sigma 0.1) forces query mode; the JAX
    package's draws and its single-process result are carried in, and
    the distributed result must equal them."""
    jdb = jchk._workload()
    jps = _jax_params(12, 3, sigma=0.1)
    _assert_no_near_tie(jdb, jps)
    want = jpc.cluster_proteins(jdb, jax.random.PRNGKey(12), tables=3,
                                sigma=0.1)
    path = str(tmp_path / "jax.npz")
    np.savez(path, w=np.stack([np.asarray(p.w) for p in jps]),
             t=np.stack([np.asarray(p.t) for p in jps]),
             b=np.stack([np.asarray(p.b) for p in jps]), labels=want.labels,
             pre_groups=np.concatenate(want.pre_groups),
             pre_group_sizes=[len(g) for g in want.pre_groups],
             hit_rows=jchk._hit_rows(want.hits))
    outs = _mp_check.run_local_cluster(
        nproc=2, ndev_per_proc=1, module=MODULE, timeout=120,
        extra_env={"PCLUSTER_CHECK_NPZ": path})
    assert all(m == ["query"] * 3 for m in _modes(outs))
    assert all(f"/{len(want.hits)} " in o for o in outs)


@pytest.mark.parametrize("sigma,bits,modes", [
    (0.3, 17, {"group", "query"}), (0.1, 16, {"query"})])
def test_three_process_both_modes(sigma, bits, modes):
    """nproc 3 at N 144 and 2 tables: the serpentine partition, the
    group-mode rule and the padded all-gather with an odd count."""
    outs = _mp_check.run_local_cluster(
        nproc=3, ndev_per_proc=1, module=MODULE, timeout=120,
        extra_env={"PCLUSTER_CHECK_N": 144, "PCLUSTER_CHECK_TABLES": 2,
                   "PCLUSTER_CHECK_SIGMA": sigma,
                   "PCLUSTER_CHECK_BITS": bits})
    assert all(set(m) == modes for m in _modes(outs))
