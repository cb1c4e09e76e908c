"""hsearch_tpu_torch/cluster/pcluster.py against hsearch_tpu's on the CPU:
histograms bitwise, KLSH codes equal except at stated near-ties, and
cluster_proteins' labels and hits identical given the JAX package's KLSH
draws; plus utils/profiling.py."""

import dataclasses
import io
import json
import os

import jax
import numpy as np
import pytest
import torch

from hsearch_tpu.cluster import pcluster as jpc
from hsearch_tpu.core import alphabet as jalpha
from hsearch_tpu.core import io as jio
from hsearch_tpu_torch.cluster import pcluster
from hsearch_tpu_torch.core import alphabet
from hsearch_tpu_torch.core import io as tio
from hsearch_tpu_torch.utils import profiling

# a code bit within this of its threshold may flip between two float32
# GEMMs that sum the 512 products in different orders
NEAR_TIE = 1e-5


def _families(n_fam=12, per_fam=4, plen=120, n_noise=6, seed=3):
    """Families of near-identical proteins (4 substitutions each, every
    third member with a 3-residue deletion) plus random proteins."""
    rng = np.random.default_rng(seed)
    seqs, fam = [], []
    for f in range(n_fam):
        base = rng.integers(0, 20, plen).astype(np.int32)
        for m in range(per_fam):
            s = base.copy()
            s[rng.choice(plen, 4, replace=False)] = rng.integers(0, 20, 4)
            if m % 3 == 2:
                s = np.concatenate([s[:50], s[53:]])
            seqs.append(s)
            fam.append(f)
    for i in range(n_noise):
        seqs.append(rng.integers(0, 20, int(rng.integers(60, 140)))
                    .astype(np.int32))
        fam.append(n_fam + i)
    starts = np.concatenate([[0], np.cumsum([len(s) for s in seqs])])
    names = [f"p{i}" for i in range(len(seqs))]
    seq = np.concatenate(seqs)
    return (tio.ProteinDB(names=names, seq=seq, starts=starts),
            jio.ProteinDB(names=names, seq=seq, starts=starts),
            np.array(fam))


def _jax_params(seed, tables, bits, sigma):
    keys = jax.random.split(jax.random.PRNGKey(seed), tables)
    return [jpc.klsh_init(keys[t], jpc.FEATURE_SIZE, bits, sigma)
            for t in range(tables)]


def _ported(params):
    return [pcluster.klsh_params_from_arrays(np.asarray(p.w),
                                             np.asarray(p.t),
                                             np.asarray(p.b))
            for p in params]


def _margins(feats, p):
    """(P, bits) float64 cos(x.w + b) + t: a bit's distance from its
    threshold."""
    proj = feats.astype(np.float64) @ np.asarray(p.w, np.float64)
    return np.cos(proj + np.asarray(p.b, np.float64)) \
        + np.asarray(p.t, np.float64)


def test_hist8_and_reduced_kmer_ids_equal_jax(rng):
    np.testing.assert_array_equal(alphabet.HIST8, jalpha.HIST8)
    assert (alphabet.HIST8_SIZE, alphabet.HASHLEN) == \
        (jalpha.HIST8_SIZE, jalpha.HASHLEN)
    x = rng.integers(0, 20, 70)
    np.testing.assert_array_equal(alphabet.reduced_kmer_ids(x),
                                  jalpha.reduced_kmer_ids(x))


def test_protein_histograms_equal_jax():
    tdb, jdb, _ = _families()
    for lo, hi in ((0, None), (5, 17), (3, 4)):
        got = pcluster.protein_histograms(tdb, lo, hi)
        want = jpc.protein_histograms(jdb, lo, hi)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    short = tio.ProteinDB(names=["a"], seq=np.zeros(2, np.uint8),
                          starts=np.array([0, 2]))
    assert not pcluster.protein_histograms(short).any()


@pytest.mark.parametrize("bits,sigma", [(16, 0.2), (12, 0.1)])
def test_klsh_codes_equal_jax_except_near_ties(bits, sigma):
    tdb, jdb, _ = _families()
    feats = jpc.protein_histograms(jdb)
    (jp,) = _jax_params(5, 1, bits, sigma)
    (tp,) = _ported([jp])
    got = pcluster.klsh_codes(torch.as_tensor(feats.astype(np.float32)),
                              tp).numpy()
    want = np.asarray(jpc.klsh_codes(jax.numpy.asarray(feats), jp))
    tie = np.abs(_margins(feats, jp)) < NEAR_TIE
    differ = (got ^ want)[:, None] >> np.arange(bits) & 1
    assert not (differ.astype(bool) & ~tie).any()
    assert got.dtype == np.int32 and len(set(got.tolist())) > 5
    # klsh_codes_all: chunked, several tables
    jps = _jax_params(6, 2, bits, sigma)
    got_all = pcluster.klsh_codes_all(tdb, _ported(jps), chunk=7,
                                      device="cpu")
    want_all = jpc.klsh_codes_all(jdb, jps, chunk=7)
    for t, p in enumerate(jps):
        tie = np.abs(_margins(feats, p)) < NEAR_TIE
        differ = (got_all[t] ^ want_all[t])[:, None] >> np.arange(bits) & 1
        assert not (differ.astype(bool) & ~tie).any()


def test_klsh_init_and_params():
    a = pcluster.klsh_init(torch.Generator().manual_seed(3), bits=12,
                           sigma=0.1)
    b = pcluster.klsh_init(torch.Generator().manual_seed(3), bits=12,
                           sigma=0.1)
    assert a.w.shape == (pcluster.FEATURE_SIZE, 12) and a.t.shape == (12,)
    assert torch.equal(a.w, b.w) and torch.equal(a.b, b.b)
    assert float(a.t.min()) >= -1 and float(a.t.max()) <= 1
    assert float(a.b.min()) >= 0 and float(a.b.max()) < 2 * np.pi
    assert abs(float(a.w.std()) - 0.01) < 0.001          # sigma^2
    tdb, _, _ = _families(n_fam=2, n_noise=0)
    with pytest.raises(ValueError, match="klsh_params holds 1 tables"):
        pcluster.cluster_proteins(tdb, None, tables=2, klsh_params=[a],
                                  device="cpu")
    with pytest.raises(ValueError, match="hit_sink requires gapped=False"):
        pcluster.cluster_proteins(tdb, None, gapped=True,
                                  hit_sink=lambda h: None, device="cpu")


def test_table_groups_equal_jax(rng):
    codes = rng.integers(0, 9, 60).astype(np.int32)
    seen_t, seen_j = set(), set()
    for _ in range(2):
        got = pcluster.table_groups(codes, seen_t)
        want = jpc.table_groups(codes, seen_j)
        assert [g.tolist() for g in got] == [g.tolist() for g in want]
        codes = np.where(codes == 3, 4, codes)


def _rows(hits):
    return [dataclasses.astuple(h) for h in hits]


@pytest.mark.parametrize("tables,gapped", [(1, False), (1, True),
                                           (3, False), (3, True)])
def test_cluster_proteins_equal_jax(tables, gapped):
    tdb, jdb, fam = _families()
    bits, sigma, seed = 12, 0.1, 1
    jps = _jax_params(seed, tables, bits, sigma)
    # this corpus has no bit within NEAR_TIE of its threshold, so both
    # packages form the same pre-groups
    feats = jpc.protein_histograms(jdb)
    assert min(float(np.abs(_margins(feats, p)).min()) for p in jps) \
        > NEAR_TIE
    got = pcluster.cluster_proteins(tdb, None, bits=bits, sigma=sigma,
                                    tables=tables, gapped=gapped,
                                    klsh_params=_ported(jps), device="cpu")
    want = jpc.cluster_proteins(jdb, jax.random.PRNGKey(seed), bits=bits,
                                sigma=sigma, tables=tables, gapped=gapped)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert [g.tolist() for g in got.pre_groups] == \
        [g.tolist() for g in want.pre_groups]
    assert _rows(got.hits) == _rows(want.hits)
    assert [g.tolist() for g in got.groups()] == \
        [g.tolist() for g in want.groups()]
    assert len(got.hits) > 50
    if gapped:
        assert any(h.gap_open > 0 for h in got.hits)
    if tables == 3:
        # OR-amplified tables recover every planted family
        for f in range(12):
            assert len(set(got.labels[fam == f].tolist())) == 1


def test_cluster_proteins_hit_sink_equal_jax():
    tdb, jdb, _ = _families(n_fam=8)
    jps = _jax_params(2, 2, 12, 0.1)
    streamed, jstreamed = [], []
    got = pcluster.cluster_proteins(tdb, None, bits=12, sigma=0.1, tables=2,
                                    klsh_params=_ported(jps),
                                    hit_sink=streamed.extend, render=False,
                                    device="cpu")
    want = jpc.cluster_proteins(jdb, jax.random.PRNGKey(2), bits=12,
                                sigma=0.1, tables=2,
                                hit_sink=jstreamed.extend, render=False)
    assert got.hits == [] and _rows(streamed) == _rows(jstreamed)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert streamed and not any(h.q_aln for h in streamed)


def test_profiling_phases_and_trace(tmp_path, capsys):
    profiling.reset()
    with profiling.phase("a", sync=True):
        torch.ones(4).sum()
    profiling.add("a", 0.5)
    profiling.add("b", 0.25)
    rep = profiling.report()
    assert rep["a"]["count"] == 2 and rep["a"]["total_s"] >= 0.5
    assert rep["b"] == {"count": 1, "total_s": 0.25, "mean_s": 0.25}
    buf = io.StringIO()
    profiling.print_report(buf)
    assert buf.getvalue().splitlines()[1] == \
        "[TIME] b: total 0.250s over 1 calls (mean 250.0ms)"
    profiling.reset()
    assert profiling.report() == {}
    with profiling.device_trace(str(tmp_path / "tr")) as path:
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    with open(path) as f:
        assert json.load(f)["traceEvents"]
    os.environ["HSEARCH_PROGRESS"] = "1"
    try:
        profiling.heartbeat("step 3")
    finally:
        del os.environ["HSEARCH_PROGRESS"]
    profiling.heartbeat("silent")
    err = capsys.readouterr().err
    assert "step 3" in err and "silent" not in err
