"""The port's p-stable LSH and LSH motif search against hsearch_tpu on the
same numpy inputs and the same parameters.

Tolerances: bucket indices and probe codes are equal except where a
scaled projection lies within 1e-5 of an integer (the fold table's
8-term sums may round differently), and there they differ by exactly 1;
search hit sets are equal and d^2 agrees within 1e-5 relative (the JAX
package sums the P-table by a one-hot product, the port in position
order); radii are picked so that no candidate's d^2 lies within 1e-3 of
R^2.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hsearch_tpu.core import embedding
from hsearch_tpu.core import io as jio
from hsearch_tpu.lsh import pstable as jp
from hsearch_tpu.search import motif as jm
from hsearch_tpu.utils import checkpoint as jck
from hsearch_tpu_torch.core import io as tio
from hsearch_tpu_torch.lsh import pstable as tp
from hsearch_tpu_torch.lsh import tuning as ttune
from hsearch_tpu_torch.ops import compact as tcompact
from hsearch_tpu_torch.search import motif as tm
from hsearch_tpu_torch.utils import checkpoint as tck

L = 10
BOUNDARY_TOL = 1e-5


def _db(rng, n=3000, l=L):
    """Families of near-duplicate k-mers plus random rows."""
    fam = rng.integers(0, 20, (n // 50, l))
    db = fam[rng.integers(0, len(fam), n)]
    flip = rng.random((n, l)) < 0.15
    db = np.where(flip, rng.integers(0, 20, (n, l)), db)
    return db.astype(np.int32)


def _params(k, t, w, seed=1, l=L):
    p = jp.init(jax.random.PRNGKey(seed), l * embedding.AA_DIM, k, t, w)
    return p, tp.params_from_arrays(np.asarray(p.a), np.asarray(p.b), p.w)


def _scaled(x, p, is_kmers):
    """(N, T, K) (a.x + b) / W in float64 from the JAX parameters."""
    a = np.asarray(p.a, np.float64)
    pts = embedding.embed_kmers(x, dtype=np.float64) if is_kmers else \
        np.asarray(x, np.float64)
    return (np.einsum("nd,tdk->ntk", pts, a)
            + np.asarray(p.b, np.float64)) / p.w


def _assert_indices_match(got, want, scaled):
    """got/want (T, N, K): equal, or differ by exactly 1 where the scaled
    projection lies within BOUNDARY_TOL of an integer."""
    diff = got != want
    near = np.abs(scaled - np.round(scaled)) < BOUNDARY_TOL
    assert not (diff & ~near.transpose(1, 0, 2)).any()
    assert (np.abs(got.astype(np.int64) - want)[diff] == 1).all()


@pytest.mark.parametrize("k,t", [(4, 4), (8, 3)])
def test_bucket_indices_match(rng, k, t):
    db = _db(rng)
    jpar, tpar = _params(k, t, 30.0)
    want = np.asarray(jp.bucket_indices_kmers(jnp.asarray(db), jpar))
    got = tp.bucket_indices_kmers(torch.as_tensor(db), tpar).numpy()
    assert got.shape == (t, len(db), k) and got.dtype == np.int32
    _assert_indices_match(got, want, _scaled(db, jpar, True))
    pts = embedding.embed_kmers(db[:200]) + rng.normal(
        0, 0.3, (200, L * 8)).astype(np.float32)
    want = np.asarray(jp.bucket_indices(jnp.asarray(pts), jpar))
    got = tp.bucket_indices(torch.as_tensor(pts), tpar).numpy()
    _assert_indices_match(got, want, _scaled(pts, jpar, False))
    np.testing.assert_array_equal(
        tp.hash_codes(torch.as_tensor(db), tpar, True).numpy(),
        np.asarray(jp.hash_codes(jnp.asarray(db), jpar, True)))


@pytest.mark.parametrize("k", [4, 8])
@pytest.mark.parametrize("probes", [1, 2, 8])
def test_multiprobe_codes_match(rng, k, probes):
    q = _db(rng, 120)
    jpar, tpar = _params(k, 3, 30.0)
    want = np.asarray(jp.multiprobe_codes(jnp.asarray(q), jpar, True, probes))
    got = tp.multiprobe_codes(torch.as_tensor(q), tpar, True, probes).numpy()
    assert got.shape == want.shape == (3, 120, min(probes, 1 << k))
    # a (table, center) row may differ only if one of its projections
    # lies within BOUNDARY_TOL of an integer or of a half (the flip order)
    s = _scaled(q, jpar, True).transpose(1, 0, 2)            # (T, C, K)
    frac = s - np.floor(s)
    near = ((np.abs(s - np.round(s)) < BOUNDARY_TOL)
            | (np.abs(frac - 0.5) < BOUNDARY_TOL)).any(-1)
    rows_diff = (got != want).any(-1)
    assert not (rows_diff & ~near).any()
    assert rows_diff.sum() <= 2


def test_multiprobe_warns_past_2k(rng):
    _, tpar = _params(2, 1, 30.0)
    with pytest.warns(UserWarning, match="at most 2"):
        out = tp.multiprobe_codes(torch.as_tensor(_db(rng, 100)[:5]), tpar,
                                  True, 8)
    assert out.shape == (1, 5, 4)


def test_init_draws_from_generator():
    a = tp.init(torch.Generator().manual_seed(3), 80, 4, 2, 50.0)
    b = tp.init(torch.Generator().manual_seed(3), 80, 4, 2, 50.0)
    assert torch.equal(a.a, b.a) and torch.equal(a.b, b.b)
    assert a.a.shape == (2, 80, 4) and 0 <= float(a.b.min()) \
        and float(a.b.max()) < 50.0


# ---- motif search ------------------------------------------------------

def _radius_clear(db, centers, r, is_kmers=True):
    """A radius near ``r`` with no center/k-mer d^2 within 1e-3 of R^2."""
    if is_kmers:
        d2 = embedding.DISTANCE_SQUARE[centers[:, None, :], db[None]].sum(-1)
    else:
        e = embedding.embed_kmers(db).astype(np.float64)
        d2 = ((centers[:, None, :].astype(np.float64) - e[None]) ** 2).sum(-1)
    v = np.unique(d2.ravel())
    i = int(np.searchsorted(v, r * r))
    while v[i] - v[i - 1] < 3e-3:
        i += 1
    return float(np.sqrt((v[i] + v[i - 1]) / 2))


def _jax_index(tmp_path, db, cfg, cand_max=None, seed=2):
    jidx = jm.build_index(db, jax.random.PRNGKey(seed), cfg,
                          cand_max=cand_max)
    path = str(tmp_path / "motif.npz")
    jck.save_index(path, jidx)
    return jidx, tck.load_index(path, device="cpu")


def _query_codes(jidx, tidx, centers, is_kmers, probes):
    c = jnp.asarray(centers)
    if probes > 1:
        want = np.asarray(jp.multiprobe_codes(c, jidx.params, is_kmers,
                                              probes)).transpose(1, 0, 2)
    else:
        want = np.asarray(jp.hash_codes(c, jidx.params, is_kmers)).T
    got = tm._query_codes(tidx, torch.as_tensor(centers), is_kmers,
                          probes).numpy()
    np.testing.assert_array_equal(got, want)
    return np.array(want)


def _pairs(ci, ki):
    return set(zip(ci.tolist(), ki.tolist()))


def _overflow(stats):
    """The two overflow counts that both packages report; the port's
    ``stats_out`` also holds its candidate and transfer counters."""
    return {k: stats[k] for k in ("truncated", "skewed")}


def _search_both(jidx, tidx, centers, cfg):
    with warnings.catch_warnings(record=True) as wj:
        warnings.simplefilter("always")
        want = jm.search(jidx, centers, cfg)
    stats: dict = {}
    got = tm.search(tidx, centers, cfg, stats_out=stats)
    return got, want, stats, [str(w.message) for w in wj]


CASES = {
    # name: (hash_k, hash_l, w, probes, real-point centers)
    "k4_p1_int": (4, 4, 30.0, 1, False),
    "k8_p8_int": (8, 4, 30.0, 8, False),
    "k8_p8_points": (8, 4, 30.0, 8, True),
    "k4_p1_points": (4, 4, 30.0, 1, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_search_equals_jax_on_jax_index(tmp_path, rng, case):
    """A JAX index saved with hsearch_tpu.utils.checkpoint and loaded by
    the port gives the same (center, kmer) set and d^2 within 1e-5
    relative."""
    k, t, w, probes, points = CASES[case]
    db = _db(rng)
    centers = db[rng.choice(len(db), 24, replace=False)]
    if points:
        centers = embedding.embed_kmers(centers) + rng.normal(
            0, 0.5, (24, L * 8)).astype(np.float32)
    r = _radius_clear(db, centers, 18.0, not points)
    cfg = jm.MotifSearchConfig(hash_k=k, hash_l=t, w=w, radius=r,
                               probes=probes, center_block=16,
                               max_hits=4096)
    jidx, tidx = _jax_index(tmp_path, db, cfg)
    tcfg = tm.MotifSearchConfig(**vars(cfg))
    _query_codes(jidx, tidx, centers, not points, probes)
    (ci, ki, dd), (wci, wki, wdd), stats, _ = _search_both(
        jidx, tidx, centers, tcfg)
    assert len(wci) > 50 and _overflow(stats) == {"truncated": 0,
                                                  "skewed": 0}
    assert _pairs(ci, ki) == _pairs(wci, wki)
    got = dict(zip(zip(ci.tolist(), ki.tolist()), dd.astype(np.float64)))
    want = np.array([got[p] for p in zip(wci.tolist(), wki.tolist())])
    np.testing.assert_allclose(want ** 2, wdd.astype(np.float64) ** 2,
                               rtol=1e-5)


def _block_meta(idx, mod, centers, qcodes, r2, cand_max, max_hits, cb):
    packed = mod._probe_verify(idx, centers, qcodes, r2, cand_max, max_hits)
    return tcompact.unpack_hits(np.asarray(packed[0]), (cb, cb))


def test_truncation_and_overflow_match_jax(tmp_path, rng):
    """cand_max below the largest bucket (n_dropped equal per center) and
    max_hits below some centers' hit counts (the packed-overflow path;
    sets compared where n_hits <= max_hits)."""
    db = _db(rng)
    db[:400] = db[0]                      # one mega-bucket in every table
    centers = np.concatenate([db[:4], db[rng.choice(len(db), 12)]])
    r = _radius_clear(db, centers, 16.0)
    cfg = jm.MotifSearchConfig(hash_k=4, hash_l=3, w=30.0, radius=r,
                               center_block=16, max_hits=24)
    jidx, tidx = _jax_index(tmp_path, db, cfg, cand_max=64)
    assert tidx.cand_max == 64
    tcfg = tm.MotifSearchConfig(**vars(cfg))
    q = _query_codes(jidx, tidx, centers, True, 1)
    r2 = float(np.float32(r * r))
    _, (jn, jd) = _block_meta(jidx, jm, jnp.asarray(centers),
                                 jnp.asarray(q), jnp.float32(r * r), 64, 24,
                                 16)
    _, (tn, td) = _block_meta(tidx, tm, torch.as_tensor(centers),
                                 torch.as_tensor(q), r2, 64, 24, 16)
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(tn, jn)
    assert (jd > 0).sum() >= 4 and (jn > 24).sum() >= 1
    (ci, ki, _), (wci, wki, _), stats, msgs = _search_both(
        jidx, tidx, centers, tcfg)
    assert _overflow(stats) == {"truncated": int((jn > 24).sum()),
                                "skewed": int((jd > 0).sum())}
    assert any("max_hits" in m for m in msgs) and \
        any("cand_max" in m for m in msgs)
    ok = np.nonzero(jn <= 24)[0]
    assert _pairs(ci[np.isin(ci, ok)], ki[np.isin(ci, ok)]) == \
        _pairs(wci[np.isin(wci, ok)], wki[np.isin(wci, ok)])
    # the overflowed centers keep max_hits of their true hits
    full = np.nonzero(jn > 24)[0]
    assert all((ci == c).sum() == 24 for c in full)
    # the port's warnings name the same two counts
    with pytest.warns(UserWarning, match="max_hits"):
        tm.search(tidx, centers, tcfg)


def test_build_index_reproduces_jax(rng):
    db = _db(rng)
    for k, t, limit in ((4, 3, 8192), (8, 4, 8192), (4, 2, 5)):
        cfg = jm.MotifSearchConfig(hash_k=k, hash_l=t, w=30.0,
                                   cand_limit=limit)
        jidx = jm.build_index(db, jax.random.PRNGKey(k), cfg)
        tidx = tm.build_index(
            db, None, tm.MotifSearchConfig(**vars(cfg)),
            params=tp.params_from_arrays(np.asarray(jidx.params.a),
                                         np.asarray(jidx.params.b), 30.0),
            device="cpu")
        np.testing.assert_array_equal(tidx.tables.sorted_codes.numpy(),
                                      np.asarray(jidx.tables.sorted_codes))
        np.testing.assert_array_equal(tidx.tables.perm.numpy(),
                                      np.asarray(jidx.tables.perm))
        assert tidx.cand_max == jidx.cand_max
        np.testing.assert_array_equal(tidx.db_kmers.numpy(),
                                      np.asarray(jidx.db_kmers))


def test_port_checkpoint_loads_in_jax(tmp_path, rng):
    db = _db(rng, 500)
    tidx = tm.build_index(db, torch.Generator().manual_seed(0),
                          tm.MotifSearchConfig(hash_k=8, hash_l=2, w=30.0),
                          device="cpu")
    path = str(tmp_path / "port.npz")
    tck.save_index(path, tidx)
    jidx = jck.load_index(path)
    np.testing.assert_array_equal(np.asarray(jidx.tables.perm),
                                  tidx.tables.perm.numpy())
    np.testing.assert_array_equal(np.asarray(jidx.params.a),
                                  tidx.params.a.numpy())
    assert jidx.cand_max == tidx.cand_max and jidx.db_kmers.shape == (501, L)
    again = tck.load_index(path, device="cpu")
    assert torch.equal(again.tables.sorted_codes, tidx.tables.sorted_codes)


def test_search_protein_db_same_best_centers(rng):
    fam = rng.integers(0, 20, (6, L))
    seqs = []
    for i in range(40):
        s = np.concatenate([rng.integers(0, 20, 7), fam[i % 6],
                            rng.integers(0, 20, 9)])
        s[rng.integers(0, len(s))] = rng.integers(0, 20)
        seqs.append(s)
    aa = "ARNDCQEGHILKMFPSTWYV"
    text = "".join(f">p{i}\n{''.join(aa[x] for x in s)}\n"
                   for i, s in enumerate(seqs))
    jdb, tdb = jio.read_fasta(jio.from_strings(text)), \
        tio.read_fasta(jio.from_strings(text))
    # W far above every projection: each table is one bucket whatever the
    # draw, so both searches are exhaustive and their results do not
    # depend on the (different) parameters each package draws
    cfg = jm.MotifSearchConfig(hash_k=4, hash_l=4, w=1e6, radius=14.0,
                               center_block=8)
    jbest = jm.search_protein_db(jdb, fam.astype(np.int32),
                                 jax.random.PRNGKey(0), cfg)
    tbest = tm.search_protein_db(tdb, fam.astype(np.int32),
                                 torch.Generator().manual_seed(0),
                                 tm.MotifSearchConfig(**vars(cfg)),
                                 device="cpu")
    np.testing.assert_array_equal(tbest[2], jbest[2])
    hit = jbest[0] >= 0
    assert hit.sum() >= 30
    np.testing.assert_array_equal(tbest[0], jbest[0])
    np.testing.assert_allclose(tbest[1][hit], jbest[1][hit], rtol=1e-5)


def test_tuning_sweep_and_best(rng):
    db = _db(rng, 1500)
    centers = db[:12]
    grid = [tm.MotifSearchConfig(hash_k=4, hash_l=2, w=30.0),
            tm.MotifSearchConfig(hash_k=4, hash_l=8, w=60.0, probes=4)]
    pts = ttune.sweep(db, centers, 16.0, configs=grid,
                      generator=torch.Generator().manual_seed(0),
                      device="cpu")
    assert [p.config.radius for p in pts] == [16.0, 16.0]
    assert pts[1].recall >= pts[0].recall and pts[1].recall > 0.9
    assert all(p.hits <= p.truth for p in pts)
    assert ttune.best(pts, 0.0) is min(pts, key=lambda p: p.cand_slots)
    assert ttune.best(pts, 1.01) is max(pts, key=lambda p: p.recall)
    assert len(ttune.default_grid(35.0)) == 6

