"""hsearch_tpu_torch.parallel (mesh, sharded LSH/IVF search, exact_topk)
on 8 logical CPU shards, against the JAX package's sharded functions on
its 8-device CPU mesh and against the port's own single-device engines and
exact oracle.  Each case of tests/test_parallel.py is mirrored.

Torch cannot reproduce jax.random, so the parity cases carry the JAX
sharded index's own arrays across (``motif_index_from_arrays``,
``ivf_index_from_arrays``)."""

import warnings

import jax
import numpy as np
import pytest
import torch

from hsearch_tpu.parallel import mesh as jmesh, sharded as jsharded
from hsearch_tpu.search import motif as jmotif
from hsearch_tpu_torch.core import embedding
from hsearch_tpu_torch.ops import cuda_kernels
from hsearch_tpu_torch.parallel import mesh as mesh_lib, sharded
from hsearch_tpu_torch.search import exact, motif


def _mesh(data=2):
    return mesh_lib.make_mesh(8, data=data, devices=["cpu"] * 8)


def _db_with_planted(rng, n, c, l, flips=2):
    """Database containing perturbed copies of each center."""
    db = rng.integers(0, 20, (n, l), dtype=np.int32)
    centers = rng.integers(0, 20, (c, l), dtype=np.int32)
    for i in range(c):
        for j in range(3):
            row = centers[i].copy()
            pos = rng.integers(0, l, flips)
            row[pos] = rng.integers(0, 20, flips)
            db[(i * 3 + j) % n] = row
    return db, centers


def _families(rng, n, c, l):
    nfam = n // 32
    fam = rng.integers(0, 20, (nfam, l), dtype=np.int32)
    db = fam[rng.integers(0, nfam, n)].copy()
    for i in range(n):
        k = int(rng.poisson(2.0))
        if k:
            pos = rng.integers(0, l, k)
            db[i, pos] = rng.integers(0, 20, k)
    return db, fam[rng.choice(nfam, c, replace=False)]


def _pairs(res):
    return set(zip(res[0].tolist(), res[1].tolist()))


def _carry_lsh(jidx):
    p = jidx.params
    return sharded.motif_index_from_arrays(
        _mesh(jidx.mesh.shape["data"]), np.asarray(p.a), np.asarray(p.b),
        p.w, p.pack_bits, np.asarray(jidx.sorted_codes),
        np.asarray(jidx.perm), np.asarray(jidx.db_kmers), jidx.cand_max,
        jidx.n_points, jidx.max_hits, jidx.probes)


def _carry_ivf(jidx):
    return sharded.ivf_index_from_arrays(
        _mesh(jidx.mesh.shape["data"]), np.asarray(jidx.db_sorted),
        np.asarray(jidx.order), np.asarray(jidx.block_centroid),
        np.asarray(jidx.block_radius), jidx.n_points, jidx.n_local,
        jidx.max_hits)


def _same_hits(got, want):
    assert _pairs(got) == _pairs(want)
    dw = {(a, b): d for a, b, d in zip(*want)}
    d2g = np.array([d * d for d in got[2]], np.float64)
    d2w = np.array([dw[(a, b)] ** 2 for a, b in zip(got[0], got[1])])
    np.testing.assert_allclose(d2g, d2w, rtol=1e-5, atol=1e-6)


def test_mesh_shape():
    m = _mesh()
    assert m.shape[mesh_lib.DATA_AXIS] * m.shape[mesh_lib.DB_AXIS] == 8
    assert len(m.flat()) == 8 and not m.spans_processes
    # the data axis default is the JAX package's rule
    for n in (1, 2, 4, 6, 8, 16):
        jm = jmesh.make_mesh(n_devices=n, devices=[jax.devices()[0]] * n)
        tm = mesh_lib.make_mesh(n, devices=["cpu"] * n)
        assert tm.shape == dict(jm.shape)
    with pytest.raises(ValueError, match="does not divide"):
        mesh_lib.make_mesh(6, data=4, devices=["cpu"] * 6)


def test_mesh_needs_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mesh_lib.make_mesh()


def test_sharded_search_matches_single_host(rng):
    n, c, l = 512, 16, 10
    db, centers = _db_with_planted(rng, n, c, l)
    cfg = motif.MotifSearchConfig(hash_k=4, hash_l=4, w=50.0, radius=25.0)
    idx = sharded.build_index(db, torch.Generator().manual_seed(7), _mesh(),
                              cfg)
    got = sharded.search(idx, centers, radius=cfg.radius)
    gt = exact.search_radius(db, centers, cfg.radius, device="cpu")
    gtd = {(a, b): d for a, b, d in zip(*gt)}
    assert len(got[0]) > 0
    for a, b, d in zip(*got):
        np.testing.assert_allclose(d, gtd[(a, b)], atol=1e-3)
    assert len(_pairs(got)) / max(1, len(gtd)) > 0.5
    # the same parameters on one index give the same hit set
    one = motif.build_index(db, torch.Generator().manual_seed(7), cfg,
                            device="cpu")
    assert _pairs(got) == _pairs(motif.search(one, centers, cfg))


def test_sharded_lsh_equals_jax_on_carried_index(rng):
    n, c, l = 512, 16, 10
    db, centers = _db_with_planted(rng, n, c, l)
    cfg = jmotif.MotifSearchConfig(hash_k=4, hash_l=4, w=50.0, radius=25.0)
    jidx = jsharded.build_index(db, jax.random.PRNGKey(7),
                                jmesh.make_mesh(8, data=2), cfg)
    want = jsharded.search(jidx, centers, radius=cfg.radius)
    got = sharded.search(_carry_lsh(jidx), centers, radius=cfg.radius)
    assert len(want[0]) > 0
    _same_hits(got, want)


def test_sharded_search_no_padding_artifacts(rng):
    # n not divisible by the db axis, c not divisible by the data axis
    n, c, l = 509, 13, 10
    db, centers = _db_with_planted(rng, n, c, l)
    cfg = motif.MotifSearchConfig(radius=60.0)
    gt = _pairs(exact.search_radius(db, centers, 60.0, device="cpu"))
    idx = sharded.build_index(db, torch.Generator().manual_seed(3), _mesh(),
                              cfg)
    assert idx.n_real == [128, 128, 128, 125] and idx.n_local == 128
    ci, ki, _ = sharded.search(idx, centers, radius=60.0)
    assert (ki < n).all() and (ci < c).all()
    assert set(zip(ci, ki)) <= gt
    # the JAX index keeps its zero-filled padding rows in the last shard's
    # tables; carried across they are never hits
    jidx = jsharded.build_index(db, jax.random.PRNGKey(3),
                                jmesh.make_mesh(8, data=2),
                                jmotif.MotifSearchConfig(radius=60.0))
    carried = _carry_lsh(jidx)
    assert carried.n_real == [128, 128, 128, 125]
    got = sharded.search(carried, centers, radius=60.0)
    assert (got[1] < n).all()
    _same_hits(got, jsharded.search(jidx, centers, radius=60.0))


def _oracle_topk(db, centers, k):
    d2 = embedding.DISTANCE_SQUARE[centers[:, None, :], db[None, :, :]]
    return d2.astype(np.float64).sum(-1)


@pytest.mark.parametrize("n,c,k,data", [(300, 9, 7, 2), (40, 3, 20, 1)])
def test_exact_topk_matches_oracle_and_jax(rng, n, c, k, data):
    # (40, k = 20): k exceeds the rows of a db shard (5 on 8 shards)
    l = 10
    db = rng.integers(0, 20, (n, l), dtype=np.int32)
    centers = rng.integers(0, 20, (c, l), dtype=np.int32)
    idx, dist = sharded.exact_topk(db, centers, k, _mesh(data))
    jidx, jdist = jsharded.exact_topk(db, centers, k,
                                      jmesh.make_mesh(8, data=data))
    assert idx.shape == (c, k)
    d2 = _oracle_topk(db, centers, k)
    n_clear = 0
    for i in range(c):
        want = np.sort(d2[i])
        np.testing.assert_allclose(np.sort(dist[i]) ** 2, want[:k],
                                   rtol=1e-4)
        np.testing.assert_allclose(dist[i] ** 2, d2[i, idx[i]], rtol=1e-4)
        np.testing.assert_allclose(dist[i] ** 2, jdist[i] ** 2, rtol=1e-5)
        if want[k - 1] != want[k]:
            n_clear += 1
            assert set(idx[i].tolist()) == set(jidx[i].tolist())
    assert n_clear > 0


def test_sharded_ivf_matches_exact(rng):
    db, centers = _families(rng, 1024, 12, 25)
    idx = sharded.build_ivf_index(db, torch.Generator().manual_seed(0),
                                  _mesh(), block_size=16)
    # k_blocks = every block of the largest shard: pure triangle pruning
    got = sharded.search_ivf(idx, centers, 35.0,
                             k_blocks=idx.blocks_per_shard)
    gt = exact.search_radius(db, centers, 35.0, device="cpu")
    assert len(gt[0]) > 0
    _same_hits(got, gt)


def test_ivf_shards_depend_on_seed_and_shard_only(rng):
    """Shard s of a 4-shard build is the same index whatever the mesh's
    data axis: its generator depends only on (seed, s)."""
    db, _ = _families(rng, 1024, 4, 10)
    a = sharded.build_ivf_index(db, torch.Generator().manual_seed(5),
                                _mesh(2), block_size=16)
    b = sharded.build_ivf_index(
        db, torch.Generator().manual_seed(5),
        mesh_lib.make_mesh(4, data=1, devices=["cpu"] * 4), block_size=16)
    for sa, sb in zip(a.shards[0], b.shards[0]):
        assert torch.equal(sa.order, sb.order)
        assert torch.equal(sa.db_sorted, sb.db_sorted)
    # the data rows hold the same objects where the device repeats
    assert a.shards[1][2] is a.shards[0][2]


def test_data_rows_with_moved_replicas(rng):
    """A data row on another device holds moved copies of the shards (the
    move is exercised here onto the same device): the search is
    unchanged."""
    db, centers = _db_with_planted(rng, 300, 8, 10)
    cfg = motif.MotifSearchConfig(radius=25.0)
    for idx, move, run in (
            (sharded.build_ivf_index(db, torch.Generator().manual_seed(1),
                                     _mesh(), block_size=16),
             sharded._move_ivf,
             lambda i: sharded.search_ivf(i, centers, 25.0, k_blocks=64)),
            (sharded.build_index(db, torch.Generator().manual_seed(1),
                                 _mesh(), cfg),
             sharded._move_motif,
             lambda i: sharded.search(i, centers, 25.0))):
        want = run(idx)
        idx.shards[1] = [move(s, torch.device("cpu"))
                         for s in idx.shards[0]]
        assert idx.shards[1][0] is not idx.shards[0][0]
        for a, b in zip(run(idx), want):
            np.testing.assert_array_equal(a, b)


def _clear_centers(idx, centers, radius, kb):
    """Centers whose kb-th and (kb+1)-th live keys differ by more than
    float noise on every shard, and whose first kb+1 keys lie clear of
    their liveness threshold: there the block select cannot depend on the
    package."""
    emb = torch.as_tensor(embedding.embed_kmers(centers))
    ok = np.ones(len(centers), bool)
    for s in idx.shards[0]:
        key, _, _ = cuda_kernels.sq_distance_prune_plain(
            emb, s.block_centroid, s.block_radius, radius)
        key = key[:, :s.num_blocks]
        d = torch.cdist(emb.double(), s.block_centroid.double())
        thr = radius + s.block_radius.double()[None, :]
        for i in range(len(centers)):
            k = torch.sort(key[i]).values[:kb + 1].double()
            fin = torch.isfinite(k)
            if int(fin.sum()) > kb and float(k[kb] - k[kb - 1]) <= 1e-3:
                ok[i] = False
            near = ((d[i] - thr[0]).abs() <= 1e-3)
            if bool(near.any()):
                ok[i] = False
    return ok


def test_sharded_ivf_equals_jax_at_capped_kb(rng):
    db, centers = _families(rng, 1024, 12, 25)
    jidx = jsharded.build_ivf_index(db, jax.random.PRNGKey(0),
                                    jmesh.make_mesh(8, data=2),
                                    block_size=16)
    idx = _carry_ivf(jidx)
    # JAX's dummy blocks (radius -inf, never alive) are dropped
    rad = np.asarray(jidx.block_radius).reshape(4, -1)
    assert [s.num_blocks for s in idx.shards[0]] == \
        [int(np.isfinite(r).sum()) for r in rad]
    assert idx.blocks_per_shard <= jidx.blocks_per_shard
    # lossless: equal to the oracle
    _same_hits(sharded.search_ivf(idx, centers, 35.0,
                                  k_blocks=idx.blocks_per_shard),
               exact.search_radius(db, centers, 35.0, device="cpu"))
    kb = 2
    clear = _clear_centers(idx, centers, 35.0, kb)
    assert clear.sum() >= len(centers) // 2
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = sharded.search_ivf(idx, centers[clear], 35.0, k_blocks=kb)
        want = jsharded.search_ivf(jidx, centers[clear], 35.0, k_blocks=kb)
    assert len(want[0]) > 0
    _same_hits(got, want)


def test_sharded_ivf_uneven_db(rng):
    n, c, l = 509, 5, 10
    db = rng.integers(0, 20, (n, l), dtype=np.int32)
    centers = db[rng.choice(n, c, replace=False)]
    idx = sharded.build_ivf_index(db, torch.Generator().manual_seed(1),
                                  _mesh(), block_size=16)
    ci, ki, _ = sharded.search_ivf(idx, centers, 25.0,
                                   k_blocks=idx.blocks_per_shard)
    assert (ki < n).all()
    gt = exact.search_radius(db, centers, 25.0, device="cpu")
    assert set(zip(ci, ki)) == _pairs(gt)


def test_empty_shards(rng):
    # 9 rows over 8 shards of 2: shards 5..7 hold no real row
    db = rng.integers(0, 20, (9, 6), dtype=np.int32)
    mesh = mesh_lib.make_mesh(8, data=1, devices=["cpu"] * 8)
    iv = sharded.build_ivf_index(db, torch.Generator(), mesh, block_size=2)
    lsh = sharded.build_index(db, torch.Generator(), mesh,
                              motif.MotifSearchConfig(radius=40.0))
    assert iv.n_real == [2, 2, 2, 2, 1, 0, 0, 0]
    assert iv.shards[0][5] is None and lsh.shards[0][7] is None
    gt = exact.search_radius(db, db[:3], 40.0, device="cpu")
    assert set(zip(*sharded.search_ivf(iv, db[:3], 40.0, k_blocks=8)[:2])) \
        == _pairs(gt)
    assert set(zip(*sharded.search(lsh, db[:3], 40.0)[:2])) <= _pairs(gt)


def test_padding_rows_never_displace_real_hits(rng):
    # n not divisible by the db axis -> zero-filled (poly-A) padding rows;
    # an all-A center must get REAL near rows in its per-shard slots
    n, l = 509, 10
    db = rng.integers(1, 20, (n, l), dtype=np.int32)   # nothing is all-A
    near = np.zeros((40, l), np.int32)
    near[:, 0] = rng.integers(0, 3, 40)                # near-all-A rows
    db[-40:] = near                                    # tail of LAST shard
    centers = np.zeros((1, l), np.int32)               # all-A center
    cfg = motif.MotifSearchConfig(hash_k=2, hash_l=8, w=200.0, radius=40.0,
                                  max_hits=8)
    jcfg = jmotif.MotifSearchConfig(hash_k=2, hash_l=8, w=200.0,
                                    radius=40.0, max_hits=8)
    jidx = jsharded.build_index(db, jax.random.PRNGKey(0),
                                jmesh.make_mesh(8, data=2), jcfg)
    gt_d = exact.search_radius(db, centers, 40.0, device="cpu")[2]
    for idx in (sharded.build_index(db, torch.Generator().manual_seed(0),
                                    _mesh(), cfg), _carry_lsh(jidx)):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            ci, ki, d = sharded.search(idx, centers, radius=40.0)
        assert len(ki) > 0 and (ki < n).all()
        k = min(8, len(d), len(gt_d))
        np.testing.assert_allclose(np.sort(d)[:k], np.sort(gt_d)[:k],
                                   atol=1e-3)
        assert np.sort(d)[0] < 1e-3         # the planted 0-distance rows


def test_sharded_multiprobe_finds_superset(rng):
    n, c, l = 512, 8, 10
    db, centers = _db_with_planted(rng, n, c, l)
    hits = []
    for probes in (1, 8):
        cfg = motif.MotifSearchConfig(hash_k=8, hash_l=4, w=50.0,
                                      radius=25.0, probes=probes)
        idx = sharded.build_index(db, torch.Generator().manual_seed(5),
                                  _mesh(), cfg)
        hits.append(_pairs(sharded.search(idx, centers, 25.0)))
    assert hits[0] <= hits[1]
    assert len(hits[1]) > len(hits[0])   # multiprobe recovers extra recall


def test_no_false_truncation_warning(rng):
    # hits spread across shards but each shard under its cap: no warning
    n, c, l = 256, 4, 10
    db, centers = _db_with_planted(rng, n, c, l)
    cfg = motif.MotifSearchConfig(hash_k=4, hash_l=4, radius=25.0,
                                  max_hits=16)
    idx = sharded.build_index(db, torch.Generator().manual_seed(1), _mesh(),
                              cfg)
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*max_hits.*")
        sharded.search(idx, centers, radius=25.0)
    # a cap one shard's hits do exceed is reported
    idx.max_hits = 1
    with pytest.warns(UserWarning, match="max_hits=1"):
        sharded.search(idx, db[:4], radius=60.0)


def test_sharded_packed_overflow_fallback(rng):
    """Every center hits every row: the packed buffer overflows and the
    merge falls back to the full blocks without losing a hit."""
    n, c, l = 256, 8, 10
    db = rng.integers(0, 20, (n, l), dtype=np.int32)
    centers = db[:c].copy()
    idx = sharded.build_ivf_index(db, torch.Generator().manual_seed(2),
                                  _mesh(), block_size=16, max_hits=n)
    st = {}
    got = sharded.search_ivf(idx, centers, radius=1e3,
                             k_blocks=idx.blocks_per_shard, stats_out=st)
    gt = exact.search_radius(db, centers, 1e3, max_hits=n, device="cpu")
    assert len(got[0]) == c * n and st["over_blocks"] == 0
    assert _pairs(got) == _pairs(gt)
