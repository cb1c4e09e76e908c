"""hsearch_tpu_torch.search.ivf against hsearch_tpu.search.ivf on the same
numpy inputs, on the CPU (the kernels' plain versions).

Torch cannot reproduce JAX's random draws, so the parity tests hand both
packages the same centroids or cells, or search one index that the JAX
package built and saved to its .npz checkpoint.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hsearch_tpu.search import exact as jexact
from hsearch_tpu.search import ivf as jivf
from hsearch_tpu.utils import checkpoint as jckpt
from hsearch_tpu_torch import native_ext
from hsearch_tpu_torch.core import embedding
from hsearch_tpu_torch.ops import cuda_kernels as ck
from hsearch_tpu_torch.search import exact, ivf, stream
from hsearch_tpu_torch.utils import checkpoint

T = torch.as_tensor


def _family_db(rng, n, c, l, family_size=32):
    nfam = max(1, n // family_size)
    fam = rng.integers(0, 20, (nfam, l), dtype=np.int32)
    db = fam[rng.integers(0, nfam, n)].copy()
    flips = rng.random((n, l)) < 0.08
    db[flips] = rng.integers(0, 20, int(flips.sum()))
    return db, fam[rng.choice(nfam, c, replace=False)]


def _pairs(res):
    return set(zip(res[0].tolist(), res[1].tolist()))


@pytest.fixture(scope="module")
def jax_index(tmp_path_factory):
    """One index built by the JAX package (block_size 8: enough blocks for
    the cascade select), saved to its .npz checkpoint."""
    rng = np.random.default_rng(1)
    db, centers = _family_db(rng, 2048, 16, 25)
    idx = jivf.build_index(db, jax.random.PRNGKey(0), block_size=8)
    path = str(tmp_path_factory.mktemp("ivf") / "jax_ivf.npz")
    jckpt.save_index(path, idx)
    return db, centers, idx, path


@pytest.mark.parametrize("cell_chunk", [None, 32, 64])
def test_assign_rows_matches_jax(rng, cell_chunk):
    n, l, n_cells = 3001, 10, 96
    km = rng.integers(0, 20, (n, l)).astype(np.int32)
    km[1000:1100] = km[1000]                 # duplicates -> distance ties
    cent = embedding.embed_kmers(km[rng.choice(n, n_cells, replace=False)])
    want = np.asarray(jivf._assign_rows(jnp.asarray(km), jnp.asarray(cent),
                                        n_cells, block=512,
                                        cell_chunk=cell_chunk))
    got = ivf._assign_rows(T(km).to(torch.int8), T(cent), n_cells,
                           block=512, cell_chunk=cell_chunk).numpy()
    assert got.dtype == np.int32
    # float32 products differ in the last bits between the two libraries:
    # a different cell is allowed only where the two are a near tie
    d2 = ((embedding.embed_kmers(km, dtype=np.float64)[:, None, :]
           - cent[None, :, :].astype(np.float64)) ** 2).sum(-1)
    rows = np.arange(n)
    diff = got != want
    assert diff.mean() < 0.01
    np.testing.assert_allclose(d2[rows, got][diff], d2[rows, want][diff],
                               rtol=1e-4)
    # chunking is result-invariant within the port
    if cell_chunk is not None:
        np.testing.assert_array_equal(
            got, ivf._assign_rows(T(km), T(cent), n_cells, block=512)
            .numpy())


def test_cell_aligned_groups_identical(rng):
    cells = rng.integers(0, 37, 1000)
    cells[cells == 5] = 6                    # an empty cell
    np.testing.assert_array_equal(
        ivf._cell_aligned_groups(cells, 37, 8, 1000),
        jivf._cell_aligned_groups(cells, 37, 8, 1000))


def test_stage2_matches_jax_given_cells(rng, monkeypatch):
    n, l, n_cells, bs = 3000, 25, 50, 8
    db, _ = _family_db(rng, n, 4, l)
    cells = rng.integers(0, n_cells, n).astype(np.int32)
    monkeypatch.setattr(jivf, "_assign_cells_kmers",
                        lambda *a, **k: jnp.asarray(cells))
    jidx = jivf.build_index(db, jax.random.PRNGKey(0), block_size=bs,
                            n_cells=n_cells)
    order = ivf._cell_aligned_groups(cells, n_cells, bs, n)
    db_s, cent, rad = ivf._stage2(T(db.astype(np.int8)), T(order), n, bs,
                                  bchunk=16)
    np.testing.assert_array_equal(db_s.numpy(), np.asarray(jidx.db_sorted))
    np.testing.assert_array_equal(order, np.asarray(jidx.order))
    np.testing.assert_allclose(cent.numpy(), np.asarray(jidx.block_centroid),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(rad.numpy(), np.asarray(jidx.block_radius),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("kb", [16, 128, 700])
def test_cascade_equals_flat_topk(rng, kb):
    c, b = 16, 5000
    key = rng.random((c, b)).astype(np.float32)
    key[rng.random((c, b)) < 0.3] = np.inf        # dead blocks
    # the prune kernel's outputs: keys inf-padded to whole groups, and
    # each group's minimum
    kp = np.pad(key, ((0, 0), (0, (-b) % 64)), constant_values=np.inf)
    gmin = kp.reshape(c, -1, 64).min(axis=2)
    neg, ids = ivf._cascade_top_blocks(T(kp), T(gmin), kb)
    fneg, fids = jax.lax.top_k(-jnp.asarray(key), kb)

    def live(n_, i_):
        n_, i_ = np.asarray(n_), np.asarray(i_)
        return {(ci, int(bi)) for ci in range(c)
                for bi, v in zip(i_[ci], n_[ci]) if np.isfinite(v)}
    assert live(neg, ids) == live(fneg, fids)


def test_jax_index_capped_kb_identical_hits(jax_index):
    db, centers, jidx, path = jax_index
    idx = checkpoint.load_index(path, device="cpu")
    np.testing.assert_array_equal(idx.db_sorted.numpy(),
                                  np.asarray(jidx.db_sorted))
    np.testing.assert_array_equal(idx.host_kmers, db.astype(np.int8))
    kb, radius = 16, 35.0
    assert idx.num_blocks >= 4 * ivf._SELECT_GROUP      # the cascade path
    # tie precondition: each center's kb-th and (kb+1)-th live keys
    # differ, so the selected block set does not depend on tie order
    key = np.sort(ck.sq_distance_prune(
        T(embedding.embed_kmers(centers)), idx.block_centroid,
        idx.block_radius, radius)[0][:, :idx.num_blocks].numpy(), axis=1)
    assert (key[:, kb] == np.inf).sum() < len(centers)  # kb really caps
    kth, nxt = key[:, kb - 1], key[:, kb]
    assert np.all(~np.isfinite(kth) | (kth < nxt * (1 - 1e-5)))
    st, jst = {}, {}
    got = ivf.search(idx, centers, radius, k_blocks=kb, max_hits=512,
                     retry_overflow=False, stats_out=st)
    want = jivf.search(jidx, centers, radius, k_blocks=kb, max_hits=512,
                       retry_overflow=False, stats_out=jst)
    assert st["over_blocks"] == jst["over_blocks"] > 0
    assert st["max_alive"] == jst["max_alive"]
    assert len(want[0]) > 100
    assert _pairs(got) == _pairs(want)


def test_jax_index_lossless_equals_both_oracles(jax_index):
    db, centers, jidx, path = jax_index
    idx = checkpoint.load_index(path, device="cpu")
    got = ivf.search(idx, centers, 35.0, k_blocks=idx.num_blocks,
                     max_hits=1024)
    port_oracle = exact.search_radius(db, centers, 35.0, device="cpu")
    jax_oracle = jexact.search_radius(db, centers, 35.0)
    assert _pairs(got) == _pairs(port_oracle) == _pairs(jax_oracle)
    gt = {(a, b): v for a, b, v in zip(*jax_oracle)}
    for a, b, v in zip(*got):
        np.testing.assert_allclose(v, gt[(a, b)], rtol=1e-5, atol=1e-4)


def test_retry_ladder_is_lossless(rng):
    db, centers = _family_db(rng, 4096, 24, 25)
    idx = ivf.build_index(db, torch.Generator().manual_seed(0),
                          block_size=8, device="cpu")
    assert idx.num_blocks >= 4 * ivf._SELECT_GROUP
    stats: dict = {}
    got = ivf.search(idx, centers, 35.0, k_blocks=4, max_hits=16,
                     center_block=16, retry_overflow=True, stats_out=stats)
    want = exact.search_radius(db, centers, 35.0, device="cpu")
    assert _pairs(got) == _pairs(want)
    assert stats["retried"] > 0 and stats["retry_depth"] > 1
    assert stats["over_blocks"] == stats["over_hits"] == 0


def test_packed_cap_escalation_ladder(rng):
    """A tight pack cap escalates (never the full-array fallback) and stays
    lossless at every rung."""
    n, c, l = 512, 16, 10
    db, _ = _family_db(rng, n, c, l, family_size=8)
    centers = db[rng.choice(n, c, replace=False)]
    idx = ivf.build_index(db, torch.Generator().manual_seed(0),
                          block_size=16, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        a = ivf.search(idx, centers, 1e3, k_blocks=idx.num_blocks,
                       max_hits=n, pack_cap_frac=4096)   # cap ~ 2 hits
        b = ivf.search(idx, centers, 1e3, k_blocks=idx.num_blocks,
                       max_hits=n, pack_cap_frac=1)
    assert len(a[0]) == c * n
    assert _pairs(a) == _pairs(b)
    db_ = {(x, y): v for x, y, v in zip(*b)}
    for x, y, v in zip(*a):
        np.testing.assert_allclose(v, db_[(x, y)], atol=1e-4)


@pytest.mark.parametrize("cap_frac", [0, -1])
def test_pack_cap_frac_below_one_raises(rng, cap_frac):
    """cap_frac 1 holds every hit slot, so a smaller one is refused."""
    db, centers = _family_db(rng, 256, 4, 10)
    idx = ivf.build_index(db, torch.Generator().manual_seed(0),
                          block_size=16, device="cpu")
    with pytest.raises(ValueError, match="pack_cap_frac"):
        ivf.search(idx, centers, 35.0, pack_cap_frac=cap_frac)


def test_transfer_d2_off_matches_on(rng):
    db, centers = _family_db(rng, 2048, 24, 25)
    idx = ivf.build_index(db, torch.Generator().manual_seed(0),
                          block_size=32, device="cpu")
    kw = dict(k_blocks=16, max_hits=512, retry_overflow=False, stats_out={})
    a = ivf.search(idx, centers, 35.0, transfer_d2=True, **kw)
    b = ivf.search(idx, centers, 35.0, transfer_d2=False, **kw)
    assert _pairs(a) == _pairs(b) and len(a[0]) > 100
    da = {(x, y): v for x, y, v in zip(*a)}
    for x, y, v in zip(*b):
        np.testing.assert_allclose(v, da[(x, y)], atol=1e-3)
    # float centers cannot recompute d2 on the host: explicit False raises
    with pytest.raises(ValueError, match="transfer_d2"):
        ivf.search(idx, embedding.embed_kmers(centers), 35.0,
                   transfer_d2=False, **kw)


def test_host_d2_native_pass_equals_numpy_twin(rng, monkeypatch):
    """The host d2 through the library's pass and through its numpy twin
    (patched in for the pass): bitwise-equal results, the retry's hits
    counted too."""
    db, centers = _family_db(rng, 4096, 24, 25)
    idx = ivf.build_index(db, torch.Generator().manual_seed(0),
                          block_size=8, device="cpu")
    kw = dict(k_blocks=4, max_hits=64, center_block=16)
    native_ext.reset_calls()
    st_n: dict = {}
    native = ivf.search(idx, centers, 35.0, stats_out=st_n, **kw)
    native_calls = native_ext.hit_sq_distance.calls
    twin_hits = []

    def twin_d2(*args):
        twin_hits.append(len(args[1]))
        return embedding.hit_sq_distance_np(*args)

    monkeypatch.setattr(native_ext, "hit_sq_distance", twin_d2)
    st_t: dict = {}
    twin = ivf.search(idx, centers, 35.0, stats_out=st_t, **kw)
    assert st_n["retried"] > 0 and len(native[0]) > 100
    for a, b in zip(native, twin):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert st_n["host_d2_hits"] == st_t["host_d2_hits"] \
        == sum(twin_hits) > len(native[0])
    assert native_calls == len(twin_hits) > 1


@pytest.mark.parametrize("transfer_d2", [False, True])
def test_host_d2_hits_count_the_returned_hits(rng, transfer_d2):
    db, centers = _family_db(rng, 2048, 24, 25)
    idx = ivf.build_index(db, torch.Generator().manual_seed(0),
                          block_size=32, device="cpu")
    st: dict = {}
    got = ivf.search(idx, centers, 35.0, k_blocks=16, max_hits=512,
                     center_block=8, retry_overflow=False, stats_out=st,
                     transfer_d2=transfer_d2)
    assert len(got[0]) > 100
    want = 0 if transfer_d2 else len(got[0])
    assert st["host_d2_hits"] == want


def test_segmented_sums_the_host_d2_counters(rng):
    db, centers = _family_db(rng, 4096, 24, 25)
    sidx = stream.build_segmented(db, torch.Generator().manual_seed(0),
                                  segment_points=1024, block_size=16,
                                  device="cpu")
    st: dict = {}
    got = stream.search_segmented(sidx, centers, 35.0, k_blocks=64,
                                  max_hits=512, retry_overflow=False,
                                  stats_out=st)
    per_seg = []
    for seg in sidx.segments:
        one: dict = {}
        ivf.search(stream.upload_segment(seg, "cpu"), centers, 35.0,
                   k_blocks=64, max_hits=512, retry_overflow=False,
                   stats_out=one)
        per_seg.append(one)
    assert st["segments"] == 4 and len(got[0]) > 100
    assert st["host_d2_hits"] == sum(s["host_d2_hits"] for s in per_seg) \
        == len(got[0])
    assert min(s["host_d2_hits"] for s in per_seg) > 0


def test_port_npz_loads_in_jax(rng, tmp_path):
    db, centers = _family_db(rng, 1024, 8, 25)
    idx = ivf.build_index(db, torch.Generator().manual_seed(3),
                          block_size=32, device="cpu")
    path = str(tmp_path / "port_ivf.npz")
    checkpoint.save_index(path, idx)
    jidx = jckpt.load_index(path)
    np.testing.assert_array_equal(jidx.host_kmers_np, db.astype(np.int8))
    want = jivf.search(jidx, centers, 35.0, k_blocks=jidx.num_blocks,
                       max_hits=1024)
    got = ivf.search(idx, centers, 35.0, k_blocks=idx.num_blocks,
                     max_hits=1024)
    assert _pairs(got) == _pairs(want) and len(got[0]) > 20
    back = checkpoint.load_index(path, device="cpu")
    for f in ("db_sorted", "order", "block_centroid", "block_radius"):
        assert torch.equal(getattr(back, f), getattr(idx, f))


def test_build_is_seeded_and_invertible(rng):
    db = rng.integers(0, 20, (509, 10), dtype=np.int32)
    a = ivf.build_index(db, torch.Generator().manual_seed(1), block_size=16,
                        device="cpu")
    b = ivf.build_index(db, torch.Generator().manual_seed(1), block_size=16,
                        device="cpu")
    assert torch.equal(a.order, b.order)
    np.testing.assert_array_equal(ivf._index_kmers(a), db)
    np.testing.assert_array_equal(
        ivf.unsort_blocks(a.order.numpy(), a.db_sorted.numpy(), 509, 10),
        db)
    # Lloyd refinement: seeded and invertible like the sampled build
    ka = ivf.build_index(db, torch.Generator().manual_seed(1), block_size=16,
                         kmeans_iters=2, device="cpu")
    kb = ivf.build_index(db, torch.Generator().manual_seed(1), block_size=16,
                         kmeans_iters=2, device="cpu")
    assert torch.equal(ka.order, kb.order)
    np.testing.assert_array_equal(
        ivf.unsort_blocks(ka.order.numpy(), ka.db_sorted.numpy(), 509, 10),
        db)
    bad = db.copy()
    bad[3, 4] = 20
    with pytest.raises(ValueError, match="amino-acid indices"):
        ivf.build_index(bad, torch.Generator(), device="cpu")
    with pytest.raises(ValueError, match="amino-acid indices"):
        ivf.search(a, bad[:4] - 1, 10.0)


def test_autotune_k_blocks_reaches_target(rng):
    from hsearch_tpu_torch.search import evaluate
    db, centers = _family_db(rng, 4096, 24, 25)
    idx = ivf.build_index(db, torch.Generator().manual_seed(0),
                          block_size=16, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        kb = ivf.autotune_k_blocks(idx, centers[:12], 35.0,
                                   target_recall=0.98,
                                   candidates=(4, 8, 16, 32, 64))
        got = ivf.search(idx, centers[12:], 35.0, k_blocks=kb, max_hits=512,
                         retry_overflow=False)
    assert 4 <= kb <= idx.num_blocks
    want = exact.search_radius(db, centers[12:], 35.0, device="cpu")
    rep = evaluate.recall_from_indices(*want, got[0], got[1], 35.0)
    assert rep.recall >= 0.96


def test_lloyd_matches_jax_kmeans_cells():
    """Given JAX's own draw of the initial centroids, the port's Lloyd
    iterations assign every point as hsearch_tpu's _kmeans_cells does,
    except a point whose two nearest centroids are a near tie."""
    rng = np.random.default_rng(11)
    n, l, n_cells, iters = 3000, 10, 96, 3
    pts = embedding.embed_kmers(rng.integers(0, 20, (n, l)))
    key = jax.random.PRNGKey(5)
    idx = np.asarray(jax.random.choice(key, n, (n_cells,),
                                       replace=n < n_cells))
    want = np.asarray(jivf._kmeans_cells(jnp.asarray(pts), key, n_cells,
                                         iters))
    got, cent = ivf._lloyd(T(pts), T(pts)[T(idx.copy())], iters,
                           block=512)
    got = got.numpy()
    assert got.dtype == np.int32 and len(np.unique(got)) > n_cells // 2
    diff = np.nonzero(got != want)[0]
    d2 = ((pts[diff, None, :].astype(np.float64)
           - cent.numpy()[None].astype(np.float64)) ** 2).sum(-1)
    rows = np.arange(len(diff))
    assert np.all(np.abs(d2[rows, want[diff]] - d2[rows, got[diff]])
                  <= 1e-5 * d2[rows, got[diff]])
    assert len(diff) <= n // 100


def test_lloyd_keeps_empty_cells_and_ties_first():
    """An empty cell keeps its centroid; equidistant centroids go to the
    first (two identical initial centroids: the second stays empty)."""
    pts = T(np.array([[0.0, 0.0], [0.1, 0.0], [5.0, 5.0], [5.1, 5.0]],
                     np.float32))
    init = T(np.array([[0.0, 0.0], [5.0, 5.0], [5.0, 5.0], [90.0, 90.0]],
                      np.float32))
    assert ivf._lloyd(pts, init, 0)[0].tolist() == [0, 0, 1, 1]
    a, cent = ivf._lloyd(pts, init, 1)
    np.testing.assert_allclose(cent.numpy(), [[0.05, 0.0], [5.05, 5.0],
                                              [5.0, 5.0], [90.0, 90.0]],
                               rtol=1e-6)
    # the kept centroid (5, 5) now holds (5, 5) exactly
    assert a.tolist() == [0, 0, 2, 1]


def test_kmeans_build_is_lossless(rng):
    db, centers = _family_db(rng, 2048, 16, 25)
    idx = ivf.build_index(db, torch.Generator().manual_seed(2),
                          block_size=16, kmeans_iters=2, device="cpu")
    got = ivf.search(idx, centers, 35.0, k_blocks=8, max_hits=1024)
    want = exact.search_radius(db, centers, 35.0, device="cpu")
    assert _pairs(got) == _pairs(want) and len(want[0]) > 100
