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
from hsearch_tpu_torch.core import embedding
from hsearch_tpu_torch.ops import cuda_kernels as ck
from hsearch_tpu_torch.search import exact, ivf
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
    neg, ids = ivf._cascade_top_blocks(T(key), kb, 64)
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
        idx.block_radius, radius).numpy(), axis=1)
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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ivf.build_index(db, torch.Generator(), kmeans_iters=2, device="cpu")
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
