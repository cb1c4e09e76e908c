"""The IVF engine's approximate block select (hsearch_tpu_torch.search.ivf's
``_approx_bins``, ``_approx_topk_min`` and ``approx_select``) against
``jax.lax.approx_max_k`` and hsearch_tpu.search.ivf on the CPU.

XLA's CPU lowering of ``approx_max_k`` is an exact sort, so only the
reduction width is observable here; the bin layout is checked against a
numpy reference of the strided layout.  Both packages approximate only on
their accelerator, so ``ivf.search(approx_select=True)`` on the CPU is held
to the JAX package's exact result; the approximate path itself is driven
on the CPU through ``_search_block_hits`` and by opening the device gate
(``ivf._approximates``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hsearch_tpu.search import ivf as jivf
from hsearch_tpu.utils import checkpoint as jckpt
from hsearch_tpu_torch.core import embedding
from hsearch_tpu_torch.ops import cuda_kernels as ck
from hsearch_tpu_torch.search import exact, ivf
from hsearch_tpu_torch.utils import checkpoint

T = torch.as_tensor
RADIUS = 35.0

# row lengths from 100 to 2^17, powers of two and not
NS = (100, 128, 129, 200, 255, 256, 257, 385, 777, 839, 1000, 1513, 2049,
      3000, 4096, 5000, 8191, 12896, 40000, 65536, 66000, 99991, 100000,
      131071, 131072)


def _pairs(res):
    return set(zip(res[0].tolist(), res[1].tolist()))


def _xla_bins(n, k):
    out = jax.eval_shape(
        lambda x: jax.lax.approx_max_k(x, k, recall_target=0.95,
                                       aggregate_to_topk=False),
        jax.ShapeDtypeStruct((2, n), jnp.float32))
    return out[0].shape[1]


@pytest.mark.parametrize("k", [1, 2, 3, 8, 16, 31, 100, 128, 256, 1000,
                               1024, 2048])
def test_approx_bins_equal_xla_reduction_width(k):
    got = {n: ivf._approx_bins(n, k) for n in NS if k <= n}
    assert got == {n: _xla_bins(n, k) for n in got}


def test_approx_bins_at_known_points():
    for (n, k), want in {(12896, 128): 3328, (12896, 256): 6528,
                         (65536, 100): 2048, (66000, 1024): 33024,
                         (3000, 16): 384, (839, 128): 839,
                         (100000, 2): 256}.items():
        assert ivf._approx_bins(n, k) == want == _xla_bins(n, k)


def _strided_bins(vals, ks):
    """numpy: element j in bin j mod L; each bin's minimum and the index
    of its first minimal element."""
    c, n = vals.shape
    nb = ivf._approx_bins(n, ks)
    m = -(-n // nb)
    binned = np.pad(vals, ((0, 0), (0, m * nb - n)),
                    constant_values=np.inf).reshape(c, m, nb)
    row = np.argmin(binned, axis=1)
    bmin = np.take_along_axis(binned, row[:, None, :], 1)[:, 0]
    return bmin, row * nb + np.arange(nb)


@pytest.mark.parametrize("n,ks", [(3000, 16), (1000, 4), (12896, 128),
                                  (4096, 1), (66000, 1024)])
def test_approx_topk_min_equals_strided_bins(rng, n, ks):
    c = 6
    nb = ivf._approx_bins(n, ks)
    assert nb < n
    # few distinct values: ties inside bins and between bins; dead entries
    vals = rng.integers(0, 50, (c, n)).astype(np.float32)
    vals[rng.random((c, n)) < 0.3] = np.inf
    vals[0] = np.inf                      # a row with no live entry
    neg, idx = (x.numpy() for x in ivf._approx_topk_min(T(vals), ks))
    assert neg.shape == idx.shape == (c, ks) and idx.dtype == np.int64
    bmin, first = _strided_bins(vals, ks)
    # the ks best bin minima (which of several equal ones is free) ...
    np.testing.assert_array_equal(np.sort(-neg, axis=1),
                                  np.sort(bmin, axis=1)[:, :ks])
    # ... each from a distinct bin, named by its first minimal element
    b = idx % nb
    assert all(len(set(r)) == ks for r in b.tolist())
    np.testing.assert_array_equal(np.take_along_axis(bmin, b, 1), -neg)
    np.testing.assert_array_equal(np.take_along_axis(first, b, 1), idx)


@pytest.mark.parametrize("n,ks", [(839, 128), (128, 5), (1513, 128),
                                  (500, 100)])
def test_approx_topk_min_is_topk_without_reduction(rng, n, ks):
    assert ivf._approx_bins(n, ks) >= n
    vals = T(rng.random((5, n)).astype(np.float32))
    neg, idx = ivf._approx_topk_min(vals, ks)
    want = torch.topk(-vals, ks, dim=1)
    assert torch.equal(neg, want.values) and torch.equal(idx, want.indices)


@pytest.mark.parametrize("n,ks", [(3000, 16), (1000, 4), (4096, 32)])
def test_approx_topk_min_recall_on_random_keys(n, ks):
    vals = T(np.random.default_rng(n).random((4096, n)).astype(np.float32))
    _, idx = ivf._approx_topk_min(vals, ks)
    exact_idx = torch.topk(-vals, ks, dim=1).indices
    hit = (idx[:, :, None] == exact_idx[:, None, :]).any(dim=2)
    recall = float(hit.float().mean())
    assert 0.95 <= recall < 1.0


def test_cascade_with_approx_stage1_names_live_real_blocks(rng):
    c, b, kb = 16, 600 * 64, 8
    key = rng.random((c, b)).astype(np.float32)
    key[rng.random((c, b)) < 0.3] = np.inf
    gmin = key.reshape(c, -1, 64).min(axis=2)
    assert ivf._approx_bins(gmin.shape[1], kb) < gmin.shape[1]
    neg, ids = (x.numpy() for x in ivf._cascade_top_blocks(
        T(key), T(gmin), kb, approx=True))
    assert np.all(ids < b)
    np.testing.assert_array_equal(np.take_along_axis(key, ids, 1), -neg)
    assert all(len(set(r)) == kb for r in ids.tolist())
    # exact stage 2 inside the chosen groups: every chosen block is at
    # least as near as the exact kb-th block
    fneg = torch.topk(-T(key), kb, dim=1).values.numpy()
    assert np.all(neg <= fneg[:, :1])


@pytest.fixture(scope="module")
def family_index():
    """A CPU IVF index whose cascade reduces its stage-1 domain at small
    kb: 2^16 family rows (32 per family, ~2 substitutions each) cut into
    family-aligned blocks of 2 (the families stand in for the cells).
    Returns (db, centers, index)."""
    rng = np.random.default_rng(3)
    n, l, bs = 1 << 16, 25, 2
    nfam = n // 32
    fam = rng.integers(0, 20, (nfam, l))
    which = rng.integers(0, nfam, n)
    db = np.where(rng.random((n, l)) < 0.08, rng.integers(0, 20, (n, l)),
                  fam[which]).astype(np.int32)
    order = ivf._cell_aligned_groups(which, nfam, bs, n)
    db_s, cent, rad = ivf._stage2(T(db.astype(np.int8)), T(order), n, bs)
    index = ivf.IVFIndex(db_sorted=db_s, order=T(order),
                         block_centroid=cent, block_radius=rad, n_points=n,
                         host_kmers=db.astype(np.int8), kmer_len=l)
    return db, fam[rng.choice(nfam, 48, replace=False)].astype(np.int32), \
        index


def _spy(monkeypatch):
    """Record the (n, ks) of every approximate select."""
    calls = []
    real = ivf._approx_topk_min

    def spy(vals, ks, *a):
        calls.append((vals.shape[1], ks))
        return real(vals, ks, *a)
    monkeypatch.setattr(ivf, "_approx_topk_min", spy)
    return calls


def test_block_hits_approx_subset_of_exact(family_index, monkeypatch):
    db, centers, index = family_index
    calls = _spy(monkeypatch)
    r = np.float32(RADIUS)
    emb = T(embedding.embed_kmers(centers))
    kb, ng = 8, -(-index.num_blocks // ivf._SELECT_GROUP)
    assert ivf._approx_bins(ng, kb) < ng
    runs = {a: [x.numpy() for x in ivf._search_block_hits(
        index, T(centers), emb, r, kb, 64, approx_select=a)]
        for a in (False, True)}
    assert calls == [(ng, kb)]
    truth = _pairs(exact.search_radius(db, centers, RADIUS, device="cpu"))
    n = index.n_points
    hits = {}
    for a, (ids, d2, _, _) in runs.items():
        cc, jj = np.nonzero(ids < n)
        hits[a] = {(c, int(ids[c, j])): d2[c, j] for c, j in zip(cc, jj)}
        assert set(hits[a]) <= truth
    # a group the approximate select misses costs hits, never adds one
    assert len(hits[True]) > 0.9 * len(hits[False]) > 0
    np.testing.assert_array_equal(runs[True][3], runs[False][3])
    for p in set(hits[True]) & set(hits[False]):
        assert hits[True][p] == hits[False][p]          # bitwise d^2


def test_flat_branch_takes_the_approx_gate(monkeypatch):
    """Below 4 groups of blocks the select is flat, and a flat domain that
    small (< 256 blocks) never reduces: the approximate select there is
    the exact one, as approx_max_k's is."""
    calls = _spy(monkeypatch)
    vals = T(np.random.default_rng(0).random((3, 255)).astype(np.float32))
    got = ivf._select_nearest(vals, 16, approx=True)
    assert calls == [(255, 16)]
    want = torch.topk(-vals, 16, dim=1)
    assert torch.equal(got[0], want.values) and \
        torch.equal(got[1], want.indices)
    ivf._select_nearest(vals, 32, approx=True)      # 8k > 255: gate shut
    assert calls == [(255, 16)]


def test_search_approximates_only_on_the_card(family_index, monkeypatch):
    db, centers, index = family_index
    calls = _spy(monkeypatch)
    kw = dict(k_blocks=8, max_hits=64, center_block=16,
              retry_overflow=False, stats_out={})
    exact_res = ivf.search(index, centers, RADIUS, approx_select=False, **kw)
    cpu_res = ivf.search(index, centers, RADIUS, approx_select=True, **kw)
    assert calls == []                  # the CPU gives the exact select
    assert _pairs(cpu_res) == _pairs(exact_res)
    np.testing.assert_array_equal(cpu_res[2], exact_res[2])
    # with the gate open, every center block approximates, and the hits
    # stay true hits
    monkeypatch.setattr(ivf, "_approximates", lambda dev: True)
    approx_res = ivf.search(index, centers, RADIUS, approx_select=True, **kw)
    ng = -(-index.num_blocks // ivf._SELECT_GROUP)
    assert len(calls) >= 3 and set(calls) == {(ng, 8)}
    truth = _pairs(exact.search_radius(db, centers, RADIUS, device="cpu"))
    assert _pairs(approx_res) <= truth


def test_env_var_is_read_on_each_call(family_index, monkeypatch):
    _, centers, index = family_index
    calls = _spy(monkeypatch)
    monkeypatch.setattr(ivf, "_approximates", lambda dev: True)
    kw = dict(k_blocks=8, max_hits=64, center_block=48,
              retry_overflow=False, stats_out={})
    seen = []
    for env, arg in (("1", None), ("0", None), ("1", None), ("1", False),
                     ("0", True)):
        monkeypatch.setenv("HSEARCH_APPROX_SELECT", env)
        before = len(calls)
        ivf.search(index, centers, RADIUS, approx_select=arg, **kw)
        seen.append(len(calls) > before)
    assert seen == [True, False, True, False, True]


def test_retry_keeps_the_approx_select(family_index, monkeypatch):
    """The overflow retry re-runs the overflowed centers with the same
    select; the result is then the lossless one only where the approximate
    select missed nothing, so it is held to the oracle as a subset."""
    db, centers, index = family_index
    calls = _spy(monkeypatch)
    monkeypatch.setattr(ivf, "_approximates", lambda dev: True)
    st: dict = {}
    got = ivf.search(index, centers[:8], RADIUS, k_blocks=8, max_hits=64,
                     center_block=8, retry_overflow=True, stats_out=st,
                     approx_select=True)
    assert st["retried"] > 0
    assert len(calls) > 1 and calls[0] == (calls[0][0], 8)
    truth = _pairs(exact.search_radius(db, centers[:8], RADIUS,
                                       device="cpu"))
    assert _pairs(got) <= truth


@pytest.fixture(scope="module")
def jax_index(tmp_path_factory):
    """An index built by the JAX package, saved to its .npz checkpoint."""
    rng = np.random.default_rng(1)
    nfam = 64
    fam = rng.integers(0, 20, (nfam, 25), dtype=np.int32)
    db = fam[rng.integers(0, nfam, 2048)].copy()
    flips = rng.random(db.shape) < 0.08
    db[flips] = rng.integers(0, 20, int(flips.sum()))
    centers = fam[rng.choice(nfam, 16, replace=False)]
    idx = jivf.build_index(db, jax.random.PRNGKey(0), block_size=8)
    path = str(tmp_path_factory.mktemp("ivf") / "jax_ivf.npz")
    jckpt.save_index(path, idx)
    return db, centers, idx, path


@pytest.mark.parametrize("kb,retry", [(16, False), (4, True)])
def test_search_approx_on_cpu_equals_jax(jax_index, kb, retry):
    db, centers, jidx, path = jax_index
    idx = checkpoint.load_index(path, device="cpu")
    if not retry:
        # the kb-th and (kb+1)-th keys differ, so the capped block set does
        # not depend on tie order
        key = np.sort(ck.sq_distance_prune(
            T(embedding.embed_kmers(centers)), idx.block_centroid,
            idx.block_radius, RADIUS)[0][:, :idx.num_blocks].numpy(), axis=1)
        assert (key[:, kb] == np.inf).sum() < len(centers)
        kth, nxt = key[:, kb - 1], key[:, kb]
        assert np.all(~np.isfinite(kth) | (kth < nxt * (1 - 1e-5)))
    kw = dict(k_blocks=kb, max_hits=512, retry_overflow=retry,
              approx_select=True, stats_out={})
    got = ivf.search(idx, centers, RADIUS, **kw)
    want = jivf.search(jidx, centers, RADIUS, **kw)
    assert len(want[0]) > 100
    assert _pairs(got) == _pairs(want)
    if retry:
        assert _pairs(got) == _pairs(exact.search_radius(
            db, centers, RADIUS, device="cpu"))
