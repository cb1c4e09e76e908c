"""The port's k-mer clustering against hsearch_tpu on the same numpy inputs
and the same LSH draws: the greedy election and cluster_greedy (parent and
merged equal), the centroid rounds (equal partitions), the center-distance
merge (equal labels), connected components, and the host helpers.

Greedy labels are compared exactly: every case checks first that no
in-bucket distance lies within 1e-3 of the radius, so float32 summation
order cannot flip an absorption.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hsearch_tpu.cluster import centroid as jc
from hsearch_tpu.cluster import greedy as jg
from hsearch_tpu.cluster import postprocess as jpp
from hsearch_tpu.cluster import union_find as juf
from hsearch_tpu.core import alphabet as jalpha
from hsearch_tpu.core import embedding
from hsearch_tpu.core import io as jio
from hsearch_tpu.lsh import pstable as jp
from hsearch_tpu_torch.cluster import centroid as tc
from hsearch_tpu_torch.cluster import greedy as tg
from hsearch_tpu_torch.cluster import postprocess as tpp
from hsearch_tpu_torch.cluster import union_find as tuf
from hsearch_tpu_torch.core import alphabet as talpha
from hsearch_tpu_torch.core import io as tio


def _bucket_dist(bk):
    return np.sqrt(embedding.DISTANCE_SQUARE[
        bk[:, :, None, :], bk[:, None, :, :]].sum(-1))


def test_election_matches_reference_and_jax(rng):
    """The cases of tests/test_cluster.py's election test: the port's
    election == the sequential walk == the JAX device election."""
    for trial in range(20):
        nb, b, l = 4, 12, 6
        bk = rng.integers(0, 20, size=(nb, b, l), dtype=np.int32)
        bk[:, 5] = bk[:, 1]                  # distances of 0
        state = rng.integers(0, 2, size=(nb, b)).astype(np.uint8)
        valid = rng.random((nb, b)) > 0.2
        radius = float(rng.uniform(10, 40))
        d = _bucket_dist(bk).astype(np.float32)
        got = tg._elect_device(torch.as_tensor(d), torch.as_tensor(state),
                               torch.as_tensor(valid), radius).numpy()
        want = np.asarray(jg._elect_device(
            jnp.asarray(d), jnp.asarray(state), jnp.asarray(valid),
            jnp.float32(radius)))
        np.testing.assert_array_equal(got, want, err_msg=f"trial {trial}")
        for i in range(nb):
            np.testing.assert_array_equal(
                got[i], tg._elect_reference(d[i], state[i], valid[i],
                                            radius))


def test_bucket_distances_match_jax(rng):
    """Both take the norm identity in float32: d^2 agrees within
    1e-3 + 1e-5 (|a|^2 + |b|^2) (summation order; near d = 0 the sqrt
    magnifies it, so the comparison is in d^2)."""
    bk = rng.integers(0, 20, (3, 16, 8), dtype=np.int32)
    bk[:, 3] = bk[:, 0]
    got = tg._bucket_distances(torch.as_tensor(bk)).numpy() ** 2
    want = np.asarray(jg._bucket_distances(jnp.asarray(bk), 8)) ** 2
    sq = (embedding.embed_kmers(bk.reshape(-1, 8)) ** 2).sum(-1) \
        .reshape(3, 16)
    tol = 1e-3 + 1e-5 * (sq[:, :, None] + sq[:, None, :])
    assert (np.abs(got - want) <= tol).all()
    assert (np.abs(got - _bucket_dist(bk) ** 2) <= tol).all()


def _round_params(key, cfg, dim):
    """What the JAX package's cluster_greedy draws for each round."""
    keys = jax.random.split(key, cfg.hash_l)
    out = []
    for r in range(cfg.hash_l):
        p = jp.init(keys[r], dim, cfg.hash_k, 1, cfg.w)
        out.append((np.asarray(p.a), np.asarray(p.b)))
    return out


def _assert_clear_of_radius(km, radius):
    """No pairwise distance within 1e-3 of the radius (checked over all
    pairs, so over every bucket)."""
    d = np.sqrt(embedding.DISTANCE_SQUARE[km[:, None, :], km[None]].sum(-1))
    assert not (np.abs(d - radius) < 1e-3).any()


def _kmers(rng, n, l=8):
    return rng.integers(0, 20, size=(n, l), dtype=np.int32)


def _corpus(name, rng):
    """Corpora of tests/test_cluster.py: duplicates, near-duplicates and
    an oversize bucket; (kmers, bucket_max, hash_l, seed)."""
    if name == "bucket_max_64":
        km = _kmers(rng, 400)
        km[100:200] = km[:100]
        km[200:320] = np.tile(km[5], (120, 1))   # oversize vs 64
        km[330:360] = km[:30]
        km[330:360, 0] = (km[330:360, 0] + 1) % 20
        return km, 64, 4, 7
    if name == "bucket_max_100":
        km = _kmers(rng, 300)
        km[150:300] = km[:150]                   # 150 size-2 buckets
        return km, 100, 3, 11
    km = np.tile(_kmers(rng, 1), (700, 1))       # one bucket of 700
    return km, 64, 2, 3


@pytest.mark.parametrize("name", ["bucket_max_64", "bucket_max_100",
                                  "oversize"])
def test_cluster_greedy_matches_jax(rng, name):
    km, bucket_max, hash_l, seed = _corpus(name, rng)
    cfg = jg.ClusterConfig(hash_k=8, hash_l=hash_l, w=50.0, radius=20.0,
                           bucket_max=bucket_max, bucket_chunk=8)
    _assert_clear_of_radius(km, cfg.radius)
    key = jax.random.key(seed)
    want = jg.cluster_greedy(km, key, cfg)
    rp = _round_params(key, cfg, km.shape[1] * embedding.AA_DIM)
    got = tg.cluster_greedy(km, None, tg.ClusterConfig(**vars(cfg)),
                            round_params=rp, device="cpu")
    np.testing.assert_array_equal(got.parent, want.parent)
    np.testing.assert_array_equal(got.merged, want.merged)
    clusters = got.clusters()
    assert [c.tolist() for c in clusters] == \
        [c.tolist() for c in want.clusters()]
    np.testing.assert_array_equal(np.sort(np.concatenate(clusters)),
                                  np.arange(len(km)))
    if name == "oversize":
        assert len(clusters) <= -(-700 // 64) + 1


def test_cluster_greedy_generator_invariants(rng):
    """Drawn from a torch.Generator: every point once, members within R
    of their head, planted duplicates co-clustered."""
    km = _kmers(rng, 200)
    km[100:150] = km[:50]
    cfg = tg.ClusterConfig(hash_k=8, hash_l=8, w=50.0, radius=15.0,
                           bucket_max=128)
    res = tg.cluster_greedy(km, torch.Generator().manual_seed(1), cfg,
                            device="cpu")
    again = tg.cluster_greedy(km, torch.Generator().manual_seed(1), cfg,
                              device="cpu")
    np.testing.assert_array_equal(res.parent, again.parent)
    clusters = res.clusters()
    np.testing.assert_array_equal(np.sort(np.concatenate(clusters)),
                                  np.arange(200))
    label = np.empty(200, np.int64)
    for cid, c in enumerate(clusters):
        label[c] = cid
        d = np.sqrt(embedding.DISTANCE_SQUARE[km[c[0]], km[c[1:]]].sum(-1))
        assert (d <= cfg.radius + 1e-3).all()
    assert all(label[i] == label[100 + i] for i in range(50))


@pytest.mark.parametrize("bucket_max", [256, 100])
def test_bucket_class_matrices_match_jax(rng, bucket_max):
    """The engineered multiset of tests/test_cluster.py (singleton, pairs,
    mid sizes, oversize buckets chunked into full rows plus a remainder,
    a dropped size-1 remainder), shuffled codes with id gaps: the same
    class layouts, element for element."""
    sizes = [1, 2, 2, 3, 5, 17, 64, 65, 600, 257]
    codes = np.concatenate([np.full(s, 1000 + 7 * i, np.int32)
                            for i, s in enumerate(sizes)])
    rng.shuffle(codes)
    ids = np.sort(rng.choice(5000, len(codes), replace=False))
    got = tg._bucket_class_matrices(torch.as_tensor(codes),
                                    torch.as_tensor(ids), bucket_max, 5000)
    want = jg._bucket_class_matrices(codes, ids, bucket_max, 5000)
    assert len(got) == len(want) == 4
    for (gi, gv), (wi, wv) in zip(got, want):
        np.testing.assert_array_equal(gi.numpy(), wi)
        np.testing.assert_array_equal(gv.numpy(), wv)
    assert tg._class_sizes(100) == jg._class_sizes(100) == (4, 16, 64, 100)
    empty = torch.zeros(0, dtype=torch.int32)
    assert tg._bucket_class_matrices(empty, empty.long(), 64, 9) == []
    assert tg._bucket_class_matrices(torch.tensor([3, 4], dtype=torch.int32),
                                     torch.tensor([0, 1]), 64, 9) == []


def _canon(lab):
    first: dict = {}
    return np.array([first.setdefault(int(v), len(first)) for v in lab])


@pytest.mark.parametrize("seed", [5, 9])
def test_centroid_rounds_partition_matches_jax(rng, seed):
    n, l, rounds, k, w, radius = 64, 6, 5, 8, 50.0, 30.0
    km = rng.integers(0, 20, (n, l), dtype=np.int32)
    km[40:] = km[:24]
    ka, kb = jax.random.split(jax.random.PRNGKey(seed))
    a_all = np.asarray(jax.random.normal(ka, (rounds, l * 8, k),
                                         jnp.float32))
    b_all = np.asarray(jax.random.uniform(kb, (rounds, k), jnp.float32,
                                          0.0, w))
    want = np.asarray(jc._cluster_rounds(
        jnp.asarray(km), jnp.asarray(a_all), jnp.asarray(b_all),
        jnp.float32(w), jnp.float32(radius / 2), rounds, chunk=16))
    got = tc._cluster_rounds(torch.as_tensor(km), torch.tensor(a_all),
                             torch.tensor(b_all), w, radius / 2, rounds,
                             chunk=16).numpy()
    np.testing.assert_array_equal(_canon(got), _canon(want))
    assert len(set(got.tolist())) < n
    # cluster_centroid with the same injected draws: the same groups
    cfg = tc.CentroidConfig(hash_k=k, hash_l=rounds, w=w, radius=radius)
    groups = tc.cluster_centroid(km, None, cfg, a_all=a_all, b_all=b_all,
                                 device="cpu")
    assert sorted(g.tolist() for g in groups) == sorted(
        np.nonzero(want == v)[0].tolist() for v in np.unique(want))


def test_cluster_centroid_generator_runs(rng):
    km = rng.integers(0, 20, (60, 6), dtype=np.int32)
    km[30:] = km[:30]
    cfg = tc.CentroidConfig(hash_k=8, hash_l=4, w=50.0, radius=30.0)
    members = tc.cluster_centroid(km, torch.Generator().manual_seed(2), cfg,
                                  device="cpu")
    np.testing.assert_array_equal(np.sort(np.concatenate(members)),
                                  np.arange(60))
    assert len(members) < 60
    assert [m[0] for m in members] == sorted(m[0] for m in members)


def _merge_corpus(rng, n_heads=60):
    """Center-labeled rows: families of one substitution apart, so some
    heads lie within the merge radius of each other."""
    base = rng.integers(0, 20, (n_heads // 3, 12), dtype=np.int32)
    heads = np.repeat(base, 3, axis=0)
    pos = rng.integers(0, 12, len(heads))
    heads[np.arange(len(heads)), pos] = rng.integers(0, 20, len(heads))
    km = np.repeat(heads, 3, axis=0)
    labels = np.repeat(np.arange(0, len(km), 3), 3)
    perm = rng.permutation(len(km))
    inv = np.argsort(perm)
    return km[perm], inv[labels[perm]]


@pytest.mark.parametrize("quantile", [0.01, 0.03])
def test_merge_by_center_distance_matches_jax(rng, quantile):
    """Heads fit in fewer than k_blocks blocks, so the radius search is
    lossless whatever the draw and the labels equal the JAX package's.
    The radius sits at a low quantile of the head distances (within-
    family pairs are about 3% of them), clear of every distance by 1e-3."""
    km, labels = _merge_corpus(rng)
    heads = np.unique(labels)
    assert len(heads) < 128 * 32
    d = np.sqrt(embedding.DISTANCE_SQUARE[km[heads][:, None], km[heads]]
                .sum(-1))
    v = np.unique(d[d > 0])
    i = max(1, int(quantile * len(v)))
    r = float((v[i] + v[i - 1]) / 2)
    assert not (np.abs(d - r) < 1e-3).any()
    want = jpp.merge_by_center_distance(km, labels, r, jax.random.key(0))
    got = tpp.merge_by_center_distance(km, labels, r,
                                       torch.Generator().manual_seed(0),
                                       device="cpu")
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) < len(heads)


def test_merge_single_cluster(rng):
    km = rng.integers(0, 20, (6, 8), dtype=np.int32)
    labels = np.zeros(6, np.int64)
    out = tpp.merge_by_center_distance(km, labels, 10.0,
                                       torch.Generator(), device="cpu")
    np.testing.assert_array_equal(out, labels)


def test_connected_components_partition(rng):
    n = 300
    src = rng.integers(0, n, 200)
    dst = rng.integers(0, n, 200)
    src = np.concatenate([src, np.full(300, 7)])   # many duplicate edges
    dst = np.concatenate([dst, np.full(300, 8)])
    got = tuf.connected_components(n, src, dst)
    want = juf.connected_components(n, src, dst, use_native=False)
    np.testing.assert_array_equal(_canon(got), _canon(want))
    assert got[7] == got[8]
    uf = tuf.UnionFind(6)
    uf.union_edges([0, 1, 3], [1, 2, 4])
    np.testing.assert_array_equal(uf.components(), [0, 0, 0, 3, 3, 5])
    assert sorted(len(g) for g in uf.groups()) == [1, 2, 3]


def test_host_helpers_match_jax(tmp_path, rng):
    km = rng.integers(0, 22, (50, 9)).astype(np.int64)   # incl. INVALID
    np.testing.assert_array_equal(talpha.decode_all(km),
                                  jalpha.decode_all(km))
    seq = rng.integers(0, 20, 40).astype(np.uint8)
    np.testing.assert_array_equal(talpha.kmer_view(seq, 7),
                                  jalpha.kmer_view(seq, 7))
    strs = list(talpha.decode_all(km[:, :8] % 20))
    clusters = [strs[:5], strs[5:6], strs[6:20]]
    for style in ("hclust2", "hclust"):
        a, b = tmp_path / f"t_{style}.txt", tmp_path / f"j_{style}.txt"
        tio.write_clusters(str(a), clusters, style=style)
        jio.write_clusters(str(b), clusters, style=style)
        assert a.read_text() == b.read_text()
        assert tio.read_clusters(str(a)) == jio.read_clusters(str(b)) \
            == clusters
    named = [(f"cluster{i}", c) for i, c in enumerate(clusters)]
    cen = tpp.cluster_centers(clusters)
    np.testing.assert_array_equal(cen, jpp.cluster_centers(clusters))
    for mod, tag in ((tpp, "t"), (jpp, "j")):
        mod.write_meme(str(tmp_path / f"{tag}.meme"), named, max_members=3,
                       include_members=True)
        mod.write_centers_as_datapoints(str(tmp_path / f"{tag}.pts"),
                                        [n for n, _ in named], cen)
    for ext in ("meme", "pts"):
        assert (tmp_path / f"t.{ext}").read_text() == \
            (tmp_path / f"j.{ext}").read_text()
    pts = rng.normal(0, 5, (7, cen.shape[1])).astype(np.float32)
    ti, tr = tpp.center_distance_samples(cen, pts, device="cpu")
    ji, jr = jpp.center_distance_samples(cen, pts)
    np.testing.assert_allclose(ti, ji, rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(tr, jr, rtol=1e-5, atol=1e-3)
    got = tpp.shuffle_motifs(named, np.random.default_rng(4), 2, 3)
    assert got == jpp.shuffle_motifs(named, np.random.default_rng(4), 2, 3)
