"""hsearch_tpu_torch.search.exact against hsearch_tpu.search.exact on the
same numpy inputs: equal hit sets on all three search_radius paths, and
the top-k oracles."""

import warnings

import numpy as np
import pytest

from hsearch_tpu.search import exact as jexact
from hsearch_tpu_torch.core import embedding
from hsearch_tpu_torch.search import exact


def _family_db(rng, n, c, l, family_size=16):
    nfam = max(1, n // family_size)
    fam = rng.integers(0, 20, (nfam, l), dtype=np.int32)
    db = fam[rng.integers(0, nfam, n)].copy()
    flips = rng.random((n, l)) < 0.1
    db[flips] = rng.integers(0, 20, int(flips.sum()))
    return db, fam[rng.choice(nfam, c, replace=False)]


# the dense path (no max_hits), the on-device compaction, and the streamed
# running-top-k path (db_chunk below N forces it)
PATHS = {"dense": {}, "block_compact": {"max_hits": 64},
         "streamed": {"max_hits": 64, "db_chunk": 128},
         "streamed_overflow": {"max_hits": 8, "db_chunk": 100}}


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("points", [False, True])
def test_search_radius_matches_jax(rng, path, points):
    db, centers = _family_db(rng, 600, 12, 10)
    if points:
        centers = embedding.embed_kmers(centers)
    kw = PATHS[path]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")         # max_hits truncation
        got = exact.search_radius(db, centers, 25.0, center_block=5,
                                  device="cpu", **kw)
        want = jexact.search_radius(db, centers, 25.0, center_block=5, **kw)
    assert len(want[0]) > 30
    assert got[0].dtype == np.int64 and got[2].dtype == np.float32
    # squared distances: the one-hot form adds the same table entries in
    # another order; the point form loses digits to float32 cancellation
    tol = dict(rtol=1e-5, atol=1e-3) if points else \
        dict(rtol=1e-6, atol=1e-4)
    if path == "streamed_overflow":
        # max_hits truncates: the nearest 8 per center are kept, and which
        # of several equally near k-mers is kept may differ
        for c in range(len(centers)):
            np.testing.assert_allclose(np.sort(got[2][got[0] == c]) ** 2,
                                       np.sort(want[2][want[0] == c]) ** 2,
                                       **tol)
        return
    assert set(zip(got[0].tolist(), got[1].tolist())) == \
        set(zip(want[0].tolist(), want[1].tolist()))
    wd = {(a, b): d for a, b, d in zip(*want)}
    for a, b, d in zip(*got):
        np.testing.assert_allclose(d ** 2, wd[(a, b)] ** 2, **tol)
    if path == "dense":
        # sorted by (center, kmer) like the JAX oracle
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_search_topk_matches_jax(rng):
    db, centers = _family_db(rng, 300, 9, 10)
    d, i = exact.search_topk(db, centers, 7, center_block=4, device="cpu")
    jd_, ji = jexact.search_topk(db, centers, 7, center_block=4)
    np.testing.assert_allclose(d, jd_, rtol=1e-5, atol=1e-4)
    # ids may differ only among equal distances: check each id's distance
    true = np.sqrt(embedding.kmer_sq_distance(centers[:, None, :], db[i]))
    np.testing.assert_allclose(d, true, rtol=1e-5, atol=1e-4)
    s, si = exact.search_topk_blosum(db, centers, 7, center_block=4,
                                     device="cpu")
    js, _ = jexact.search_topk_blosum(db, centers, 7, center_block=4)
    np.testing.assert_array_equal(s, js)
