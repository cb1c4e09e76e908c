"""hsearch_tpu_torch.search.stream against hsearch_tpu.search.stream, on the
CPU (the kernels' plain versions).

Each segment's seed comes from the caller's torch.Generator, so the port's
segments differ from the JAX package's for the same seed: parity goes
through the shared ``segivf`` checkpoint, which either package writes and
the other searches.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hsearch_tpu.search import exact as jexact
from hsearch_tpu.search import stream as jstream
from hsearch_tpu.utils import checkpoint as jckpt
from hsearch_tpu_torch.core import embedding
from hsearch_tpu_torch.ops import cuda_kernels as ck
from hsearch_tpu_torch.search import exact, stream
from hsearch_tpu_torch.utils import checkpoint

N, SEG, BS, L, R = 8192, 2048, 16, 25, 35.0


def _family_db(rng, n, c, l, family_size=32):
    """Families of near-duplicate rows (Poisson(2) substitutions each)
    and c family centers."""
    nfam = max(1, n // family_size)
    fam = rng.integers(0, 20, (nfam, l), dtype=np.int32)
    db = fam[rng.integers(0, nfam, n)].copy()
    flips = np.argsort(rng.random((n, l)), axis=1) \
        < rng.poisson(2.0, n)[:, None]
    db[flips] = rng.integers(0, 20, int(flips.sum()))
    return db, fam[rng.choice(nfam, c, replace=False)]


def _pairs(res):
    return set(zip(res[0].tolist(), res[1].tolist()))


@pytest.fixture(scope="module")
def jax_seg(tmp_path_factory):
    """One segmented index built by the JAX package (4 segments of 2048,
    block size 16), saved to its segivf checkpoint."""
    rng = np.random.default_rng(7)
    db, centers = _family_db(rng, N, 16, L)
    sidx = jstream.build_segmented(db, jax.random.PRNGKey(0),
                                   segment_points=SEG, block_size=BS)
    path = str(tmp_path_factory.mktemp("seg") / "jax_seg.npz")
    jckpt.save_index(path, sidx)
    return db, centers, sidx, path


@pytest.fixture(scope="module")
def port_seg(jax_seg):
    """The same database built by the port on the CPU."""
    db, centers, _, _ = jax_seg
    return stream.build_segmented(db, torch.Generator().manual_seed(0),
                                  segment_points=SEG, block_size=BS,
                                  device="cpu")


def test_jax_checkpoint_lossless_equals_jax_and_oracle(jax_seg):
    db, centers, jsidx, path = jax_seg
    sidx = checkpoint.load_index(path, device="cpu")
    assert sidx.num_segments == 4 and sidx.resident_fraction() == 0.0
    for a, b in zip(sidx.segments, jsidx.segments):
        np.testing.assert_array_equal(a.db_sorted, b.db_sorted)
        np.testing.assert_array_equal(a.host_kmers, b.host_kmers)
        assert a.pinned is None
    got = stream.search_segmented(sidx, centers, R, k_blocks=8,
                                  max_hits=1024)
    want = jstream.search_segmented(jsidx, centers, R, k_blocks=8,
                                    max_hits=1024)
    oracle = jexact.search_radius(db, centers, R)
    assert _pairs(got) == _pairs(want) == _pairs(oracle)
    assert len(got[0]) > 100
    gt = {(a, b): v for a, b, v in zip(*oracle)}
    for a, b, v in zip(*got):
        np.testing.assert_allclose(v, gt[(a, b)], rtol=1e-5, atol=1e-4)


def test_jax_checkpoint_capped_kb_identical_hits(jax_seg):
    db, centers, jsidx, path = jax_seg
    sidx = checkpoint.load_index(path, device="cpu")
    kb = 4
    # tie precondition, per segment and center: the kb-th and (kb+1)-th
    # live keys differ, so the selected blocks do not depend on tie order
    capped = 0
    for seg in sidx.segments:
        up = stream.upload_segment(seg, "cpu")
        key = np.sort(ck.sq_distance_prune(
            torch.as_tensor(embedding.embed_kmers(centers)),
            up.block_centroid, up.block_radius, R)[0][:, :up.num_blocks]
            .numpy(), axis=1)
        kth, nxt = key[:, kb - 1], key[:, kb]
        assert np.all(~np.isfinite(kth) | (kth < nxt * (1 - 1e-5)))
        capped += int(np.isfinite(nxt).sum())
    assert capped > 0                               # kb really caps
    st, jst = {}, {}
    got = stream.search_segmented(sidx, centers, R, k_blocks=kb,
                                  max_hits=512, retry_overflow=False,
                                  stats_out=st)
    want = jstream.search_segmented(jsidx, centers, R, k_blocks=kb,
                                    max_hits=512, retry_overflow=False,
                                    stats_out=jst)
    assert st["over_blocks"] == jst["over_blocks"] > 0
    assert st["max_alive"] == jst["max_alive"]
    assert _pairs(got) == _pairs(want)
    assert len(got[0]) > 50
    # the same keys as JAX's search statistics
    assert set(st) == set(jst)


def test_port_checkpoint_loads_in_jax(jax_seg, port_seg, tmp_path):
    db, centers, _, _ = jax_seg
    path = str(tmp_path / "port_seg.npz")
    checkpoint.save_index(path, port_seg)
    jsidx = jckpt.load_index(path)
    assert [s.n_points for s in jsidx.segments] == [SEG] * 4
    for a, b in zip(port_seg.segments, jsidx.segments):
        np.testing.assert_array_equal(a.order, b.order)
        np.testing.assert_array_equal(a.host_kmers, b.host_kmers)
    got = stream.search_segmented(port_seg, centers, R, k_blocks=8,
                                  max_hits=1024)
    want = jstream.search_segmented(jsidx, centers, R, k_blocks=8,
                                    max_hits=1024)
    oracle = exact.search_radius(db, centers, R, device="cpu")
    assert _pairs(got) == _pairs(want) == _pairs(oracle)
    back = checkpoint.load_index(path, device="cpu")
    back_hits = stream.search_segmented(back, centers, R, k_blocks=8,
                                        max_hits=1024)
    assert _pairs(back_hits) == _pairs(got)


def test_recompute_bounds_matches_jax(port_seg):
    seg = port_seg.segments[1]
    b, bsl = seg.db_sorted.shape
    # three all-sentinel padding blocks between the real ones
    db = np.concatenate([seg.db_sorted[:5], np.zeros((3, bsl), np.int8),
                         seg.db_sorted[5:]])
    order = np.concatenate([seg.order[:5],
                            np.full((3, BS), seg.n_points, np.int32),
                            seg.order[5:]])
    cent, rad = stream._recompute_bounds(torch.as_tensor(db),
                                         torch.as_tensor(order),
                                         seg.n_points, L, bchunk=64)
    jc, jr = jstream._recompute_bounds(jnp.asarray(db), jnp.asarray(order),
                                       seg.n_points, L, bchunk=64)
    jc, jr = np.asarray(jc), np.asarray(jr)
    pad = np.zeros(b + 3, bool)
    pad[5:8] = True
    assert np.all(rad.numpy()[pad] == -np.inf) and np.all(jr[pad] == -np.inf)
    assert np.all(cent.numpy()[pad] == 0) and np.all(jc[pad] == 0)
    np.testing.assert_allclose(cent.numpy()[~pad], jc[~pad], rtol=1e-6,
                               atol=1e-5)
    np.testing.assert_allclose(rad.numpy()[~pad], jr[~pad], rtol=1e-6,
                               atol=1e-5)


def test_upload_bounds_equal_the_build(port_seg, jax_seg):
    """A streamed segment's recomputed bounds are bitwise the built ones,
    so residency never changes a capped-kb result."""
    db, _, _, _ = jax_seg
    from hsearch_tpu_torch.search import ivf
    sub = ivf.build_index(db[:SEG], torch.Generator().manual_seed(5),
                          block_size=BS, device="cpu")
    up = stream.upload_segment(stream._to_host_segment(sub, 0, False),
                               "cpu")
    for f in ("db_sorted", "order", "block_centroid", "block_radius"):
        assert torch.equal(getattr(up, f), getattr(sub, f))


def test_iterator_input_segments_like_array(rng):
    n = 5000
    db, centers = _family_db(rng, n, 8, 10)
    a = stream.build_segmented(db, torch.Generator().manual_seed(1),
                               segment_points=SEG, block_size=BS,
                               device="cpu")
    b = stream.build_segmented((db[s:s + 700] for s in range(0, n, 700)),
                               torch.Generator().manual_seed(1),
                               segment_points=SEG, block_size=BS,
                               device="cpu")
    assert [s.n_points for s in a.segments] == \
        [s.n_points for s in b.segments] == [2048, 2048, 904]
    assert [s.offset for s in b.segments] == [0, 2048, 4096]
    for sa, sb in zip(a.segments, b.segments):
        np.testing.assert_array_equal(sa.db_sorted, sb.db_sorted)
        np.testing.assert_array_equal(sa.order, sb.order)
    ra = stream.search_segmented(a, centers, 30.0, k_blocks=64,
                                 max_hits=512)
    rb = stream.search_segmented(b, centers, 30.0, k_blocks=64,
                                 max_hits=512)
    oracle = exact.search_radius(db, centers, 30.0, device="cpu")
    assert _pairs(ra) == _pairs(rb) == _pairs(oracle)
    with pytest.raises(ValueError, match="empty"):
        stream.build_segmented(iter([]), torch.Generator(), device="cpu")


def test_device_budget_keeps_prefix_resident(rng):
    n = 4096
    db, centers = _family_db(rng, n, 8, 10)
    dry = stream.build_segmented(db, torch.Generator().manual_seed(0),
                                 segment_points=1024, block_size=BS,
                                 device="cpu")
    budget = sum(stream.segment_device_bytes(s) for s in dry.segments[:2])
    sidx = stream.build_segmented(db, torch.Generator().manual_seed(0),
                                  segment_points=1024, block_size=BS,
                                  device_budget_bytes=budget, device="cpu")
    assert [r is not None for r in sidx.resident] == [True, True, False,
                                                      False]
    assert sidx.resident_fraction() == 0.5
    st: dict = {}
    got = stream.search_segmented(sidx, centers, 30.0, k_blocks=64,
                                  max_hits=512, stats_out=st)
    assert st["segments"] == 4 and st["resident_fraction"] == 0.5
    assert len(st["seg_walls_s"]) == 4 and len(st["upload_dispatch_s"]) == 3
    assert _pairs(got) == _pairs(exact.search_radius(db, centers, 30.0,
                                                     device="cpu"))


def test_set_residency_after_load(port_seg, jax_seg, tmp_path):
    _, centers, _, _ = jax_seg
    path = str(tmp_path / "seg.npz")
    checkpoint.save_index(path, port_seg)
    budget = 3 * stream.segment_device_bytes(port_seg.segments[0])
    b = checkpoint.load_index(path, device_budget_bytes=budget,
                              device="cpu")
    # the CPU reports no free device memory, so the budget is not clamped
    assert sum(r is not None for r in b.resident) in (2, 3)
    assert b.resident[0] is not None and b.resident[3] is None
    kw = dict(k_blocks=4, max_hits=512, retry_overflow=False,
              stats_out={})
    want = stream.search_segmented(port_seg, centers, R, **kw)
    assert _pairs(stream.search_segmented(b, centers, R, **kw)) == \
        _pairs(want)
    stream.set_residency(b, 0)
    assert b.resident_fraction() == 0.0
    assert _pairs(stream.search_segmented(b, centers, R, **kw)) == \
        _pairs(want)


def test_segment_device_bytes_and_clamp(monkeypatch):
    """The card pads no lanes: rows + order map + f32 centroids + radii.
    The clamp keeps two streamed slots, the prune keys of the largest
    segment at center block 1024, and a fixed slack."""
    b, bs, l = 64, 16, 10
    seg = stream.HostSegment(
        offset=0, n_points=1024, kmer_len=l,
        db_sorted=np.zeros((b, bs * l), np.int8),
        order=np.zeros((b, bs), np.int32),
        host_kmers=np.zeros((1024, l), np.int8))
    assert stream.segment_device_bytes(seg) == \
        b * bs * l + b * bs * 4 + b * 8 * l * 4 + b * 4
    bp = 64                                     # B rounded up to 64 blocks
    assert stream.search_reserve_bytes(seg) == 4 * 1024 * (bp + bp // 64)
    free = 12 << 30
    monkeypatch.setattr(stream, "free_device_bytes", lambda device=None:
                        free)
    reserve = (2 * stream.segment_device_bytes(seg)
               + stream.search_reserve_bytes(seg) + (512 << 20))
    with pytest.warns(UserWarning, match="clamping"):
        assert stream.clamp_device_budget(1 << 62, [seg], "cuda") == \
            free - reserve
    assert stream.clamp_device_budget(1 << 20, [seg], "cuda") == 1 << 20
    assert stream.clamp_device_budget(0, [seg], "cuda") == 0
    monkeypatch.setattr(stream, "free_device_bytes", lambda device=None:
                        None)
    assert stream.clamp_device_budget(1 << 62, [seg], "cpu") == 1 << 62


def test_free_device_bytes_is_none_on_the_cpu():
    assert stream.free_device_bytes("cpu") is None
    assert stream.free_device_bytes(None) is None
