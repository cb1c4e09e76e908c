"""The block_bounds kernel's plain version and wrapper on the CPU.

The wrapper's CPU path is its plain version bitwise; the plain version
agrees with the JAX package's jitted ``_recompute_bounds`` within float32
tolerance (rtol 1e-6, atol 1e-5: JAX averages an explicit (bs, 8L)
embedding, the port sums residue counts times the coordinate table), and
with a float64 evaluation of the definition under
kernel_checks.bounds_agreement (the rule the kernel is held to on the
card); padding blocks get radius -inf and centroid 0, rows with
order >= n count in neither the mean nor the max, and the chunk size
changes nothing.  The build and every segment upload reach the bounds
through one wrapper call each.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hsearch_tpu.search import stream as jstream
from hsearch_tpu_torch.core import embedding
from hsearch_tpu_torch.ops import cuda_kernels as ck
from hsearch_tpu_torch.ops import distance
from hsearch_tpu_torch.ops import kernel_checks as kc
from hsearch_tpu_torch.search import ivf, stream

COORDS = distance.const("coords", torch.device("cpu"))


def _blocks(rng, b=300, bs=32, l=25, n=10_000):
    """(rows (b, bs*l) int8, order (b, bs) int32, n): family rows, a third
    of the rows invalid (order == n), every fifth block all padding with
    zero rows, and one block with a single valid row."""
    fam = rng.integers(0, 20, (20, bs * l))
    rows = np.where(rng.random((b, bs * l)) < 0.1,
                    rng.integers(0, 20, (b, bs * l)),
                    fam[rng.integers(0, 20, b)]).astype(np.int8)
    order = rng.integers(0, n, (b, bs)).astype(np.int32)
    order[rng.random((b, bs)) < 0.33] = n
    order[::5] = n
    rows[::5] = 0
    order[1] = n
    order[1, bs // 2] = 3
    return rows, order, n


def _t(x):
    return torch.as_tensor(x)


@pytest.mark.parametrize("bs,l", [(32, 25), (8, 10), (1, 25)])
def test_wrapper_cpu_path_is_the_plain_version(bs, l):
    rows, order, n = _blocks(np.random.default_rng(bs), bs=bs, l=l)
    ck.reset_launches()
    got = ck.block_bounds(_t(rows), _t(order), n, COORDS)
    want = ck.block_bounds_plain(_t(rows), _t(order), n, COORDS)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert got[0].shape == (len(rows), 8 * l) and got[0].dtype == \
        torch.float32
    assert ck.launch_counts()["block_bounds"] == 0
    pad = (order >= n).all(axis=1)
    assert pad.sum() >= 60
    assert torch.isneginf(got[1][pad]).all() and (got[0][pad] == 0).all()
    assert torch.isfinite(got[1][~pad]).all()
    if bs > 1:
        assert float(got[1][1]) == 0.0      # one valid row: radius 0


@pytest.mark.parametrize("bs,l", [(32, 25), (8, 10)])
def test_plain_matches_jax_recompute_bounds(bs, l):
    rows, order, n = _blocks(np.random.default_rng(10 + bs), bs=bs, l=l)
    cent, rad = ck.block_bounds_plain(_t(rows), _t(order), n, COORDS)
    jc, jr = (np.asarray(x) for x in jstream._recompute_bounds(
        jnp.asarray(rows), jnp.asarray(order), n, l, bchunk=64))
    pad = np.isneginf(jr)
    np.testing.assert_array_equal(np.isneginf(rad.numpy()), pad)
    assert np.all(cent.numpy()[pad] == 0) and np.all(jc[pad] == 0)
    np.testing.assert_allclose(cent.numpy()[~pad], jc[~pad], rtol=1e-6,
                               atol=1e-5)
    np.testing.assert_allclose(rad.numpy()[~pad], jr[~pad], rtol=1e-6,
                               atol=1e-5)


def _float64_bounds(rows, order, n, l):
    """The definition in float64: the mean embedding of the valid rows and
    the largest distance of one to it."""
    emb = embedding.COORDINATES.astype(np.float64)[rows.astype(np.int64)]
    emb = emb.reshape(len(rows), order.shape[1], 8 * l)
    valid = order < n
    cnt = np.maximum(valid.sum(axis=1), 1)[:, None]
    cent = (emb * valid[..., None]).sum(axis=1) / cnt
    d2 = ((emb - cent[:, None]) ** 2).sum(axis=-1)
    rad = np.sqrt(np.where(valid, d2, 0).max(axis=1))
    real = valid.any(axis=1)
    return (torch.as_tensor(np.where(real[:, None], cent, 0),
                            dtype=torch.float32),
            torch.as_tensor(np.where(real, rad, -np.inf),
                            dtype=torch.float32))


def test_plain_within_the_kernel_tolerance_of_the_definition():
    rows, order, n = _blocks(np.random.default_rng(4))
    res = kc.bounds_agreement(
        ck.block_bounds_plain(_t(rows), _t(order), n, COORDS),
        _float64_bounds(rows, order, n, 25), COORDS)
    assert res["ok"], res
    assert res["padding_blocks"] == 60 and res["max_rad_rel_err"] < 1e-6


@pytest.mark.parametrize("bchunk", [1, 7, 64, 300, 4096])
def test_chunk_size_changes_nothing(bchunk):
    rows, order, n = _blocks(np.random.default_rng(5))
    want = ck.block_bounds_plain(_t(rows), _t(order), n, COORDS, bchunk=300)
    got = ck.block_bounds(_t(rows), _t(order), n, COORDS, bchunk=bchunk)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_build_and_uploads_bound_through_one_call_each(monkeypatch):
    """build_index bounds its blocks with one block_bounds call, each
    segment upload with one more, and an uploaded segment's bounds are
    bitwise the built index's."""
    calls = []
    real = ck.block_bounds
    monkeypatch.setattr(ck, "block_bounds",
                        lambda *a, **k: calls.append(a[0].shape[0])
                        or real(*a, **k))
    rng = np.random.default_rng(6)
    fam = rng.integers(0, 20, (64, 25))
    db = np.where(rng.random((4096, 25)) < 0.1,
                  rng.integers(0, 20, (4096, 25)),
                  fam[rng.integers(0, 64, 4096)]).astype(np.int32)
    idx = ivf.build_index(db, torch.Generator().manual_seed(0),
                          device="cpu")
    assert calls == [idx.num_blocks]
    up = stream.upload_segment(stream._to_host_segment(idx, 0, False),
                               "cpu")
    assert calls == [idx.num_blocks] * 2
    assert torch.equal(up.block_centroid, idx.block_centroid)
    assert torch.equal(up.block_radius, idx.block_radius)
    sidx = stream.build_segmented(db, torch.Generator().manual_seed(1),
                                  segment_points=1024, device="cpu")
    del calls[:]
    stream.search_segmented(sidx, fam[:8].astype(np.int32), 35.0,
                            k_blocks=8, max_hits=256,
                            retry_overflow=False)
    assert calls == [s.db_sorted.shape[0] for s in sidx.segments]
