"""hsearch_tpu_torch/parallel/stream_sharded.py against the JAX package's
search_segmented_sharded and the exact oracle, on logical CPU shards.

Segment seeds come from the caller's generator, so the port's segments
differ from JAX's for one seed: the JAX segmented index crosses over
through its ``segivf`` checkpoint.  The JAX function has neither overflow
counts nor a retry; those cases are held against the port's own per-wave
``sharded.search_ivf`` and against the oracle."""

import dataclasses

import jax
import numpy as np
import pytest

from hsearch_tpu.parallel import mesh as jmesh
from hsearch_tpu.parallel import stream_sharded as jss
from hsearch_tpu.search import exact as jexact, stream as jstream
from hsearch_tpu.utils import checkpoint as jckpt
from hsearch_tpu_torch.parallel import mesh as mesh_lib, sharded
from hsearch_tpu_torch.parallel import stream_sharded
from hsearch_tpu_torch.search import stream
from hsearch_tpu_torch.utils import checkpoint

N, C, L, R, SEG, BS = 8192, 12, 10, 30.0, 1024, 16


def _mesh(n, data):
    return mesh_lib.make_mesh(n, data=data, devices=["cpu"] * n)


def _pairs(res):
    return set(zip(res[0].tolist(), res[1].tolist()))


def _same_d2(got, oracle):
    """Each hit's d^2 within 1e-5 relative of the oracle's."""
    want = {(a, b): d for a, b, d in zip(*oracle)}
    d2w = np.array([want[(a, b)] ** 2 for a, b in zip(got[0], got[1])],
                   np.float64)
    np.testing.assert_allclose(got[2].astype(np.float64) ** 2, d2w,
                               rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """tests/test_parallel.py's stream x sharded case: family rows with 5%
    zeroed residues, and JAX segmented indexes of all 8192 rows (8
    segments) and of the first 3000 (3 segments, a ragged tail), saved."""
    rng = np.random.default_rng(0)
    nfam = N // 32
    fam = rng.integers(0, 20, (nfam, L), dtype=np.int32)
    db = fam[rng.integers(0, nfam, N)].copy()
    db[rng.random((N, L)) < 0.05] = 0
    centers = fam[rng.choice(nfam, C, replace=False)]
    tmp = tmp_path_factory.mktemp("ss")
    out = {"db": db, "centers": centers}
    for name, n in (("full", N), ("tail", 3000)):
        jsidx = jstream.build_segmented(db[:n], jax.random.PRNGKey(4),
                                        segment_points=SEG, block_size=BS)
        path = str(tmp / f"{name}.npz")
        jckpt.save_index(path, jsidx)
        out[name] = (jsidx, path, jexact.search_radius(db[:n], centers, R))
    return out


@pytest.mark.parametrize("name,n_dev,data_axis,waves", [
    ("full", 8, 1, 1), ("tail", 4, 2, 2)])
def test_equals_jax_and_oracle(data, name, n_dev, data_axis, waves):
    jsidx, path, oracle = data[name]
    sidx = checkpoint.load_index(path, device="cpu")
    jst, st = {}, {}
    want = jss.search_segmented_sharded(
        jsidx, data["centers"], R, mesh=jmesh.make_mesh(n_dev,
                                                        data=data_axis),
        k_blocks=64, max_hits=512, stats_out=jst)
    got = stream_sharded.search_segmented_sharded(
        sidx, data["centers"], R, mesh=_mesh(n_dev, data_axis), k_blocks=64,
        max_hits=512, stats_out=st)
    assert _pairs(got) == _pairs(want) == _pairs(oracle)
    assert len(got[0]) > 100
    _same_d2(got, oracle)
    assert jst == {k: st[k] for k in jst}
    assert st["waves"] == waves and len(st["wave_upload_ms"]) == waves
    assert st["over_blocks"] == st["over_hits"] == 0
    # with the retry off, the JAX function's contract exactly
    got = stream_sharded.search_segmented_sharded(
        sidx, data["centers"], R, mesh=_mesh(n_dev, data_axis),
        k_blocks=256, max_hits=512, retry_overflow=False)
    assert _pairs(got) == _pairs(oracle)


def _per_wave_counts(sidx, centers, mesh, k_blocks, max_hits):
    """The overflow counts and hits of ``sharded.search_ivf`` over each wave
    assembled by hand, ids rebased by the wave's offset."""
    ndb, sp = mesh.shape["db"], sidx.segments[0].n_points
    total = {"over_blocks": 0, "over_hits": 0}
    hits = set()
    for w0 in range(0, sidx.num_segments, ndb):
        wave = sidx.segments[w0:w0 + ndb]
        shards = [stream.upload_segment(s, "cpu") for s in wave]
        shards += [None] * (ndb - len(wave))
        idx = sharded.ShardedIVFIndex(
            mesh=mesh, shards=[shards], n_real=[s.n_points for s in wave]
            + [0] * (ndb - len(wave)), n_local=sp,
            n_points=(len(wave) - 1) * sp + wave[-1].n_points,
            blocks_per_shard=max(s.num_blocks for s in shards if s),
            max_hits=max_hits)
        st: dict = {}
        ci, ki, _ = sharded.search_ivf(idx, centers, R, k_blocks=k_blocks,
                                       stats_out=st)
        for k in total:
            total[k] += st[k]
        hits |= set(zip(ci.tolist(), (ki + wave[0].offset).tolist()))
    return total, hits


def test_overflow_counted_then_retried(data):
    """max_hits 4 and a capped k_blocks: with the retry off the summed
    counts are the per-wave sharded searches' and the hits theirs; with it
    on the hits are the oracle's (the JAX function drops them silently)."""
    _, path, oracle = data["full"]
    sidx = checkpoint.load_index(path, device="cpu")
    mesh = _mesh(4, 1)
    st: dict = {}
    got = stream_sharded.search_segmented_sharded(
        sidx, data["centers"], R, mesh=mesh, k_blocks=8, max_hits=4,
        retry_overflow=False, stats_out=st)
    want, want_hits = _per_wave_counts(sidx, data["centers"], mesh, 8, 4)
    assert st["over_hits"] == want["over_hits"] > 0
    assert st["over_blocks"] == want["over_blocks"] > 0
    assert _pairs(got) == want_hits and st["retried"] == 0
    assert len(got[0]) < len(oracle[0])
    st = {}
    got = stream_sharded.search_segmented_sharded(
        sidx, data["centers"], R, mesh=mesh, k_blocks=8, max_hits=4,
        stats_out=st)
    assert _pairs(got) == _pairs(oracle)
    _same_d2(got, oracle)
    assert st["retried"] > 0 and st["over_hits"] == st["over_blocks"] == 0
    assert st["max_alive"] > 8


def test_resident_segments_reused(data, monkeypatch):
    _, path, oracle = data["full"]
    sidx = checkpoint.load_index(path, device="cpu")
    budget = sum(stream.segment_device_bytes(s) for s in sidx.segments[:3])
    stream.set_residency(sidx, budget)
    assert sum(r is not None for r in sidx.resident) == 3
    uploaded = []
    real = stream.upload_segment

    def counting(seg, *a, **kw):
        uploaded.append(seg.offset)
        return real(seg, *a, **kw)

    monkeypatch.setattr(stream, "upload_segment", counting)
    got = stream_sharded.search_segmented_sharded(
        sidx, data["centers"], R, mesh=_mesh(8, 1), k_blocks=64,
        max_hits=512)
    assert _pairs(got) == _pairs(oracle)
    assert uploaded == [s.offset for s in sidx.segments[3:]]


def _reordered(sidx):
    segs = sidx.segments
    return dataclasses.replace(sidx, segments=[segs[2], segs[0], segs[1]])


def _short_middle(sidx):
    segs = sidx.segments
    short = dataclasses.replace(segs[2], offset=segs[1].offset)
    return dataclasses.replace(sidx, segments=[segs[0], short, segs[1]])


@pytest.mark.parametrize("case", ["non_contiguous", "non_uniform",
                                  "spans_processes"])
def test_layout_and_mesh_checked(data, case):
    sidx = checkpoint.load_index(data["tail"][1], device="cpu")
    mesh = _mesh(2, 1)
    if case == "non_contiguous":
        sidx = _reordered(sidx)
    elif case == "non_uniform":
        sidx = _short_middle(sidx)
    else:
        mesh = dataclasses.replace(mesh, db_size=4)
    with pytest.raises(ValueError, match="segments must be contiguous"
                       if case != "spans_processes" else "spans processes"):
        stream_sharded.search_segmented_sharded(sidx, data["centers"], R,
                                                mesh=mesh)
