"""The CUDA kernels' plain versions against hsearch_tpu's Pallas kernels in
interpret mode and the reference's own code around them, at
tests/test_pallas.py's shapes and tolerances; the CPU dispatch of the
wrappers; and, on a machine with a CUDA device, each kernel against its
plain version at ragged shapes (verify also at block size 1, as the LSH
search calls it), the LSH search on the card against the CPU, the
segmented engine's pinned, side-stream uploads, pcluster (the device
probe, both extension forms and the banded scorer) against the CPU, and
the IVF engine's approximate block select.

The CUDA cases need neither jax nor tests/conftest.py, so they also run on
a GPU host without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels.py
"""

import re
import subprocess

import numpy as np
import pytest
import torch

from hsearch_tpu_torch.ops import cuda_kernels as ck
from hsearch_tpu_torch.ops import distance as td
from hsearch_tpu_torch.ops import kernel_checks as kc

G = ck.PRUNE_GROUP


def _prune_inputs(rng, c=200, b=300, d=80):
    q = rng.normal(0, 10, (c, d)).astype(np.float32)
    cent = rng.normal(0, 10, (b, d)).astype(np.float32)
    rad = np.abs(rng.normal(0, 5, b)).astype(np.float32)
    return q, cent, rad


def _jax_stage1(key, b):
    """hsearch_tpu/search/ivf.py's cascade stage 1 and n_alive lines on a
    (C, B) key matrix: inf-pad to whole groups, per-group minimum."""
    import jax.numpy as jnp
    key = jnp.asarray(key)[:, :b]
    n_alive = jnp.sum(jnp.isfinite(key), axis=1).astype(jnp.int32)
    kp = jnp.pad(key, ((0, 0), (0, (-b) % G)), constant_values=jnp.inf)
    gmin = jnp.min(kp.reshape(key.shape[0], -1, G), axis=2)
    return np.asarray(gmin), np.asarray(n_alive)


@pytest.mark.parametrize("r", [30.0, 121.5])   # 121.5: ~half the keys live
def test_prune_plain_matches_pallas(rng, r):
    pk = pytest.importorskip("hsearch_tpu.ops.pallas_kernels")
    q, c, rad = _prune_inputs(rng)
    b = c.shape[0]
    want = np.asarray(pk.sq_distance_prune(q, c, rad, r, interpret=True))
    key, gmin, n_alive = (x.numpy() for x in ck.sq_distance_prune_plain(
        torch.as_tensor(q), torch.as_tensor(c), torch.as_tensor(rad), r))
    assert key.shape == (200, 320) and gmin.shape == (200, 5)
    np.testing.assert_allclose(key[:, :b], want, rtol=1e-4, atol=1e-3)
    assert np.all(key[:, b:] == np.inf)
    # the reference's stage 1 on the same keys: exact
    jg, jn = _jax_stage1(key, b)
    np.testing.assert_array_equal(gmin, jg)
    np.testing.assert_array_equal(n_alive, jn)
    # and on the reference's own keys: the same alive set, minima within
    # the key tolerance
    wg, wn = _jax_stage1(want, b)
    np.testing.assert_array_equal(n_alive, wn)
    np.testing.assert_allclose(gmin, wg, rtol=1e-4, atol=1e-3)
    if r > 100:
        assert 0.2 < np.isfinite(want).mean() < 0.8


@pytest.mark.parametrize("c,b", [(1, 64), (7, 63), (5, 129), (3, 1)])
def test_prune_plain_groups_and_count(c, b):
    """Padding, group minima and alive counts at group-edge shapes, against
    the reference's stage-1 lines on the same keys (exact)."""
    rng = np.random.default_rng(c * 1000 + b)
    q, cent, rad = _prune_inputs(rng, c, b, 16)
    dist = np.sqrt(((q[:, None, :].astype(np.float64) - cent[None]) ** 2)
                   .sum(-1))
    r = float(np.median(dist) - 2.5)
    key, gmin, n_alive = ck.sq_distance_prune_plain(
        torch.as_tensor(q), torch.as_tensor(cent), torch.as_tensor(rad), r)
    bp = -(-b // G) * G
    assert key.shape == (c, bp) and gmin.shape == (c, bp // G)
    assert n_alive.dtype == torch.int32
    jg, jn = _jax_stage1(key.numpy(), b)
    np.testing.assert_array_equal(gmin.numpy(), jg)
    np.testing.assert_array_equal(n_alive.numpy(), jn)
    assert torch.all(key[:, b:] == float("inf"))


def _jax_verify(ptab, db_sorted, order, blk_ids, neg, r, n):
    """hsearch_tpu/search/ivf.py's _search_block from the gather to n_hits,
    with the Pallas ptable_verify in interpret mode."""
    import jax.numpy as jnp
    pk = pytest.importorskip("hsearch_tpu.ops.pallas_kernels")
    c, kb = blk_ids.shape
    bs, l = order.shape[1], ptab.shape[1]
    r = jnp.float32(r)
    blk_alive = jnp.isfinite(jnp.asarray(neg))
    safe_ids = jnp.where(blk_alive, jnp.asarray(blk_ids, jnp.int32), 0)
    cand = jnp.take(jnp.asarray(db_sorted), safe_ids, axis=0)
    cand = cand.reshape(-1, kb * bs, l)
    gids = jnp.take(jnp.asarray(order), safe_ids, axis=0).reshape(-1,
                                                                  kb * bs)
    gids = jnp.where(jnp.repeat(blk_alive, bs, axis=1), gids, n)
    d2 = pk.ptable_verify(jnp.asarray(ptab), cand, interpret=True)
    hits = (gids < n) & (d2 <= r * r)
    n_hits = jnp.sum(hits, axis=1).astype(jnp.int32)
    d2m = jnp.where(hits, d2, jnp.inf)
    return np.asarray(d2m), np.asarray(n_hits), np.asarray(d2)


def _radius_between(d2, want_frac=0.5):
    """A radius whose square sits midway between two neighbouring d2
    values, so summation-order noise cannot flip a hit."""
    v = np.unique(d2.ravel())
    i = int(len(v) * want_frac)
    return float(np.sqrt((v[i] + v[i + 1]) / 2))


def _check_verify_vs_jax(rng, c, kb, bs, l):
    ptab, db_sorted, order, blk_ids, neg, _, n = kc.verify_inputs(
        rng, c, kb, bs, l)
    _, _, d2_all = _jax_verify(ptab, db_sorted, order, blk_ids, neg, 1.0, n)
    r = _radius_between(d2_all)
    want_d2m, want_hits, _ = _jax_verify(ptab, db_sorted, order, blk_ids,
                                         neg, r, n)
    r2 = float(np.float32(r) * np.float32(r))
    d2m, n_hits = ck.ptable_verify_plain(
        *(torch.as_tensor(x) for x in (ptab, db_sorted, order, blk_ids,
                                       neg)), r2, n)
    assert d2m.shape == (c, kb * bs) and n_hits.dtype == torch.int32
    np.testing.assert_allclose(d2m.numpy(), want_d2m, rtol=2e-6, atol=1e-4)
    np.testing.assert_array_equal(n_hits.numpy(), want_hits)
    assert 0 < want_hits.sum() < np.isfinite(d2_all).sum()
    # the verified distances are bitwise the plain P-table sums
    alive = np.isfinite(neg)
    safe = np.where(alive, blk_ids, 0)
    cand = torch.as_tensor(db_sorted[safe].reshape(c, kb * bs, l))
    d2 = td.ptable_distances(torch.as_tensor(ptab), cand).numpy()
    hit = np.isfinite(d2m.numpy())
    np.testing.assert_array_equal(d2m.numpy()[hit], d2[hit])


def test_ptable_verify_plain_matches_pallas(rng):
    _check_verify_vs_jax(rng, 6, 40, 8, 25)


@pytest.mark.parametrize("c,kb,bs,l", [(3, 37, 8, 25), (4, 21, 32, 25),
                                       (5, 9, 16, 10)])
def test_ptable_verify_plain_matches_reference(c, kb, bs, l):
    _check_verify_vs_jax(np.random.default_rng(kb), c, kb, bs, l)


# the grid holds 65,535 block tiles of 128 columns: B below, at and above
# that (8,388,480 blocks), and B = 0 (one grid, to zero n_alive)
@pytest.mark.parametrize("b", [0, 1, 200, 128 * 65535 - 200, 128 * 65535,
                               128 * 65535 + 1, 8_388_608,
                               2 * 128 * 65535 + 129])
def test_prune_launch_ranges_cover_every_column_once(b):
    ranges = ck.prune_launch_ranges(b)
    bp = -(-b // G) * G
    tiles = -(-bp // ck.PRUNE_TILE)
    assert ranges[0][0] == 0
    assert len(ranges) == max(1, -(-tiles // ck.MAX_GRID_Y))
    cover = np.zeros(max(tiles, 1), np.int64)
    for t0, n in ranges:
        assert 0 <= n <= ck.MAX_GRID_Y
        cover[t0:t0 + n] += 1
    # every key column 0..Bp-1 lies in exactly one launched tile
    cols = np.zeros(tiles * ck.PRUNE_TILE, np.int64)
    for t0, n in ranges:
        cols[t0 * ck.PRUNE_TILE:(t0 + n) * ck.PRUNE_TILE] += 1
    assert (cols[:bp] == 1).all()
    assert (cover == 1).all() or tiles == 0


_GEOMETRY_B = (1, 2, 7, 31, 1000, 8192, 96_846, 100_003, 1 << 22)


def _check_bounds_layout(geo, bs, l):
    """The shared-memory regions of a bounds geometry: each 16-byte
    aligned, each the size its contents take, in order and inside the
    total (the conditions the kernel's C entry tests)."""
    tile, threads, lay = geo["tile"], geo["threads"], geo
    cols = tile * l
    assert lay == {**lay, **ck.bounds_layout(tile, bs, l, lay["stages"],
                                             threads)}
    for k in ("vmask", "rsum", "tab", "cnt", "stage0", "rows_cap",
              "stage_bytes"):
        assert lay[k] % 16 == 0, k
    assert lay["vmask"] >= 4 * 20 * 8
    assert lay["rsum"] >= lay["vmask"] + 4 * tile * (-(-bs // 32))
    assert lay["tab"] >= lay["rsum"] + 4 * threads
    assert lay["ncp"] % 32 == 0
    if cols <= threads:             # the table reuses the counts' bytes
        assert lay["cnt"] == lay["tab"] and lay["ncp"] >= cols
        assert lay["stage0"] >= lay["tab"] + 4 * max(20 * lay["ncp"],
                                                     21 * cols)
    else:                           # columns in rounds: counts of their own
        assert tile == 1 and lay["ncp"] >= threads
        assert lay["cnt"] >= lay["tab"] + 4 * 21 * cols
        assert lay["stage0"] >= lay["cnt"] + 4 * 20 * lay["ncp"]
    assert lay["stages"] in (1, 2)
    assert lay["rows_cap"] >= tile * bs * l + 30
    assert lay["stage_bytes"] >= lay["rows_cap"] + (
        4 * tile * bs + 30 if lay["stages"] == 2 else 0)
    assert lay["smem"] == lay["stage0"] + lay["stages"] * lay["stage_bytes"]
    assert lay["smem"] <= ck.MAX_SHARED


@pytest.mark.parametrize("bs", [1, 8, 32, 33, 64])
@pytest.mark.parametrize("l", [8, 25, 33, 40])
def test_bounds_launch_geometry_covers_every_block_once(bs, l):
    """The bounds kernel's tiles cover blocks 0..B-1 once, its persistent
    grid walks every tile once, one CUDA block fits an SM's shared memory
    and the grid its limits, for B from 1 to 2^22."""
    for b in _GEOMETRY_B:
        for sms, per_sm in ((132, 4), (132, 1), (1, 1)):
            geo = ck.bounds_launch_geometry(b, bs, l, sms, per_sm)
            tile, tiles, grid, threads = (geo[k] for k in
                                          ("tile", "tiles", "grid",
                                           "threads"))
            _check_bounds_layout(geo, bs, l)
            # a thread per column and per row of a tile
            assert tile == 1 or (tile * l <= threads
                                 and tile * bs <= threads)
            assert threads % 32 == 0 and 32 <= threads <= 1024
            assert 1 <= grid <= min(tiles, sms * per_sm, ck.MAX_GRID_X)
            # tile t holds blocks [t*tile, min(b, (t+1)*tile)), none empty
            lo = np.arange(tiles) * tile
            hi = np.minimum(lo + tile, b)
            assert (hi > lo).all() and lo[0] == 0 and hi[-1] == b
            assert (lo[1:] == hi[:-1]).all()
            # CUDA block g walks tiles g, g + grid, ...
            walked = np.zeros(tiles, np.int64)
            for g in range(grid):
                walked[g::grid] += 1
            assert (walked == 1).all()
    with pytest.raises(ValueError):
        ck.bounds_launch_geometry(10, 65536, 25, 132, 1)
    with pytest.raises(ValueError):
        ck.bounds_launch_geometry(10, 32, 10_000, 132, 1)


def _warp_per_block_smem(bs, l):
    """Shared bytes of a bounds pass that gives each block one warp and
    stages its counts (L, 20), centroid (L, 8), table (L, 20), rows and
    row flags, with the coordinate table beside them."""
    return (4 * 20 * 8 + 4 * 20 * l + 4 * 8 * l + 4 * 20 * l
            + -(-bs * l // 16) * 16 + -(-bs // 16) * 16)


@pytest.mark.parametrize("l", [1, 8, 25, 40, 255, 256, 257, 300, 1000])
def test_bounds_geometry_takes_every_shape_a_warp_per_block_fits(l):
    """Every (bs, L) whose block fits in shared memory with a warp of its
    own fits the bounds kernel: L past the threads of a block takes its
    columns in rounds, and a block of thousands of rows is staged one tile
    at a time with order read from global memory."""
    lo, hi = 1, 1 << 20             # the largest bs that fits, bisected
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if _warp_per_block_smem(mid, l) <= \
            ck.MAX_SHARED else (lo, mid - 1)
    for bs in sorted({1, 8, 32, 33, 4096, lo // 2, lo}):
        if _warp_per_block_smem(bs, l) > ck.MAX_SHARED:
            continue
        geo = ck.bounds_launch_geometry(100, bs, l, 132, 2)
        _check_bounds_layout(geo, bs, l)
        if geo["tile"] * l > geo["threads"]:
            assert geo["tile"] == 1 and l > geo["threads"]
    if l == 25:
        geo = ck.bounds_launch_geometry(100, 4096, 25, 132, 2)
        assert geo["tile"] == 1 and geo["stages"] == 1
        assert ck.bounds_launch_geometry(100, 32, 25, 132, 2)["stages"] == 2


@pytest.mark.parametrize("b", _GEOMETRY_B)
def test_extend_launch_geometry_covers_every_lane_once(b):
    """The extension kernel's grid holds every lane once (lane j in CUDA
    block j // lanes_per_block), with static tables that fit and a grid
    within its limit."""
    geo = ck.extend_launch_geometry(b)
    lanes, grid = geo["lanes_per_block"], geo["grid"]
    assert ck.EXTEND_GROUP * lanes == geo["threads"] == ck.EXTEND_THREADS
    assert (grid - 1) * lanes < b <= grid * lanes <= 2 * b + lanes
    assert 1 <= grid <= ck.MAX_GRID_X
    assert geo["smem"] <= ck.MAX_SHARED


def test_cpu_wrappers_take_plain_versions(rng):
    q, c, rad = _prune_inputs(rng)
    qt, ct, rt = (torch.as_tensor(x) for x in (q, c, rad))
    vin = [torch.as_tensor(x)
           for x in kc.verify_inputs(rng, 3, 7, 8, 7)[:5]]
    ck.reset_launches()
    for got, want in zip(ck.sq_distance_prune(qt, ct, rt, 121.5),
                         ck.sq_distance_prune_plain(qt, ct, rt, 121.5)):
        assert torch.equal(got, want)
    for got, want in zip(ck.ptable_verify(*vin, 3.5, 1000),
                         ck.ptable_verify_plain(*vin, 3.5, 1000)):
        assert torch.equal(got, want)
    seq = torch.as_tensor(rng.integers(0, 22, 300).astype(np.int32))
    six = torch.as_tensor(np.stack([rng.integers(0, 140, 50),
                                    rng.integers(150, 280, 50),
                                    np.zeros(50), np.full(50, 150),
                                    np.full(50, 150), np.full(50, 300)])
                          .astype(np.int32))
    assert torch.equal(ck.extend_pairs(seq, seq, six, 9),
                       ck.extend_pairs_plain(seq, seq, six, 9))
    order = torch.as_tensor(rng.integers(0, 90, (7, 4)).astype(np.int32))
    rows = torch.as_tensor(rng.integers(0, 20, (7, 4 * 5)).astype(np.int8))
    coords = td.const("coords", torch.device("cpu"))
    for got, want in zip(ck.block_bounds(rows, order, 60, coords),
                         ck.block_bounds_plain(rows, order, 60, coords)):
        assert torch.equal(got, want)
    from hsearch_tpu_torch.align import gapped_device, pipeline
    from hsearch_tpu_torch.cluster import greedy
    win = [torch.as_tensor(x) for x in (rng.integers(0, 21, (6, 30)),
                                        rng.integers(0, 31, 6),
                                        rng.integers(0, 21, (6, 40)),
                                        rng.integers(0, 41, 6))]
    win = [x.to(torch.int32) for x in win]
    sub = torch.as_tensor(pipeline._sub21())
    for got, want in zip(ck.banded_scores(*win, sub, 11, 1, 27, 8),
                         gapped_device.banded_scores_plain(*win, sub, 11, 1,
                                                           27, 8)):
        assert torch.equal(got, want)
    d = torch.rand((5, 16, 16)) * 50
    state = torch.as_tensor(rng.integers(0, 3, (5, 16)).astype(np.uint8))
    valid = torch.rand((5, 16)) > 0.2
    assert torch.equal(ck.elect(d, state, valid, 25.0),
                       greedy._elect_plain(d, state, valid, 25.0))
    # the counts record kernel launches only
    assert ck.launch_counts() == {"sq_distance_prune": 0,
                                  "ptable_verify": 0, "extend_pairs": 0,
                                  "block_bounds": 0, "banded_scores": 0,
                                  "elect": 0}


def test_non_cpu_tensors_never_fall_back():
    # a tensor that is not on the CPU goes to the kernel path, which
    # refuses anything but CUDA tensors instead of computing elsewhere
    q = torch.empty((4, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ck.sq_distance_prune(q, torch.empty((5, 16), device="meta"),
                             torch.empty(5, device="meta"), 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        ck.ptable_verify(torch.empty((2, 3, 20), device="meta"),
                         torch.empty((9, 12), dtype=torch.int8,
                                     device="meta"),
                         torch.empty((9, 4), dtype=torch.int32,
                                     device="meta"),
                         torch.empty((2, 5), dtype=torch.int64,
                                     device="meta"),
                         torch.empty((2, 5), device="meta"), 1.0, 10)
    with pytest.raises(ValueError, match="CUDA"):
        ck.extend_pairs(torch.empty(40, dtype=torch.int32, device="meta"),
                        torch.empty(40, dtype=torch.int32, device="meta"),
                        torch.empty((6, 8), dtype=torch.int32,
                                    device="meta"), 9)
    with pytest.raises(ValueError, match="CUDA"):
        ck.block_bounds(torch.empty((9, 12), dtype=torch.int8,
                                    device="meta"),
                        torch.empty((9, 4), dtype=torch.int32,
                                    device="meta"), 10,
                        torch.empty((20, 8), device="meta"))


# ---- on the card -----------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _check_prune_on_cuda(q, cent, rad, r):
    """Kernel vs plain under kernel_checks.prune_agreement's tolerance and
    flip rule: keys within rtol 1e-4 / atol 1e-3 (or 1e-3 +
    1e-5 (|q|^2 + |c|^2) in d^2), liveness flips only within 1e-3 of
    r + radius; gmin and n_alive exactly the kernel's own keys'."""
    res = kc.prune_agreement(q, cent, rad, r,
                             ck.sq_distance_prune(q, cent, rad, r),
                             ck.sq_distance_prune_plain(q, cent, rad, r))
    assert res["ok"], res


def _check_verify_on_cuda(dev, rng, c, kb, bs, l):
    """Kernel vs plain: d2m and n_hits bitwise equal."""
    *arrays, r2, n = kc.verify_inputs(rng, c, kb, bs, l)
    ins = [torch.as_tensor(x, device=dev) for x in arrays]
    res = kc.verify_agreement(ck.ptable_verify(*ins, r2, n),
                              ck.ptable_verify_plain(*ins, r2, n))
    assert res["ok"], res


@pytest.mark.cuda
def test_kernels_match_plain_on_cuda():
    dev = _cuda()
    rng = np.random.default_rng(0)
    q, c, rad = (torch.as_tensor(x, device=dev) for x in _prune_inputs(rng))
    _check_prune_on_cuda(q, c, rad, 121.5)
    _check_verify_on_cuda(dev, rng, 6, 40, 8, 25)


# ragged: C not a multiple of the 128-row tile, B not a multiple of 64
@pytest.mark.cuda
@pytest.mark.parametrize("c,b,d", [(200, 300, 80), (130, 1000, 200),
                                   (1, 65, 8)])
def test_prune_kernel_ragged_on_cuda(c, b, d):
    dev = _cuda()
    rng = np.random.default_rng(c + b)
    q, cent, rad = (torch.as_tensor(x, device=dev)
                    for x in _prune_inputs(rng, c, b, d))
    r = float(torch.sqrt(td.sq_distance_matrix(q, cent)).median()) - 2.5
    _check_prune_on_cuda(q, cent, rad, r)


@pytest.mark.cuda
def test_prune_kernel_past_the_grid_limit_on_cuda():
    """B = 8,388,608 blocks, 128 past the 65,535 block tiles one grid
    holds (a 2.1 GB key matrix at C = 64): the second grid's columns too
    agree with the plain version."""
    dev = _cuda()
    b, c, d = 8_388_608, 64, 8
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(c, d, generator=g, device=dev) * 10
    cent = torch.randn(b, d, generator=g, device=dev) * 10
    rad = torch.rand(b, generator=g, device=dev) * 5
    r = float(torch.sqrt(td.sq_distance_matrix(q, cent[:65536])).median()) \
        - 2.5
    assert len(ck.prune_launch_ranges(b)) == 2
    _check_prune_on_cuda(q, cent, rad, r)
    key = ck.sq_distance_prune(q, cent, rad, r)[0]
    assert bool(torch.isfinite(key[:, 128 * 65535:b]).any())


# ragged: kb*bs not a multiple of the 512-candidate tile; rows of 200
# bytes (byte staging) and of 800 / 160 bytes (16-byte staging); and
# 66,000 one-block tiles, past the grid's 65,535 (two launches)
@pytest.mark.cuda
@pytest.mark.parametrize("c,kb,bs,l", [(3, 37, 8, 25), (4, 70, 8, 25),
                                       (5, 21, 32, 25), (2, 9, 16, 10),
                                       (1, 66000, 512, 1)])
def test_verify_kernel_ragged_on_cuda(c, kb, bs, l):
    dev = _cuda()
    _check_verify_on_cuda(dev, np.random.default_rng(kb), c, kb, bs, l)


@pytest.mark.cuda
@pytest.mark.parametrize("c,m", [(32, 4096), (5, 777)])
def test_verify_kernel_bs1_on_cuda(c, m):
    """The verify kernel at block size 1, as the LSH search calls it: the
    database rows are the blocks (order = arange, a zero sentinel row
    last), ids with duplicates and sentinels; bitwise equal to the plain
    version."""
    dev = _cuda()
    rng = np.random.default_rng(m)
    n, l = 5000, 25
    db = np.zeros((n + 1, l), np.int8)
    db[:n] = rng.integers(0, 20, (n, l))
    ids = np.sort(rng.integers(0, n + 1, (c, m)), axis=1)
    neg = np.where(ids < n, 0.0, np.inf).astype(np.float32)
    ptab = rng.random((c, l, 20)).astype(np.float32)
    args = [torch.as_tensor(x, device=dev) for x in (
        ptab, db, np.arange(n + 1, dtype=np.int32).reshape(-1, 1), ids,
        neg)]
    res = kc.verify_agreement(ck.ptable_verify(*args, 0.45 * l, n),
                              ck.ptable_verify_plain(*args, 0.45 * l, n))
    assert res["ok"], res


@pytest.mark.cuda
def test_lsh_search_on_cuda_matches_cpu():
    """The LSH search on the card (through the verify kernel) equals the
    same search on the CPU, given equal tables and query codes."""
    from hsearch_tpu_torch.search import motif as tm
    dev = _cuda()
    rng = np.random.default_rng(0)
    fam = rng.integers(0, 20, (400, 25))
    db = fam[rng.integers(0, 400, 20000)]
    db = np.where(rng.random(db.shape) < 0.08,
                  rng.integers(0, 20, db.shape), db).astype(np.int32)
    centers = db[:64]
    cfg = tm.MotifSearchConfig(hash_k=8, hash_l=4, w=60.0, radius=20.0,
                               probes=4, center_block=32)
    cpu = tm.build_index(db, torch.Generator().manual_seed(0), cfg,
                         device="cpu")
    gpu = tm.build_index(db, torch.Generator().manual_seed(0), cfg,
                         device=dev)
    assert torch.equal(gpu.tables.perm.cpu(), cpu.tables.perm)
    assert torch.equal(
        tm._query_codes(gpu, torch.as_tensor(centers, device=dev), True,
                        4).cpu(),
        tm._query_codes(cpu, torch.as_tensor(centers), True, 4))
    ck.reset_launches()
    got = tm.search(gpu, centers, cfg)
    assert ck.launch_counts()["ptable_verify"] == 2
    want = tm.search(cpu, centers, cfg)
    assert set(zip(got[0].tolist(), got[1].tolist())) == \
        set(zip(want[0].tolist(), want[1].tolist()))
    assert len(got[0]) > 64


_SQRT_CHECK = r"""
#include <cstdio>
#include <cstdint>
SQRT_NONNEG
__global__ void check(unsigned long long* bad) {
  for (uint64_t b = blockIdx.x * (uint64_t)blockDim.x + threadIdx.x;
       b < 0x7f800000ull; b += (uint64_t)gridDim.x * blockDim.x) {
    const float x = __uint_as_float((uint32_t)b);
    if (__float_as_uint(sqrt_nonneg(x)) != __float_as_uint(sqrtf(x)))
      atomicAdd(bad, 1ull);
  }
}
int main() {
  unsigned long long* bad;
  cudaMallocManaged(&bad, sizeof(*bad));
  *bad = 0;
  check<<<1056, 256>>>(bad);
  if (cudaDeviceSynchronize() != cudaSuccess) return 1;
  printf("%llu\n", *bad);
  return 0;
}
"""


@pytest.mark.cuda
def test_pcluster_on_cuda_matches_cpu():
    """cluster_proteins with gapped refinement on the card (the device
    probe and pair preparation, the windowed extension, banded_scores)
    equals the CPU run in labels and every Hit field; a searcher over
    proteins longer than 512 residues (the chunked extension) too."""
    import dataclasses

    from hsearch_tpu_torch.align import pipeline
    from hsearch_tpu_torch.cluster import pcluster
    from hsearch_tpu_torch.core import io as tio
    dev = _cuda()
    rng = np.random.default_rng(0)
    seqs = []
    for f in range(40):
        base = rng.integers(0, 20, 120)
        for m in range(4):
            s = base.copy()
            s[rng.choice(120, 4, replace=False)] = rng.integers(0, 20, 4)
            seqs.append(np.delete(s, [50, 51, 52]) if m == 2 else s)
    long = np.tile(seqs[0], 6)
    seqs += [long, long.copy()]
    starts = np.concatenate([[0], np.cumsum([len(s) for s in seqs])])
    db = tio.ProteinDB(names=[f"p{i}" for i in range(len(seqs))],
                       seq=np.concatenate(seqs).astype(np.uint8),
                       starts=starts)
    kp = [pcluster.klsh_init(torch.Generator().manual_seed(1), bits=12,
                             sigma=0.1)]
    got, want = (pcluster.cluster_proteins(db, None, klsh_params=kp,
                                           gapped=True, bits=12, sigma=0.1,
                                           device=d) for d in (dev, "cpu"))
    assert np.array_equal(got.labels, want.labels)
    rows = [dataclasses.astuple(h) for h in got.hits]
    assert rows == [dataclasses.astuple(h) for h in want.hits]
    assert any(h.gap_open for h in got.hits) and len(rows) > 400
    sub = np.arange(150, len(seqs))
    gs, cs = (pipeline.ProteinSearcher(db, subset=sub, device=d)
              for d in (dev, "cpu"))
    assert not gs.windowed
    assert [dataclasses.astuple(h) for h in gs.search_all()] == \
        [dataclasses.astuple(h) for h in cs.search_all()]


@pytest.mark.cuda
def test_stream_upload_on_cuda(monkeypatch):
    """The segmented engine's uploads on the card: the host byte sets are
    page-locked, every copy runs on a side stream, the streamed search
    equals a search of synchronously uploaded segments, and a segment
    uploaded on a side stream while kernels queue on the current stream
    is bounded bitwise like a synchronous upload."""
    from hsearch_tpu_torch.core import embedding
    from hsearch_tpu_torch.search import ivf, stream
    dev = _cuda()
    rng = np.random.default_rng(3)
    fam = rng.integers(0, 20, (512, 25))
    db = fam[rng.integers(0, 512, 1 << 15)]
    db = np.where(rng.random(db.shape) < 0.08,
                  rng.integers(0, 20, db.shape), db).astype(np.int32)
    centers = fam[:64].astype(np.int32)
    sidx = stream.build_segmented(db, torch.Generator().manual_seed(0),
                                  segment_points=1 << 13, device=dev)
    assert sidx.num_segments == 4 and sidx.resident_fraction() == 0.0
    assert all(s.pinned[0].is_pinned() and s.pinned[1].is_pinned()
               for s in sidx.segments)
    copies = []
    h2d = stream._h2d

    def spy(host, d):
        copies.append((host.is_pinned(),
                       torch.cuda.current_stream(d).cuda_stream
                       != torch.cuda.default_stream(d).cuda_stream))
        return h2d(host, d)

    monkeypatch.setattr(stream, "_h2d", spy)
    kw = dict(k_blocks=16, max_hits=512, center_block=64,
              retry_overflow=False)
    events: list = []
    got = stream.search_segmented(sidx, centers, 35.0, stats_out={},
                                  h2d_events=events, **kw)
    assert copies == [(True, True)] * 8
    torch.cuda.synchronize(dev)
    assert [e[0] for e in events] == [0, 1, 2, 3]
    assert all(s.elapsed_time(e) > 0 for _, s, e in events)
    want = []
    for seg in sidx.segments:
        ci, ki, _ = ivf.search(stream.upload_segment(seg, dev), centers,
                               35.0, **kw)
        want += list(zip(ci.tolist(), (ki + seg.offset).tolist()))
    assert set(zip(got[0].tolist(), got[1].tolist())) == set(want)
    assert len(want) > 500
    a = stream.upload_segment(sidx.segments[0], dev)
    q = torch.as_tensor(embedding.embed_kmers(centers), device=dev)
    for _ in range(50):
        ck.sq_distance_prune(q, a.block_centroid, a.block_radius, 35.0)
    side = torch.cuda.Stream(dev)
    b = stream.upload_segment(sidx.segments[1], dev, stream=side)
    torch.cuda.current_stream(dev).wait_stream(side)
    stream._adopt(b, torch.cuda.current_stream(dev))
    c = stream.upload_segment(sidx.segments[1], dev)
    torch.cuda.synchronize(dev)
    for f in ("db_sorted", "order", "block_centroid", "block_radius"):
        assert torch.equal(getattr(b, f), getattr(c, f))


@pytest.mark.cuda
def test_approx_select_on_cuda(monkeypatch):
    """The approximate block select on the card: each selected key is the
    first minimum of its strided bin and the ks best bin minima are taken
    (ties and dead keys included); ivf.search(approx_select=True) on a
    CUDA index approximates where L < groups and finds a subset of the
    oracle's hits with the exact select's distances, and where L >= groups
    finds exactly the exact select's hits."""
    from hsearch_tpu_torch.bench import protein_like_db
    from hsearch_tpu_torch.search import exact, ivf
    dev = _cuda()
    rng = np.random.default_rng(5)
    vals = rng.integers(0, 50, (64, 12896)).astype(np.float32)
    vals[rng.random(vals.shape) < 0.3] = np.inf
    vals[0] = np.inf
    for ks in (128, 256):
        nb = ivf._approx_bins(vals.shape[1], ks)
        neg, idx = (x.cpu().numpy() for x in ivf._approx_topk_min(
            torch.as_tensor(vals, device=dev), ks))
        binned = np.pad(vals, ((0, 0), (0, (-vals.shape[1]) % nb)),
                        constant_values=np.inf).reshape(64, -1, nb)
        first = np.argmin(binned, axis=1) * nb + np.arange(nb)
        bmin = binned.min(axis=1)
        b = idx % nb
        np.testing.assert_array_equal(np.sort(-neg, axis=1),
                                      np.sort(bmin, axis=1)[:, :ks])
        np.testing.assert_array_equal(np.take_along_axis(first, b, 1), idx)
        assert all(len(set(r)) == ks for r in b.tolist())
    db, centers = protein_like_db(np.random.default_rng(0), 1 << 20, 25,
                                  query_n=256)
    index = ivf.build_index(db, torch.Generator().manual_seed(0),
                            block_size=32, device=dev)
    ng = -(-index.num_blocks // ivf._SELECT_GROUP)
    calls = []
    real = ivf._approx_topk_min
    monkeypatch.setattr(ivf, "_approx_topk_min",
                        lambda v, k, *a: calls.append(k) or real(v, k, *a))
    truth = exact.search_radius(db, centers, 35.0, device=dev)
    truth = set(zip(truth[0].tolist(), truth[1].tolist()))
    for kb in (8, 128):
        res = {}
        for approx in (False, True):
            ci, ki, dd = ivf.search(index, centers, 35.0, k_blocks=kb,
                                    max_hits=512, retry_overflow=False,
                                    stats_out={}, approx_select=approx)
            res[approx] = dict(zip(zip(ci.tolist(), ki.tolist()),
                                   dd.tolist()))
        assert set(res[True]) <= truth and len(res[True]) > 256
        if ivf._approx_bins(ng, kb) < ng:
            assert kb in calls
            assert all(res[True][p] == res[False][p]
                       for p in set(res[True]) & set(res[False]))
        else:
            assert res[True] == res[False]
    assert ivf._approx_bins(ng, 8) < ng <= ivf._approx_bins(ng, 128)


@pytest.mark.cuda
def test_prune_sqrt_is_sqrtf_on_cuda(tmp_path):
    """The prune kernel's branch-free square root (csrc/prune.cu
    sqrt_nonneg) is bitwise sqrtf on every non-negative finite float."""
    _cuda()
    src = (ck._SRC / "prune.cu").read_text()
    fn = re.search(r"__device__ __forceinline__ float sqrt_nonneg\(float x\)"
                   r" \{.*?\n\}\n", src, re.S)
    assert fn, "sqrt_nonneg not found in prune.cu"
    (tmp_path / "check.cu").write_text(
        _SQRT_CHECK.replace("SQRT_NONNEG", fn.group(0)))
    subprocess.run([ck._nvcc(), *ck.NVCC_FLAGS[:2], "-O3", "-o",
                    str(tmp_path / "check"), str(tmp_path / "check.cu")],
                   check=True, capture_output=True)
    out = subprocess.run([str(tmp_path / "check")], check=True,
                         capture_output=True, text=True).stdout
    assert out.strip() == "0", f"{out.strip()} inputs differ from sqrtf"


@pytest.mark.cuda
@pytest.mark.parametrize("n_prot,plen,b", [(24, 96, 1), (24, 96, 37),
                                           (40, 120, 8192),
                                           (20, 600, 8197)])
def test_extend_kernel_matches_plain_on_cuda(n_prot, plen, b):
    """The extension kernel on ragged batches equals the chunked form on
    the card and on the CPU in all 8 fields; a column slice of a wider
    batch is read in place."""
    dev = _cuda()
    seq, six = kc.extend_inputs(np.random.default_rng(plen + b), n_prot,
                                plen, b)
    s, x = torch.as_tensor(seq, device=dev), torch.as_tensor(six, device=dev)
    got = ck.extend_pairs(s, s, x, 9)
    res = kc.extend_agreement(got, ck.extend_pairs_plain(s, s, x, 9))
    assert res["ok"], res
    assert torch.equal(got.cpu(), ck.extend_pairs_plain(
        torch.as_tensor(seq), torch.as_tensor(seq), torch.as_tensor(six),
        9))
    if b > 2:
        assert torch.equal(ck.extend_pairs(s, s, x[:, 1:b - 1], 9),
                           got[:, 1:b - 1])


@pytest.mark.cuda
@pytest.mark.parametrize("plen", [120, 600])
def test_extend_batch_on_cuda_is_the_kernel_and_never_syncs(plen):
    """On a CUDA searcher extend_batch launches the kernel for proteins of
    120 (window-dense form on the CPU) and 600 residues (chunked form),
    bitwise the chunked form on the card and the CPU form, and makes no
    host synchronisation once the tables are on the card."""
    from hsearch_tpu_torch.align import extend, pipeline, seed_index
    from hsearch_tpu_torch.examples.bench_align import protein_families
    dev = _cuda()
    db, _ = protein_families(256, plen=plen, seed=2)
    gs, cs = (pipeline.ProteinSearcher(db, device=d) for d in (dev, "cpu"))
    assert cs.windowed == (plen <= 512)
    rng = np.random.default_rng(plen)
    starts = gs.starts
    pid = rng.integers(0, len(starts) - 1, (2, 8192))
    off = rng.integers(0, plen - 10, (2, 8192))
    six = np.stack([starts[pid[0]] + off[0], starts[pid[1]] + off[1],
                    starts[pid[0]], starts[pid[0] + 1], starts[pid[1]],
                    starts[pid[1] + 1]]).astype(np.int32)
    x = torch.as_tensor(six, device=dev)
    gs.extend_batch(x)
    torch.cuda.synchronize(dev)
    before = ck.extend_pairs.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = gs.extend_batch(x)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert ck.extend_pairs.launches == before + 1
    drop = int(gs.cutoffs.ungap_ext_drop)
    plain = extend.extend_pairs_packed(gs._seq_dev, gs._seq_dev, x, drop,
                                       seed_index.SEED_LEN)
    assert torch.equal(got, plain)
    assert torch.equal(got.cpu(), cs.extend_batch(torch.as_tensor(six)))


@pytest.mark.cuda
@pytest.mark.parametrize("bs,l", [(32, 25), (8, 10), (33, 25), (1, 25)])
def test_block_bounds_kernel_on_cuda(bs, l):
    """The bounds kernel against its plain version under
    kernel_checks.bounds_agreement, with padding blocks and partly valid
    blocks, at block sizes below, at and above one warp."""
    dev = _cuda()
    rng = np.random.default_rng(bs * 100 + l)
    b, n = 3000, 50_000
    fam = rng.integers(0, 20, (40, bs * l))
    rows = np.where(rng.random((b, bs * l)) < 0.1,
                    rng.integers(0, 20, (b, bs * l)),
                    fam[rng.integers(0, 40, b)]).astype(np.int8)
    order = rng.integers(0, n, (b, bs)).astype(np.int32)
    order[rng.random((b, bs)) < 0.3] = n
    order[::7] = n                              # padding blocks
    rows[::7] = 0
    r_, o_ = torch.as_tensor(rows, device=dev), torch.as_tensor(order,
                                                                device=dev)
    coords = td.const("coords", dev)
    before = ck.block_bounds.launches
    got = ck.block_bounds(r_, o_, n, coords)
    assert ck.block_bounds.launches == before + 1
    res = kc.bounds_agreement(got, ck.block_bounds_plain(r_, o_, n, coords),
                              coords)
    assert res["ok"] and res["padding_blocks"] >= -(-b // 7), res


@pytest.mark.cuda
def test_streamed_bounds_are_the_built_index_bounds_on_cuda():
    """An index built on the card and the same rows uploaded as a segment
    get bitwise the same bounds, each from one kernel launch."""
    from hsearch_tpu_torch.search import ivf, stream
    dev = _cuda()
    rng = np.random.default_rng(11)
    fam = rng.integers(0, 20, (256, 25))
    db = np.where(rng.random((1 << 16, 25)) < 0.08,
                  rng.integers(0, 20, (1 << 16, 25)),
                  fam[rng.integers(0, 256, 1 << 16)]).astype(np.int32)
    ck.reset_launches()
    idx = ivf.build_index(db, torch.Generator().manual_seed(0), device=dev)
    seg = stream._to_host_segment(idx, 0, True)
    up = stream.upload_segment(seg, dev, stream=torch.cuda.Stream(dev))
    torch.cuda.synchronize(dev)
    assert ck.launch_counts()["block_bounds"] == 2
    assert torch.equal(up.block_centroid, idx.block_centroid)
    assert torch.equal(up.block_radius, idx.block_radius)
    coords = td.const("coords", dev)
    res = kc.bounds_agreement(
        (idx.block_centroid, idx.block_radius),
        ck.block_bounds_plain(idx.db_sorted, idx.order, idx.n_points,
                              coords), coords)
    assert res["ok"], res


@pytest.mark.cuda
@pytest.mark.parametrize("drop", [9, 30])
def test_extend_kernel_ties_and_bounds_on_cuda(drop):
    """The kernel equals the chunked form bitwise on lanes whose running
    maximum ties across chunk boundaries, lanes that run to a protein's
    end (the past-bound score stops them), gate scores below MINSCORE,
    and kernel_checks.extend_inputs' mixed lanes."""
    dev = _cuda()
    for seed, make in ((1, kc.extend_tie_inputs), (2, kc.extend_inputs)):
        seq, six = make(np.random.default_rng(seed + drop))
        s, x = (torch.as_tensor(a, device=dev) for a in (seq, six))
        got = ck.extend_pairs(s, s, x, drop)
        res = kc.extend_agreement(got, ck.extend_pairs_plain(s, s, x, drop))
        assert res["ok"], (seed, drop, res)
    occ = ck.resident_warps("extend_pairs", ck.extend_launch_geometry(8192),
                            dev)
    assert occ["warps_per_sm"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("bs,l", [(bs, l) for bs in (1, 8, 32, 33, 64)
                                  for l in (8, 25, 33, 40)]
                         + [(32, 300), (4096, 25), (8192, 25)])
def test_block_bounds_kernel_ragged_on_cuda(bs, l):
    """The bounds kernel against its plain version at ragged shapes, with
    B past one wave of the persistent grid and not a multiple of the tile,
    padding blocks, partly valid blocks and a row span that starts off a
    16-byte boundary (a view one block in); L = 300 takes a tile's
    columns in rounds, and bs 4096 and 8192 stage one tile at a time."""
    dev = _cuda()
    rng = np.random.default_rng(bs * 100 + l)
    geo = ck.bounds_geometry_on(dev, 1 << 30, bs, l)    # the full grid
    waves = 3 if bs * l <= 2048 else 1
    b = waves * geo["tile"] * geo["grid"] + 3
    n = 50_000
    fam = rng.integers(0, 20, (40, bs * l))
    rows = np.where(rng.random((b + 1, bs * l)) < 0.1,
                    rng.integers(0, 20, (b + 1, bs * l)),
                    fam[rng.integers(0, 40, b + 1)]).astype(np.int8)
    order = rng.integers(0, n, (b + 1, bs)).astype(np.int32)
    order[rng.random((b + 1, bs)) < 0.3] = n
    order[::7] = n
    coords = td.const("coords", dev)
    r_all = torch.as_tensor(rows, device=dev)
    o_all = torch.as_tensor(order, device=dev)
    for r_, o_ in ((r_all[:b], o_all[:b]), (r_all[1:], o_all[1:])):
        assert r_.is_contiguous() and o_.is_contiguous()
        before = ck.block_bounds.launches
        got = ck.block_bounds(r_, o_, n, coords)
        assert ck.block_bounds.launches == before + 1
        res = kc.bounds_agreement(got, ck.block_bounds_plain(r_, o_, n,
                                                             coords), coords)
        assert res["ok"] and res["padding_blocks"] >= b // 7, res
    occ = ck.resident_warps("block_bounds",
                            ck.bounds_geometry_on(dev, b, bs, l), dev)
    assert occ["warps_per_sm"] > 0
