"""The elect kernel's algorithm, plain version and wrapper on the CPU, and
the kernel against its plain version on a card.

``elect_block`` is a numpy model of hsearch_tpu_torch/csrc/elect.cu for
one bucket row, written as the kernel runs it: a mask of the unprocessed
slots, a first pass that keeps each unprocessed position's distance test
d[p, j] <= r as one bit per slot, then the walk over the unprocessed
positions in order, each step the minimum of the keys
j + B (1 - pre_j) of the available matching slots.  On seeded rows of
every size class (4, 16, 64, 256; 100 for a ragged class) with invalid
and pre-existing slots, all-invalid and all-center rows, distances of 0
and radii 0, mid and huge, it equals ``_elect_plain``, which equals the
sequential walk ``_elect_reference`` and the JAX package's
``_elect_device``.  ``_elect_device`` takes the plain version on CPU
tensors and launches nothing; what the kernel cannot take raises before
anything is built; greedy clustering reaches the election through the
wrapper.

The card's cases need neither jax nor tests/conftest.py:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_elect_kernel.py
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from hsearch_tpu_torch.cluster import greedy as tg
from hsearch_tpu_torch.core import embedding
from hsearch_tpu_torch.ops import cuda_kernels as ck

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def elect_block(d, state, valid, r):
    """One (B, B) row through the kernel's walk -> (B,) int64 parents."""
    b = d.shape[0]
    pre = valid & (state == 1)
    unproc = valid & (state == 0)
    key = np.where(pre, np.arange(b), np.arange(b) + b)
    bits = np.zeros((b, b), bool)          # bits[p, j], unprocessed p only
    bits[unproc] = d[unproc] <= np.float32(r)
    avail = pre.copy()
    parent = np.full(b, -1, np.int64)
    for p in np.flatnonzero(unproc):
        kmin = np.where(avail & bits[p], key, 2 * b).min()
        if kmin < 2 * b:
            parent[p] = kmin if kmin < b else kmin - b
        else:
            avail[p] = True
    return parent


def _rows(rng, nb, b, l=6):
    """(d (NB, B, B) f32, state uint8, valid bool, radius) from random
    k-mers; slot 5 repeats slot 1 (distance 0); row 0 all invalid, row 1
    all pre-existing centers, row 2 all unprocessed and valid."""
    bk = rng.integers(0, 20, (nb, b, l))
    if b > 5:
        bk[:, 5] = bk[:, 1]
    d = np.sqrt(embedding.DISTANCE_SQUARE[bk[:, :, None, :],
                                          bk[:, None, :, :]].sum(-1))
    state = rng.integers(0, 3, (nb, b)).astype(np.uint8)
    valid = rng.random((nb, b)) > 0.2
    valid[0] = False
    state[1], valid[1] = 1, True
    state[2], valid[2] = 0, True
    return d.astype(np.float32), state, valid, float(np.median(d))


RADII = (0.0, None, 1e9)            # None: the median distance


@pytest.mark.parametrize("b", [4, 16, 64, 100, 256])
def test_block_model_equals_plain_and_reference(b):
    rng = np.random.default_rng(b)
    d, state, valid, mid = _rows(rng, 6 if b == 256 else 12, b)
    for r in RADII:
        r = mid if r is None else r
        got = tg._elect_plain(torch.as_tensor(d), torch.as_tensor(state),
                              torch.as_tensor(valid), r).numpy()
        for i in range(len(d)):
            want = tg._elect_reference(d[i], state[i], valid[i], r)
            np.testing.assert_array_equal(got[i], want, err_msg=f"{r} {i}")
            np.testing.assert_array_equal(
                elect_block(d[i], state[i], valid[i], r), want)
        assert (got[0] == -1).all() and (got[1] == -1).all()
        if r == 1e9:                  # one leader absorbs every other slot
            assert (got[2, 1:] == 0).all() and got[2, 0] == -1


@pytest.mark.parametrize("b", [4, 16, 64, 256])
def test_plain_equals_jax(b):
    import jax.numpy as jnp

    from hsearch_tpu.cluster import greedy as jg
    rng = np.random.default_rng(100 + b)
    d, state, valid, mid = _rows(rng, 5 if b == 256 else 9, b)
    for r in RADII:
        r = mid if r is None else r
        got = tg._elect_plain(torch.as_tensor(d), torch.as_tensor(state),
                              torch.as_tensor(valid), r).numpy()
        want = np.asarray(jg._elect_device(jnp.asarray(d),
                                           jnp.asarray(state),
                                           jnp.asarray(valid),
                                           jnp.float32(r)))
        np.testing.assert_array_equal(got, want, err_msg=str(r))


def test_radius_is_compared_in_float32():
    """A distance equal to float32(radius) matches even when the float64
    radius lies just below it."""
    d = np.zeros((1, 4, 4), np.float32)
    d[0, 1, 0] = d[0, 0, 1] = np.float32(20.1)
    state = np.zeros((1, 4), np.uint8)
    valid = np.ones((1, 4), bool)
    r = float(np.nextafter(np.float64(np.float32(20.1)), 0))
    assert np.float32(r) == np.float32(20.1) and r < float(np.float32(20.1))
    got = tg._elect_device(torch.as_tensor(d), torch.as_tensor(state),
                           torch.as_tensor(valid), r).numpy()
    assert got[0, 1] == 0
    np.testing.assert_array_equal(got[0], elect_block(d[0], state[0],
                                                      valid[0], r))


def test_wrapper_takes_the_plain_version_on_cpu():
    rng = np.random.default_rng(7)
    d, state, valid, mid = (torch.as_tensor(x) if isinstance(x, np.ndarray)
                            else x for x in _rows(rng, 10, 16))
    ck.reset_launches()
    got = tg._elect_device(d, state, valid, mid)
    also = ck.elect(d, state, valid, mid)
    want = tg._elect_plain(d, state, valid, mid)
    assert torch.equal(got, want) and torch.equal(also, want)
    assert got.dtype == torch.int64 and got.shape == (10, 16)
    assert ck.launch_counts()["elect"] == 0


def test_empty_slab():
    d = torch.zeros((0, 16, 16))
    state = torch.zeros((0, 16), dtype=torch.uint8)
    valid = torch.zeros((0, 16), dtype=torch.bool)
    got = tg._elect_device(d, state, valid, 35.0)
    assert got.shape == (0, 16) and got.dtype == torch.int64


@pytest.mark.parametrize("bad", ["state_float", "state_int", "d_dtype",
                                 "valid_dtype", "too_wide", "not_square"])
def test_unsupported_arguments_raise_before_any_build(monkeypatch, bad):
    """Tensors off the CPU take the kernel's path (``meta`` tensors stand
    in for a card here): what the kernel cannot take raises first."""
    def fail(*a, **k):
        raise AssertionError("a kernel was built")
    monkeypatch.setattr(ck, "build", fail)
    monkeypatch.setattr(ck, "_lib", fail)
    meta = dict(device="meta")
    b = 1025 if bad == "too_wide" else 16
    d = torch.empty((3, b, b), **meta)
    state = torch.empty((3, b), dtype=torch.uint8, **meta)
    valid = torch.empty((3, b), dtype=torch.bool, **meta)
    args = dict(d=d, state=state, valid=valid, radius=35.0)
    args.update({"state_float": dict(state=state.float()),
                 "state_int": dict(state=state.long()),
                 "d_dtype": dict(d=d.double()),
                 "valid_dtype": dict(valid=state),
                 "too_wide": {},
                 "not_square": dict(d=torch.empty((3, 16, 8), **meta))}[bad])
    err = TypeError if bad != "too_wide" and bad != "not_square" \
        else ValueError
    with pytest.raises(err):
        ck.elect(**args)
    assert ck.launch_counts()["elect"] == 0


def test_non_cpu_tensors_never_fall_back(monkeypatch):
    """Valid arguments off the CPU and off a card raise: the kernel's
    path never computes elsewhere."""
    monkeypatch.setattr(ck, "_lib", None)
    d = torch.empty((3, 16, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tg._elect_device(d, torch.empty((3, 16), dtype=torch.uint8,
                                        device="meta"),
                         torch.empty((3, 16), dtype=torch.bool,
                                     device="meta"), 35.0)


def test_greedy_reaches_the_election_through_the_wrapper(monkeypatch):
    """cluster_greedy elects every slab through ``cuda_kernels.elect`` (on
    the card, the kernel), once per slab of each size class."""
    calls = []
    real = ck.elect
    monkeypatch.setattr(ck, "elect", lambda *a, **k:
                        calls.append(tuple(a[0].shape)) or real(*a, **k))
    rng = np.random.default_rng(3)
    fam = rng.integers(0, 20, (30, 8))
    km = np.where(rng.random((600, 8)) < 0.1, rng.integers(0, 20, (600, 8)),
                  fam[rng.integers(0, 30, 600)])
    cfg = tg.ClusterConfig(hash_k=4, hash_l=2, radius=25.0, bucket_max=64,
                           slab_elems=256)
    tg.cluster_greedy(km, torch.Generator().manual_seed(0), cfg,
                      device="cpu")
    assert calls and all(s[1] == s[2] and s[0] <= max(1, 256 // s[1])
                         for s in calls)


@pytest.mark.parametrize("pid,nproc", [(0, 1), (1, 2), (2, 3)])
def test_elect_edges_hands_the_kernel_contiguous_inputs(monkeypatch, pid,
                                                        nproc):
    """A process's share of the bucket rows (r % nproc == pid, as
    greedy_dist elects them) reaches the election contiguous, as the
    kernel requires; the parents are those of the plain version on the
    same rows."""
    seen = []

    def contiguous_elect(d, state, valid, radius):
        seen.append(all(x.is_contiguous() for x in (d, state, valid)))
        return tg._elect_plain(d, state, valid, radius)
    monkeypatch.setattr(ck, "elect", contiguous_elect)
    rng = np.random.default_rng(11)
    fam = rng.integers(0, 20, (20, 8))
    km = np.where(rng.random((500, 8)) < 0.1, rng.integers(0, 20, (500, 8)),
                  fam[rng.integers(0, 20, 500)]).astype(np.int8)
    km_pad = torch.as_tensor(np.concatenate([km, np.zeros((1, 8), np.int8)]))
    state = torch.zeros(501, dtype=torch.uint8)
    state[500] = 2
    codes = torch.as_tensor(rng.integers(0, 9, 500).astype(np.int32))
    mats = tg._bucket_class_matrices(codes, torch.arange(500), 64, 500)
    cfg = tg.ClusterConfig(radius=25.0, bucket_max=64, slab_elems=128)
    absorbed, _ = tg._elect_edges(km_pad, state, mats, cfg, pid, nproc)
    assert seen and all(seen)
    assert int((absorbed < 500).sum()) > 0


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_elect_bound_by_hand():
    """4,096 rows of 256 slots, 900,000 of them unprocessed: 4 * 256 *
    900,000 + 2 * 1,048,576 + 8 * 1,048,576 bytes at 3.35 TB/s bound it
    (2 * 256 * 900,000 operations take a tenth of that)."""
    cs = _chip_smoke()
    ms, by = cs.elect_bound(4096, 256, 900_000)
    nbytes = 4 * 256 * 900_000 + 10 * 4096 * 256
    assert by == "bytes"
    assert ms == pytest.approx(nbytes / 3.35e12 * 1e3, rel=1e-12)
    ops_ms = 2 * 256 * 900_000 / (64 * 132 * 1.98e9) * 1e3
    assert ops_ms < ms / 5


# ---- on the card -------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b", [4, 16, 64, 100, 256, 1024])
def test_kernel_equals_plain_on_cuda(b):
    dev = _cuda()
    rng = np.random.default_rng(b + 1)
    d, state, valid, mid = _rows(rng, 4 if b == 1024 else 40, b)
    d, state, valid = (torch.as_tensor(x, device=dev)
                       for x in (d, state, valid))
    for r in RADII:
        r = mid if r is None else r
        before = ck.elect.launches
        got = tg._elect_device(d, state, valid, r)
        assert ck.elect.launches == before + 1
        assert torch.equal(got, tg._elect_plain(d, state, valid, r)), (b, r)


@pytest.mark.cuda
def test_cluster_greedy_kernel_equals_plain_on_cuda(monkeypatch):
    """cluster_greedy on the card with the kernel == with the plain loop
    in its place (the same distances, so the same elections)."""
    dev = _cuda()
    rng = np.random.default_rng(5)
    fam = rng.integers(0, 20, (200, 10))
    km = np.where(rng.random((1 << 14, 10)) < 0.1,
                  rng.integers(0, 20, (1 << 14, 10)),
                  fam[rng.integers(0, 200, 1 << 14)])
    cfg = tg.ClusterConfig(hash_k=6, hash_l=3, radius=30.0)
    ck.reset_launches()
    got = tg.cluster_greedy(km, torch.Generator().manual_seed(0), cfg,
                            device=dev)
    assert ck.launch_counts()["elect"] > 0
    monkeypatch.setattr(ck, "elect", tg._elect_plain)
    want = tg.cluster_greedy(km, torch.Generator().manual_seed(0), cfg,
                             device=dev)
    np.testing.assert_array_equal(got.parent, want.parent)
    np.testing.assert_array_equal(got.merged, want.merged)
