"""The banded_scores kernel's algorithm, plain version and wrapper on the
CPU, and the kernel against its plain version on a card.

``banded_warp`` is a numpy model of hsearch_tpu_torch/csrc/banded_scores.cu
for one pair, written as the kernel runs it: the lanes in contiguous
chunks of ceil(w/32) per thread of a 32-thread warp, F's shift across the
chunk boundary from the next thread, E's exclusive prefix maximum as a
chunk prefix plus a warp scan of the chunk maxima, the row's first
maximum as the lowest holding thread's first lane, and the scan stopped
at the pair's qlen or the row it dies in.  On seeded windows (ragged
qlen / dlen, Ld much longer and much shorter than Lq, unknown residues,
bands 0 to 127, drops 0 to 2^20) it equals the plain version, which
equals the JAX package's ``banded_scores`` bitwise and the traceback
scorer of the port's host library.  The wrapper takes the plain version
on CPU tensors and launches nothing; an unsupported band, penalty or
dtype raises before anything is built.

The card's cases need neither jax nor tests/conftest.py:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_banded_kernel.py
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from hsearch_tpu_torch import native_ext
from hsearch_tpu_torch.align import gapped_device, pipeline
from hsearch_tpu_torch.ops import cuda_kernels as ck

NEG = gapped_device.NEG
SUB = pipeline._sub21()
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def banded_warp(q, qlen, d, dlen, sub, go, ge, drop, band):
    """One pair through the kernel's warp algorithm -> (best, bi, bj,
    rows scanned); int64 arithmetic, which equals int32's within the
    wrapper's limits."""
    w = 2 * band + 1
    c = -(-w // 32)
    lanes = np.arange(32 * c).reshape(32, c)       # thread t, chunk k
    real = lanes < w
    ld = len(d)
    j0 = lanes - band
    h = np.where(real & (j0 >= 0) & (j0 <= dlen),
                 np.where(j0 == 0, 0, -(go + (j0 - 1) * ge)), NEG)
    f = np.full((32, c), NEG)
    best, bi, bj, rows = 0, 0, -band, 0
    for i in range(1, min(qlen, len(q)) + 1):
        rows += 1
        # F from (i-1, jj+1): within the chunk, else the next thread's
        # first lane (NEG past thread 31)
        nxt_h = np.append(h[1:, 0], NEG)
        nxt_f = np.append(f[1:, 0], NEG)
        hu = np.concatenate([h[:, 1:], nxt_h[:, None]], axis=1)
        fu = np.concatenate([f[:, 1:], nxt_f[:, None]], axis=1)
        fv = np.maximum(np.maximum(hu - go, fu - ge), NEG)
        j = i - band + lanes
        live = real & (j >= 0) & (j <= dlen)
        jd = np.clip(j - 1, 0, ld)
        dc = np.where(jd == ld, 20,
                      np.clip(np.asarray(d)[np.minimum(jd, ld - 1)], 0, 20)
                      if ld else 20)
        s = sub[min(max(int(q[i - 1]), 0), 20), dc]
        diag = np.where((j > 0) & (h > NEG // 2), h + s, NEG)
        am = np.where(live, np.maximum(diag, fv), NEG)
        f = np.where(real, fv, NEG)
        m = np.maximum(am - go, NEG) + lanes * ge
        pl = np.maximum.accumulate(m, axis=1)
        incl = np.maximum.accumulate(pl[:, -1])     # the warp scan
        excl = np.concatenate([[np.iinfo(np.int64).min], incl[:-1]])
        prev = np.concatenate([excl[:, None],
                               np.maximum(excl[:, None], pl[:, :-1])],
                              axis=1)
        e = np.where((lanes > 0) & (j > 0),
                     np.maximum(prev - np.maximum(lanes * ge - ge, 0), NEG),
                     NEG)
        h = np.where(live, np.maximum(am, e), NEG)
        loc = np.where(real, h, np.iinfo(np.int64).min)
        rmax = loc.max(axis=1)                      # per thread
        row_max = rmax.max()
        if row_max > best:
            holder = int(np.flatnonzero(rmax == row_max)[0])
            first = int(lanes[holder, np.argmax(loc[holder])])
            best, bi, bj = int(row_max), i, i - band + first
        if i > 1 and not (real & (h >= best - drop)).any():
            break
    return best, bi, bj, rows


def _windows(rng, n, lq, ld, unknown=0.0, related=0.7):
    """n padded window pairs with qlen in [0, lq], dlen in [0, ld]: mostly
    a mutated copy of the query with an indel, unknown residues (20) at
    rate ``unknown``."""
    q = np.full((n, lq), 20, np.int32)
    d = np.full((n, ld), 20, np.int32)
    ql = rng.integers(0, lq + 1, n).astype(np.int32)
    dl = rng.integers(0, ld + 1, n).astype(np.int32)
    for r in range(n):
        a = rng.integers(0, 20, ql[r])
        if rng.random() < related and ql[r] > 8:
            b = a.copy()
            b[rng.integers(0, ql[r], ql[r] // 6)] = rng.integers(0, 20,
                                                                 ql[r] // 6)
            cut = int(rng.integers(2, ql[r] - 2))
            b = np.concatenate([b[:cut], b[cut + int(rng.integers(1, 4)):]])
            b = np.concatenate([b, rng.integers(0, 20, ld)])[:dl[r]]
        else:
            b = rng.integers(0, 20, dl[r])
        q[r, :ql[r]] = np.where(rng.random(ql[r]) < unknown, 20, a)
        d[r, :dl[r]] = np.where(rng.random(dl[r]) < unknown, 20, b)
    return q, ql, d, dl


CASES = {"ragged": (60, 70, 80, 0.0), "d_longer": (40, 20, 300, 0.0),
         "q_longer": (40, 200, 24, 0.05), "unknown": (16, 30, 30, 1.0)}


def _t(x, dev="cpu"):
    return torch.as_tensor(x, device=dev)


def _plain(q, ql, d, dl, drop, band, **kw):
    return gapped_device.banded_scores_plain(
        _t(q), _t(ql), _t(d), _t(dl), _t(SUB), 11, 1, drop, band, **kw)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("band", [0, 4, 32, 127])
def test_warp_model_equals_plain(case, band):
    """The kernel's algorithm == the plain version for every pair, and
    scans exactly the rows the plain version's stats_out counts."""
    n, lq, ld, unk = CASES[case]
    rng = np.random.default_rng(band * 7 + len(case))
    q, ql, d, dl = _windows(rng, n, lq, ld, unk)
    for drop in (0, 7, 1 << 20):
        st: dict = {}
        want = [x.numpy() for x in _plain(q, ql, d, dl, drop, band,
                                          stats_out=st)]
        got = np.array([banded_warp(q[r], ql[r], d[r, :], dl[r], SUB, 11,
                                    1, drop, band) for r in range(n)])
        for k in range(3):
            np.testing.assert_array_equal(got[:, k], want[k],
                                          err_msg=f"output {k}, drop {drop}")
        np.testing.assert_array_equal(got[:, 3], st["rows"].numpy())


@pytest.mark.parametrize("band", [4, 16, 32])
@pytest.mark.parametrize("drop", [0, 7, 1 << 20])
def test_plain_equals_jax(band, drop):
    import jax.numpy as jnp

    from hsearch_tpu.align import gapped_device as jgd
    rng = np.random.default_rng(band + drop % 97)
    for case in ("ragged", "d_longer", "q_longer", "unknown"):
        q, ql, d, dl = _windows(rng, *CASES[case])
        got = _plain(q, ql, d, dl, drop, band)
        want = jgd.banded_scores(jnp.asarray(q), jnp.asarray(ql),
                                 jnp.asarray(d), jnp.asarray(dl),
                                 jnp.asarray(SUB), 11, 1, drop, band)
        for g, w_ in zip(got, want):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w_),
                                          err_msg=case)


@pytest.mark.parametrize("drop", [30, 1 << 20])
def test_plain_equals_host_traceback(drop):
    """Score and, where positive, extents of the traceback scorer (the
    port's host library), as tests/test_gapped_device.py holds the JAX
    package's scorer to its native library."""
    rng = np.random.default_rng(drop % 1000)
    q, ql, d, dl = _windows(rng, 30, 90, 90, related=1.0)
    score, qe, de = (x.numpy() for x in _plain(q, ql, d, dl, drop, 16))
    n_pos = 0
    for r in range(len(q)):
        res = native_ext.align_gapped(q[r, :ql[r]], d[r, :dl[r]], SUB, 11,
                                      1, drop, 16)
        if res is None:                 # an empty sequence: no alignment
            assert score[r] == 0
            continue
        assert score[r] == res[0], r
        if res[0] > 0:
            n_pos += 1
            assert (qe[r], de[r]) == (res[2], res[3]), r
    assert n_pos > 20


def test_qlen_varying_across_the_batch():
    """Each pair's result is its result alone: the batch scored at once
    equals each pair scored by itself (the kernel stops each pair at its
    own qlen and death row, the plain version scans every pair to Lq)."""
    rng = np.random.default_rng(3)
    q, ql, d, dl = _windows(rng, 40, 120, 130)
    ql[::5] = 120
    ql[1::5] = 1
    ql[2::5] = 0
    whole = [x.numpy() for x in _plain(q, ql, d, dl, 27, 32)]
    for r in range(len(q)):
        one = _plain(q[r:r + 1, :max(ql[r], 1)], ql[r:r + 1], d[r:r + 1],
                     dl[r:r + 1], 27, 32)
        assert [int(x[0]) for x in one] == [int(x[r]) for x in whole], r


def test_wrapper_takes_the_plain_version_on_cpu():
    rng = np.random.default_rng(4)
    q, ql, d, dl = _windows(rng, 30, 50, 60)
    ck.reset_launches()
    got = gapped_device.banded_scores(_t(q), _t(ql), _t(d), _t(dl), _t(SUB),
                                      11, 1, 27, 32)
    also = ck.banded_scores(_t(q), _t(ql), _t(d), _t(dl), _t(SUB), 11, 1,
                            27, 32)
    want = _plain(q, ql, d, dl, 27, 32)
    assert all(torch.equal(a, b) and torch.equal(b, c)
               for a, b, c in zip(got, also, want))
    assert ck.launch_counts()["banded_scores"] == 0


def test_empty_batch():
    q = torch.zeros((0, 7), dtype=torch.int32)
    d = torch.zeros((0, 9), dtype=torch.int32)
    n = torch.zeros(0, dtype=torch.int32)
    out = gapped_device.banded_scores(q, n, d, n, _t(SUB), 11, 1, 27, 32)
    assert [tuple(x.shape) for x in out] == [(0,)] * 3
    assert all(x.dtype == torch.int32 for x in out)


def _no_build(monkeypatch):
    def fail(*a, **k):
        raise AssertionError("a kernel was built")
    monkeypatch.setattr(ck, "build", fail)
    monkeypatch.setattr(ck, "_lib", fail)


@pytest.mark.parametrize("bad", ["band", "negative_band", "gap_order",
                                 "gap_size", "drop", "q_dtype",
                                 "qlen_dtype", "sub_dtype"])
def test_unsupported_arguments_raise_before_any_build(monkeypatch, bad):
    """Tensors off the CPU take the kernel's path (``meta`` tensors stand
    in for a card here): what the kernel cannot take raises first."""
    _no_build(monkeypatch)
    meta = dict(device="meta")
    q = torch.empty((4, 10), dtype=torch.int32, **meta)
    ln = torch.empty(4, dtype=torch.int32, **meta)
    sub = torch.empty((21, 21), dtype=torch.int32, **meta)
    args = dict(q=q, qlen=ln, d=q, dlen=ln, sub21=sub, gap_open=11,
                gap_ext=1, drop=27, band=32)
    args.update({"band": dict(band=128), "negative_band": dict(band=-1),
                 "gap_order": dict(gap_open=1, gap_ext=2),
                 "gap_size": dict(gap_open=1 << 20),
                 "drop": dict(drop=(1 << 30) + 1),
                 "q_dtype": dict(q=q.long()),
                 "qlen_dtype": dict(qlen=ln.long()),
                 "sub_dtype": dict(sub21=sub.float())}[bad])
    err = TypeError if bad.endswith("dtype") else ValueError
    with pytest.raises(err):
        ck.banded_scores(**args)
    assert ck.launch_counts()["banded_scores"] == 0


def test_non_cpu_tensors_never_fall_back(monkeypatch):
    """Valid arguments off the CPU and off a card raise: the kernel's
    path never computes elsewhere."""
    _no_build(monkeypatch)
    q = torch.empty((4, 10), dtype=torch.int32, device="meta")
    ln = torch.empty(4, dtype=torch.int32, device="meta")
    sub = torch.empty((21, 21), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        gapped_device.banded_scores(q, ln, q, ln, sub, 11, 1, 27, 32)


def test_refine_gapped_all_reaches_the_wrapper(monkeypatch):
    """The --gapped refinement scores its windows through
    ``cuda_kernels.banded_scores`` (on the card, the kernel)."""
    from hsearch_tpu_torch.examples.bench_align import protein_families
    calls = []
    real = ck.banded_scores
    monkeypatch.setattr(ck, "banded_scores", lambda *a, **k:
                        calls.append(a[0].shape) or real(*a, **k))
    db, _ = protein_families(16, seed=2)
    s = pipeline.ProteinSearcher(db, device="cpu")
    queries = [(db.protein(0), s.search_sequence(db.protein(0)))]
    assert queries[0][1]
    pipeline.refine_gapped_all(s, queries)
    assert len(calls) == 1


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_banded_bound_by_hand():
    """2 pairs of 3 x 4 residues: 4 * (6 + 8 + 4 + 441 + 6) = 1,860 bytes;
    band 127 (255 lanes) and 100 rows scanned: 24 * 100 * 255 = 612,000
    int32 operations at 64 * 132 * 1.98e9 per second, which bound it;
    with no row scanned, the bytes do."""
    cs = _chip_smoke()
    ms, by = cs.banded_bound(2, 3, 4, 255, 100)
    assert by == "operations"
    assert ms == pytest.approx(612_000 / (64 * 132 * 1.98e9) * 1e3,
                               rel=1e-12)
    ms, by = cs.banded_bound(2, 3, 4, 255, 0)
    assert by == "bytes" and ms == pytest.approx(1860 / 3.35e12 * 1e3,
                                                 rel=1e-12)


# ---- on the card -------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("band", [0, 4, 16, 32, 127])
def test_kernel_equals_plain_on_cuda(case, band):
    dev = _cuda()
    rng = np.random.default_rng(band + 100 * len(case))
    q, ql, d, dl = (_t(x, dev) for x in _windows(rng, *CASES[case]))
    sub = _t(SUB, dev)
    for drop in (0, 7, 30, 1 << 20):
        before = ck.banded_scores.launches
        got = gapped_device.banded_scores(q, ql, d, dl, sub, 11, 1, drop,
                                          band)
        assert ck.banded_scores.launches == before + 1
        want = gapped_device.banded_scores_plain(q, ql, d, dl, sub, 11, 1,
                                                 drop, band)
        for g, w_ in zip(got, want):
            assert torch.equal(g, w_), (case, band, drop)
