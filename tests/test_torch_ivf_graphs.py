"""``ivf.search``'s center-block chain replayed from CUDA graphs.

On the CPU a stand-in for the capture (``_fake_capture``: each step run
once into the tensors it leaves, and rerun into those same tensors on every
replay, as a graph writes its outputs at fixed addresses) exercises the
cache's policy: no capture on a key's first call, a capture on its second,
replays from its third; a new key for each changed part; nothing for a
fresh index; the cache freed with its index and bounded to two keys; a
capture out of memory left eager; segments never captured; and a CPU
index without the stand-in as before.  On a machine with a CUDA device the real graphs are
held bitwise against the eager chain.  The CUDA cases need neither jax nor
tests/conftest.py:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_ivf_graphs.py
"""

import dataclasses
import warnings
import weakref

import numpy as np
import pytest
import torch

from hsearch_tpu_torch.ops import cuda_kernels as ck
from hsearch_tpu_torch.search import exact, ivf, stream


def _family_db(rng, n, c, l, family_size=32):
    nfam = max(1, n // family_size)
    fam = rng.integers(0, 20, (nfam, l), dtype=np.int32)
    db = fam[rng.integers(0, nfam, n)].copy()
    flips = rng.random((n, l)) < 0.08
    db[flips] = rng.integers(0, 20, int(flips.sum()))
    return db, fam[rng.choice(nfam, c, replace=False)]


def _fake_capture(steps, v, dev):
    """The CPU stand-in for ``ivf._capture_cuda``: runs each step once
    (the capture) and returns replays that rerun it on the captured input
    tensors and copy the results into the captured output tensors."""
    _fake_capture.calls += 1
    replays = []
    for name, step in steps:
        ins = dict(v)
        step(v)
        outs = {k: t for k, t in v.items() if ins.get(k) is not t}

        def replay(step=step, ins=ins, outs=outs):
            w = dict(ins)
            step(w)
            for k, t in outs.items():
                t.copy_(w[k])
        replays.append((name, replay))
    return replays


@pytest.fixture
def graphs_on_cpu(monkeypatch):
    """Open the graph path on the CPU with the stand-in capture."""
    _fake_capture.calls = 0
    monkeypatch.setitem(ivf._CAPTURE, "cpu", _fake_capture)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    db, centers = _family_db(rng, 4096, 100, 25)
    return db, centers


def _index(db, dev="cpu", block_size=8):
    return ivf.build_index(db, torch.Generator().manual_seed(0),
                           block_size=block_size, device=dev)


# a packed buffer with room for every hit: no re-dispatch
BASE = dict(radius=35.0, k_blocks=16, max_hits=128, center_block=32,
            pack_cap_frac=1, approx_select=False, transfer_d2=None)


def _search(idx, centers, **kw):
    kw = {**BASE, **kw}
    st: dict = {}
    out = ivf.search(idx, centers, kw.pop("radius"), retry_overflow=False,
                     stats_out=st, **kw)
    return out, st


def _counts(st):
    return st["graph_captures"], st["graph_replays"]


def _same(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def test_capture_on_second_call_replay_from_third(data, graphs_on_cpu):
    db, centers = data
    idx = _index(db)
    eager = _search(_index(db), centers[:32])[0]
    seen = []
    for _ in range(4):
        out, st = _search(idx, centers[:32])
        _same(out, eager)
        seen.append(_counts(st))
    assert seen == [(0, 0), (1, 0), (0, 1), (0, 1)]
    assert _fake_capture.calls == 1


# each changes one part of the key but the radius's float64 tail, which
# float32 does not hold
@pytest.mark.parametrize("change,new_key", [
    (dict(radius=30.0), True),
    (dict(radius=35.0 + 1e-9), False),
    (dict(k_blocks=8), True),
    (dict(center_block=16), True),
    (dict(max_hits=64), True),
    (dict(pack_cap_frac=2), True),
    (dict(transfer_d2=True), True),
    (dict(approx_select=True), True),
])
def test_each_part_of_the_key(data, graphs_on_cpu, monkeypatch, change,
                              new_key):
    db, centers = data
    # the approximate select acts only where ``_approximates`` says so
    monkeypatch.setattr(ivf, "_approximates", lambda dev: True)
    idx = _index(db)
    for _ in range(3):
        _search(idx, centers[:16])
    want = _search(_index(db), centers[:16], **change)[0]
    got = [_search(idx, centers[:16], **change) for _ in range(2)]
    for out, _ in got:
        _same(out, want)
    if new_key:
        assert [_counts(st) for _, st in got] == [(0, 0), (1, 0)]
    else:
        assert [_counts(st) for _, st in got] == [(0, 1), (0, 1)]


def test_fresh_index_never_captures(data, graphs_on_cpu):
    db, centers = data
    idx = _index(db)
    for _ in range(3):
        fresh = dataclasses.replace(idx)
        assert _counts(_search(fresh, centers[:32])[1]) == (0, 0)
    assert _fake_capture.calls == 0


def test_cache_is_freed_with_its_index(data, graphs_on_cpu):
    db, centers = data
    idx = _index(db)
    for _ in range(3):
        _search(idx, centers[:32])
    (entry,) = vars(idx)["_block_graphs"].values()
    assert entry.replays is not None
    gone = weakref.ref(entry)
    packed = weakref.ref(entry.v["packed"])
    del idx, entry
    # freed by reference counting, with no collector pass: the cache
    # holds no cycle back to its index
    assert gone() is None and packed() is None


def test_multi_block_calls_equal_eager(data, graphs_on_cpu):
    """100 centers in blocks of 32 (the last one padded): the second block
    captures, the later ones replay, and each block's outputs survive the
    replays queued after it; then another radius, a new key."""
    db, centers = data
    idx = _index(db)
    ref = _index(db)
    with pytest.MonkeyPatch.context() as mp:
        mp.delitem(ivf._CAPTURE, "cpu")
        eager = [_search(ref, centers, radius=r) for r in (35.0, 35.0, 35.0,
                                                           30.0)]
    got = [_search(idx, centers, radius=r) for r in (35.0, 35.0, 35.0, 30.0)]
    for (out, st), (want, st_want) in zip(got, eager):
        _same(out, want)
        assert {k: v for k, v in st.items() if not k.startswith("graph_")} \
            == {k: v for k, v in st_want.items()
                if not k.startswith("graph_")}
        assert _counts(st_want) == (0, 0)
    assert [_counts(st) for _, st in got] == [(1, 2), (0, 4), (0, 4), (1, 2)]


def test_redispatch_stays_exact(graphs_on_cpu):
    """A packed capacity too small for the hits re-dispatches the block
    every call, eagerly: the hits stay those of a roomy buffer."""
    rng = np.random.default_rng(3)
    n, c, l = 512, 16, 10
    db, _ = _family_db(rng, n, c, l, family_size=8)
    centers = db[rng.choice(n, c, replace=False)]
    idx = _index(db, block_size=16)
    kw = dict(radius=1e3, k_blocks=idx.num_blocks, max_hits=n,
              center_block=16)
    want, _ = _search(_index(db, block_size=16), centers, pack_cap_frac=1,
                      **kw)
    assert len(want[0]) == c * n
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = [_search(idx, centers, pack_cap_frac=4096, **kw)
               for _ in range(4)]
    for out, _ in got:
        _same(out, want)
    # each call: the block at cap 4096 from its graphs, then its eager
    # re-dispatch at cap 1
    assert [_counts(st) for _, st in got] == [(0, 0), (1, 0), (0, 1),
                                               (0, 1)]
    assert len(vars(idx)["_block_graphs"]) == 1


def test_cpu_index_stays_eager(data):
    db, centers = data
    idx = _index(db)
    want = exact.search_radius(db, centers, 35.0, device="cpu")
    first = None
    for _ in range(3):
        st: dict = {}
        out = ivf.search(idx, centers, 35.0, k_blocks=idx.num_blocks,
                         max_hits=4096, center_block=32, stats_out=st)
        assert _counts(st) == (0, 0)
        assert "_block_graphs" not in vars(idx)
        assert set(zip(*out[:2])) == set(zip(*want[:2]))
        if first is not None:
            _same(out, first)
        first = out


def test_segmented_sums_the_graph_counters(data, graphs_on_cpu):
    """Segments never capture: at device budget 0 each is a fresh index per
    search, and resident ones stay eager, since the residency budget plans
    no graph pool for them; the segments' counters are summed all the
    same."""
    db, centers = data
    for budget in (0, 1 << 40):
        sidx = stream.build_segmented(db, torch.Generator().manual_seed(0),
                                      segment_points=1024, block_size=16,
                                      device_budget_bytes=budget,
                                      device="cpu")
        seen = []
        for _ in range(3):
            st: dict = {}
            stream.search_segmented(sidx, centers[:32], 35.0, k_blocks=16,
                                    max_hits=64, center_block=32,
                                    retry_overflow=False, stats_out=st)
            seen.append(_counts(st))
        assert seen == [(0, 0)] * 3
        assert _fake_capture.calls == 0
        resident = [seg for seg in sidx.resident if seg is not None]
        assert len(resident) == (4 if budget else 0)
        for seg in resident:
            assert vars(seg)["_block_graphs"] is None


def test_cache_keeps_the_last_two_keys(data, graphs_on_cpu):
    """Searched at five radii, three calls each and then the first radius
    again, an index keeps the two keys it used last: an older key's
    graphs and outputs are freed, and it starts over as a new key."""
    db, centers = data
    idx = _index(db)
    gone = []
    for r in (35.0, 34.0, 33.0, 32.0, 31.0, 35.0):
        want = _search(_index(db), centers[:32], radius=r)[0]
        seen = []
        for _ in range(3):
            out, st = _search(idx, centers[:32], radius=r)
            _same(out, want)
            seen.append(_counts(st))
        assert seen == [(0, 0), (1, 0), (0, 1)]
        cache = vars(idx)["_block_graphs"]
        assert len(cache) <= 2
        gone.append(weakref.ref(next(reversed(cache.values())).v["packed"]))
    assert _fake_capture.calls == 6
    # the entries of 35, 34, 33 and 32 were dropped; 31 and the new 35 stay
    assert [g() is None for g in gone] == [True] * 4 + [False] * 2


def test_capture_out_of_memory_stays_eager(data, graphs_on_cpu,
                                           monkeypatch):
    """A capture the card has no memory for leaves its key eager: the
    search still returns the eager hits, counts no capture, and the
    launches counted while capturing come off the kernels' counts."""
    db, centers = data

    def no_memory(steps, v, dev):
        _fake_capture.calls += 1
        ck.sq_distance_prune.launches += 1       # as a capture counts it
        raise torch.OutOfMemoryError("no room for the graphs' pool")

    monkeypatch.setitem(ivf._CAPTURE, "cpu", no_memory)
    idx = _index(db)
    want = _search(_index(db), centers[:32])[0]
    before = ck.launch_counts()
    for _ in range(4):
        out, st = _search(idx, centers[:32])
        _same(out, want)
        assert _counts(st) == (0, 0)
    assert _fake_capture.calls == 1
    assert ck.launch_counts() == before
    (entry,) = vars(idx)["_block_graphs"].values()
    assert entry.replays == [] and entry.v == {}


# ---- on the card -----------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.fixture
def card_data():
    dev = _cuda()
    rng = np.random.default_rng(11)
    db, centers = _family_db(rng, 1 << 16, 100, 25)
    return dev, db, centers


def _eager_runs(idx, centers, radii, **kw):
    with pytest.MonkeyPatch.context() as mp:
        mp.delitem(ivf._CAPTURE, "cuda")
        return [_search(idx, centers, radius=r, **kw) for r in radii]


@pytest.mark.cuda
def test_graph_replay_equals_eager_on_cuda(card_data):
    dev, db, centers = card_data
    idx = _index(db, dev, block_size=32)
    radii = (35.0, 35.0, 35.0, 30.0)
    eager = _eager_runs(idx, centers, radii)
    got = [_search(idx, centers, radius=r) for r in radii]
    assert len(eager[0][0][0]) > 1000
    for (out, st), (want, st_want) in zip(got, eager):
        _same(out, want)
        assert {k: v for k, v in st.items() if not k.startswith("graph_")} \
            == {k: v for k, v in st_want.items()
                if not k.startswith("graph_")}
    assert [_counts(st) for _, st in got] == [(1, 2), (0, 4), (0, 4), (1, 2)]


@pytest.mark.cuda
def test_redispatch_stays_exact_on_cuda(card_data):
    dev, db, centers = card_data
    idx = _index(db, dev, block_size=32)
    kw = dict(max_hits=512, k_blocks=64, pack_cap_frac=64)
    eager = _eager_runs(idx, centers, (60.0,) * 4, **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = [_search(idx, centers, radius=60.0, **kw) for _ in range(4)]
    for (out, _), (want, _) in zip(got, eager):
        _same(out, want)
    (big, _), = _eager_runs(idx, centers, (60.0,), max_hits=512,
                            k_blocks=64, pack_cap_frac=1)
    _same(got[-1][0], big)
    # the blocks overflowed their packed buffers (3 header words, 2 x 32
    # meta, 32 x 512 / 64 hits) and were re-dispatched; the main chain
    # replayed in each of the 4 blocks
    assert got[-1][1]["d2h_bytes"] > 4 * 4 * (3 + 2 * 32 + 32 * 512 // 64)
    assert got[-1][1]["graph_replays"] >= 4


@pytest.mark.cuda
def test_launch_counts_advance_per_replay_on_cuda(card_data):
    dev, db, centers = card_data
    idx = _index(db, dev, block_size=32)
    _eager_runs(idx, centers[:32], (35.0,))
    ck.reset_launches()
    _eager_runs(idx, centers[:32], (35.0,))
    per_call = ck.launch_counts()
    assert per_call["sq_distance_prune"] == per_call["ptable_verify"] == 1
    for want in [(0, 0), (1, 0), (0, 1), (0, 1)]:
        ck.reset_launches()
        assert _counts(_search(idx, centers[:32])[1]) == want
        assert ck.launch_counts() == per_call


@pytest.mark.cuda
def test_capture_takes_memory_the_allocator_holds_on_cuda(card_data):
    """A capture whose pool needs more than the card has free, while the
    caching allocator holds the rest unallocated (as after a large earlier
    search), still captures: the cached memory is handed back first."""
    dev, db, centers = card_data
    idx = _index(db, dev, block_size=32)
    # a block of 1,024 centers verifying every block: a (1024, 65536) f32
    # verify output and its negation, ~0.5 GiB of working memory
    c = np.resize(centers, (1024, centers.shape[1]))
    kw = dict(k_blocks=idx.num_blocks, max_hits=64, center_block=1024)
    want = _eager_runs(idx, c, (35.0,), **kw)[0][0]
    try:
        free, _ = torch.cuda.mem_get_info(dev)
        torch.empty(free - (128 << 20), dtype=torch.uint8, device=dev)
        got = [_search(idx, c, **kw) for _ in range(3)]
    finally:
        torch.cuda.empty_cache()
    assert [_counts(st) for _, st in got] == [(0, 0), (1, 0), (0, 1)]
    for out, _ in got:
        _same(out, want)


@pytest.mark.cuda
def test_segmented_budget_zero_never_replays_on_cuda(card_data):
    dev, db, centers = card_data
    sidx = stream.build_segmented(db, torch.Generator().manual_seed(0),
                                  segment_points=1 << 14, block_size=32,
                                  device_budget_bytes=0, device=dev)
    for _ in range(3):
        st: dict = {}
        stream.search_segmented(sidx, centers, 35.0, k_blocks=64,
                                max_hits=512, center_block=128,
                                retry_overflow=False, stats_out=st)
        assert st["graph_replays"] == st["graph_captures"] == 0
        assert st["segments"] == 4


@pytest.mark.cuda
def test_memory_stays_bounded_over_many_radii_on_cuda(card_data):
    """One index searched at six radii, three calls each, with a block
    whose working memory is ~0.5 GiB: the card holds the pools of the two
    keys used last, not one per radius, and every call's hits are the
    eager chain's."""
    dev, db, centers = card_data
    idx = _index(db, dev, block_size=32)
    c = np.resize(centers, (1024, centers.shape[1]))
    kw = dict(k_blocks=idx.num_blocks, max_hits=64, center_block=1024)
    radii = (35.0, 34.0, 33.0, 32.0, 31.0, 30.0)
    eager = _eager_runs(idx, c, radii, **kw)
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_reserved(dev)
    reserved = []
    for r, (want, _) in zip(radii, eager):
        got = [_search(idx, c, radius=r, **kw) for _ in range(3)]
        assert [_counts(st) for _, st in got] == [(0, 0), (1, 0), (0, 1)]
        for out, _ in got:
            _same(out, want)
        reserved.append(torch.cuda.memory_reserved(dev))
    pool = reserved[0] - base
    assert pool > 256 << 20
    assert len(vars(idx)["_block_graphs"]) == 2
    assert max(reserved) <= base + 2 * pool + (64 << 20), (base, reserved)


@pytest.mark.cuda
def test_segmented_resident_never_captures_on_cuda(card_data):
    """Device budget > 0: the resident segments are searched again in
    every call, in blocks of 32, and still run eagerly, since the
    residency budget plans no graph pool; the hits are those of budget
    0."""
    dev, db, centers = card_data
    out = {}
    for budget in (0, 1 << 30):
        sidx = stream.build_segmented(db, torch.Generator().manual_seed(0),
                                      segment_points=1 << 14, block_size=32,
                                      device_budget_bytes=budget, device=dev)
        for _ in range(3):
            st: dict = {}
            out[budget] = stream.search_segmented(
                sidx, centers, 35.0, k_blocks=64, max_hits=512,
                center_block=32, retry_overflow=False, stats_out=st)
            assert st["graph_replays"] == st["graph_captures"] == 0
        assert st["resident_fraction"] == (1.0 if budget else 0.0)
    _same(out[1 << 30], out[0])


@pytest.mark.cuda
def test_capture_out_of_memory_runs_eagerly_on_cuda(card_data, monkeypatch):
    """A capture that runs out of the card's memory (forced: its first
    step asks for more than the card has free) leaves its key eager: the
    search returns the eager hits and the kernels' launch counts of an
    eager call."""
    dev, db, centers = card_data
    idx = _index(db, dev, block_size=32)
    want = _eager_runs(idx, centers[:32], (35.0,))[0][0]
    ck.reset_launches()
    _eager_runs(idx, centers[:32], (35.0,))
    per_call = ck.launch_counts()
    real = ivf._CAPTURE["cuda"]

    def too_big(steps, v, dev):
        (name, step), *rest = steps

        def hog(v, step=step):
            free, _ = torch.cuda.mem_get_info(dev)
            v["hog"] = torch.empty(free + (1 << 30), dtype=torch.uint8,
                                   device=dev)
            step(v)
        return real([(name, hog)] + rest, v, dev)

    monkeypatch.setitem(ivf._CAPTURE, "cuda", too_big)
    for _ in range(4):
        ck.reset_launches()
        out, st = _search(idx, centers[:32])
        _same(out, want)
        assert _counts(st) == (0, 0)
        assert ck.launch_counts() == per_call
    (entry,) = vars(idx)["_block_graphs"].values()
    assert entry.replays == []
