"""The port's spans and transfer counters (utils/profiling.span,
search/ivf.search, search/stream.search_segmented), on the CPU.

Spans are read as the benchmark reads them: from the Chrome trace that
``torch.profiler`` exports, as ``user_annotation`` events, a span's parent
being the innermost span that holds it on the same host thread.
"""

import contextlib
import json

import numpy as np
import pytest
import torch

from hsearch_tpu_torch.ops import compact
from hsearch_tpu_torch.search import exact, ivf, stream
from hsearch_tpu_torch.utils import profiling

L, BS = 10, 16
BLOCK_SPANS = ("ivf.prune", "ivf.select", "ivf.verify", "ivf.top_hits",
               "ivf.pack")


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


def _traced(tmp_path, fn):
    """(fn's result, [(span name, parent span name or None)]) from the
    exported trace of one call, in start order."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    spans = sorted((e for e in json.loads(path.read_text())["traceEvents"]
                    if e.get("cat") == "user_annotation"),
                   key=lambda e: e["ts"])
    tree = []
    for e in spans:
        holders = [p for p in spans if p is not e
                   and p.get("tid") == e.get("tid")
                   and p["ts"] <= e["ts"]
                   and e["ts"] + e["dur"] <= p["ts"] + p["dur"]]
        parent = min(holders, key=lambda p: p["dur"]) if holders else None
        tree.append((e["name"], parent["name"] if parent else None))
    return out, tree


def _count(tree, name, parent=None):
    return sum(1 for n, p in tree if n == name
               and (parent is None or p == parent))


@pytest.fixture
def small(rng):
    db, centers = _family_db(rng, 4096, 40, L)
    idx = ivf.build_index(db, torch.Generator().manual_seed(0),
                          block_size=BS, device="cpu")
    return db, centers, idx


def test_search_spans_nest_per_center_block(small, tmp_path):
    _, centers, idx = small
    kw = dict(k_blocks=64, max_hits=256, center_block=16,  # 3 blocks
              retry_overflow=False, stats_out={})
    got, tree = _traced(tmp_path, lambda: ivf.search(idx, centers, 30.0,
                                                     **kw))
    assert _pairs(got) == _pairs(ivf.search(idx, centers, 30.0, **kw))
    assert tree[0] == ("ivf.search", None)
    assert _count(tree, "ivf.search") == 1
    for name in ("ivf.centers", "ivf.assemble"):
        assert _count(tree, name, "ivf.search") == 1
    for name in ("ivf.block", "ivf.d2h", "ivf.unpack", "ivf.host_d2"):
        assert _count(tree, name) == _count(tree, name, "ivf.search") == 3
    for name in BLOCK_SPANS:
        assert _count(tree, name) == _count(tree, name, "ivf.block") == 3
    for name in ("ivf.redispatch", "ivf.retry"):
        assert _count(tree, name) == 0


def test_retry_nests_its_search(small, tmp_path):
    db, centers, idx = small
    st: dict = {}
    got, tree = _traced(tmp_path, lambda: ivf.search(
        idx, centers, 30.0, k_blocks=2, max_hits=256, center_block=16,
        retry_overflow=True, stats_out=st))
    assert st["retried"] > 0
    assert _pairs(got) == _pairs(exact.search_radius(db, centers, 30.0,
                                                     device="cpu"))
    assert tree[0] == ("ivf.search", None)
    assert _count(tree, "ivf.retry", "ivf.search") >= 1
    assert _count(tree, "ivf.search") == 1 + st["retry_depth"]
    assert _count(tree, "ivf.search", "ivf.retry") == st["retry_depth"]


def test_segmented_spans_per_segment(rng, tmp_path):
    db, centers = _family_db(rng, 4096, 24, L)
    sidx = stream.build_segmented(db, torch.Generator().manual_seed(0),
                                  segment_points=1024, block_size=BS,
                                  device="cpu")
    st: dict = {}
    kw = dict(k_blocks=64, max_hits=512, retry_overflow=False)
    got, tree = _traced(tmp_path, lambda: stream.search_segmented(
        sidx, centers, 30.0, stats_out=st, **kw))
    assert _pairs(got) == _pairs(stream.search_segmented(
        sidx, centers, 30.0, **kw))
    assert tree[0] == ("stream.search_segmented", None)
    assert _count(tree, "stream.search_segmented") == 1
    assert _count(tree, "stream.segment", "stream.search_segmented") == 4
    assert _count(tree, "ivf.search") == \
        _count(tree, "ivf.search", "stream.segment") == 4
    # segment 0 is uploaded before its search, each later one while the
    # search before it runs (queued once that search's blocks are)
    assert _count(tree, "stream.upload", "stream.search_segmented") == 1
    assert _count(tree, "stream.upload", "ivf.search") == 3
    # the wait for an upload is on the device only
    assert _count(tree, "stream.adopt") == 0
    assert "upload_wait_ms" not in st


def test_span_off_is_one_shared_null_context():
    assert not profiling.recording()
    a, b = profiling.span("ivf.search"), profiling.span("x")
    assert a is b and isinstance(a, contextlib.nullcontext)
    with a:
        pass
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert profiling.recording()
        assert profiling.span("x") is not a


def _phase(name):
    with profiling.phase(name):
        with profiling.span("inner"):
            torch.ones(4).sum()


def test_phase_emits_its_span(tmp_path):
    profiling.reset()
    _, tree = _traced(tmp_path, lambda: _phase("pcluster/outer"))
    assert ("pcluster/outer", None) in tree
    assert ("inner", "pcluster/outer") in tree
    assert profiling.report()["pcluster/outer"]["count"] == 1
    profiling.reset()


def _packed_sizes(monkeypatch):
    """Bytes of every buffer ``compact.pack_hits`` makes from here on."""
    sizes = []
    real = compact.pack_hits

    def spy(*a, **kw):
        out = real(*a, **kw)
        sizes.append(out.numel() * out.element_size())
        return out
    monkeypatch.setattr(compact, "pack_hits", spy)
    return sizes


def test_transfer_counters_equal_the_buffers(small, monkeypatch):
    db, centers, idx = small
    c, cb, mh, kb = len(centers), 16, 256, 64
    nblk = -(-c // cb)
    st: dict = {}
    want = ivf.search(idx, centers, 30.0, k_blocks=kb, max_hits=mh,
                      center_block=cb, retry_overflow=False, stats_out=st)
    # 1-word layout: header, n_hits and n_alive, cap = cb * k // 4 words
    k = min(mh, kb * BS)
    assert st["d2h_bytes"] == nblk * 4 * (3 + 2 * cb + cb * k // 4)
    # padded int32 centers and their float32 embedding (8 per residue)
    assert st["h2d_bytes"] == nblk * cb * L * 4 + nblk * cb * 8 * L * 4
    # a capacity too small for the hits: each block is re-dispatched
    sizes = _packed_sizes(monkeypatch)
    st = {}
    got = ivf.search(idx, centers, 30.0, k_blocks=kb, max_hits=mh,
                     center_block=cb, retry_overflow=False, stats_out=st,
                     pack_cap_frac=4096)
    assert len(sizes) > nblk and st["d2h_bytes"] == sum(sizes)
    assert _pairs(got) == _pairs(want)
    # the retry's transfers are counted with the first pass's
    sizes.clear()
    st = {}
    ivf.search(idx, centers, 30.0, k_blocks=2, max_hits=mh,
               center_block=cb, retry_overflow=True, stats_out=st)
    assert st["retried"] > 0 and st["d2h_bytes"] == sum(sizes)
    assert st["h2d_bytes"] > nblk * cb * 9 * L * 4


def test_segmented_counters_sum_the_segments(rng):
    db, centers = _family_db(rng, 4096, 24, L)
    kw = dict(segment_points=1024, block_size=BS, device="cpu")
    dry = stream.build_segmented(db, torch.Generator().manual_seed(0), **kw)
    budget = sum(stream.segment_device_bytes(s) for s in dry.segments[:1])
    sidx = stream.build_segmented(db, torch.Generator().manual_seed(0),
                                  device_budget_bytes=budget, **kw)
    assert [r is not None for r in sidx.resident] == [True] + [False] * 3
    st: dict = {}
    stream.search_segmented(sidx, centers, 30.0, k_blocks=64, max_hits=512,
                            retry_overflow=False, stats_out=st)
    seg_st = []
    for seg, res in zip(sidx.segments, sidx.resident):
        one: dict = {}
        ivf.search(res if res is not None else stream.upload_segment(
            seg, "cpu"), centers, 30.0, k_blocks=64, max_hits=512,
            retry_overflow=False, stats_out=one)
        seg_st.append(one)
    assert st["d2h_bytes"] == sum(s["d2h_bytes"] for s in seg_st)
    # the centers once per segment, and the three streamed segments
    assert st["h2d_bytes"] == sum(s["h2d_bytes"] for s in seg_st) + sum(
        s.nbytes for s in sidx.segments[1:])
