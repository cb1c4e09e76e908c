"""The LSH engine as the benchmark's ``pfam25-lsh`` deployment runs it,
held against the plain reference on the CPU at small sizes.

``motif.search`` is compared with ``benchmark/reference.py``'s
``radius_hits`` (float64 brute force that imports nothing of the port):
at a lossless operating point the hit sets are equal; at the
configuration's K/L/W/P on a tiny drawn database every hit is a true hit
with its distance and the weighted recall clears the configuration's
limit.  Its counters are held against hand counts from the index's
tables, and its spans and the cell's per-layer readers against a CPU
trace.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import devtrace, judge, reference, workload
from benchmark.hitlog import HitLog
from benchmark.registry import Registry
from benchmark.run import LayerContext
from hsearch_tpu_torch.ops import compact
from hsearch_tpu_torch.search import motif
from hsearch_tpu_torch.utils import host_heap, profiling

ROOT = Path(__file__).resolve().parents[1]
CFG = json.loads((ROOT / "benchmark" / "configs" / "pfam25-lsh.json")
                 .read_text())
CPU = torch.device("cpu")
N_ROWS, POOL = 4096, 32
# above every bucket of 4,096 rows: the cell's cand_max is sized for 2^22
TINY_CAND_MAX = 128

POINTS = {
    # name: (hash_k, hash_l, w, probes, cand_max, hit set equal to truth)
    "lossless": (2, 2, 1e5, 4, N_ROWS, True),
    "pfam25-lsh": (CFG["hash_k"], CFG["hash_l"], CFG["w"], CFG["probes"],
                   TINY_CAND_MAX, False),
}


@pytest.fixture(scope="module")
def data():
    cfg = dict(CFG, n_rows=N_ROWS, pool=POOL)
    d = workload.family_db(cfg, workload.seeds(2 ** 31 + 19).data, CPU)
    truth = reference.radius_hits(d.db, d.pool, CFG["radius"])
    return d, truth


def _index(d, point, center_block=8):
    k, t, w, p, cm, _ = point
    conf = motif.MotifSearchConfig(hash_k=k, hash_l=t, w=w,
                                   radius=CFG["radius"], probes=p,
                                   center_block=center_block,
                                   max_hits=CFG["max_hits"], cand_max=cm)
    index = motif.build_index(d.db.numpy(), torch.Generator().manual_seed(5),
                              conf, cand_max=cm, device=CPU)
    return index, conf


@pytest.mark.parametrize("point", sorted(POINTS))
def test_search_against_plain_reference(data, point):
    d, truth = data
    index, conf = _index(d, POINTS[point])
    stats: dict = {}
    ci, ki, dist = motif.search(index, d.pool_np, conf, stats_out=stats)
    assert stats["truncated"] == 0 and stats["skewed"] == 0
    tc, tr, td2 = (x.numpy() for x in truth)
    want = dict(zip(zip(tc.tolist(), tr.tolist()), td2.tolist()))
    got = list(zip(ci.tolist(), ki.tolist()))
    assert len(got) == len(set(got)), "a (center, k-mer) pair twice"
    assert set(got) <= set(want)
    r2 = CFG["radius"] ** 2
    err = np.abs(dist.astype(np.float64) ** 2
                 - np.array([want[g] for g in got])) / r2
    assert err.max(initial=0.0) <= 1e-5
    if POINTS[point][-1]:
        assert set(got) == set(want)
    log = HitLog(N_ROWS)
    log.add(np.arange(POOL), (ci, ki, dist))
    num = judge.compare(log, truth, d.db, d.pool, CFG["radius"])
    assert num["duplicates"] == 0 and num["outside_truth"] == 0
    assert num["hit_error"] <= CFG["correct"]["hit_error_max"]
    assert num["recall"] >= CFG["correct"]["recall_min"]


def _hand_counts(index, conf, centers):
    """(slots, distinct ids) over ``centers`` from the index's tables."""
    q = motif._query_codes(index, torch.as_tensor(centers), True,
                           conf.probes).numpy()
    q = q.reshape(len(centers), index.tables.num_tables, -1)
    codes = index.tables.sorted_codes.numpy()
    perm = index.tables.perm.numpy()
    slots = distinct = 0
    for c in range(len(centers)):
        ids = set()
        for t in range(q.shape[1]):
            for code in q[c, t]:
                bucket = perm[t][codes[t] == code][:index.cand_max]
                slots += len(bucket)
                ids.update(bucket.tolist())
        distinct += len(ids)
    return slots, distinct


@pytest.mark.parametrize("n_centers", [8, 13])
def test_counters_equal_hand_counts(data, n_centers):
    """13 centers in blocks of 8: the padding centers count nowhere."""
    d, _ = data
    index, conf = _index(d, POINTS["pfam25-lsh"], center_block=8)
    centers = d.pool_np[:n_centers]
    stats: dict = {}
    motif.search(index, centers, conf, stats_out=stats)
    slots, distinct = _hand_counts(index, conf, centers)
    assert stats["cand_slots"] == slots
    assert stats["cand_distinct"] == distinct
    # each block ships one fused buffer: header, four meta vectors, and a
    # word and a d2 per hit slot of its capacity
    blocks = -(-n_centers // 8)
    k = min(conf.max_hits, conf.hash_l * conf.probes * index.cand_max)
    cap = 8 * k // 4
    assert stats["d2h_bytes"] == blocks * 4 * (3 + 4 * 8 + 2 * cap)
    packed, _, _ = motif._probe_verify(
        index, torch.as_tensor(centers[:8]),
        motif._query_codes(index, torch.as_tensor(centers[:8]), True,
                           conf.probes), 1.0, index.cand_max, conf.max_hits)
    assert packed.numel() == 3 + 4 * 8 + 2 * cap
    _, metas = compact.unpack_hits(packed.numpy(), (8,) * 4)
    assert len(metas) == 4 and all(len(m) == 8 for m in metas)


LSH_SPANS = ("lsh.search", "lsh.centers", "lsh.block", "lsh.codes",
             "lsh.candidates", "lsh.verify", "lsh.top_hits", "lsh.pack",
             "lsh.d2h", "lsh.unpack")
# the cell's readers: those of host spans and counters read numbers on the
# CPU, those of CUDA kernels find none there
READERS = {"lsh.enqueue_ms": True, "lsh.verified_per_batch": True,
           "lsh.candidates_ms": False, "lsh.top_hits_ms": False,
           "lsh.verify_roofline": False}


@pytest.fixture(scope="module")
def traced(data, tmp_path_factory):
    d, _ = data
    index, conf = _index(d, POINTS["pfam25-lsh"], center_block=8)
    stats = []
    with profiling.device_trace(str(tmp_path_factory.mktemp("tr"))) as path:
        for b in range(2):
            st: dict = {}
            motif.search(index, d.pool_np[8 * b:8 * (b + 1)], conf,
                         stats_out=st)
            stats.append(st)
    events = devtrace.load_events(path)
    ctx = LayerContext(events=events, summary=devtrace.trace_summary(events),
                       window_s=1.0, batches=2, launches={}, stats=stats,
                       shapes=[{"C": 8, "kb": conf.hash_l * conf.probes
                                * index.cand_max, "bs": 1, "L": 25}] * 2)
    return ctx


@pytest.mark.parametrize("name", LSH_SPANS)
def test_span_in_trace(traced, name):
    from benchmark import spans
    iv = spans.span_intervals(traced.events, name)
    assert len(iv) >= 2 and all(b >= a for a, b in iv)


@pytest.mark.parametrize("name", sorted(READERS))
def test_cell_reader_on_cpu_trace(traced, name):
    value = Registry().layer_metric(name).read(traced)
    if READERS[name]:
        assert value is not None and value > 0
    else:
        assert value is None
    if name == "lsh.verified_per_batch":
        assert value == sum(s["cand_distinct"] for s in traced.stats) / 2


def test_counters_ride_the_packed_buffer(data, monkeypatch):
    """The counters come from the packed buffers' meta: one read back per
    center block, each unpacked with its four meta vectors."""
    d, _ = data
    index, conf = _index(d, POINTS["pfam25-lsh"], center_block=8)
    calls = []
    real_unpack = compact.unpack_hits

    def unpack(packed, meta_lens=()):
        calls.append(len(meta_lens))
        return real_unpack(packed, meta_lens)

    monkeypatch.setattr(compact, "unpack_hits", unpack)
    st: dict = {}
    motif.search(index, d.pool_np[:16], conf, stats_out=st)
    assert calls == [4, 4] and st["cand_distinct"] > 0


class _Libc:
    """A C library whose ``mallopt`` records its calls and answers
    ``answer`` (glibc: 1 taken, 0 refused)."""

    def __init__(self, answer):
        self.answer, self.calls = answer, []

    def mallopt(self, param, value):
        self.calls.append((param, value))
        return self.answer


HELD = [(host_heap.M_MMAP_THRESHOLD, host_heap.MMAP_THRESHOLD),
        (host_heap.M_TRIM_THRESHOLD, host_heap.TRIM_THRESHOLD)]


def test_search_holds_the_host_heap_once(data, monkeypatch):
    """The first search sets both thresholds; later calls set nothing."""
    d, _ = data
    index, conf = _index(d, POINTS["pfam25-lsh"], center_block=8)
    libc = _Libc(1)
    monkeypatch.setattr(host_heap, "_held", None)
    monkeypatch.setattr(host_heap.ctypes, "CDLL", lambda name: libc)
    for _ in range(2):
        motif.search(index, d.pool_np[:8], conf, stats_out={})
    assert libc.calls == HELD and host_heap.hold()


@pytest.mark.parametrize("libc, held", [
    ("glibc", True), (_Libc(0), False), (object(), False)],
    ids=["glibc", "refused", "no-mallopt"])
def test_hold_reports_the_heap_state(monkeypatch, recwarn, libc, held):
    """True where this process's glibc takes both values; False, with a
    warning, where it refuses one; False, silently, with no mallopt."""
    monkeypatch.setattr(host_heap, "_held", None)
    if libc != "glibc":
        monkeypatch.setattr(host_heap.ctypes, "CDLL", lambda name: libc)
    assert host_heap.hold() is held
    assert len(recwarn) == isinstance(libc, _Libc)
