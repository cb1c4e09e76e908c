"""The span and counter readers on a synthetic Chrome trace (times in
us)."""

import pytest

from benchmark import spans
from benchmark.registry import Registry
from benchmark.run import LayerContext


def _ev(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


EVENTS = [
    _ev("user_annotation", "ivf.search", 0, 100),
    _ev("user_annotation", "ivf.select", 10, 10),
    _ev("cuda_runtime", "cudaLaunchKernel", 12, 2, corr=1),
    _ev("cuda_driver", "cuLaunchKernel", 16, 2, corr=2),
    _ev("user_annotation", "ivf.host_d2", 60, 30),
    # launched outside any ivf.select span, though it runs during one
    _ev("cuda_runtime", "cudaLaunchKernel", 30, 2, corr=3),
    _ev("kernel", "void gatherTopK(x)", 40, 8, corr=1),
    _ev("kernel", "void sort(x)", 48, 4, corr=2),
    _ev("kernel", "prune_kernel(x)", 52, 20, corr=3),
    # a memcpy correlated with a launch inside the span is not a kernel
    _ev("gpu_memcpy", "Memcpy DtoH", 72, 3, corr=2),
    _ev("user_annotation", "ivf.search", 200, 50),
    _ev("user_annotation", "ivf.select", 210, 5),
    _ev("cuda_runtime", "cudaLaunchKernel", 211, 1, corr=4),
    _ev("kernel", "void gatherTopK(x)", 230, 6, corr=4),
    _ev("user_annotation", "ivf.host_d2", 240, 10),
]


def _ctx(events, batches=2, stats=()):
    return LayerContext(events=events, summary={}, window_s=1.0,
                        batches=batches, launches={}, stats=list(stats))


def test_kernels_matched_to_launches_inside_the_span():
    n, secs = spans.kernels_under(EVENTS, "ivf.select")
    # gatherTopK twice and the sort; not prune, launched outside
    assert n == 3 and secs == pytest.approx(18e-6)
    n, secs = spans.kernels_under(EVENTS, "ivf.search")
    assert n == 4 and secs == pytest.approx(38e-6)
    assert spans.kernels_under(EVENTS, "ivf.verify") is None


def test_per_batch_normalisation():
    ctx = _ctx(EVENTS, batches=2)
    assert spans.span_ms_per_batch(ctx, "ivf.host_d2") == \
        pytest.approx(40e-3 / 2)
    assert spans.kernel_ms_per_batch(ctx, "ivf.select") == \
        pytest.approx(18e-3 / 2)
    ctx = _ctx(EVENTS, batches=2, stats=[{"d2h_bytes": 100},
                                         {"d2h_bytes": 300}])
    assert spans.counter_per_batch(ctx, "d2h_bytes") == 200


def test_nothing_to_read_is_none():
    bare = [e for e in EVENTS if e["cat"] != "user_annotation"]
    ctx = _ctx(bare, stats=[{"seg_walls_s": [0.01]}] * 2)
    assert spans.span_ms_per_batch(ctx, "ivf.host_d2") is None
    assert spans.kernel_ms_per_batch(ctx, "ivf.select") is None
    assert spans.counter_per_batch(ctx, "d2h_bytes") is None
    # a span that launched no kernel (the CPU's trace)
    cpu = [e for e in EVENTS if e["cat"] == "user_annotation"]
    assert spans.kernel_ms_per_batch(_ctx(cpu), "ivf.select") is None
    assert spans.span_ms_per_batch(_ctx(EVENTS, batches=0),
                                   "ivf.host_d2") is None


@pytest.mark.parametrize("name,want", [
    ("ivf.host_d2_ms", 40e-3 / 2),
    ("ivf.select_ms", 18e-3 / 2),
    ("ivf.enqueue_ms", None),
    ("ivf.centers_ms", None),
    ("ivf.d2h_bytes_per_batch", 200.0),
    ("ivf.h2d_bytes_per_batch", 1000.0),
    ("stream.upload_wait_ms", None),
])
def test_readers_by_name(name, want):
    stats = [{"d2h_bytes": 100, "h2d_bytes": 1000},
             {"d2h_bytes": 300, "h2d_bytes": 1000}]
    got = Registry().layer_metric(name).read(_ctx(EVENTS, 2, stats))
    assert got == (pytest.approx(want) if want is not None else None)
