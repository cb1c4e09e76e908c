"""The trace reduction on a synthetic Chrome trace (times in us)."""

import json

import pytest

from benchmark import devtrace


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


EVENTS = [
    _ev("kernel", "(anonymous namespace)::prune_kernel(x)", 0, 10),
    _ev("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 5, 20),
    _ev("kernel", "void (anonymous namespace)::verify_kernel<true>(x)", 20,
        10),
    _ev("cpu_op", "aten::topk", 31, 15),
    _ev("kernel", "(anonymous namespace)::prune_kernel(x)", 50, 10),
    _ev("cpu_op", "aten::cat", 60, 2),
    _ev("cuda_runtime", "cudaStreamSynchronize", 62, 8),
]


def test_summary_kernels_and_copies(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": EVENTS + [
        {"ph": "i", "name": "instant", "ts": 1}]}))
    events = devtrace.load_events(path)
    assert len(events) == len(EVENTS)
    s = devtrace.trace_summary(events)
    # device busy: [0, 30] and [50, 60]
    assert s["busy_s"] == pytest.approx(40e-6)
    assert s["kernels"] == 3 and s["h2d_copies"] == 1
    assert s["h2d_s"] == pytest.approx(20e-6)
    # the copy [5, 25] lies under kernels over [5, 10] and [20, 25]
    assert s["h2d_under_kernels_s"] == pytest.approx(10e-6)
    assert devtrace.kernel_time(events, "prune_kernel") == \
        (2, pytest.approx(20e-6))
    ops = devtrace.device_ops(events)
    assert ops[0][0].startswith("(anonymous namespace)::prune_kernel")
    assert ops[0][1] == pytest.approx(20e-6)


def test_idle_gaps_by_host_op():
    gaps = dict(devtrace.idle_gaps(EVENTS))
    # [30, 50]: topk covers 15 of 20 us; [60, 70]: the sync covers 8 of 10
    assert gaps == {"aten::topk": pytest.approx(20e-6),
                    "cudaStreamSynchronize": pytest.approx(10e-6)}


def test_idle_gap_outside_torch_ops():
    events = [_ev("kernel", "k", 0, 10), _ev("cpu_op", "aten::to", 8, 4),
              _ev("kernel", "k", 30, 10)]
    assert devtrace.idle_gaps(events) == [
        ["outside torch ops after aten::to", pytest.approx(20e-6)]]
    assert devtrace.intervals_union([(0, 2), (1, 3), (5, 6)]) == 4


def test_copies_of_the_upload_stream_only():
    def on(e, stream):
        return dict(e, args={"stream": stream})
    events = [
        on(_ev("kernel", "prune_kernel", 0, 10), 7),
        on(_ev("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 5, 20), 9),
        on(_ev("kernel", "bounds_kernel(x)", 25, 5), 9),
        # the search's own upload of its centers, on the main stream
        on(_ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 40, 4), 7),
    ]
    # the side stream's copy [5, 25] lies under prune over [5, 10]
    secs, under = devtrace.stream_copies_under_kernels(events,
                                                       "bounds_kernel")
    assert secs == pytest.approx(20e-6) and under == pytest.approx(5e-6)
    assert devtrace.stream_copies_under_kernels(events, "nothing") is None
