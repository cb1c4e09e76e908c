"""Phase timing and device tracing (counterpart of
hsearch_tpu/utils/profiling.py).

The reference prints clock() spans around every phase
(motif_both_points.cpp:373,384-386, pcluster util.hpp:179-186); here a
``phase`` context accumulates wall-clock per named phase into a registry
that ``report`` reads, and ``device_trace`` wraps ``torch.profiler``.

``span`` names a stretch of host code in the profiler's trace: while a
``torch.profiler`` trace records, each span lands in it as a
``user_annotation`` event on the same clock as the device's kernels and
copies, nested in the span that encloses it on the same host thread.
Nothing else turns spans on, and a span never synchronises the device;
with no trace recording it costs one flag test.
"""

from __future__ import annotations

import contextlib
import functools
import os
import sys
import time
from collections import defaultdict

import torch

_REGISTRY: dict[str, list[float]] = defaultdict(list)
# what ``span`` returns while no trace records: one shared no-op context
_OFF = contextlib.nullcontext()


def heartbeat(msg: str) -> None:
    """Opt-in progress line (HSEARCH_PROGRESS=1) on stderr, timestamped,
    for runs that are otherwise silent until they finish."""
    if os.environ.get("HSEARCH_PROGRESS", "0") != "1":
        return
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


def _fence() -> None:
    """Wait for queued device work (CPU tensors compute synchronously)."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def recording() -> bool:
    """Whether a ``torch.profiler`` trace is recording in this process."""
    return torch.autograd._profiler_enabled()


def span(name: str):
    """Context manager naming the enclosed host code ``name`` in the
    recording ``torch.profiler`` trace (``record_function``); the shared
    no-op context while none records.

    with profiling.span("ivf.select"):
        neg, blk_ids = _cascade_top_blocks(key, gmin, kb)
    """
    if torch.autograd._profiler_enabled():
        return torch.autograd.profiler.record_function(name)
    return _OFF


def spanned(name: str):
    """Decorator: each call of the function is the span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


@contextlib.contextmanager
def phase(name: str, *, sync: bool = False):
    """Time a phase, and name it as a ``span`` in a recording trace; with
    sync=True wait for queued device work before and after, so the span
    holds the phase's device time.

    with profiling.phase("pcluster/klsh_codes", sync=True):
        codes = klsh_codes_all(...)
    """
    if sync:
        _fence()
    t0 = time.perf_counter()
    try:
        with span(name):
            yield
    finally:
        if sync:
            _fence()
        _REGISTRY[name].append(time.perf_counter() - t0)


def add(name: str, seconds: float) -> None:
    """Record an already-measured span."""
    _REGISTRY[name].append(seconds)


def report() -> dict[str, dict]:
    """{phase: {count, total_s, mean_s}} for all recorded phases."""
    return {k: {"count": len(v), "total_s": sum(v),
                "mean_s": sum(v) / len(v)}
            for k, v in _REGISTRY.items() if v}


def reset() -> None:
    _REGISTRY.clear()


def print_report(file=None) -> None:
    for name, st in sorted(report().items()):
        print(f"[TIME] {name}: total {st['total_s']:.3f}s over "
              f"{st['count']} calls (mean {st['mean_s'] * 1000:.1f}ms)",
              file=file)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """torch.profiler trace of the enclosed block (CPU, and CUDA when a
    device is present), written as Chrome JSON to ``log_dir/trace.json``;
    yields that path.

    The way to trace a search: the trace holds the program's spans
    (``ivf.search`` and its center blocks, ``stream.search_segmented`` and
    its segments, every ``phase``) beside the device's kernels and copies,
    on one clock, and is written when the block ends.

    with profiling.device_trace("traces") as path:
        ivf.search(index, centers, radius)
    """
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    with profile(activities=acts) as prof:
        yield path
        _fence()
    prof.export_chrome_trace(path)
