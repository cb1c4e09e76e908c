"""Read the program's own spans and counters over the traced window.

A span is ``hsearch_tpu_torch.utils.profiling.span``: a ``user_annotation``
event of the ``torch.profiler`` trace, on the clock of the device's events.
The device work a span caused is found through its launches: every CUDA
runtime or driver call that launches a kernel carries a ``correlation`` id,
and so does the kernel it launched; a kernel counts for a span when its
launch call lies inside one of the span's intervals.

Every reader returns None where the trace or the counters hold nothing of
what it reads (a program without the span or counter).
"""

from __future__ import annotations

import bisect

from benchmark import devtrace

SPAN_CAT = "user_annotation"
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def span_intervals(events: list, name: str) -> list:
    """(start, end) in us of every span named ``name``, in start order."""
    return sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                  if e.get("cat") == SPAN_CAT and e.get("name") == name)


def kernels_under(events: list, name: str):
    """(kernels, device seconds) of the kernels launched from inside a
    span named ``name``, or None where no such span is in the trace."""
    iv = devtrace._merged(span_intervals(events, name))
    if not iv:
        return None
    starts = [a for a, _ in iv]
    corr = set()
    for e in events:
        if e.get("cat") not in LAUNCH_CATS:
            continue
        j = bisect.bisect_right(starts, e["ts"]) - 1
        c = e.get("args", {}).get("correlation")
        if j >= 0 and e["ts"] <= iv[j][1] and c is not None:
            corr.add(c)
    ks = [e["dur"] for e in events if e.get("cat") == "kernel"
          and e.get("args", {}).get("correlation") in corr]
    return len(ks), sum(ks) / 1e6


def span_ms_per_batch(ctx, name: str):
    """Milliseconds per traced batch spent in spans named ``name``."""
    iv = span_intervals(ctx.events, name)
    if not iv or not ctx.batches:
        return None
    return sum(b - a for a, b in iv) / 1e3 / ctx.batches


def kernel_ms_per_batch(ctx, name: str):
    """Device milliseconds per traced batch of the kernels launched from
    inside spans named ``name``."""
    got = kernels_under(ctx.events, name)
    if got is None or not got[0] or not ctx.batches:
        return None
    return 1e3 * got[1] / ctx.batches


def counter_per_batch(ctx, key: str):
    """The program's counter ``stats_out[key]`` summed over the traced
    batches, per batch."""
    vals = [st[key] for st in ctx.stats if key in st]
    if not vals or not ctx.batches:
        return None
    return sum(vals) / ctx.batches
