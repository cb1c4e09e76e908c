"""Reduce a ``torch.profiler`` Chrome trace of the traced window to device
busy time, copies under kernels, kernel time by name and idle gaps by
what the host was doing (``intervals_union`` and ``trace_summary`` are
copied from ``chip_smoke.py``'s ``_intervals_union`` and
``_trace_summary``).
"""

from __future__ import annotations

import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")


def load_events(path) -> list:
    """The complete ("X") events of a Chrome trace file."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def intervals_union(iv) -> float:
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, -float("inf")
    for a, b in sorted(iv):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def _merged(iv) -> list:
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def trace_summary(events: list) -> dict:
    """Device busy seconds (union of every kernel, copy and memset
    interval), kernel count, host-to-device copy seconds and the part of
    them that lies under kernels running at the same time."""
    dev_ev = [e for e in events if e.get("cat") in DEVICE_CATS]
    kern = [(e["ts"], e["ts"] + e["dur"]) for e in dev_ev
            if e["cat"] == "kernel"]
    h2d = [(e["ts"], e["ts"] + e["dur"]) for e in dev_ev
           if e["cat"] == "gpu_memcpy" and "HtoD" in e["name"]]
    busy = intervals_union([(e["ts"], e["ts"] + e["dur"]) for e in dev_ev])
    merged_k = _merged(kern)
    under = 0.0
    for a, b in h2d:
        under += intervals_union([(max(a, ka), min(b, kb))
                                  for ka, kb in merged_k if ka < b and kb > a])
    return {"busy_s": busy / 1e6, "kernels": len(kern),
            "h2d_copies": len(h2d),
            "h2d_s": sum(b - a for a, b in h2d) / 1e6,
            "h2d_under_kernels_s": under / 1e6}


def _stream(e: dict):
    """The CUDA stream of a device event: its ``args`` say, and the
    trace's thread of a device event is its stream too."""
    return e.get("args", {}).get("stream", e.get("tid"))


def stream_copies_under_kernels(events: list, kernel_part: str):
    """(seconds, seconds under kernels) of the host-to-device copies on
    the streams that run the kernels whose name holds ``kernel_part``, or
    None where no such kernel ran: the copies of one side stream, apart
    from the other uploads of the traced window."""
    streams = {_stream(e) for e in events
               if e.get("cat") == "kernel" and kernel_part in e["name"]}
    streams.discard(None)
    if not streams:
        return None
    copies = [(e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("cat") == "gpu_memcpy" and "HtoD" in e["name"]
              and _stream(e) in streams]
    merged_k = _merged([(e["ts"], e["ts"] + e["dur"]) for e in events
                        if e.get("cat") == "kernel"])
    under = 0.0
    for a, b in copies:
        under += intervals_union([(max(a, ka), min(b, kb))
                                  for ka, kb in merged_k if ka < b and kb > a])
    return sum(b - a for a, b in copies) / 1e6, under / 1e6


def kernel_time(events: list, name_part: str):
    """(launches, device seconds) of the kernels whose name holds
    ``name_part``."""
    ks = [e for e in events
          if e.get("cat") == "kernel" and name_part in e.get("name", "")]
    return len(ks), sum(e["dur"] for e in ks) / 1e6


def device_ops(events: list, top: int = 10) -> list:
    """[name, seconds] of the device operations that took most time."""
    by: dict = {}
    for e in events:
        if e.get("cat") in DEVICE_CATS:
            name = e["name"][:120]
            by[name] = by.get(name, 0.0) + e["dur"] / 1e6
    return [[k, v] for k, v in sorted(by.items(), key=lambda x: -x[1])[:top]]


def idle_gaps(events: list, top: int = 10) -> list:
    """[label, seconds] of the device's idle time within the trace, summed
    by what the host was doing: each gap between device operations takes
    the name of the host op (torch op or CUDA call) that covers most of
    it, or, where none covers half of it, "outside torch ops after" the
    torch op that ended last before the gap's end."""
    dev = _merged([(e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") in DEVICE_CATS])
    host = sorted(((e["ts"], e["ts"] + e["dur"], e["name"], e["cat"])
                   for e in events if e.get("cat") in HOST_CATS),
                  key=lambda x: x[0])
    if not dev or not host:
        return []
    t0 = min(dev[0][0], host[0][0])
    t1 = max(max(b for _, b in dev), max(h[1] for h in host))
    gaps, cur = [], t0
    for a, b in dev + [[t1, t1]]:
        if a > cur:
            gaps.append((cur, a))
        cur = max(cur, b)
    by: dict = {}
    active: list = []
    i = 0
    last_end, last_name = -float("inf"), "trace start"
    for a, b in gaps:
        while i < len(host) and host[i][0] < b:
            active.append(host[i])
            i += 1
        active = [h for h in active if h[1] > a]
        best, best_ov = None, 0.0
        for s, e, name, _ in active:
            ov = min(e, b) - max(s, a)
            if ov > best_ov or (ov == best_ov and best is not None
                                and e - s < best[1] - best[0]):
                best, best_ov = (s, e, name), ov
        for s, e, name, cat in host[max(0, i - 64):i]:
            if cat == "cpu_op" and last_end < e <= b:
                last_end, last_name = e, name
        if best is not None and best_ov >= 0.5 * (b - a):
            label = best[2]
        else:
            label = f"outside torch ops after {last_name}"
        by[label] = by.get(label, 0.0) + (b - a) / 1e6
    return [[k, v] for k, v in sorted(by.items(), key=lambda x: -x[1])[:top]]
