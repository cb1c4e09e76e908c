"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (timed as ``setup_s`` from the start of this process): the data
drawn on the card from ``--seed``, the engine's index built, and the
cell's own batch shape warmed up.  Then one client sends batches for
``--seconds`` (closed loop: each batch is due when the previous one
returned); each batch is timed from when it was due until its hits are on
the host.  With ``--trace 1`` a steady part of the window runs under
``torch.profiler`` and the per-layer metrics are read from that trace and
the program's counters instead of the end-to-end ones.

Once the window has closed and the program's state is freed, every hit
the window returned is judged against the plain reference (judge.py).  The
last line of standard output is one JSON object: ``correct``,
``attempted`` and ``failed`` (batches), ``metrics``, ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``, each number compared
beside its limit (also the last lines of standard error).

Exits non-zero, printing no result, without enough CUDA devices, or if
``jax``, ``jaxlib``, ``flax`` or ``hsearch_tpu`` was imported.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# as a script, this folder is sys.path[0]: the checkout's root takes its
# place, so the harness and the program import as packages and no module
# here shadows one of the standard library
if sys.path and Path(sys.path[0] or ".").resolve() == HERE:
    sys.path[0] = str(ROOT)
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "hsearch_tpu")
#: host threads of torch's and OpenMP's pools in a run: fixed, so that a
#: run does not size them from the machine it lands on
HOST_THREADS = 4
# the traced part of a --trace 1 window: from this share of the window on,
# for at most TRACE_SECONDS
TRACE_FROM, TRACE_SECONDS = 1 / 3, 4.0


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@dataclass
class LayerContext:
    """What a per-layer reader reads: the traced window's device events
    and their summary, its batches, the program's kernel launch counts
    and counters over it, and the launch shapes of its calls."""

    events: list
    summary: dict
    window_s: float
    batches: int
    launches: dict
    stats: list
    shapes: list = field(default_factory=list)


class Tracer:
    """torch.profiler over whole batches of a steady part of the window."""

    def __init__(self, seconds: float):
        self.start_at = seconds * TRACE_FROM
        self.length = min(TRACE_SECONDS, seconds * TRACE_FROM)
        self.prof = None
        self.on = self.off = None
        self.first = self.last = None
        self.launch0 = self.launch1 = None

    def before(self, elapsed: float, i: int) -> None:
        if self.prof is None and elapsed >= self.start_at:
            from torch.profiler import ProfilerActivity, profile

            from hsearch_tpu_torch.ops import cuda_kernels
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.start()
            self.launch0 = cuda_kernels.launch_counts()
            self.first = i
            self.on = time.perf_counter()

    def after(self, i: int, force: bool = False) -> None:
        if self.prof is None or self.off is not None:
            return
        now = time.perf_counter()
        if force or now - self.on >= self.length:
            from hsearch_tpu_torch.ops import cuda_kernels
            self.off = now
            self.last = i
            self.launch1 = cuda_kernels.launch_counts()
            self.prof.stop()


def power_limit() -> str | None:
    """The card's power limit as nvidia-smi reports it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60)
        return out.stdout.splitlines()[0].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def _metrics(entries: list, cell: str, values: dict) -> dict:
    """The ``entries`` of BENCHMARK.json that this cell reports, with the
    values found for them (a metric whose reader found nothing is left
    out)."""
    out = {}
    for m in entries:
        if "workloads" in m and cell not in m["workloads"]:
            continue
        v = values.get(m["name"])
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def run_cell(reg, wl: dict, seed: int, seconds: float, trace: bool,
             device, t_start: float = T_START, wrap=None) -> dict:
    """Set-up, window, trace and judgement of one run of cell ``wl`` on
    ``device``; returns the result object.  ``wrap(engine, data)``, when
    given, stands in for the engine (the fault tests break the timed path
    with it)."""
    import torch

    from benchmark import devtrace, judge, reference, workload
    from benchmark.hitlog import HitLog

    spec = reg.spec()
    cfg = reg.config(wl["config"])
    trf = reg.traffic(wl["traffic"])
    s = workload.seeds(seed)
    data = workload.family_db(cfg, s.data, device)
    engine = reg.engine(cfg["engine"]).make(cfg, trf, data, s, device)
    if wrap is not None:
        engine = wrap(engine, data)
    sched = workload.Schedule(trf, len(data.pool_np), s.traffic)
    warm = int(trf["warmup_batches"])
    for i in range(warm):
        t = time.perf_counter()
        hits = engine.search(data.pool_np[sched.batch(i)])
        t = time.perf_counter() - t
    # room for the window's hits at the last warm-up batch's rate, and half
    # as much again
    log_ = HitLog(data.db.shape[0], reserve=int(
        1.5 * len(hits[0]) * seconds / max(t, 1e-4))) if warm else \
        HitLog(data.db.shape[0])
    del hits
    if trace:
        # the profiler's first start initialises its tracing library:
        # done here, in set-up, and not inside the traced window
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU]
                     + ([ProfilerActivity.CUDA] if device.type == "cuda"
                        else [])):
            torch.ones(1, device=device).add_(1)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start

    lat, stats = [], []
    failed = 0
    tracer = Tracer(seconds) if trace else None
    i = warm
    # no collector pauses inside the window: collected now, off until it
    # closes
    gc.collect()
    gc.disable()
    t0 = prev_done = time.perf_counter()
    while True:
        due = prev_done              # closed loop: due when the last returned
        if tracer is not None:
            tracer.before(time.perf_counter() - t0, i)
        ids = sched.batch(i)
        try:
            out = engine.search(data.pool_np[ids])
        except Exception:        # an answer that never came: counted
            if not failed:
                log(traceback.format_exc())
            failed += 1
            out = None
        done = time.perf_counter()
        lat.append(done - due)
        stats.append(engine.stats)
        if out is not None:
            log_.add(ids, out)
            del out
        if tracer is not None:
            tracer.after(i)
        prev_done = done
        i += 1
        if done - t0 >= seconds:
            break
    window_s = prev_done - t0
    gc.enable()
    if tracer is not None:
        tracer.after(i - 1, force=True)
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    batch_shapes = engine.call_shapes(sched.batch_size)
    engine.close()
    del engine
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    e2e = {"queries_per_s": sched.batch_size * len(log_.sent) / window_s,
           "batch_p95_ms": 1e3 * workload.percentile(lat, 95),
           "setup_s": setup_s}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device)
           if device.type == "cuda" else "cpu",
           "count": int(wl["chips"]), "memory_peak_bytes": int(peak)}
    if device.type == "cuda":
        dev["power_limit"] = power_limit()
    result = {"correct": False, "attempted": len(lat), "failed": failed}
    breakdown = None
    per_layer = {}
    if tracer is not None and tracer.prof is not None:
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "trace.json"
            tracer.prof.export_chrome_trace(str(path))
            events = devtrace.load_events(path)
        tracer.prof = None
        summary = devtrace.trace_summary(events)
        traced = range(tracer.first - warm, tracer.last - warm + 1)
        shapes = [sh for _ in traced for sh in batch_shapes]
        ctx = LayerContext(
            events=events, summary=summary,
            window_s=tracer.off - tracer.on, batches=len(traced),
            launches={k: tracer.launch1[k] - tracer.launch0[k]
                      for k in tracer.launch1},
            stats=[stats[j] for j in traced], shapes=shapes)
        for m in spec["per_layer"]:
            if "workloads" in m and wl["name"] not in m["workloads"]:
                continue
            per_layer[m["name"]] = reg.layer_metric(m["name"]).read(ctx)
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = ctx.window_s
        breakdown = {"device_ops": devtrace.device_ops(events),
                     "idle_gaps": devtrace.idle_gaps(events)}
        del events, ctx

    truth = reference.radius_hits(data.db, data.pool, cfg["radius"])
    numbers = judge.compare(log_, truth, data.db, data.pool, cfg["radius"])
    checks = judge.checks(numbers, failed, cfg)
    e2e["weighted_recall"] = numbers["recall"]
    result["correct"] = bool(log_.sent) and all(c["ok"]
                                              for c in checks.values())
    if trace:
        result["metrics"] = _metrics(spec["per_layer"], wl["name"],
                                     per_layer)
    else:
        result["metrics"] = _metrics(spec["end_to_end"], wl["name"], e2e)
    result["device"] = dev
    if breakdown is not None:
        result["breakdown"] = breakdown
    over = {k: sum(int(st.get(k, 0)) for st in stats)
            for k in ("over_blocks", "over_hits", "retried")}
    n3 = len(lat) // 3
    thirds = [round(1e3 * workload.percentile(lat[k * n3:(k + 1) * n3], 50),
                    6) for k in range(3)]
    log(f"# {wl['name']} seed={seed} batches={len(lat)} "
        f"window_s={window_s:.6f} setup_s={setup_s:.6f} "
        f"hits={numbers['hits']} outside_truth={numbers['outside_truth']} "
        f"true_hits_sent={numbers['true_hits_sent']} {json.dumps(over)} "
        f"latency_ms p50={1e3 * workload.percentile(lat, 50):.6f} "
        f"max={1e3 * max(lat):.6f} p50_by_third_ms={thirds} "
        f"e2e={json.dumps(e2e)} "
        f"per_layer={json.dumps(per_layer)} card={dev['kind']} "
        f"power_limit={dev.get('power_limit')}")
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    os.environ["OMP_NUM_THREADS"] = str(HOST_THREADS)
    from benchmark.registry import Registry
    reg = Registry()
    wl = reg.workload(args.workload)
    import torch
    torch.set_num_threads(HOST_THREADS)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(wl["chips"]):
        log(f"{args.workload} needs {wl['chips']} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            "; no result")
        return 2
    result = run_cell(reg, wl, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0))
    loaded = sorted({m.partition(".")[0] for m in list(sys.modules)}
                    & set(FORBIDDEN))
    if loaded:
        log(f"modules of the JAX stack were imported: {loaded}; no result")
        return 3
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r} "
            f"{'ok' if c['ok'] else 'FAILED'}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
