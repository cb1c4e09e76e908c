"""Readings for the limits of ``correct`` and the one-off k_blocks sweep.

    python3 benchmark/calibrate.py --config pfam25-resident \
        --traffic batch1024,batch32 --seeds 1,2,3 [--kb 128,256,512] \
        [--control] [--out calibrate.jsonl]

For each seed: the data and the engine as a run builds them, the plain
reference's exact hits of the pool, then one pass of each traffic's
batches over the whole pool at each k_blocks (default: the
configuration's), judged as a run judges its window (``judge.compare``).
With ``--control`` the control is judged too: the reference put in the
program's place and computed one precision lower (``precision="tf32"``).
One JSON line per reading on standard output (and appended to ``--out``).
The benchmark's own runs never run this; it needs a CUDA device unless
``--device cpu`` is given.
"""

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if sys.path and Path(sys.path[0] or ".").resolve() == HERE:
    sys.path[0] = str(ROOT)
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def one_pass(engine, sched, pool_np):
    """The pool once, in the traffic's batches: [(pool ids, hits)]."""
    out = []
    for i in range(-(-len(pool_np) // sched.batch_size)):
        ids = sched.batch(i)
        out.append((ids, engine.search(pool_np[ids])))
    return out


def calibrate(reg, config: str, traffics: list, seeds: list, kbs: list,
              control: bool, device, emit) -> None:
    import numpy as np
    import torch

    from benchmark import judge, reference, workload
    from benchmark.hitlog import HitLog

    cfg = reg.config(config)
    trfs = {t: reg.traffic(t) for t in traffics}
    for seed in seeds:
        s = workload.seeds(seed)
        t0 = time.perf_counter()
        data = workload.family_db(cfg, s.data, device)
        engine = reg.engine(cfg["engine"]).make(cfg, trfs[traffics[0]],
                                                data, s, device)
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        truth = reference.radius_hits(data.db, data.pool, cfg["radius"])
        ref_s = time.perf_counter() - t0
        base = {"config": config, "seed": seed, "build_s": build_s,
                "reference_s": ref_s, "true_hits": int(truth[0].numel())}
        for kb in kbs or [cfg["k_blocks"]]:
            for name, trf in trfs.items():
                engine.k_blocks = kb
                engine.center_block = int(trf["center_block"])
                sched = workload.Schedule(trf, len(data.pool_np), s.traffic)
                one_pass(engine, sched, data.pool_np)      # warm
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                t0 = time.perf_counter()
                got = one_pass(engine, sched, data.pool_np)
                pass_s = time.perf_counter() - t0
                nums = judge.compare(HitLog.of(cfg["n_rows"], got), truth,
                                     data.db, data.pool, cfg["radius"])
                emit(dict(base, side="program", traffic=name, k_blocks=kb,
                          pass_s=pass_s, **nums))
        if control:
            t0 = time.perf_counter()
            c, r, d2 = reference.radius_hits(data.db, data.pool,
                                             cfg["radius"], precision="tf32")
            ctl_s = time.perf_counter() - t0
            hits = (c.cpu().numpy(), r.cpu().numpy(),
                    np.sqrt(d2.cpu().numpy()).astype(np.float32))
            got = HitLog.of(cfg["n_rows"], [(np.arange(len(data.pool_np)),
                                             hits)])
            nums = judge.compare(got, truth, data.db, data.pool,
                                 cfg["radius"])
            emit(dict(base, side="control", precision="tf32",
                      control_s=ctl_s, **nums))
        engine.close()
        del engine, data, truth
        if device.type == "cuda":
            torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True,
                    help="comma-separated traffic mixes")
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--kb", default="", help="comma-separated k_blocks")
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from benchmark.registry import Registry
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    calibrate(Registry(), args.config, args.traffic.split(","),
              [int(s) for s in args.seeds.split(",")],
              [int(k) for k in args.kb.split(",") if k], args.control, dev,
              emit)
    return 0


if __name__ == "__main__":
    sys.exit(main())
