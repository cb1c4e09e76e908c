"""GPU smoke run of hsearch_tpu_torch: kernels, main path, exactness, CLI.

    python3 chip_smoke.py

Needs one CUDA device (exits non-zero without one) and ``nvcc`` for the
kernels, which it builds from ``hsearch_tpu_torch/csrc`` into
``hsearch_tpu_torch/_build``.  Imports neither jax nor hsearch_tpu.

Phases, each of which fails the run on error:
  1. environment: torch/CUDA versions, the card's name and power limit,
     the kernel build;
  2. each kernel against its plain PyTorch version on the card, at the
     main path's shapes (real index data) and at ragged small shapes:
     prune's keys within the stated tolerance and flip rule, its group
     minima and alive counts exactly those of its own keys; verify's
     d2m and n_hits bitwise; then each kernel's time beside its plain
     version's, its bound and the one PyTorch call that computes the
     same (torch.cdist for prune's distances), and, for verify, the time
     of the candidate gather it made unnecessary;
  3. the main path at the bench workload (N = 2^20 k-mers, L = 25,
     4096 centers, R = 35): build_index, the exact oracle, ivf.search up
     the k_blocks ladder 128 -> 256 -> 512 until weighted recall >= 0.99,
     then 3 timed searches; kernel launch counts are read around it,
     and torch.profiler gives one search call's device time by kernel;
  4. the exactness contract (retry_overflow=True equals the oracle) on a
     2^16-point prefix;
  5. the CLI: motif-search --engine ivf equals motif-search-exact.

Output: free-form progress lines; a ``kernels`` line and a ``main_path``
line; the nvidia-smi name/power line; one JSON object ``{"kernels": [...]}``
and, last, ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# published peaks of one H100 SXM (NVIDIA data sheet): float32 outside
# the tensor cores, dense TF32 on the tensor cores, and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12

N_LOG2, L, C, RADIUS = 20, 25, 4096, 35.0
CENTER_BLOCK, MAX_HITS, ORACLE_BLOCK = 1024, 512, 256
KB_LADDER = (128, 256, 512)
EXACT_N_LOG2, EXACT_C = 16, 64


def protein_like_db(rng, n, l, family_size=64, query_n=256):
    """Motif families (centers + Poisson-flip members): the bench workload
    of the JAX package's bench.py, same numpy calls."""
    nfam = max(1, n // family_size)
    query_n = min(query_n, nfam)
    fam = rng.integers(0, 20, (nfam, l), dtype=np.int32)
    which = rng.integers(0, nfam, n)
    db = fam[which].copy()
    flips = rng.poisson(2.0, n).clip(0, l)
    ranks = np.argsort(rng.random((n, l)), axis=1)
    mask = ranks < flips[:, None]
    sub = rng.integers(0, 20, (n, l))
    db = np.where(mask, sub, db).astype(np.int32)
    q = fam[rng.choice(nfam, query_n, replace=False)]
    return db, q


def _sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _time_ms(fn, dev, reps=10):
    """Mean time of one call: CUDA events around ``reps`` calls on the card,
    the host clock on the CPU (rehearsals only)."""
    import torch
    fn()
    _sync(dev)
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def _bound_ms(flops, nbytes, peak_flops=PEAK_F32_FLOPS):
    t_ops = flops / peak_flops * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def check_prune(ck, q, cent, rad, r):
    """Kernel vs plain on the same inputs, under
    ops/kernel_checks.prune_agreement's tolerance and flip rule."""
    from hsearch_tpu_torch.ops import kernel_checks
    got = ck.sq_distance_prune(q, cent, rad, r)
    want = ck.sq_distance_prune_plain(q, cent, rad, r)
    _sync(q.device)
    return kernel_checks.prune_agreement(q, cent, rad, r, got, want)


def check_verify(ck, *args):
    """Kernel vs plain on the same inputs: d2m and n_hits bitwise equal."""
    from hsearch_tpu_torch.ops import kernel_checks
    return kernel_checks.verify_agreement(ck.ptable_verify(*args),
                                          ck.ptable_verify_plain(*args))


def verify_small_inputs(rng, dev, c, kb, bs, l):
    """ops/kernel_checks.verify_inputs at a ragged shape, on ``dev``."""
    import torch
    from hsearch_tpu_torch.ops import kernel_checks
    *arrays, r2, n = kernel_checks.verify_inputs(rng, c, kb, bs, l)
    return (*(torch.as_tensor(x, device=dev) for x in arrays), r2, n)


def run(device, n_log2=N_LOG2, n_centers=C, center_block=CENTER_BLOCK,
        exact_n_log2=EXACT_N_LOG2, cli=True):
    """All phases on ``device``; returns the kernel records and the main
    path's record.  Raises on the first failed check."""
    import torch
    from hsearch_tpu_torch import _device
    from hsearch_tpu_torch.ops import cuda_kernels as ck
    from hsearch_tpu_torch.ops import distance
    from hsearch_tpu_torch.search import evaluate, exact, ivf
    from hsearch_tpu_torch.search.motif import _center_ptables
    from hsearch_tpu_torch.core import embedding

    dev = _device.resolve(device)
    gen = torch.Generator().manual_seed(1)

    # ---- phase 1: build ------------------------------------------------
    if dev.type == "cuda":
        t0 = time.perf_counter()
        ck.build()
        print(f"phase1 kernels built in {time.perf_counter() - t0:.2f} s "
              f"into {ck._BUILD}", flush=True)

    # ---- phase 2: kernels vs plain versions ----------------------------
    rng = np.random.default_rng(0)
    db, centers = protein_like_db(rng, 1 << n_log2, L, query_n=n_centers)
    c_blk = min(center_block, centers.shape[0])
    idx2 = ivf.build_index(db, torch.Generator().manual_seed(0),
                           block_size=32, device=dev)
    q_emb = torch.as_tensor(embedding.embed_kmers(centers[:c_blk]),
                            device=dev)
    r = float(np.float32(RADIUS))
    cent2, rad2 = idx2.block_centroid, idx2.block_radius
    prune_bench = check_prune(ck, q_emb, cent2, rad2, r)
    # ragged small shape (C not a multiple of the 128-row tile, B not a
    # multiple of 64); r puts about half the keys on each side
    qs = torch.randn(200, 80, generator=gen).mul(10).to(dev)
    cs = torch.randn(300, 80, generator=gen).mul(10).to(dev)
    rs = torch.rand(300, generator=gen).mul(5).to(dev)
    rsmall = float(torch.sqrt(distance.sq_distance_matrix(qs, cs))
                   .median()) - 2.5
    prune_small = check_prune(ck, qs, cs, rs, rsmall)
    print(f"phase2 prune bench {tuple(q_emb.shape)}x"
          f"{tuple(cent2.shape)}: {prune_bench}", flush=True)
    print(f"phase2 prune small (200,80)x(300,80): {prune_small}", flush=True)

    # verify at the main path's first rung: the real select of kb=128
    kb0 = min(KB_LADDER[0], idx2.num_blocks)
    key, gmin, _ = ck.sq_distance_prune(q_emb, cent2, rad2, r)
    if idx2.num_blocks >= 4 * ivf._SELECT_GROUP:
        neg, blk = ivf._cascade_top_blocks(key, gmin, kb0)
    else:
        neg, blk = torch.topk(-key[:, :idx2.num_blocks], kb0, dim=1)
    del key, gmin
    ptab = _center_ptables(torch.as_tensor(centers[:c_blk], device=dev), L)
    r2 = float(np.float32(r) * np.float32(r))
    vargs = (ptab, idx2.db_sorted, idx2.order, blk, neg, r2, idx2.n_points)
    verify_bench = check_verify(ck, *vargs)
    # ragged: kb*bs not a multiple of the 512-candidate tile, rows of 200
    # bytes (byte staging) and 800 bytes (16-byte staging)
    verify_small = check_verify(ck, *verify_small_inputs(rng, dev, 6, 37, 8,
                                                          L))
    verify_small16 = check_verify(ck, *verify_small_inputs(rng, dev, 5, 21,
                                                            32, L))
    print(f"phase2 verify bench C={c_blk} kb={kb0} bs={idx2.block_size}: "
          f"{verify_bench}", flush=True)
    print(f"phase2 verify small (6, kb 37, bs 8): {verify_small}",
          flush=True)
    print(f"phase2 verify small (5, kb 21, bs 32): {verify_small16}",
          flush=True)
    for name, res in (("prune bench", prune_bench),
                      ("prune small", prune_small),
                      ("verify bench", verify_bench),
                      ("verify small", verify_small),
                      ("verify small 16-byte", verify_small16)):
        if not res["ok"]:
            raise AssertionError(f"{name} disagrees with its plain version:"
                                 f" {res}")

    # times at the main path's shapes
    cq, bq, dq = q_emb.shape[0], idx2.num_blocks, q_emb.shape[1]
    bp = -(-bq // ck.PRUNE_GROUP) * ck.PRUNE_GROUP
    prune_ms = _time_ms(
        lambda: ck.sq_distance_prune(q_emb, cent2, rad2, r), dev)
    prune_plain_ms = _time_ms(
        lambda: ck.sq_distance_prune_plain(q_emb, cent2, rad2, r), dev)
    cdist_ms = _time_ms(lambda: torch.cdist(q_emb, cent2), dev)
    # inputs q, centroids, radii; outputs key, gmin, n_alive
    prune_bytes = 4.0 * (cq * dq + bq * dq + bq + cq * bp
                         + cq * bp // ck.PRUNE_GROUP + cq)
    prune_bound, prune_by = _bound_ms(3 * 2.0 * cq * bq * dq, prune_bytes,
                                      PEAK_TF32_FLOPS)
    # the previous kernel's reckoning: one float32 product on the SIMT
    # units, (C, B) out
    prune_simt, _ = _bound_ms(2.0 * cq * bq * dq,
                              4.0 * (cq * dq + bq * dq + bq + cq * bq))
    kbv, bsv = blk.shape[1], idx2.block_size
    verify_ms = _time_ms(lambda: ck.ptable_verify(*vargs), dev)
    verify_plain_ms = _time_ms(lambda: ck.ptable_verify_plain(*vargs), dev)
    alive = torch.isfinite(neg)
    safe = torch.where(alive, blk, torch.zeros_like(blk))
    # the (C, kb*bs, L) candidate and id gathers the previous path ran
    gather_ms = _time_ms(lambda: (idx2.db_sorted[safe].reshape(cq, -1, L),
                                  idx2.order[safe]), dev)
    # the work the fused kernel needs: each distinct selected block's rows
    # and ids once, the tables, the select result, d2m and n_hits
    n_distinct = int(torch.unique(blk[alive]).numel())
    verify_bytes = (n_distinct * bsv * (L + 4) + 4.0 * cq * L * 20
                    + 12.0 * cq * kbv + 4.0 * cq * kbv * bsv + 4.0 * cq)
    verify_bound, verify_by = _bound_ms(
        float(int(alive.sum())) * bsv * L, verify_bytes)
    del idx2, ptab, vargs, blk, neg, safe, alive

    # ---- phase 3: the main path ----------------------------------------
    ck.reset_launches()
    t0 = time.perf_counter()
    index = ivf.build_index(db, torch.Generator().manual_seed(0),
                            block_size=32, device=dev)
    _sync(dev)
    build_s = time.perf_counter() - t0
    print(f"phase3 build {build_s:.3f} s, B={index.num_blocks}", flush=True)
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as wlog:
        warnings.simplefilter("always")
        gci, gki, gd = exact.search_radius(db, centers, RADIUS,
                                           center_block=ORACLE_BLOCK,
                                           max_hits=4 * MAX_HITS,
                                           device=dev)
    oracle_s = time.perf_counter() - t0
    truncated = [str(w.message) for w in wlog if "max_hits" in
                 str(w.message)]
    print(f"phase3 oracle {oracle_s:.3f} s, {len(gci)} hits, truncated: "
          f"{truncated or 'none'}", flush=True)
    rep, kb, stats = None, None, {}
    for kb in KB_LADDER:
        stats = {}
        ci, ki, dd = ivf.search(index, centers, RADIUS, k_blocks=kb,
                                max_hits=MAX_HITS, center_block=c_blk,
                                retry_overflow=False, stats_out=stats,
                                pack_cap_frac=4)
        rep = evaluate.recall_from_indices(gci, gki, gd, ci, ki, RADIUS)
        print(f"phase3 kb={kb} recall={rep.recall:.6f} stats={stats}",
              flush=True)
        if rep.recall >= 0.99:
            break
    iters = 3
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        ci, ki, dd = ivf.search(index, centers, RADIUS, k_blocks=kb,
                                max_hits=MAX_HITS, center_block=c_blk,
                                retry_overflow=False, stats_out={},
                                pack_cap_frac=4)
    search_s = (time.perf_counter() - t0) / iters
    qps = centers.shape[0] / search_s
    # the same search shipping d2 from the device (2 words per hit)
    # instead of recomputing it on the host
    t0 = time.perf_counter()
    ivf.search(index, centers, RADIUS, k_blocks=kb, max_hits=MAX_HITS,
               center_block=c_blk, retry_overflow=False, stats_out={},
               pack_cap_frac=4, transfer_d2=True)
    search_d2_s = time.perf_counter() - t0
    launches = ck.launch_counts()
    print(f"phase3 search {search_s * 1e3:.3f} ms/call, {qps:.1f} q/s, "
          f"launches {launches}; with transfer_d2=True "
          f"{search_d2_s * 1e3:.3f} ms", flush=True)
    if rep.recall < 0.99:
        raise AssertionError(f"weighted recall {rep.recall} < 0.99 at the "
                             f"top of the kb ladder")
    if dev.type == "cuda" and min(launches.values()) <= 0:
        raise AssertionError(f"a kernel was not launched on the main path: "
                             f"{launches}")
    # the oracle itself against a numpy brute force over all N
    r2 = float(np.float32(RADIUS * RADIUS))
    for c in range(4):
        d2 = embedding.DISTANCE_SQUARE[centers[c][None, :], db].sum(axis=1)
        want = set(np.nonzero(d2 <= r2)[0].tolist())
        got = set(gki[gci == c].tolist())
        diff = want ^ got
        if any(abs(d2[i] - r2) > 1e-2 for i in diff):
            raise AssertionError(f"oracle disagrees with numpy brute force "
                                 f"for center {c}: {sorted(diff)[:10]}")
    print("phase3 oracle == numpy brute force on 4 centers", flush=True)
    main_path = {"n": int(db.shape[0]), "c": int(centers.shape[0]),
                 "l": L, "radius": RADIUS, "center_block": c_blk,
                 "blocks": index.num_blocks, "build_s": build_s,
                 "oracle_s": oracle_s, "kb": kb, "recall": rep.recall,
                 "search_ms": search_s * 1e3, "qps": qps,
                 "search_ms_transfer_d2": search_d2_s * 1e3,
                 "hits": int(len(ci)), "truth_hits": int(len(gci)),
                 "stats": stats}
    profile_search(index, centers, kb, c_blk, dev)
    del index

    # ---- phase 4: exactness contract -----------------------------------
    n4 = 1 << exact_n_log2
    c4 = centers[:EXACT_C]
    idx4 = ivf.build_index(db[:n4], torch.Generator().manual_seed(0),
                           block_size=32, device=dev)
    st4: dict = {}
    ci4, ki4, _ = ivf.search(idx4, c4, RADIUS, k_blocks=128,
                             max_hits=MAX_HITS, center_block=EXACT_C,
                             retry_overflow=True, stats_out=st4)
    gci4, gki4, _ = exact.search_radius(db[:n4], c4, RADIUS, device=dev)
    if set(zip(ci4.tolist(), ki4.tolist())) != \
            set(zip(gci4.tolist(), gki4.tolist())):
        raise AssertionError("retry_overflow=True differs from the oracle")
    print(f"phase4 exact on 2^{exact_n_log2} x {len(c4)}: {len(ci4)} hits "
          f"== oracle, stats={st4}", flush=True)

    # ---- phase 5: CLI ---------------------------------------------------
    if cli:
        # the CLI database: the true hits of 8 centers plus filler rows
        rows = np.unique(np.concatenate([gki[gci < 8], np.arange(1024)]))
        run_cli(db[rows], centers[:8], dev)

    kernels = [
        {"name": "sq_distance_prune", "route": "cuda",
         "source": "hsearch_tpu_torch/csrc/prune.cu",
         "replaces": "hsearch_tpu/ops/pallas_kernels.py:86",
         "launches": launches["sq_distance_prune"],
         "max_abs_err": max(prune_bench["max_abs_err"],
                            prune_small["max_abs_err"]),
         "ms": prune_ms, "plain_ms": prune_plain_ms,
         "bound_ms": prune_bound, "bound_by": prune_by,
         "bound_basis": "3xTF32 on the tensor cores, 3*2*C*B*D at 495 "
                        "TFLOP/s",
         "bound_f32_simt_ms": prune_simt,
         "library_ms": cdist_ms,
         "library_call": "torch.cdist (the distance part alone)",
         "shape": [cq, bq, dq]},
        {"name": "ptable_verify", "route": "cuda",
         "source": "hsearch_tpu_torch/csrc/ptable_verify.cu",
         "replaces": "hsearch_tpu/ops/pallas_kernels.py:145",
         "launches": launches["ptable_verify"],
         "max_abs_err": max(verify_bench["max_abs_err"],
                            verify_small["max_abs_err"],
                            verify_small16["max_abs_err"]),
         "bitwise": (verify_bench["bitwise"] and verify_small["bitwise"]
                     and verify_small16["bitwise"]),
         "ms": verify_ms, "plain_ms": verify_plain_ms,
         "bound_ms": verify_bound, "bound_by": verify_by,
         "distinct_blocks": n_distinct,
         "replaced_gather_ms": gather_ms,
         "library_ms": None,
         "shape": [cq, kbv, bsv, L]},
    ]
    return kernels, main_path


def profile_search(index, centers, kb, c_blk, dev):
    """Device time by kernel and the device's busy share over one search
    call (torch.profiler); a measurement aid, so a profiler failure is
    reported and does not fail the run."""
    import torch
    from hsearch_tpu_torch.search import ivf
    if dev.type != "cuda":
        return
    try:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            ivf.search(index, centers, RADIUS, k_blocks=kb,
                       max_hits=MAX_HITS, center_block=c_blk,
                       retry_overflow=False, stats_out={},
                       pack_cap_frac=4)
            torch.cuda.synchronize(dev)
            wall_us = (time.perf_counter() - t0) * 1e6
        events = prof.key_averages()
        rows = sorted(((getattr(e, "device_time_total", 0.0) or 0.0,
                        e.key, e.count) for e in events
                       if (getattr(e, "device_time_total", 0.0) or 0.0) > 0
                       and e.device_type == torch.autograd.DeviceType.CUDA),
                      reverse=True)
        busy = sum(t for t, _, _ in rows)
        print(f"profile one search: wall {wall_us / 1e3:.3f} ms, device "
              f"busy {busy / 1e3:.3f} ms (idle share "
              f"{max(0.0, 1 - busy / wall_us):.3f})", flush=True)
        for t, k, n in rows[:15]:
            print(f"profile   {t / 1e3:9.3f} ms  x{n:<4d} {k[:90]}",
                  flush=True)
    except Exception as e:   # measurement aid only: report, keep running
        print(f"profile not measured: {type(e).__name__}: {e}", flush=True)


def run_cli(db, centers, dev):
    """motif-search --engine ivf (defaults otherwise) == motif-search-exact
    on a small k-mer FASTA, in a child process."""
    aa = "ARNDCQEGHILKMFPSTWYV"
    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    with tempfile.TemporaryDirectory() as tmp:
        paths = {}
        for name, rows in (("db", db), ("centers", centers)):
            paths[name] = os.path.join(tmp, f"{name}.fasta")
            with open(paths[name], "w") as f:
                for i, r in enumerate(rows):
                    f.write(f">{name}{i}\n{''.join(aa[x] for x in r)}\n")
        outs = {}
        for tool, extra in (("motif-search-exact", []),
                            ("motif-search", ["--engine", "ivf"])):
            out = os.path.join(tmp, f"{tool}.txt")
            cmd = [sys.executable, "-m", "hsearch_tpu_torch", tool,
                   "-d", paths["db"], "-c", paths["centers"], "-l", str(L),
                   "-T", str(RADIUS), "-o", out, "--device", dev.type,
                   *extra]
            subprocess.run(cmd, check=True, env=env, cwd=tmp, timeout=300)
            with open(out) as f:
                outs[tool] = [ln.split() for ln in f]
    exact_t = {(a, b): float(d) for a, b, d in outs["motif-search-exact"]}
    ivf_t = {(a, b): float(d) for a, b, d in outs["motif-search"]}
    if set(exact_t) != set(ivf_t) or not exact_t:
        raise AssertionError(f"CLI ivf ({len(ivf_t)} triples) != exact "
                             f"({len(exact_t)} triples)")
    worst = max(abs(exact_t[k] - ivf_t[k]) for k in exact_t)
    if worst > 1e-3:
        raise AssertionError(f"CLI distances differ by up to {worst}")
    print(f"phase5 CLI: motif-search --engine ivf == motif-search-exact "
          f"({len(exact_t)} triples, max |dist diff| {worst:.2e})",
          flush=True)


def main() -> int:
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a GPU",
              file=sys.stderr)
        return 2
    import hsearch_tpu_torch  # noqa: F401  (fails outside a checkout)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}"
          f" x{torch.cuda.device_count()}", flush=True)
    t0 = time.perf_counter()
    kernels, main_path = run("cuda")
    print("kernels " + json.dumps(kernels))
    print("main_path " + json.dumps(main_path))
    print(f"total {time.perf_counter() - t0:.1f} s")
    print(smi.splitlines()[0])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
