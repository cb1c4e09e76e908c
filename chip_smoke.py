"""GPU smoke run of hsearch_tpu_torch: kernels, IVF and LSH search,
exactness, k-mer clustering, the segmented (stream) engine alone and over
db shards, the protein aligner and pcluster, the sharded, multi-process and
training paths, distributed k-mer and protein clustering, CLI.

    python3 chip_smoke.py [--stream-n-log2 N] [--approx-n-log2 N]
                          [--trace-out PATH]

Needs one CUDA device (exits non-zero without one), ``nvcc`` for the
kernels and ``g++`` (or ``$CXX``) with OpenMP for the host library, which
it builds from ``hsearch_tpu_torch/csrc`` into ``hsearch_tpu_torch/_build``.
Imports neither jax nor hsearch_tpu.

Phases, each of which fails the run on error:
  1. environment: torch/CUDA versions, the card's name and power limit,
     the kernel build and, beside it, the host library's (g++ -fopenmp:
     build seconds, compiler, the OpenMP runtime loaded, the host's cores
     and the library's effective thread count);
  2. each kernel against its plain PyTorch version on the card, at the
     main path's shapes (real index data), at ragged small shapes and,
     for prune, past one grid's 65,535 block tiles (C=64, D=8,
     B=8,388,608: two launches); block_bounds on phase 3's index and on
     ragged blocks with padding and invalid rows (bs 32, 8 and 33) under
     ops/kernel_checks.bounds_agreement's tolerance; extend_pairs on
     ragged mixed lanes (8,192 of 120-residue and 8,197 of 600-residue
     proteins) bitwise;
     prune's keys within the stated tolerance and flip rule, its group
     minima and alive counts exactly those of its own keys; verify's
     d2m and n_hits bitwise, at the IVF search's block size 32 and at the
     LSH search's block size 1 (the deduplicated candidate ids of the
     LSH tuned point, with sentinels, and the same ids with duplicates);
     then each kernel's time beside its plain
     version's, its bound and the one PyTorch call that computes the
     same (torch.cdist for prune's distances), and, for verify, the time
     of the candidate gather it made unnecessary;
  3. the IVF search at the bench workload (N = 2^20 k-mers, L = 25,
     4096 centers, R = 35): build_index, then hsearch_tpu_torch.bench's
     run_ladder (the exact oracle, ivf.search up the k_blocks ladder 128
     -> 256 -> 512 until weighted recall >= 0.99, then 3 timed searches);
     kernel launch counts are read around it, and torch.profiler gives
     one search call's device time by kernel;
 3c. the approximate block select (ivf.search's approx_select, the
     counterpart of the JAX package's approx_max_k) on one resident index
     of 2^23 family rows (phase 3's shape; ``--approx-n-log2``), 256
     family centers in one center block, retry off, kb 128, 256 and 512,
     each with the exact and the approximate select, and kb 128 again
     through HSEARCH_APPROX_SELECT=1: groups, bins L, stage-1 select ms
     (exact and approximate, CUDA events), ms per call, q/s, weighted
     recall on a 64-center oracle sample, the select's group recall;
     fails unless every approximate hit is an oracle hit with the exact
     select's d^2, the hit sets are identical where L >= groups, and the
     environment's run equals the explicit one;
  4. the exactness contract (retry_overflow=True equals the oracle) on a
     2^16-point prefix;
  5. the CLI: motif-search --engine ivf equals motif-search-exact,
     --engine lsh (autotuned) finds a subset of it, and hclust2
     --merge-radius writes a partition of its input;
  6. the LSH engine on phase 3's database, 256 centers, at the
     reference's point (K=4 L=4 W=50 P=1) and the tuned point (K=8 L=8
     W=105 P=8, cand_max 2048, center block 32): build s, ms per search,
     q/s, weighted recall against phase 3's oracle (>= 0.98 at the tuned
     point), hits within the oracle's with d^2 agreeing; launch counts
     and a profile of one tuned search call;
  7. k-mer clustering on the same database: cluster_greedy (K=16 L=8
     W=50 R=35) with its stage times and the elect launches it made; the
     first slab of each size class of its round 0 through the elect
     kernel and through greedy._elect_plain on the card (bitwise), ms per
     slab of both and the kernel's bound; merge_by_center_distance at
     radius 35 with the kernel launches it made, cluster counts, sampled
     same-family pair recall and the invariants (every row once, sampled
     members within R of their head); the merge's index build timed
     alone and a profile of its search over 4096 heads;
     cluster_centroid (K=16 L=8) on a 2^18 prefix;
  8. the segmented engine (search/stream.py) on a 2^23-row database of
     the same family shape (generated on the card in chunks; R = 35,
     1024 family-center queries, center blocks of 1024, max_hits 512)
     in 4 segments of 2^21 points: per-segment build seconds, host and
     device bytes; prune, verify and block_bounds at a segment's shape
     against their plain versions, with their times; exactness fully streamed with the
     retry on (== the exact oracle over all rows, d^2 agreeing); the kb
     ladder, retry off, doubling from 128 until weighted recall >= 0.99
     (its last rung, kb = a segment's block count, is lossless); identical
     hits at
     residency 0, 1/2 and 1 with ms per call (beside the times when the
     bounds pass was torch ops) and one block_bounds launch per upload
     asserted, per-segment search walls,
     upload dispatch and h2d ms (CUDA events on the copy stream); a
     profiler trace of one fully streamed call (device busy, idle share,
     h2d time overlapped by kernels); segivf save and load; Lloyd
     refinement (kmeans_iters=2) on phase 3's database beside the sampled
     build; the CLI (motif-search --engine stream == motif-search-exact,
     index-build --engine stream + serve == motif-search --engine stream).
     ``--stream-n-log2 24`` runs it at 2^24 rows in 4 segments of 2^22,
     ``--stream-n-log2 27`` at 2^27 rows (32 segments of 2^22, built
     from an iterator of 2^22-row chunks).
 8b. the same index through parallel/stream_sharded.py over 4 logical db
     shards of the card (one wave): == the oracle at kb = a segment's
     block count (retry off); == search_segmented at phase 8's kb (retry
     off) with its recall, ms per call over 3 calls streamed and resident
     beside phase 8's, launches per call and each wave's upload ms; ==
     the oracle from kb = 128 with the retry on (centers retried); over 2
     shards (2 waves) == search_segmented at phase 8's kb.
  9. the aligner and pcluster on the JAX package's examples/bench_align.py
     corpus (families of 4 copies of a 120-residue base, 4 substitutions
     each, seed 0): cluster_proteins at 100,000 proteins (bits 12, sigma
     0.1, one table, default SearchParams) with seconds, proteins/s,
     pre-groups, seed pairs extended, hits, clusters, family-pair recall
     (gate 0.98) and the stage split; a torch.profiler trace of one
     search_all slice over the first 2^14 proteins' groups (device busy,
     idle share); hits, clusters and recall at 100,000 proteins equal
     PC_EXPECT; the first four 8,192-lane batches of that slice through
     extend_batch (the extend_pairs kernel), its plain version on the
     card and the CPU's window-dense form, bitwise, and the same for 512
     proteins of 600 residues (the CPU's chunked form), with kernel, card
     plain (and window-dense) and CPU ms per call and the kernel's bound;
     cluster_proteins on 2^14 proteins of 600 residues (seconds,
     align/extend seconds, recall, kernel launches);
     cluster_proteins gapped=True on a 2^14-protein corpus
     with examples/bench_gapped.py's indels (the extend_pairs and
     banded_scores launches it made), banded_scores on every
     gap-triggered window card against CPU and the kernel against
     banded_scores_plain on the card (bitwise), ms per call of both, the
     kernel's bound and the host tracebacks; cluster_proteins on
     2^12 proteins on the card and on the CPU with the same KLSH
     parameters (labels and every Hit field identical); the pcluster CLI;
     the corpus's group-partitioned seed index through a ``seed``
     checkpoint (save and load seconds, arrays and probes unchanged); the
     host library's call counts over the phase (seed_codes, argsort_u64
     and align_gapped must be non-zero);
 9h. the host library (native_ext, csrc/hostops.cpp) on phase 9's
     100,000-protein corpus, each binding against its numpy twin bitwise
     with both times: seed codes, the stable argsort of the valid codes,
     the grouped index's argsort_u32 of its largest group, searchsorted of
     the protein starts, the probe and the pair preparation of the
     table's first search_all slice, the diag-run collapse, the traceback
     of the first 256 gap-triggered windows of the 2^14 gapped run,
     union-find over the 100,000-protein run's hit edges, the FASTA parse
     of the corpus written as the CLI reads it, the suffix array of a
     2^18-residue prefix and the brute force of 2 centers over its
     25-mers;
 10. sharded, multi-process and training (parallel/): the sharded IVF
     search over 4 db shards on the one card on phase 3's database and
     centers (per-shard kb ladder from 128 to weighted recall >= 0.99, ms
     per call, the launches of both kernels); sharded exactness at
     k_blocks = blocks_per_shard on phase 4's set (== the oracle); the
     sharded LSH at the tuned point (256 centers) == the single-device
     engine with the same parameters; exact_topk (2^16 x 256, k = 16) ==
     the exact oracle; a world-of-one NCCL group through
     multihost.initialize whose search_ivf equals the single-process
     sharded one, then torn down; fit_embedding at the CLI's defaults on
     the card (under 1.1x the shipped table's mean distance error, within
     1e-3 of the CPU run); the mesh train step on the 4 logical shards ==
     one device to 1e-5; topk_agreement (length 8, k 1000, 100 queries)
     card == CPU.
 11. distributed clustering, 2-process gloo clusters whose ranks compute
     on the card (NCCL refuses two ranks on one card): greedy_dist on
     phase 7's k-mers and config == phase 7's parent / merged bit for bit;
     hclust2 --merge-radius as an NCCL world of one == the run without
     --dist-* (2^14 rows); pcluster_dist on phase 9's corpus and KLSH draw
     (query mode) == phase 9's labels, pre-groups and hit rows, and on a
     2^14-protein corpus at bits 16, sigma 0.2, two tables == one process;
     seconds, each rank's hits and the partition modes.
 12. the port's measurement entry points as subprocesses: ``python -m
     hsearch_tpu_torch.bench`` at its default size (its last stdout line
     the four-key JSON, its kb phase 3's, recall >= 0.99, both kernels
     launched in each timed call), then every script of
     hsearch_tpu_torch/examples once at a small size (EXAMPLE_RUNS, 4 at
     a time), each of which must exit 0; their wall seconds.

Output: free-form progress lines; ``kernels``, ``host_kernels``,
``main_path``, ``approx_select``, ``lsh``,
``cluster``, ``stream``, ``pcluster``, ``sharded``, ``distributed`` and
``examples`` lines; the nvidia-smi name/power line; one JSON object ``{"kernels":
[...]}`` and, last, ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import io
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
# int32 outside the tensor cores: 64 int32 lanes per SM (half the float32
# lanes whose FMAs make the 67 TFLOP/s), 132 SMs at 1.98 GHz
PEAK_INT32_OPS = 64 * 132 * 1.98e9

N_LOG2, L, C, RADIUS = 20, 25, 4096, 35.0
CENTER_BLOCK, MAX_HITS, ORACLE_BLOCK = 1024, 512, 256
KB_LADDER = (128, 256, 512)
EXACT_N_LOG2, EXACT_C = 16, 64
# phase 3c: rows (log2) of its resident index, centers (one center block),
# the oracle sample its weighted recall is read on, the kb ladder and the
# timed calls per point
APPROX_N_LOG2, APPROX_C, APPROX_SAMPLE = 23, 256, 64
APPROX_KBS, APPROX_REPS = (128, 256, 512), 3
# phase 6: LSH centers, recall gate of the tuned point
LSH_C, LSH_RECALL_GATE = 256, 0.98
# phase 7: cluster_centroid runs on a prefix of this size; the merge's
# search is profiled over this many heads
CENTROID_N_LOG2, MERGE_PROFILE_C = 18, 4096
# phase 8: database rows, the largest segment (a quarter of the rows below
# it), centers, and the rows from which the chunks feed the build as an
# iterator; the kb ladder doubles from its first rung until weighted
# recall >= 0.99 (on this data it passes phase 3's 512; see PERF.md); rows
# of the CLI's k-mer file and its queries
STREAM_N_LOG2, SEG_LOG2, STREAM_C, STREAM_ITER_N_LOG2 = 23, 22, 1024, 25
STREAM_KB0 = 128
# ms per call at residency 0, 1/2 and 1 of the default phase 8 run when
# the bounds pass was a host loop of torch ops (about 240 launches per
# segment), printed beside this run's (NVIDIA H100 80GB HBM3, 700.00 W)
TORCH_BOUNDS_STREAM_MS = {"0/4": [172.96, 174.38, 174.37],
                          "2/4": [113.75, 126.78, 110.72],
                          "4/4": [57.58, 58.04, 55.50]}
STREAM_CLI_N_LOG2, STREAM_CLI_Q = 16, 8
# phase 9: proteins of the cluster_proteins run (the JAX package's first
# validated rung), its KLSH operating point and family-pair recall gate;
# the corpora of the gapped run, of the card-vs-CPU run and of the CLI
# (log2 proteins); the long-protein corpus of the chunked extension
# (proteins, residues each); proteins the profiled search covers; and the
# 8,192-lane batches held card against CPU
PC_N, PC_BITS, PC_SIGMA, PC_RECALL_GATE = 100_000, 12, 0.1, 0.98
PC_GAPPED_LOG2, PC_CROSS_LOG2, PC_CLI_LOG2 = 14, 12, 10
PC_LONG_N, PC_LONG_LEN, PC_PROFILE_N, PC_CMP_BATCHES = 512, 600, 1 << 14, 4
# the long-protein cluster_proteins run (log2 proteins of PC_LONG_LEN), and
# the 100,000-protein run's hits, clusters and family-pair recall (6
# decimals), which the card's run must reproduce
PC_LONG_LOG2, PC_EXPECT = 14, (404_158, 25_031, 0.999347)
# phase 9h: gap-triggered windows traced by both tracebacks, and the
# residue prefix of the suffix array and the brute force
HOST_GAPPED_WINDOWS, SA_PREFIX = 256, 1 << 18
# phase 2: the prune case past one grid's 65,535 block tiles (C, D, B)
PRUNE_PAST_GRID = (64, 8, 8_388_608)
# phase 10: db shards on the one card, the per-shard kb ladder, the
# exact_topk shape (log2 rows, centers, k), fit_embedding at the CLI's
# defaults, and topk_agreement's (length, k, queries)
SH_DB, SH_KB_LADDER = 4, (128, 256, 512, 1024)
SH_TOPK = (16, 256, 16)
# phase 11: rows of the hclust2 world-of-one CLI run (log2)
DIST_CLI_LOG2 = 14
FIT = dict(dim=8, steps=2000, batch=4096, kmer_len=1, lr=1e-1, seed=0)
AGREE = (8, 1000, 100)
# phase 12: the bench at its default size, then each example once at the
# smallest size that still reaches its path on the card, as (module,
# arguments, environment; "{tmp}" is the phase's temporary directory),
# EXAMPLE_WORKERS at a time, each failing the run past EXAMPLE_TIMEOUT_S
BENCH_ARGS = ()
EXAMPLE_RUNS = (
    ("bench_engines", ("16",), {}),
    ("bench_stream", ("16", "--c=1024"), {}),
    ("quickstart", (), {}),
    ("pipeline_e2e", ("200", "{tmp}/pipeline"), {}),
    ("bench_align", ("512",), {}),
    ("bench_pcluster_mp", ("2048", "--nproc=2", "--tables=2",
                           "--timeout=240", "--logdir={tmp}/mp"), {}),
    ("bench_gapped", ("16384", "--indels"), {}),
    ("sweep_klsh", ("1024", "--tables=1"), {}),
    ("bench_merge_scale", ("16", "--kbs=64,128"), {}),
    ("bench_stream27", ("--log2n=21", "--segment-log2=20",
                        "--budgets=0,1"), {}),
    ("bench_scale24", ("--mode=stream",),
     {"HSEARCH_SCALE24_NPROT": "20000", "TMPDIR": "{tmp}/s24a"}),
    ("bench_scale24", ("--mode=single",),
     {"HSEARCH_SCALE24_NPROT": "20000", "TMPDIR": "{tmp}/s24b"}),
)
EXAMPLE_WORKERS, EXAMPLE_TIMEOUT_S = 4, 300


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


def check_bounds(ck, db_sorted, order, n):
    """block_bounds against its plain version on the same inputs, under
    ops/kernel_checks.bounds_agreement's tolerance."""
    from hsearch_tpu_torch.ops import distance, kernel_checks
    coords = distance.const("coords", db_sorted.device)
    got = ck.block_bounds(db_sorted, order, n, coords)
    want = ck.block_bounds_plain(db_sorted, order, n, coords)
    _sync(db_sorted.device)
    return kernel_checks.bounds_agreement(got, want, coords)


def bounds_small_inputs(rng, dev, b, bs, l, n=50_000):
    """Ragged bounds inputs on ``dev``: family rows, a third of the rows
    invalid (order == n), every seventh block all padding."""
    import torch
    fam = rng.integers(0, 20, (40, bs * l))
    rows = np.where(rng.random((b, bs * l)) < 0.1,
                    rng.integers(0, 20, (b, bs * l)),
                    fam[rng.integers(0, 40, b)]).astype(np.int8)
    order = rng.integers(0, n, (b, bs)).astype(np.int32)
    order[rng.random((b, bs)) < 0.33] = n
    order[::7] = n
    return (torch.as_tensor(rows, device=dev),
            torch.as_tensor(order, device=dev), n)


def bounds_bound(b, bs, l):
    """block_bounds' least time: rows, order and the coordinate table read
    once, centroids and radii written once; float operations per block:
    the centroid (20 FMAs per coordinate), the (L, 20) table (8 FMAs and a
    subtraction per entry) and the rows' L-term sums."""
    nbytes = b * (bs * l + 4.0 * bs + 4.0 * 8 * l + 4.0) + 4.0 * 20 * 8
    flops = b * (2.0 * 20 * 8 * l + 3.0 * 8 * 20 * l + 1.0 * bs * l)
    return _bound_ms(flops, nbytes)


def extend_bound(six, out):
    """extend_pairs' least time for these lanes: the (6, B) seeds read and
    the (8, B) results written once, and each residue of the query and
    subject extents [beg, end) read once (int32); operations: 4 int32
    operations (pair index, table lookup, sum, stop test) per residue pair
    of each lane's final extent, at the int32 rate."""
    six, out = (x.cpu().numpy().astype(np.int64) for x in (six, out))
    lo = np.concatenate([out[4], out[6]])
    hi = np.concatenate([out[5], out[7]])
    touched = _intervals_union(list(zip(lo.tolist(), hi.tolist())))
    nbytes = 4.0 * (six.size + out.size + touched)
    ops = 4.0 * float((out[5] - out[4]).sum())
    return _bound_ms(ops, nbytes, PEAK_INT32_OPS)


# int32 operations per (pair, scanned row, lane) cell of banded_scores'
# row update (csrc/banded_scores.cu, counted op by op): F 4 (two
# subtractions, two maxima), the band test 3, the diagonal 4 (two tests,
# an addition, a select), A 1, M 3, the prefix maximum 2 (in the chunk
# and across chunks), E 3, H 2, the row maximum 1, the alive test 1
BANDED_OPS_PER_CELL = 24


def banded_bound(p, lq, ld, w, rows):
    """banded_scores' least time for P pairs of (P, lq) / (P, ld) int32
    windows on w = 2*band+1 lanes: q, d, qlen, dlen and the 21x21 table
    read once, best / bi / bj written once; operations:
    BANDED_OPS_PER_CELL int32 operations per lane of the ``rows`` rows the
    pairs scan in all (the plain version's ``stats_out["rows"]`` summed:
    up to each pair's qlen or the row it dies in), at the int32 rate."""
    nbytes = 4.0 * (p * lq + p * ld + 2 * p + 21 * 21 + 3 * p)
    ops = float(BANDED_OPS_PER_CELL) * rows * w
    return _bound_ms(ops, nbytes, PEAK_INT32_OPS)


def elect_bound(nb, b, n_unproc):
    """elect's least time for NB bucket rows of B slots with n_unproc
    unprocessed slots in all: the walk reads the distance row of each
    unprocessed position once (B float32 each; a row of any other
    position cannot change the result), state and valid (a byte each)
    once, and writes the (NB, B) int64 parents once; operations: at each
    unprocessed position, a distance test and a key minimum per slot, at
    the int32 rate."""
    nbytes = 4.0 * b * n_unproc + 2.0 * nb * b + 8.0 * nb * b
    return _bound_ms(2.0 * b * n_unproc, nbytes, PEAK_INT32_OPS)


def check_prune_past_grid(ck, dev, gen):
    """Prune at PRUNE_PAST_GRID (B 128 blocks past the 65,535 block tiles
    one grid holds: two launches) against its plain version, with r about
    the median distance; the second grid's keys must hold live blocks.
    A 16x smaller B on the CPU (rehearsals)."""
    import torch
    from hsearch_tpu_torch.ops import distance
    c, d, b = PRUNE_PAST_GRID
    if dev.type != "cuda":
        b //= 16
    q = torch.randn(c, d, generator=gen).mul(10).to(dev)
    cent = torch.randn(b, d, generator=gen).mul(10).to(dev)
    rad = torch.rand(b, generator=gen).mul(5).to(dev)
    r = float(torch.sqrt(distance.sq_distance_matrix(q, cent[:65536]))
              .median()) - 2.5
    res = check_prune(ck, q, cent, rad, r)
    key = ck.sq_distance_prune(q, cent, rad, r)[0]
    first = ck.MAX_GRID_Y * ck.PRUNE_TILE
    res["launch_ranges"] = ck.prune_launch_ranges(b)
    res["second_grid_live"] = int(torch.isfinite(key[:, first:b]).sum())
    if dev.type == "cuda":
        res["ok"] = res["ok"] and res["second_grid_live"] > 0
    return res


def build_all(dev):
    """Phase 1: the CUDA kernels (on the card) and the host library, every
    compiler started at once; returns the host library's record."""
    import concurrent.futures
    from hsearch_tpu_torch import native_ext
    from hsearch_tpu_torch.ops import cuda_kernels as ck

    def timed(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        host = ex.submit(timed, native_ext.build)
        if dev.type == "cuda":
            cuda_s = timed(ck.build)
            print(f"phase1 kernels built in {cuda_s:.2f} s into "
                  f"{ck._BUILD}", flush=True)
        host_s = host.result()
    threads = native_ext.set_threads(0)       # loads it: the count as is
    cxx = native_ext.compiler()
    version = subprocess.run([cxx, "--version"], capture_output=True,
                             text=True).stdout.splitlines()[:1]
    ldd = subprocess.run(["ldd", str(native_ext.lib_path())],
                         capture_output=True, text=True).stdout
    rec = {"build_s": host_s, "compiler": cxx,
           "compiler_version": version[0] if version else None,
           "flags": list(native_ext.CXX_FLAGS),
           "library": str(native_ext.lib_path()),
           "ldd_openmp": [ln.strip() for ln in ldd.splitlines()
                          if "gomp" in ln or "omp.so" in ln],
           "openmp_runtime_loaded": native_ext.openmp_runtime(),
           "cpu_count": os.cpu_count(), "threads": threads}
    print(f"phase1 host library: {json.dumps(rec)}", flush=True)
    return rec


def verify_small_inputs(rng, dev, c, kb, bs, l):
    """ops/kernel_checks.verify_inputs at a ragged shape, on ``dev``."""
    import torch
    from hsearch_tpu_torch.ops import kernel_checks
    *arrays, r2, n = kernel_checks.verify_inputs(rng, c, kb, bs, l)
    return (*(torch.as_tensor(x, device=dev) for x in arrays), r2, n)


def verify_bound(n_distinct, row_bytes, c, kb, bs, n_alive):
    """verify's least time: each distinct selected block's rows and ids
    read once, the tables, the select result (int64 ids, f32 keys), d2m
    and n_hits written once; operations: L additions per alive row."""
    nbytes = (n_distinct * (row_bytes + 4.0 * bs) + 4.0 * c * L * 20
              + 12.0 * c * kb + 4.0 * c * kb * bs + 4.0 * c)
    return _bound_ms(float(n_alive) * bs * L, nbytes)


def lsh_configs():
    """Phase 6's two operating points as (tag, config, cand_max)."""
    from hsearch_tpu_torch.search import motif
    return (("reference", motif.MotifSearchConfig(
                hash_k=4, hash_l=4, w=50.0, radius=RADIUS, probes=1,
                cand_limit=8192, center_block=256, max_hits=512), None),
            ("tuned", motif.MotifSearchConfig(
                hash_k=8, hash_l=8, w=105.0, radius=RADIUS, probes=8,
                center_block=32, max_hits=512), 2048))


def run(device, n_log2=N_LOG2, n_centers=C, center_block=CENTER_BLOCK,
        exact_n_log2=EXACT_N_LOG2, centroid_n_log2=CENTROID_N_LOG2,
        cli=True, stream_n_log2=STREAM_N_LOG2, stream_c=STREAM_C,
        trace_out=None, pcluster_sizes=None, sharded_sizes=None,
        bench_args=BENCH_ARGS, example_runs=EXAMPLE_RUNS,
        approx_n_log2=APPROX_N_LOG2):
    """All phases on ``device``; returns the kernel records and the
    records of the IVF, approximate-select, LSH, clustering,
    segmented-engine, pcluster, sharded, distributed and bench/examples
    phases.  ``pcluster_sizes``
    and ``sharded_sizes`` override run_pcluster's corpus sizes and
    run_sharded's ``fit`` / ``agree``, ``bench_args`` and
    ``example_runs`` phase 12's runs (rehearsals).  Raises on the first
    failed check."""
    import torch
    from hsearch_tpu_torch import _device, bench
    from hsearch_tpu_torch.bench import protein_like_db
    from hsearch_tpu_torch.core import embedding
    from hsearch_tpu_torch.ops import cuda_kernels as ck
    from hsearch_tpu_torch.ops import distance, kernel_checks
    from hsearch_tpu_torch.search import exact, ivf, motif
    from hsearch_tpu_torch.search.motif import _center_ptables

    dev = _device.resolve(device)
    gen = torch.Generator().manual_seed(1)

    # ---- phase 1: build ------------------------------------------------
    host_build = build_all(dev)

    # ---- phase 2: kernels vs plain versions ----------------------------
    rng = np.random.default_rng(0)
    db, centers, fam = protein_like_db(rng, 1 << n_log2, L,
                                       query_n=n_centers,
                                       return_families=True)
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
    prune_past = check_prune_past_grid(ck, dev, gen)
    print(f"phase2 prune past the grid limit C,D,B={PRUNE_PAST_GRID}: "
          f"{prune_past}", flush=True)

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

    # verify at block size 1, as the LSH search calls it: the deduplicated
    # candidate ids (with sentinels) of the tuned point's first center
    # block, and a ragged small shape with duplicate and dead ids
    _, cfg_t, cm_t = lsh_configs()[1]
    lidx = motif.build_index(db, torch.Generator().manual_seed(0), cfg_t,
                             cand_max=cm_t, device=dev)
    lc = min(cfg_t.center_block, centers.shape[0])
    lcen = torch.as_tensor(centers[:lc], device=dev)
    lids, _ = motif._candidates(
        lidx, motif._query_codes(lidx, lcen, True, cfg_t.probes),
        lidx.cand_max)
    lneg = torch.where(lids < lidx.num_points, 0.0, float("inf"))
    lr2 = float(np.float32(RADIUS * RADIUS))
    largs = (_center_ptables(lcen, L), lidx.db_kmers, lidx.order, lids,
             lneg, lr2, lidx.num_points)
    verify_lsh = check_verify(ck, *largs)
    # the same ids with every odd slot repeating its neighbour: duplicate
    # ids beside the sentinels, at the same shape
    ldup = lids.clone()
    ldup[:, 1::2] = ldup[:, 0::2]
    verify_lsh_dup = check_verify(
        ck, *largs[:3], ldup,
        torch.where(ldup < lidx.num_points, 0.0, float("inf")), *largs[5:])
    verify_lsh_small = check_verify(ck, *verify_small_inputs(rng, dev, 5,
                                                              777, 1, L))
    print(f"phase2 verify lsh C={lc} M={lids.shape[1]} bs=1: {verify_lsh}",
          flush=True)
    print(f"phase2 verify lsh with duplicate ids: {verify_lsh_dup}",
          flush=True)
    print(f"phase2 verify lsh small (5, M 777, bs 1): {verify_lsh_small}",
          flush=True)
    # bounds at the build's shape (phase 3's index) and ragged, with
    # padding blocks and invalid rows; the extension on ragged mixed lanes
    # (kernel_checks.extend_inputs: family, bound, unknown-residue and
    # low-gate seeds) at 120 and 600 residues
    bounds_build = check_bounds(ck, idx2.db_sorted, idx2.order,
                                idx2.n_points)
    bounds_small = [check_bounds(ck, *bounds_small_inputs(rng, dev, b_, bs_,
                                                           l_))
                    for b_, bs_, l_ in ((3001, 32, 25), (777, 8, 10),
                                        (500, 33, 25))]
    extend_small = []
    for n_prot, plen, lanes in ((40, 120, 8192), (20, 600, 8197)):
        eseq, esix = (torch.as_tensor(x, device=dev) for x in
                      kernel_checks.extend_inputs(rng, n_prot, plen, lanes))
        extend_small.append(kernel_checks.extend_agreement(
            ck.extend_pairs(eseq, eseq, esix, 9),
            ck.extend_pairs_plain(eseq, eseq, esix, 9)))
    print(f"phase2 bounds at the build shape B={idx2.num_blocks}: "
          f"{bounds_build}", flush=True)
    print(f"phase2 bounds small: {bounds_small}", flush=True)
    print(f"phase2 extend small (120 and 600 residues): {extend_small}",
          flush=True)
    for name, res in (("bounds build shape", bounds_build),
                      *(("bounds small", r_) for r_ in bounds_small),
                      *(("extend small", r_) for r_ in extend_small),
                      ("prune bench", prune_bench),
                      ("prune small", prune_small),
                      ("prune past the grid limit", prune_past),
                      ("verify bench", verify_bench),
                      ("verify small", verify_small),
                      ("verify small 16-byte", verify_small16),
                      ("verify lsh bs=1", verify_lsh),
                      ("verify lsh bs=1 duplicate ids", verify_lsh_dup),
                      ("verify lsh small bs=1", verify_lsh_small)):
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
    n_distinct = int(torch.unique(blk[alive]).numel())
    verify_bnd, verify_by = verify_bound(n_distinct, bsv * L, cq, kbv, bsv,
                                         int(alive.sum()))
    # block size 1 at the LSH shape
    lsh_ms = _time_ms(lambda: ck.ptable_verify(*largs), dev)
    lsh_plain_ms = _time_ms(lambda: ck.ptable_verify_plain(*largs), dev)
    lreal = lids < lidx.num_points
    lsh_distinct = int(torch.unique(lids[lreal]).numel())
    lsh_bnd, lsh_by = verify_bound(lsh_distinct, L, lc, lids.shape[1], 1,
                                   int(lreal.sum()))
    lsh_shape = [lc, int(lids.shape[1]), 1, L]
    del idx2, ptab, vargs, blk, neg, safe, alive, lidx, lids, lneg, largs
    del lreal, ldup

    # ---- phase 3: the IVF search ---------------------------------------
    # the bench's own measurement (hsearch_tpu_torch.bench.run_ladder): the
    # oracle, the kb ladder to recall >= 0.99 (retry off), 3 timed calls
    ck.reset_launches()
    t0 = time.perf_counter()
    index = ivf.build_index(db, torch.Generator().manual_seed(0),
                            block_size=32, device=dev)
    _sync(dev)
    build_s = time.perf_counter() - t0
    print(f"phase3 build {build_s:.3f} s, B={index.num_blocks}", flush=True)
    lad = bench.run_ladder(index, db, centers, RADIUS, center_block=c_blk,
                           ladder=KB_LADDER)
    rec3 = lad.record
    gci, gki, gd = lad.truth
    oracle_s, kb, stats = rec3["oracle_s"], rec3["kb"], rec3["stats"]
    print(f"phase3 oracle {oracle_s:.3f} s, {len(gci)} hits, truncated: "
          f"{rec3['oracle_truncated'] or 'none'}", flush=True)
    for row in rec3["ladder"]:
        print(f"phase3 kb={row['kb']} recall={row['recall']:.6f} "
              f"stats={row['stats']}", flush=True)
    search_s = sum(rec3["call_s"]) / len(rec3["call_s"])
    qps = rec3["qps"]
    # the same search shipping d2 from the device (2 words per hit)
    # instead of recomputing it on the host
    t0 = time.perf_counter()
    ivf.search(index, centers, RADIUS, k_blocks=kb, max_hits=MAX_HITS,
               center_block=c_blk, retry_overflow=False, stats_out={},
               pack_cap_frac=4, transfer_d2=True)
    search_d2_s = time.perf_counter() - t0
    by_path = {"ivf_search": ck.launch_counts()}
    print(f"phase3 search {search_s * 1e3:.3f} ms/call, {qps:.1f} q/s, "
          f"launches {by_path['ivf_search']}; with transfer_d2=True "
          f"{search_d2_s * 1e3:.3f} ms", flush=True)
    if rec3["recall"] < 0.99:
        raise AssertionError(f"weighted recall {rec3['recall']} < 0.99 at "
                             f"the top of the kb ladder")
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
                 "oracle_s": oracle_s, "kb": kb, "recall": rec3["recall"],
                 "search_ms": search_s * 1e3, "qps": qps,
                 "call_ms": [1e3 * x for x in rec3["call_s"]],
                 "launches_per_call": rec3["launches_per_call"],
                 "search_ms_transfer_d2": search_d2_s * 1e3,
                 "hits": rec3["hits"], "truth_hits": int(len(gci)),
                 "stats": stats}
    profile_call("ivf search", lambda: ivf.search(
        index, centers, RADIUS, k_blocks=kb, max_hits=MAX_HITS,
        center_block=c_blk, retry_overflow=False, stats_out={},
        pack_cap_frac=4), dev)
    del index

    # ---- phase 3c: the approximate block select -------------------------
    approx_rec, by_path["ivf_approx"] = run_approx(dev, approx_n_log2)

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

    # ---- phase 6: the LSH engine ----------------------------------------
    lsh, by_path["lsh_search"] = run_lsh(db, centers, (gci, gki, gd), dev)

    # ---- phase 7: k-mer clustering --------------------------------------
    cluster, cluster_launches, greedy_res = run_cluster(
        db, fam, dev, centroid_n_log2)
    by_path.update(cluster_launches)

    # ---- phase 8: the segmented engine ----------------------------------
    stream, by_path["stream_search"], seg_kernels = run_stream(
        dev, stream_n_log2, stream_c, cli, trace_out,
        lloyd=(db, centers, (gci, gki, gd), c_blk, main_path))
    by_path["stream_sharded"] = stream["sharded"]["launches"]
    prune_seg, verify_seg, bounds_seg = seg_kernels

    # ---- phase 9: the aligner and pcluster ---------------------------------
    pcluster, pc_expect = run_pcluster(dev, cli=cli,
                                       **(pcluster_sizes or {}))
    pcluster["host_library"]["build"] = host_build
    # the extension kernel lies on this path, neither search kernel does
    by_path["pcluster"] = pcluster["cluster"]["tpu_kernel_launches"]
    by_path["pcluster_long"] = pcluster["cluster_long"]["kernel_launches"]
    by_path["pcluster_gapped"] = pcluster["gapped"]["launches"]

    # ---- phase 10: sharded, multi-process and training -----------------
    sharded_rec, sh_launches = run_sharded(
        dev, db, centers, (gci, gki, gd), c_blk, **(sharded_sizes or {}))
    by_path.update(sh_launches)

    # ---- phase 11: distributed clustering -------------------------------
    # the child processes share the card: hand back what this process's
    # allocator holds in reserve
    if dev.type == "cuda":
        print(f"phase11 this process's reserved device bytes before: "
              f"{torch.cuda.memory_reserved(dev)} (allocated "
              f"{torch.cuda.memory_allocated(dev)}); emptying the cache",
              flush=True)
        torch.cuda.empty_cache()
    dist_rec = run_distributed(
        dev, db, greedy_res, pc_expect,
        (pcluster_sizes or {}).get("gapped_log2", PC_GAPPED_LOG2))
    del pc_expect

    # ---- phase 12: the bench and the examples as subprocesses -----------
    examples_rec = run_examples(dev, kb, bench_args, example_runs)

    if dev.type == "cuda":
        need = {"ivf_search": ("sq_distance_prune", "ptable_verify",
                               "block_bounds"),
                "ivf_approx": ("sq_distance_prune", "ptable_verify"),
                "lsh_search": ("ptable_verify",),
                "hclust2_merge": ("sq_distance_prune", "ptable_verify"),
                "stream_search": ("sq_distance_prune", "ptable_verify",
                                  "block_bounds"),
                "stream_sharded": ("sq_distance_prune", "ptable_verify",
                                   "block_bounds"),
                "hclust2_greedy": ("elect",),
                "pcluster": ("extend_pairs",),
                "pcluster_long": ("extend_pairs",),
                "pcluster_gapped": ("extend_pairs", "banded_scores"),
                "sharded_ivf": ("sq_distance_prune", "ptable_verify"),
                "sharded_lsh": ("ptable_verify",)}
        for path, names in need.items():
            if min(by_path[path][n] for n in names) <= 0:
                raise AssertionError(f"a kernel of the {path} path was not "
                                     f"launched there: {by_path[path]}")
    kernels = [
        {"name": "sq_distance_prune", "route": "cuda",
         "source": "hsearch_tpu_torch/csrc/prune.cu",
         "replaces": "hsearch_tpu/ops/pallas_kernels.py:86",
         "launches": sum(p["sq_distance_prune"] for p in by_path.values()),
         "launches_by_path": {k: v["sq_distance_prune"]
                              for k, v in by_path.items()},
         "max_abs_err": max(prune_bench["max_abs_err"],
                            prune_small["max_abs_err"],
                            prune_past["max_abs_err"],
                            prune_seg["max_abs_err"]),
         "ms": prune_ms, "plain_ms": prune_plain_ms,
         "bound_ms": prune_bound, "bound_by": prune_by,
         "bound_basis": "3xTF32 on the tensor cores, 3*2*C*B*D at 495 "
                        "TFLOP/s",
         "bound_f32_simt_ms": prune_simt,
         "library_ms": cdist_ms,
         "library_call": "torch.cdist (the distance part alone)",
         "shape": [cq, bq, dq],
         "past_grid_limit": prune_past,
         "stream_segment": prune_seg},
        {"name": "ptable_verify", "route": "cuda",
         "source": "hsearch_tpu_torch/csrc/ptable_verify.cu",
         "replaces": "hsearch_tpu/ops/pallas_kernels.py:145",
         "launches": sum(p["ptable_verify"] for p in by_path.values()),
         "launches_by_path": {k: v["ptable_verify"]
                              for k, v in by_path.items()},
         "max_abs_err": max(verify_bench["max_abs_err"],
                            verify_small["max_abs_err"],
                            verify_small16["max_abs_err"],
                            verify_lsh["max_abs_err"],
                            verify_lsh_dup["max_abs_err"],
                            verify_lsh_small["max_abs_err"],
                            verify_seg["max_abs_err"]),
         "bitwise": all(v["bitwise"] for v in (
             verify_bench, verify_small, verify_small16, verify_lsh,
             verify_lsh_dup, verify_lsh_small)) and verify_seg["bitwise"],
         "ms": verify_ms, "plain_ms": verify_plain_ms,
         "bound_ms": verify_bnd, "bound_by": verify_by,
         "distinct_blocks": n_distinct,
         "replaced_gather_ms": gather_ms,
         "library_ms": None,
         "shape": [cq, kbv, bsv, L],
         "lsh_bs1": {"shape": lsh_shape, "ms": lsh_ms,
                     "plain_ms": lsh_plain_ms, "bound_ms": lsh_bnd,
                     "bound_by": lsh_by, "distinct_ids": lsh_distinct},
         "stream_segment": verify_seg},
        {"name": "extend_pairs", "route": "cuda",
         "source": "hsearch_tpu_torch/csrc/extend_pairs.cu",
         "replaces": "hsearch_tpu/align/extend.py:176 (lax.while_loop "
                     ":111, :171)",
         "launches": sum(p.get("extend_pairs", 0) for p in by_path.values()),
         "launches_by_path": {k: v.get("extend_pairs", 0)
                              for k, v in by_path.items()},
         "max_abs_err": max(r_["max_abs_err"] for r_ in (
             *extend_small, pcluster["extend_windowed"],
             pcluster["extend_chunked"])),
         "bitwise": all(r_["bitwise"] for r_ in extend_small),
         "ms": pcluster["extend_windowed"]["ms_per_call"],
         "plain_ms": pcluster["extend_windowed"]["plain_ms_per_call"],
         "bound_ms": pcluster["extend_windowed"]["bound_ms"],
         "bound_by": pcluster["extend_windowed"]["bound_by"],
         "bound_basis": "4 int32 operations per residue pair of the final "
                        "extents at 16.7 TOP/s; seeds, results and the "
                        "residues of the extents read or written once",
         "library_ms": None,
         "shape": ["8,192 lanes", "120-residue proteins"],
         "corpus_120": pcluster["extend_windowed"],
         "corpus_600": pcluster["extend_chunked"]},
        {"name": "block_bounds", "route": "cuda",
         "source": "hsearch_tpu_torch/csrc/block_bounds.cu",
         "replaces": "hsearch_tpu/search/stream.py:93 (lax.scan :127); "
                     "hsearch_tpu/search/ivf.py:367 (lax.scan :384)",
         "launches": sum(p.get("block_bounds", 0) for p in by_path.values()),
         "launches_by_path": {k: v.get("block_bounds", 0)
                              for k, v in by_path.items()},
         "max_abs_err": max(r_["max_abs_err"] for r_ in (
             bounds_build, *bounds_small, bounds_seg)),
         "tolerance": "centroid 1e-6 (|plain| + max|coord|), radius 1e-6 "
                      "(plain + sqrt(8L) max|coord|), both ways",
         "ms": bounds_seg["ms"], "plain_ms": bounds_seg["plain_ms"],
         "bound_ms": bounds_seg["bound_ms"],
         "bound_by": bounds_seg["bound_by"], "library_ms": None,
         "shape": bounds_seg["shape"], "stream_segment": bounds_seg,
         "build_shape": bounds_build},
        {"name": "banded_scores", "route": "cuda",
         "source": "hsearch_tpu_torch/csrc/banded_scores.cu",
         "replaces": "hsearch_tpu/align/gapped_device.py:39 (lax.scan :114)",
         "launches": sum(p.get("banded_scores", 0) for p in by_path.values()),
         "launches_by_path": {k: v.get("banded_scores", 0)
                              for k, v in by_path.items()},
         "max_abs_err": pcluster["gapped"]["banded_max_abs_err"],
         "bitwise": pcluster["gapped"]["banded_bitwise"],
         "ms": pcluster["gapped"]["banded_ms_per_call"],
         "plain_ms": pcluster["gapped"]["banded_plain_ms_per_call"],
         "bound_ms": pcluster["gapped"]["banded_bound_ms"],
         "bound_by": pcluster["gapped"]["banded_bound_by"],
         "bound_basis": f"{BANDED_OPS_PER_CELL} int32 operations per lane of "
                        "each scanned row at 16.7 TOP/s; windows, lengths, "
                        "table and results moved once",
         "library_ms": None,
         "shape": [pcluster["gapped"]["windows"],
                   *pcluster["gapped"]["window_shape"], "band 32"],
         "rows_scanned": pcluster["gapped"]["banded_rows_scanned"]},
        {"name": "elect", "route": "cuda",
         "source": "hsearch_tpu_torch/csrc/elect.cu",
         "replaces": "hsearch_tpu/cluster/greedy.py:87 (lax.scan :115)",
         "launches": sum(p.get("elect", 0) for p in by_path.values()),
         "launches_by_path": {k: v.get("elect", 0)
                              for k, v in by_path.items()},
         "max_abs_err": max(r_["max_abs_err"]
                            for r_ in cluster["elect_kernel"]),
         "bitwise": all(r_["bitwise"] for r_ in cluster["elect_kernel"]),
         # the widest class's first slab; every class's in "slabs"
         **{k: cluster["elect_kernel"][-1][k]
            for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
         "bound_basis": "the distance rows of the unprocessed positions, "
                        "state, valid and parents moved once; a test and a "
                        "minimum per slot and position at 16.7 TOP/s",
         "library_ms": None,
         "shape": [cluster["elect_kernel"][-1]["rows"],
                   cluster["elect_kernel"][-1]["b"]],
         "slabs": cluster["elect_kernel"]},
    ]
    return (kernels, main_path, approx_rec, lsh, cluster, stream, pcluster,
            sharded_rec, dist_rec, examples_rec)


def _run_module(module, args, env, dev, tmp, timeout=EXAMPLE_TIMEOUT_S):
    """``python -m module args --device <dev>`` from the checkout, in its
    own process group (killed whole at ``timeout``); returns (stdout,
    stderr, wall seconds) and raises on a non-zero exit."""
    import signal
    cmd = [sys.executable, "-m", module,
           *(a.format(tmp=tmp) for a in args), "--device", dev.type]
    # an even share of the cores for each of the EXAMPLE_WORKERS at once
    # (torch's threads and the host library's pool)
    share = str(max(1, (os.cpu_count() or 1) // EXAMPLE_WORKERS))
    e = dict(os.environ, TMPDIR=tmp, PYTHONPATH=HERE + os.pathsep
             + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS=share,
             HSEARCH_THREADS=share)
    e.update({k: v.format(tmp=tmp) for k, v in env.items()})
    os.makedirs(e["TMPDIR"], exist_ok=True)
    t0 = time.perf_counter()
    pr = subprocess.Popen(cmd, cwd=HERE, env=e, stdout=subprocess.PIPE,
                          stderr=subprocess.PIPE, text=True,
                          start_new_session=True)
    try:
        out, err = pr.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(pr.pid, signal.SIGKILL)
        pr.communicate()
        raise AssertionError(f"{' '.join(cmd)} ran past {timeout} s")
    wall = time.perf_counter() - t0
    if pr.returncode or not out.strip():
        raise AssertionError(f"{' '.join(cmd)} exited {pr.returncode}:\n"
                             f"{out[-3000:]}\n{err[-3000:]}")
    return out, err, wall


def run_examples(dev, kb, bench_args=BENCH_ARGS, runs=EXAMPLE_RUNS):
    """Phase 12: ``python -m hsearch_tpu_torch.bench`` (its last stdout
    line the four-key JSON, its kb phase 3's, recall >= 0.99, and on the
    card both kernels launched in each timed call), then every example
    once, EXAMPLE_WORKERS at a time; each must exit 0 with output.
    Returns the bench's numbers, each example's wall seconds and the
    phase's."""
    import concurrent.futures
    import re
    rec: dict = {}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out, err, wall = _run_module("hsearch_tpu_torch.bench", bench_args,
                                     {}, dev, tmp)
        line = json.loads(out.strip().splitlines()[-1])
        if set(line) != {"metric", "value", "unit", "vs_baseline"} or \
                line["metric"] != "motif_search_throughput" or \
                line["unit"] != "center queries/s/chip" or \
                not line["value"] > 0:
            raise AssertionError(f"bench printed {line}")
        summary = [ln for ln in err.splitlines() if " kb=" in ln][-1]
        b_kb = int(re.search(r" kb=(\d+) ", summary).group(1))
        b_recall = float(re.search(r"weighted_recall=([\d.]+)",
                                   summary).group(1))
        launches = json.loads(re.search(r"launches_per_call=(\{.*?\})",
                                        summary).group(1))
        rec["bench"] = {**line, "kb": b_kb, "recall": b_recall,
                        "launches_per_call": launches, "wall_s": wall,
                        "summary": summary}
        print(f"phase12 bench {wall:.1f} s: {json.dumps(line)}; {summary}",
              flush=True)
        if b_kb != kb or b_recall < 0.99:
            raise AssertionError(f"bench kb {b_kb} recall {b_recall}; "
                                 f"phase 3 chose kb {kb}")
        if dev.type == "cuda" and min(launches[k] for k in (
                "sq_distance_prune", "ptable_verify")) <= 0:
            raise AssertionError(f"the bench's timed calls launched "
                                 f"{launches}")
        rec["examples"] = {}
        with concurrent.futures.ThreadPoolExecutor(EXAMPLE_WORKERS) as ex:
            futs = {f"{name} {' '.join(args)}".strip(): ex.submit(
                _run_module, f"hsearch_tpu_torch.examples.{name}", args,
                env, dev, tmp) for name, args, env in runs}
            for key, fut in futs.items():
                out, _, wall = fut.result()
                rec["examples"][key] = wall
                print(f"phase12 {key}: {wall:.1f} s, "
                      f"{out.strip().splitlines()[-1][:300]}", flush=True)
    rec["phase_s"] = time.perf_counter() - t0
    print(f"phase12 done in {rec['phase_s']:.1f} s", flush=True)
    return rec


def run_approx(dev, n_log2):
    """Phase 3c: the approximate block select (``ivf.search``'s
    ``approx_select``) on one resident index of 2^n_log2 family rows
    (phase 3's shape: bs 32, R 35), APPROX_C family centers in one center
    block, retry off, at each kb of APPROX_KBS with the exact and the
    approximate select, and the first approximate point again through
    HSEARCH_APPROX_SELECT=1.  Fails unless every approximate hit is an
    oracle hit with the exact select's d^2 (bitwise where both found it),
    the hit sets are identical wherever the select cannot reduce (L >=
    groups, or the 8k gate shut), and the environment's run equals the
    explicit one.  Then, outside the counted launches, the stage-1 select
    alone on the prune kernel's group minima: exact and approximate ms
    (CUDA events) and the approximate select's group recall.  Returns the
    record and the kernel launches of the searches."""
    import torch
    from hsearch_tpu_torch.core import embedding
    from hsearch_tpu_torch.ops import cuda_kernels as ck
    from hsearch_tpu_torch.search import evaluate, exact, ivf
    n = 1 << n_log2
    t0 = time.perf_counter()
    fam, chunks = family_chunks(n, L, dev, seed=11,
                                chunk=1 << min(SEG_LOG2, n_log2))
    db = np.concatenate([c for c, _ in chunks()])
    centers = fam[np.random.default_rng(12).choice(
        len(fam), min(APPROX_C, len(fam)), replace=False)]
    rec: dict = {"n": n, "c": len(centers), "gen_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    index = ivf.build_index(db, torch.Generator().manual_seed(0),
                            block_size=32, device=dev)
    _sync(dev)
    rec["build_s"] = time.perf_counter() - t0
    ng = -(-index.num_blocks // ivf._SELECT_GROUP)
    rec.update(blocks=index.num_blocks, groups=ng)
    t0 = time.perf_counter()
    tci, tki, tdd = exact.search_radius(db, centers, RADIUS, device=dev)
    rec["oracle_s"] = time.perf_counter() - t0
    truth = dict(zip(zip(tci.tolist(), tki.tolist()),
                     (tdd.astype(np.float64) ** 2).tolist()))
    sample = tci < APPROX_SAMPLE
    print(f"phase3c built 2^{n_log2} rows in {rec['build_s']:.3f} s, "
          f"B={index.num_blocks}, groups {ng}; oracle {len(tci)} hits in "
          f"{rec['oracle_s']:.3f} s", flush=True)
    kw = dict(max_hits=MAX_HITS, center_block=APPROX_C,
              retry_overflow=False)

    def hits(kb, approx):
        ci, ki, dd = ivf.search(index, centers, RADIUS, k_blocks=kb,
                                stats_out={}, approx_select=approx, **kw)
        return ci, ki, dict(zip(zip(ci.tolist(), ki.tolist()),
                                dd.tolist()))

    ck.reset_launches()
    runs = {}
    for kb in APPROX_KBS:
        for approx in (False, True):
            hits(kb, approx)                                  # warm-up
            t0 = time.perf_counter()
            for _ in range(APPROX_REPS):
                res = hits(kb, approx)
            runs[kb, approx] = res, ((time.perf_counter() - t0) * 1e3
                                     / APPROX_REPS)
    env = os.environ.get("HSEARCH_APPROX_SELECT")
    os.environ["HSEARCH_APPROX_SELECT"] = "1"
    try:
        env_hits = hits(APPROX_KBS[0], None)[2]
    finally:
        if env is None:
            del os.environ["HSEARCH_APPROX_SELECT"]
        else:
            os.environ["HSEARCH_APPROX_SELECT"] = env
    launches = ck.launch_counts()
    if env_hits != runs[APPROX_KBS[0], True][0][2]:
        raise AssertionError("HSEARCH_APPROX_SELECT=1 differs from "
                             "approx_select=True")

    key, gmin, _ = ck.sq_distance_prune(
        torch.as_tensor(embedding.embed_kmers(centers), device=dev),
        index.block_centroid, index.block_radius, float(np.float32(RADIUS)))
    rec["points"] = []
    for kb in APPROX_KBS:
        (eci, eki, eh), e_ms = runs[kb, False]
        (aci, aki, ah), a_ms = runs[kb, True]
        ks = min(kb, ng)
        bins = ivf._approx_bins(ng, ks)
        acts = ks * 8 <= ng and bins < ng and dev.type == "cuda"
        false_pos = set(ah) - set(truth)
        if false_pos:
            raise AssertionError(f"kb {kb}: {len(false_pos)} approximate "
                                 f"hits are not oracle hits")
        if any(ah[p] != eh[p] for p in set(ah) & set(eh)):
            raise AssertionError(f"kb {kb}: d differs between the selects")
        worst = max((abs(d * d - truth[p]) / max(truth[p], 1.0)
                     for p, d in ah.items()), default=0.0)
        if worst > 1e-5:
            raise AssertionError(f"kb {kb}: d^2 differs from the oracle's "
                                 f"by {worst}")
        if not acts and ah != eh:
            raise AssertionError(f"kb {kb}: L {bins} >= {ng} groups but "
                                 "the hit sets differ")
        recall = {}
        for tag, ci, ki in (("exact", eci, eki), ("approx", aci, aki)):
            m = ci < APPROX_SAMPLE
            recall[tag] = evaluate.recall_from_indices(
                tci[sample], tki[sample], tdd[sample], ci[m], ki[m],
                RADIUS).recall
        thr = -torch.topk(-gmin, ks, dim=1).values[:, -1:]
        _, asel = ivf._select_nearest(gmin, ks, True)
        group_recall = float((torch.gather(gmin, 1, asel) <= thr)
                             .float().mean())
        pt = {"kb": kb, "groups": ng, "bins": bins, "acts": acts,
              "select_ms": _time_ms(
                  lambda: torch.topk(-gmin, ks, dim=1), dev),
              "approx_select_ms": _time_ms(
                  lambda: ivf._select_nearest(gmin, ks, True), dev),
              "cascade_ms": _time_ms(
                  lambda: ivf._cascade_top_blocks(key, gmin, kb), dev),
              "approx_cascade_ms": _time_ms(
                  lambda: ivf._cascade_top_blocks(key, gmin, kb, True), dev),
              "ms_per_call": e_ms, "approx_ms_per_call": a_ms,
              "qps": len(centers) / e_ms * 1e3,
              "approx_qps": len(centers) / a_ms * 1e3,
              "recall": recall["exact"], "approx_recall": recall["approx"],
              "group_recall": group_recall, "hits": len(eh),
              "approx_hits": len(ah),
              "approx_hits_not_exact": len(set(ah) - set(eh)),
              "max_rel_d2_vs_oracle": worst}
        rec["points"].append(pt)
        print(f"phase3c kb={kb} groups={ng} L={bins} acts={acts}: stage-1 "
              f"select {pt['select_ms']:.4f} ms exact / "
              f"{pt['approx_select_ms']:.4f} ms approx (cascade "
              f"{pt['cascade_ms']:.4f} / {pt['approx_cascade_ms']:.4f}); "
              f"{e_ms:.3f} / {a_ms:.3f} ms per call, {pt['qps']:.1f} / "
              f"{pt['approx_qps']:.1f} q/s; weighted recall "
              f"{recall['exact']:.6f} / {recall['approx']:.6f}; group "
              f"recall {group_recall:.6f}; hits {len(eh)} / {len(ah)}",
              flush=True)
    rec["launches"] = launches
    print(f"phase3c HSEARCH_APPROX_SELECT=1 == approx_select=True at kb "
          f"{APPROX_KBS[0]}; launches {launches}", flush=True)
    del index, key, gmin
    return rec, launches


def run_lsh(db, centers, truth, dev):
    """Phase 6: both LSH operating points on phase 3's database, the first
    LSH_C centers, against phase 3's oracle.  Returns the records and the
    kernel launches of the LSH searches."""
    import torch
    from hsearch_tpu_torch.ops import cuda_kernels as ck
    from hsearch_tpu_torch.search import evaluate, motif
    gci, gki, gd = truth
    nc = min(LSH_C, centers.shape[0])
    cen = centers[:nc]
    keep = gci < nc
    tci, tki, tdd = gci[keep], gki[keep], gd[keep]
    truth_d2 = dict(zip(zip(tci.tolist(), tki.tolist()),
                        (tdd.astype(np.float64) ** 2).tolist()))
    out = {}
    ck.reset_launches()
    for tag, cfg, cand_max in lsh_configs():
        t0 = time.perf_counter()
        index = motif.build_index(db, torch.Generator().manual_seed(0), cfg,
                                  cand_max=cand_max, device=dev)
        _sync(dev)
        build_s = time.perf_counter() - t0
        stats: dict = {}
        motif.search(index, cen, cfg, stats_out=stats)          # warm
        iters = 3
        t0 = time.perf_counter()
        for _ in range(iters):
            ci, ki, dd = motif.search(index, cen, cfg, stats_out=stats)
        search_s = (time.perf_counter() - t0) / iters
        rep = evaluate.recall_from_indices(tci, tki, tdd, ci, ki, RADIUS)
        pairs = list(zip(ci.tolist(), ki.tolist()))
        outside = [p for p in pairs if p not in truth_d2]
        d2 = dd.astype(np.float64) ** 2
        worst = max((abs(d2[i] - truth_d2[p]) / max(truth_d2[p], 1.0)
                     for i, p in enumerate(pairs) if p in truth_d2),
                    default=0.0)
        rec = {"k": cfg.hash_k, "l": cfg.hash_l, "w": cfg.w,
               "probes": cfg.probes, "cand_max": index.cand_max,
               "center_block": cfg.center_block, "centers": nc,
               "build_s": build_s, "search_ms": search_s * 1e3,
               "qps": nc / search_s, "recall": rep.recall,
               "hits": len(ci), "truth_hits": int(len(tci)),
               "truncated": stats["truncated"], "skewed": stats["skewed"],
               "hits_outside_oracle": len(outside),
               "max_d2_rel_err": worst}
        out[tag] = rec
        print(f"phase6 lsh {tag}: {json.dumps(rec)}", flush=True)
        if outside or worst > 1e-5:
            raise AssertionError(f"lsh {tag}: {len(outside)} hits outside "
                                 f"the oracle, d2 rel err {worst}")
        if tag == "tuned":
            if rep.recall < LSH_RECALL_GATE:
                raise AssertionError(f"lsh tuned recall {rep.recall} < "
                                     f"{LSH_RECALL_GATE}")
            launches = ck.launch_counts()
            profile_call("lsh tuned search", lambda: motif.search(
                index, cen, cfg, stats_out={}), dev)
        del index
    print(f"phase6 launches {launches}", flush=True)
    return out, launches


def run_cluster(db, fam, dev, centroid_n_log2):
    """Phase 7: greedy clustering + center-distance merge on the whole
    database, centroid clustering on a prefix.  Returns the record, the
    kernel launches of the merge and the greedy ClusterResult."""
    import torch
    from hsearch_tpu_torch.cluster import centroid, greedy, postprocess
    from hsearch_tpu_torch.core import embedding
    from hsearch_tpu_torch.examples.bench_engines import pair_recall
    from hsearch_tpu_torch.ops import cuda_kernels as ck
    from hsearch_tpu_torch.search import ivf
    n = db.shape[0]
    cfg = greedy.ClusterConfig(hash_k=16, hash_l=8, w=50.0, radius=RADIUS)
    stages: dict = {}
    ck.reset_launches()
    t0 = time.perf_counter()
    res = greedy.cluster_greedy(db, torch.Generator().manual_seed(1), cfg,
                                device=dev, stats_out=stages)
    greedy_s = time.perf_counter() - t0
    greedy_launches = ck.launch_counts()
    lab = np.where(res.parent >= 0, res.parent, np.arange(n))
    n_heads = int((res.merged != 2).sum())
    # invariants: every row once; sampled members within R of their head
    clusters = res.clusters()
    if not np.array_equal(np.sort(np.concatenate(clusters)), np.arange(n)):
        raise AssertionError("greedy clusters are not a partition")
    srng = np.random.default_rng(2)
    child = np.nonzero(res.parent >= 0)[0]
    sample = srng.choice(child, min(20000, len(child)), replace=False)
    dmax = float(np.sqrt(embedding.DISTANCE_SQUARE[
        db[sample], db[res.parent[sample]]].sum(-1)).max()) \
        if len(sample) else 0.0
    if dmax > RADIUS + 1e-3:
        raise AssertionError(f"a member lies {dmax} from its head > R")
    recall_greedy = pair_recall(lab, fam)
    print(f"phase7 greedy {greedy_s:.3f} s ({stages}), {n_heads} clusters, "
          f"pair recall {recall_greedy:.4f}, max sampled member distance "
          f"{dmax:.3f}, launches {greedy_launches}", flush=True)
    elect_rec = check_elect(db, cfg, dev)
    ck.reset_launches()
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as wlog:
        warnings.simplefilter("always")
        mlab = postprocess.merge_by_center_distance(
            db, lab, RADIUS, torch.Generator().manual_seed(3), device=dev)
    merge_s = time.perf_counter() - t0
    launches = ck.launch_counts()
    n_merged = int(len(np.unique(mlab)))
    if not np.isin(mlab, np.nonzero(res.merged != 2)[0]).all():
        raise AssertionError("a merged label is not a greedy head")
    recall_merged = pair_recall(mlab, fam)
    print(f"phase7 merge {merge_s:.3f} s, {n_merged} clusters, pair recall "
          f"{recall_merged:.4f}, launches {launches}, warnings "
          f"{[str(w.message) for w in wlog]}", flush=True)
    # where the merge's time goes: its index build alone, and a profile of
    # its search over the first MERGE_PROFILE_C heads (outside the counted
    # launches)
    heads = np.unique(lab)
    t0 = time.perf_counter()
    hidx = ivf.build_index(db[heads], torch.Generator().manual_seed(3),
                           block_size=32, device=dev)
    _sync(dev)
    merge_build_s = time.perf_counter() - t0
    print(f"phase7 merge index build {merge_build_s:.3f} s "
          f"({len(heads)} heads)", flush=True)
    profile_call(f"merge search of {min(MERGE_PROFILE_C, len(heads))} "
                 f"heads", lambda: ivf.search(
                     hidx, db[heads[:MERGE_PROFILE_C]], RADIUS,
                     k_blocks=128, retry_overflow=False, stats_out={}), dev)
    del hidx
    nc = min(n, 1 << centroid_n_log2)
    t0 = time.perf_counter()
    members = centroid.cluster_centroid(
        db[:nc], torch.Generator().manual_seed(2),
        centroid.CentroidConfig(hash_k=16, hash_l=8, w=50.0, radius=RADIUS),
        device=dev)
    centroid_s = time.perf_counter() - t0
    clab = np.empty(nc, np.int64)
    for i, grp in enumerate(members):
        clab[grp] = i
    if not np.array_equal(np.sort(np.concatenate(members)), np.arange(nc)):
        raise AssertionError("centroid clusters are not a partition")
    recall_centroid = pair_recall(clab, fam[:nc])
    print(f"phase7 centroid on {nc} rows {centroid_s:.3f} s, "
          f"{len(members)} clusters, pair recall {recall_centroid:.4f}",
          flush=True)
    rec = {"n": n, "greedy_s": greedy_s, "greedy_stages": stages,
           "greedy_launches": greedy_launches, "elect_kernel": elect_rec,
           "greedy_clusters": n_heads, "greedy_pair_recall": recall_greedy,
           "merge_s": merge_s, "merge_index_build_s": merge_build_s,
           "merged_clusters": n_merged,
           "merged_pair_recall": recall_merged, "merge_launches": launches,
           "centroid_n": nc, "centroid_s": centroid_s,
           "centroid_clusters": len(members),
           "centroid_pair_recall": recall_centroid}
    return rec, {"hclust2_greedy": greedy_launches,
                 "hclust2_merge": launches}, res


def elect_slabs(db, cfg, dev, seed=1):
    """Round 0 of ``cluster_greedy(db, Generator().manual_seed(seed),
    cfg)``: the first slab of bucket rows of each size class, as
    ``greedy._elect_edges`` hands it to the election; yields (B, d, state,
    valid), one slab at a time (at B = 256 its distances take 1 GB)."""
    import torch
    from hsearch_tpu_torch.cluster import greedy
    from hsearch_tpu_torch.core import embedding
    from hsearch_tpu_torch.lsh import pstable
    n, l = db.shape
    km_pad = torch.zeros((n + 1, l), dtype=torch.int8, device=dev)
    km_pad[:n] = torch.as_tensor(db.astype(np.int8), device=dev)
    state_pad = torch.zeros(n + 1, dtype=torch.uint8, device=dev)
    state_pad[n] = 2
    params = greedy._round_params(0, torch.Generator().manual_seed(seed),
                                  l * embedding.AA_DIM, cfg, None, dev)
    codes = pstable.hash_codes(km_pad[:n], params, is_kmers=True)[0]
    mats = greedy._bucket_class_matrices(
        codes, torch.arange(n, device=dev), cfg.bucket_max, n)
    for ids, valid in mats:
        rows = max(1, cfg.slab_elems // ids.shape[1])
        ids, valid = ids[:rows], valid[:rows]
        yield (ids.shape[1], greedy._bucket_distances(km_pad[ids]),
               torch.where(valid, state_pad[ids], 2), valid)


def check_elect(db, cfg, dev):
    """Phase 7: the first slab of each size class of greedy's round 0
    through the elect kernel and through ``greedy._elect_plain`` on
    ``dev``, bitwise; ms per slab of both (CUDA events) and the bound."""
    from hsearch_tpu_torch.cluster import greedy
    from hsearch_tpu_torch.ops import cuda_kernels as ck
    out = []
    for b, d, state, valid in elect_slabs(db, cfg, dev):
        args = (d, state, valid, cfg.radius)
        got = ck.elect(*args)
        want = greedy._elect_plain(*args)
        if not bool((got == want).all()):
            raise AssertionError(f"elect differs from _elect_plain at B={b}"
                                 f": {int((got != want).sum())} slots")
        n_unproc = int(((state == 0) & valid).sum())
        bound, by = elect_bound(d.shape[0], b, n_unproc)
        out.append({"b": b, "rows": int(d.shape[0]),
                    "unprocessed": n_unproc,
                    "absorbed": int((got >= 0).sum()), "bitwise": True,
                    "max_abs_err": int((got - want).abs().max()),
                    "ms": _time_ms(lambda: ck.elect(*args), dev),
                    "plain_ms": _time_ms(lambda: greedy._elect_plain(*args),
                                         dev, reps=2),
                    "bound_ms": bound, "bound_by": by})
        print(f"phase7 elect kernel == _elect_plain, first slab of class "
              f"{b}: {json.dumps(out[-1])}", flush=True)
        del d, state, valid, args, got, want
    return out


def family_chunks(n, l, dev, seed=8, chunk=1 << SEG_LOG2, family_size=64):
    """protein_like_db's family shape, drawn on ``dev`` in chunks: family
    centers (n / family_size, l), each row a random family's center with
    Poisson(2) substitutions.  Returns (family centers (F, l) int32 numpy,
    a generator of (rows (m, l) int8 numpy, family id (m,)) chunks)."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    nfam = max(1, n // family_size)
    fam = torch.randint(0, 20, (nfam, l), generator=g, device=dev,
                        dtype=torch.int8)

    def chunks():
        for lo in range(0, n, chunk):
            m = min(chunk, n - lo)
            which = torch.randint(0, nfam, (m,), generator=g, device=dev)
            flips = torch.poisson(torch.full((m,), 2.0, device=dev),
                                  generator=g)
            ranks = torch.argsort(torch.rand((m, l), generator=g,
                                             device=dev), dim=1)
            sub = torch.randint(0, 20, (m, l), generator=g, device=dev,
                                dtype=torch.int8)
            rows = torch.where(ranks < flips[:, None], sub, fam[which])
            yield rows.cpu().numpy(), which.cpu().numpy()

    return fam.cpu().numpy().astype(np.int32), chunks


def _pairs(ci, ki):
    return set(zip(ci.tolist(), ki.tolist()))


def _d2_agree(got, truth):
    """Hit sets equal and d^2 within f32 summation noise (1e-5 relative,
    the ROADMAP's rule); returns the worst relative d^2 difference."""
    (ci, ki, dd), (tci, tki, tdd) = got, truth
    if _pairs(ci, ki) != _pairs(tci, tki):
        raise AssertionError(f"hit sets differ: {len(ci)} vs {len(tci)} "
                             f"hits, {len(_pairs(ci, ki) ^ _pairs(tci, tki))}"
                             " pairs in one only")
    t = dict(zip(zip(tci.tolist(), tki.tolist()),
                 (tdd.astype(np.float64) ** 2).tolist()))
    d2 = dd.astype(np.float64) ** 2
    worst = max((abs(d2[i] - t[p]) / max(t[p], 1.0)
                 for i, p in enumerate(zip(ci.tolist(), ki.tolist()))),
                default=0.0)
    if worst > 1e-5:
        raise AssertionError(f"d^2 differs from the oracle's by {worst}")
    return worst


def _intervals_union(iv):
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, -float("inf")
    for a, b in sorted(iv):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def _trace_summary(path, wall_us):
    """A Chrome trace of one call: device busy (union of every kernel,
    copy and memset interval), idle share against the call's wall, how
    much of the host-to-device copy time lies under kernels running at the
    same time, and the device time of the top kernels."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev_ev = [e for e in events if e.get("ph") == "X" and e.get("cat")
              in ("kernel", "gpu_memcpy", "gpu_memset")]
    kern = [(e["ts"], e["ts"] + e["dur"]) for e in dev_ev
            if e["cat"] == "kernel"]
    h2d = [(e["ts"], e["ts"] + e["dur"]) for e in dev_ev
           if e["cat"] == "gpu_memcpy" and "HtoD" in e["name"]]
    busy = _intervals_union([(e["ts"], e["ts"] + e["dur"])
                             for e in dev_ev])
    h2d_total = sum(b - a for a, b in h2d)
    # the part of each copy that some kernel covers
    under = sum(_intervals_union([(max(a, ka), min(b, kb_))
                                  for ka, kb_ in kern
                                  if ka < b and kb_ > a])
                for a, b in h2d)
    names = {}
    for e in dev_ev:
        names[e["name"][:60]] = names.get(e["name"][:60], 0.0) + e["dur"]
    top = sorted(names.items(), key=lambda x: -x[1])[:8]
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "idle_share": max(0.0, 1 - busy / wall_us),
            "kernels": len(kern), "h2d_copies": len(h2d),
            "h2d_ms": h2d_total / 1e3,
            "h2d_under_kernels_ms": under / 1e3,
            "h2d_overlaps_kernels": under > 0.5 * h2d_total > 0,
            "top_device_ms": {k: v / 1e3 for k, v in top}}


def profile_stream(fn, dev, trace_out=None):
    """One call under torch.profiler, summarised by ``_trace_summary``.
    A measurement aid: a profiler failure is reported, not raised."""
    import torch
    if dev.type != "cuda":
        return {"profile": "not measured (no CUDA device)"}
    try:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize(dev)
            wall_us = (time.perf_counter() - t0) * 1e6
        with tempfile.TemporaryDirectory() as tmp:
            path = trace_out or os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            return _trace_summary(path, wall_us)
    except Exception as e:   # measurement aid only: report, keep running
        return {"profile": f"not measured: {type(e).__name__}: {e}"}


def run_stream(dev, n_log2, n_centers, cli, trace_out, lloyd):
    """Phase 8: the segmented engine.  Returns its record, the kernel
    launches of its searches, and the prune/verify records at a segment's
    shape.  ``lloyd`` carries phase 3's database, centers, oracle, center
    block and record for the Lloyd-refinement check."""
    import torch
    from hsearch_tpu_torch.core import embedding
    from hsearch_tpu_torch.ops import cuda_kernels as ck
    from hsearch_tpu_torch.ops import distance
    from hsearch_tpu_torch.search import evaluate, exact, ivf, stream
    from hsearch_tpu_torch.search.motif import _center_ptables
    from hsearch_tpu_torch.utils import checkpoint
    n = 1 << n_log2
    seg_pts = 1 << min(SEG_LOG2, n_log2 - 2)
    rec: dict = {"n": n, "segment_points": seg_pts, "centers": n_centers}

    # data: family rows drawn on the device; queries are family centers
    t0 = time.perf_counter()
    fam, chunks = family_chunks(n, L, dev, chunk=seg_pts)
    qidx = np.random.default_rng(9).choice(len(fam), n_centers,
                                           replace=False)
    centers = fam[qidx]
    streamed_input = n_log2 >= STREAM_ITER_N_LOG2
    if streamed_input:
        db = None                       # built from the chunk iterator
    else:
        db = np.concatenate([c for c, _ in chunks()])
        rec["gen_s"] = time.perf_counter() - t0

    # build, timed per segment
    marks = [time.perf_counter()]
    sidx = stream.build_segmented(
        (c for c, _ in chunks()) if streamed_input else db,
        torch.Generator().manual_seed(8), segment_points=seg_pts,
        block_size=32, device=dev,
        progress=lambda i, off: marks.append(time.perf_counter()))
    rec["build_s"] = marks[-1] - marks[0]
    rec["build_s_per_segment"] = [float(x) for x in np.diff(marks)]
    rec["segments"] = sidx.num_segments
    rec["blocks_per_segment"] = [s.db_sorted.shape[0] for s in sidx.segments]
    rec["host_bytes"] = sum(s.nbytes for s in sidx.segments)
    rec["segment_device_bytes"] = [stream.segment_device_bytes(s)
                                   for s in sidx.segments]
    rec["pinned"] = all(s.pinned is not None and s.pinned[0].is_pinned()
                        for s in sidx.segments) if dev.type == "cuda" \
        else None
    print(f"phase8 built {sidx.num_segments} segments of {seg_pts} in "
          f"{rec['build_s']:.3f} s "
          f"({[round(x, 3) for x in rec['build_s_per_segment']]}), host bytes {rec['host_bytes']}, device bytes per segment "
          f"{rec['segment_device_bytes']}", flush=True)

    # the exact oracle over every row, as the union of per-segment oracles
    # (radius search decomposes over the partition)
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as wlog:
        warnings.simplefilter("always")
        parts = [exact.search_radius(s.host_kmers, centers, RADIUS,
                                     center_block=n_centers,
                                     max_hits=4 * MAX_HITS, device=dev)
                 for s in sidx.segments]
    truth = (np.concatenate([p[0] for p in parts]),
             np.concatenate([p[1] + s.offset
                             for p, s in zip(parts, sidx.segments)]),
             np.concatenate([p[2] for p in parts]))
    rec["oracle_s"] = time.perf_counter() - t0
    rec["truth_hits"] = int(len(truth[0]))
    if any("max_hits" in str(w.message) for w in wlog):
        raise AssertionError("the phase 8 oracle truncated a center")
    print(f"phase8 oracle {rec['oracle_s']:.3f} s, {len(truth[0])} hits",
          flush=True)

    # prune and verify at a segment's shape, against their plain versions
    seg0 = stream.upload_segment(sidx.segments[0], dev)
    cb = min(n_centers, 1024)
    q_emb = torch.as_tensor(embedding.embed_kmers(centers[:cb]), device=dev)
    r = float(np.float32(RADIUS))
    cent, rad = seg0.block_centroid, seg0.block_radius
    prune_res = check_prune(ck, q_emb, cent, rad, r)
    key, gmin, _ = ck.sq_distance_prune(q_emb, cent, rad, r)
    kb0 = min(STREAM_KB0, seg0.num_blocks)
    neg, blk = ivf._cascade_top_blocks(key, gmin, kb0)
    del key, gmin
    ptab = _center_ptables(torch.as_tensor(centers[:cb], device=dev), L)
    vargs = (ptab, seg0.db_sorted, seg0.order, blk, neg,
             float(np.float32(r) * np.float32(r)), seg0.n_points)
    verify_res = check_verify(ck, *vargs)
    print(f"phase8 prune at segment shape {tuple(q_emb.shape)}x"
          f"{tuple(cent.shape)}: {prune_res}", flush=True)
    print(f"phase8 verify at segment shape C={cb} kb={kb0}: {verify_res}",
          flush=True)
    for name, res in (("prune", prune_res), ("verify", verify_res)):
        if not res["ok"]:
            raise AssertionError(f"{name} at the segment shape disagrees "
                                 f"with its plain version: {res}")
    bq, dq = seg0.num_blocks, q_emb.shape[1]
    bp = -(-bq // ck.PRUNE_GROUP) * ck.PRUNE_GROUP
    prune_bound, prune_by = _bound_ms(
        3 * 2.0 * cb * bq * dq,
        4.0 * (cb * dq + bq * dq + bq + cb * bp + cb * bp // ck.PRUNE_GROUP
               + cb), PEAK_TF32_FLOPS)
    prune_seg = {"shape": [cb, bq, dq], "max_abs_err": prune_res[
                     "max_abs_err"], "mask_flips": prune_res["mask_flips"],
                 "ms": _time_ms(lambda: ck.sq_distance_prune(
                     q_emb, cent, rad, r), dev),
                 "plain_ms": _time_ms(lambda: ck.sq_distance_prune_plain(
                     q_emb, cent, rad, r), dev, reps=3),
                 "bound_ms": prune_bound, "bound_by": prune_by,
                 "library_ms": _time_ms(lambda: torch.cdist(q_emb, cent),
                                        dev, reps=3)}
    alive = torch.isfinite(neg)
    verify_bnd, verify_by = verify_bound(
        int(torch.unique(blk[alive]).numel()), 32 * L, cb, kb0, 32,
        int(alive.sum()))
    verify_seg = {"shape": [cb, kb0, 32, L],
                  "max_abs_err": verify_res["max_abs_err"],
                  "bitwise": verify_res["bitwise"],
                  "ms": _time_ms(lambda: ck.ptable_verify(*vargs), dev),
                  "plain_ms": _time_ms(lambda: ck.ptable_verify_plain(
                      *vargs), dev, reps=3),
                  "bound_ms": verify_bnd, "bound_by": verify_by,
                  "library_ms": None}
    # the bounds pass of an upload, at a segment's shape
    bounds_res = check_bounds(ck, seg0.db_sorted, seg0.order, seg0.n_points)
    if not bounds_res["ok"]:
        raise AssertionError(f"block_bounds at the segment shape disagrees "
                             f"with its plain version: {bounds_res}")
    coords = distance.const("coords", dev)
    bargs = (seg0.db_sorted, seg0.order, seg0.n_points, coords)
    bounds_bnd, bounds_by = bounds_bound(bq, 32, L)
    bounds_seg = {"shape": [bq, 32, L], **bounds_res,
                  "ms": _time_ms(lambda: ck.block_bounds(*bargs), dev),
                  "plain_ms": _time_ms(lambda: ck.block_bounds_plain(
                      *bargs), dev, reps=3),
                  "bound_ms": bounds_bnd, "bound_by": bounds_by,
                  "library_ms": None}
    print(f"phase8 kernels at segment shape: prune {prune_seg}, verify "
          f"{verify_seg}, bounds {bounds_seg}", flush=True)
    del seg0, q_emb, cent, rad, neg, blk, ptab, vargs, alive, bargs

    def cb_for(kb):
        """A center block that keeps the (C, kb*bs) verify output near
        1 GB."""
        return max(1, min(cb, (1 << 28) // (kb * 32)))

    ck.reset_launches()
    # exactness: fully streamed, retry on.  On this dense data most blocks
    # of a segment survive the prune for every center, so the retry
    # ladder would end at kb = B for each center alone; the search starts
    # there instead
    stream.set_residency(sidx, 0)
    b_max = max(rec["blocks_per_segment"])
    st: dict = {}
    t0 = time.perf_counter()
    got = stream.search_segmented(
        sidx, centers, RADIUS, k_blocks=b_max, retry_overflow=True,
        stats_out=st, max_hits=MAX_HITS, pack_cap_frac=4,
        center_block=cb_for(b_max))
    rec["exact_s"] = time.perf_counter() - t0
    rec["exact_max_d2_rel_err"] = _d2_agree(got, truth)
    rec["exact_stats"] = {k: st[k] for k in ("retried", "max_alive",
                                             "over_blocks", "over_hits")}
    print(f"phase8 exact, fully streamed, retry on: {len(got[0])} hits == "
          f"oracle in {rec['exact_s']:.3f} s, stats {rec['exact_stats']}",
          flush=True)

    # the kb ladder, retry off, doubling until weighted recall >= 0.99;
    # at kb = b_max it is lossless
    ladder, kb = {}, STREAM_KB0
    while True:
        kb = min(kb, b_max)
        st = {}
        ci, ki, _ = stream.search_segmented(
            sidx, centers, RADIUS, k_blocks=kb, retry_overflow=False,
            stats_out=st, max_hits=MAX_HITS, pack_cap_frac=4,
            center_block=cb_for(kb))
        rep = evaluate.recall_from_indices(*truth, ci, ki, RADIUS)
        ladder[kb] = rep.recall
        print(f"phase8 kb={kb} recall={rep.recall:.6f} over_blocks="
              f"{st['over_blocks']} max_alive={st['max_alive']}",
              flush=True)
        if rep.recall >= 0.99 or kb == b_max:
            break
        kb *= 2
    rec["recall_ladder"] = ladder
    rec["kb"], rec["recall"] = kb, ladder[kb]
    if ladder[kb] < 0.99:
        raise AssertionError(f"phase 8 weighted recall {ladder[kb]} < 0.99 "
                             f"at kb = {kb}, every block of a segment")
    kw = dict(max_hits=MAX_HITS, center_block=cb_for(kb), pack_cap_frac=4)

    # residency 0, 1/2 and 1 at the chosen kb: identical hits
    ns = sidx.num_segments
    res_rec, ref = {}, None
    for k in (0, ns // 2, ns):
        budget = sum(stream.segment_device_bytes(s)
                     for s in sidx.segments[:k])
        stream.set_residency(sidx, budget)
        if sum(r_ is not None for r_ in sidx.resident) != k:
            raise AssertionError(f"set_residency kept "
                                 f"{sidx.resident_fraction()} resident, "
                                 f"asked {k}/{ns}")
        calls, last, events = [], None, []
        for _ in range(3):
            st, events = {}, []
            _sync(dev)
            bb0 = ck.block_bounds.launches
            t0 = time.perf_counter()
            last = stream.search_segmented(sidx, centers, RADIUS,
                                           k_blocks=kb, retry_overflow=False,
                                           stats_out=st, h2d_events=events,
                                           **kw)
            calls.append((time.perf_counter() - t0) * 1e3)
            # one bounds launch per upload: each streamed segment
            if dev.type == "cuda" and ck.block_bounds.launches - bb0 \
                    != ns - k:
                raise AssertionError(
                    f"residency {k}/{ns}: {ck.block_bounds.launches - bb0}"
                    f" block_bounds launches for {ns - k} uploads")
        _sync(dev)
        pairs = _pairs(last[0], last[1])
        if ref is None:
            ref = pairs
        elif pairs != ref:
            raise AssertionError(f"residency {k}/{ns} changed the hits: "
                                 f"{len(pairs ^ ref)} pairs differ")
        h2d = {i: s_.elapsed_time(e_) for i, s_, e_ in events}
        res_rec[f"{k}/{ns}"] = {
            "resident_fraction": sidx.resident_fraction(),
            "ms_per_call": calls,
            "torch_op_bounds_ms_per_call": TORCH_BOUNDS_STREAM_MS.get(
                f"{k}/{ns}") if n_log2 == STREAM_N_LOG2 else None,
            "block_bounds_per_call": ns - k,
            "seg_walls_s": st["seg_walls_s"],
            "upload_dispatch_s": st["upload_dispatch_s"],
            "h2d_ms": [h2d.get(i) for i in range(ns)],
            "h2d_gb_per_s": [sidx.segments[i].nbytes / (h2d[i] * 1e6)
                             if h2d.get(i) else None for i in range(ns)],
            "hits": len(last[0])}
        print(f"phase8 residency {k}/{ns}: {json.dumps(res_rec[f'{k}/{ns}'])}",
              flush=True)
        if k == 0:
            rec["profile_streamed"] = profile_stream(
                lambda: stream.search_segmented(
                    sidx, centers, RADIUS, k_blocks=kb,
                    retry_overflow=False, **kw), dev, trace_out)
            print(f"phase8 profile of one fully streamed call: "
                  f"{json.dumps(rec['profile_streamed'])}", flush=True)
    rec["residency"] = res_rec
    launches = ck.launch_counts()
    print(f"phase8 launches {launches}", flush=True)

    # ---- phase 8b: the same index over db shards of the card ------------
    rec["sharded"] = run_stream_sharded(dev, sidx, centers, truth, kb,
                                        b_max, ref, cb_for, res_rec)

    # checkpoint: segivf save and load with a budget
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "seg.npz")
        t0 = time.perf_counter()
        checkpoint.save_index(path, sidx)
        rec["save_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = checkpoint.load_index(
            path, device_budget_bytes=stream.segment_device_bytes(
                sidx.segments[0]) * (ns // 2), device=dev)
        rec["load_s"] = time.perf_counter() - t0
        rec["checkpoint_bytes"] = os.path.getsize(path)
    again = stream.search_segmented(back, centers, RADIUS, k_blocks=kb,
                                    retry_overflow=False, **kw)
    if _pairs(again[0], again[1]) != ref:
        raise AssertionError("the reloaded segivf index changed the hits")
    print(f"phase8 checkpoint: save {rec['save_s']:.3f} s, load "
          f"{rec['load_s']:.3f} s ({rec['checkpoint_bytes']} bytes, "
          f"resident {back.resident_fraction():.2f}), same hits", flush=True)
    del back, again
    stream.set_residency(sidx, 0)

    # Lloyd refinement on phase 3's database, beside the sampled build
    db3, cen3, truth3, c_blk3, main3 = lloyd
    t0 = time.perf_counter()
    kidx = ivf.build_index(db3, torch.Generator().manual_seed(0),
                           block_size=32, kmeans_iters=2, device=dev)
    _sync(dev)
    rec["lloyd_build_s"] = time.perf_counter() - t0
    rec["sampled_build_s"] = main3["build_s"]
    ci, ki, _ = ivf.search(kidx, cen3, RADIUS, k_blocks=128,
                           max_hits=MAX_HITS, center_block=c_blk3,
                           retry_overflow=False, stats_out={})
    rec["lloyd_recall_kb128"] = evaluate.recall_from_indices(
        *truth3, ci, ki, RADIUS).recall
    rec["sampled_recall_kb128"] = main3["recall"] if main3["kb"] == 128 \
        else None
    c64 = cen3[:EXACT_C]
    sel = truth3[0] < EXACT_C
    rec["lloyd_exact_max_d2_rel_err"] = _d2_agree(
        ivf.search(kidx, c64, RADIUS, k_blocks=128, max_hits=4 * MAX_HITS,
                   center_block=EXACT_C, retry_overflow=True),
        tuple(x[sel] for x in truth3))
    print(f"phase8 lloyd (kmeans_iters=2) on phase 3's database: build "
          f"{rec['lloyd_build_s']:.3f} s (sampled {main3['build_s']:.3f} s),"
          f" recall at kb=128 {rec['lloyd_recall_kb128']:.6f} (sampled "
          f"{rec['sampled_recall_kb128']}), exact on {EXACT_C} centers",
          flush=True)
    del kidx

    if cli:
        # the CLI's k-mer file: the true hits of its queries, then filler
        want = truth[1][truth[0] < STREAM_CLI_Q]
        if db is None:
            db = np.concatenate([s.host_kmers for s in sidx.segments])
        m = min(n, 1 << STREAM_CLI_N_LOG2)
        fill = np.setdiff1d(np.arange(m), want)
        rows = np.concatenate([want, fill])[:m]
        rec["cli"] = run_stream_cli(db[rows], centers[:STREAM_CLI_Q], dev,
                                    m // 4)
    return rec, launches, (prune_seg, verify_seg, bounds_seg)


def run_stream_sharded(dev, sidx, centers, truth, kb, b_max, ref, cb_for,
                       residency):
    """Phase 8b: parallel/stream_sharded.py on phase 8's index, centers and
    oracle.  Over SH_DB logical db shards of the card (one wave): at kb =
    a segment's block count, retry off, the oracle's hits; at phase 8's
    kb, retry off, ``search_segmented``'s hits (``ref``), its recall, ms
    per call (3 calls, streamed and resident), launches per call and each
    wave's upload ms; at kb = STREAM_KB0 with the retry on, the oracle's
    hits.  Over 2 shards (2 waves) at phase 8's kb: ``ref`` again.  The
    kernel launches are counted from 0 over the whole phase."""
    from hsearch_tpu_torch.ops import cuda_kernels as ck
    from hsearch_tpu_torch.parallel import mesh as mesh_lib, stream_sharded
    from hsearch_tpu_torch.search import evaluate, stream
    ns = sidx.num_segments
    rec: dict = {"phase8_streamed_ms_per_call":
                 residency[f"0/{ns}"]["ms_per_call"],
                 "phase8_resident_ms_per_call":
                 residency[f"{ns}/{ns}"]["ms_per_call"]}
    stream.set_residency(sidx, 0)

    def search(ndb, k, retry, st=None):
        return stream_sharded.search_segmented_sharded(
            sidx, centers, RADIUS,
            mesh=mesh_lib.make_mesh(ndb, data=1, devices=[dev] * ndb),
            k_blocks=k, max_hits=MAX_HITS, center_block=cb_for(k),
            retry_overflow=retry, stats_out=st)

    ck.reset_launches()
    t0 = time.perf_counter()
    st: dict = {}
    rec["exact_max_d2_rel_err"] = _d2_agree(search(SH_DB, b_max, False, st),
                                            truth)
    rec["exact"] = {"kb": b_max, "s": time.perf_counter() - t0,
                    **{k: st[k] for k in ("waves", "over_blocks",
                                          "over_hits", "wave_upload_ms")}}
    print(f"phase8b {SH_DB} shards, kb={b_max} (every block), retry off: "
          f"== oracle, {json.dumps(rec['exact'])}", flush=True)
    # phase 8's kb: 3 timed calls, fully streamed and then resident
    for label, budget in (("streamed", 0), ("resident", sum(
            stream.segment_device_bytes(s) for s in sidx.segments))):
        stream.set_residency(sidx, budget)
        before = ck.launch_counts()
        calls, ups = [], []
        for _ in range(3):
            st = {}
            _sync(dev)
            t0 = time.perf_counter()
            got = search(SH_DB, kb, False, st)
            calls.append((time.perf_counter() - t0) * 1e3)
            ups.append(st["wave_upload_ms"])
            if _pairs(got[0], got[1]) != ref:
                raise AssertionError(f"stream_sharded ({label}) at kb={kb} "
                                     "differs from search_segmented")
        after = ck.launch_counts()
        rec[label] = {"kb": kb, "ms_per_call": calls,
                      "wave_upload_ms": ups, "waves": st["waves"],
                      "launches_per_call": {k: (after[k] - before[k]) / 3
                                            for k in after},
                      "recall": evaluate.recall_from_indices(
                          *truth, got[0], got[1], RADIUS).recall,
                      "over_blocks": st["over_blocks"]}
        print(f"phase8b {SH_DB} shards, kb={kb}, retry off, {label}: == "
              f"search_segmented, {json.dumps(rec[label])}", flush=True)
    stream.set_residency(sidx, 0)
    # the retry ladder from the first rung
    st = {}
    t0 = time.perf_counter()
    rec["retry_max_d2_rel_err"] = _d2_agree(
        search(SH_DB, STREAM_KB0, True, st), truth)
    rec["retry"] = {"kb": STREAM_KB0, "s": time.perf_counter() - t0,
                    **{k: st[k] for k in ("retried", "max_alive",
                                          "over_blocks", "over_hits")}}
    print(f"phase8b {SH_DB} shards, kb={STREAM_KB0}, retry on: == oracle, "
          f"{json.dumps(rec['retry'])}", flush=True)
    # 2 shards: 2 waves
    st = {}
    t0 = time.perf_counter()
    got = search(2, kb, False, st)
    if _pairs(got[0], got[1]) != ref:
        raise AssertionError(f"stream_sharded over 2 shards at kb={kb} "
                             "differs from search_segmented")
    rec["two_shards"] = {"kb": kb, "ms": (time.perf_counter() - t0) * 1e3,
                         "waves": st["waves"],
                         "wave_upload_ms": st["wave_upload_ms"]}
    rec["launches"] = ck.launch_counts()
    print(f"phase8b 2 shards, kb={kb}: == search_segmented, "
          f"{json.dumps(rec['two_shards'])}; launches {rec['launches']}",
          flush=True)
    return rec


def first_table_searcher(db, pre_groups, dev, max_proteins=None):
    """The group-partitioned ProteinSearcher that cluster_proteins builds
    for a table from its pre-groups; with ``max_proteins``, over only the
    first that many of its proteins (the first groups, the last one cut).
    """
    from hsearch_tpu_torch.align import pipeline
    subset = np.concatenate(pre_groups)
    group_of = np.repeat(np.arange(len(pre_groups)),
                         [len(g) for g in pre_groups])
    return pipeline.ProteinSearcher(
        db, pipeline.SearchParams(), subset=subset[:max_proteins],
        groups=group_of[:max_proteins], device=dev)


def slice_pairs(searcher):
    """The packed (6, n) seed pairs of the searcher's first search_all
    slice (all of them when the default budgets hold the corpus)."""
    from hsearch_tpu_torch.align import hostops, seed_index
    s = searcher
    code, _, valid10, qgrp10 = seed_index.host_codes(s.seq, s.starts)
    qidx = np.nonzero(valid10)[0]
    qgroups = None if s.groups is None else np.repeat(
        s.groups.astype(np.int64), np.diff(s.starts))[qidx]
    rows, dpos, _ = seed_index.probe_host(s._hview, code[qidx],
                                          qgrp10[qidx], s.params.cand_max,
                                          qgroups=qgroups)
    six, _, _ = hostops.pair_prep(rows, dpos, qidx.astype(np.int64),
                                  s.starts, s.ids, None,
                                  s.params.collapse_runs)
    return six


def compare_extension(searcher, dev):
    """The first PC_CMP_BATCHES batches of the searcher's first slice
    through ``extend_batch`` on ``dev`` (the extend_pairs kernel on the
    card), through the kernel's plain version (the chunked form) on the
    same device and through the searcher's form on CPU tensors (window-
    dense up to 512 residues, else chunked): all bitwise equal.  Returns
    the CPU form, lanes, the kernel's ms per call (CUDA events on the
    card, the host clock on the CPU) beside the plain version's on the
    same device, the window-dense form's there (when it is the CPU form)
    and the CPU form's, and the kernel's bound on the first batch."""
    import torch
    from hsearch_tpu_torch.align import extend, seed_index
    from hsearch_tpu_torch.ops import cuda_kernels as ck
    from hsearch_tpu_torch.ops import kernel_checks
    b = searcher.params.pair_batch
    six = slice_pairs(searcher)[:, :PC_CMP_BATCHES * b]
    seq = torch.as_tensor(searcher.seq)
    sdev = searcher._seq_dev
    drop = int(searcher.cutoffs.ungap_ext_drop)
    form = "windowed" if searcher.windowed else "chunked"

    def windowed(s, x):
        return extend.extend_pairs_windowed(
            s, s, x, drop, seed_index.SEED_LEN, win_pre=searcher._win,
            win_post=searcher._win)

    def on_cpu(x):
        if searcher.windowed:
            return windowed(seq, x)
        return ck.extend_pairs_plain(seq, seq, x, drop, seed_index.SEED_LEN)

    cpu_s = []
    for lo in range(0, six.shape[1], b):
        part = torch.as_tensor(six[:, lo:lo + b])
        x = part.to(dev)
        got = searcher.extend_batch(x)
        res = kernel_checks.extend_agreement(got, ck.extend_pairs_plain(
            sdev, sdev, x, drop, seed_index.SEED_LEN))
        t0 = time.perf_counter()
        want = on_cpu(part)
        cpu_s.append(time.perf_counter() - t0)
        if not (res["ok"] and torch.equal(got.cpu(), want)):
            raise AssertionError(
                f"extension ({form} corpus) on {dev} differs from its plain "
                f"version or the CPU at lanes {lo}..{lo + b}: {res}, "
                f"{int((got.cpu() != want).any(dim=0).sum())} lanes vs CPU")
    first = torch.as_tensor(six[:, :b], device=dev)
    bound, by = extend_bound(first, searcher.extend_batch(first))
    rec = {"form": form, "window": searcher._win if searcher.windowed
           else None, "lanes": int(six.shape[1]), "bitwise": True,
           "max_abs_err": 0.0,
           "ms_per_call": _time_ms(lambda: searcher.extend_batch(first),
                                   dev, reps=20),
           "plain_ms_per_call": _time_ms(lambda: ck.extend_pairs_plain(
               sdev, sdev, first, drop, seed_index.SEED_LEN), dev, reps=3),
           "windowed_ms_per_call": _time_ms(lambda: windowed(sdev, first),
                                            dev, reps=5)
           if searcher.windowed else None,
           "lanes_per_call": int(first.shape[1]),
           "cpu_ms_per_call": 1e3 * float(np.mean(cpu_s)),
           "bound_ms": bound, "bound_by": by}
    return rec


def run_pcluster(dev, n=PC_N, gapped_log2=PC_GAPPED_LOG2,
                 cross_log2=PC_CROSS_LOG2, long_n=PC_LONG_N,
                 profile_n=PC_PROFILE_N, long_log2=PC_LONG_LOG2, cli=True):
    """Phase 9: the aligner and pcluster.  Returns the record and, for phase
    11b, the 100,000-protein run's KLSH draw, labels, pre-groups and hit
    rows."""
    import dataclasses

    import torch
    from hsearch_tpu_torch import native_ext
    from hsearch_tpu_torch.align import gapped_device, pipeline
    from hsearch_tpu_torch.cluster import _mp_pcluster_check, pcluster
    from hsearch_tpu_torch.examples.bench_align import (family_pair_recall,
                                                        protein_families)
    from hsearch_tpu_torch.examples.bench_gapped import add_indels
    from hsearch_tpu_torch.ops import cuda_kernels as ck
    from hsearch_tpu_torch.utils import profiling
    rec: dict = {}
    kw = dict(bits=PC_BITS, sigma=PC_SIGMA, tables=1)

    # cluster_proteins at the validated rung
    t0 = time.perf_counter()
    db, n_fam = protein_families(n)
    rec["corpus_s"] = time.perf_counter() - t0
    profiling.reset()
    ck.reset_launches()
    native_ext.reset_calls()
    t0 = time.perf_counter()
    res = pcluster.cluster_proteins(db, torch.Generator().manual_seed(0),
                                    device=dev, **kw)
    _sync(dev)
    secs = time.perf_counter() - t0
    recall = family_pair_recall(res.labels, n_fam)
    rec["cluster"] = {
        "proteins": n, "residues": int(db.starts[-1]), "seconds": secs,
        "proteins_per_s": n / secs, "pre_groups": len(res.pre_groups),
        "pairs_extended": res.pairs_extended, "hits": len(res.hits),
        "clusters": int(len(np.unique(res.labels))),
        "family_pair_recall": recall,
        "stages_s": {k: v["total_s"] for k, v in profiling.report().items()},
        "tpu_kernel_launches": ck.launch_counts(),
        "host_library_calls": native_ext.call_counts()}
    print(f"phase9 cluster_proteins: {json.dumps(rec['cluster'])}",
          flush=True)
    if recall < PC_RECALL_GATE:
        raise AssertionError(f"family-pair recall {recall} < "
                             f"{PC_RECALL_GATE}")
    if n == PC_N and (len(res.hits), rec["cluster"]["clusters"],
                      round(recall, 6)) != PC_EXPECT:
        raise AssertionError(f"hits, clusters and recall at {PC_N} "
                             f"proteins are not {PC_EXPECT}")

    kp = pcluster.klsh_init(torch.Generator().manual_seed(0),
                            bits=PC_BITS, sigma=PC_SIGMA)
    expect = {"seq": np.asarray(db.seq), "starts": np.asarray(db.starts),
              "w": kp.w.numpy()[None], "t": kp.t.numpy()[None],
              "b": kp.b.numpy()[None], "labels": res.labels,
              "pre_groups": np.concatenate(res.pre_groups),
              "pre_group_sizes": [len(g) for g in res.pre_groups],
              "hit_rows": _mp_pcluster_check._hit_rows(res.hits)}
    rec["seed_checkpoint"] = seed_checkpoint(db, res.pre_groups)
    print(f"phase9 seed checkpoint: {json.dumps(rec['seed_checkpoint'])}",
          flush=True)

    # one search_all slice over the first proteins of the table's groups,
    # traced; and the extension of its first batches on the card against
    # the CPU
    ps = first_table_searcher(db, res.pre_groups, dev, profile_n)
    pre_groups, edges = res.pre_groups, expect["hit_rows"][:, :2]
    del res
    rec["profile"] = {"proteins": len(ps.ids)}
    if dev.type == "cuda":
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            with profiling.device_trace(tmp) as path:
                ps.search_all()
            wall_us = (time.perf_counter() - t0) * 1e6
            rec["profile"].update(_trace_summary(path, wall_us))
    print(f"phase9 one search_all slice traced: "
          f"{json.dumps(rec['profile'])}", flush=True)
    rec["extend_windowed"] = compare_extension(ps, dev)
    del ps
    long_db, _ = protein_families(long_n, plen=PC_LONG_LEN, seed=1)
    rec["extend_chunked"] = compare_extension(
        pipeline.ProteinSearcher(long_db, device=dev), dev)
    print(f"phase9 extension card vs CPU: windowed "
          f"{json.dumps(rec['extend_windowed'])}; chunked "
          f"{json.dumps(rec['extend_chunked'])}", flush=True)
    rec["cluster_long"] = run_pcluster_long(dev, long_log2, kw)

    # the gapped path, on the corpus with bench_gapped's indels: on the
    # substitution-only corpus no gap pays, so no traceback would run
    gdb, g_fam = protein_families(1 << gapped_log2)
    gdb = dataclasses.replace(gdb, seq=add_indels(
        gdb.seq.reshape(-1, gdb.lengths[0]), g_fam).reshape(-1))
    t0 = time.perf_counter()
    plain = pcluster.cluster_proteins(gdb, torch.Generator().manual_seed(0),
                                      device=dev, **kw)
    plain_s = time.perf_counter() - t0
    profiling.reset()
    ck.reset_launches()
    t0 = time.perf_counter()
    gapped = pcluster.cluster_proteins(
        gdb, torch.Generator().manual_seed(0), gapped=True, device=dev, **kw)
    gapped_s = time.perf_counter() - t0
    gapped_launches = ck.launch_counts()
    gs = first_table_searcher(gdb, plain.pre_groups, dev)
    by_query: dict = {}
    for h in plain.hits:
        by_query.setdefault(h.query, []).append(h)
    queries = [(np.asarray(gdb.protein(q)), qh)
               for q, qh in by_query.items()]
    where, _, q, ql, d, dl = pipeline.gapped_windows(gs, queries)
    cut = gs.cutoffs
    sub = torch.as_tensor(pipeline._sub21())
    bargs = (cut.gap_open, cut.gap_extend, int(round(cut.gap_ext_drop)), 32)
    on_dev = [torch.as_tensor(x, device=dev) for x in (q, ql, d, dl)]
    got = gapped_device.banded_scores(*on_dev, sub.to(dev), *bargs)
    want = gapped_device.banded_scores(
        *(torch.as_tensor(x) for x in (q, ql, d, dl)), sub, *bargs)
    if not all(torch.equal(g.cpu(), w) for g, w in zip(got, want)):
        raise AssertionError("banded_scores on the card differs from the "
                             "CPU")
    # the kernel against its plain version on the card, the same windows
    banded_st: dict = {}
    plain_dev = gapped_device.banded_scores_plain(
        *on_dev, sub.to(dev), *bargs, stats_out=banded_st)
    banded_err = max(int((g - w).abs().max()) if len(g) else 0
                     for g, w in zip(got, plain_dev))
    if banded_err:
        raise AssertionError("the banded_scores kernel differs from "
                             "banded_scores_plain on the card")
    banded_rows = int(banded_st["rows"].sum())
    banded_bnd, banded_by = banded_bound(len(where), q.shape[1], d.shape[1],
                                         2 * bargs[3] + 1, banded_rows)
    tracebacks = sum(int(s_) > queries[qi][1][i].score
                     for (qi, i), s_ in zip(where, got[0].cpu().tolist()))
    rows = [dataclasses.astuple(h) for h in gapped.hits]
    rec["gapped"] = {
        "proteins": 1 << gapped_log2, "ungapped_s": plain_s,
        "gapped_s": gapped_s,
        "refine_s": profiling.report()["align/gapped"]["total_s"],
        "windows": len(where), "window_shape": [int(q.shape[1]),
                                                int(d.shape[1])],
        "launches": gapped_launches,
        "banded_bitwise": True, "banded_max_abs_err": banded_err,
        "banded_rows_scanned": banded_rows,
        "banded_ms_per_call": _time_ms(
            lambda: gapped_device.banded_scores(*on_dev, sub.to(dev),
                                                *bargs), dev),
        "banded_plain_ms_per_call": _time_ms(
            lambda: gapped_device.banded_scores_plain(*on_dev, sub.to(dev),
                                                      *bargs), dev, reps=1),
        "banded_bound_ms": banded_bnd, "banded_bound_by": banded_by,
        "host_tracebacks": tracebacks,
        "hits_changed": sum(a != dataclasses.astuple(b)
                            for a, b in zip(rows, plain.hits)),
        "labels_equal_ungapped": bool(np.array_equal(gapped.labels,
                                                     plain.labels))}
    print(f"phase9 gapped: {json.dumps(rec['gapped'])}", flush=True)
    windows = [(q[r, :ql[r]], d[r, :dl[r]])
               for r in range(min(HOST_GAPPED_WINDOWS, len(where)))]
    del gs, queries, q, d, on_dev, got, want, plain_dev

    # the same clustering on the card and on the CPU
    cdb, _ = protein_families(1 << cross_log2)
    kp = [pcluster.klsh_init(torch.Generator().manual_seed(4), bits=PC_BITS,
                             sigma=PC_SIGMA)]
    outs = [pcluster.cluster_proteins(cdb, None, klsh_params=kp, device=d_,
                                      **kw) for d_ in (dev, "cpu")]
    if not (np.array_equal(outs[0].labels, outs[1].labels)
            and [dataclasses.astuple(h) for h in outs[0].hits]
            == [dataclasses.astuple(h) for h in outs[1].hits]):
        raise AssertionError(f"cluster_proteins on {dev} differs from the "
                             "CPU")
    rec["card_vs_cpu"] = {"proteins": 1 << cross_log2,
                          "hits": len(outs[0].hits), "identical": True}
    print(f"phase9 cluster_proteins on {dev} == CPU at "
          f"{1 << cross_log2} proteins ({len(outs[0].hits)} hits, every "
          "field)", flush=True)
    del outs, cdb
    # the host library on this phase's path: its calls over the phase
    rec["host_library_calls"] = calls = native_ext.call_counts()
    print(f"phase9 host library calls: {json.dumps(calls)}", flush=True)
    missing = [k for k in ("seed_codes", "argsort_u64", "align_gapped")
               if calls[k] <= 0]
    if missing:
        raise AssertionError(f"phase 9 never called the host library's "
                             f"{missing}: {calls}")
    rec["host_library"] = run_host_library(db, pre_groups, edges, windows,
                                           bargs)
    del db, pre_groups, edges, windows
    if cli:
        rec["cli"] = run_pcluster_cli(protein_families(1 << PC_CLI_LOG2)[0],
                                      dev)
    return rec, expect


def run_pcluster_long(dev, log2, kw):
    """cluster_proteins on 2^log2 proteins of PC_LONG_LEN residues (past
    the 512 up to which the CPU takes the window-dense form): seconds,
    the stages, the kernel's launches, family-pair recall and the peak
    of allocated device memory."""
    import torch
    from hsearch_tpu_torch.cluster import pcluster
    from hsearch_tpu_torch.examples.bench_align import (family_pair_recall,
                                                        protein_families)
    from hsearch_tpu_torch.ops import cuda_kernels as ck
    from hsearch_tpu_torch.utils import profiling
    db, n_fam = protein_families(1 << log2, plen=PC_LONG_LEN, seed=3)
    profiling.reset()
    ck.reset_launches()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    res = pcluster.cluster_proteins(db, torch.Generator().manual_seed(0),
                                    device=dev, **kw)
    _sync(dev)
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else None
    stages = {k: v["total_s"] for k, v in profiling.report().items()}
    rec = {"proteins": 1 << log2, "residues": int(db.starts[-1]),
           "seconds": secs, "pre_groups": len(res.pre_groups),
           "pairs_extended": res.pairs_extended, "hits": len(res.hits),
           "clusters": int(len(np.unique(res.labels))),
           "family_pair_recall": family_pair_recall(res.labels, n_fam),
           "align_extend_s": stages.get("align/extend"),
           "stages_s": stages, "kernel_launches": ck.launch_counts(),
           "peak_allocated_bytes": peak}
    print(f"phase9 cluster_proteins on {PC_LONG_LEN}-residue proteins: "
          f"{json.dumps(rec)}", flush=True)
    if dev.type == "cuda" and rec["kernel_launches"]["extend_pairs"] <= 0:
        raise AssertionError("the long-protein run never launched the "
                             "extension kernel")
    if not res.hits:
        raise AssertionError("the long-protein run found no hit")
    return rec


# each host-library binding: the JAX package's C function it replaces
# (native/hsearch_native.cpp) and its binding (hsearch_tpu/native_ext.py)
HOST_REPLACES = {
    "parse_fasta_bytes": ("native/hsearch_native.cpp:65", 156),
    "suffix_array": ("native/hsearch_native.cpp:120", 181),
    "union_find_labels": ("native/hsearch_native.cpp:149", 193),
    "brute_search_cpp": ("native/hsearch_native.cpp:275", 206),
    "align_gapped": ("native/hsearch_native.cpp:177", 232),
    "seed_codes": ("native/hsearch_native.cpp:317", 330),
    "searchsorted_right": ("native/hsearch_native.cpp:542", 356),
    "argsort_u64": ("native/hsearch_native.cpp:452 (radix :378)", 369),
    "argsort_u32": ("native/hsearch_native.cpp:532 (radix :461)", 381),
    "pair_prep": ("native/hsearch_native.cpp:608", 399),
    "probe_sorted": ("native/hsearch_native.cpp:560 and :709", 430),
}


def host_kernels(pc_rec) -> list[dict]:
    """The host_kernels line: per binding, what it replaces, its calls
    over phase 9 and phase 9h's native and numpy seconds."""
    host = pc_rec["host_library"]
    out = []
    for name, (c_line, py_line) in HOST_REPLACES.items():
        out.append({"name": name, "route": "cpp-openmp",
                    "source": "hsearch_tpu_torch/csrc/hostops.cpp",
                    "binding": "hsearch_tpu_torch/native_ext.py",
                    "replaces": c_line,
                    "binding_replaces":
                        f"hsearch_tpu/native_ext.py:{py_line}",
                    "calls": pc_rec["host_library_calls"][name],
                    **host[name]})
    out.append({"name": "collapse_diag_runs", "route": "cpp-openmp "
                "(argsort_u64 twice)",
                "replaces": "hsearch_tpu/align/pipeline.py:93",
                **host["collapse_diag_runs"]})
    return out


def _same(a, b) -> bool:
    """Equal values and dtypes, through tuples and lists."""
    if isinstance(a, (tuple, list)):
        return isinstance(b, (tuple, list)) and len(a) == len(b) \
            and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and a.dtype == b.dtype \
            and np.array_equal(a, b)
    return a == b


def run_host_library(db, pre_groups, edges, windows, gap_args):
    """Phase 9h: each host-library binding on phase 9's corpus against its
    numpy twin, bitwise, with both times (one call each, host clock).
    Returns {binding: {native_s, numpy_s, shape ...}}."""
    from hsearch_tpu_torch import native_ext as nat
    from hsearch_tpu_torch.align import hostops, pipeline, seed_index
    from hsearch_tpu_torch.cluster import union_find
    from hsearch_tpu_torch.core import dataprep, embedding
    from hsearch_tpu_torch.core import io as hio
    rows: dict = {}
    t_phase = time.perf_counter()

    def both(name, native, plain, same=_same, **shape):
        t0 = time.perf_counter()
        got = native()
        t1 = time.perf_counter()
        want = plain()
        t2 = time.perf_counter()
        if not same(got, want):
            raise AssertionError(f"host library {name} differs from its "
                                 "numpy twin")
        rows[name] = {"native_s": t1 - t0, "numpy_s": t2 - t1, **shape}
        print(f"phase9h {name}: native {t1 - t0:.4f} s, numpy "
              f"{t2 - t1:.4f} s, bitwise {json.dumps(shape)}", flush=True)
        return got

    g21 = seed_index._GROUP21
    seq = np.asarray(db.seq, np.int32)
    starts = np.asarray(db.starts, np.int64)
    code, valid6, _, _, _ = both(
        "seed_codes", lambda: nat.seed_codes(seq, starts, g21),
        lambda: hostops.seed_codes(seq, starts, g21), positions=len(seq))
    pos = np.nonzero(valid6)[0]
    c = code[pos].astype(np.uint64)
    both("argsort_u64", lambda: nat.argsort_u64(c),
         lambda: hostops.argsort_u64(c), keys=len(c))
    both("searchsorted_right", lambda: nat.searchsorted_right(starts, pos),
         lambda: hostops.searchsorted_right(starts, pos),
         sorted=len(starts), queries=len(pos))
    del code, valid6, pos, c

    # the table's group-partitioned searcher (host side only): its largest
    # group's codes, and the probe and pair preparation of its first
    # search_all slice (the queries of the first pair_budget candidates)
    t0 = time.perf_counter()
    s = first_table_searcher(db, pre_groups, "cpu")
    rows["index_build_s"] = time.perf_counter() - t0
    code, valid6, _, _, _ = nat.seed_codes(s.seq, s.starts, g21)
    cs = code[np.nonzero(valid6)[0]]
    gs = np.asarray(s.index.group_starts, np.int64)
    big = int(np.argmax(np.diff(gs)))
    cg = cs[gs[big]:gs[big + 1]]
    both("argsort_u32", lambda: nat.argsort_u32(cg),
         lambda: hostops.argsort_u32(cg), keys=len(cg), groups=len(gs) - 1)
    del code, valid6, cs, cg
    p = s.params
    code_c, _, valid10, qgrp10 = seed_index.host_codes(s.seq, s.starts)
    qidx = np.nonzero(valid10)[0]
    qgroups = np.repeat(s.groups.astype(np.int64), np.diff(s.starts))[qidx]
    counts = seed_index.bucket_counts(s._hview, code_c[qidx], p.cand_max,
                                      qgroups=qgroups)
    b = min(len(qidx), int(np.searchsorted(np.cumsum(counts),
                                           p.pair_budget)) + 1)
    qidx, qgroups = qidx[:b], qgroups[:b]
    qk = seed_index.query_keys(s._hview, code_c[qidx], qgroups)
    qg = qgrp10[qidx].astype(np.int32)
    v = s._hview
    del code_c, valid10, qgrp10, counts
    rows_, dpos, _ = both(
        "probe_sorted",
        lambda: nat.probe_sorted(v.keys64, v.positions,
                                 qk.astype(np.uint64), v.g10_at, qg,
                                 p.cand_max),
        lambda: hostops.probe_sorted(v.keys, v.positions, qk, v.g10_at, qg,
                                     p.cand_max), queries=len(qk))
    q64 = qidx.astype(np.int64)
    tol = int(p.collapse_runs)

    def prep_same(got, want):
        return _same(got[0], want[0]) and _same(
            got[1], np.stack([want[1], want[2]]).astype(np.int32))

    six, _ = both("pair_prep",
                  lambda: nat.pair_prep(rows_, dpos, q64, s.starts, s.ids,
                                        None, tol),
                  lambda: hostops.pair_prep(rows_, dpos, q64, s.starts,
                                            s.ids, None, tol),
                  same=prep_same, pairs=len(rows_), collapse_tol=tol)
    rows["pair_prep"]["survivors"] = int(six.shape[1])
    six0, pids0 = nat.pair_prep(rows_, dpos, q64, s.starts, s.ids, None, 0)
    del rows_, dpos, six, s, v, qk
    both("collapse_diag_runs",
         lambda: hostops.collapse_diag_runs(six0[0], six0[1], pids0[0],
                                            pids0[1], tol,
                                            argsort=nat.argsort_u64),
         lambda: hostops.collapse_diag_runs(six0[0], six0[1], pids0[0],
                                            pids0[1], tol),
         pairs=int(six0.shape[1]))
    del six0, pids0

    sub21 = pipeline._sub21()
    both("align_gapped",
         lambda: [nat.align_gapped(q, d, sub21, *gap_args)
                  for q, d in windows],
         lambda: [hostops.align_gapped(q, d, sub21, *gap_args)
                  for q, d in windows], windows=len(windows))
    n = db.num_proteins

    def uf_plain():
        uf = union_find.UnionFind(n)
        uf.union_edges(edges[:, 0], edges[:, 1])
        return uf.components()

    both("union_find_labels",
         lambda: nat.union_find_labels(n, edges[:, 0], edges[:, 1]),
         uf_plain, nodes=n, edges=len(edges))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "corpus.fasta")
        hio.write_fasta(path, db.names, [db.protein(i) for i in range(n)])
        with open(path, "rb") as f:
            data = f.read()

        def parse_plain():
            py = hio.read_fasta(io.StringIO(data.decode()), seed=None)
            return py.names, py.seq, py.starts

        def parse_same(got, want):
            names, pseq, pstarts = got
            folded = np.where(pseq == 20, np.uint8(255), pseq)
            return names == want[0] and _same(folded, want[1]) \
                and _same(pstarts, want[2])

        both("parse_fasta_bytes", lambda: nat.parse_fasta_bytes(data),
             parse_plain, same=parse_same, bytes=len(data), records=n)
        with open(path) as f:
            via_file = hio.read_fasta(f, seed=0)
        via_path = hio.read_fasta(path, seed=0)
        if not (via_path.names == via_file.names
                and _same(via_path.seq, via_file.seq)
                and _same(via_path.starts, via_file.starts)):
            raise AssertionError("read_fasta through the host library "
                                 "differs from the Python parser")
    pre = seq[:SA_PREFIX]
    both("suffix_array", lambda: nat.suffix_array(pre),
         lambda: dataprep.suffix_array(pre), residues=len(pre))
    kmers = np.lib.stride_tricks.sliding_window_view(pre, L)
    centers = np.ascontiguousarray(kmers[:2])

    def brute_plain():
        dsq = np.asarray(embedding.DISTANCE_SQUARE, np.float64)
        d2 = np.zeros((len(centers), len(kmers)))
        for i in range(L):
            d2 += dsq[centers[:, i][:, None], kmers[:, i][None, :]]
        ci, ki = np.nonzero(d2 <= RADIUS ** 2)
        return ci.astype(np.int64), ki.astype(np.int64), \
            np.sqrt(d2[ci, ki])

    both("brute_search_cpp",
         lambda: nat.brute_search_cpp(centers, kmers, RADIUS), brute_plain,
         centers=len(centers), kmers=len(kmers))
    rows["phase_s"] = time.perf_counter() - t_phase
    print(f"phase9h host library == numpy twins in {rows['phase_s']:.1f} s",
          flush=True)
    return rows


def seed_checkpoint(db, pre_groups, n_probe=2000):
    """Phase 9: the corpus's group-partitioned seed index (the table's
    pre-groups) through a ``seed`` checkpoint: save and load seconds, file
    bytes, every array and the probe of the first ``n_probe`` proteins'
    seeds unchanged."""
    from hsearch_tpu_torch.align import seed_index
    from hsearch_tpu_torch.utils import checkpoint
    seq = np.asarray(db.seq, np.int32)
    starts = np.asarray(db.starts, np.int64)
    group_of = np.empty(len(starts) - 1, np.int64)
    for g, members in enumerate(pre_groups):
        group_of[members] = g
    t0 = time.perf_counter()
    idx, view = seed_index.build_index_and_view(seq, starts, group_of)
    rec = {"positions": int(idx.num_positions), "groups": len(pre_groups),
           "build_s": time.perf_counter() - t0}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "seed.npz")
        t0 = time.perf_counter()
        checkpoint.save_index(path, idx)
        rec["save_s"] = time.perf_counter() - t0
        rec["file_bytes"] = os.path.getsize(path)
        t0 = time.perf_counter()
        back = checkpoint.load_index(path)
        rec["load_s"] = time.perf_counter() - t0
    for f in ("sorted_codes", "positions", "seq", "starts", "group_starts",
              "g10_at"):
        if not np.array_equal(getattr(idx, f), getattr(back, f)):
            raise AssertionError(f"seed checkpoint changed {f}")
    qs = starts[:n_probe + 1]
    code, _, v10, qg10 = seed_index.host_codes(seq[:qs[-1]], qs)
    q = np.nonzero(v10)[0]
    qgroups = np.repeat(group_of[:n_probe], np.diff(qs))[q]
    want = seed_index.probe_host(view, code[q], qg10[q], 64, qgroups)
    got = seed_index.probe_host(seed_index.host_view(back), code[q],
                                qg10[q], 64, qgroups)
    if not (np.array_equal(got[0], want[0])
            and np.array_equal(got[1], want[1]) and got[2] == want[2]):
        raise AssertionError("the loaded seed index probes differently")
    rec["probe_pairs"] = int(len(got[0]))
    return rec


def run_sharded(dev, db, centers, truth, c_blk, fit=FIT, agree=AGREE):
    """Phase 10: the sharded, multi-process and training paths on one
    device.  Returns the record and the kernel launches of the sharded
    IVF and LSH searches."""
    import dataclasses
    import socket

    import torch
    from hsearch_tpu_torch import metric
    from hsearch_tpu_torch.core import blosum, embedding
    from hsearch_tpu_torch.ops import cuda_kernels as ck
    from hsearch_tpu_torch.parallel import mesh as mesh_lib, multihost
    from hsearch_tpu_torch.parallel import sharded, train
    from hsearch_tpu_torch.search import evaluate, exact, motif
    gci, gki, gd = truth
    rec, launches = {}, {}
    mesh = mesh_lib.make_mesh(SH_DB, data=1, devices=[dev] * SH_DB)

    # the sharded IVF search on phase 3's database, per-shard kb ladder
    t0 = time.perf_counter()
    sidx = sharded.build_ivf_index(db, torch.Generator().manual_seed(0),
                                   mesh, block_size=32, max_hits=MAX_HITS)
    _sync(dev)
    ivf_rec = {"shards": SH_DB, "build_s": time.perf_counter() - t0,
               "blocks": [s.num_blocks for s in sidx.shards[0]],
               "ladder": {}}
    ck.reset_launches()
    for kb in SH_KB_LADDER:
        st: dict = {}
        ci, ki, _ = sharded.search_ivf(sidx, centers, RADIUS, k_blocks=kb,
                                       center_block=c_blk, stats_out=st)
        r = evaluate.recall_from_indices(gci, gki, gd, ci, ki, RADIUS)
        ivf_rec["ladder"][kb] = {"recall": r.recall, **st}
        print(f"phase10 sharded ivf kb={kb} recall={r.recall:.6f} {st}",
              flush=True)
        if r.recall >= 0.99:
            break
    if r.recall < 0.99:
        raise AssertionError(f"sharded ivf recall {r.recall} < 0.99 at the "
                             "top of its kb ladder")
    iters = 3
    t0 = time.perf_counter()
    for _ in range(iters):
        sharded.search_ivf(sidx, centers, RADIUS, k_blocks=kb,
                           center_block=c_blk, stats_out={})
    ivf_rec.update(kb=kb, recall=r.recall, hits=int(len(ci)),
                   search_ms=(time.perf_counter() - t0) * 1e3 / iters)
    launches["sharded_ivf"] = ck.launch_counts()
    ivf_rec["launches"] = launches["sharded_ivf"]
    rec["ivf"] = ivf_rec
    print(f"phase10 sharded ivf: {json.dumps(ivf_rec)}", flush=True)
    del sidx

    # exactness at k_blocks = blocks_per_shard on phase 4's set
    n4 = 1 << (EXACT_N_LOG2 if dev.type == "cuda" else 12)
    db4, c4 = db[:n4], centers[:EXACT_C]
    gen4 = torch.Generator().manual_seed(0)
    sidx4 = sharded.build_ivf_index(db4, gen4, mesh, block_size=32,
                                    max_hits=MAX_HITS)
    ex4 = sharded.search_ivf(sidx4, c4, RADIUS,
                             k_blocks=sidx4.blocks_per_shard,
                             center_block=EXACT_C)
    g4 = exact.search_radius(db4, c4, RADIUS, device=dev)
    if _pairs(ex4[0], ex4[1]) != _pairs(g4[0], g4[1]):
        raise AssertionError("sharded ivf at k_blocks = blocks_per_shard "
                             "differs from the oracle")
    rec["exact"] = {"n": n4, "centers": len(c4), "hits": int(len(ex4[0])),
                    "blocks_per_shard": sidx4.blocks_per_shard}
    print(f"phase10 sharded exactness: {json.dumps(rec['exact'])} == "
          "oracle", flush=True)

    # the sharded LSH at the tuned point's K, L, W and probes against the
    # single-device engine with the same parameters.  Phase 6's cand_max
    # 2048 truncates buckets (every center is skewed), and a shard's
    # buckets are a quarter of the whole index's, so the two truncate
    # different candidates: both take cand_max = the index's largest
    # bucket here, where neither truncates and the hit sets must be equal
    _, cfg, _ = lsh_configs()[1]
    cen = centers[:min(LSH_C, centers.shape[0])]
    one = motif.build_index(db, torch.Generator().manual_seed(0),
                            dataclasses.replace(cfg, cand_limit=1 << 30),
                            device=dev)
    cm = one.cand_max
    ost: dict = {}
    oc, ok_, _ = motif.search(one, cen, cfg, stats_out=ost)
    del one
    t0 = time.perf_counter()
    slsh = sharded.build_index(db, torch.Generator().manual_seed(0), mesh,
                               cfg, cand_max=cm)
    _sync(dev)
    lsh_build_s = time.perf_counter() - t0
    sst: dict = {}
    ck.reset_launches()
    t0 = time.perf_counter()
    lc, lk, _ = sharded.search(slsh, cen, RADIUS,
                               center_block=cfg.center_block, stats_out=sst)
    lsh_ms = (time.perf_counter() - t0) * 1e3
    launches["sharded_lsh"] = ck.launch_counts()
    del slsh
    if ost["skewed"] or sst["skewed"] or _pairs(lc, lk) != _pairs(oc, ok_):
        raise AssertionError(f"sharded LSH ({sst}) differs from the "
                             f"single-device engine ({ost}) with the same "
                             "parameters")
    rec["lsh"] = {"centers": len(cen), "cand_max": cm,
                  "build_s": lsh_build_s, "search_ms": lsh_ms,
                  "hits": int(len(lc)), "stats": sst,
                  "launches": launches["sharded_lsh"]}
    print(f"phase10 sharded lsh == single-device: {json.dumps(rec['lsh'])}",
          flush=True)

    # exact_topk against the exact oracle
    tn, tc, tk = SH_TOPK
    tn = tn if dev.type == "cuda" else 12
    dbt, ct = db[:1 << tn], centers[:tc]
    t0 = time.perf_counter()
    ti, tdist = sharded.exact_topk(dbt, ct, tk, mesh)
    topk_s = time.perf_counter() - t0
    od, oi = exact.search_topk(dbt, ct, tk + 1, device=dev)
    if not np.allclose(tdist ** 2, od[:, :tk] ** 2, rtol=1e-5, atol=1e-4):
        raise AssertionError("exact_topk distances differ from the oracle")
    clear = od[:, tk - 1] < od[:, tk]
    for i in np.nonzero(clear)[0]:
        if set(ti[i].tolist()) != set(oi[i, :tk].tolist()):
            raise AssertionError(f"exact_topk ids differ for center {i}")
    rec["exact_topk"] = {"n": 1 << tn, "centers": len(ct), "k": tk,
                         "seconds": topk_s, "centers_id_checked":
                         int(clear.sum())}
    print(f"phase10 exact_topk == oracle: {json.dumps(rec['exact_topk'])}",
          flush=True)

    # a world of one through multihost.initialize, then torn down
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    t0 = time.perf_counter()
    multihost.initialize(f"127.0.0.1:{port}", 1, 0, device=dev.type,
                         timeout_s=120)
    try:
        init_s = time.perf_counter() - t0
        hm = multihost.host_mesh(SH_DB, local_devices=[dev] * SH_DB)
        echo = multihost._gather_blocks(torch.arange(4, device=dev)[None])
        miv = multihost.build_ivf_index(
            db4, n4, torch.Generator().manual_seed(0), hm, block_size=32,
            max_hits=MAX_HITS)
        mres = multihost.search_ivf(miv, c4, RADIUS,
                                    k_blocks=sidx4.blocks_per_shard,
                                    center_block=EXACT_C)
        backend = torch.distributed.get_backend()
    finally:
        torch.distributed.destroy_process_group()
    if not (all(np.array_equal(a, b) for a, b in zip(mres, ex4))
            and echo.tolist() == [[0, 1, 2, 3]]):
        raise AssertionError("the world-of-one search differs from the "
                             "single-process sharded one")
    rec["multihost"] = {"backend": backend, "init_s": init_s,
                        "hits": int(len(mres[0]))}
    print(f"phase10 multihost world of one: {json.dumps(rec['multihost'])}"
          " == sharded", flush=True)
    del sidx4, miv

    # fit_embedding at the CLI's defaults, on the device and on the CPU
    t0 = time.perf_counter()
    coords = train.fit_embedding(**fit, device=dev)
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    coords_cpu = train.fit_embedding(**fit, device="cpu")
    fit_cpu_s = time.perf_counter() - t0

    def mean_err(x):
        d = np.linalg.norm(x[:, None] - x[None, :], axis=-1)
        return float(np.abs(d - blosum.BLOSUM_DISTANCE).mean())

    rec["fit"] = {**fit, "seconds": fit_s, "cpu_seconds": fit_cpu_s,
                  "mean_abs_err": mean_err(coords),
                  "shipped_mean_abs_err": mean_err(embedding.COORDINATES),
                  "max_diff_vs_cpu": float(np.abs(coords - coords_cpu).max())}
    print(f"phase10 fit_embedding: {json.dumps(rec['fit'])}", flush=True)
    if rec["fit"]["mean_abs_err"] >= 1.1 * rec["fit"]["shipped_mean_abs_err"]:
        raise AssertionError("fit_embedding misses the 1.1x bar")
    if rec["fit"]["max_diff_vs_cpu"] > 1e-3:
        raise AssertionError("fit_embedding on the device differs from the "
                             "CPU run by more than 1e-3")

    # the mesh train step on the logical shards against one device
    rng = np.random.default_rng(0)
    c0 = rng.normal(0, 1, (20, 8)).astype(np.float32)
    batch = [torch.as_tensor(x, device=dev)
             for x in train.sample_pair_batch(rng, 4096, 4)]
    stepped = []
    for m in (None, mesh):
        c = torch.tensor(c0, device=dev, requires_grad=True)
        train.make_train_step(torch.optim.Adam([c], lr=3e-2), m)(*batch)
        stepped.append(c.detach().cpu().numpy())
    step_diff = float(np.abs(stepped[0] - stepped[1]).max())
    if step_diff > 1e-5:
        raise AssertionError(f"mesh train step differs by {step_diff}")
    rec["mesh_step_max_diff"] = step_diff

    # topk_agreement, the device against the CPU
    length, k, nq = agree
    t0 = time.perf_counter()
    a_dev = metric.topk_agreement(np.random.default_rng(0), length, k, nq,
                                  device=dev)
    agree_s = time.perf_counter() - t0
    a_cpu = metric.topk_agreement(np.random.default_rng(0), length, k, nq,
                                  device="cpu")
    if a_dev != a_cpu:
        raise AssertionError(f"topk_agreement {a_dev} on {dev} != {a_cpu}")
    rec["topk_agreement"] = {"length": length, "k": k, "queries": nq,
                             "value": a_dev, "seconds": agree_s}
    print(f"phase10 mesh step diff {step_diff:.3e}; topk_agreement "
          f"{json.dumps(rec['topk_agreement'])} == CPU", flush=True)
    return rec, launches


def _mp_cluster(module, env, nproc=2):
    """A local ``module`` cluster of nproc processes whose ranks compute
    where ``env`` says (gloo collectives on the CPU: NCCL refuses two ranks
    on one card).  Returns (wall seconds, each rank's MP_CHECK_OK line)."""
    from hsearch_tpu_torch.parallel import _mp_check
    t0 = time.perf_counter()
    outs = _mp_check.run_local_cluster(nproc=nproc, ndev_per_proc=1,
                                       timeout=600, module=module,
                                       extra_env=env)
    return time.perf_counter() - t0, [
        next(ln for ln in o.splitlines() if ln.startswith("MP_CHECK_OK"))
        for o in outs]


def _field(line, key):
    return line.split(f"{key}=")[1].split()[0]


def run_distributed(dev, db, greedy_res, pc_expect, group_log2):
    """Phase 11: distributed clustering.  11a: phase 7's k-mers and config
    through a 2-process greedy_dist cluster computing on ``dev``, bit for
    bit phase 7's parent / merged; hclust2 --merge-radius as a world of
    one (NCCL on the card) writing the file of the run without --dist-*.
    11b: 2-process pcluster_dist clusters on ``dev``: phase 9's corpus and
    KLSH draw (query mode) against phase 9's labels, pre-groups and hit
    rows; a 2^group_log2-protein corpus of the same recipe at bits 16,
    sigma 0.2, two tables, against a single-process run in each rank.
    Returns the record."""
    import socket

    import torch
    from hsearch_tpu_torch.cluster import pcluster
    from hsearch_tpu_torch.examples.bench_align import protein_families
    rec: dict = {}
    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    with tempfile.TemporaryDirectory() as tmp:
        def path(name):
            return os.path.join(tmp, name)

        # 11a: greedy_dist against phase 7
        np.save(path("kmers.npy"), db.astype(np.int8))
        np.savez(path("greedy.npz"), config=[16, 8, 50.0, RADIUS], seed=1,
                 parent=greedy_res.parent, merged=greedy_res.merged)
        secs, lines = _mp_cluster(
            "hsearch_tpu_torch.cluster._mp_greedy_check",
            {"GREEDY_CHECK_DEVICE": dev.type,
             "GREEDY_CHECK_KMERS": path("kmers.npy"),
             "GREEDY_CHECK_NPZ": path("greedy.npz"),
             "GREEDY_CHECK_MERGE_RADIUS": 0})
        rec["greedy"] = {"n": int(len(db)), "processes": 2, "wall_s": secs,
                         "rank_s": [float(_field(ln, "seconds"))
                                    for ln in lines],
                         # each rank's single-process run, its first
                         # (with the warm-up), before the distributed one
                         "rank_single_first_s": [
                             float(_field(ln, "ref_seconds"))
                             for ln in lines],
                         "clusters": int(_field(lines[0], "clusters"))}
        print(f"phase11a greedy_dist, 2 processes on {dev.type} == phase 7 "
              f"bit for bit: {json.dumps(rec['greedy'])}", flush=True)
        rows = db[:1 << DIST_CLI_LOG2]
        _write_kmers_fasta(path("k.fasta"), "k", rows)
        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            port = sk.getsockname()[1]
        files, cli_s = {}, {}
        for name, extra in (("single", []), ("world_of_one", [
                "--dist-nproc", "1", "--dist-pid", "0",
                "--dist-coordinator", f"127.0.0.1:{port}"])):
            out = path(f"{name}.txt")
            t0 = time.perf_counter()
            subprocess.run([sys.executable, "-m", "hsearch_tpu_torch",
                            "hclust2", "-d", path("k.fasta"), "-o", out,
                            "-l", str(L), "-k", "16", "-L", "8", "-T",
                            str(RADIUS), "--merge-radius", str(RADIUS),
                            "--device", dev.type, *extra], check=True,
                           env=env, cwd=tmp, timeout=300)
            cli_s[name] = time.perf_counter() - t0
            with open(out) as f:
                files[name] = f.read()
        if files["world_of_one"] != files["single"]:
            raise AssertionError("hclust2 --dist-nproc 1 wrote another file "
                                 "than hclust2")
        rec["cli"] = {"rows": len(rows), "seconds": cli_s,
                      "clusters": files["single"].count("#cluster")}
        print(f"phase11a hclust2 --merge-radius, world of one == without "
              f"--dist-*: {json.dumps(rec['cli'])}", flush=True)

        # 11b: pcluster_dist, query mode against phase 9
        np.savez(path("pc9_db.npz"), seq=pc_expect["seq"],
                 starts=pc_expect["starts"])
        np.savez(path("pc9.npz"), **{k: v for k, v in pc_expect.items()
                                     if k not in ("seq", "starts")})
        # 11b: group mode against a single-process run in each rank
        gdb, _ = protein_families(1 << group_log2)
        gen = torch.Generator().manual_seed(0)
        kps = [pcluster.klsh_init(gen, bits=16, sigma=0.2) for _ in range(2)]
        np.savez(path("grp_db.npz"), seq=gdb.seq, starts=gdb.starts)
        np.savez(path("grp.npz"), **{f: np.stack([getattr(k, f).numpy()
                                                  for k in kps])
                                     for f in ("w", "t", "b")})
        for tag, corpus, npz in (("query_phase9", "pc9_db", "pc9"),
                                 ("two_tables", "grp_db", "grp")):
            secs, lines = _mp_cluster(
                "hsearch_tpu_torch.cluster._mp_pcluster_check",
                {"PCLUSTER_CHECK_DEVICE": dev.type,
                 "PCLUSTER_CHECK_DB": path(f"{corpus}.npz"),
                 "PCLUSTER_CHECK_NPZ": path(f"{npz}.npz")})
            rec[tag] = {
                "proteins": int(len(np.load(path(f"{corpus}.npz"))["starts"])
                                - 1),
                "processes": 2, "wall_s": secs,
                "rank_s": [float(_field(ln, "seconds")) for ln in lines],
                "rank_single_first_s": [_field(ln, "ref_seconds")
                                        for ln in lines],
                "hits_local": [_field(ln, "hits_local") for ln in lines],
                "modes": _field(lines[0], "modes").split(",")}
            print(f"phase11b pcluster_dist {tag}, 2 processes on "
                  f"{dev.type} == single process: {json.dumps(rec[tag])}",
                  flush=True)
    return rec


def run_pcluster_cli(db, dev):
    """python -m hsearch_tpu_torch pcluster on a small FASTA in a child
    process: .m8 rows of 12 fields, an .aln block per hit up to
    --max-aln, and a .clusters partition of every protein."""
    from hsearch_tpu_torch.core import io as hio
    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    with tempfile.TemporaryDirectory() as tmp:
        fa, out = os.path.join(tmp, "prot.fasta"), os.path.join(tmp, "pc")
        hio.write_fasta(fa, db.names, [db.protein(i)
                                       for i in range(db.num_proteins)])
        subprocess.run([sys.executable, "-m", "hsearch_tpu_torch",
                        "pcluster", "-d", fa, "-o", out, "--bits",
                        str(PC_BITS), "--sigma", str(PC_SIGMA), "--device",
                        dev.type], check=True, env=env, cwd=tmp,
                       timeout=300)
        with open(out + ".m8") as f:
            m8 = [ln.rstrip("\n").split("\t") for ln in f]
        with open(out + ".aln") as f:
            aln = f.read()
        clusters = hio.read_clusters(out + ".clusters")
    bad = [r for r in m8 if len(r) != 12 or r[0] not in db.names
           or r[1] not in db.names]
    members = sorted(m for c in clusters for m in c)
    if bad or not m8 or aln.count(" vs ") != min(len(m8), 100) \
            or members != sorted(db.names):
        raise AssertionError(f"pcluster CLI files malformed: {len(m8)} m8 "
                             f"rows ({len(bad)} bad), {aln.count(' vs ')} "
                             f"aln blocks, {len(members)} cluster members "
                             f"for {db.num_proteins} proteins")
    print(f"phase9 CLI: pcluster wrote {len(m8)} m8 rows, "
          f"{aln.count(' vs ')} aln blocks, {len(clusters)} clusters over "
          f"{len(members)} proteins", flush=True)
    return {"proteins": db.num_proteins, "m8_rows": len(m8),
            "clusters": len(clusters)}


def _write_kmers_fasta(path, prefix, rows):
    aa = "ARNDCQEGHILKMFPSTWYV"
    with open(path, "w") as f:
        for i, r in enumerate(rows):
            f.write(f">{prefix}{i}\n{''.join(aa[x] for x in r)}\n")


def run_stream_cli(db, centers, dev, seg_pts):
    """The tools, called in this process as the command line calls them:
    motif-search --engine stream == motif-search-exact; index-build
    --engine stream, then serve of the centers == motif-search --engine
    stream."""
    import contextlib
    import io
    from hsearch_tpu_torch import cli
    aa = "ARNDCQEGHILKMFPSTWYV"
    with tempfile.TemporaryDirectory() as tmp:
        dbf, cf = (os.path.join(tmp, x) for x in ("db.fasta", "c.fasta"))
        _write_kmers_fasta(dbf, "db", db)
        _write_kmers_fasta(cf, "c", centers)
        qf = os.path.join(tmp, "q.txt")
        seqs = ["".join(aa[x] for x in c) for c in centers]
        with open(qf, "w") as f:
            f.write("\n".join(seqs) + "\n")
        common = ["-l", str(L), "--device", dev.type]
        outs = {}
        for tool, extra in (("motif-search-exact", []),
                            ("motif-search", ["--engine", "stream",
                                              "--segment-points",
                                              str(seg_pts)])):
            out = os.path.join(tmp, f"{tool}.txt")
            cli.main([tool, "-d", dbf, "-c", cf, "-T", str(RADIUS), "-o",
                      out, *common, *extra])
            with open(out) as f:
                outs[tool] = {(a, b): float(d)
                              for a, b, d in (ln.split() for ln in f)}
        idx = os.path.join(tmp, "idx.npz")
        cli.main(["index-build", "-d", dbf, "-o", idx, "--engine", "stream",
                  "--segment-points", str(seg_pts), *common])
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(["serve", "-i", idx, "--input", qf, "-T", str(RADIUS),
                      "--device", dev.type])
        served = buf.getvalue()
    exact_t, stream_t = outs["motif-search-exact"], outs["motif-search"]
    if set(exact_t) != set(stream_t) or len(exact_t) < len(centers):
        raise AssertionError(f"CLI stream ({len(stream_t)} triples) != "
                             f"exact ({len(exact_t)} triples)")
    worst = max(abs(exact_t[k] - stream_t[k]) for k in exact_t)
    if worst > 1e-3:
        raise AssertionError(f"CLI stream distances differ by up to {worst}")
    by_seq = {s: f"c{i}" for i, s in enumerate(seqs)}
    serve_t = {(by_seq[q], f"db{k}"): float(d) for q, k, d in
               (ln.split() for ln in served.splitlines() if ln)}
    if set(serve_t) != set(stream_t):
        raise AssertionError(f"serve ({len(serve_t)} hits) != motif-search "
                             f"--engine stream ({len(stream_t)} triples)")
    print(f"phase8 CLI: motif-search --engine stream == motif-search-exact "
          f"({len(exact_t)} triples over {len(db)} k-mers in segments of "
          f"{seg_pts}, max |dist diff| {worst:.2e}); index-build --engine "
          f"stream + serve == motif-search --engine stream", flush=True)
    return {"rows": len(db), "queries": len(centers),
            "segment_points": seg_pts, "triples": len(exact_t),
            "max_dist_diff": worst}


def profile_call(label, fn, dev):
    """Device time by kernel and the device's idle share over one call
    (torch.profiler); a measurement aid, so a profiler failure is
    reported and does not fail the run."""
    import torch
    if dev.type != "cuda":
        return
    try:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize(dev)
            wall_us = (time.perf_counter() - t0) * 1e6
        events = prof.key_averages()
        rows = sorted(((getattr(e, "device_time_total", 0.0) or 0.0,
                        e.key, e.count) for e in events
                       if (getattr(e, "device_time_total", 0.0) or 0.0) > 0
                       and e.device_type == torch.autograd.DeviceType.CUDA),
                      reverse=True)
        busy = sum(t for t, _, _ in rows)
        print(f"profile one {label}: wall {wall_us / 1e3:.3f} ms, device "
              f"busy {busy / 1e3:.3f} ms (idle share "
              f"{max(0.0, 1 - busy / wall_us):.3f})", flush=True)
        for t, k, n in rows[:15]:
            print(f"profile   {t / 1e3:9.3f} ms  x{n:<4d} {k[:90]}",
                  flush=True)
    except Exception as e:   # measurement aid only: report, keep running
        print(f"profile not measured: {type(e).__name__}: {e}", flush=True)


def run_cli(db, centers, dev):
    """On a small k-mer FASTA, in child processes: motif-search --engine
    ivf (defaults otherwise) == motif-search-exact; --engine lsh (the
    default autotune) finds a subset of it with the same distances; and
    hclust2 --merge-radius writes every row once."""
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
                            ("motif-search", ["--engine", "ivf"]),
                            ("lsh", ["--engine", "lsh"])):
            out = os.path.join(tmp, f"{tool}.txt")
            cmd = [sys.executable, "-m", "hsearch_tpu_torch",
                   "motif-search" if tool == "lsh" else tool,
                   "-d", paths["db"], "-c", paths["centers"], "-l", str(L),
                   "-T", str(RADIUS), "-o", out, "--device", dev.type,
                   *extra]
            subprocess.run(cmd, check=True, env=env, cwd=tmp, timeout=300)
            with open(out) as f:
                outs[tool] = [ln.split() for ln in f]
        clusters = os.path.join(tmp, "clusters.txt")
        subprocess.run([sys.executable, "-m", "hsearch_tpu_torch", "hclust2",
                        "-d", paths["db"], "-o", clusters, "-l", str(L),
                        "-k", "16", "-L", "8", "-T", str(RADIUS),
                        "--merge-radius", str(RADIUS), "--device",
                        dev.type], check=True, env=env, cwd=tmp,
                       timeout=300)
        with open(clusters) as f:
            lines = [ln.rstrip("\n") for ln in f]
    exact_t = {(a, b): float(d) for a, b, d in outs["motif-search-exact"]}
    ivf_t = {(a, b): float(d) for a, b, d in outs["motif-search"]}
    lsh_t = {(a, b): float(d) for a, b, d in outs["lsh"]}
    if set(exact_t) != set(ivf_t) or not exact_t:
        raise AssertionError(f"CLI ivf ({len(ivf_t)} triples) != exact "
                             f"({len(exact_t)} triples)")
    worst = max(abs(exact_t[k] - ivf_t[k]) for k in exact_t)
    if worst > 1e-3:
        raise AssertionError(f"CLI distances differ by up to {worst}")
    if not set(lsh_t) <= set(exact_t) or not lsh_t:
        raise AssertionError(f"CLI lsh ({len(lsh_t)} triples) is not a "
                             "non-empty subset of exact")
    lsh_worst = max(abs(exact_t[k] - lsh_t[k]) for k in lsh_t)
    n_members = sum(1 for ln in lines if ln and not ln.startswith("#"))
    n_clusters = sum(1 for ln in lines if ln.startswith("#clusterid"))
    if n_members != len(db) or not n_clusters:
        raise AssertionError(f"CLI hclust2 wrote {n_members} members in "
                             f"{n_clusters} clusters for {len(db)} rows")
    print(f"phase5 CLI: motif-search --engine ivf == motif-search-exact "
          f"({len(exact_t)} triples, max |dist diff| {worst:.2e}); "
          f"--engine lsh {len(lsh_t)} triples within them (max |dist "
          f"diff| {lsh_worst:.2e}); hclust2 --merge-radius {n_clusters} "
          f"clusters over {n_members} rows", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--stream-n-log2", type=int, default=STREAM_N_LOG2,
                    help="phase 8's database rows, log2 (segments of "
                         f"2^{SEG_LOG2})")
    ap.add_argument("--approx-n-log2", type=int, default=APPROX_N_LOG2,
                    help="phase 3c's index rows, log2")
    ap.add_argument("--trace-out", default=None,
                    help="also write phase 8's profiler trace (Chrome "
                         "JSON) to this path")
    args = ap.parse_args(argv)
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
    (kernels, main_path, approx, lsh, cluster, stream, pcluster, sharded,
     distributed, examples) = run("cuda", stream_n_log2=args.stream_n_log2,
                                  trace_out=args.trace_out,
                                  approx_n_log2=args.approx_n_log2)
    print("kernels " + json.dumps(kernels))
    print("host_kernels " + json.dumps(host_kernels(pcluster)))
    print("main_path " + json.dumps(main_path))
    print("approx_select " + json.dumps(approx))
    print("lsh " + json.dumps(lsh))
    print("cluster " + json.dumps(cluster))
    print("stream " + json.dumps(stream))
    print("pcluster " + json.dumps(pcluster))
    print("sharded " + json.dumps(sharded))
    print("distributed " + json.dumps(distributed))
    print("examples " + json.dumps(examples))
    print(f"total {time.perf_counter() - t0:.1f} s")
    print(smi.splitlines()[0])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
