"""GPU smoke run of hsearch_tpu_torch: kernels, IVF and LSH search,
exactness, k-mer clustering, the segmented (stream) engine, the protein
aligner and pcluster, the sharded, multi-process and training paths, CLI.

    python3 chip_smoke.py [--stream-n-log2 N] [--trace-out PATH]

Needs one CUDA device (exits non-zero without one) and ``nvcc`` for the
kernels, which it builds from ``hsearch_tpu_torch/csrc`` into
``hsearch_tpu_torch/_build``.  Imports neither jax nor hsearch_tpu.

Phases, each of which fails the run on error:
  1. environment: torch/CUDA versions, the card's name and power limit,
     the kernel build;
  2. each kernel against its plain PyTorch version on the card, at the
     main path's shapes (real index data), at ragged small shapes and,
     for prune, past one grid's 65,535 block tiles (C=64, D=8,
     B=8,388,608: two launches):
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
     4096 centers, R = 35): build_index, the exact oracle, ivf.search up
     the k_blocks ladder 128 -> 256 -> 512 until weighted recall >= 0.99,
     then 3 timed searches; kernel launch counts are read around it,
     and torch.profiler gives one search call's device time by kernel;
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
     W=50 R=35) with its stage times, merge_by_center_distance at radius
     35 with the kernel launches it made, cluster counts, sampled
     same-family pair recall and the invariants (every row once, sampled
     members within R of their head); the merge's index build timed
     alone and a profile of its search over 4096 heads;
     cluster_centroid (K=16 L=8) on a 2^18 prefix;
  8. the segmented engine (search/stream.py) on a 2^23-row database of
     the same family shape (generated on the card in chunks; R = 35,
     1024 family-center queries, center blocks of 1024, max_hits 512)
     in 4 segments of 2^21 points: per-segment build seconds, host and
     device bytes; prune and verify at a segment's shape against their
     plain versions, with their times; exactness fully streamed with the
     retry on (== the exact oracle over all rows, d^2 agreeing); the kb
     ladder, retry off, doubling from 128 until weighted recall >= 0.99
     (its last rung, kb = a segment's block count, is lossless); identical
     hits at
     residency 0, 1/2 and 1 with ms per call, per-segment search walls,
     upload dispatch and h2d ms (CUDA events on the copy stream); a
     profiler trace of one fully streamed call (device busy, idle share,
     h2d time overlapped by kernels); segivf save and load; Lloyd
     refinement (kmeans_iters=2) on phase 3's database beside the sampled
     build; the CLI (motif-search --engine stream == motif-search-exact,
     index-build --engine stream + serve == motif-search --engine stream).
     ``--stream-n-log2 24`` runs it at 2^24 rows in 4 segments of 2^22,
     ``--stream-n-log2 27`` at 2^27 rows (32 segments of 2^22, built
     from an iterator of 2^22-row chunks).
  9. the aligner and pcluster on the JAX package's examples/bench_align.py
     corpus (families of 4 copies of a 120-residue base, 4 substitutions
     each, seed 0): cluster_proteins at 100,000 proteins (bits 12, sigma
     0.1, one table, default SearchParams) with seconds, proteins/s,
     pre-groups, seed pairs extended, hits, clusters, family-pair recall
     (gate 0.98) and the stage split; a torch.profiler trace of one
     search_all slice over the first 2^14 proteins' groups (device busy,
     idle share); the first four 8,192-lane batches of that slice through
     the windowed extension on the card and on the CPU, bitwise, and the
     same for the chunked extension on 512 proteins of 600 residues, with
     ms per call; cluster_proteins gapped=True on a 2^14-protein corpus,
     banded_scores on every gap-triggered window card against CPU
     (bitwise), ms per call and the host tracebacks; cluster_proteins on
     2^12 proteins on the card and on the CPU with the same KLSH
     parameters (labels and every Hit field identical); the pcluster CLI;
     the corpus's group-partitioned seed index through a ``seed``
     checkpoint (save and load seconds, arrays and probes unchanged).
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

Output: free-form progress lines; ``kernels``, ``main_path``, ``lsh``,
``cluster``, ``stream``, ``pcluster`` and ``sharded`` lines; the
nvidia-smi name/power line; one JSON object ``{"kernels": [...]}`` and,
last, ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
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
# phase 2: the prune case past one grid's 65,535 block tiles (C, D, B)
PRUNE_PAST_GRID = (64, 8, 8_388_608)
# phase 10: db shards on the one card, the per-shard kb ladder, the
# exact_topk shape (log2 rows, centers, k), fit_embedding at the CLI's
# defaults, and topk_agreement's (length, k, queries)
SH_DB, SH_KB_LADDER = 4, (128, 256, 512, 1024)
SH_TOPK = (16, 256, 16)
FIT = dict(dim=8, steps=2000, batch=4096, kmer_len=1, lr=1e-1, seed=0)
AGREE = (8, 1000, 100)


def protein_like_db(rng, n, l, family_size=64, query_n=256,
                    return_families=False):
    """Motif families (centers + Poisson-flip members): the bench workload
    of the JAX package's bench.py, same numpy calls.  return_families=True
    also returns each row's family id."""
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
    if return_families:
        return db, q, which
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
        trace_out=None, pcluster_sizes=None, sharded_sizes=None):
    """All phases on ``device``; returns the kernel records and the
    records of the IVF, LSH, clustering, segmented-engine, pcluster and
    sharded phases.  ``pcluster_sizes`` and ``sharded_sizes`` override
    run_pcluster's corpus sizes and run_sharded's ``fit`` / ``agree``
    (rehearsals).  Raises on the first failed check."""
    import torch
    from hsearch_tpu_torch import _device
    from hsearch_tpu_torch.core import embedding
    from hsearch_tpu_torch.ops import cuda_kernels as ck
    from hsearch_tpu_torch.ops import distance
    from hsearch_tpu_torch.search import evaluate, exact, ivf, motif
    from hsearch_tpu_torch.search.motif import _center_ptables

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
    for name, res in (("prune bench", prune_bench),
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
    ck.reset_launches()
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
    by_path = {"ivf_search": ck.launch_counts()}
    print(f"phase3 search {search_s * 1e3:.3f} ms/call, {qps:.1f} q/s, "
          f"launches {by_path['ivf_search']}; with transfer_d2=True "
          f"{search_d2_s * 1e3:.3f} ms", flush=True)
    if rep.recall < 0.99:
        raise AssertionError(f"weighted recall {rep.recall} < 0.99 at the "
                             f"top of the kb ladder")
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
    profile_call("ivf search", lambda: ivf.search(
        index, centers, RADIUS, k_blocks=kb, max_hits=MAX_HITS,
        center_block=c_blk, retry_overflow=False, stats_out={},
        pack_cap_frac=4), dev)
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

    # ---- phase 6: the LSH engine ----------------------------------------
    lsh, by_path["lsh_search"] = run_lsh(db, centers, (gci, gki, gd), dev)

    # ---- phase 7: k-mer clustering --------------------------------------
    cluster, by_path["hclust2_merge"] = run_cluster(db, fam, dev,
                                                    centroid_n_log2)

    # ---- phase 8: the segmented engine ----------------------------------
    stream, by_path["stream_search"], seg_kernels = run_stream(
        dev, stream_n_log2, stream_c, cli, trace_out,
        lloyd=(db, centers, (gci, gki, gd), c_blk, main_path))
    prune_seg, verify_seg = seg_kernels

    # ---- phase 9: the aligner and pcluster ---------------------------------
    pcluster = run_pcluster(dev, cli=cli, **(pcluster_sizes or {}))
    # neither TPU kernel lies on this path: its launches are read to show it
    by_path["pcluster"] = pcluster["cluster"]["tpu_kernel_launches"]

    # ---- phase 10: sharded, multi-process and training -----------------
    sharded_rec, sh_launches = run_sharded(
        dev, db, centers, (gci, gki, gd), c_blk, **(sharded_sizes or {}))
    by_path.update(sh_launches)

    if dev.type == "cuda":
        need = {"ivf_search": ("sq_distance_prune", "ptable_verify"),
                "lsh_search": ("ptable_verify",),
                "hclust2_merge": ("sq_distance_prune", "ptable_verify"),
                "stream_search": ("sq_distance_prune", "ptable_verify"),
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
    ]
    return kernels, main_path, lsh, cluster, stream, pcluster, sharded_rec


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


def pair_recall(labels, fam, n_pairs=200_000):
    """Fraction of sampled same-family row pairs sharing a label (the
    JAX package's examples/bench_engines.py metric, same sampling)."""
    prng = np.random.default_rng(1)
    order = np.argsort(fam, kind="stable")
    f = fam[order]
    starts = np.searchsorted(f, np.arange(f.max() + 2))
    sizes = np.diff(starts)
    ok_fam = np.nonzero(sizes >= 2)[0]
    fs = prng.choice(ok_fam, n_pairs)
    a = starts[fs] + (prng.random(n_pairs) * sizes[fs]).astype(int)
    b = starts[fs] + (prng.random(n_pairs) * sizes[fs]).astype(int)
    m = a != b
    ra, rb = order[a[m]], order[b[m]]
    return float((labels[ra] == labels[rb]).mean())


def run_cluster(db, fam, dev, centroid_n_log2):
    """Phase 7: greedy clustering + center-distance merge on the whole
    database, centroid clustering on a prefix.  Returns the record and
    the kernel launches of the merge."""
    import torch
    from hsearch_tpu_torch.cluster import centroid, greedy, postprocess
    from hsearch_tpu_torch.core import embedding
    from hsearch_tpu_torch.ops import cuda_kernels as ck
    from hsearch_tpu_torch.search import ivf
    n = db.shape[0]
    cfg = greedy.ClusterConfig(hash_k=16, hash_l=8, w=50.0, radius=RADIUS)
    stages: dict = {}
    t0 = time.perf_counter()
    res = greedy.cluster_greedy(db, torch.Generator().manual_seed(1), cfg,
                                device=dev, stats_out=stages)
    greedy_s = time.perf_counter() - t0
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
          f"{dmax:.3f}", flush=True)
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
           "greedy_clusters": n_heads, "greedy_pair_recall": recall_greedy,
           "merge_s": merge_s, "merge_index_build_s": merge_build_s,
           "merged_clusters": n_merged,
           "merged_pair_recall": recall_merged, "merge_launches": launches,
           "centroid_n": nc, "centroid_s": centroid_s,
           "centroid_clusters": len(members),
           "centroid_pair_recall": recall_centroid}
    return rec, launches


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
    print(f"phase8 kernels at segment shape: prune {prune_seg}, verify "
          f"{verify_seg}", flush=True)
    del seg0, q_emb, cent, rad, neg, blk, ptab, vargs, alive

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
            t0 = time.perf_counter()
            last = stream.search_segmented(sidx, centers, RADIUS,
                                           k_blocks=kb, retry_overflow=False,
                                           stats_out=st, h2d_events=events,
                                           **kw)
            calls.append((time.perf_counter() - t0) * 1e3)
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
            "ms_per_call": calls, "seg_walls_s": st["seg_walls_s"],
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
    return rec, launches, (prune_seg, verify_seg)


def protein_families(n, plen=120, seed=0):
    """The JAX package's examples/bench_align.py corpus, same numpy calls:
    n // 4 families of 4 copies of a plen-residue base (protein i belongs
    to family i % (n // 4)), 4 substitutions each; proteins past the last
    whole family random.  Returns (ProteinDB, number of families)."""
    from hsearch_tpu_torch.core import io as hio
    rng = np.random.default_rng(seed)
    n_fam = max(1, n // 4)
    seqs = []
    for i in range(n):
        if i < n_fam * 4:
            s = np.random.default_rng(1000 + i % n_fam).integers(
                0, 20, plen).astype(np.int32)
            pos = rng.choice(plen, 4, replace=False)
            s[pos] = rng.integers(0, 20, 4)
        else:
            s = rng.integers(0, 20, plen).astype(np.int32)
        seqs.append(s)
    starts = np.concatenate([[0], np.cumsum([len(s) for s in seqs])])
    return hio.ProteinDB(names=[f"p{i}" for i in range(n)],
                         seq=np.concatenate(seqs).astype(np.uint8),
                         starts=starts), n_fam


def family_pair_recall(labels, n_fam):
    """Fraction of within-family protein pairs in one cluster (the JAX
    package's examples/bench_align.py metric)."""
    lab = labels[np.arange(n_fam * 4).reshape(4, n_fam).T]
    pairs = [(a, b) for a in range(4) for b in range(a + 1, 4)]
    return float(sum(int((lab[:, a] == lab[:, b]).sum()) for a, b in pairs)
                 / max(n_fam * len(pairs), 1))


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
    through its extension form on ``dev`` and through the same form on
    CPU tensors: bitwise equal.  Returns the form, lanes, and ms per
    call of each (CUDA events on the card, the host clock on the CPU)."""
    import torch
    from hsearch_tpu_torch.align import extend, seed_index
    b = searcher.params.pair_batch
    six = slice_pairs(searcher)[:, :PC_CMP_BATCHES * b]
    seq = torch.as_tensor(searcher.seq)
    drop = int(searcher.cutoffs.ungap_ext_drop)

    def on_cpu(x):
        if searcher.windowed:
            return extend.extend_pairs_windowed(
                seq, seq, x, drop, seed_index.SEED_LEN,
                win_pre=searcher._win, win_post=searcher._win)
        return extend.extend_pairs_packed(seq, seq, x, drop,
                                          seed_index.SEED_LEN)

    cpu_s = []
    for lo in range(0, six.shape[1], b):
        part = torch.as_tensor(six[:, lo:lo + b])
        got = searcher.extend_batch(part.to(dev)).cpu()
        t0 = time.perf_counter()
        want = on_cpu(part)
        cpu_s.append(time.perf_counter() - t0)
        if not torch.equal(got, want):
            raise AssertionError(
                f"extension ({'windowed' if searcher.windowed else 'chunked'}"
                f") on {dev} differs from the CPU at lanes {lo}..{lo + b}: "
                f"{int((got != want).any(dim=0).sum())} lanes")
    first = torch.as_tensor(six[:, :b], device=dev)
    return {"form": "windowed" if searcher.windowed else "chunked",
            "window": searcher._win if searcher.windowed else None,
            "lanes": int(six.shape[1]), "bitwise": True,
            "ms_per_call": _time_ms(lambda: searcher.extend_batch(first),
                                    dev, reps=5),
            "lanes_per_call": int(first.shape[1]),
            "cpu_ms_per_call": 1e3 * float(np.mean(cpu_s))}


def run_pcluster(dev, n=PC_N, gapped_log2=PC_GAPPED_LOG2,
                 cross_log2=PC_CROSS_LOG2, long_n=PC_LONG_N,
                 profile_n=PC_PROFILE_N, cli=True):
    """Phase 9: the aligner and pcluster.  Returns the record."""
    import dataclasses

    import torch
    from hsearch_tpu_torch.align import gapped_device, pipeline
    from hsearch_tpu_torch.cluster import pcluster
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
        "tpu_kernel_launches": ck.launch_counts()}
    print(f"phase9 cluster_proteins: {json.dumps(rec['cluster'])}",
          flush=True)
    if recall < PC_RECALL_GATE:
        raise AssertionError(f"family-pair recall {recall} < "
                             f"{PC_RECALL_GATE}")

    rec["seed_checkpoint"] = seed_checkpoint(db, res.pre_groups)
    print(f"phase9 seed checkpoint: {json.dumps(rec['seed_checkpoint'])}",
          flush=True)

    # one search_all slice over the first proteins of the table's groups,
    # traced; and the extension of its first batches on the card against
    # the CPU
    ps = first_table_searcher(db, res.pre_groups, dev, profile_n)
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
    del ps, db
    long_db, _ = protein_families(long_n, plen=PC_LONG_LEN, seed=1)
    rec["extend_chunked"] = compare_extension(
        pipeline.ProteinSearcher(long_db, device=dev), dev)
    print(f"phase9 extension card vs CPU: windowed "
          f"{json.dumps(rec['extend_windowed'])}; chunked "
          f"{json.dumps(rec['extend_chunked'])}", flush=True)

    # the gapped path
    gdb, _ = protein_families(1 << gapped_log2)
    t0 = time.perf_counter()
    plain = pcluster.cluster_proteins(gdb, torch.Generator().manual_seed(0),
                                      device=dev, **kw)
    plain_s = time.perf_counter() - t0
    profiling.reset()
    t0 = time.perf_counter()
    gapped = pcluster.cluster_proteins(
        gdb, torch.Generator().manual_seed(0), gapped=True, device=dev, **kw)
    gapped_s = time.perf_counter() - t0
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
    tracebacks = sum(int(s_) > queries[qi][1][i].score
                     for (qi, i), s_ in zip(where, got[0].cpu().tolist()))
    rows = [dataclasses.astuple(h) for h in gapped.hits]
    rec["gapped"] = {
        "proteins": 1 << gapped_log2, "ungapped_s": plain_s,
        "gapped_s": gapped_s,
        "refine_s": profiling.report()["align/gapped"]["total_s"],
        "windows": len(where), "window_shape": [int(q.shape[1]),
                                                int(d.shape[1])],
        "banded_bitwise": True,
        "banded_ms_per_call": _time_ms(
            lambda: gapped_device.banded_scores(*on_dev, sub.to(dev),
                                                *bargs), dev, reps=3),
        "host_tracebacks": tracebacks,
        "hits_changed": sum(a != dataclasses.astuple(b)
                            for a, b in zip(rows, plain.hits)),
        "labels_equal_ungapped": bool(np.array_equal(gapped.labels,
                                                     plain.labels))}
    print(f"phase9 gapped: {json.dumps(rec['gapped'])}", flush=True)
    del gs, queries, q, d, on_dev, got, want

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
    if cli:
        rec["cli"] = run_pcluster_cli(protein_families(1 << PC_CLI_LOG2)[0],
                                      dev)
    return rec


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
    kernels, main_path, lsh, cluster, stream, pcluster, sharded = run(
        "cuda", stream_n_log2=args.stream_n_log2, trace_out=args.trace_out)
    print("kernels " + json.dumps(kernels))
    print("main_path " + json.dumps(main_path))
    print("lsh " + json.dumps(lsh))
    print("cluster " + json.dumps(cluster))
    print("stream " + json.dumps(stream))
    print("pcluster " + json.dumps(pcluster))
    print("sharded " + json.dumps(sharded))
    print(f"total {time.perf_counter() - t0:.1f} s")
    print(smi.splitlines()[0])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
