"""Command-line tools (counterpart of hsearch_tpu/cli.py).

    python -m hsearch_tpu_torch <tool> [args]

    motif-search         --engine lsh | ivf | exact (stream: not yet ported)
    motif-search-exact   brute-force exact search
    lsh-sweep            LSH operating-point sweep against the exact oracle
    hclust2 / hclust3    greedy k-mer clustering (one implementation), with
                         the optional center-distance merge
    hclust               centroid-merging k-mer clustering
    postprocess          cluster centers, MEME file, center distances

Flags, defaults and output files are those of the JAX package's tools:
triples ``center kmer dist`` (``{d:g}``), and with ``-g`` an ``ACCURACY``
line plus ``<out>.accuracy.txt``; cluster files with ``#clusterid`` or
``#cluster`` headers.  ``--device`` picks the device (default ``cuda``;
``cpu`` must be asked for); seeds feed a ``torch.Generator``.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np

# engines of the JAX package that this package does not run yet, with the
# ROADMAP item that ports them
_NOT_PORTED = {"stream": "ROADMAP A.5"}


def _read_kmer_input(path: str, k: int):
    """k-mer FASTA or datapoints file -> (names, kmers (N, k) int32, points).

    points is (N, 8k) float32 when the datapoints headers carry no k-mer.
    """
    from .core import alphabet, embedding, io as hio
    with open(path) as f:
        head = f.read(4096)
    if head.lstrip().startswith(">"):
        db = hio.read_fasta(path)
        keep = [i for i in range(db.num_proteins)
                if len(db.protein(i)) >= k]
        names = [db.names[i] for i in keep]
        km = np.stack([np.asarray(db.protein(i))[:k] for i in keep]) \
            .astype(np.int32) if keep else np.zeros((0, k), np.int32)
        return names, km, None
    names, pts = hio.read_datapoints(path, k * embedding.AA_DIM)
    kmers = []
    for h in names:
        meta = hio.parse_datapoint_header(h)
        if meta is None:
            return names, None, np.asarray(pts, np.float32)
        kmers.append(alphabet.encode(meta["kmer"]))
    return names, np.stack(kmers).astype(np.int32), None


def _lsh_search(args, dk, centers):
    """The lsh engine: a measured-recall autotune of (K, L, W, probes) on a
    subsample unless any of -k/-L/-W/--probes or --no-autotune is given,
    then build and search."""
    import torch

    from .search import motif
    explicit = {k: v for k, v in (("hash_k", args.hash_k),
                                  ("hash_l", args.hash_l),
                                  ("w", args.width),
                                  ("probes", args.probes))
                if v is not None}
    if not explicit and not args.no_autotune:
        # the reference's K=4/L=4/W=50 point loses recall to bucket skew
        # on family data, so an untouched --engine lsh sweeps the tuning
        # grid on a subsample and takes the cheapest config meeting
        # --target-recall
        from .lsh import tuning
        rng = np.random.default_rng(args.seed)
        db_s = dk if len(dk) <= (1 << 16) else \
            dk[rng.choice(len(dk), 1 << 16, replace=False)]
        cen_s = np.asarray(centers[::max(1, len(centers) // 48)][:48])
        pts = tuning.sweep(np.asarray(db_s), cen_s, args.radius,
                           generator=torch.Generator().manual_seed(args.seed),
                           device=args.device)
        choice = tuning.best(pts, args.target_recall)
        cfg = dataclasses.replace(choice.config, radius=args.radius,
                                  max_hits=args.max_hits,
                                  center_block=args.center_block)
        print(f"[lsh autotune (target {args.target_recall}, "
              f"sample {len(db_s)}x{len(cen_s)}): {choice.row()}]",
              file=sys.stderr)
        if choice.recall < args.target_recall:
            print(f"[WARNING: best sampled config reaches only "
                  f"recall {choice.recall:.4f} < "
                  f"{args.target_recall}; consider --engine ivf]",
                  file=sys.stderr)
    else:
        cfg = motif.MotifSearchConfig(
            hash_k=explicit.get("hash_k", 4),
            hash_l=explicit.get("hash_l", 4),
            w=explicit.get("w", 50.0), radius=args.radius,
            probes=explicit.get("probes", 1),
            max_hits=args.max_hits, center_block=args.center_block)
    index = motif.build_index(dk, torch.Generator().manual_seed(args.seed),
                              cfg, device=args.device)
    return motif.search(index, centers, cfg)


def cmd_motif_search(args):
    import torch

    from .core import io as hio
    from .search import evaluate, exact, ivf
    if args.engine in _NOT_PORTED:
        raise SystemExit(f"motif-search: --engine {args.engine} is not yet "
                         f"ported ({_NOT_PORTED[args.engine]}); use "
                         "--engine lsh, ivf or exact")
    dnames, dk, _ = _read_kmer_input(args.database, args.kmer_len)
    cnames, ck, cpts = _read_kmer_input(args.centers, args.kmer_len)
    if dk is None:
        raise SystemExit("database must be k-mer-typed (FASTA or "
                         "headered datapoints)")
    centers = ck if ck is not None else cpts
    if args.engine == "exact":
        ci, ki, dd = exact.search_radius(dk, centers, args.radius,
                                         center_block=args.center_block,
                                         device=args.device)
    elif args.engine == "lsh":
        ci, ki, dd = _lsh_search(args, dk, centers)
    else:
        index = ivf.build_index(
            dk, torch.Generator().manual_seed(args.seed),
            block_size=args.block_size, device=args.device)
        k_blocks = args.k_blocks
        if args.no_retry and not args.force_k_blocks:
            # without the lossless retry, gate k-blocks on measured
            # weighted recall on a query sample; --force-k-blocks opts out
            sample = centers[::max(1, len(centers) // 64)][:64]
            ladder = tuple(args.k_blocks << i for i in range(5))
            k_blocks = ivf.autotune_k_blocks(
                index, np.asarray(sample), args.radius,
                target_recall=args.target_recall, candidates=ladder,
                max_hits=args.max_hits)
            print(f"[--no-retry: measured-recall autotune "
                  f"(target {args.target_recall}) picked "
                  f"k-blocks={k_blocks}]", file=sys.stderr)
        stats: dict = {}
        ci, ki, dd = ivf.search(index, centers, args.radius,
                                k_blocks=k_blocks,
                                max_hits=args.max_hits,
                                center_block=args.center_block,
                                retry_overflow=not args.no_retry,
                                stats_out=stats if args.no_retry else None,
                                approx_select=args.approx_select or None)
        if args.no_retry and (stats.get("over_blocks")
                              or stats.get("over_hits")):
            print(f"[--no-retry: {stats.get('over_blocks', 0)} centers "
                  f"exceeded k-blocks={k_blocks}, "
                  f"{stats.get('over_hits', 0)} exceeded "
                  f"max-hits={args.max_hits}; hit set may be incomplete "
                  "— raise the caps or drop --no-retry]", file=sys.stderr)
    hio.write_triples(args.output, ((cnames[a], dnames[b], d)
                                    for a, b, d in zip(ci, ki, dd)))
    print(f"[{len(ci)} hits -> {args.output}]", file=sys.stderr)
    if args.ground_truth:
        truth = hio.read_triples(args.ground_truth)
        name_ci = [(cnames[a], dnames[b]) for a, b in zip(ci, ki)]
        tp = [(a, b) for a, b, _ in truth]
        td = [d for _, _, d in truth]
        rep = evaluate.weighted_recall(tp, td, name_ci, args.radius)
        print(f"ACCURACY {rep.recall}")
        evaluate.write_accuracy_file(args.output + ".accuracy.txt", rep)


def cmd_motif_search_exact(args):
    from .core import io as hio
    from .search import exact
    dnames, dk, _ = _read_kmer_input(args.database, args.kmer_len)
    if dk is None:
        raise SystemExit("input must be k-mer-typed (FASTA or datapoints "
                         "with name#idx$off@KMER*count headers)")
    cnames, ck, cpts = _read_kmer_input(args.centers, args.kmer_len)
    centers = ck if ck is not None else cpts
    ci, ki, dd = exact.search_radius(dk, centers, args.radius,
                                     device=args.device)
    hio.write_triples(args.output, ((cnames[a], dnames[b], d)
                                    for a, b, d in zip(ci, ki, dd)))
    # misses file (motif_both_points_noLSH.cpp:48-52)
    if args.not_less_than:
        hit_pairs = set(zip(ci.tolist(), ki.tolist()))
        with open(args.not_less_than, "w") as f:
            for a in range(len(cnames)):
                for b in range(len(dnames)):
                    if (a, b) not in hit_pairs:
                        f.write(f"{cnames[a]} {dnames[b]}\n")
    print(f"[{len(ci)} exact hits -> {args.output}]", file=sys.stderr)


def cmd_lsh_sweep(args):
    import torch

    from .lsh import tuning
    _, dk, _ = _read_kmer_input(args.database, args.kmer_len)
    if dk is None:
        raise SystemExit("input must be k-mer-typed (FASTA or datapoints "
                         "with name#idx$off@KMER*count headers)")
    _, ck, cpts = _read_kmer_input(args.centers, args.kmer_len)
    centers = ck if ck is not None else cpts
    pts = tuning.sweep(dk, centers, args.radius,
                       generator=torch.Generator().manual_seed(args.seed),
                       device=args.device)
    for p in pts:
        print(p.row())
    print(f"# best: {tuning.best(pts, args.min_recall).row()}")


def _kmer_matrix(db, kmer_len: int) -> np.ndarray:
    """First kmer_len residues of every long-enough sequence."""
    starts = np.asarray(db.starts)
    keep = np.nonzero(np.diff(starts) >= kmer_len)[0]
    if len(keep) == 0:
        raise SystemExit(f"no sequences of length >= {kmer_len} "
                         "in the database (check -l)")
    return np.asarray(db.seq)[starts[keep][:, None]
                              + np.arange(kmer_len)].astype(np.int32)


def _head_first_groups(lab: np.ndarray) -> list[np.ndarray]:
    """Row groups by label, ascending; each group's head row (the row equal
    to its label) moved to the front (hclust2.cpp:137-150 order)."""
    order = np.argsort(lab, kind="stable")
    sl = lab[order]
    groups = np.split(order, np.nonzero(sl[1:] != sl[:-1])[0] + 1)
    for grp in groups:
        head = np.nonzero(grp == lab[grp[0]])[0]
        if head.size and head[0] != 0:
            h = int(head[0])
            hv = grp[h]
            grp[1:h + 1] = grp[:h].copy()
            grp[0] = hv
    return groups


def cmd_hclust2(args):
    import torch

    from .cluster import greedy
    from .core import alphabet, io as hio
    if any(v is not None for v in (args.dist_nproc, args.dist_pid,
                                   args.dist_coordinator)):
        raise SystemExit(f"{args.tool}: --dist-nproc/--dist-pid/"
                         "--dist-coordinator (distributed clustering) are "
                         "not yet ported (ROADMAP A.10)")
    db = hio.read_fasta(args.database, seed=args.seed)
    km = _kmer_matrix(db, args.kmer_len)
    cfg = greedy.ClusterConfig(hash_k=args.hash_k, hash_l=args.hash_l,
                               w=args.width, radius=args.radius)
    res = greedy.cluster_greedy(km, torch.Generator().manual_seed(args.seed),
                                cfg, device=args.device)
    if args.merge_radius:
        # hclust v1's centroid-merge stage (hclust.cpp:186-235) on the
        # greedy labels: union clusters whose center k-mers lie within
        # --merge-radius (postprocess.merge_by_center_distance)
        from .cluster import postprocess
        lab = np.where(res.parent >= 0, res.parent,
                       np.arange(len(res.parent)))
        lab = postprocess.merge_by_center_distance(
            km, lab, args.merge_radius,
            torch.Generator().manual_seed(args.seed + 1),
            k_blocks=args.merge_k_blocks, device=args.device)
        groups = _head_first_groups(lab)
    else:
        groups = res.clusters()
    # member lines are the k-mer sequences: the post-processing tools read
    # them back as sequences (centerDistanceSmapling.cpp:119,146)
    strs = alphabet.decode_all(km)
    clusters = [[strs[int(i)] for i in grp] for grp in groups]
    hio.write_clusters(args.output, clusters, style="hclust2")
    print(f"[{len(clusters)} clusters -> {args.output}]", file=sys.stderr)


def cmd_hclust(args):
    import torch

    from .cluster import centroid
    from .core import alphabet, io as hio
    db = hio.read_fasta(args.database, seed=args.seed)
    km = _kmer_matrix(db, args.kmer_len)
    cfg = centroid.CentroidConfig(hash_k=args.hash_k, hash_l=args.hash_l,
                                  w=args.width, radius=args.radius)
    groups = centroid.cluster_centroid(
        km, torch.Generator().manual_seed(args.seed), cfg,
        device=args.device)
    strs = alphabet.decode_all(km)
    clusters = [[strs[int(i)] for i in grp] for grp in groups]
    hio.write_clusters(args.output, clusters, style="hclust")
    print(f"[{len(clusters)} clusters -> {args.output}]", file=sys.stderr)


def cmd_postprocess(args):
    from .cluster import postprocess
    from .core import io as hio
    clusters = hio.read_clusters(args.clusters)
    clusters = [c for c in clusters if len(c) >= args.min_size]
    if not clusters:
        raise SystemExit(f"no clusters with >= {args.min_size} members "
                         "(lower --min-size)")
    named = [(f"cluster{i}", c) for i, c in enumerate(clusters)]
    centers = postprocess.cluster_centers(clusters)
    postprocess.write_centers_as_datapoints(
        args.output + "hclust.format.txt",
        [n for n, _ in named], centers)
    postprocess.write_meme(args.output + "meme.format.txt", named)
    inter, _ = postprocess.center_distance_samples(centers,
                                                   device=args.device)
    with open(args.output + "center_distances.txt", "w") as f:
        for d in inter:
            f.write(f"{d:g}\n")
    print(f"[{len(clusters)} clusters postprocessed -> {args.output}*]",
          file=sys.stderr)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="hsearch_tpu_torch",
                                description=__doc__.split("\n")[0])
    sub = p.add_subparsers(dest="tool", required=True)

    def device_flag(q):
        q.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                       help="device to run on (cpu must be asked for)")

    def common_lsh(q):
        q.add_argument("-k", "--hash-k", type=int, default=4)
        q.add_argument("-L", "--hash-l", type=int, default=4)
        q.add_argument("-W", "--width", type=float, default=50.0)
        q.add_argument("-T", "--radius", type=float, default=200.0)
        q.add_argument("--seed", type=int, default=0)

    q = sub.add_parser("motif-search")
    q.add_argument("-d", "--database", required=True)
    q.add_argument("-c", "--centers", required=True)
    q.add_argument("-l", "--kmer-len", type=int, default=25)
    q.add_argument("-o", "--output", required=True)
    q.add_argument("-g", "--ground-truth")
    q.add_argument("--engine", choices=("lsh", "ivf", "exact", "stream"),
                   default="lsh",
                   help="lsh, ivf and exact run here; stream is not yet "
                        "ported")
    q.add_argument("--segment-points", type=int, default=1 << 22,
                   help="stream engine (not yet ported)")
    q.add_argument("--device-budget", type=int, default=0,
                   help="stream engine (not yet ported)")
    q.add_argument("--index", help="stream engine (not yet ported)")
    q.add_argument("--save-index", help="stream engine (not yet ported)")
    q.add_argument("--probes", type=int, default=1)
    q.add_argument("--max-hits", type=int, default=256)
    q.add_argument("--block-size", type=int, default=32)
    q.add_argument("--k-blocks", type=int, default=64)
    q.add_argument("--center-block", type=int, default=256)
    q.add_argument("--approx-select", action="store_true",
                   help="ivf engine: accepted for compatibility; the block "
                        "select is always exact in this package")
    q.add_argument("--no-retry", action="store_true",
                   help="ivf engine only: skip the lossless overflow retry."
                   " k-blocks is then AUTOTUNED to the smallest cap whose"
                   " measured weighted recall on a query sample reaches"
                   " --target-recall (overflow counts still reported)")
    q.add_argument("--force-k-blocks", action="store_true",
                   help="with --no-retry: use exactly --k-blocks, skipping"
                   " the measured-recall autotune")
    q.add_argument("--target-recall", type=float, default=0.99,
                   help="autotune gate (weighted recall): --no-retry's "
                        "k-blocks ladder (ivf) and the default lsh config "
                        "sweep")
    q.add_argument("--no-autotune", action="store_true",
                   help="lsh engine only: skip the default config sweep "
                        "and run the reference's K=4/L=4/W=50 point")
    common_lsh(q)
    # the lsh engine autotunes when NONE of K/L/W/probes is given: the
    # None defaults tell untouched from explicit
    q.set_defaults(hash_k=None, hash_l=None, width=None, probes=None)
    device_flag(q)
    q.set_defaults(func=cmd_motif_search)

    q = sub.add_parser("motif-search-exact")
    q.add_argument("-d", "--database", required=True)
    q.add_argument("-c", "--centers", required=True)
    q.add_argument("-l", "--kmer-len", type=int, default=25)
    q.add_argument("-o", "--output", required=True)
    q.add_argument("-T", "--radius", type=float, default=200.0)
    q.add_argument("--not-less-than")
    device_flag(q)
    q.set_defaults(func=cmd_motif_search_exact)

    # hclust3 is the reference's memory-lean variant of the same greedy
    # algorithm (hclust3.cpp); distances are recomputed from the integer
    # k-mers here, so one implementation serves both
    for tool, func in (("hclust2", cmd_hclust2), ("hclust3", cmd_hclust2),
                       ("hclust", cmd_hclust)):
        q = sub.add_parser(tool)
        q.add_argument("-d", "--database", required=True)
        q.add_argument("-o", "--output", required=True)
        q.add_argument("-l", "--kmer-len", type=int, default=25)
        common_lsh(q)
        if tool != "hclust":
            q.add_argument("--dist-nproc", type=int, default=None,
                           help="distributed clustering (not yet ported)")
            q.add_argument("--dist-pid", type=int, default=None,
                           help="distributed clustering (not yet ported)")
            q.add_argument("--dist-coordinator", default=None,
                           help="distributed clustering (not yet ported)")
        q.add_argument("-t", "--threads", type=int, default=None,
                       help="accepted for the JAX package's interface; "
                            "no effect here")
        if tool != "hclust":
            q.add_argument("--merge-radius", type=float, default=None,
                           help="post-merge pass: union clusters whose "
                                "center k-mers are within this distance "
                                "(hclust v1's centroid merge, "
                                "hclust.cpp:186-235)")
            q.add_argument("--merge-k-blocks", type=int, default=128,
                           help="block cap of the merge pass's "
                                "centers-vs-centers radius search "
                                "(over-cap counts are reported)")
        device_flag(q)
        q.set_defaults(func=func)

    q = sub.add_parser("postprocess")
    q.add_argument("-c", "--clusters", required=True)
    q.add_argument("-o", "--output", required=True)
    q.add_argument("--min-size", type=int, default=50)
    device_flag(q)
    q.set_defaults(func=cmd_postprocess)

    q = sub.add_parser("lsh-sweep")
    q.add_argument("-d", "--database", required=True)
    q.add_argument("-c", "--centers", required=True)
    q.add_argument("-l", "--kmer-len", type=int, default=25)
    q.add_argument("-T", "--radius", type=float, default=35.0)
    q.add_argument("--min-recall", type=float, default=0.95)
    q.add_argument("--seed", type=int, default=0)
    device_flag(q)
    q.set_defaults(func=cmd_lsh_sweep)
    return p


def main(argv=None):
    from . import __version__
    p = build_parser()
    p.add_argument("--version", action="version",
                   version=f"hsearch_tpu_torch {__version__}")
    args = p.parse_args(argv)
    try:
        args.func(args)
    except (ValueError, OSError) as e:
        raise SystemExit(f"{args.tool}: {e}")


if __name__ == "__main__":
    main()
