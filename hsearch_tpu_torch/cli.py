"""Command-line tools (counterpart of hsearch_tpu/cli.py).

    python -m hsearch_tpu_torch <tool> [args]

    motif-search         --engine ivf | exact (lsh and stream: not yet ported)
    motif-search-exact   brute-force exact search

Flags, defaults and output files are those of the JAX package's tools:
triples ``center kmer dist`` (``{d:g}``), and with ``-g`` an ``ACCURACY``
line plus ``<out>.accuracy.txt``.  ``--device`` picks the device (default
``cuda``; ``cpu`` must be asked for).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

# engines of the JAX package that this package does not run yet, with the
# ROADMAP item that ports them
_NOT_PORTED = {"lsh": "ROADMAP A.6", "stream": "ROADMAP A.5"}


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


def cmd_motif_search(args):
    import torch

    from .core import io as hio
    from .search import evaluate, exact, ivf
    if args.engine in _NOT_PORTED:
        raise SystemExit(f"motif-search: --engine {args.engine} is not yet "
                         f"ported ({_NOT_PORTED[args.engine]}); use "
                         "--engine ivf or --engine exact")
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


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="hsearch_tpu_torch",
                                description=__doc__.split("\n")[0])
    sub = p.add_subparsers(dest="tool", required=True)

    def device_flag(q):
        q.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                       help="device to run on (cpu must be asked for)")

    q = sub.add_parser("motif-search")
    q.add_argument("-d", "--database", required=True)
    q.add_argument("-c", "--centers", required=True)
    q.add_argument("-l", "--kmer-len", type=int, default=25)
    q.add_argument("-o", "--output", required=True)
    q.add_argument("-g", "--ground-truth")
    q.add_argument("--engine", choices=("lsh", "ivf", "exact", "stream"),
                   default="lsh",
                   help="ivf and exact run here; lsh and stream are not "
                        "yet ported")
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
                   help="autotune gate (weighted recall) of --no-retry's "
                        "k-blocks ladder")
    q.add_argument("--no-autotune", action="store_true",
                   help="lsh engine (not yet ported)")
    q.add_argument("-k", "--hash-k", type=int, default=4)
    q.add_argument("-L", "--hash-l", type=int, default=4)
    q.add_argument("-W", "--width", type=float, default=50.0)
    q.add_argument("-T", "--radius", type=float, default=200.0)
    q.add_argument("--seed", type=int, default=0)
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
