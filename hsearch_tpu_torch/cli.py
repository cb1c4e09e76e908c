"""Command-line tools (counterpart of hsearch_tpu/cli.py).

    python -m hsearch_tpu_torch <tool> [args]

    protein2datapoints   sampled k-mer datapoints of a protein FASTA
    motif-search         --engine lsh | ivf | exact | stream
    motif-search-exact   brute-force exact search
    index-build          build an ivf, lsh or segmented (stream) index once
    serve                answer queries line by line from a saved index
    lsh-sweep            LSH operating-point sweep against the exact oracle
    hclust2 / hclust3    greedy k-mer clustering (one implementation), with
                         the optional center-distance merge
    hclust               centroid-merging k-mer clustering
    pcluster             whole-protein clustering: KLSH pre-groups, seed-
                         extend alignment (.m8/.aln), union-find clusters
    postprocess          cluster centers, MEME file, center distances
    evaluate2            weighted recall of result files against a truth
    evaluate-motifs      MEME-vs-search motif protein-set comparison
    shuffle-kmers        labeled, shuffled benchmark FASTA from clusters
    kmer2coordinates     embedded points of a k-mer file
    gen-kmers            distinct k-mers of a corpus with their counts
    orf                  six-frame ORF translation of DNA
    stockholm            motif centers from a Pfam STOCKHOLM file
    fit-embedding        train a BLOSUM62-metric amino-acid embedding

Flags, defaults and output files are those of the JAX package's tools:
triples ``center kmer dist`` (``{d:g}``), and with ``-g`` an ``ACCURACY``
line plus ``<out>.accuracy.txt``; cluster files with ``#clusterid`` or
``#cluster`` headers.  ``--device`` picks the device of every tool that
touches a tensor (default ``cuda``; ``cpu`` must be asked for); seeds feed
a ``torch.Generator``.  The data-prep and evaluation tools are host-only
numpy.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np

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


def _load_stream_index(args, n_db: int):
    """--index: a saved segmented index, checked against the run before
    it is loaded: its kind must be segivf, its k-mer length -l and its
    point count the database's (the rows its hit ids name)."""
    from .utils import checkpoint
    kind, meta = checkpoint.peek(args.index)
    if kind != "segivf":
        raise SystemExit(f"motif-search: --index {args.index} holds a "
                         f"{kind!r} index; --engine stream needs a segmented "
                         "index (kind 'segivf', from --save-index or "
                         "index-build --engine stream)")
    if int(meta["kmer_len"]) != args.kmer_len:
        raise SystemExit(f"motif-search: --index {args.index} was built for "
                         f"{meta['kmer_len']}-mers, but -l is "
                         f"{args.kmer_len}")
    if int(meta["n_points"]) != n_db:
        raise SystemExit(f"motif-search: --index {args.index} holds "
                         f"{meta['n_points']} points, but the database -d "
                         f"has {n_db} k-mers")
    index = checkpoint.load_index(args.index,
                                  device_budget_bytes=args.device_budget,
                                  device=args.device)
    print(f"[segmented index reloaded: {index.n_points} points, "
          f"{index.num_segments} segments, resident "
          f"{index.resident_fraction():.2f}]", file=sys.stderr)
    return index


def _stream_search(args, dk, centers):
    """The stream engine: segments of --segment-points streamed through
    the device, a --device-budget prefix kept resident; --index loads a
    saved segmented index instead of building, --save-index saves the
    one built."""
    import torch

    from .search import stream
    from .utils import checkpoint
    if args.index:
        index = _load_stream_index(args, len(dk))
    else:
        index = stream.build_segmented(
            dk, torch.Generator().manual_seed(args.seed),
            segment_points=args.segment_points, block_size=args.block_size,
            device_budget_bytes=args.device_budget, device=args.device)
        if args.save_index:
            checkpoint.save_index(args.save_index, index)
            print(f"[segmented index -> {args.save_index}]",
                  file=sys.stderr)
    stats: dict = {}
    ci, ki, dd = stream.search_segmented(
        index, centers, args.radius, k_blocks=args.k_blocks,
        max_hits=args.max_hits, center_block=args.center_block,
        retry_overflow=not args.no_retry, stats_out=stats, pack_cap_frac=4)
    if args.no_retry and (stats.get("over_blocks")
                          or stats.get("over_hits")):
        print(f"[--no-retry: {stats.get('over_blocks', 0)} "
              f"center-segment pairs over k-blocks, "
              f"{stats.get('over_hits', 0)} over max-hits]", file=sys.stderr)
    return ci, ki, dd


def cmd_motif_search(args):
    import torch

    from .core import io as hio
    from .search import evaluate, exact, ivf
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
    elif args.engine == "stream":
        ci, ki, dd = _stream_search(args, dk, centers)
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
                         "not yet ported (ROADMAP A.10d)")
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


def cmd_pcluster(args):
    """KLSH pre-groups -> group-partitioned seed-extend alignment (with
    --gapped, refinement under the same group statistics) -> union-find:
    ``<out>.m8``, ``<out>.aln`` (the first --max-aln hits) and
    ``<out>.clusters``."""
    import torch

    from .align import pipeline as apipe
    from .cluster import pcluster
    from .core import io as hio
    if any(v is not None for v in (args.dist_nproc, args.dist_pid,
                                   args.dist_coordinator)):
        raise SystemExit("pcluster: --dist-nproc/--dist-pid/"
                         "--dist-coordinator (distributed clustering) are "
                         "not yet ported (ROADMAP A.10d)")
    if args.threads:
        torch.set_num_threads(args.threads)
    db = hio.read_fasta(args.database, seed=args.seed)
    params = apipe.SearchParams(evalue_threshold=args.evalue,
                                max_aln_per_query=args.max_aln,
                                max_m8_per_query=args.max_hit)
    res = pcluster.cluster_proteins(
        db, torch.Generator().manual_seed(args.seed), params,
        cluster_evalue=args.cluster_evalue, tables=args.tables,
        bits=args.bits, sigma=args.sigma, gapped=args.gapped,
        device=args.device)
    apipe.write_m8(args.output + ".m8", res.hits, db.names, db.names)
    apipe.write_aln(args.output + ".aln", res.hits[:args.max_aln],
                    db.names, db.names)
    clusters = [[db.names[int(i)] for i in g] for g in res.groups()]
    hio.write_clusters(args.output + ".clusters", clusters, style="hclust2")
    print(f"[{len(clusters)} clusters, {len(res.hits)} hits -> "
          f"{args.output}.*]", file=sys.stderr)


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


def cmd_protein2datapoints(args):
    from .core import dataprep, embedding, io as hio
    rng = np.random.default_rng(args.seed)
    if args.stream_aa:
        # bounded memory: chunked read, datapoints written per chunk; the
        # output is identical to the whole-file path's
        total = 0
        with open(args.output, "w") as f:
            chunks = hio.stream_fasta(args.database, seed=args.seed,
                                      chunk_aa=args.stream_aa)
            for headers, kmers in dataprep.stream_kmer_datapoints(
                    chunks, args.kmer_len, rng):
                hio.write_datapoints(f, headers,
                                     embedding.embed_kmers(kmers))
                total += len(headers)
    else:
        db = hio.read_fasta(args.database, seed=args.seed)
        headers, kmers = dataprep.sample_kmer_datapoints(
            db, args.kmer_len, rng)
        hio.write_datapoints(args.output, headers,
                             embedding.embed_kmers(kmers))
        total = len(headers)
    print(f"[WROTE {total} datapoints to {args.output}]", file=sys.stderr)


def cmd_evaluate2(args):
    import os

    from .core import io as hio
    from .search import evaluate
    truth = hio.read_triples(args.ground_truth)
    tp = [(a, b) for a, b, _ in truth]
    td = [d for _, _, d in truth]
    if os.path.isdir(args.result):
        paths = [os.path.join(args.result, p)
                 for p in sorted(os.listdir(args.result))]
    else:
        paths = [args.result]
    for p in paths:
        found = [(a, b) for a, b, _ in hio.read_triples(p)]
        rep = evaluate.weighted_recall(tp, td, found, args.radius,
                                       weighting=args.weighting)
        print(f"{p} ACCURACY {rep.recall}")


def cmd_evaluate_motifs(args):
    """MEME-vs-search motif protein-set comparison (evaluate.cpp)."""
    from .core import io as hio
    from .search import evaluate
    with open(args.meme) as f:
        f.readline()                       # header line (evaluate.cpp:25)
        meme_pairs = [tuple(parts[:2]) for parts in map(str.split, f)
                      if len(parts) >= 2]
    triples = hio.read_triples(args.result)
    s1, s2, ratio = evaluate.motif_protein_set_ratio(meme_pairs, triples)
    print(f"ACCURACY: {s1} {s2} {ratio}")


def cmd_shuffle_kmers(args):
    from .cluster import postprocess
    from .core import io as hio
    clusters = hio.read_clusters(args.clusters)
    clusters = [c for c in clusters if len(c) >= args.min_size]
    named = [(f"cluster{i}", c) for i, c in enumerate(clusters)]
    rng = np.random.default_rng(args.seed)
    recs = postprocess.shuffle_motifs(named, rng, args.num_motifs,
                                      args.seqs_per_motif)
    with open(args.output, "w") as f:
        for name, seq in recs:
            f.write(f">{name}\n{seq}\n")
    print(f"[{len(recs)} shuffled records -> {args.output}]",
          file=sys.stderr)


def cmd_kmer2coordinates(args):
    from .core import dataprep, io as hio
    names, km, _ = _read_kmer_input(args.input, args.kmer_len)
    if km is None:
        raise SystemExit("input must be k-mer-typed (FASTA or datapoints "
                         "with name#idx$off@KMER*count headers)")
    hio.write_datapoints(args.output, names,
                         dataprep.kmers_to_coordinates(km))
    print(f"[{len(names)} points -> {args.output}]", file=sys.stderr)


def cmd_gen_kmers(args):
    from .core import alphabet, dataprep, io as hio
    # seed=None keeps unknown residues, so unique_kmers drops the windows
    # that hold them (randomizing first would make k-mers up)
    if args.stream_aa:
        kmers, counts = dataprep.stream_unique_kmers(
            hio.stream_fasta(args.database, seed=None,
                             chunk_aa=args.stream_aa), args.kmer_len)
    else:
        db = hio.read_fasta(args.database, seed=None)
        kmers, counts = dataprep.unique_kmers(db, args.kmer_len)
    # decoded in bounded slices: one (U,) string array of every k-mer
    # would undo --stream-aa's memory bound
    step = 1 << 20
    with open(args.output, "w") as f:
        for s in range(0, len(kmers), step):
            strs = alphabet.decode_all(kmers[s:s + step])
            f.writelines(f"{t}\t{c}\n"
                         for t, c in zip(strs, counts[s:s + step]))
    print(f"[{len(kmers)} unique {args.kmer_len}-mers -> {args.output}]",
          file=sys.stderr)


def _read_raw_fasta(path: str):
    """(names up to the first space, sequences as text) of a FASTA file."""
    names, seqs, cur = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                if names:
                    seqs.append("".join(cur))
                cur = []          # also drops text before the first '>'
                names.append(line[1:].split(" ")[0])
            elif names:
                cur.append(line)
    if names:
        seqs.append("".join(cur))
    return names, seqs


def cmd_orf(args):
    from .core import orf
    names, dnas = _read_raw_fasta(args.query)
    out_names, peptides = orf.translate_fasta(names, dnas, args.min_len)
    out = args.output or (args.query + "_translatedAA.fasta")
    with open(out, "w") as f:
        for n, pep in zip(out_names, peptides):
            f.write(f">{n}\n{pep}\n")
    print(f"[{len(peptides)} peptides -> {out}]", file=sys.stderr)


def cmd_stockholm(args):
    from .core import stockholm
    centers = stockholm.extract_centers(args.input, args.length,
                                        sample_every=args.sample_every)
    with open(args.output, "w") as f:
        for label, motif_seq in centers:
            f.write(f">{label}\n{motif_seq}\n")
    print(f"[{len(centers)} centers -> {args.output}]", file=sys.stderr)


def cmd_index_build(args):
    """Build a search index once and save it."""
    import json

    import torch

    from .search import ivf, motif, stream
    from .utils import checkpoint, stats
    _, dk, _ = _read_kmer_input(args.database, args.kmer_len)
    if dk is None:
        raise SystemExit("input must be k-mer-typed (FASTA or datapoints "
                         "with name#idx$off@KMER*count headers)")
    gen = torch.Generator().manual_seed(args.seed)
    if args.engine == "ivf":
        index = ivf.build_index(dk, gen, block_size=args.block_size,
                                device=args.device)
    elif args.engine == "stream":
        index = stream.build_segmented(
            dk, gen, segment_points=args.segment_points,
            block_size=args.block_size, device=args.device)
    else:
        cfg = motif.MotifSearchConfig(hash_k=args.hash_k,
                                      hash_l=args.hash_l, w=args.width)
        index = motif.build_index(dk, gen, cfg, device=args.device)
    checkpoint.save_index(args.output, index)
    print(json.dumps(stats.index_stats(index))[:400], file=sys.stderr)
    print(f"[index -> {args.output}]", file=sys.stderr)


def cmd_serve(args):
    """Persistent query loop: one process keeps the index on the device
    and answers motif queries line by line."""
    from .core import alphabet
    from .search import ivf, motif, stream
    from .utils import checkpoint
    index = checkpoint.load_index(args.index,
                                  device_budget_bytes=args.device_budget,
                                  device=args.device)
    is_ivf = isinstance(index, ivf.IVFIndex)
    is_seg = isinstance(index, stream.SegmentedIVF)
    kind = "segmented" if is_seg else ("ivf" if is_ivf else "lsh")
    n_pts = index.n_points if (is_ivf or is_seg) else index.num_points
    extra = (f", {index.num_segments} segments, resident "
             f"{index.resident_fraction():.2f}") if is_seg else ""
    print(f"[serving {kind} index: {n_pts} points, "
          f"L={index.kmer_len}{extra}; query = one sequence per line, "
          "blank to quit]", file=sys.stderr)
    cfg = None if (is_ivf or is_seg) else \
        motif.MotifSearchConfig(radius=args.radius, probes=args.probes)
    fin = open(args.input) if args.input else sys.stdin
    try:
        for line in fin:
            seq = line.strip().upper()
            if not seq:
                break
            if seq.startswith(">"):
                continue
            if len(seq) != index.kmer_len:
                print(f"# query must be length {index.kmer_len}",
                      file=sys.stderr)
                continue
            q = alphabet.encode(seq).astype(np.int32)[None, :]
            if is_seg:
                ci, ki, dd = stream.search_segmented(
                    index, q, args.radius, k_blocks=args.k_blocks)
            elif is_ivf:
                ci, ki, dd = ivf.search(index, q, args.radius,
                                        k_blocks=args.k_blocks)
            else:
                ci, ki, dd = motif.search(index, q, cfg)
            for j in np.argsort(dd):
                print(f"{seq} {int(ki[j])} {dd[j]:g}")
            print(f"# {len(ki)} hits", file=sys.stderr)
    finally:
        if args.input:
            fin.close()


def cmd_fit_embedding(args):
    from .parallel import train
    coords = train.fit_embedding(dim=args.dim, steps=args.steps,
                                 batch=args.batch, kmer_len=args.kmer_len,
                                 lr=args.lr, seed=args.seed,
                                 device=args.device)
    np.savetxt(args.output, coords, fmt="%.6f")
    print(f"[{args.dim}-dim embedding -> {args.output}]", file=sys.stderr)


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

    q = sub.add_parser("protein2datapoints")
    q.add_argument("-d", "--database", required=True)
    q.add_argument("-o", "--output", required=True)
    q.add_argument("-l", "--kmer-len", type=int, default=25)
    q.add_argument("--seed", type=int, default=0)
    q.add_argument("--stream-aa", type=int, default=0, metavar="N",
                   help="stream the FASTA in ~N-residue chunks "
                        "(bounded memory; identical output)")
    q.set_defaults(func=cmd_protein2datapoints)

    q = sub.add_parser("motif-search")
    q.add_argument("-d", "--database", required=True)
    q.add_argument("-c", "--centers", required=True)
    q.add_argument("-l", "--kmer-len", type=int, default=25)
    q.add_argument("-o", "--output", required=True)
    q.add_argument("-g", "--ground-truth")
    q.add_argument("--engine", choices=("lsh", "ivf", "exact", "stream"),
                   default="lsh")
    q.add_argument("--segment-points", type=int, default=1 << 22,
                   help="stream engine: points per host segment")
    q.add_argument("--device-budget", type=int, default=0,
                   help="stream engine: device bytes for a resident"
                   " segment prefix (clamped against free device memory"
                   " minus two double-buffer slots and the search's"
                   " working set; 0 = fully streamed)")
    q.add_argument("--index",
                   help="stream engine: load a saved segmented index"
                   " (.npz from --save-index / index-build --engine"
                   " stream) instead of building; its kind, k-mer length"
                   " and point count must match the run")
    q.add_argument("--save-index",
                   help="stream engine: save the freshly built segmented"
                   " index to this .npz")
    q.add_argument("--probes", type=int, default=1)
    q.add_argument("--max-hits", type=int, default=256)
    q.add_argument("--block-size", type=int, default=32)
    q.add_argument("--k-blocks", type=int, default=64)
    q.add_argument("--center-block", type=int, default=256)
    q.add_argument("--approx-select", action="store_true",
                   help="ivf engine: accepted for compatibility; the block "
                        "select is always exact in this package")
    q.add_argument("--no-retry", action="store_true",
                   help="ivf and stream engines: skip the lossless overflow"
                   " retry.  For ivf, k-blocks is then AUTOTUNED to the"
                   " smallest cap whose measured weighted recall on a"
                   " query sample reaches --target-recall (overflow counts"
                   " still reported)")
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

    q = sub.add_parser("pcluster")
    q.add_argument("-d", "--database", required=True)
    q.add_argument("-o", "--output", required=True)
    q.add_argument("-e", "--evalue", type=float, default=10.0)
    q.add_argument("--cluster-evalue", type=float, default=1e-3)
    q.add_argument("--max-aln", type=int, default=100)
    q.add_argument("--max-hit", type=int, default=500)
    q.add_argument("--tables", type=int, default=1)
    q.add_argument("--bits", type=int, default=16,
                   help="KLSH code width (reference: 16, pcluster.cpp:14)")
    q.add_argument("--sigma", type=float, default=0.2,
                   help="KLSH kernel bandwidth (reference: 0.2, "
                        "pcluster.cpp:15); sigma, not bits, is the recall "
                        "knob (bits=12 sigma=0.1 at tables=1 is the "
                        "measured operating point)")
    q.add_argument("--gapped", action="store_true",
                   help="re-align strong hits with the banded gapped "
                        "aligner (affine gaps + traceback)")
    q.add_argument("--seed", type=int, default=0)
    q.add_argument("--dist-nproc", type=int, default=None,
                   help="distributed clustering (not yet ported)")
    q.add_argument("--dist-pid", type=int, default=None,
                   help="distributed clustering (not yet ported)")
    q.add_argument("--dist-coordinator", default=None,
                   help="distributed clustering (not yet ported)")
    q.add_argument("-t", "--threads", type=int, default=None,
                   help="torch host threads for this process (default: "
                        "torch's)")
    device_flag(q)
    q.set_defaults(func=cmd_pcluster)

    q = sub.add_parser("postprocess")
    q.add_argument("-c", "--clusters", required=True)
    q.add_argument("-o", "--output", required=True)
    q.add_argument("--min-size", type=int, default=50)
    device_flag(q)
    q.set_defaults(func=cmd_postprocess)

    q = sub.add_parser("evaluate2")
    q.add_argument("-g", "--ground-truth", required=True)
    q.add_argument("-r", "--result", required=True,
                   help="result file or directory of result files")
    q.add_argument("-T", "--radius", type=float, default=200.0)
    q.add_argument("--weighting", choices=("search", "pivot"),
                   default="pivot",
                   help="'pivot' = evaluate2.cpp's 49.38 weighting")
    q.set_defaults(func=cmd_evaluate2)

    q = sub.add_parser("evaluate-motifs")
    q.add_argument("-m", "--meme", required=True,
                   help="MEME-style hit list: motif protein per line")
    q.add_argument("-r", "--result", required=True,
                   help="search triples: motif protein distance per line")
    q.set_defaults(func=cmd_evaluate_motifs)

    q = sub.add_parser("shuffle-kmers")
    q.add_argument("-c", "--clusters", required=True)
    q.add_argument("-o", "--output", required=True)
    q.add_argument("--min-size", type=int, default=100)
    q.add_argument("-m", "--num-motifs", type=int)
    q.add_argument("-n", "--seqs-per-motif", type=int)
    q.add_argument("--seed", type=int, default=0)
    q.set_defaults(func=cmd_shuffle_kmers)

    q = sub.add_parser("kmer2coordinates")
    q.add_argument("-i", "--input", required=True)
    q.add_argument("-o", "--output", required=True)
    q.add_argument("-l", "--kmer-len", type=int, default=10)
    q.set_defaults(func=cmd_kmer2coordinates)

    q = sub.add_parser("gen-kmers")
    q.add_argument("-d", "--database", required=True)
    q.add_argument("-o", "--output", required=True)
    q.add_argument("-l", "--kmer-len", type=int, default=10)
    q.add_argument("--seed", type=int, default=0)
    q.add_argument("--stream-aa", type=int, default=0, metavar="N",
                   help="stream the FASTA in ~N-residue chunks")
    q.set_defaults(func=cmd_gen_kmers)

    q = sub.add_parser("orf")
    q.add_argument("-q", "--query", required=True)
    q.add_argument("-o", "--output")
    q.add_argument("--min-len", type=int, default=6)
    q.set_defaults(func=cmd_orf)

    q = sub.add_parser("stockholm")
    q.add_argument("-i", "--input", required=True)
    q.add_argument("-o", "--output", required=True)
    q.add_argument("-l", "--length", type=int, default=25)
    q.add_argument("--sample-every", type=int, default=1)
    q.set_defaults(func=cmd_stockholm)

    q = sub.add_parser("index-build")
    q.add_argument("-d", "--database", required=True)
    q.add_argument("-o", "--output", required=True)
    q.add_argument("-l", "--kmer-len", type=int, default=25)
    q.add_argument("--engine", choices=("lsh", "ivf", "stream"),
                   default="ivf")
    q.add_argument("--segment-points", type=int, default=1 << 22,
                   help="stream engine: points per host segment")
    q.add_argument("--block-size", type=int, default=32)
    common_lsh(q)
    device_flag(q)
    q.set_defaults(func=cmd_index_build)

    q = sub.add_parser("serve")
    q.add_argument("-i", "--index", required=True)
    q.add_argument("--input", help="query file (default stdin)")
    q.add_argument("-T", "--radius", type=float, default=35.0)
    q.add_argument("--k-blocks", type=int, default=64)
    q.add_argument("--probes", type=int, default=8)
    q.add_argument("--device-budget", type=int, default=0,
                   help="segmented index: device bytes for a resident"
                   " prefix (clamped; 0 = fully streamed)")
    device_flag(q)
    q.set_defaults(func=cmd_serve)

    q = sub.add_parser("lsh-sweep")
    q.add_argument("-d", "--database", required=True)
    q.add_argument("-c", "--centers", required=True)
    q.add_argument("-l", "--kmer-len", type=int, default=25)
    q.add_argument("-T", "--radius", type=float, default=35.0)
    q.add_argument("--min-recall", type=float, default=0.95)
    q.add_argument("--seed", type=int, default=0)
    device_flag(q)
    q.set_defaults(func=cmd_lsh_sweep)

    q = sub.add_parser("fit-embedding")
    q.add_argument("-o", "--output", required=True)
    q.add_argument("--dim", type=int, default=8)
    q.add_argument("--steps", type=int, default=2000)
    q.add_argument("--batch", type=int, default=4096)
    q.add_argument("--kmer-len", type=int, default=1)
    q.add_argument("--lr", type=float, default=1e-1)
    q.add_argument("--seed", type=int, default=0)
    device_flag(q)
    q.set_defaults(func=cmd_fit_embedding)
    return p


def main(argv=None):
    from . import __version__
    argv = sys.argv[1:] if argv is None else list(argv)
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
