"""Worked example: the whole flow of the port on a small synthetic corpus.

    python -m hsearch_tpu_torch.examples.quickstart [--device cuda]

Covers: FASTA -> ProteinDB -> k-mers -> three search engines (exact
oracle, multiprobe LSH, block-pruned IVF) -> recall evaluation -> motif
clustering -> MEME output -> protein clustering with alignments.  Its
files go to a fresh ``tempfile.mkdtemp()`` directory.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from .. import _device
from ..cluster import greedy, pcluster, postprocess
from ..core import alphabet, io as hio
from ..search import evaluate, exact, ivf, motif

AA = "ARNDCQEGHILKMFPSTWYV"
MOTIF = "WWCHHKKRRF"
KMER_LEN, RADIUS = 10, 25.0


def planted_corpus(rng) -> list[tuple[str, str]]:
    """60 random 80-residue proteins; every third starts with MOTIF."""
    records = []
    for i in range(60):
        s = "".join(AA[j] for j in rng.integers(0, 20, 80))
        if i % 3 == 0:
            s = MOTIF + s[10:]
        records.append((f"protein{i}", s))
    return records


def run(device="cuda", workdir: str | None = None) -> dict:
    """Every step on ``device``; prints what each finds and returns the
    k-mers and each engine's (center, kmer, dist) hits."""
    dev = _device.resolve(device)
    workdir = workdir or tempfile.mkdtemp()
    rng = np.random.default_rng(0)

    # --- 1. a corpus with a planted motif --------------------------------
    records = planted_corpus(rng)
    fasta = os.path.join(workdir, "db.fasta")
    hio.write_fasta(fasta, [n for n, _ in records], [s for _, s in records])
    db = hio.read_fasta(fasta)
    kmers = np.concatenate([
        alphabet.kmer_view(db.protein(i).astype(np.int64), KMER_LEN)
        for i in range(db.num_proteins)]).astype(np.int32)
    print(f"{db.num_proteins} proteins -> {len(kmers)} {KMER_LEN}-mers")
    center = alphabet.encode(MOTIF).astype(np.int32)[None, :]

    # --- 2. exact oracle --------------------------------------------------
    truth = exact.search_radius(kmers, center, RADIUS, device=dev)
    gci, gki, gd = truth
    print(f"exact: {len(gki)} hits within R={RADIUS}")

    # --- 3. multiprobe LSH ------------------------------------------------
    cfg = motif.MotifSearchConfig(hash_k=8, hash_l=8, w=50.0, radius=RADIUS,
                                  probes=8)
    index = motif.build_index(kmers, torch.Generator().manual_seed(0), cfg,
                              device=dev)
    lsh = motif.search(index, center, cfg)
    rep = evaluate.recall_from_indices(gci, gki, gd, lsh[0], lsh[1], RADIUS)
    print(f"LSH:   {len(lsh[1])} hits, weighted recall {rep.recall:.3f}")

    # --- 4. block-pruned IVF (exact when k_blocks covers survivors) ------
    ivf_index = ivf.build_index(kmers, torch.Generator().manual_seed(0),
                                block_size=32, device=dev)
    ivf_hits = ivf.search(ivf_index, center, RADIUS,
                          k_blocks=ivf_index.num_blocks)
    if set(zip(ivf_hits[0], ivf_hits[1])) != set(zip(gci, gki)):
        raise RuntimeError("lossless IVF search differs from the oracle")
    print(f"IVF:   {len(ivf_hits[1])} hits == exact hit set")

    # --- 5. motif clustering + MEME output ------------------------------
    res = greedy.cluster_greedy(kmers, torch.Generator().manual_seed(1),
                                greedy.ClusterConfig(hash_k=8, hash_l=8,
                                                     radius=RADIUS),
                                device=dev)
    clusters = [[alphabet.decode(kmers[int(i)]) for i in grp]
                for grp in res.clusters() if len(grp) >= 5]
    print(f"clustering: {len(clusters)} clusters with >= 5 members")
    meme_path = fasta + ".meme.txt"
    postprocess.write_meme(meme_path,
                           [(f"motif{i}", c) for i, c in enumerate(clusters)])
    print(f"MEME motifs -> {meme_path}")

    # --- 6. whole-protein clustering with alignments ----------------------
    pres = pcluster.cluster_proteins(db, torch.Generator().manual_seed(2),
                                     tables=4, device=dev)
    n_groups = len({int(x) for x in pres.labels})
    print(f"pcluster: {n_groups} protein clusters, "
          f"{len(pres.hits)} alignments")
    return {"kmers": kmers, "exact": truth, "lsh": lsh, "ivf": ivf_hits,
            "clusters": clusters, "meme": meme_path,
            "protein_clusters": n_groups, "alignments": len(pres.hits)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
