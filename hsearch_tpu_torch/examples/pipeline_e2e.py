"""End-to-end IGC-shaped pipeline, CLI-driven, with per-stage timing.

    python -m hsearch_tpu_torch.examples.pipeline_e2e [n_genes] [outdir]
        [--device cuda]

BASELINE config 5: DNA corpus -> 6-frame ORF translation -> unique k-mers
-> k-mer search database -> IVF motif search -> greedy clustering ->
MEME/centers post-processing.  Every stage is one ``python -m
hsearch_tpu_torch`` subcommand (the reference's pipeline is likewise
file-coupled CLI binaries); this script only synthesizes the corpus,
converts the gen-kmers TSV to a k-mer FASTA, samples centers, and times
the stages.

The search, clustering and post-processing stages run on the card, or on
the CPU when the script is given ``--device cpu``, which is passed to each
of them; ``orf`` and ``gen-kmers`` are host tools.  The clustering subset
is 2^23 k-mers on the card and 2^20 on the CPU.  Writes a JSON timing
summary to <outdir>/pipeline_times.json (outdir defaults to
``hsearch_torch_pipeline`` under the temporary directory) and prints it.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

from .. import _device

KMER_LEN = 10
RADIUS = 25.0
N_CENTERS = 256


def synth_dna(path, n_genes, rng, gene_len=900, n_motifs=64):
    """Protein-coding-ish DNA with shared motif-encoding segments, so the
    translated corpus has real k-mer families (the IGC shape)."""
    codons = [a + b + c for a in "ACGT" for b in "ACGT" for c in "ACGT"
              if a + b + c not in ("TAA", "TAG", "TGA")]
    motif_dna = [list(rng.choice(codons, KMER_LEN + 2))
                 for _ in range(n_motifs)]
    with open(path, "w") as f:
        for g in range(n_genes):
            seq = "ATG" + "".join(rng.choice(codons, gene_len // 3))
            # a MUTATED family member per gene (exact copies would dedup
            # away in gen-kmers; variants survive and cluster)
            mvar = list(motif_dna[rng.integers(0, n_motifs)])
            mvar[rng.integers(0, len(mvar))] = str(rng.choice(codons))
            m = "".join(mvar)
            pos = 3 * rng.integers(1, (len(seq) - len(m)) // 3 - 1)
            seq = seq[:pos] + m + seq[pos + len(m):]
            f.write(f">gene{g}\n")
            for s in range(0, len(seq), 70):
                f.write(seq[s:s + 70] + "\n")


def run(stage, cmd, times):
    """One stage as a subprocess; a non-zero exit raises SystemExit."""
    print(f"[stage {stage}] {' '.join(cmd)}", file=sys.stderr, flush=True)
    t0 = time.perf_counter()
    r = subprocess.run(cmd)
    dt = time.perf_counter() - t0
    times[stage] = round(dt, 2)
    if r.returncode:
        raise SystemExit(f"stage {stage} failed rc={r.returncode}")
    print(f"[stage {stage}] {dt:.1f}s", file=sys.stderr, flush=True)


def kmers_to_fasta(ktsv, kfa, cfa, n_centers=N_CENTERS) -> int:
    """gen-kmers TSV -> k-mer FASTA database, plus ``n_centers`` centers
    sampled without replacement by ``default_rng(1)``; returns the number
    of k-mers."""
    kms = []
    with open(ktsv) as f, open(kfa, "w") as out:
        for i, line in enumerate(f):
            km = line.split("\t")[0]
            out.write(f">k{i}\n{km}\n")
            kms.append(km)
    sel = np.random.default_rng(1).choice(len(kms),
                                          min(n_centers, len(kms)),
                                          replace=False)
    with open(cfa, "w") as out:
        for j, i in enumerate(sel):
            out.write(f">c{j}\n{kms[int(i)]}\n")
    return len(kms)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n_genes", nargs="?", type=int, default=20000)
    ap.add_argument("outdir", nargs="?", default=os.path.join(
        tempfile.gettempdir(), "hsearch_torch_pipeline"))
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)
    outdir = args.outdir
    os.makedirs(outdir, exist_ok=True)
    rng = np.random.default_rng(0)
    times = {}
    py = [sys.executable, "-m", "hsearch_tpu_torch"]
    on = ["--device", dev.type]

    dna = os.path.join(outdir, "dna.fasta")
    t0 = time.perf_counter()
    synth_dna(dna, args.n_genes, rng)
    times["synth_dna"] = round(time.perf_counter() - t0, 2)

    # 1. 6-frame ORF translation (orf.cc:39-74 semantics)
    run("orf", py + ["orf", "-q", dna], times)
    aa = dna + "_translatedAA.fasta"     # <query>_translatedAA.fasta

    # 2. unique k-mers via the streaming suffix path (gen-kmers)
    ktsv = os.path.join(outdir, "kmers.tsv")
    run("gen_kmers", py + ["gen-kmers", "-d", aa, "-o", ktsv,
                           "-l", str(KMER_LEN), "--stream-aa",
                           str(1 << 22)], times)

    # 3. TSV -> k-mer FASTA database + sampled centers (host glue)
    t0 = time.perf_counter()
    kfa = os.path.join(outdir, "kmers.fasta")
    cfa = os.path.join(outdir, "centers.fasta")
    n_kmers = kmers_to_fasta(ktsv, kfa, cfa)
    times["to_fasta"] = round(time.perf_counter() - t0, 2)

    # 4. IVF motif search (the headline engine) over the full database
    hits = os.path.join(outdir, "hits.txt")
    run("ivf_search", py + ["motif-search", "--engine", "ivf", "-d", kfa,
                            "-c", cfa, "-l", str(KMER_LEN), "-T",
                            str(RADIUS), "-o", hits] + on, times)

    # 5. greedy clustering (hclust2) over a bounded subset
    nsub = min(n_kmers, 1 << (23 if dev.type == "cuda" else 20))
    sfa = os.path.join(outdir, "kmers_sub.fasta")
    with open(kfa) as f, open(sfa, "w") as out:
        for i, line in enumerate(f):
            if i >= 2 * nsub:
                break
            out.write(line)
    clus = os.path.join(outdir, "clusters.txt")
    run("hclust2", py + ["hclust2", "-d", sfa, "-o", clus, "-l",
                         str(KMER_LEN), "-T", str(RADIUS), "-k", "16",
                         "-L", "8"] + on, times)

    # 6. post-processing: centers + MEME motif format.  The reference's
    # default floor is 50 members (centerDistanceSmapling.cpp:12), but
    # gen-kmers dedups exact family copies, so cluster sizes depend on the
    # corpus's mutation density: step down the floor, and fail if even 2
    # leaves no cluster.
    post = os.path.join(outdir, "post")
    floors = ("50", "10", "2")
    for min_size in floors:
        try:
            run(f"postprocess(min={min_size})",
                py + ["postprocess", "-c", clus, "-o", post,
                      "--min-size", min_size] + on, times)
            break
        except SystemExit:
            if min_size == floors[-1]:
                raise
            print(f"[postprocess] no clusters >= {min_size}, lowering",
                  file=sys.stderr, flush=True)

    summary = dict(n_genes=args.n_genes, n_kmers=n_kmers,
                   n_clustered=nsub, device=dev.type, times_s=times,
                   total_s=round(sum(times.values()), 2))
    with open(os.path.join(outdir, "pipeline_times.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
