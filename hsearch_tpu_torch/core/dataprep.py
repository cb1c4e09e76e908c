"""Corpus preparation: k-mer sampling, suffix-array dedup, stats (own
copy of hsearch_tpu/core/dataprep.py).

Covers the IGC data-prep tools of the reference plus protein2datapoints:
vectorized numpy on the host, run once per corpus to feed the engines on
the device.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import alphabet, embedding


def sample_kmer_datapoints(db, k: int, rng: np.random.Generator,
                           max_proteins: int | None = None):
    """Sample deduplicated k-mers with random stride 30 + U[0, 20).

    protein2datapoints.cpp:40-72: walk each protein, skip ahead a random
    stride after each emitted (or duplicate) k-mer, dedup by exact
    sequence.  Returns (headers, kmers (N, k) int32) where headers follow
    the ``name#proteinIdx$offset@kmer*count`` format
    (protein2datapoints.cpp:64).
    """
    seen: set[bytes] = set()
    headers: list[str] = []
    rows: list[np.ndarray] = []
    cnt = 0
    n_prot = db.num_proteins if max_proteins is None else \
        min(max_proteins, db.num_proteins)
    for i in range(n_prot):
        seq = np.asarray(db.protein(i))
        j = 0
        while j + k <= len(seq):
            kmer = seq[j:j + k]
            key = kmer.tobytes()
            if key in seen or (kmer >= 20).any():
                j += 30 + int(rng.integers(0, 20))
                continue
            seen.add(key)
            headers.append(_dp_header(db.names[i], i, j, kmer, cnt))
            rows.append(kmer.astype(np.int32))
            cnt += 1
            j += 30 + int(rng.integers(0, 20))
    kmers = np.stack(rows) if rows else np.zeros((0, k), np.int32)
    return headers, kmers


def _dp_header(name: str, pid: int, off: int, kmer: np.ndarray,
               cnt: int) -> str:
    from . import io as hio
    return hio.datapoint_header(name.split(" ")[0], pid, off,
                                alphabet.decode(kmer), cnt)


def stream_kmer_datapoints(db_chunks, k: int, rng: np.random.Generator,
                           dedup: bool = True):
    """Streaming ``sample_kmer_datapoints`` over ProteinDB chunks.

    Yields one (headers, kmers) pair per input chunk; the dedup set,
    protein indices, and datapoint counter are global across chunks, so
    concatenating the yields over ``io.stream_fasta(path)`` equals
    ``sample_kmer_datapoints(io.read_fasta(path), ...)`` exactly — with
    host memory bounded by one chunk plus the dedup set.
    """
    seen: set[bytes] = set() if dedup else None
    pid_off = 0
    cnt = 0
    for db in db_chunks:
        headers: list[str] = []
        rows: list[np.ndarray] = []
        for i in range(db.num_proteins):
            seq = np.asarray(db.protein(i))
            j = 0
            while j + k <= len(seq):
                kmer = seq[j:j + k]
                key = kmer.tobytes()
                if (seen is not None and key in seen) or \
                        (kmer >= 20).any():
                    j += 30 + int(rng.integers(0, 20))
                    continue
                if seen is not None:
                    seen.add(key)
                headers.append(_dp_header(db.names[i], pid_off + i, j,
                                          kmer, cnt))
                rows.append(kmer.astype(np.int32))
                cnt += 1
                j += 30 + int(rng.integers(0, 20))
        pid_off += db.num_proteins
        yield headers, (np.stack(rows) if rows
                        else np.zeros((0, k), np.int32))


def stream_unique_kmers(db_chunks, k: int):
    """Streaming ``unique_kmers``: merge per-chunk uniques with counts.

    Chunks from ``io.stream_fasta`` split at protein boundaries and
    ``unique_kmers`` never counts windows crossing protein boundaries,
    so the merged result equals the whole-corpus call.  Memory is one
    chunk plus the (output-sized) running unique set.
    """
    acc_k = np.zeros((0, k), np.int32)
    acc_c = np.zeros(0, np.int64)
    for db in db_chunks:
        uk, uc = unique_kmers(db, k)
        if uk.shape[0] == 0:
            continue
        if acc_k.shape[0] == 0:
            acc_k, acc_c = uk, uc
            continue
        allk = np.concatenate([acc_k, uk])
        allc = np.concatenate([acc_c, uc])
        acc_k, inv = np.unique(allk, axis=0, return_inverse=True)
        # bincount weights are f64 — exact for counts < 2^53
        acc_c = np.bincount(inv.reshape(-1), weights=allc,
                            minlength=acc_k.shape[0]).astype(np.int64)
    return acc_k, acc_c


def suffix_array(seq: np.ndarray) -> np.ndarray:
    """Suffix array by prefix doubling (O(n log^2 n), fully vectorized).

    Replaces the reference's std::sort with 500-char-capped comparator
    (IGC/shuffle_data/IGC/suffix_array.cpp:15-47) — this one is exact for
    all suffix lengths.
    """
    s = np.asarray(seq, np.int64)
    n = len(s)
    if n == 0:
        return np.zeros(0, np.int64)
    rank = s.copy()
    sa = np.argsort(rank, kind="stable")
    k = 1
    while k < n:
        second = np.full(n, -1, np.int64)
        second[:n - k] = rank[k:]
        key = rank * (n + 1) + (second + 1)
        sa = np.argsort(key, kind="stable")
        sk = key[sa]
        new_rank = np.zeros(n, np.int64)
        new_rank[sa[1:]] = np.cumsum(sk[1:] != sk[:-1])
        rank = new_rank
        if rank[sa[-1]] == n - 1:
            break
        k *= 2
    return sa.astype(np.int64)


def unique_kmers(db, k: int):
    """All distinct k-mers of the corpus with occurrence counts.

    The role of suffix_array.cpp + gen_kmers_from_suffix_array.cpp
    (:51-68): enumerate each distinct k-mer once, with its multiplicity.
    Windows crossing protein boundaries or containing unknown residues
    are excluded.  Returns (kmers (U, k) int32 sorted lexicographically,
    counts (U,) int64).
    """
    seq = np.asarray(db.seq, np.int64)
    starts = np.asarray(db.starts)
    if len(seq) < k:
        return np.zeros((0, k), np.int32), np.zeros(0, np.int64)
    wins = alphabet.kmer_view(seq, k)
    pos = np.arange(len(wins))
    pid = np.searchsorted(starts, pos, side="right") - 1
    ok = (pos + k <= starts[pid + 1]) & (wins < 20).all(axis=1)
    wins = wins[ok]
    # row-wise unique: exact for any k (base-20 int64 packing overflows
    # silently at k >= 15)
    out, counts = np.unique(wins.astype(np.int32), axis=0,
                            return_counts=True)
    return out, counts.astype(np.int64)


@dataclasses.dataclass
class CorpusStats:
    num_proteins: int
    total_aa: int
    max_len: int


def corpus_stats(db) -> CorpusStats:
    """pep2kmers.cpp's corpus scan (max/total length)."""
    lens = db.lengths
    return CorpusStats(num_proteins=db.num_proteins,
                       total_aa=int(lens.sum()),
                       max_len=int(lens.max()) if len(lens) else 0)


@dataclasses.dataclass
class AnnotationStats:
    total: int
    unknown: int
    total_length: int
    unknown_length: int
    lengths: np.ndarray
    unknown_lengths: np.ndarray


def annotation_stats(path_or_file) -> AnnotationStats:
    """IGC annotation summary: fully-unknown gene counts/lengths
    (NOGCOG.cpp:36-56: a gene is 'unknown' when phylum, genus, KEGG and
    eggNOG columns all read 'unknown')."""
    close = False
    f = path_or_file
    if isinstance(path_or_file, str):
        f = open(path_or_file)
        close = True
    lengths, un_lengths = [], []
    try:
        for line in f:
            parts = line.split()
            if len(parts) < 9:
                continue
            length = int(parts[2])
            lengths.append(length)
            if all(p == "unknown" for p in (parts[5], parts[6],
                                            parts[7], parts[8])):
                un_lengths.append(length)
    finally:
        if close:
            f.close()
    lengths = np.asarray(lengths, np.int64)
    un = np.asarray(un_lengths, np.int64)
    return AnnotationStats(total=len(lengths), unknown=len(un),
                           total_length=int(lengths.sum()),
                           unknown_length=int(un.sum()),
                           lengths=lengths, unknown_lengths=un)


def kmers_to_coordinates(kmers: np.ndarray) -> np.ndarray:
    """(N, L) int k-mers -> (N, 8L) float points (kmer2coordinates.cpp)."""
    return embedding.embed_kmers(kmers)
