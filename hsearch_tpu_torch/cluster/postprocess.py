"""Cluster post-processing (counterpart of hsearch_tpu/cluster/postprocess.py):
the center-distance merge, cluster centers, distance samples, MEME output
and benchmark shuffling.  File formats match the reference outputs
(centerDistanceSmapling.cpp, shuffle_kmers.cpp).
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from .. import _device
from ..core import alphabet, embedding
from ..ops import distance

#: MEME column order (centerDistanceSmapling.cpp:195-197)
MEME_ALPHABET = "ACDEFGHIKLMNPQRSTVWY"


def cluster_centers(clusters: list[list[str]]) -> np.ndarray:
    """Mean embedded point per cluster ((K, 8L) array): Center() over
    KmerToCoordinates embeddings (centerDistanceSmapling.cpp:110-136)."""
    out = []
    for members in clusters:
        if len({len(m) for m in members}) > 1:
            raise ValueError("cluster members must share one length "
                             f"(got {sorted({len(m) for m in members})})")
        km = np.stack([alphabet.encode(m) for m in members])
        out.append(embedding.embed_kmers(km).mean(axis=0))
    if not out:
        return np.zeros((0, 0), np.float32)
    return np.stack(out)


def write_centers_as_datapoints(path: str, names: list[str],
                                centers: np.ndarray) -> None:
    """'hclust.format.txt' writer (cluster2datapoint,
    centerDistanceSmapling.cpp:125-135): name line + coordinate line."""
    with open(path, "w") as f:
        for name, c in zip(names, centers):
            f.write(name + "\n")
            f.write(" ".join(f"{v:g}" for v in c) + "\n")


def center_distance_samples(centers: np.ndarray,
                            random_points: np.ndarray | None = None,
                            device: str | torch.device = "cuda"):
    """(inter-center distances, random-point-to-center distances) as flat
    arrays (sequencedatabase2centers, centerDistanceSmapling.cpp:138-186),
    from two distance-matrix products on ``device``."""
    dev = _device.resolve(device)
    c = torch.as_tensor(np.asarray(centers, np.float32), device=dev)
    d2 = distance.sq_distance_matrix(c, c).cpu().numpy()
    iu = np.triu_indices(len(centers), k=1)
    inter = np.sqrt(np.maximum(d2[iu], 0.0))
    rand_d = None
    if random_points is not None:
        r2 = distance.sq_distance_matrix(
            torch.as_tensor(np.asarray(random_points, np.float32),
                            device=dev), c).cpu().numpy()
        rand_d = np.sqrt(np.maximum(r2, 0.0)).ravel()
    return inter, rand_d


def merge_by_center_distance(kmers: np.ndarray, labels: np.ndarray,
                             merge_radius: float,
                             generator: torch.Generator,
                             k_blocks: int = 128,
                             max_hits: int = 256,
                             device: str | torch.device = "cuda"
                             ) -> np.ndarray:
    """Transitive post-merge: union clusters whose center k-mers lie
    within ``merge_radius`` of each other.

    hclust v1 re-clusters CLUSTERS by hashing their centroids
    (hclust.cpp:186-235); the greedy pass has no such stage, so one family
    fragments into every center the bucket order happened to elect.  The
    centers are k-mer rows, so the merge edges are a radius search of the
    centers against themselves on the IVF engine (both CUDA kernels on
    the card), then connected components.

    ``labels`` holds, per row, the row index of its cluster center
    (cluster_greedy's parent for absorbed rows, its own index for heads).
    Returns new labels in the same convention: every component is
    relabeled to its smallest head.  ``generator`` (a CPU
    torch.Generator) samples the IVF cells.
    """
    from ..search import ivf
    from . import union_find

    labels = np.asarray(labels)
    heads, inverse = np.unique(labels, return_inverse=True)
    if len(heads) <= 1:
        return labels.copy()
    centers = np.ascontiguousarray(kmers[heads]).astype(np.int32)
    index = ivf.build_index(centers, generator, block_size=32, device=device)
    # over_hits = centers whose edge list was cut at max_hits: real
    # dropped edges, so the hit cap escalates until clean.  over_blocks =
    # centers with more than k_blocks unprunable blocks (possible misses):
    # reported, not chased — union-find needs only one surviving edge per
    # cluster pair.
    stats: dict = {}
    for _ in range(4):
        stats.clear()
        ci, ki, _ = ivf.search(index, centers, merge_radius,
                               k_blocks=k_blocks, max_hits=max_hits,
                               retry_overflow=False, stats_out=stats)
        if not stats.get("over_hits"):
            break
        max_hits *= 2
    if stats.get("over_hits"):
        warnings.warn(
            f"merge_by_center_distance: {stats['over_hits']} centers still "
            f"exceed max_hits={max_hits} after escalation; some merge edges "
            "were dropped (clusters may stay fragmented)")
    if stats.get("over_blocks"):
        warnings.warn(
            f"merge_by_center_distance: {stats['over_blocks']}/{len(heads)} "
            f"centers had more than k_blocks={k_blocks} unprunable blocks; "
            "raise k_blocks (or --merge-k-blocks) if merged clusters look "
            "fragmented")
    comp = union_find.connected_components(len(heads), ci, ki)
    # relabel each component to its smallest head (stable argsort over
    # sorted heads: each component's first entry is its minimum)
    order = np.argsort(comp, kind="stable")
    sc = comp[order]
    starts = np.searchsorted(sc, np.arange(comp.max() + 1))
    first = heads[order[starts]]
    return first[comp[inverse]]


def meme_probability_matrix(members: list[str]) -> np.ndarray:
    """(w, 20) letter-probability matrix in MEME_ALPHABET column order."""
    w = len(members[0])
    counts = np.zeros((w, 26), np.float64)
    for m in members:
        for k, ch in enumerate(m.upper()[:w]):
            j = ord(ch) - ord("A")
            if 0 <= j < 26:
                counts[k][j] += 1.0
    cols = [ord(ch) - ord("A") for ch in MEME_ALPHABET]
    mat = counts[:, cols]
    sums = counts.sum(axis=1, keepdims=True)
    return mat / np.maximum(sums, 1.0)


def write_meme(path: str, clusters: list[tuple[str, list[str]]],
               max_members: int | None = None,
               include_members: bool = False) -> None:
    """MEME version-4 motif file (meme_format_output,
    centerDistanceSmapling.cpp:189-228; clusterDistance :243-270).

    ``max_members=10`` with ``include_members=True`` matches
    meme_format_output's truncated variant; the defaults produce the
    clean matrix-only form of clusterDistance.
    """
    with open(path, "w") as f:
        f.write("MEME version 4\n\n")
        f.write(f"ALPHABET= {MEME_ALPHABET}\n\n")
        for name, members in clusters:
            if max_members is not None:
                members = members[:max_members]
            f.write(f"MOTIF {name}\n")
            f.write(f"letter-probability matrix: alength= 20 "
                    f"w= {len(members[0])}\n")
            if include_members:
                for m in members:
                    f.write(m + "\n")
                f.write("\n " + "    ".join(MEME_ALPHABET) + "\n")
            mat = meme_probability_matrix(members)
            for row in mat:
                f.write(" ".join(f"{v:.2f}" for v in row) + "\n")
            f.write("\n")


def shuffle_motifs(clusters: list[tuple[str, list[str]]],
                   rng: np.random.Generator,
                   num_motifs: int | None = None,
                   seqs_per_motif: int | None = None):
    """Labeled, shuffled benchmark FASTA records (shuffleMotifs,
    shuffle_kmers.cpp:13-65) from a seeded numpy rng.

    Returns list of (name 'motif<i>_seq<j>', sequence) in random order.
    """
    if num_motifs:
        clusters = clusters[:num_motifs]
    records = []
    for i, (_, members) in enumerate(clusters):
        if seqs_per_motif:
            members = members[:seqs_per_motif]
        for j, m in enumerate(members):
            records.append((f"motif{i}_seq{j}", m))
    perm = rng.permutation(len(records))
    return [records[i] for i in perm]
