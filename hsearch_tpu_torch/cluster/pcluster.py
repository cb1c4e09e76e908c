"""Whole-protein clustering: KLSH pre-grouping + alignment + union-find
(counterpart of hsearch_tpu/cluster/pcluster.py).

The pcluster pipeline (pcluster.cpp:11-81,150-170): each protein becomes a
512-dim histogram of reduced-alphabet 3-mers, hashed through a cosine
("kernelized") LSH code; proteins sharing a code form a pre-group; every
group member is aligned against the group (the seed-extend engine of
align/); proteins connected by significant alignments merge transitively.

The reference *declares* the final merge but ships it as an empty stub
(``UnionFind::ProteinClustering``, union_find.cpp:35-43); here the merge
is implemented for real.

On the device: the KLSH projection (one (P, 512) @ (512, bits) float32
GEMM, TF32 off, then cos and sign) and the batched extension.  KLSH
parameters come from an explicit ``torch.Generator``
(``klsh_init``) or, to reproduce another package's draws, from arrays
(``klsh_params_from_arrays``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import _device
from ..align import pipeline as align_pipeline
from ..core import alphabet
from ..utils import profiling
from . import union_find

FEATURE_SIZE = alphabet.HIST8_SIZE ** alphabet.HASHLEN   # 8^3 = 512
DEFAULT_BITS = 16       # bit_num (pcluster.cpp:14)
DEFAULT_SIGMA = 0.2     # sigma (pcluster.cpp:15)


@dataclasses.dataclass
class KLSHParams:
    """Random-Fourier cosine LSH (lsh.cpp:17-49)."""

    w: torch.Tensor    # (F, bits) ~ N(0, sigma^4)  [sic: the reference
                       # draws N(0, sigma^2) with "sigma" = sigma^2,
                       # lsh.cpp:22]
    t: torch.Tensor    # (bits,) ~ U[-1, 1]
    b: torch.Tensor    # (bits,) ~ U[0, 2pi)

    def to(self, device: torch.device) -> "KLSHParams":
        return KLSHParams(w=self.w.to(device), t=self.t.to(device),
                          b=self.b.to(device))


def klsh_init(generator: torch.Generator, feature_size: int = FEATURE_SIZE,
              bits: int = DEFAULT_BITS,
              sigma: float = DEFAULT_SIGMA) -> KLSHParams:
    """Draw one table's parameters from a CPU generator (float32)."""
    w = torch.randn((feature_size, bits), generator=generator,
                    dtype=torch.float32) * np.float32(sigma ** 2)
    t = torch.rand((bits,), generator=generator,
                   dtype=torch.float32) * 2.0 - 1.0
    b = torch.rand((bits,), generator=generator,
                   dtype=torch.float32) * np.float32(2.0 * np.pi)
    return KLSHParams(w=w, t=t, b=b)


def klsh_params_from_arrays(w: np.ndarray, t: np.ndarray,
                            b: np.ndarray) -> KLSHParams:
    """One table's KLSH parameters given as arrays (``w`` (F, bits), ``t``
    and ``b`` (bits,)), for example the JAX package's draws as numpy."""
    return KLSHParams(w=torch.as_tensor(np.array(w, np.float32)),
                      t=torch.as_tensor(np.array(t, np.float32)),
                      b=torch.as_tensor(np.array(b, np.float32)))


def klsh_codes(features: torch.Tensor, params: KLSHParams) -> torch.Tensor:
    """(P, F) feature histograms -> (P,) int32 codes, on the device of
    ``features`` (``params`` must be there too).

    bit_i = sign(cos(w_i . x + b_i) + t_i)  (lsh.cpp:40-49): one
    full-float32 GEMM."""
    proj = features.to(torch.float32) @ params.w
    bits = ((torch.cos(proj + params.b[None, :]) + params.t[None, :]) >= 0) \
        .to(torch.int32)
    weights = 1 << torch.arange(params.t.shape[0], dtype=torch.int32,
                                device=features.device)
    return (bits * weights).sum(dim=1, dtype=torch.int32)


def protein_histograms(db, lo: int = 0, hi: int | None = None) -> np.ndarray:
    """(hi-lo, 512) reduced 3-mer count histograms of proteins [lo, hi)
    (PreClustering, pcluster.cpp:22-33; Kmer2Integer util.hpp:244-250).

    One vectorized pass over the concatenated sequence: every 3-mer
    window's feature id is computed at once, windows crossing protein
    boundaries are masked, and the (protein, feature) pairs fall into
    one bincount, with no per-protein Python loop.
    The [lo, hi) range lets callers stream histograms in protein chunks:
    the full (P, 512) matrix is ~5 GB at the IGC corpus's 9.9M proteins
    (protein.hpp:2-4).

    Returned as uint16 (int32 in the pathological >65535-counts case;
    IGC's longest peptide is 29,409 AA, protein.hpp:2-4): counts are exact
    integers, so their float32 cast in ``klsh_codes_all`` is exact."""
    p_all = db.num_proteins
    hi = p_all if hi is None else hi
    p = hi - lo
    starts_all = np.asarray(db.starts)
    starts = starts_all[lo:hi + 1] - starts_all[lo]
    seq = np.minimum(
        np.asarray(db.seq)[starts_all[lo]:starts_all[hi]], 19)
    if len(seq) < alphabet.HASHLEN:
        return np.zeros((p, FEATURE_SIZE), np.uint16)
    ids = alphabet.reduced_kmer_ids(seq)          # (S - HASHLEN + 1,)
    pos = np.arange(len(ids))
    pid = np.repeat(np.arange(p), np.diff(starts))[:len(ids)]
    ok = pos + alphabet.HASHLEN <= starts[pid + 1]
    key = pid[ok] * FEATURE_SIZE + ids[ok]
    out = np.bincount(key, minlength=p * FEATURE_SIZE) \
        .reshape(p, FEATURE_SIZE)
    return out.astype(np.uint16 if not len(key)
                      or out.max() <= np.iinfo(np.uint16).max
                      else np.int32)


# protein chunk per klsh_codes_all GEMM: bounds host feature memory to
# chunk x 512 float32 (~0.5 GB) whatever the corpus size; the same chunks
# as the JAX package, so both run their GEMMs over the same rows
CODE_CHUNK = 1 << 18


def klsh_codes_all(db, params_list, chunk: int = CODE_CHUNK,
                   device: str | torch.device = "cuda") -> np.ndarray:
    """(T, P) int32 KLSH codes of every protein under each of T tables'
    params, histogrammed and projected in bounded-memory chunks: each
    protein chunk's histograms are built once and projected through
    every table."""
    dev = _device.resolve(device)
    params_list = [kp.to(dev) for kp in params_list]
    p = db.num_proteins
    t = len(params_list)
    out = np.empty((t, p), np.int32)
    for lo in range(0, max(p, 1), chunk):
        hi = min(p, lo + chunk)
        feats = torch.as_tensor(
            protein_histograms(db, lo, hi).astype(np.float32), device=dev)
        for i, kp in enumerate(params_list):
            out[i, lo:hi] = klsh_codes(feats, kp).cpu().numpy()
    return out


def table_groups(codes: np.ndarray, seen: set) -> list[np.ndarray]:
    """The size>1 code buckets of one KLSH table that no earlier table
    produced (deduped by exact sorted membership).

    ``seen`` keys are the raw bytes of each group's sorted int64 member
    array: hashed at C speed, exact (no truncated-hash collision risk).
    """
    order = np.argsort(codes, kind="stable")
    sc = codes[order]
    cuts = np.nonzero(sc[1:] != sc[:-1])[0] + 1
    new_groups = []
    for g in np.split(order, cuts):
        if len(g) < 2:
            continue
        g = np.sort(g)
        gk = g.tobytes()
        if gk in seen:
            continue
        seen.add(gk)
        new_groups.append(g)
    return new_groups


@dataclasses.dataclass
class ProteinClusters:
    labels: np.ndarray            # (P,) cluster label per protein
    pre_groups: list[np.ndarray]  # KLSH buckets (size > 1) that were aligned
    hits: list                    # all alignment hits across groups
    pairs_extended: int = 0       # seed pairs the searches extended

    def groups(self) -> list[np.ndarray]:
        order = np.argsort(self.labels, kind="stable")
        sl = self.labels[order]
        cuts = np.nonzero(sl[1:] != sl[:-1])[0] + 1
        return np.split(order, cuts)


def cluster_proteins(db, generator: torch.Generator | None,
                     params: align_pipeline.SearchParams
                     = align_pipeline.SearchParams(),
                     cluster_evalue: float = 1e-3,
                     bits: int = DEFAULT_BITS,
                     sigma: float = DEFAULT_SIGMA,
                     tables: int = 1,
                     gapped: bool = False,
                     hit_sink=None,
                     render: bool = True,
                     klsh_params: list[KLSHParams] | None = None,
                     device: str | torch.device = "cuda"
                     ) -> ProteinClusters:
    """Full pcluster pipeline over a ProteinDB.

    tables=1 matches the reference (one 16-bit code per protein,
    pcluster.cpp:17,34).  A single table splits families at a few percent
    substitution; more tables take the union of each table's pre-groups
    (any shared code anywhere puts two proteins in a common group).

    Each table's KLSH parameters are drawn from ``generator`` (a CPU
    torch.Generator) or taken from ``klsh_params`` (one per table, for
    example ``klsh_params_from_arrays`` of the JAX package's draws).

    All of a table's pre-groups are aligned by ONE group-partitioned
    ProteinSearcher (seed probes bounded to each protein's own group,
    e-values under each group's own statistics) instead of a fresh index
    per bucket (pcluster.cpp:157-167).

    gapped=True re-aligns gap-triggered hits with the banded gapped
    aligner under the SAME group statistics, so refined and unrefined
    hits stay on one e-value scale.

    hit_sink: optional callable(list[Hit]): hits stream to it per search
    slice (union edges and cross-table dedup keys are taken as they
    stream) instead of accumulating in ``ProteinClusters.hits``, which
    comes back empty.  Incompatible with gapped=True.  render=False skips
    aligned-string rendering (numeric fields unchanged).
    """
    if hit_sink is not None and gapped:
        raise ValueError("hit_sink requires gapped=False")
    if klsh_params is not None and len(klsh_params) != tables:
        raise ValueError(f"klsh_params holds {len(klsh_params)} tables, "
                         f"tables={tables}")
    dev = _device.resolve(device)
    profiling.heartbeat(
        f"cluster_proteins: histograms over {db.num_proteins} proteins")
    uf = union_find.UnionFind(db.num_proteins)
    all_hits = []
    aligned_groups = []
    pairs_extended = 0
    seen_groups: set[bytes] = set()
    # directional (query << 32 | subject) keys of every hit so far: a
    # later table's pre-groups largely re-cover earlier tables' pairs, so
    # known pairs are dropped before extension
    hit_pairs = np.empty(0, np.uint64)
    if klsh_params is None:
        klsh_params = [klsh_init(generator, FEATURE_SIZE, bits, sigma)
                       for _ in range(tables)]
    with profiling.phase("pcluster/klsh_codes", sync=True):
        all_codes = klsh_codes_all(db, klsh_params, device=dev)
    for t in range(tables):
        new_groups = table_groups(all_codes[t], seen_groups)
        if not new_groups:
            continue
        aligned_groups.extend(new_groups)
        subset = np.concatenate(new_groups)
        group_of = np.repeat(np.arange(len(new_groups)),
                             [len(g) for g in new_groups])
        profiling.heartbeat(
            f"cluster_proteins: table {t + 1}/{tables} — "
            f"{len(new_groups)} new groups, {len(subset)} proteins to "
            "index + align")
        searcher = align_pipeline.ProteinSearcher(
            db, params, subset=subset, groups=group_of, device=dev)
        if hit_sink is not None:
            # streaming mode: take union edges and dedup keys per slice,
            # forward the hits, keep nothing resident
            key_parts: list[np.ndarray] = []

            def _sink(chunk_hits, _parts=key_parts):
                n_h = len(chunk_hits)
                if n_h:
                    q = np.fromiter((h.query for h in chunk_hits),
                                    np.int64, n_h)
                    s = np.fromiter((h.subject for h in chunk_hits),
                                    np.int64, n_h)
                    ev = np.fromiter((h.evalue for h in chunk_hits),
                                     np.float64, n_h)
                    m = (q != s) & (ev <= cluster_evalue)
                    uf.union_edges(q[m], s[m])
                    if tables > 1:
                        _parts.append(
                            (q.astype(np.uint64) << np.uint64(32))
                            | s.astype(np.uint64))
                hit_sink(chunk_hits)

            searcher.search_all(exclude_pairs=hit_pairs if t else None,
                                hit_sink=_sink, render=render)
            pairs_extended += searcher.pairs_extended
            if tables > 1:
                hit_pairs = np.sort(np.concatenate(
                    [hit_pairs, *key_parts]))
            continue
        hits = searcher.search_all(
            exclude_pairs=hit_pairs if t else None, render=render)
        pairs_extended += searcher.pairs_extended
        profiling.heartbeat(
            f"cluster_proteins: table {t + 1}/{tables} — "
            f"{len(hits)} new hits")
        if tables > 1 and (hits or t == 0):
            new_keys = np.fromiter(
                ((int(h.query) << 32) | int(h.subject) for h in hits),
                np.uint64, len(hits))
            hit_pairs = np.sort(np.concatenate([hit_pairs, new_keys]))
        if gapped and hits:
            by_query: dict[int, list] = {}
            for h in hits:
                by_query.setdefault(h.query, []).append(h)
            refined = align_pipeline.refine_gapped_all(
                searcher, [(np.asarray(db.protein(q)), qhits)
                           for q, qhits in by_query.items()])
            hits = [h for qhits in refined for h in qhits]
        all_hits.extend(hits)
        for h in hits:
            if h.query != h.subject and h.evalue <= cluster_evalue:
                uf.union(h.query, h.subject)
    return ProteinClusters(labels=uf.components(),
                           pre_groups=aligned_groups, hits=all_hits,
                           pairs_extended=pairs_extended)
