"""Whole-protein clustering across processes (counterpart of
hsearch_tpu/cluster/pcluster_dist.py), over torch.distributed.

``cluster_proteins`` (KLSH pre-groups, group-partitioned alignment,
union-find; pcluster.cpp:11-81,150-170) run by N processes:

  * **codes**: every process computes the same KLSH codes
    (``pcluster.klsh_codes_all`` over the same draws), so every process
    forms the same pre-groups with no communication;
  * **work partition**, chosen per table by a rule every process
    evaluates alike: when the groups balance (the largest group's weight
    at most total / (2 * nproc)) whole groups are dealt to processes and
    each indexes and aligns only its own (group mode: a group's hits
    depend only on its own index and statistics); otherwise, in the
    giant-group KLSH regimes (sigma <= 0.1), every process builds the
    same searcher over all of the table's groups and aligns a serpentine,
    weight-balanced slice of the queries (query mode: a query's hits
    depend only on its own seeds and its group's index);
  * **merge**: after each table, one padded all-gather of (query,
    subject, union_flag) int32 edges, which feed the next table's
    ``exclude_pairs`` and the union-find every process runs alike.

Labels and pre-groups come out identical on every process and equal to
single-process ``cluster_proteins``; the hits stay with the process that
aligned them (the CLI writes them per process), and their union is the
single-process hit set.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _device
from ..align import pipeline as align_pipeline
from ..parallel import multihost
from ..utils import profiling
from . import pcluster, union_find


def partition_queries(weights: np.ndarray, nproc: int) -> np.ndarray:
    """(R,) process id per row: a deterministic serpentine balance.

    Rows sort by descending weight (index order breaks ties) and are dealt
    0..P-1, P-1..0, ..., so every process's total weight is within one
    row's weight of the others'.  Every process computes the same
    assignment with no communication."""
    r = len(weights)
    assign = np.zeros(r, np.int32)
    if nproc <= 1 or r == 0:
        return assign
    order = np.argsort(-np.asarray(weights, np.float64), kind="stable")
    pos = np.arange(r)
    lane = pos % nproc
    snake = np.where((pos // nproc) % 2 == 0, lane, nproc - 1 - lane)
    assign[order] = snake.astype(np.int32)
    return assign


def _allgather_rows(rows: np.ndarray, width: int) -> np.ndarray:
    """The cross-process row merge, ``multihost.allgather_rows``."""
    return multihost.allgather_rows(rows, width)


def _edge_rows(hits, cluster_evalue: float) -> np.ndarray:
    """(n, 3) int32 rows (query, subject, union_flag) of a hit list: the
    flag marks a significant hit between two proteins."""
    n = len(hits)
    q = np.fromiter((h.query for h in hits), np.int64, n)
    s = np.fromiter((h.subject for h in hits), np.int64, n)
    ev = np.fromiter((h.evalue for h in hits), np.float64, n)
    flag = (q != s) & (ev <= cluster_evalue)
    return np.stack([q, s, flag], axis=1).astype(np.int32).reshape(n, 3)


def cluster_proteins_distributed(
        db, generator: torch.Generator | None,
        params: align_pipeline.SearchParams = align_pipeline.SearchParams(),
        cluster_evalue: float = 1e-3,
        bits: int = pcluster.DEFAULT_BITS,
        sigma: float = pcluster.DEFAULT_SIGMA,
        tables: int = 1,
        gapped: bool = False,
        hit_sink=None,
        render: bool = True,
        klsh_params: list | None = None,
        device: str | torch.device = "cuda",
        stats_out: dict | None = None) -> pcluster.ProteinClusters:
    """``cluster_proteins`` across ``multihost.process_count()`` processes.

    Every process calls with identical arguments (``db`` its copy of the
    same corpus, ``generator`` in the same state or the same
    ``klsh_params``).  Returns labels and pre-groups identical on every
    process and to single-process ``cluster_proteins`` on the same draws;
    ``hits`` holds this process's hits only.

    hit_sink / render: as in ``cluster_proteins``; with a sink the union
    edges are taken from each slice as it passes and ``hits`` comes back
    empty.  ``stats_out`` receives per table the partition ``modes``
    ("group" / "query") and the ``local_queries`` this process aligned.
    """
    if hit_sink is not None and gapped:
        raise ValueError("hit_sink requires gapped=False")
    if klsh_params is not None and len(klsh_params) != tables:
        raise ValueError(f"klsh_params holds {len(klsh_params)} tables, "
                         f"tables={tables}")
    dev = _device.resolve(device)
    nproc = multihost.process_count()
    pid = multihost.process_index()
    profiling.heartbeat(
        f"cluster_proteins_dist p{pid}/{nproc}: codes over "
        f"{db.num_proteins} proteins x {tables} tables")
    uf = union_find.UnionFind(db.num_proteins)
    local_hits = []
    aligned_groups = []
    pairs_extended = 0
    modes, local_queries = [], []
    seen_groups: set[bytes] = set()
    hit_pairs = np.empty(0, np.uint64)
    if klsh_params is None:
        klsh_params = [pcluster.klsh_init(generator, pcluster.FEATURE_SIZE,
                                          bits, sigma)
                       for _ in range(tables)]
    with profiling.phase("pcluster/klsh_codes", sync=True):
        all_codes = pcluster.klsh_codes_all(db, klsh_params, device=dev)
    dstarts = np.asarray(db.starts)
    # the collective context comes up while the processes are in
    # lock-step: the first real exchange follows minutes of alignment
    _allgather_rows(np.zeros((0, 3), np.int32), 3)
    for t in range(tables):
        new_groups = pcluster.table_groups(all_codes[t], seen_groups)
        if not new_groups:
            continue
        aligned_groups.extend(new_groups)
        subset = np.concatenate(new_groups)
        group_of = np.repeat(np.arange(len(new_groups)),
                             [len(g) for g in new_groups])
        # a query's work ~ its group's residues (probes are group-local;
        # every group subject is a potential extension)
        glen = (dstarts[subset + 1] - dstarts[subset]).astype(np.float64)
        gaa = np.bincount(group_of, weights=glen)
        gw = gaa * gaa        # within-group alignment ~ all-vs-all
        group_mode = nproc > 1 and len(new_groups) >= nproc and \
            gw.max() <= gw.sum() / (2 * nproc)
        if group_mode:
            gassign = partition_queries(gw, nproc)
            mine = [g for g, a in zip(new_groups, gassign) if a == pid]
            subset_l = np.concatenate(mine) if mine \
                else np.zeros(0, np.int64)
            group_l = np.repeat(np.arange(len(mine)),
                                [len(g) for g in mine]) if mine \
                else np.zeros(0, np.int64)
            my_rows = np.arange(len(subset_l))
        else:
            subset_l, group_l = subset, group_of
            assign = partition_queries(gaa[group_of], nproc)
            my_rows = np.nonzero(assign == pid)[0]
        modes.append("group" if group_mode else "query")
        local_queries.append(int(len(my_rows)))
        profiling.heartbeat(
            f"cluster_proteins_dist p{pid}: table {t + 1}/{tables}, "
            f"{modes[-1]} mode, {len(my_rows)}/{len(subset)} query rows "
            f"local, {len(new_groups)} groups")
        hits = []
        edge_parts: list[np.ndarray] = []
        if len(my_rows):
            searcher = align_pipeline.ProteinSearcher(
                db, params, subset=subset_l, groups=group_l, device=dev)
            query_rows = None if group_mode else my_rows
            exclude = hit_pairs if t else None
            if hit_sink is not None:
                def _sink(chunk_hits, _parts=edge_parts):
                    _parts.append(_edge_rows(chunk_hits, cluster_evalue))
                    hit_sink(chunk_hits)

                searcher.search_all(exclude_pairs=exclude,
                                    query_rows=query_rows, hit_sink=_sink,
                                    render=render)
            else:
                hits = searcher.search_all(exclude_pairs=exclude,
                                           query_rows=query_rows,
                                           render=render)
            pairs_extended += searcher.pairs_extended
            if gapped and hits:
                by_query: dict[int, list] = {}
                for h in hits:
                    by_query.setdefault(h.query, []).append(h)
                refined = align_pipeline.refine_gapped_all(
                    searcher, [(np.asarray(db.protein(q)), qhits)
                               for q, qhits in by_query.items()])
                hits = [h for qhits in refined for h in qhits]
        local_hits.extend(hits)
        # gapped refinement replaces hits one for one on the same (query,
        # subject) pairs, so the refined rows serve both the next table's
        # exclusions and the union edges
        edges = np.concatenate(edge_parts) if edge_parts \
            else _edge_rows(hits, cluster_evalue)
        edges = _allgather_rows(edges, 3)
        profiling.heartbeat(
            f"cluster_proteins_dist p{pid}: table {t + 1}/{tables}, "
            f"{len(edges)} merged hits ({len(hits)} local)")
        if tables > 1 and len(edges):
            new_keys = (edges[:, 0].astype(np.uint64) << np.uint64(32)) \
                | edges[:, 1].astype(np.uint64)
            hit_pairs = np.sort(np.concatenate([hit_pairs, new_keys]))
        ue = edges[edges[:, 2] == 1]
        uf.union_edges(ue[:, 0], ue[:, 1])
    if stats_out is not None:
        stats_out.update(modes=modes, local_queries=local_queries)
    return pcluster.ProteinClusters(labels=uf.components(),
                                    pre_groups=aligned_groups,
                                    hits=local_hits,
                                    pairs_extended=pairs_extended)
