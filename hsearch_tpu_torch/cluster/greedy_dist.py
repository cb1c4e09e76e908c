"""Greedy k-mer clustering (hclust2/hclust3) across processes (counterpart
of hsearch_tpu/cluster/greedy_dist.py), over torch.distributed.

Replicated state, partitioned elections:

  * **codes**: every process draws each round's LSH from the same CPU
    generator (``greedy._round_params``; nothing else is drawn from it) or
    takes the same ``round_params``, and hashes the same k-mers, so every
    process forms the round's bucket rows identically with no
    communication;
  * **work partition**: within each size class, process p elects the
    bucket rows r with r % nproc == p (rows of a class have one padded
    width, so striding balances count and cost), against the round-start
    state.  A point lies in exactly one bucket per round, so the
    elections of different processes never touch the same point;
  * **merge**: after the round, one padded all-gather of the round's
    (absorbed, absorber) int32 edges (``multihost.allgather_rows``; a
    point is absorbed at most once over the whole run, so the traffic is
    at most N rows) is applied to the replicated parent / state.  The
    absorbed and absorber sets of a round are disjoint, so the order of
    application does not matter and the result is bit-identical to
    single-process ``greedy.cluster_greedy``.

Collectives run on the group's collective device (the CPU under gloo);
the hashing, grouping and elections run on ``device``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _device
from ..core import embedding
from ..lsh import pstable
from ..parallel import multihost
from ..utils import profiling
from . import greedy


def cluster_greedy_distributed(kmers: np.ndarray,
                               generator: torch.Generator | None,
                               config: greedy.ClusterConfig
                               = greedy.ClusterConfig(),
                               round_params=None,
                               device: str | torch.device = "cuda"
                               ) -> greedy.ClusterResult:
    """``greedy.cluster_greedy`` across ``multihost.process_count()``
    processes.

    Every process calls with identical arguments (``generator`` in the
    same state, or the same ``round_params``) and receives the identical
    ClusterResult, bit-equal to single-process ``cluster_greedy`` on the
    same draws.  Without a process group it is ``cluster_greedy``'s walk
    in one process.
    """
    dev = _device.resolve(device)
    nproc = multihost.process_count()
    pid = multihost.process_index()
    kmers = np.asarray(kmers)
    n, l = kmers.shape
    dim = l * embedding.AA_DIM
    km_pad = torch.zeros((n + 1, l), dtype=torch.int8, device=dev)
    km_pad[:n] = torch.as_tensor(kmers.astype(np.int8), device=dev)
    merged = torch.zeros(n + 1, dtype=torch.uint8, device=dev)
    merged[n] = 2
    parent = torch.full((n + 1,), -1, dtype=torch.int64, device=dev)
    # the collective context comes up while the processes are in
    # lock-step: the first real exchange follows a whole round of elections
    multihost.allgather_rows(np.zeros((0, 2), np.int32), 2)
    for rnd in range(config.hash_l):
        params = greedy._round_params(rnd, generator, dim, config,
                                      round_params, dev)
        codes = pstable.hash_codes(km_pad[:n], params, is_kmers=True)[0]
        active_ids = torch.nonzero(merged[:n] != 2)[:, 0]
        mats = greedy._bucket_class_matrices(codes[active_ids], active_ids,
                                             config.bucket_max, n)
        profiling.heartbeat(
            f"greedy_dist p{pid}/{nproc}: round {rnd + 1}/{config.hash_l}, "
            f"{active_ids.numel()} active points, "
            f"{sum(ids.shape[0] for ids, _ in mats)} bucket rows")
        absorbed, absorber = greedy._elect_edges(km_pad, merged.clone(),
                                                 mats, config, pid, nproc)
        hit = absorbed < n
        local = torch.stack([absorbed[hit], absorber[hit]], dim=1)
        edges = multihost.allgather_rows(
            local.to(torch.int32).cpu().numpy(), 2)
        if len(edges):
            e = torch.as_tensor(edges.astype(np.int64), device=dev)
            parent[e[:, 0]] = e[:, 1]
            merged[e[:, 0]] = 2
            # "to be the real center" (hclust2.cpp:122)
            merged[e[:, 1]] = 1
    return greedy.ClusterResult(parent=parent[:n].cpu().numpy(),
                                merged=merged[:n].cpu().numpy())
