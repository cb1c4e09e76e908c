"""Inputs of a run, made from ``--seed``: the k-mer database and the pool
of query centers (on the device), and the batches the traffic sends.

The database follows the upstream project's own labelled benchmark
(``shuffle_kmers.cpp``: the members of motif clusters, each query a
motif's center, ``STOCKHOLM.h``), drawn from published statistics of
protein sequence (``protein_model.py``): each family's center is a 25-mer
of background residues (Robinson & Robinson 1991); each member copies it
at an identity drawn uniformly between ``identity_min`` and 1, every
position replaced with probability one minus that identity, by a residue
drawn from BLOSUM62's substitution frequencies.  Row ``r`` is a member of
family ``r mod families``, so every family has ``family_size`` members or
one more, spread over the whole database.  The query pool is ``pool``
distinct family centers.  It is drawn with a ``torch.Generator`` on the
device, in chunks, so later edits of the program cannot change the
yardstick.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from . import protein_model

# rows drawn per call: bounds the (rows, L) float64 draws to ~420 MB each
CHUNK = 1 << 21


@dataclasses.dataclass
class Seeds:
    """Independent 64-bit seeds of one run, all from ``--seed``."""

    data: int
    build: int
    traffic: int


def seeds(seed: int) -> Seeds:
    state = np.random.SeedSequence(seed % 2 ** 64).generate_state(
        3, np.uint64)
    return Seeds(*(int(s) for s in state))


@dataclasses.dataclass
class Data:
    db: torch.Tensor      # (N, L) int8 amino-acid indices, on the device
    pool: torch.Tensor    # (P, L) int8 query centers, on the device
    pool_np: np.ndarray   # the same centers, (P, L) int32 on the host


def family_db(cfg: dict, seed: int, device: torch.device) -> Data:
    """``cfg``'s ``n_rows`` x ``kmer_len`` family database and its
    ``pool`` of family centers, drawn on ``device`` from ``seed``."""
    n, l = cfg["n_rows"], cfg["kmer_len"]
    nfam = max(1, n // cfg["family_size"])
    if cfg["pool"] > nfam:
        raise ValueError(f"pool {cfg['pool']} > {nfam} families")
    lo_id = float(cfg["identity_min"])
    if not 0.0 <= lo_id <= 1.0:
        raise ValueError(f"identity_min {lo_id} outside [0, 1]")
    g = torch.Generator(device=device).manual_seed(seed)
    bg = torch.as_tensor(protein_model.background(), device=device)
    # inverse CDFs of each residue's replacement: a zero-probability step
    # (the residue itself) is never drawn by searchsorted(right=True)
    cdf = torch.as_tensor(np.cumsum(protein_model.substitution(), axis=1),
                          device=device)
    fam = torch.multinomial(bg, nfam * l, replacement=True, generator=g) \
        .to(torch.int8).view(nfam, l)
    db = torch.empty((n, l), dtype=torch.int8, device=device)
    for lo in range(0, n, CHUNK):
        m = min(CHUNK, n - lo)
        which = torch.arange(lo, lo + m, device=device) % nfam
        ident = lo_id + (1.0 - lo_id) * torch.rand(
            (m, 1), generator=g, device=device, dtype=torch.float64)
        subst = torch.rand((m, l), generator=g, device=device,
                           dtype=torch.float64) >= ident
        base = fam[which]
        rows = base.clone()
        u = torch.rand((m, l), generator=g, device=device,
                       dtype=torch.float64)
        for a in range(20):
            sel = subst & (base == a)
            new = torch.searchsorted(cdf[a], u[sel], right=True) \
                .clamp_(max=19).to(torch.int8)
            rows[sel] = new
        db[lo:lo + m] = rows
    pick = torch.randperm(nfam, generator=g, device=device)[:cfg["pool"]]
    pool = fam[pick]
    return Data(db=db, pool=pool,
                pool_np=pool.cpu().numpy().astype(np.int32))


class Schedule:
    """The batches of one client in a closed loop: ``batch`` centers per
    batch, drawn by cycling through a seeded permutation of the pool (so a
    batch never holds a center twice); each batch is due when the previous
    one returned."""

    def __init__(self, traffic: dict, pool_size: int, seed: int):
        self.batch_size = int(traffic["batch"])
        if not 0 < self.batch_size <= pool_size:
            raise ValueError(f"batch {self.batch_size} outside "
                             f"1..{pool_size}")
        if traffic["loop"] != "closed" or traffic.get("clients", 1) != 1:
            raise ValueError("the generator runs one client in a closed "
                             "loop")
        self.perm = np.random.default_rng(seed % 2 ** 64) \
            .permutation(pool_size)

    def batch(self, i: int) -> np.ndarray:
        """Pool indices of batch ``i``."""
        p = len(self.perm)
        return self.perm[(i * self.batch_size
                          + np.arange(self.batch_size)) % p]


def percentile(values, q: float) -> float:
    """The ``q``-th percentile by linear interpolation between closest
    ranks (numpy's default)."""
    if not len(values):
        return math.nan
    return float(np.percentile(np.asarray(values, np.float64), q))
