"""LSH operating-point sweep (counterpart of hsearch_tpu/lsh/tuning.py).

For each candidate config: build the index, search, and score weighted
recall against the exact oracle, beside the verify bill (candidate slots
per query) that the parameters trade against.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..search import evaluate, exact, motif


@dataclasses.dataclass
class SweepPoint:
    config: motif.MotifSearchConfig
    recall: float            # weighted (the reference's metric)
    hits: int
    truth: int
    cand_slots: int          # tables * probes * cand_max per query
    build_s: float
    search_s: float

    def row(self) -> str:
        c = self.config
        return (f"K={c.hash_k:<3} L={c.hash_l:<3} W={c.w:<6g} "
                f"P={c.probes:<3} recall={self.recall:.4f} "
                f"slots/query={self.cand_slots:<8} "
                f"build={self.build_s:.2f}s search={self.search_s:.2f}s")


def sweep(db_kmers: np.ndarray, centers: np.ndarray, radius: float,
          configs: list[motif.MotifSearchConfig] | None = None,
          generator: torch.Generator | None = None,
          truth=None, device: str | torch.device = "cuda"
          ) -> list[SweepPoint]:
    """Evaluate candidate LSH configs against the exact oracle.

    Every config draws its parameters from the same generator state, as
    the JAX package reuses one key.  truth: optional precomputed
    (ci, ki, dd) from exact.search_radius, else computed here.
    """
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    state = generator.get_state()
    if configs is None:
        configs = default_grid(radius)
    if truth is None:
        truth = exact.search_radius(db_kmers, centers, radius, device=device)
    tci, tki, tdd = truth
    out = []
    for cfg in configs:
        cfg = dataclasses.replace(cfg, radius=radius)
        t0 = time.perf_counter()
        index = motif.build_index(db_kmers,
                                  torch.Generator().set_state(state), cfg,
                                  device=device)
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ci, ki, _ = motif.search(index, centers, cfg)
        search_s = time.perf_counter() - t0
        rep = evaluate.recall_from_indices(tci, tki, tdd, ci, ki, radius)
        out.append(SweepPoint(
            config=cfg, recall=rep.recall, hits=len(ci), truth=len(tci),
            cand_slots=cfg.hash_l * max(cfg.probes, 1) * index.cand_max,
            build_s=build_s, search_s=search_s))
    return out


def default_grid(radius: float) -> list[motif.MotifSearchConfig]:
    """A starting grid around the reference's defaults."""
    grid = []
    for k, t, w, p in [(4, 4, 50.0, 1),      # the reference's fixed point
                       (4, 8, 50.0, 1),
                       (8, 8, 50.0, 8),
                       (8, 16, 50.0, 16),
                       (8, 8, 2 * radius, 8),
                       (10, 16, 2 * radius, 16)]:
        grid.append(motif.MotifSearchConfig(hash_k=k, hash_l=t, w=w,
                                            radius=radius, probes=p))
    return grid


def best(points: list[SweepPoint], min_recall: float = 0.95):
    """Cheapest config meeting the recall bar (or the highest-recall one
    when none does)."""
    ok = [p for p in points if p.recall >= min_recall]
    if ok:
        return min(ok, key=lambda p: p.cand_slots)
    return max(points, key=lambda p: p.recall)
