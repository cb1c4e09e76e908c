"""The LSH engine, the upstream's own method (``--engine lsh``):
``motif.build_index`` once, ``motif.search`` per batch, on an index that
lives on the card.

The configuration states the operating point (``hash_k``, ``hash_l``,
``w``, ``probes``, ``cand_max``); the center block is the traffic's.
"""

from __future__ import annotations

import torch

from hsearch_tpu_torch.ops import cuda_kernels
from hsearch_tpu_torch.search import motif

# the kernel the search launches on the card
KERNELS = ("ptable_verify",)


class Engine:
    def __init__(self, cfg: dict, traffic: dict, data, seeds, device):
        if device.type == "cuda":
            cuda_kernels.build(KERNELS)
        self.center_block = int(traffic["center_block"])
        self.config = motif.MotifSearchConfig(
            hash_k=cfg["hash_k"], hash_l=cfg["hash_l"], w=cfg["w"],
            radius=cfg["radius"], center_block=self.center_block,
            cand_max=cfg["cand_max"], max_hits=cfg["max_hits"],
            probes=cfg["probes"])
        self.index = motif.build_index(
            data.db.cpu().numpy(), torch.Generator().manual_seed(seeds.build),
            self.config, cand_max=cfg["cand_max"], device=device)
        self.stats: dict = {}

    def search(self, centers):
        """One batch of (C, L) int centers -> (center, k-mer id, distance)
        host arrays; the program's counters land in ``self.stats``."""
        self.stats = {}
        return motif.search(self.index, centers, self.config,
                            stats_out=self.stats)

    def call_shapes(self, batch: int) -> list:
        """The launch shape of each verify call one batch of ``batch``
        centers makes, one per center block: ``kb`` candidate slots of one
        row each (every table, probe and bucket slot up to cand_max)."""
        cfg, idx = self.config, self.index
        probes = min(max(cfg.probes, 1), 1 << cfg.hash_k)
        shape = {"C": self.center_block,
                 "kb": idx.tables.num_tables * probes * idx.cand_max,
                 "bs": 1, "L": idx.kmer_len}
        return [shape] * (-(-batch // self.center_block))

    def close(self):
        self.index = None


def make(cfg, traffic, data, seeds, device):
    return Engine(cfg, traffic, data, seeds, device)
