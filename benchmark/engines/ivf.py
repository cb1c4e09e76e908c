"""The resident IVF engine: ``ivf.build_index`` once, ``ivf.search`` per
batch, on an index that lives on the card."""

from __future__ import annotations

import torch

from hsearch_tpu_torch.ops import cuda_kernels
from hsearch_tpu_torch.search import ivf

# the kernels the build and the search launch on the card
KERNELS = ("sq_distance_prune", "ptable_verify", "block_bounds")


class Engine:
    def __init__(self, cfg: dict, traffic: dict, data, seeds, device):
        if device.type == "cuda":
            cuda_kernels.build(KERNELS)
        self.cfg = cfg
        self.center_block = int(traffic["center_block"])
        self.k_blocks = int(cfg["k_blocks"])
        self.index = ivf.build_index(
            data.db.cpu().numpy(), torch.Generator().manual_seed(seeds.build),
            block_size=cfg["block_size"], device=device)
        self.stats: dict = {}

    def search(self, centers):
        """One batch of (C, L) int centers -> (center, k-mer id, distance)
        host arrays; the program's counters land in ``self.stats``."""
        self.stats = {}
        cfg = self.cfg
        return ivf.search(self.index, centers, cfg["radius"],
                          k_blocks=self.k_blocks, max_hits=cfg["max_hits"],
                          center_block=self.center_block,
                          retry_overflow=cfg["retry_overflow"],
                          stats_out=self.stats,
                          pack_cap_frac=cfg["pack_cap_frac"],
                          approx_select=bool(cfg["approx_select"]))

    def call_shapes(self, batch: int) -> list:
        """The launch shape of each prune and verify call one batch of
        ``batch`` centers makes: one per center block."""
        idx = self.index
        b = idx.num_blocks
        shape = {"C": self.center_block, "B": b,
                 "D": idx.block_centroid.shape[1], "kb": min(self.k_blocks, b),
                 "bs": idx.block_size, "L": idx.kmer_len}
        return [shape] * (-(-batch // self.center_block))

    def close(self):
        self.index = None


def make(cfg, traffic, data, seeds, device):
    return Engine(cfg, traffic, data, seeds, device)
