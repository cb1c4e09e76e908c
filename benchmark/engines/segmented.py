"""The segmented engine: ``stream.build_segmented`` once, with a device
budget from the configuration (0: every segment streams), and
``stream.search_segmented`` per batch.

``search_segmented`` takes no ``approx_select`` and its per-segment
``ivf.search`` then reads ``HSEARCH_APPROX_SELECT`` from the environment:
the engine sets that variable in this process to the configuration's
``approx_select``, so the block select a cell runs is the one its
configuration states, whatever the caller's environment holds.
"""

from __future__ import annotations

import os

import torch

from hsearch_tpu_torch.core import embedding
from hsearch_tpu_torch.ops import cuda_kernels
from hsearch_tpu_torch.search import stream

# the kernels the build, the uploads and the search launch on the card
KERNELS = ("sq_distance_prune", "ptable_verify", "block_bounds")


class Engine:
    def __init__(self, cfg: dict, traffic: dict, data, seeds, device):
        if device.type == "cuda":
            cuda_kernels.build(KERNELS)
        self.cfg = cfg
        os.environ["HSEARCH_APPROX_SELECT"] = \
            "1" if cfg["approx_select"] else "0"
        self.center_block = int(traffic["center_block"])
        self.k_blocks = int(cfg["k_blocks"])
        self.index = stream.build_segmented(
            data.db.cpu().numpy(), torch.Generator().manual_seed(seeds.build),
            segment_points=cfg["segment_points"],
            block_size=cfg["block_size"],
            device_budget_bytes=cfg["device_budget_bytes"], device=device)
        self.stats: dict = {}

    def search(self, centers):
        """One batch of (C, L) int centers -> (center, global k-mer id,
        distance) host arrays; the program's counters (``seg_walls_s``,
        ``upload_dispatch_s``, ...) land in ``self.stats``."""
        self.stats = {}
        cfg = self.cfg
        return stream.search_segmented(
            self.index, centers, cfg["radius"], k_blocks=self.k_blocks,
            max_hits=cfg["max_hits"], center_block=self.center_block,
            retry_overflow=cfg["retry_overflow"], stats_out=self.stats,
            pack_cap_frac=cfg["pack_cap_frac"])

    def call_shapes(self, batch: int) -> list:
        """The launch shape of each prune and verify call one batch makes:
        one per segment and center block."""
        out = []
        l, bs = self.index.kmer_len, self.index.block_size
        for seg in self.index.segments:
            b = seg.db_sorted.shape[0]
            out += [{"C": self.center_block, "B": b, "D": embedding.AA_DIM * l,
                     "kb": min(self.k_blocks, b), "bs": bs, "L": l}] \
                * (-(-batch // self.center_block))
        return out

    def close(self):
        self.index = None


def make(cfg, traffic, data, seeds, device):
    return Engine(cfg, traffic, data, seeds, device)
