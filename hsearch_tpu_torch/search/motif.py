"""Motif search helpers (counterpart of hsearch_tpu/search/motif.py).

Only the per-center P-tables are ported so far; they feed the IVF
engine's verify.  The LSH engine that fills the rest of this module is
still to be ported (ROADMAP A.6).
"""

from __future__ import annotations

import torch

from ..core import embedding
from ..ops import distance


def _center_ptables(centers: torch.Tensor, kmer_len: int) -> torch.Tensor:
    """(C, L) int or (C, 8L) float centers -> (C, L, 20) P-tables.

    P[c, l, aa] = squared distance between the center's l-th 8-dim slice
    and the coordinates of amino acid ``aa``; for integer centers this is
    exactly DISTANCE_SQUARE[center_l, aa] (in float32).
    """
    dev = centers.device
    if not torch.is_floating_point(centers):
        dsq = distance.const("dsq", dev)
        return dsq[centers.long()]                               # (C, L, 20)
    coords = distance.const("coords", dev)                      # (20, 8)
    c = centers.shape[0]
    x = centers.to(torch.float32).reshape(c, kmer_len, embedding.AA_DIM)
    diff = x[:, :, None, :] - coords[None, None, :, :]           # (C, L, 20, 8)
    return torch.sum(diff * diff, dim=-1)
