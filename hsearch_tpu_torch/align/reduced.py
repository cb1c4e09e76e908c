"""Reduced amino-acid alphabets for seeding and pre-clustering (own copy
of hsearch_tpu/align/reduced.py).

The reference ships murphy10/9/5, gbmr10, dayhoff6, hsdm4 and the identity
alphabet as group strings plus per-AA group maps (pcluster/src/pcluster/
aa.hpp:8-57); the seed index uses murphy10 (hash_search.cpp:39-60) and the
KLSH pre-clustering uses its own 8-group reduction (pcluster/src/pcluster/
util.hpp:101-105).  Here each alphabet is a (20,) int8 map over the
canonical AA order ARNDCQEGHILKMFPSTWYV (core.alphabet.AA20) — a gather
away from any encoded sequence, on host or device.
"""

from __future__ import annotations

import numpy as np

# group id per AA, canonical order A R N D C Q E G H I L K M F P S T W Y V
# (aa.hpp:34-35 et al., re-expressed over AA20 index order)
MURPHY10 = np.array([0, 1, 2, 2, 3, 2, 2, 4, 5, 6, 6, 1, 6, 7, 8, 9, 9, 7, 7, 6],
                    np.int8)
MURPHY9 = np.array([0, 1, 1, 1, 2, 1, 1, 3, 4, 5, 5, 1, 5, 6, 7, 8, 8, 6, 6, 5],
                   np.int8)
MURPHY5 = np.array([1, 4, 3, 3, 0, 3, 3, 1, 4, 0, 0, 4, 0, 2, 1, 1, 1, 2, 2, 0],
                   np.int8)
GBMR10 = np.array([3, 3, 2, 1, 6, 3, 3, 0, 5, 3, 3, 3, 3, 3, 9, 8, 7, 3, 4, 3],
                  np.int8)
DAYHOFF6 = np.array([0, 4, 2, 2, 1, 2, 2, 0, 4, 5, 5, 4, 5, 3, 0, 0, 0, 3, 3, 5],
                    np.int8)
HSDM4 = np.array([2, 2, 2, 2, 1, 2, 2, 2, 3, 0, 0, 2, 0, 0, 2, 2, 2, 0, 0, 0],
                 np.int8)
AABET20 = np.arange(20, dtype=np.int8)

# 8-group reduction used only by the KLSH protein pre-clustering
# (pcluster util.hpp:101-105: REDUCEDAAINDEX) — distinct from murphy10.
PCLUSTER8 = np.array([2, 5, 2, 2, 3, 2, 2, 0, 5, 6, 6, 5, 6, 7, 1, 2, 2, 7, 7, 6],
                     np.int8)

#: representative residue strings, for display parity (aa.hpp:*r)
REPRESENTATIVES = {
    "murphy10": "AKECGHIFPS",
    "murphy9": "AKCGHIFPS",
    "murphy5": "LAFEK",
    "gbmr10": "GDNAYHCTSP",
    "dayhoff6": "ACDFHI",
    "hsdm4": "LCDH",
    "aabet20": "ARNDCQEGHILKMFPSTWYV",
}

ALPHABETS = {
    "murphy10": MURPHY10,
    "murphy9": MURPHY9,
    "murphy5": MURPHY5,
    "gbmr10": GBMR10,
    "dayhoff6": DAYHOFF6,
    "hsdm4": HSDM4,
    "aabet20": AABET20,
    "pcluster8": PCLUSTER8,
}

#: number of groups per alphabet
SIZES = {k: int(v.max()) + 1 for k, v in ALPHABETS.items()}

#: sentinel group for unknown residues (reference m_uMask=10 for murphy10,
#: hash_search.cpp:29)
MASK_GROUP = {k: int(v.max()) + 1 for k, v in ALPHABETS.items()}


def reduce_seq(aa_idx: np.ndarray, alphabet: str = "murphy10") -> np.ndarray:
    """(…,) AA indices (0..19; >=20 unknown) -> group ids, unknown -> mask."""
    table = ALPHABETS[alphabet]
    mask = MASK_GROUP[alphabet]
    out = np.where(aa_idx < 20, table[np.minimum(aa_idx, 19)], mask)
    return out.astype(np.int8)
