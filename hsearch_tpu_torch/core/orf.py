"""Six-frame ORF translation of DNA to peptides (own copy of
hsearch_tpu/core/orf.py).

Behavioral equivalent of the reference translator (orf/orf.cc:39-74):
translate the 3 forward and 3 reverse-complement frames, cut each frame at
the first stop codon, and keep peptides of length >= min_len (default 6).
The reference's tool was not buildable (missing headers, orf.h:4); this is a
working re-implementation with the same codon table (orf/orf.h:28-31).
"""

from __future__ import annotations

import numpy as np

# NCBI standard genetic code, codon order T/C/A/G nested (orf.h:28-31).
_BASES = "TCAG"
_AAS = "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"

CODON_TABLE: dict[str, str] = {}
for _i in range(64):
    _codon = _BASES[_i // 16] + _BASES[(_i // 4) % 4] + _BASES[_i % 4]
    CODON_TABLE[_codon] = _AAS[_i]

_COMPLEMENT = str.maketrans("ACGTacgt", "TGCAtgca")


def reverse_complement(dna: str) -> str:
    return dna.translate(_COMPLEMENT)[::-1]


def translate_frame(dna: str, start: int) -> str:
    """Translate one frame, stopping at the first stop codon (orf.cc:45-53)."""
    out = []
    for i in range(start, len(dna) - 2, 3):
        aa = CODON_TABLE.get(dna[i:i + 3].upper(), "X")
        if aa == "*":
            break
        out.append(aa)
    return "".join(out)


def orf6(dna: str, min_len: int = 6) -> list[str]:
    """All 6-frame translations with length >= min_len (orf.cc:39-74)."""
    peptides = []
    for strand in (dna, reverse_complement(dna)):
        for s in range(3):
            aa = translate_frame(strand, s)
            if len(aa) >= min_len:
                peptides.append(aa)
    return peptides


def translate_fasta(names, dnas, min_len: int = 6):
    """(names, dna seqs) -> (peptide names, peptide seqs), one entry per
    surviving frame, named ``<name>_frame<j>``."""
    out_names, out_seqs = [], []
    for name, dna in zip(names, dnas):
        for j, pep in enumerate(orf6(dna, min_len)):
            out_names.append(f"{name}_frame{j}")
            out_seqs.append(pep)
    return out_names, out_seqs


def codon_usage(dna: str) -> np.ndarray:
    """64-bin codon histogram of frame 0 (utility for corpus stats)."""
    counts = np.zeros(64, dtype=np.int64)
    lut = {b: i for i, b in enumerate(_BASES)}
    for i in range(0, len(dna) - 2, 3):
        try:
            idx = (lut[dna[i].upper()] * 16 + lut[dna[i + 1].upper()] * 4
                   + lut[dna[i + 2].upper()])
        except KeyError:
            continue
        counts[idx] += 1
    return counts
