"""Pfam STOCKHOLM parsing and motif-center extraction (own copy of
hsearch_tpu/core/stockholm.py).

This is how query "centers" (ground-truth motif seeds) are produced in the
reference pipeline: parse Pfam full alignments, strip insert states
('.' and lowercase columns) from each aligned sequence, and take the leading
ungapped length-LEN fragment per sequence, deduplicated across entries
(IGC/shuffle_data/Pfam/STOCKHOLM.cpp:45-98 ``ReadPfam``;
STOCKHOLM.h:113-149 ``Output_LEN``; all-positions variant
STOCKHOLM.h:151-199 ``Output_LEN_all_kemrs``).
"""

from __future__ import annotations

import dataclasses
import re


@dataclasses.dataclass
class PfamEntry:
    id: str = ""
    ac: str = ""
    de: str = ""
    tp: str = ""
    sq: int = 0
    # seqname -> (start, stop, aligned string)
    sequences: dict = dataclasses.field(default_factory=dict)


_SEQLINE = re.compile(r"^(\S+)/(\d+)-(\d+)\s+(\S+)$")


def parse_stockholm(path_or_file):
    """Yield PfamEntry objects from a (possibly multi-entry) STOCKHOLM file."""
    close = False
    if isinstance(path_or_file, (str, bytes)):
        f = open(path_or_file, "r")
        close = True
    else:
        f = path_or_file
    entry = PfamEntry()
    try:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith("# STOCKHOLM"):
                entry = PfamEntry()
            elif line.startswith("#=GF ID"):
                entry.id = line.split(None, 2)[2]
            elif line.startswith("#=GF AC"):
                entry.ac = line.split(None, 2)[2]
            elif line.startswith("#=GF DE"):
                entry.de = line.split(None, 2)[2]
            elif line.startswith("#=GF TP"):
                entry.tp = line.split(None, 2)[2]
            elif line.startswith("#=GF SQ"):
                entry.sq = int(line.split(None, 2)[2])
            elif line == "//":
                yield entry
                entry = PfamEntry()
            elif line and not line.startswith("#"):
                m = _SEQLINE.match(line)
                if m:
                    name, start, stop, aln = m.groups()
                    key = f"{name}/{start}-{stop}"
                    prev = entry.sequences.get(key)
                    if prev is not None:  # interleaved blocks concatenate
                        aln = prev[2] + aln
                    entry.sequences[key] = (int(start), int(stop), aln)
    finally:
        if close:
            f.close()


def strip_inserts(aligned: str) -> str:
    """Drop '.' and lowercase (insert-state) columns (STOCKHOLM.h:99-105)."""
    return "".join(c for c in aligned if c != "." and not c.islower())


def entry_motif_seeds(entry: PfamEntry, length: int,
                      seen: set[str] | None = None) -> list[str]:
    """Leading ungapped length-``length`` fragments of each sequence.

    Exactly Output_LEN (STOCKHOLM.h:113-149): keep the first ``length``
    match-state letters if no '-' appears among them; dedup via ``seen``.
    """
    motifs = []
    for _, (_, _, aln) in sorted(entry.sequences.items()):
        cur = strip_inserts(aln)[:length]
        if len(cur) != length or "-" in cur:
            continue
        if seen is not None:
            if cur in seen:
                continue
            seen.add(cur)
        motifs.append(cur)
    return motifs


def entry_all_position_seeds(entry: PfamEntry, length: int,
                             positions=None) -> dict[int, list[str]]:
    """Per-alignment-column motif groups (Output_LEN_all_kemrs,
    STOCKHOLM.h:151-199, minus that function's rand()%2 column sampling —
    pass ``positions`` to subsample deterministically)."""
    if not entry.sequences:
        return {}
    any_aln = next(iter(entry.sequences.values()))[2]
    cols = range(len(any_aln)) if positions is None else positions
    out: dict[int, list[str]] = {}
    for p in cols:
        motifs = []
        for _, (_, _, aln) in sorted(entry.sequences.items()):
            cur = ""
            for c in aln[p:]:
                if c == "." or c.islower():
                    continue
                cur += c
                if len(cur) >= length:
                    break
            if len(cur) == length and "-" not in cur:
                motifs.append(cur)
        if motifs:
            out[p] = motifs
    return out


def extract_centers(path_or_file, length: int,
                    sample_every: int = 1) -> list[tuple[str, str]]:
    """(label, motif) center list from a Pfam file.

    ``sample_every=10`` reproduces the reference program's 1-in-10 entry
    sampling (STOCKHOLM.cpp:127-142) deterministically (every 10th entry
    instead of rand()).  Labels are ``ID:<id>#AC:<ac>#<i>``.
    """
    seen: set[str] = set()
    out = []
    for i, entry in enumerate(parse_stockholm(path_or_file)):
        if i % sample_every:
            continue
        for j, m in enumerate(entry_motif_seeds(entry, length, seen)):
            out.append((f"ID:{entry.id}#AC:{entry.ac}#{j}", m))
    return out
