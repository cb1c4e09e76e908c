"""Text-format IO at the pipeline boundary (own copy of the parts of
hsearch_tpu/core/io.py that motif search needs).

  * FASTA protein databases (pure-Python parser; it gives the same
    ``ProteinDB`` as the JAX package's native parser, including the
    seeded position-keyed replacement of unknown residues).
  * "data points" files: a header line ``name#proteinIdx$offset@KMER*count``
    followed by one line of 8L floats.
  * hit "triples": ``center kmer distance`` per line.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np

from . import alphabet


@dataclasses.dataclass
class ProteinDB:
    """A FASTA database as concatenated index arrays."""

    names: list[str]
    seq: np.ndarray           # concatenated uint8 AA indices
    starts: np.ndarray        # (P+1,) int64 offsets into seq

    @property
    def num_proteins(self) -> int:
        return len(self.names)

    def protein(self, i: int) -> np.ndarray:
        return self.seq[self.starts[i]:self.starts[i + 1]]


def _open(path_or_file, mode: str):
    """(file, close?) for a path or an already open file."""
    if isinstance(path_or_file, (str, bytes)):
        return open(path_or_file, mode), True
    return path_or_file, False


def read_fasta(path_or_file, *, seed: int | None = 0,
               name_upto_space: bool = True,
               drop_non_alpha: bool = True) -> ProteinDB:
    """Read a FASTA file into a ProteinDB.

    seed=None keeps INVALID residues; otherwise unknown alphabetic
    residues are replaced by ``alphabet.randomize_unknown_at`` (keyed by
    seed and position).
    """
    f, close = _open(path_or_file, "r")
    names: list[str] = []
    chunks: list[np.ndarray] = []
    starts = [0]
    cur: list[bytes] = []
    total = 0

    def _flush():
        nonlocal total
        if not names:
            cur.clear()      # text before the first '>' is not sequence
            return
        raw = b"".join(cur)
        if drop_non_alpha:
            raw = bytes(c for c in raw if (65 <= (c & ~32) <= 90))
        idx = alphabet.encode(raw)
        chunks.append(idx)
        total += len(idx)
        starts.append(total)
        cur.clear()

    try:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                _flush()
                name = line[1:]
                if name_upto_space:
                    name = name.split(" ", 1)[0]
                names.append(name)
            else:
                cur.append(line.encode())
        _flush()
    finally:
        if close:
            f.close()

    seq = np.concatenate(chunks) if chunks else np.empty(0, np.uint8)
    if seed is not None:
        seq = alphabet.randomize_unknown_at(seq, seed)
    return ProteinDB(names=names, seq=seq,
                     starts=np.asarray(starts, dtype=np.int64))


_DP_HEADER = re.compile(r"^(?P<name>.*)#(?P<pid>\d+)\$(?P<off>\d+)@"
                        r"(?P<kmer>[A-Z]+)\*(?P<cnt>\d+)$")


def parse_datapoint_header(header: str):
    """Parse a datapoints header; returns dict or None if free-form."""
    m = _DP_HEADER.match(header)
    if not m:
        return None
    return {"name": m["name"], "protein_idx": int(m["pid"]),
            "offset": int(m["off"]), "kmer": m["kmer"],
            "count": int(m["cnt"])}


def read_datapoints(path_or_file, dim: int):
    """Read (names, points) from a data-points file: alternate header line
    and line of ``dim`` whitespace-separated floats."""
    f, close = _open(path_or_file, "r")
    names: list[str] = []
    rows: list[np.ndarray] = []
    try:
        while True:
            header = f.readline()
            if not header:
                break
            header = header.rstrip("\n")
            if not header:
                continue
            values = f.readline()
            row = np.array(values.split(), dtype=np.float64)
            if row.shape[0] < dim:
                raise ValueError(
                    f"point line has {row.shape[0]} values, expected {dim}")
            names.append(header)
            rows.append(row[:dim])
    finally:
        if close:
            f.close()
    pts = np.stack(rows) if rows else np.empty((0, dim), np.float64)
    return names, pts


def write_triples(path_or_file, triples) -> None:
    """``center kmer distance`` lines."""
    f, close = _open(path_or_file, "w")
    try:
        for center, kmer, dis in triples:
            f.write(f"{center} {kmer} {dis:g}\n")
    finally:
        if close:
            f.close()


def read_triples(path_or_file):
    f, close = _open(path_or_file, "r")
    out = []
    try:
        for line in f:
            parts = line.split()
            if len(parts) != 3:
                continue
            out.append((parts[0], parts[1], float(parts[2])))
    finally:
        if close:
            f.close()
    return out
