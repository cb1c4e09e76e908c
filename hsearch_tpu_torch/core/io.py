"""Text-format IO at the pipeline boundary (own copy of
hsearch_tpu/core/io.py).

  * FASTA protein databases, whole or streamed in chunks of whole
    proteins.  ``read_fasta`` of a path with the default options parses
    in the C++ host library (``native_ext.parse_fasta_bytes``), as the
    JAX package does; other options, open files and ``stream_fasta`` take
    the pure-Python parser.  Both apply the seeded position-keyed
    replacement of unknown residues, so the chunks of ``stream_fasta``
    concatenate to ``read_fasta``'s database.
  * "data points" files: a header line ``name#proteinIdx$offset@KMER*count``
    followed by one line of 8L floats.
  * hit "triples": ``center kmer distance`` per line.
  * cluster files: ``#clusterid:<i>:size<n>`` or ``#cluster<i>`` headers,
    one member per line.
"""

from __future__ import annotations

import dataclasses
import io as _io
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

    @property
    def lengths(self) -> np.ndarray:
        return np.diff(self.starts)

    def protein(self, i: int) -> np.ndarray:
        return self.seq[self.starts[i]:self.starts[i + 1]]


def _open(path_or_file, mode: str):
    """(file, close?) for a path or an already open file."""
    if isinstance(path_or_file, (str, bytes)):
        return open(path_or_file, mode), True
    return path_or_file, False


def _records(f, name_upto_space: bool, drop_non_alpha: bool):
    """(name, uint8 AA indices) of each FASTA record in order; text before
    the first '>' is not sequence."""
    name, cur = None, []

    def seq():
        raw = b"".join(cur)
        if drop_non_alpha:
            raw = bytes(c for c in raw if (65 <= (c & ~32) <= 90))
        return alphabet.encode(raw)

    for line in f:
        line = line.strip()
        if not line:
            continue
        if line.startswith(">"):
            if name is not None:
                yield name, seq()
            name = line[1:]
            if name_upto_space:
                name = name.split(" ", 1)[0]
            cur = []
        elif name is not None:
            cur.append(line.encode())
    if name is not None:
        yield name, seq()


def _db(names: list[str], seqs: list[np.ndarray], seed: int | None,
        offset: int = 0) -> ProteinDB:
    seq = np.concatenate(seqs) if seqs else np.empty(0, np.uint8)
    if seed is not None:
        seq = alphabet.randomize_unknown_at(seq, seed, offset)
    starts = np.zeros(len(seqs) + 1, np.int64)
    np.cumsum([len(x) for x in seqs], out=starts[1:])
    return ProteinDB(names=names, seq=seq, starts=starts)


def read_fasta(path_or_file, *, seed: int | None = 0,
               name_upto_space: bool = True,
               drop_non_alpha: bool = True) -> ProteinDB:
    """Read a FASTA file into a ProteinDB.

    seed=None keeps INVALID residues; otherwise unknown alphabetic
    residues are replaced by ``alphabet.randomize_unknown_at`` (keyed by
    seed and position).
    """
    if isinstance(path_or_file, (str, bytes)) and name_upto_space \
            and drop_non_alpha:
        from .. import native_ext
        with open(path_or_file, "rb") as fh:
            names, seq, starts = native_ext.parse_fasta_bytes(fh.read())
        # the library emits 20 for unknown alphabetics; fold to INVALID so
        # both parsers randomize (or keep) identically
        seq = np.where(seq == 20, np.uint8(alphabet.INVALID), seq)
        if seed is not None:
            seq = alphabet.randomize_unknown_at(seq, seed)
        return ProteinDB(names=names, seq=seq, starts=starts)
    f, close = _open(path_or_file, "r")
    try:
        recs = list(_records(f, name_upto_space, drop_non_alpha))
    finally:
        if close:
            f.close()
    return _db([n for n, _ in recs], [s for _, s in recs], seed)


def stream_fasta(path_or_file, *, chunk_aa: int = 1 << 24,
                 seed: int | None = 0, name_upto_space: bool = True,
                 drop_non_alpha: bool = True):
    """Yield ProteinDB chunks of >= ``chunk_aa`` residues (whole proteins;
    a protein longer than ``chunk_aa`` is a chunk of its own).

    Unknown-residue replacement is keyed by each residue's global
    position, so the chunks concatenate to ``read_fasta``'s database with
    the same seed, while host memory holds one chunk.
    """
    f, close = _open(path_or_file, "r")
    names: list[str] = []
    seqs: list[np.ndarray] = []
    total = offset = 0
    try:
        for name, idx in _records(f, name_upto_space, drop_non_alpha):
            if total >= chunk_aa:
                yield _db(names, seqs, seed, offset)
                offset += total
                names, seqs, total = [], [], 0
            names.append(name)
            seqs.append(idx)
            total += len(idx)
        if names:
            yield _db(names, seqs, seed, offset)
    finally:
        if close:
            f.close()


def write_fasta(path_or_file, names, seqs) -> None:
    """``>name`` / sequence lines; index arrays are decoded."""
    f, close = _open(path_or_file, "w")
    try:
        for name, s in zip(names, seqs):
            if isinstance(s, np.ndarray):
                s = alphabet.decode(s)
            f.write(f">{name}\n{s}\n")
    finally:
        if close:
            f.close()


_DP_HEADER = re.compile(r"^(?P<name>.*)#(?P<pid>\d+)\$(?P<off>\d+)@"
                        r"(?P<kmer>[A-Z]+)\*(?P<cnt>\d+)$")


def datapoint_header(name: str, protein_idx: int, offset: int,
                     kmer: str, count: int) -> str:
    """``name#proteinIdx$offset@kmer*count`` (protein2datapoints.cpp:64)."""
    return f"{name}#{protein_idx}${offset}@{kmer}*{count}"


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


def write_datapoints(path_or_file, names, points, fmt: str = "%g") -> None:
    """Alternating header and values lines (Point::Output,
    protein2datapoints.cpp:23-29)."""
    f, close = _open(path_or_file, "w")
    try:
        for name, row in zip(names, points):
            f.write(name + "\n")
            f.write(" ".join(fmt % v for v in np.asarray(row)) + "\n")
    finally:
        if close:
            f.close()


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


def write_clusters(path_or_file, clusters: list[list[str]],
                   style: str = "hclust2") -> None:
    """Cluster membership blocks.

    style='hclust2': ``#clusterid:<i>:size<n>`` headers (hclust2.cpp:142);
    style='hclust':  ``#cluster<i>`` headers (hclust.cpp:304).
    """
    f, close = _open(path_or_file, "w")
    try:
        for i, members in enumerate(clusters):
            if style == "hclust2":
                f.write(f"#clusterid:{i}:size{len(members)}\n")
            else:
                f.write(f"#cluster{i}\n")
            for m in members:
                f.write(m + "\n")
    finally:
        if close:
            f.close()


def read_clusters(path_or_file) -> list[list[str]]:
    """Member lists of a cluster file written by ``write_clusters``."""
    f, close = _open(path_or_file, "r")
    clusters: list[list[str]] = []
    try:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            if line.startswith("#cluster"):
                clusters.append([])
            elif clusters:
                clusters[-1].append(line)
    finally:
        if close:
            f.close()
    return clusters


def from_strings(text: str):
    """Wrap a string as a file-like object for the readers above."""
    return _io.StringIO(text)
