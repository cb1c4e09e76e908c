"""The port's OpenMP C++ host library (counterpart of
hsearch_tpu/native_ext.py).

``csrc/hostops.cpp`` holds the irregular host passes of the aligner and the
clustering: FASTA parsing, the suffix array, union-find, the banded gapped
traceback, the reference's brute-force scan, and the seed-index and probe
passes (seed codes, stable radix argsorts, searchsorted, the sorted-range
probe, the fused pair preparation), and the IVF search's d² of its hits.
It is host code, parallel over the CPU cores with OpenMP where a pass
gains from it.

The source is compiled by ``g++`` (or ``$CXX``) with ``-fopenmp`` at first
use into ``_build/`` beside the package, then linked against the OpenMP
runtime (``libgomp.so.1``) at the path the compiler reports: a compiler
whose installation lacks OpenMP's link spec still builds it.  The file
name carries a hash of the source and flags, so an edited source
rebuilds, and each build writes temporary files of its own and renames
the library, so processes building at once do not collide.
``HSEARCH_THREADS``, when set, pins the library's OpenMP pool as it
loads.

There is no fallback: a failed build raises ``RuntimeError`` with the
compiler's name and log.  The numpy twins (``align/hostops.py``,
``core/dataprep.suffix_array``, ``cluster/union_find.UnionFind``,
``core/embedding.hit_sq_distance_np``) are the plain versions that the
tests hold each binding bitwise equal to.

``calls`` on each binding counts its calls into the library, so a run can
show that it went through it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG / "csrc" / "hostops.cpp"
_BUILD = _PKG / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-fopenmp")

_lib = None


def compiler() -> str:
    """The C++ compiler the library is built with: ``$CXX``, else g++."""
    return os.environ.get("CXX") or "g++"


def lib_path() -> Path:
    """Where the library for this source and these flags is built."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return _BUILD / f"hostops-{digest}.so"


def build() -> Path:
    """Compile the library (reused when already built) and return its
    path; raises RuntimeError when the compiler is missing or fails."""
    path = lib_path()
    if path.exists():
        return path
    cxx = compiler()
    exe = shutil.which(cxx)
    if exe is None:
        raise RuntimeError(f"C++ compiler {cxx!r} not found: the host "
                           f"library {SOURCE.name} is built with g++ "
                           "-fopenmp (set CXX or PATH)")
    path.parent.mkdir(parents=True, exist_ok=True)
    obj = path.with_suffix(f".{os.getpid()}.o")
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    gomp = subprocess.run([exe, "-print-file-name=libgomp.so.1"],
                          capture_output=True, text=True).stdout.strip()
    steps = ([exe, *CXX_FLAGS, "-c", "-o", str(obj), str(SOURCE)],
             [exe, "-shared", "-o", str(tmp), str(obj),
              gomp if os.path.isabs(gomp) else "-lgomp"])
    try:
        for cmd in steps:
            proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"{cxx} failed to build {SOURCE.name} "
                                   f"({' '.join(cmd)}):\n{proc.stdout}")
        os.replace(tmp, path)
    finally:
        obj.unlink(missing_ok=True)
        tmp.unlink(missing_ok=True)
    return path


def _ptr(dtype):
    return np.ctypeslib.ndpointer(dtype, flags="C_CONTIGUOUS")


_I64 = ctypes.c_int64
_SIGNATURES = {
    "hs_set_threads": (_I64, [_I64]),
    "hs_parse_fasta": (_I64, [ctypes.c_char_p, _I64, _ptr(np.uint8),
                              _ptr(np.int64), _ptr(np.int64),
                              _ptr(np.int64), _I64]),
    "hs_suffix_array": (None, [_ptr(np.int32), _I64, _ptr(np.int64)]),
    "hs_union_find": (None, [_I64, _ptr(np.int64), _ptr(np.int64), _I64,
                             _ptr(np.int64)]),
    "hs_brute_search": (_I64, [_ptr(np.int32), _I64, _ptr(np.int32), _I64,
                               _I64, _ptr(np.float64), ctypes.c_double,
                               _ptr(np.int64), _ptr(np.int64),
                               _ptr(np.float64), _I64]),
    "hs_align_gapped": (_I64, [_ptr(np.int32), _I64, _ptr(np.int32), _I64,
                               _ptr(np.int32), ctypes.c_int32,
                               ctypes.c_int32, ctypes.c_int32, _I64,
                               _ptr(np.uint8), _I64,
                               ctypes.POINTER(ctypes.c_int32),
                               ctypes.POINTER(_I64),
                               ctypes.POINTER(_I64)]),
    "hs_seed_codes": (None, [_ptr(np.int32), _I64, _ptr(np.int64), _I64,
                             _ptr(np.int32), _ptr(np.uint32),
                             _ptr(np.uint8), _ptr(np.uint8), _ptr(np.int32),
                             _ptr(np.int8)]),
    "hs_argsort_u64": (None, [_ptr(np.uint64), _I64, _ptr(np.int64)]),
    "hs_argsort_u32": (None, [_ptr(np.uint32), _I64, _ptr(np.int32)]),
    "hs_searchsorted_right": (None, [_ptr(np.int64), _I64, _ptr(np.int64),
                                     _I64, _ptr(np.int64)]),
    "hs_probe_count": (_I64, [_ptr(np.uint64), _ptr(np.int64), _I64,
                              _ptr(np.uint64), _I64, _ptr(np.int8),
                              _ptr(np.int32), _I64, _ptr(np.int64),
                              _ptr(np.int32), _ptr(np.int32)]),
    "hs_probe_fill": (None, [_ptr(np.int64), _ptr(np.int64), _ptr(np.int32),
                             _ptr(np.int64), _I64, _ptr(np.int8),
                             _ptr(np.int32), _ptr(np.int64),
                             _ptr(np.int64)]),
    "hs_pair_prep": (_I64, [_ptr(np.int64), _ptr(np.int64), _I64,
                            _ptr(np.int64), _ptr(np.int64), _I64,
                            _ptr(np.int64), _ptr(np.uint64), _I64, _I64,
                            _ptr(np.int32), _ptr(np.int32)]),
    "hs_hit_sq_distance": (_I64, [_ptr(np.int8), _I64, _ptr(np.int8), _I64,
                                  _I64, _ptr(np.int64), _ptr(np.int64), _I64,
                                  _ptr(np.float64), _ptr(np.float32)]),
}


def _load() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        env_threads = os.environ.get("HSEARCH_THREADS")
        if env_threads:
            lib.hs_set_threads(int(env_threads))
        _lib = lib
    return _lib


def available() -> bool:
    """Whether the library builds and loads here."""
    try:
        _load()
    except (RuntimeError, OSError):
        return False
    return True


def openmp_runtime() -> list[str]:
    """The OpenMP runtime libraries mapped into this process (from
    /proc/self/maps; empty where that file does not exist)."""
    try:
        with open("/proc/self/maps") as f:
            paths = {ln.split()[-1] for ln in f if len(ln.split()) >= 6}
    except OSError:
        return []
    return sorted(p for p in paths
                  if os.path.basename(p).startswith(("libgomp", "libiomp",
                                                     "libomp")))


# -- threads ----------------------------------------------------------------
def set_threads(n: int) -> int:
    """Pin this process's OpenMP pool to ``n`` threads (``n`` <= 0 leaves
    it as it is); returns the effective count.  N cooperating processes on
    one box must split the cores: unpinned pools fight."""
    return int(_load().hs_set_threads(int(n)))


def default_process_threads(nproc: int) -> int:
    """Even per-process core split for an nproc-process local cluster."""
    return max(1, (os.cpu_count() or 1) // max(nproc, 1))


def pin_threads(n: int) -> int:
    """``torch.set_num_threads(n)`` and ``set_threads(n)``: torch's host
    threads and the library's pool (one pool when both load the same
    OpenMP runtime); returns the library's effective count."""
    import torch
    torch.set_num_threads(int(n))
    return set_threads(n)


# -- FASTA ------------------------------------------------------------------
def parse_fasta_bytes(data: bytes):
    """bytes -> (names, seq uint8 AA indices with 20 for unknown
    alphabetic residues, starts int64): one pass; names end at the first
    space, tab or CR, and non-alphabetic residue bytes are dropped."""
    n = len(data)
    max_rec = data.count(b">") + 1
    seq = np.empty(n, np.uint8)
    starts = np.zeros(max_rec + 1, np.int64)
    noff = np.zeros(max_rec + 1, np.int64)
    nlen = np.zeros(max_rec + 1, np.int64)
    parse_fasta_bytes.calls += 1
    n_rec = _load().hs_parse_fasta(data, n, seq, starts, noff, nlen, max_rec)
    if n_rec < 0:
        raise ValueError("hs_parse_fasta: more records than '>' marks")
    names = [data[noff[i]:noff[i] + nlen[i]].decode()
             for i in range(n_rec)]
    return names, seq[:starts[n_rec]].copy(), starts[:n_rec + 1].copy()


parse_fasta_bytes.calls = 0


# -- suffix array -----------------------------------------------------------
def suffix_array(seq: np.ndarray) -> np.ndarray:
    """Suffix array of an int32 symbol sequence (int64 order)."""
    s = np.ascontiguousarray(seq, np.int32)
    out = np.empty(len(s), np.int64)
    suffix_array.calls += 1
    _load().hs_suffix_array(s, len(s), out)
    return out


suffix_array.calls = 0


# -- union find -------------------------------------------------------------
def union_find_labels(n: int, src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """(n,) label of each node: the smallest node of its component."""
    src = np.ascontiguousarray(src, np.int64)
    dst = np.ascontiguousarray(dst, np.int64)
    if src.shape != dst.shape or src.ndim != 1:
        raise ValueError(f"edge lists of shapes {src.shape} and {dst.shape}")
    if len(src) and (min(src.min(), dst.min()) < 0
                     or max(src.max(), dst.max()) >= n):
        raise ValueError(f"edge endpoint outside [0, {n})")
    out = np.empty(n, np.int64)
    union_find_labels.calls += 1
    _load().hs_union_find(n, src, dst, len(src), out)
    return out


union_find_labels.calls = 0


# -- reference-style brute force --------------------------------------------
def brute_search_cpp(centers: np.ndarray, kmers: np.ndarray, radius: float,
                     max_hits: int = 1 << 22):
    """Single-threaded brute force (motif_both_points_noLSH.cpp
    semantics): every (center, k-mer) pair within ``radius`` under the
    20-letter metric, as (ci, ki, dist), at most ``max_hits`` of them."""
    from .core import embedding
    centers = np.ascontiguousarray(centers, np.int32)
    kmers = np.ascontiguousarray(kmers, np.int32)
    c, l = centers.shape
    n = kmers.shape[0]
    if kmers.shape[1] != l:
        raise ValueError(f"centers of length {l}, k-mers of length "
                         f"{kmers.shape[1]}")
    for a in (centers, kmers):
        if a.size and (a.min() < 0 or a.max() >= 20):
            raise ValueError("residues must be AA indices 0..19")
    ci = np.empty(max_hits, np.int64)
    ki = np.empty(max_hits, np.int64)
    d2 = np.empty(max_hits, np.float64)
    dsq = np.ascontiguousarray(embedding.DISTANCE_SQUARE, np.float64)
    brute_search_cpp.calls += 1
    hits = _load().hs_brute_search(centers, c, kmers, n, l, dsq,
                                   float(radius) ** 2, ci, ki, d2, max_hits)
    hits = min(hits, max_hits)
    return ci[:hits].copy(), ki[:hits].copy(), np.sqrt(d2[:hits])


brute_search_cpp.calls = 0


# -- banded gapped alignment ------------------------------------------------
def align_gapped(q: np.ndarray, d: np.ndarray, sub21: np.ndarray,
                 gap_open: int = 11, gap_ext: int = 1, drop: int = 27,
                 band: int = 32):
    """Banded affine-gap alignment with traceback (the recurrence of
    ``hostops.align_gapped``).

    Returns (score, ops uint8 [0=M, 1=gap-in-d, 2=gap-in-q], q_extent,
    d_extent), or None for an empty sequence or a band below 1 (callers
    keep the ungapped alignment)."""
    q = np.ascontiguousarray(q, np.int32)
    d = np.ascontiguousarray(d, np.int32)
    sub = np.ascontiguousarray(sub21, np.int32)
    if sub.shape != (21, 21):
        raise ValueError(f"sub21 has shape {sub.shape}, expected (21, 21)")
    for a in (q, d):
        if a.size and (a.min() < 0 or a.max() > 20):
            raise ValueError("residues must be AA indices 0..20")
    cap = len(q) + len(d) + 2
    ops = np.empty(cap, np.uint8)
    score = ctypes.c_int32(0)
    e1 = ctypes.c_int64(0)
    e2 = ctypes.c_int64(0)
    align_gapped.calls += 1
    n_ops = _load().hs_align_gapped(q, len(q), d, len(d), sub, gap_open,
                                    gap_ext, drop, band, ops, cap,
                                    ctypes.byref(score), ctypes.byref(e1),
                                    ctypes.byref(e2))
    if n_ops < 0:
        return None
    return int(score.value), ops[:n_ops].copy(), int(e1.value), int(e2.value)


align_gapped.calls = 0


# -- seed-index host passes -------------------------------------------------
def seed_codes(seq: np.ndarray, starts: np.ndarray, group21: np.ndarray):
    """``hostops.seed_codes`` in one parallel pass: (code u32, valid6 bool,
    valid10 bool, qgrp10 i32, g10 i8) of every position of the
    concatenated sequences."""
    seq = np.ascontiguousarray(seq, np.int32)
    starts = np.ascontiguousarray(starts, np.int64)
    group21 = np.ascontiguousarray(group21, np.int32)
    s = len(seq)
    if group21.shape != (21,):
        raise ValueError(f"group21 has shape {group21.shape}")
    if len(starts) < 1 or starts[0] < 0 or starts[-1] > s \
            or (np.diff(starts) < 0).any():
        raise ValueError("starts must ascend within [0, len(seq)]")
    if s and seq.min() < 0:
        raise ValueError("negative residue index")
    code = np.empty(s, np.uint32)
    valid6 = np.empty(s, np.uint8)
    valid10 = np.empty(s, np.uint8)
    qgrp10 = np.empty(s, np.int32)
    g10 = np.empty(s, np.int8)
    seed_codes.calls += 1
    _load().hs_seed_codes(seq, s, starts, len(starts) - 1, group21, code,
                          valid6, valid10, qgrp10, g10)
    return code, valid6.astype(bool), valid10.astype(bool), qgrp10, g10


seed_codes.calls = 0


def searchsorted_right(a: np.ndarray, q: np.ndarray) -> np.ndarray:
    """np.searchsorted(a, q, side="right") over int64 (``a`` sorted), as a
    parallel binary search."""
    a = np.ascontiguousarray(a, np.int64)
    q = np.ascontiguousarray(q, np.int64)
    out = np.empty(len(q), np.int64)
    searchsorted_right.calls += 1
    _load().hs_searchsorted_right(a, len(a), q, len(q), out)
    return out


searchsorted_right.calls = 0


def argsort_u64(keys: np.ndarray) -> np.ndarray:
    """Stable argsort of uint64 keys (int64 order): parallel LSD radix."""
    keys = np.ascontiguousarray(keys, np.uint64)
    order = np.empty(len(keys), np.int64)
    argsort_u64.calls += 1
    _load().hs_argsort_u64(keys, len(keys), order)
    return order


argsort_u64.calls = 0


def argsort_u32(keys: np.ndarray) -> np.ndarray:
    """Stable argsort of uint32 keys -> int32 order (n < 2^31): half the
    temporaries of ``argsort_u64``."""
    keys = np.ascontiguousarray(keys, np.uint32)
    if len(keys) >= (1 << 31):
        raise ValueError("argsort_u32 requires n < 2^31")
    order = np.empty(len(keys), np.int32)
    argsort_u32.calls += 1
    _load().hs_argsort_u32(keys, len(keys), order)
    return order


argsort_u32.calls = 0


def pair_prep(rows: np.ndarray, dpos: np.ndarray, qidx: np.ndarray,
              starts: np.ndarray, gids: np.ndarray,
              exclude: np.ndarray | None, tol: int):
    """``hostops.pair_prep`` in one parallel pass: (six (6, n) int32
    [qpos, dpos, qlo, qhi, dlo, dhi], pids (2, n) int32 [qpid, dpid]),
    survivors in ascending pair order.  ``exclude``: sorted uint64
    ``(gid_query << 32) | gid_subject`` keys, or None."""
    rows = np.ascontiguousarray(rows, np.int64)
    dpos = np.ascontiguousarray(dpos, np.int64)
    qidx = np.ascontiguousarray(qidx, np.int64)
    starts = np.ascontiguousarray(starts, np.int64)
    gids = np.ascontiguousarray(gids, np.int64)
    excl = np.zeros(0, np.uint64) if exclude is None \
        else np.ascontiguousarray(exclude, np.uint64)
    if rows.shape != dpos.shape or len(gids) != len(starts) - 1:
        raise ValueError("pair_prep: rows/dpos or gids/starts lengths "
                         "differ")
    n = len(rows)
    six = np.empty((6, n), np.int32)
    pids = np.empty((2, n), np.int32)
    pair_prep.calls += 1
    kept = _load().hs_pair_prep(rows, dpos, n, qidx, starts, len(starts) - 1,
                                gids, excl, len(excl), int(tol), six, pids)
    return six[:, :kept], pids[:, :kept]


pair_prep.calls = 0


def probe_sorted(keys: np.ndarray, positions: np.ndarray,
                 qkeys: np.ndarray, g10_at: np.ndarray,
                 qgrp10: np.ndarray, cand_max: int):
    """``hostops.probe_sorted`` as two parallel passes (count, then fill at
    prefix-summed offsets): (rows i64, dpos i64, n_over), pairs in
    (row, bucket) order."""
    keys = np.ascontiguousarray(keys, np.uint64)
    positions = np.ascontiguousarray(positions, np.int64)
    qkeys = np.ascontiguousarray(qkeys, np.uint64)
    g10_at = np.ascontiguousarray(g10_at, np.int8)
    qgrp10 = np.ascontiguousarray(qgrp10, np.int32)
    if keys.shape != positions.shape or qkeys.shape != qgrp10.shape:
        raise ValueError("probe_sorted: keys/positions or qkeys/qgrp10 "
                         "lengths differ")
    lib = _load()
    nq = len(qkeys)
    lo = np.empty(nq, np.int64)
    cap = np.empty(nq, np.int32)
    keep = np.empty(nq, np.int32)
    probe_sorted.calls += 1
    n_over = lib.hs_probe_count(keys, positions, len(keys), qkeys, nq,
                                g10_at, qgrp10, cand_max, lo, cap, keep)
    offs = np.zeros(nq, np.int64)
    np.cumsum(keep[:-1], out=offs[1:] if nq else offs[:0])
    total = int(offs[-1] + keep[-1]) if nq else 0
    rows = np.empty(total, np.int64)
    dpos = np.empty(total, np.int64)
    lib.hs_probe_fill(positions, lo, cap, offs, nq, g10_at, qgrp10, rows,
                      dpos)
    return rows, dpos, int(n_over)


probe_sorted.calls = 0


# -- IVF hit distances ------------------------------------------------------
def hit_sq_distance(centers: np.ndarray, hc: np.ndarray, kmers: np.ndarray,
                    hk: np.ndarray) -> np.ndarray:
    """(h,) float32 squared distance of each hit, center row ``hc[i]`` of
    (C, L) ``centers`` against k-mer row ``hk[i]`` of (N, L) ``kmers``, in
    one prefetching pass (split over the OpenMP pool from 16,384 hits
    on): bitwise ``embedding.hit_sq_distance_np``.

    ``kmers`` is read in place and must be C-contiguous int8 (an index's
    ``host_kmers``; a copy of the table would cost more than the pass);
    raises ValueError otherwise, or for an index or residue out of
    range."""
    from .core import embedding
    if not (isinstance(kmers, np.ndarray) and kmers.dtype == np.int8
            and kmers.ndim == 2 and kmers.flags.c_contiguous):
        raise ValueError(
            "hit_sq_distance reads kmers in place: it must be a C-contiguous "
            f"int8 (N, L) array, not {getattr(kmers, 'dtype', type(kmers))} "
            f"of shape {getattr(kmers, 'shape', None)}")
    centers = np.asarray(centers)
    if centers.ndim != 2 or centers.shape[1] != kmers.shape[1]:
        raise ValueError(f"centers of shape {centers.shape}, k-mers of "
                         f"length {kmers.shape[1]}")
    if centers.dtype != np.int8 and centers.size and (
            centers.min() < 0 or centers.max() >= 20):
        raise ValueError("residues must be AA indices 0..19")
    centers = np.ascontiguousarray(centers, np.int8)
    hc = np.ascontiguousarray(hc, np.int64)
    hk = np.ascontiguousarray(hk, np.int64)
    if hc.shape != hk.shape or hc.ndim != 1:
        raise ValueError(f"hit lists of shapes {hc.shape} and {hk.shape}")
    out = np.empty(len(hc), np.float32)
    hit_sq_distance.calls += 1
    bad = _load().hs_hit_sq_distance(
        centers, centers.shape[0], kmers, kmers.shape[0], kmers.shape[1], hc,
        hk, len(hc), np.ascontiguousarray(embedding.DISTANCE_SQUARE,
                                          np.float64), out)
    if bad:
        raise ValueError(f"{bad} hits index a row outside the centers or "
                         "the k-mers, or a residue outside 0..19")
    return out


hit_sq_distance.calls = 0

BINDINGS = {fn.__name__: fn for fn in (
    parse_fasta_bytes, suffix_array, union_find_labels, brute_search_cpp,
    align_gapped, seed_codes, searchsorted_right, argsort_u64, argsort_u32,
    pair_prep, probe_sorted, hit_sq_distance)}


def reset_calls() -> None:
    """Set every binding's call count to 0."""
    for fn in BINDINGS.values():
        fn.calls = 0


def call_counts() -> dict[str, int]:
    return {name: fn.calls for name, fn in BINDINGS.items()}
