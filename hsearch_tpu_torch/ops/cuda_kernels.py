"""Hand-written CUDA kernels for the hot search ops (counterpart of
hsearch_tpu/ops/pallas_kernels.py) and for two device loops the JAX
package runs under ``jax.jit``.

  * ``sq_distance_prune`` (csrc/prune.cu): centers vs block centroids as
    a 3xTF32 tensor-core product, with the distance epilogue (norms,
    max(., 0), sqrt), the triangle-inequality liveness test, the cascade's
    per-group minimum and the alive count fused in.
  * ``ptable_verify`` (csrc/ptable_verify.cu): the exact P-table verify
    d2 = sum_l ptab[c, l, kmer_l] of the selected blocks, read from the
    block-sorted database by block id, with the radius test and the hit
    count fused in.
  * ``extend_pairs`` (csrc/extend_pairs.cu): the aligner's ungapped
    seed-extend, a warp per seed pair extending 32 residues per step
    (shuffle scans, ballots), bitwise the chunked form
    of align/extend.py (the JAX package's ``lax.while_loop`` phases) for
    any protein length, with no host round-trip.
  * ``block_bounds`` (csrc/block_bounds.cu): each index block's embedded
    centroid and covering radius in one pass over the block-sorted rows,
    tiles of consecutive blocks double-buffered into shared memory by
    ``cp.async`` (the JAX package's jitted bounds ``lax.scan`` of the IVF
    build and of the segmented engine's upload); the shared-memory layout
    is computed here (``bounds_layout``) and passed in.
  * ``banded_scores`` (csrc/banded_scores.cu): the ``--gapped``
    refinement's banded affine-gap row scan, one warp per window pair,
    bitwise align/gapped_device.py's ``banded_scores_plain`` (the JAX
    package's ``lax.scan`` over query rows).
  * ``elect`` (csrc/elect.cu): greedy k-mer clustering's first-fit
    leader election, one block per bucket row, bitwise
    cluster/greedy.py's ``_elect_plain`` (the JAX package's ``lax.scan``
    over bucket positions).

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, at first use, into ``_build/`` beside
the package; the file name carries a hash of the source and flags, so an
edited source rebuilds, and ptxas's report (``-Xptxas -v``: registers,
spills) is kept beside each library (``ptxas_report``).  The libraries
are loaded with ``ctypes`` and launch on PyTorch's current stream; the
launch geometry of the extension and bounds kernels is computed here
(``extend_launch_geometry``, ``bounds_launch_geometry``) and checked by
their C entries.

Each wrapper takes its plain PyTorch version when its tensors lie on the
CPU, and launches its kernel (or raises) when they lie on a CUDA device.
``launches`` on each wrapper counts the kernel launches, so a run can show
that it went through the kernels; a CUDA graph's replay adds the launches
its capture recorded (``count_launches``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from ..align import extend as _extend
from . import distance

_PKG = Path(__file__).resolve().parent.parent
_SRC = _PKG / "csrc"
_BUILD = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = {"sq_distance_prune": "prune.cu",
           "ptable_verify": "ptable_verify.cu",
           "extend_pairs": "extend_pairs.cu",
           "block_bounds": "block_bounds.cu",
           "banded_scores": "banded_scores.cu",
           "elect": "elect.cu"}
_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_longlong
_SIGNATURES = {
    "sq_distance_prune": ("hs_sq_distance_prune",
                          [_P, _P, _P, _P, _P, _F, _P, _P, _P, _I, _I, _I,
                           _I, _I, _P]),
    "ptable_verify": ("hs_ptable_verify",
                      [_P, _P, _P, _P, _P, _F, _I, _P, _P, _I, _I, _I, _I,
                       _P]),
    "extend_pairs": ("hs_extend_pairs",
                     [_P, _L, _P, _L, _P, _L, _P, _P, _I, _I, _P, _I, _I,
                      _I, _P]),
    "block_bounds": ("hs_block_bounds",
                     [_P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _P,
                      _P]),
    "banded_scores": ("hs_banded_scores",
                      [_P, _P, _P, _P, _I, _I, _P, _I, _I, _I, _I, _P, _P,
                       _P, _I, _P]),
    "elect": ("hs_elect", [_P, _P, _P, _F, _P, _I, _I, _P]),
}

# resident CUDA blocks per SM of a launch geometry (cudaOccupancy... in
# the kernel's C entry): (symbol, the geometry keys it takes)
_OCCUPANCY = {"extend_pairs": ("hs_extend_pairs_occupancy", ("threads",)),
              "block_bounds": ("hs_block_bounds_occupancy",
                               ("threads", "smem"))}

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc (set CUDA_HOME or PATH)")


def _lib_path(name: str) -> Path:
    src = (_SRC / SOURCES[name]).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()) \
        .hexdigest()[:16]
    return _BUILD / f"{Path(SOURCES[name]).stem}-{digest}.so"


def _log_path(name: str) -> Path:
    return _lib_path(name).with_suffix(".ptxas.txt")


def build(names=tuple(SOURCES)) -> dict[str, Path]:
    """Compile the named kernels (all nvcc processes started together) and
    return their library paths; libraries already built are reused."""
    _BUILD.mkdir(parents=True, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    procs = {}
    for n, p in todo.items():
        tmp = p.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_SRC / SOURCES[n])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp)
    failed = []
    for n, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{SOURCES[n]}:\n{log}")
        else:
            log_tmp = tmp.with_suffix(".txt")
            log_tmp.write_text(log)
            os.replace(log_tmp, _log_path(n))
            os.replace(tmp, todo[n])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def _lib(name: str) -> ctypes.CDLL:
    lib = _loaded.get(name)
    if lib is None:
        path = build((name,))[name]
        lib = ctypes.CDLL(str(path))
        sym, argtypes = _SIGNATURES[name]
        fn = getattr(lib, sym)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        if name in _OCCUPANCY:
            sym_o, keys = _OCCUPANCY[name]
            occ = getattr(lib, sym_o)
            occ.argtypes = [_I] * len(keys) + [ctypes.POINTER(ctypes.c_int)]
            occ.restype = ctypes.c_int
        _loaded[name] = lib
    return lib


_PTXAS_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_PTXAS_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")


def ptxas_report(name: str) -> list[dict]:
    """Each entry function of the named kernel's library as ptxas
    reported it when the library was built (``-Xptxas -v``): its (mangled)
    name, registers per thread, stack frame and spill bytes.  Builds the
    library if needed."""
    build((name,))
    out: list[dict] = []
    for line in _log_path(name).read_text().splitlines():
        m = _PTXAS_ENTRY.search(line)
        if m:
            out.append({"function": m.group(1)})
            continue
        m = _PTXAS_FRAME.search(line)
        if out and m and "stack_bytes" not in out[-1]:
            out[-1].update(stack_bytes=int(m.group(1)),
                           spill_store_bytes=int(m.group(2)),
                           spill_load_bytes=int(m.group(3)))
        m = _PTXAS_REGS.search(line)
        if out and m and "registers" not in out[-1]:
            out[-1]["registers"] = int(m.group(1))
    return out


def resident_warps(name: str, geometry: dict, dev: torch.device) -> dict:
    """CUDA blocks and warps of the named kernel that one SM of ``dev``
    holds at once at ``geometry`` (a launch geometry of
    ``extend_launch_geometry`` or ``bounds_launch_geometry``), from
    cudaOccupancyMaxActiveBlocksPerMultiprocessor in its C entry."""
    sym, keys = _OCCUPANCY[name]
    blocks = ctypes.c_int(0)
    with torch.cuda.device(dev):
        rc = getattr(_lib(name), sym)(*(int(geometry[k]) for k in keys),
                                      ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"{name}: occupancy query failed with CUDA error "
                           f"{rc}")
    return {"blocks_per_sm": blocks.value,
            "warps_per_sm": blocks.value * int(geometry["threads"]) // 32}


@functools.lru_cache(maxsize=None)
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


@functools.lru_cache(maxsize=None)
def _bounds_per_sm(dev: torch.device, threads: int, smem: int) -> int:
    return resident_warps("block_bounds", {"threads": threads, "smem": smem},
                          dev)["blocks_per_sm"]


def bounds_geometry_on(dev: torch.device, b: int, bs: int, l: int) -> dict:
    """``bounds_launch_geometry`` on ``dev``: its SMs, and the blocks per
    SM the card holds at the tile's shared-memory size."""
    tile = bounds_tile(bs, l)
    return bounds_launch_geometry(
        b, bs, l, _sm_count(dev),
        _bounds_per_sm(dev, BOUNDS_THREADS, tile["smem"]))


def _check(name: str, tensors: dict, dtypes: dict) -> torch.device:
    for arg, t in tensors.items():
        if t.dtype != dtypes[arg]:
            raise TypeError(f"{name}: {arg} has dtype {t.dtype}, "
                            f"expected {dtypes[arg]}")
    dev = None
    for arg, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {arg} is on {t.device}, expected the "
                             "CUDA device of the other operands")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"{name}: operands on {dev} and {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    return dev


def _launch(name: str, dev: torch.device, *args) -> None:
    lib = _lib(name)
    sym = _SIGNATURES[name][0]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, sym)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{rc}")


# --------------------------------------------------------------------------
# sq_distance_prune
# --------------------------------------------------------------------------

# blocks per select group of the cascade; the kernel writes one minimum
# per group (csrc/prune.cu GROUP)
PRUNE_GROUP = 64
# block centroids per block tile (csrc/prune.cu BN), and the most block
# tiles one grid covers (the grid's y extent)
PRUNE_TILE = 128
MAX_GRID_Y = 65535


def prune_launch_ranges(b: int) -> list[tuple[int, int]]:
    """(first block tile, tiles) of each grid the prune wrapper launches
    for ``b`` blocks: one grid per MAX_GRID_Y tiles of PRUNE_TILE key
    columns, in order (the first zeroes n_alive, so one grid is launched
    even for b = 0)."""
    bp = -(-b // PRUNE_GROUP) * PRUNE_GROUP
    tiles = -(-bp // PRUNE_TILE)
    return [(t0, min(MAX_GRID_Y, tiles - t0))
            for t0 in range(0, max(tiles, 1), MAX_GRID_Y)]


def sq_distance_prune_plain(q_emb: torch.Tensor, centroids: torch.Tensor,
                            radii: torch.Tensor, r: float):
    """Plain version: the XLA form of hsearch_tpu/search/ivf.py's
    ``_search_block`` liveness test, then the cascade's stage-1 group
    minimum and the alive count over the inf-padded keys."""
    r = float(np.float32(r))
    c, b = q_emb.shape[0], centroids.shape[0]
    d = torch.sqrt(distance.sq_distance_matrix(q_emb, centroids))
    key = torch.where(d <= r + radii[None, :], d,
                      torch.full_like(d, float("inf")))
    key = F.pad(key, (0, (-b) % PRUNE_GROUP), value=float("inf"))
    gmin = torch.amin(key.view(c, key.shape[1] // PRUNE_GROUP, PRUNE_GROUP),
                      dim=2)
    n_alive = torch.sum(torch.isfinite(key), dim=1).to(torch.int32)
    return key, gmin, n_alive


def sq_distance_prune(q_emb: torch.Tensor, centroids: torch.Tensor,
                      radii: torch.Tensor, r: float):
    """(C, D) queries vs (B, D) block centroids -> (key, gmin, n_alive).

    key (C, Bp) f32, Bp = B rounded up to PRUNE_GROUP:
    key[c, b] = distance(q_c, centroid_b) where the block can contain a
    hit (d <= r + radius_b in float32), else +inf (always for b >= B).
    gmin (C, Bp / PRUNE_GROUP) f32: the minimum key of each group of
    PRUNE_GROUP consecutive blocks.  n_alive (C,) int32: finite keys per
    row.
    """
    if q_emb.device.type == "cpu":
        return sq_distance_prune_plain(q_emb, centroids, radii, r)
    ops = {"q_emb": q_emb, "centroids": centroids, "radii": radii}
    dev = _check("sq_distance_prune", ops,
                 dict.fromkeys(ops, torch.float32))
    c, d = q_emb.shape
    b = centroids.shape[0]
    if centroids.shape != (b, d) or radii.shape != (b,):
        raise ValueError(f"sq_distance_prune: shapes q {tuple(q_emb.shape)},"
                         f" centroids {tuple(centroids.shape)}, radii "
                         f"{tuple(radii.shape)} do not match")
    # the kernel's TMA copies need 16-byte row strides and alignment
    if d % 4 or q_emb.data_ptr() % 16 or centroids.data_ptr() % 16:
        raise ValueError(f"sq_distance_prune: D={d} must be a multiple of 4"
                         " and the operands 16-byte aligned")
    bp = -(-b // PRUNE_GROUP) * PRUNE_GROUP
    # one reduction per operand, with no (rows, D) temporary
    q_sqnorm = torch.linalg.vector_norm(q_emb, dim=1).square()
    cent_sqnorm = torch.linalg.vector_norm(centroids, dim=1).square()
    key = torch.empty((c, bp), dtype=torch.float32, device=dev)
    gmin = torch.empty((c, bp // PRUNE_GROUP), dtype=torch.float32,
                       device=dev)
    n_alive = torch.empty((c,), dtype=torch.int32, device=dev)
    for tile0, tiles in prune_launch_ranges(b):
        _launch("sq_distance_prune", dev, q_emb.data_ptr(),
                centroids.data_ptr(), q_sqnorm.data_ptr(),
                cent_sqnorm.data_ptr(), radii.data_ptr(),
                float(np.float32(r)), key.data_ptr(), gmin.data_ptr(),
                n_alive.data_ptr(), c, b, d, tile0, tiles)
    sq_distance_prune.launches += 1
    return key, gmin, n_alive


sq_distance_prune.launches = 0


# --------------------------------------------------------------------------
# ptable_verify
# --------------------------------------------------------------------------

def ptable_verify_plain(ptab: torch.Tensor, db_sorted: torch.Tensor,
                        order: torch.Tensor, blk_ids: torch.Tensor,
                        neg: torch.Tensor, r2: float, n: int):
    """Plain version: gather the selected blocks' k-mers and ids, verify
    with ``ops/distance.ptable_distances`` and apply the hit test, as
    hsearch_tpu/search/ivf.py's ``_search_block`` does."""
    c, kb = blk_ids.shape
    bs = order.shape[1]
    alive = torch.isfinite(neg)
    safe = torch.where(alive, blk_ids, torch.zeros_like(blk_ids))
    cand = db_sorted[safe].reshape(c, kb * bs, ptab.shape[1])
    gids = order[safe].reshape(c, kb * bs)
    gids = torch.where(torch.repeat_interleave(alive, bs, dim=1), gids,
                       torch.full_like(gids, n))
    d2 = distance.ptable_distances(ptab, cand)
    hits = (gids < n) & (d2 <= float(np.float32(r2)))
    d2m = torch.where(hits, d2, torch.full_like(d2, float("inf")))
    return d2m, torch.sum(hits, dim=1).to(torch.int32)


def ptable_verify(ptab: torch.Tensor, db_sorted: torch.Tensor,
                  order: torch.Tensor, blk_ids: torch.Tensor,
                  neg: torch.Tensor, r2: float, n: int):
    """Exact verify of the selected blocks -> (d2m, n_hits).

    ptab (C, L, 20) f32 P-tables; db_sorted (B, bs*L) int8 and order
    (B, bs) int32 of the index; blk_ids (C, kb) int64 selected blocks,
    alive where neg (C, kb) is finite.  d2m (C, kb*bs) f32 holds
    d2 = sum_l ptab[c, l, kmer_l] where the row is alive, a real point
    (order < n) and d2 <= r2 (float32), else +inf; n_hits (C,) int32
    counts those.  K-mer entries must be amino-acid indices in [0, 20).
    """
    if blk_ids.device.type == "cpu":
        return ptable_verify_plain(ptab, db_sorted, order, blk_ids, neg, r2,
                                   n)
    dev = _check("ptable_verify",
                 {"ptab": ptab, "db_sorted": db_sorted, "order": order,
                  "blk_ids": blk_ids, "neg": neg},
                 {"ptab": torch.float32, "db_sorted": torch.int8,
                  "order": torch.int32, "blk_ids": torch.int64,
                  "neg": torch.float32})
    c, kb = blk_ids.shape
    b, bs = order.shape
    l = ptab.shape[1]
    if ptab.shape != (c, l, 20) or db_sorted.shape != (b, bs * l) \
            or neg.shape != (c, kb):
        raise ValueError(f"ptable_verify: shapes ptab {tuple(ptab.shape)}, "
                         f"db_sorted {tuple(db_sorted.shape)}, order "
                         f"{tuple(order.shape)}, blk_ids {(c, kb)}, neg "
                         f"{tuple(neg.shape)} do not match")
    d2m = torch.empty((c, kb * bs), dtype=torch.float32, device=dev)
    n_hits = torch.empty((c,), dtype=torch.int32, device=dev)
    _launch("ptable_verify", dev, ptab.data_ptr(), db_sorted.data_ptr(),
            order.data_ptr(), blk_ids.data_ptr(), neg.data_ptr(),
            float(np.float32(r2)), n, d2m.data_ptr(), n_hits.data_ptr(), c,
            kb, bs, l)
    ptable_verify.launches += 1
    return d2m, n_hits


ptable_verify.launches = 0

# --------------------------------------------------------------------------
# extend_pairs
# --------------------------------------------------------------------------

# threads per lane (a warp: the chunk the kernel extends per step) and
# threads per CUDA block (csrc/extend_pairs.cu G, THREADS)
EXTEND_GROUP = 32
EXTEND_THREADS = 256
MAX_GRID_X = (1 << 31) - 1
MAX_SHARED = 232_448


def extend_launch_geometry(b: int) -> dict:
    """The extension kernel's launch for ``b`` lanes: EXTEND_GROUP threads
    per lane, EXTEND_THREADS threads per CUDA block, ``grid`` blocks, and
    the static shared bytes of its two tables (the 21x21 scores and the
    21 murphy10 groups, int32)."""
    lanes = EXTEND_THREADS // EXTEND_GROUP
    grid = max(1, -(-int(b) // lanes))
    if grid > MAX_GRID_X:
        raise ValueError(f"extend_pairs: {b} lanes need {grid} blocks, past "
                         f"the grid's {MAX_GRID_X}")
    return {"threads": EXTEND_THREADS, "lanes_per_block": lanes,
            "grid": grid, "smem": 4 * (21 * 21 + 21)}


@functools.lru_cache(maxsize=None)
def _extend_tables(device: torch.device):
    """The flattened 21x21 substitution table and the 21-entry murphy10
    group table, int32 on ``device``; cached, since a fresh host-to-device
    copy would synchronise the host with the stream."""
    return (torch.as_tensor(_extend._SUB.reshape(-1), dtype=torch.int32,
                            device=device),
            torch.as_tensor(_extend._GROUP, dtype=torch.int32,
                            device=device))


def extend_pairs_plain(qseq: torch.Tensor, dseq: torch.Tensor,
                       six: torch.Tensor, drop: int,
                       seed_len: int = 10) -> torch.Tensor:
    """Plain version: align/extend.py's chunked form, valid for every
    protein length (the JAX package's ``extend_pairs_packed``)."""
    return _extend.extend_pairs_packed(qseq, dseq, six, drop, seed_len)


def extend_pairs(qseq: torch.Tensor, dseq: torch.Tensor, six: torch.Tensor,
                 drop: int, seed_len: int = 10) -> torch.Tensor:
    """Ungapped seed-extend of one packed batch -> (8, B) int32 PACK_KEYS.

    qseq (Sq,) and dseq (Sd,) int32 residues (AA indices, >= 20 unknown);
    six (6, B) int32 rows (qpos, dpos, qlo, qhi, dlo, dhi), each row's
    lanes contiguous (a column slice of a wider batch is read in place);
    drop the x-drop threshold (raw score).  Bitwise equal to
    ``extend_pairs_plain`` for every protein length.
    """
    if six.device.type == "cpu":
        return extend_pairs_plain(qseq, dseq, six, drop, seed_len)
    dev = _check("extend_pairs", {"qseq": qseq, "dseq": dseq},
                 {"qseq": torch.int32, "dseq": torch.int32})
    if six.device != dev or six.dtype != torch.int32:
        raise ValueError(f"extend_pairs: six is {six.dtype} on "
                         f"{six.device}, expected int32 on {dev}")
    if six.dim() != 2 or six.shape[0] != 6 or qseq.dim() != 1 \
            or dseq.dim() != 1:
        raise ValueError(f"extend_pairs: shapes six {tuple(six.shape)}, "
                         f"qseq {tuple(qseq.shape)}, dseq "
                         f"{tuple(dseq.shape)}; expected (6, B), (Sq,), "
                         "(Sd,)")
    b = six.shape[1]
    if b > 1 and six.stride(1) != 1:
        raise ValueError("extend_pairs: each row of six must be contiguous")
    out = torch.empty((len(_extend.PACK_KEYS), b), dtype=torch.int32,
                      device=dev)
    if b:
        sub, grp = _extend_tables(dev)
        geo = extend_launch_geometry(b)
        _launch("extend_pairs", dev, qseq.data_ptr(), qseq.numel(),
                dseq.data_ptr(), dseq.numel(), six.data_ptr(),
                six.stride(0), sub.data_ptr(), grp.data_ptr(), int(drop),
                int(seed_len), out.data_ptr(), b, geo["threads"],
                geo["grid"])
        extend_pairs.launches += 1
    return out


extend_pairs.launches = 0


# --------------------------------------------------------------------------
# block_bounds
# --------------------------------------------------------------------------

# threads per CUDA block of the bounds kernel, and the names of the ten
# ints of its shared-memory layout as its C entry takes them
# (csrc/block_bounds.cu Layout)
BOUNDS_THREADS = 256
BOUNDS_LAYOUT = ("vmask", "rsum", "tab", "cnt", "ncp", "stage0", "rows_cap",
                 "stage_bytes", "stages", "smem")


def _r16(x: int) -> int:
    return (x + 15) // 16 * 16


def bounds_layout(tile: int, bs: int, l: int, stages: int,
                  threads: int = BOUNDS_THREADS) -> dict:
    """Shared bytes of one bounds block, by region (csrc/block_bounds.cu
    reads them from here): the (20, 8) coordinate table; ``vmask``, the
    valid-row masks; ``rsum``, a row-sum maximum per thread; ``tab``, the
    (column, 21) table; ``cnt``, each thread's 20 counts with row stride
    ``ncp``, in the table's bytes where a tile's columns fit in one round
    of threads, else after it; ``stages`` staged tiles from ``stage0``,
    each ``stage_bytes``: the 16-byte cover of its rows' span
    (``rows_cap``), then, double-buffered, of its order entries'; and the
    total, ``smem``."""
    cols = tile * l
    off = 4 * 20 * 8
    lay = {"vmask": off}
    off += _r16(4 * tile * (-(-bs // 32)))
    lay["rsum"] = off
    off += _r16(4 * threads)
    lay["tab"] = off
    if cols <= threads:
        ncp = -(-cols // 32) * 32
        lay["cnt"] = off
        off += _r16(4 * max(20 * ncp, 21 * cols))
    else:
        ncp = threads
        off += _r16(4 * 21 * cols)
        lay["cnt"] = off
        off += _r16(4 * 20 * ncp)
    lay["ncp"] = ncp
    lay["stage0"] = off
    lay["rows_cap"] = _r16(tile * bs * l + 30)
    lay["stage_bytes"] = lay["rows_cap"] + (_r16(4 * tile * bs + 30)
                                            if stages == 2 else 0)
    lay["stages"] = stages
    lay["smem"] = off + stages * lay["stage_bytes"]
    return lay


def bounds_tile(bs: int, l: int) -> dict:
    """The bounds kernel's tile for blocks of ``bs`` rows of length ``l``:
    as many consecutive blocks as give each thread at most one column and
    one row (tile * L <= threads and tile * bs <= threads; one block where
    a block alone has more), double-buffered, fewer where two staged tiles
    would not fit MAX_SHARED, and one tile staged at a time where even one
    block's two would not; with its ``bounds_layout``.  Raises ValueError
    where one block's rows do not fit."""
    threads = BOUNDS_THREADS
    if bs < 1 or l < 1:
        raise ValueError(f"block_bounds: bs {bs}, L {l}: both must be >= 1")
    tile = max(1, threads // max(bs, l))
    while tile > 1 and bounds_layout(tile, bs, l, 2)["smem"] > MAX_SHARED:
        tile -= 1
    for stages in (2, 1):
        lay = bounds_layout(tile, bs, l, stages)
        if lay["smem"] <= MAX_SHARED:
            return {"tile": tile, "threads": threads, **lay}
    raise ValueError(f"block_bounds: a block of {bs} rows of {l} needs "
                     f"{lay['smem']} shared bytes, past {MAX_SHARED}")


def bounds_launch_geometry(b: int, bs: int, l: int, sms: int,
                           per_sm: int) -> dict:
    """The bounds kernel's launch for B = ``b`` blocks of ``bs`` rows of
    length ``l`` on a card of ``sms`` SMs that holds ``per_sm`` of its
    CUDA blocks each: ``bounds_tile``'s tile and layout, ``tiles`` =
    ceil(b / tile), and a persistent ``grid`` of at most the blocks the
    SMs hold at once, each walking tiles g, g + grid, ...."""
    geo = bounds_tile(bs, l)
    tiles = -(-int(b) // geo["tile"])
    grid = max(1, min(tiles, int(sms) * max(1, int(per_sm))))
    if grid > MAX_GRID_X:
        raise ValueError(f"block_bounds: grid {grid} past {MAX_GRID_X}")
    return {**geo, "tiles": tiles, "grid": grid}


def _bounds_formula(db_c: torch.Tensor, valid: torch.Tensor,
                    coords: torch.Tensor):
    """(m, bs, L) int8 rows and their (m, bs) validity -> each block's
    embedded centroid (m, 8L) f32 and covering radius (m,).

    Per position, the centroid is the residue counts (exact integers)
    times the coordinate table over the row count, and a row's squared
    distance to it is a sum of L entries of a (m, L, 20) table of each
    residue's squared distance to the centroid's position: no (m, bs, 8L)
    embedding is made.
    """
    m, bs, l = db_c.shape
    a = db_c.long().transpose(1, 2)                          # (m, L, bs)
    w = valid[:, None, :].expand(m, l, bs).to(coords.dtype)
    counts = torch.zeros((m, l, coords.shape[0]), dtype=coords.dtype,
                         device=coords.device).scatter_add_(2, a, w)
    cnt = torch.clamp_min(valid.sum(dim=1), 1).to(coords.dtype)
    cent = (counts @ coords) / cnt[:, None, None]            # (m, L, 8)
    diff = coords[None, None] - cent[:, :, None, :]          # (m, L, 20, 8)
    tab = torch.sum(diff * diff, dim=-1)                     # (m, L, 20)
    d2 = torch.gather(tab, 2, a).sum(dim=1)                  # (m, bs)
    d2 = torch.where(valid, d2, torch.zeros_like(d2))
    return cent.reshape(m, -1), torch.sqrt(torch.amax(d2, dim=1))


def block_bounds_plain(db_sorted: torch.Tensor, order: torch.Tensor, n: int,
                       coords: torch.Tensor, bchunk: int = 4096):
    """Plain version: ``_bounds_formula`` over chunks of ``bchunk`` blocks
    (unchunked, the (B, L, 20, 8) table of a 2^22-point segment would take
    3 GB), then -inf radius and zero centroid for blocks with no valid
    row."""
    b, bs = order.shape
    l = db_sorted.shape[1] // bs
    cent = torch.empty((b, l * coords.shape[1]), dtype=torch.float32,
                       device=db_sorted.device)
    rad = torch.empty(b, dtype=torch.float32, device=db_sorted.device)
    for s in range(0, b, bchunk):
        valid = order[s:s + bchunk] < n
        c, r = _bounds_formula(db_sorted[s:s + bchunk].view(-1, bs, l),
                               valid, coords)
        real = valid.any(dim=1)
        rad[s:s + bchunk] = torch.where(real, r,
                                        torch.full_like(r, -float("inf")))
        cent[s:s + bchunk] = torch.where(real[:, None], c,
                                         torch.zeros_like(c))
    return cent, rad


def block_bounds(db_sorted: torch.Tensor, order: torch.Tensor, n: int,
                 coords: torch.Tensor, bchunk: int = 4096):
    """Each index block's (centroid (B, 8L) f32, radius (B,) f32).

    db_sorted (B, bs*L) int8 block-sorted rows (AA indices in [0, 20)),
    order (B, bs) int32 (a row is valid where order < n), coords the
    (20, 8) f32 coordinate table.  The centroid is the mean embedding of
    the block's valid rows, the radius the largest distance of one to it;
    a block with no valid row gets radius -inf and centroid 0.  One launch
    on a CUDA device; ``bchunk`` sizes only the plain version's chunks.
    """
    if db_sorted.device.type == "cpu":
        return block_bounds_plain(db_sorted, order, n, coords, bchunk)
    dev = _check("block_bounds",
                 {"db_sorted": db_sorted, "order": order, "coords": coords},
                 {"db_sorted": torch.int8, "order": torch.int32,
                  "coords": torch.float32})
    b, bs = order.shape
    l = db_sorted.shape[1] // max(bs, 1)
    if db_sorted.shape != (b, bs * l) or bs < 1 or coords.shape != (20, 8):
        raise ValueError(f"block_bounds: shapes db_sorted "
                         f"{tuple(db_sorted.shape)}, order "
                         f"{tuple(order.shape)}, coords "
                         f"{tuple(coords.shape)} do not match")
    cent = torch.empty((b, l * coords.shape[1]), dtype=torch.float32,
                       device=dev)
    rad = torch.empty(b, dtype=torch.float32, device=dev)
    if b:
        geo = bounds_geometry_on(dev, b, bs, l)
        _launch("block_bounds", dev, db_sorted.data_ptr(), order.data_ptr(),
                coords.data_ptr(), n, cent.data_ptr(), rad.data_ptr(), b, bs,
                l, geo["tile"], geo["threads"], geo["grid"],
                (ctypes.c_int * len(BOUNDS_LAYOUT))(
                    *(geo[k] for k in BOUNDS_LAYOUT)))
        block_bounds.launches += 1
    return cent, rad


block_bounds.launches = 0

# --------------------------------------------------------------------------
# banded_scores
# --------------------------------------------------------------------------

# the widest band the kernel takes: 2*band+1 diagonal lanes in chunks of
# at most 8 per thread of a warp (csrc/banded_scores.cu)
BANDED_MAX_BAND = 127
# gap penalties and |drop| the kernel takes: every intermediate score then
# stays within int32, as it does in the plain version
BANDED_MAX_GAP, BANDED_MAX_DROP = (1 << 20) - 1, 1 << 30


def banded_scores(q: torch.Tensor, qlen: torch.Tensor, d: torch.Tensor,
                  dlen: torch.Tensor, sub21: torch.Tensor, gap_open: int,
                  gap_ext: int, drop: int, band: int):
    """Banded affine-gap scores of P window pairs -> (best, bi, bj), each
    (P,) int32: the best cell's score (floored at 0) and its row and
    column, as align/gapped_device.py's ``banded_scores_plain`` defines
    them, bitwise.

    q (P, Lq) and d (P, Ld) int32 residues (AA indices 0..20), qlen and
    dlen (P,) int32, sub21 the (21, 21) int32 substitution table, all
    contiguous; gap_open, gap_ext, drop and band as ints
    (0 <= gap_ext <= gap_open, band <= 127).
    """
    if q.device.type == "cpu":
        from ..align.gapped_device import banded_scores_plain
        return banded_scores_plain(q, qlen, d, dlen, sub21, gap_open,
                                   gap_ext, drop, band)
    go, ge, drop, band = int(gap_open), int(gap_ext), int(drop), int(band)
    if not 0 <= band <= BANDED_MAX_BAND:
        raise ValueError(f"banded_scores: band {band} outside [0, "
                         f"{BANDED_MAX_BAND}]")
    if not (0 <= ge <= go <= BANDED_MAX_GAP and abs(drop) <= BANDED_MAX_DROP):
        raise ValueError(f"banded_scores: gap_open {go}, gap_ext {ge}, drop "
                         f"{drop}: the kernel needs 0 <= gap_ext <= gap_open"
                         f" <= {BANDED_MAX_GAP} and |drop| <= "
                         f"{BANDED_MAX_DROP}")
    ops = {"q": q, "qlen": qlen, "d": d, "dlen": dlen, "sub21": sub21}
    dev = _check("banded_scores", ops, dict.fromkeys(ops, torch.int32))
    p = q.shape[0]
    if q.dim() != 2 or d.dim() != 2 or d.shape[0] != p \
            or qlen.shape != (p,) or dlen.shape != (p,) \
            or sub21.shape != (21, 21):
        raise ValueError(f"banded_scores: shapes q {tuple(q.shape)}, qlen "
                         f"{tuple(qlen.shape)}, d {tuple(d.shape)}, dlen "
                         f"{tuple(dlen.shape)}, sub21 {tuple(sub21.shape)}"
                         " do not match")
    out = [torch.empty(p, dtype=torch.int32, device=dev) for _ in range(3)]
    if p:
        _launch("banded_scores", dev, q.data_ptr(), qlen.data_ptr(),
                d.data_ptr(), dlen.data_ptr(), q.shape[1], d.shape[1],
                sub21.data_ptr(), go, ge, drop, band,
                *(o.data_ptr() for o in out), p)
        banded_scores.launches += 1
    return tuple(out)


banded_scores.launches = 0


# --------------------------------------------------------------------------
# elect
# --------------------------------------------------------------------------

# the widest bucket row the kernel takes (one thread per slot)
ELECT_MAX_B = 1024


def elect(d: torch.Tensor, state: torch.Tensor, valid: torch.Tensor,
          radius: float) -> torch.Tensor:
    """First-fit leader election of NB bucket rows -> (NB, B) int64 parent
    slots (-1 where none), as cluster/greedy.py's ``_elect_plain`` defines
    them, bitwise.

    d (NB, B, B) float32 in-bucket distances (read in place), state
    (NB, B) uint8 (0 unprocessed, 1 center, other values neither), valid
    (NB, B) bool; a slot matches where d <= float32(radius).  B <= 1024.
    """
    if d.device.type == "cpu":
        from ..cluster.greedy import _elect_plain
        return _elect_plain(d, state, valid, radius)
    if d.dim() != 3 or d.shape[1] != d.shape[2] \
            or not 0 < d.shape[1] <= ELECT_MAX_B:
        raise ValueError(f"elect: d is {tuple(d.shape)}, expected (NB, B, "
                         f"B) with 0 < B <= {ELECT_MAX_B}")
    dev = _check("elect", {"d": d, "state": state, "valid": valid},
                 {"d": torch.float32, "state": torch.uint8,
                  "valid": torch.bool})
    nb, b, _ = d.shape
    if state.shape != (nb, b) or valid.shape != (nb, b):
        raise ValueError(f"elect: shapes d {tuple(d.shape)}, state "
                         f"{tuple(state.shape)}, valid {tuple(valid.shape)}"
                         " do not match")
    parent = torch.empty((nb, b), dtype=torch.int64, device=dev)
    if nb:
        _launch("elect", dev, d.data_ptr(), state.data_ptr(),
                valid.data_ptr(), float(np.float32(radius)),
                parent.data_ptr(), nb, b)
        elect.launches += 1
    return parent


elect.launches = 0

KERNELS = {"sq_distance_prune": sq_distance_prune,
           "ptable_verify": ptable_verify,
           "extend_pairs": extend_pairs,
           "block_bounds": block_bounds,
           "banded_scores": banded_scores,
           "elect": elect}


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def count_launches(counts: dict[str, int]) -> None:
    """Add ``counts`` to the kernels' launch counts: the launches of a
    CUDA graph's replay, which no wrapper sees (``ivf._graphed_block``)."""
    for name, k in counts.items():
        KERNELS[name].launches += k
