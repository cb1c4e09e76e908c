"""Hand-written CUDA kernels for the hot search ops (counterpart of
hsearch_tpu/ops/pallas_kernels.py).

  * ``sq_distance_prune`` (csrc/prune.cu): centers vs block centroids as
    a 3xTF32 tensor-core product, with the distance epilogue (norms,
    max(., 0), sqrt), the triangle-inequality liveness test, the cascade's
    per-group minimum and the alive count fused in.
  * ``ptable_verify`` (csrc/ptable_verify.cu): the exact P-table verify
    d2 = sum_l ptab[c, l, kmer_l] of the selected blocks, read from the
    block-sorted database by block id, with the radius test and the hit
    count fused in.

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, at first use, into ``_build/`` beside
the package; the file name carries a hash of the source and flags, so an
edited source rebuilds.  The libraries are loaded with ``ctypes`` and
launch on PyTorch's current stream.

Each wrapper takes its plain PyTorch version when its tensors lie on the
CPU, and launches its kernel (or raises) when they lie on a CUDA device.
``launches`` on each wrapper counts the kernel launches, so a run can show
that it went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from . import distance

_PKG = Path(__file__).resolve().parent.parent
_SRC = _PKG / "csrc"
_BUILD = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
SOURCES = {"sq_distance_prune": "prune.cu",
           "ptable_verify": "ptable_verify.cu"}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "sq_distance_prune": ("hs_sq_distance_prune",
                          [_P, _P, _P, _P, _P, _F, _P, _P, _P, _I, _I, _I,
                           _I, _I, _P]),
    "ptable_verify": ("hs_ptable_verify",
                      [_P, _P, _P, _P, _P, _F, _I, _P, _P, _I, _I, _I, _I,
                       _P]),
}

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
        _loaded[name] = lib
    return lib


def _check(name: str, tensors: dict, dtypes: dict) -> torch.device:
    dev = None
    for arg, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {arg} is on {t.device}, expected the "
                             "CUDA device of the other operands")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"{name}: operands on {dev} and {t.device}")
        if t.dtype != dtypes[arg]:
            raise TypeError(f"{name}: {arg} has dtype {t.dtype}, "
                            f"expected {dtypes[arg]}")
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

KERNELS = {"sq_distance_prune": sq_distance_prune,
           "ptable_verify": ptable_verify}


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}
