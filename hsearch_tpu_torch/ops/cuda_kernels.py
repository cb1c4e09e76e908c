"""Hand-written CUDA kernels for the hot search ops (counterpart of
hsearch_tpu/ops/pallas_kernels.py).

  * ``sq_distance_prune`` (csrc/prune.cu): centers vs block centroids with
    the distance epilogue (norms, max(., 0), sqrt) and the triangle-
    inequality liveness test fused in; writes the (C, B) key matrix.
  * ``ptable_verify`` (csrc/ptable_verify.cu): the exact P-table verify
    d2[c, m] = sum_l ptab[c, l, cand[c, m, l]] of gathered candidates.

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
                          [_P, _P, _P, _F, _P, _I, _I, _I, _P]),
    "ptable_verify": ("hs_ptable_verify", [_P, _P, _P, _I, _I, _I, _P]),
}
# dynamic shared memory of ptable_verify: L*20 floats + 256*L bytes,
# within the 48 KB a block gets without an opt-in attribute
_VERIFY_MAX_L = (48 * 1024) // (20 * 4 + 256)

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

def sq_distance_prune_plain(q_emb: torch.Tensor, centroids: torch.Tensor,
                            radii: torch.Tensor, r: float) -> torch.Tensor:
    """Plain version: the XLA form of hsearch_tpu/search/ivf.py's
    ``_search_block`` liveness test."""
    r = float(np.float32(r))
    d = torch.sqrt(distance.sq_distance_matrix(q_emb, centroids))
    return torch.where(d <= r + radii[None, :], d,
                       torch.full_like(d, float("inf")))


def sq_distance_prune(q_emb: torch.Tensor, centroids: torch.Tensor,
                      radii: torch.Tensor, r: float) -> torch.Tensor:
    """(C, D) queries vs (B, D) block centroids -> (C, B) pruned keys.

    key[c, b] = distance(q_c, centroid_b) where the block can contain a
    hit (d <= r + radius_b in float32), else +inf.
    """
    if q_emb.device.type == "cpu":
        return sq_distance_prune_plain(q_emb, centroids, radii, r)
    dev = _check("sq_distance_prune",
                 {"q_emb": q_emb, "centroids": centroids, "radii": radii},
                 {"q_emb": torch.float32, "centroids": torch.float32,
                  "radii": torch.float32})
    c, d = q_emb.shape
    b = centroids.shape[0]
    if centroids.shape != (b, d) or radii.shape != (b,):
        raise ValueError(f"sq_distance_prune: shapes q {tuple(q_emb.shape)},"
                         f" centroids {tuple(centroids.shape)}, radii "
                         f"{tuple(radii.shape)} do not match")
    out = torch.empty((c, b), dtype=torch.float32, device=dev)
    _launch("sq_distance_prune", dev, q_emb.data_ptr(), centroids.data_ptr(),
            radii.data_ptr(), float(np.float32(r)), out.data_ptr(), c, b, d)
    sq_distance_prune.launches += 1
    return out


sq_distance_prune.launches = 0


# --------------------------------------------------------------------------
# ptable_verify
# --------------------------------------------------------------------------

def ptable_verify_plain(ptab: torch.Tensor, cand: torch.Tensor
                        ) -> torch.Tensor:
    """Plain version: ``ops/distance.ptable_distances``."""
    return distance.ptable_distances(ptab, cand)


def ptable_verify(ptab: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """(C, L, 20) P-tables x (C, M, L) int8 candidates -> (C, M) d2.

    Candidate entries must be amino-acid indices in [0, 20).
    """
    if cand.device.type == "cpu":
        return ptable_verify_plain(ptab, cand)
    dev = _check("ptable_verify", {"ptab": ptab, "cand": cand},
                 {"ptab": torch.float32, "cand": torch.int8})
    c, m, l = cand.shape
    if ptab.shape != (c, l, 20):
        raise ValueError(f"ptable_verify: ptab {tuple(ptab.shape)} does not "
                         f"match cand {tuple(cand.shape)}")
    if l > _VERIFY_MAX_L:
        raise ValueError(f"ptable_verify: L={l} exceeds {_VERIFY_MAX_L}")
    out = torch.empty((c, m), dtype=torch.float32, device=dev)
    _launch("ptable_verify", dev, ptab.data_ptr(), cand.data_ptr(),
            out.data_ptr(), c, m, l)
    ptable_verify.launches += 1
    return out


ptable_verify.launches = 0

KERNELS = {"sq_distance_prune": sq_distance_prune,
           "ptable_verify": ptable_verify}


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}
