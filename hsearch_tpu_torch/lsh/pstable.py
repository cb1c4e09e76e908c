"""p-stable (Gaussian random projection) LSH over embedded k-mer points
(counterpart of hsearch_tpu/lsh/pstable.py).

Per table, K Gaussian projection vectors a_k ~ N(0, I) and offsets
b_k ~ U[0, W); the bucket index of point x along k is
floor((a_k . x + b_k) / W) and a point's bucket code is the packed K-tuple
(ops/segment.py).  Parameters are drawn from an explicit CPU
``torch.Generator`` and moved to the device, so one seed gives the same
parameters on the CPU and on the card; ``params_from_arrays`` carries the
JAX package's parameters across.

For integer k-mers the projection never embeds: each position's 20 residue
rows are pre-folded into a (L, 20, T*K) table and the projection is a sum
of L gathered rows, taken in position order l = 0..L-1.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from ..core import embedding
from ..ops import distance, segment


@dataclasses.dataclass
class PStableParams:
    a: torch.Tensor       # (T, D, K) f32 projection vectors
    b: torch.Tensor       # (T, K) f32 offsets in [0, W)
    w: float
    pack_bits: int = 7

    @property
    def num_tables(self) -> int:
        return self.a.shape[0]

    @property
    def dim(self) -> int:
        return self.a.shape[1]

    @property
    def hash_k(self) -> int:
        return self.a.shape[2]

    def to(self, device: torch.device) -> "PStableParams":
        return dataclasses.replace(self, a=self.a.to(device),
                                   b=self.b.to(device))


def init(generator: torch.Generator, dim: int, hash_k: int = 4,
         hash_l: int = 4, w: float = 50.0,
         device: str | torch.device = "cpu") -> PStableParams:
    """Draw LSH parameters for hash_l tables from a CPU generator."""
    a = torch.randn((hash_l, dim, hash_k), generator=generator,
                    dtype=torch.float32)
    b = torch.rand((hash_l, hash_k), generator=generator,
                   dtype=torch.float32) * np.float32(w)
    return PStableParams(a=a, b=b, w=float(w)).to(torch.device(device))


def params_from_arrays(a: np.ndarray, b: np.ndarray, w: float,
                       pack_bits: int = 7,
                       device: str | torch.device = "cpu") -> PStableParams:
    """The JAX package's PStableParams (``a`` (T, D, K), ``b`` (T, K), as
    numpy) as the port's."""
    return PStableParams(
        a=torch.as_tensor(np.array(a, np.float32), device=device),
        b=torch.as_tensor(np.array(b, np.float32), device=device),
        w=float(w), pack_bits=int(pack_bits))


def _w(params: PStableParams) -> float:
    # W as the float32 the JAX package divides by
    return float(np.float32(params.w))


def _folded_kmer_table(params: PStableParams, kmer_len: int) -> torch.Tensor:
    """Fold AA coordinates into the projections: (L, 20, T*K) with
    F[l, aa, t*K + k] = coords[aa] . a[t, l*8:(l+1)*8, k]."""
    t, d, k = params.a.shape
    ad = embedding.AA_DIM
    if d != kmer_len * ad:
        raise ValueError(f"projection dim {d} != kmer_len {kmer_len} x {ad}")
    coords = distance.const("coords", params.a.device)        # (20, 8)
    a = params.a.reshape(t, kmer_len, ad, k)                  # (T, L, 8, K)
    f = torch.einsum("ca,tlak->lctk", coords, a)              # (L, 20, T, K)
    return f.reshape(kmer_len, 20, t * k)


# rows per projection chunk: bounds the (rows, T*K) working set; each row's
# arithmetic is the same whatever the chunk
_ROW_CHUNK = 65536


def _kmer_projections(kmers: torch.Tensor, params: PStableParams):
    """(N, L) int k-mers -> yields (s, (rows, T, K) f32 a.x + b) per chunk."""
    n, l = kmers.shape
    t, _, k = params.a.shape
    fl = _folded_kmer_table(params, l)
    for s in range(0, n, _ROW_CHUNK):
        km = kmers[s:s + _ROW_CHUNK].long()
        proj = torch.zeros((km.shape[0], t * k), dtype=torch.float32,
                           device=kmers.device)
        for pos in range(l):
            proj = proj + fl[pos][km[:, pos]]
        yield s, proj.reshape(-1, t, k) + params.b[None, :, :]


def bucket_indices_kmers(kmers: torch.Tensor,
                         params: PStableParams) -> torch.Tensor:
    """(N, L) int k-mers -> (T, N, K) int32 bucket indices, embed and
    project fused: floor((sum_l F[l, kmer_l] + b) / W)."""
    n = kmers.shape[0]
    t, _, k = params.a.shape
    out = torch.empty((n, t, k), dtype=torch.int32, device=kmers.device)
    w = _w(params)
    for s, proj in _kmer_projections(kmers, params):
        out[s:s + proj.shape[0]] = torch.floor(proj / w).to(torch.int32)
    return out.permute(1, 0, 2)


def bucket_indices(points: torch.Tensor,
                   params: PStableParams) -> torch.Tensor:
    """(N, D) points -> (T, N, K) int32 bucket indices: floor((a.x + b)/W),
    all tables in one GEMM."""
    proj = _projections(points, params, is_kmers=False)
    return torch.floor(proj / _w(params)).to(torch.int32).permute(1, 0, 2)


def hash_codes(points_or_kmers: torch.Tensor, params: PStableParams,
               is_kmers: bool) -> torch.Tensor:
    """-> (T, N) packed int32 bucket codes."""
    if is_kmers:
        idx = bucket_indices_kmers(points_or_kmers, params)
    else:
        idx = bucket_indices(points_or_kmers, params)
    return segment.pack_codes(idx, params.pack_bits)


def _projections(points_or_kmers: torch.Tensor, params: PStableParams,
                 is_kmers: bool) -> torch.Tensor:
    """Raw (N, T, K) projection values a.x + b."""
    t, d, k = params.a.shape
    if is_kmers:
        return torch.cat([p for _, p in
                          _kmer_projections(points_or_kmers, params)])
    aflat = params.a.permute(1, 0, 2).reshape(d, t * k)
    proj = points_or_kmers.to(torch.float32) @ aflat
    return proj.reshape(-1, t, k) + params.b[None, :, :]


def multiprobe_codes(queries: torch.Tensor, params: PStableParams,
                     is_kmers: bool, num_probes: int) -> torch.Tensor:
    """Query-directed multiprobe: (C, ...) queries -> (T, C, P) codes.

    Probe 0 is the home bucket; probe j flips the subset (bits of j) of
    the J hash dimensions whose projections lie closest to a bucket
    boundary, each toward that boundary (Lv et al., multi-probe LSH).
    J is the smallest with 2^J >= num_probes; at most 2^K probes exist.
    """
    k_dims = params.a.shape[2]
    if num_probes > (1 << k_dims):
        warnings.warn(
            f"multiprobe can generate at most 2^K={1 << k_dims} probes "
            f"for hash_k={k_dims}; requested {num_probes}, using "
            f"{1 << k_dims}")
    scaled = _projections(queries, params, is_kmers) / _w(params)
    base = torch.floor(scaled)
    frac = scaled - base                       # in [0, 1)
    base = base.to(torch.int32)
    up = frac > 0.5
    delta = torch.where(up, 1.0 - frac, frac)  # distance to the boundary
    step = torch.where(up, 1, -1).to(torch.int32)
    j_dims = 0
    while (1 << j_dims) < num_probes and j_dims < k_dims:
        j_dims += 1
    # stable, as jnp.argsort: ties keep the lower dimension first
    order = torch.argsort(delta, dim=-1, stable=True)
    flips = []
    for j in range(j_dims):
        dim = order[..., j:j + 1]
        bump = torch.zeros_like(base).scatter(
            -1, dim, torch.gather(step, -1, dim))
        flips.append(bump)
    probes = []
    for pid in range(min(num_probes, 1 << j_dims)):
        b = base
        for j in range(j_dims):
            if pid & (1 << j):
                b = b + flips[j]
        probes.append(b)
    # every probe's indices packed in one pass: (C, T, P, K) -> (C, T, P)
    codes = segment.pack_codes(torch.stack(probes, dim=2), params.pack_bits)
    return codes.permute(1, 0, 2)                        # (T, C, P)
