"""Sort-based hash tables (counterpart of hsearch_tpu/ops/segment.py).

An LSH "hash table" over N points is three (T, N) int32 tensors:

    codes   packed bucket code per point per table
    perm    stable argsort of each table's codes
    sorted  codes[perm]

Bucket membership queries are ``searchsorted`` pairs and contiguous
gathers from ``perm``.  Packing is 32-bit two's-complement arithmetic in
int32 tensors throughout (multiplies wrap modulo 2^32, right shifts are
arithmetic), so every code is bit-identical to the JAX package's.
"""

from __future__ import annotations

import dataclasses

import torch

# 32-bit odd mixing multiplier (0x9E3779B9 as int32) and xor constant
_MIX_MULT = -1640531527
_MIX_XOR = 0x45D9F3B
_MIX_SEED = 0x12345678


def pack_codes_exact(buckets: torch.Tensor, bits: int = 7) -> torch.Tensor:
    """(..., K) int bucket indices -> (...,) int32, exact for K*bits <= 31.

    Indices are clipped to the signed ``bits`` range, then concatenated
    ``bits`` bits at a time.
    """
    k = buckets.shape[-1]
    if k * bits > 31:
        raise ValueError(f"K={k} x {bits}-bit indices do not fit 31 bits; "
                         "use pack_codes_mixed")
    lim = 1 << (bits - 1)
    b = torch.clamp(buckets.to(torch.int32), -lim, lim - 1) + lim
    out = torch.zeros(buckets.shape[:-1], dtype=torch.int32,
                      device=buckets.device)
    for i in range(k):
        out = (out << bits) | b[..., i]
    return out


def pack_codes_mixed(buckets: torch.Tensor) -> torch.Tensor:
    """(..., K) int -> (...,) int32 mixing hash (for K*bits > 31).

    Collisions merge buckets, which only adds verification candidates.
    Every step stays in int32: the multiply wraps modulo 2^32 and
    ``>> 15`` is arithmetic before the mask, as in the JAX package.
    """
    mult = torch.tensor(_MIX_MULT, dtype=torch.int32, device=buckets.device)
    h = torch.full(buckets.shape[:-1], _MIX_SEED, dtype=torch.int32,
                   device=buckets.device)
    for i in range(buckets.shape[-1]):
        h = h * mult + buckets[..., i].to(torch.int32)
        h = h ^ ((h >> 15) & 0x1FFFF) ^ _MIX_XOR
    return h


def pack_codes(buckets: torch.Tensor, bits: int = 7) -> torch.Tensor:
    if buckets.shape[-1] * bits <= 31:
        return pack_codes_exact(buckets, bits)
    return pack_codes_mixed(buckets)


@dataclasses.dataclass
class SortedTables:
    """Multi-table sorted-code index over N points."""

    sorted_codes: torch.Tensor   # (T, N) int32
    perm: torch.Tensor           # (T, N) int32

    @property
    def num_tables(self) -> int:
        return self.sorted_codes.shape[0]

    @property
    def num_points(self) -> int:
        return self.sorted_codes.shape[1]


def build_tables(codes: torch.Tensor) -> SortedTables:
    """(T, N) packed codes -> SortedTables (one stable sort per table).

    The sort must be stable: when a bucket is longer than cand_max,
    ``gather_candidates`` keeps the first cand_max ids of its run, so the
    order inside a run decides which candidates survive.
    """
    s = torch.sort(codes, dim=1, stable=True)
    return SortedTables(sorted_codes=s.values,
                        perm=s.indices.to(torch.int32))


def probe(tables: SortedTables, qcodes: torch.Tensor):
    """(C, T) or (C, T, P) query codes -> (start, count) of the same shape,
    int32: each query's bucket in each table's perm row."""
    c, t = qcodes.shape[:2]
    q = qcodes.transpose(0, 1).reshape(t, -1).contiguous()   # (T, C[*P])
    lo = torch.searchsorted(tables.sorted_codes, q, side="left")
    hi = torch.searchsorted(tables.sorted_codes, q, side="right")
    back = lambda x: x.reshape(t, c, *qcodes.shape[2:]).transpose(0, 1) \
        .to(torch.int32)
    return back(lo), back(hi - lo)


def gather_candidates(tables: SortedTables, start: torch.Tensor,
                      count: torch.Tensor, cand_max: int) -> torch.Tensor:
    """Up to cand_max point ids per (query, table[, probe]).

    start/count: (C, T) or (C, T, P).  Returns ids (C, T[*P]*cand_max)
    int64 with invalid slots set to N (one past the last point).
    """
    c, t = start.shape[:2]
    n = tables.num_points
    offs = torch.arange(cand_max, dtype=torch.int64, device=start.device)
    valid = offs < count[..., None]                       # (C, T[, P], M)
    pos = torch.where(valid, start[..., None].to(torch.int64) + offs, 0)
    tbl = torch.arange(t, dtype=torch.int64, device=start.device) \
        .view((1, t) + (1,) * (start.dim() - 1))
    ids = tables.perm.view(-1)[tbl * n + pos].to(torch.int64)
    ids = torch.where(valid, ids, n)
    return ids.reshape(c, -1)


def dedup_sorted(ids: torch.Tensor, sentinel: int) -> torch.Tensor:
    """Sort each row and replace duplicates by ``sentinel`` (keeps the first
    occurrence).  Invalid entries must already equal ``sentinel``."""
    s = torch.sort(ids, dim=1).values
    dup = torch.zeros_like(s, dtype=torch.bool)
    dup[:, 1:] = s[:, 1:] == s[:, :-1]
    return torch.where(dup, sentinel, s)


def max_bucket_size(sorted_codes: torch.Tensor) -> int:
    """Largest bucket (longest run of equal codes) of (T, N) SORTED codes,
    at least 1."""
    t, n = sorted_codes.shape
    if n == 0:
        return 1
    pos = torch.arange(n, dtype=torch.int64, device=sorted_codes.device)
    newb = torch.ones((t, n), dtype=torch.bool, device=sorted_codes.device)
    newb[:, 1:] = sorted_codes[:, 1:] != sorted_codes[:, :-1]
    start = torch.cummax(torch.where(newb, pos, 0), dim=1).values
    return max(1, int(torch.max(pos - start + 1)))
