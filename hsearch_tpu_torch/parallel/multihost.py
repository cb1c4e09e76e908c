"""Multi-process runtime on torch.distributed (counterpart of
hsearch_tpu/parallel/multihost.py).

  * **runtime**: ``initialize()`` joins a process group over a ``tcp://``
    rendezvous: NCCL with each rank on ``cuda:<local rank>``, or gloo on
    the CPU.
  * **mesh**: ``host_mesh()`` builds the (data, db) mesh with the ``db``
    axis laid out across processes: process p owns db columns
    [p * db_per_host, (p + 1) * db_per_host), its local devices form the
    ``data`` axis.
  * **ingest**: every process loads only its own database rows
    (``shard_range``, ``collect_local_rows``), streamed from global-order
    chunks; ``put_rows_streamed`` never stages more than one shard on the
    host.
  * **build/search**: thin wrappers over parallel/sharded.py's
    ``*_from_global`` builders and searches; host-local maxima (largest
    bucket, most blocks) fold across processes with one all-reduce, and
    each process's per-shard (C, max_hits) hit blocks are all-gathered,
    so every process returns the full merged hit set.

Every process calls each function with identical arguments.  Collectives
use CUDA tensors under NCCL and CPU tensors under gloo.  Tested by
tests/test_torch_multihost.py, which spawns real gloo clusters of 2 and 3
processes (parallel/_mp_check.py).
"""

from __future__ import annotations

import datetime

import numpy as np
import torch
import torch.distributed as dist

from .. import _device
from ..search import motif
from . import mesh as mesh_lib, sharded

DATA, DB = mesh_lib.DATA_AXIS, mesh_lib.DB_AXIS


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, device: str = "cuda",
               timeout_s: float | None = None) -> None:
    """Start (or join) the process group.

    coordinator_address is "host:port" of process 0's ``tcp://``
    rendezvous (nothing on the machine tells a program of a cluster).
    With device="cuda" the group runs NCCL and this rank uses
    cuda:<process_id mod the visible cards>; device="cpu" runs gloo.
    ``timeout_s`` bounds each collective's wait."""
    dev = _device.resolve(device)
    backend = "gloo"
    if dev.type == "cuda":
        backend = "nccl"
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    kw = {} if timeout_s is None \
        else {"timeout": datetime.timedelta(seconds=timeout_s)}
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id, **kw)


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def host_mesh(db_per_host: int = 1, local_devices=None) -> mesh_lib.Mesh:
    """(data, db) mesh with ``db`` spanning processes.

    Each process contributes ``db_per_host`` database shards; its
    remaining local devices form the ``data`` axis.  local_devices
    defaults to this rank's card under NCCL, else every visible card
    (``["cpu"] * n`` gives a CPU process n logical devices)."""
    if local_devices is None:
        if dist.is_initialized() and dist.get_backend() == "nccl":
            local_devices = [mesh_lib.collective_device()]
        else:
            local_devices = mesh_lib.cuda_devices()
    devs = [torch.device(d) for d in local_devices]
    nlocal = len(devs)
    if nlocal % db_per_host:
        raise ValueError(f"db_per_host={db_per_host} does not divide "
                         f"local device count {nlocal}")
    data = nlocal // db_per_host
    # local device l sits at [l // db_per_host, l % db_per_host]
    grid = tuple(tuple(devs[i * db_per_host:(i + 1) * db_per_host])
                 for i in range(data))
    return mesh_lib.Mesh(grid, db_first=process_index() * db_per_host,
                         db_size=process_count() * db_per_host)


def shard_range(n_total: int, mesh: mesh_lib.Mesh,
                process_id: int | None = None) -> tuple[int, int, int]:
    """(row_lo, row_hi, n_local_rows) of a process's database slice
    (this one's by default): rows lie contiguously per db shard in shard
    order, n_local = ceil(n_total / db) per shard."""
    ndb = mesh.shape[DB]
    n_local = -(-n_total // ndb)
    pid = process_index() if process_id is None else process_id
    dph = mesh.db_local
    lo = pid * dph * n_local
    hi = min(n_total, (pid + 1) * dph * n_local)
    return lo, max(lo, hi), n_local


def collect_local_rows(row_chunks, n_total: int,
                       mesh: mesh_lib.Mesh) -> np.ndarray:
    """Stream (M_i, L) row chunks (in global order); keep only this
    process's slice.  Memory on each host is bounded by its own shards."""
    lo, hi, _ = shard_range(n_total, mesh)
    keep = []
    base = 0
    for chunk in row_chunks:
        m = chunk.shape[0]
        s = max(lo, base)
        e = min(hi, base + m)
        if e > s:
            keep.append(np.asarray(chunk[s - base:e - base], np.int8))
        base += m
    if not keep:
        return np.zeros((0, 0), np.int8)
    return np.concatenate(keep)


def put_local_rows(local_rows: np.ndarray, n_total: int,
                   mesh: mesh_lib.Mesh, kmer_len: int | None = None) -> list:
    """This process's rows -> its per-shard (n_local, L) int8 tensors on
    each shard's first-row device (padding rows are zero, as on the
    single-process path)."""
    ndb = mesh.shape[DB]
    n_local = -(-n_total // ndb)
    l = local_rows.shape[1] if local_rows.size else kmer_len
    if l is None:
        raise ValueError("empty local_rows needs kmer_len")
    want = mesh.db_local * n_local
    if local_rows.shape[0] > want:
        raise ValueError(f"process owns {want} rows, got "
                         f"{local_rows.shape[0]}")
    local = np.zeros((want, l), np.int8)
    if local_rows.size:
        local[:local_rows.shape[0]] = local_rows
    return [torch.as_tensor(local[j * n_local:(j + 1) * n_local],
                            device=mesh.devices[0][j])
            for j in range(mesh.db_local)]


def put_rows_streamed(row_chunks, n_total: int, mesh: mesh_lib.Mesh,
                      kmer_len: int) -> list:
    """Stream global-order (M_i, L) row chunks straight into per-shard
    device tensors: the host never stages more than one shard.

    Keeps only this process's rows (as collect_local_rows), filling one
    db-shard buffer at a time and uploading it the moment it completes.
    The ingest path for databases larger than host memory."""
    n_local = -(-n_total // mesh.shape[DB])
    lo, hi, _ = shard_range(n_total, mesh)
    out = []
    buf = np.zeros((n_local, kmer_len), np.int8)
    fill = 0                 # rows filled in the current shard buffer

    def flush():
        nonlocal buf, fill
        out.append(torch.as_tensor(buf, device=mesh.devices[0][len(out)]))
        buf = np.zeros((n_local, kmer_len), np.int8)
        fill = 0

    base = 0
    for chunk in row_chunks:
        chunk = np.asarray(chunk, np.int8)
        m = chunk.shape[0]
        s = max(lo, base)
        e = min(hi, base + m)
        off = s - base
        while s < e:
            take = min(e - s, n_local - fill)
            buf[fill:fill + take] = chunk[off:off + take]
            fill += take
            s += take
            off += take
            if fill == n_local:
                flush()
        base += m
    while len(out) < mesh.db_local:
        flush()              # the partial shard and trailing padding shards
    return out


def _allmax(x: int) -> int:
    """Max of a host-local int across processes (one tiny all-reduce)."""
    if process_count() == 1:
        return int(x)
    t = torch.tensor([int(x)], dtype=torch.int64,
                     device=mesh_lib.collective_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return int(t.item())


def _gather_blocks(t: torch.Tensor) -> torch.Tensor:
    """All-gather equal-shape per-shard blocks (local db shards first on
    dim 0) in rank order, which is global shard order."""
    src = t.to(mesh_lib.collective_device()).contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, src)
    return torch.cat(parts).to(t.device)


def allgather_rows(rows: np.ndarray, width: int) -> np.ndarray:
    """Concatenate each process's (n_p, width) int32 rows across the
    cluster, in rank order: one max-reduce for the row count, then one
    padded, fixed-shape all-gather (the count rides in row 0)."""
    rows = np.asarray(rows, np.int32).reshape(-1, width)
    if process_count() == 1:
        return rows
    n = rows.shape[0]
    nmax = _allmax(n)
    buf = np.zeros((nmax + 1, width), np.int32)
    buf[0, 0] = n
    buf[1:n + 1] = rows
    g = _gather_blocks(torch.as_tensor(buf)[None]).cpu().numpy()
    return np.concatenate([g[p, 1:int(g[p, 0, 0]) + 1]
                           for p in range(g.shape[0])])


def _gather_for(mesh: mesh_lib.Mesh):
    return _gather_blocks if mesh.spans_processes else None


def build_lsh_index(local_rows: np.ndarray, n_total: int,
                    generator: torch.Generator, mesh: mesh_lib.Mesh,
                    config: motif.MotifSearchConfig
                    = motif.MotifSearchConfig(),
                    kmer_len: int | None = None
                    ) -> sharded.ShardedMotifIndex:
    """Per-process-shard LSH index from process-local rows."""
    km = put_local_rows(local_rows, n_total, mesh, kmer_len)
    return sharded.build_index_from_global(km, n_total, generator, mesh,
                                           config, reduce_max=_allmax)


def build_ivf_index(local_rows: np.ndarray, n_total: int,
                    generator: torch.Generator, mesh: mesh_lib.Mesh,
                    block_size: int = 32, max_hits: int = 256,
                    kmer_len: int | None = None
                    ) -> sharded.ShardedIVFIndex:
    """Per-process-shard IVF index from process-local rows."""
    km = put_local_rows(local_rows, n_total, mesh, kmer_len)
    return sharded.build_ivf_index_from_global(
        km, n_total, generator, mesh, block_size, max_hits,
        reduce_max=_allmax)


def build_lsh_index_streamed(row_chunks, n_total: int,
                             generator: torch.Generator,
                             mesh: mesh_lib.Mesh, kmer_len: int,
                             config: motif.MotifSearchConfig
                             = motif.MotifSearchConfig()
                             ) -> sharded.ShardedMotifIndex:
    """LSH index straight from a global-order row-chunk stream (host
    memory bounded by one shard; see put_rows_streamed)."""
    km = put_rows_streamed(row_chunks, n_total, mesh, kmer_len)
    return sharded.build_index_from_global(km, n_total, generator, mesh,
                                           config, reduce_max=_allmax)


def build_ivf_index_streamed(row_chunks, n_total: int,
                             generator: torch.Generator,
                             mesh: mesh_lib.Mesh, kmer_len: int,
                             block_size: int = 32, max_hits: int = 256
                             ) -> sharded.ShardedIVFIndex:
    """IVF index straight from a global-order row-chunk stream."""
    km = put_rows_streamed(row_chunks, n_total, mesh, kmer_len)
    return sharded.build_ivf_index_from_global(
        km, n_total, generator, mesh, block_size, max_hits,
        reduce_max=_allmax)


def search(index: sharded.ShardedMotifIndex, centers: np.ndarray,
           radius: float = 200.0, center_block: int = 128,
           stats_out: dict | None = None):
    """Cross-process LSH search; every process passes the same centers and
    receives the full merged hit set."""
    return sharded.search(index, centers, radius, center_block,
                          gather=_gather_for(index.mesh),
                          stats_out=stats_out)


def search_ivf(index: sharded.ShardedIVFIndex, centers: np.ndarray,
               radius: float, k_blocks: int = 64, center_block: int = 128,
               stats_out: dict | None = None):
    """Cross-process block-pruned exact search (the contract of search)."""
    return sharded.search_ivf(index, centers, radius, k_blocks,
                              center_block, gather=_gather_for(index.mesh),
                              stats_out=stats_out)
