"""Device meshes for sharded search and training (counterpart of
hsearch_tpu/parallel/mesh.py).

A mesh is a (data, db) grid of devices:

  * ``db``   — the database axis: the (N, L) k-mer matrix and each shard's
               index are partitioned along N; every db shard is searched
               on its own and the shards' verified hits are merged.
  * ``data`` — the query axis: center blocks are dealt over its rows, each
               row holding a replica of every db shard.

There is no ``shard_map`` here: a process loops over its own shards, and
each shard runs the single-device code on its device.  A device may
repeat (``["cpu"] * 8`` in the tests, four logical shards on one card),
which makes a mesh a partition of the work rather than of the hardware.
Across processes (parallel/multihost.py) each process holds only its own
db columns: ``db_first`` is the global index of its first column and
``shape["db"]`` counts the columns of every process.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
DB_AXIS = "db"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (data, db) grid of devices: this process's db columns."""

    devices: tuple            # (data, db_local) nested tuples of devices
    db_first: int = 0         # global db index of the first local column
    db_size: int | None = None   # db columns over all processes

    @property
    def shape(self) -> dict[str, int]:
        local = len(self.devices[0])
        return {DATA_AXIS: len(self.devices),
                DB_AXIS: local if self.db_size is None else self.db_size}

    @property
    def db_local(self) -> int:
        """db columns held by this process."""
        return len(self.devices[0])

    @property
    def spans_processes(self) -> bool:
        return self.shape[DB_AXIS] != self.db_local

    def flat(self) -> list[torch.device]:
        """Every device of the grid, row by row."""
        return [d for row in self.devices for d in row]


def collective_device() -> torch.device:
    """Where the tensors of a torch.distributed collective live: the
    rank's card under NCCL, the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _grid(devices, data: int) -> tuple:
    n = len(devices)
    return tuple(tuple(devices[i * (n // data):(i + 1) * (n // data)])
                 for i in range(data))


def cuda_devices() -> list[torch.device]:
    """Every visible CUDA device; raises when there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass devices= (for "
                           "instance ['cpu'] * 8) to run on the CPU")
    return [torch.device(f"cuda:{i}")
            for i in range(torch.cuda.device_count())]


def make_mesh(n_devices: int | None = None, data: int | None = None,
              devices=None) -> Mesh:
    """Build a (data, db) mesh over the first ``n_devices`` devices.

    ``devices`` defaults to every visible CUDA device.  ``data`` defaults
    to the largest power of two p with p*p <= n and n % p == 0, so both
    axes get parallelism; pass data=1 for a pure database-sharded mesh.
    """
    devices = cuda_devices() if devices is None \
        else [torch.device(d) for d in devices]
    if n_devices is None:
        n_devices = len(devices)
    devices = devices[:n_devices]
    if data is None:
        data = 1
        while (data * 2) ** 2 <= n_devices and n_devices % (data * 2) == 0:
            data *= 2
    if n_devices % data:
        raise ValueError(f"data axis {data} does not divide {n_devices}")
    return Mesh(_grid(devices, data))


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int = 0,
                    fill=0) -> tuple[np.ndarray, int]:
    """Pad ``x`` along ``axis`` to a multiple; returns (padded, n_pad)."""
    n = x.shape[axis]
    pad = (-n) % multiple
    if pad == 0:
        return x, 0
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return np.pad(x, widths, constant_values=fill), pad
