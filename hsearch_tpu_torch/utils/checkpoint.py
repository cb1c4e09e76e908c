"""Index serialization (counterpart of hsearch_tpu/utils/checkpoint.py).

The ``ivf`` kind only, in the JAX package's ``.npz`` format (arrays plus a
small json header), readable and writable with numpy alone — so an index
built by either package can be searched by the other.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from .. import _device
from ..search import ivf


def save_index(path: str, index: ivf.IVFIndex) -> None:
    """Serialize an IVFIndex to ``path`` (.npz, kind ``ivf``)."""
    if not isinstance(index, ivf.IVFIndex):
        raise TypeError(f"unknown index type {type(index)}")
    np.savez_compressed(
        path, __kind__="ivf",
        meta=json.dumps({"n_points": index.n_points,
                         "kmer_len": index.kmer_len}),
        db_sorted=index.db_sorted.cpu().numpy(),
        order=index.order.cpu().numpy(),
        block_centroid=index.block_centroid.cpu().numpy(),
        block_radius=index.block_radius.cpu().numpy())


def index_from_arrays(db_sorted: np.ndarray, order: np.ndarray,
                      block_centroid: np.ndarray, block_radius: np.ndarray,
                      n_points: int, kmer_len: int,
                      device: str | torch.device = "cuda") -> ivf.IVFIndex:
    """Build the port's IVFIndex from the index arrays as numpy (from either
    package's ``.npz`` or ``np.asarray`` of the JAX index's fields).

    db_sorted may be flat (B, bs*L) or the legacy rank-3 (B, bs, L); the
    host-side k-mer copy is rebuilt from the block layout.
    """
    dev = _device.resolve(device)
    ds = np.asarray(db_sorted, np.int8)
    if ds.ndim == 3:
        ds = ds.reshape(ds.shape[0], -1)
    order = np.asarray(order, np.int32)
    host_km = ivf.unsort_blocks(order, ds, n_points, kmer_len, np.int8)
    return ivf.IVFIndex(
        db_sorted=torch.as_tensor(ds, device=dev),
        order=torch.as_tensor(order, device=dev),
        block_centroid=torch.as_tensor(
            np.asarray(block_centroid, np.float32), device=dev),
        block_radius=torch.as_tensor(
            np.asarray(block_radius, np.float32), device=dev),
        n_points=int(n_points), host_kmers=host_km, kmer_len=int(kmer_len))


def load_index(path: str, device: str | torch.device = "cuda"
               ) -> ivf.IVFIndex:
    """Load an ``ivf``-kind index saved by either package onto ``device``."""
    z = np.load(path, allow_pickle=False)
    kind = str(z["__kind__"])
    if kind != "ivf":
        raise ValueError(f"index kind {kind!r} in {path} is not ported yet "
                         "(only 'ivf' loads)")
    meta = json.loads(str(z["meta"]))
    ds = z["db_sorted"]
    kmer_len = int(ds.shape[2]) if ds.ndim == 3 else int(meta["kmer_len"])
    return index_from_arrays(ds, z["order"], z["block_centroid"],
                             z["block_radius"], int(meta["n_points"]),
                             kmer_len, device)
