"""Index serialization (counterpart of hsearch_tpu/utils/checkpoint.py).

The ``ivf``, ``motif``, ``segivf`` and ``seed`` kinds, in the JAX
package's ``.npz`` format (arrays plus a small json header, with the same
field names), readable and writable with numpy alone — so an index built
by either package can be searched by the other.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from .. import _device
from ..align import seed_index
from ..search import ivf, motif, stream


def save_index(path: str, index) -> None:
    """Serialize an IVFIndex (kind ``ivf``), a MotifIndex (kind ``motif``),
    a SegmentedIVF (kind ``segivf``) or a SeedIndex (kind ``seed``) to
    ``path`` (.npz)."""
    if isinstance(index, stream.SegmentedIVF):
        # the host byte set is the checkpoint: per-segment rows and order
        # maps, uncompressed (the rows are high-entropy); the k-mers and
        # the bounds are derived at load and upload
        arrays = {}
        for i, s in enumerate(index.segments):
            arrays[f"seg{i}_db"] = s.db_sorted
            arrays[f"seg{i}_order"] = s.order
        np.savez(path, __kind__="segivf",
                 meta=json.dumps({
                     "n_points": index.n_points,
                     "kmer_len": index.kmer_len,
                     "block_size": index.block_size,
                     "segments": [{"offset": s.offset,
                                   "n_points": s.n_points}
                                  for s in index.segments]}),
                 **arrays)
    elif isinstance(index, motif.MotifIndex):
        np.savez_compressed(
            path, __kind__="motif",
            meta=json.dumps({"cand_max": index.cand_max,
                             "w": index.params.w,
                             "pack_bits": index.params.pack_bits}),
            a=index.params.a.cpu().numpy(), b=index.params.b.cpu().numpy(),
            sorted_codes=index.tables.sorted_codes.cpu().numpy(),
            perm=index.tables.perm.cpu().numpy(),
            # the JAX package keeps the padded k-mers as int32
            db_kmers=index.db_kmers.cpu().numpy().astype(np.int32))
    elif isinstance(index, ivf.IVFIndex):
        np.savez_compressed(
            path, __kind__="ivf",
            meta=json.dumps({"n_points": index.n_points,
                             "kmer_len": index.kmer_len}),
            db_sorted=index.db_sorted.cpu().numpy(),
            order=index.order.cpu().numpy(),
            block_centroid=index.block_centroid.cpu().numpy(),
            block_radius=index.block_radius.cpu().numpy())
    elif isinstance(index, seed_index.SeedIndex):
        # g10_at is derived at load; without group_starts a grouped index
        # would probe across group boundaries after the round trip
        extra = {} if index.group_starts is None \
            else {"group_starts": np.asarray(index.group_starts)}
        np.savez_compressed(
            path, __kind__="seed", meta=json.dumps({}),
            sorted_codes=np.asarray(index.sorted_codes),
            positions=np.asarray(index.positions),
            seq=np.asarray(index.seq), starts=np.asarray(index.starts),
            **extra)
    else:
        raise TypeError(f"unknown index type {type(index)}")


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


def peek(path: str) -> tuple[str, dict]:
    """(kind, json header) of a saved index, without reading its arrays."""
    with np.load(path, allow_pickle=False) as z:
        return str(z["__kind__"]), json.loads(str(z["meta"]))


def load_index(path: str, device_budget_bytes: int = 0,
               device: str | torch.device = "cuda"):
    """Load an ``ivf``, ``motif``, ``segivf`` or ``seed`` index saved by
    either package onto ``device``.

    A ``segivf`` index loads host-resident (page-locked on a CUDA device);
    ``device_budget_bytes`` re-pins its leading segments device-resident
    through ``stream.set_residency``.  The budget is ignored for the other
    kinds, which load whole onto the device.  A ``seed`` index is host
    numpy, as the aligner keeps it (``device`` is ignored), with its
    ``g10_at`` table rebuilt from the sequence."""
    z = np.load(path, allow_pickle=False)
    kind = str(z["__kind__"])
    meta = json.loads(str(z["meta"]))
    if kind == "seed":
        seq = np.asarray(z["seq"], np.int32)
        starts = np.asarray(z["starts"], np.int32)
        return seed_index.SeedIndex(
            sorted_codes=np.asarray(z["sorted_codes"]).astype(np.uint32),
            positions=np.asarray(z["positions"]).astype(np.int64),
            seq=seq, starts=starts,
            group_starts=np.asarray(z["group_starts"], np.int32)
            if "group_starts" in z else None,
            g10_at=seed_index.g10_table(seq, starts))
    if kind == "segivf":
        dev = _device.resolve(device)
        l = int(meta["kmer_len"])
        segs = [stream.host_segment_from_arrays(
                    z[f"seg{i}_db"], z[f"seg{i}_order"], int(sm["offset"]),
                    int(sm["n_points"]), l, pin=dev.type == "cuda")
                for i, sm in enumerate(meta["segments"])]
        sidx = stream.SegmentedIVF(
            segments=segs, n_points=int(meta["n_points"]), kmer_len=l,
            block_size=int(meta["block_size"]),
            resident=[None] * len(segs), device=dev)
        if device_budget_bytes:
            stream.set_residency(sidx, device_budget_bytes)
        return sidx
    if kind == "motif":
        return motif.index_from_arrays(
            z["a"], z["b"], float(meta["w"]), int(meta["pack_bits"]),
            z["sorted_codes"], z["perm"], z["db_kmers"],
            int(meta["cand_max"]), device)
    if kind != "ivf":
        raise ValueError(f"unknown index kind {kind!r} in {path}")
    ds = z["db_sorted"]
    kmer_len = int(ds.shape[2]) if ds.ndim == 3 else int(meta["kmer_len"])
    return index_from_arrays(ds, z["order"], z["block_centroid"],
                             z["block_radius"], int(meta["n_points"]),
                             kmer_len, device)
