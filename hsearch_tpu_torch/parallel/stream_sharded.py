"""Search a segmented index over the db axis of a device mesh, in waves
(counterpart of hsearch_tpu/parallel/stream_sharded.py).

The segmented engine (search/stream.py) holds an index larger than one
device in host memory, one segment at a time on the device; the sharded
engine (parallel/sharded.py) spreads one index over a mesh.  This module
composes them:

  * wave w places segment ``w*ndb + d`` on db shard ``d``: each shard's
    index is ``stream.upload_segment`` on the shard's device (the pinned
    copy and the on-device bounds pass), or the segment's resident copy
    when it already lives there;
  * the wave is one ``sharded.ShardedIVFIndex`` (shard d = segment d,
    n_local = the uniform segment size) searched by ``sharded.search_ivf``'s
    loop, so both kernels run per shard through ``ivf._search_block_hits``;
    a wave's ids are rebased by its first segment's offset, and its
    uploaded copies are freed before the next wave is placed;
  * the union over waves is the hit set.

Radius search decomposes exactly over any partition of the database, so
with ``num_segments <= ndb`` every segment sits on its own shard and the
search is one wave.  A ragged tail needs no sentinel remap and no dummy
blocks (the JAX package pads with both): a shard's real row count and the
verify kernel's ``order < n`` test already drop what is not a row.

Unlike the JAX function, overflow is counted and, by default, retried: the
centers whose live blocks exceed ``k_blocks`` on some shard, or whose hits
fill ``max_hits``, are searched again on the same wave with a 4x block cap
(2x hit cap), as ``ivf.search`` does, until none overflows, so the result
equals the exact oracle.
"""

from __future__ import annotations

import dataclasses
import time
import warnings

import numpy as np
import torch

from ..search import stream
from . import mesh as mesh_lib, sharded

DB = mesh_lib.DB_AXIS


def _canon(dev) -> torch.device:
    """A device with its CUDA index filled in, so that equal devices
    compare equal."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _check_layout(segs: list) -> int:
    """The uniform segment size; raises unless the segments are contiguous,
    each of that size but the last, which may be shorter."""
    sp = segs[0].n_points
    for i, s in enumerate(segs):
        last = i == len(segs) - 1
        if s.offset != segs[0].offset + i * sp or \
                (s.n_points > sp if last else s.n_points != sp):
            raise ValueError("segments must be contiguous with uniform size "
                             "but the last (build_segmented layout)")
    return sp


def _warn_memory(sidx: stream.SegmentedIVF, wave: list,
                 mesh: mesh_lib.Mesh) -> bool:
    """Warn (and return True) when a wave's uploads, with the search's
    reserve, do not fit some device's free memory."""
    need: dict = {}
    for d, i in enumerate(wave):
        seg = sidx.segments[i]
        res = sidx.resident[i] if i < len(sidx.resident) else None
        for dev in {_canon(row[d]) for row in mesh.devices}:
            if res is None or res.device != dev:
                need[dev] = (need.get(dev, 0)
                             + stream.segment_device_bytes(seg))
    reserve = max(stream.search_reserve_bytes(sidx.segments[i])
                  for i in wave) + stream._RESERVE_SLACK
    for dev, nbytes in need.items():
        free = stream.free_device_bytes(dev)
        if free is not None and nbytes + reserve > free:
            warnings.warn(
                f"a wave of {len(wave)} segments needs {nbytes / 1e9:.2f} GB "
                f"on {dev} beside a {reserve / 1e9:.2f} GB search reserve, "
                f"but {free / 1e9:.2f} GB are free; use a mesh with fewer db "
                "shards per device or smaller segments")
            return True
    return False


def _mark(devices) -> dict:
    """A timing event recorded on each CUDA device's current stream."""
    out = {}
    for d in devices:
        if d.type == "cuda":
            out[d] = torch.cuda.Event(enable_timing=True)
            out[d].record(torch.cuda.current_stream(d))
    return out


def _wave_index(sidx: stream.SegmentedIVF, wave: list, mesh: mesh_lib.Mesh,
                sp: int, max_hits: int) -> sharded.ShardedIVFIndex:
    """Segments ``wave`` (indexes into sidx.segments) -> a ShardedIVFIndex,
    shard d holding segment wave[d] (None past the wave's end)."""
    row0, n_real = [], []
    for d in range(mesh.shape[DB]):
        if d >= len(wave):
            row0.append(None)
            n_real.append(0)
            continue
        i = wave[d]
        seg = sidx.segments[i]
        dev = _canon(mesh.devices[0][d])
        res = sidx.resident[i] if i < len(sidx.resident) else None
        row0.append(res if res is not None and res.device == dev
                    else stream.upload_segment(seg, dev))
        n_real.append(seg.n_points)
    return sharded.ShardedIVFIndex(
        mesh=mesh, shards=sharded._replicas(row0, mesh, sharded._move_ivf),
        n_real=n_real, n_local=sp,
        n_points=(len(wave) - 1) * sp + sidx.segments[wave[-1]].n_points,
        blocks_per_shard=max(s.num_blocks for s in row0 if s is not None),
        max_hits=max_hits)


def _search_wave(widx: sharded.ShardedIVFIndex, centers: np.ndarray,
                 radius: float, k_blocks: int, center_block: int,
                 retry: bool, st: dict):
    """One wave's search with ``ivf.search``'s overflow ladder: the centers
    that overflowed are searched again at 4x the block cap (2x the hit
    cap when hits overflowed) and a 4x smaller center block.  ``st``
    accumulates the overflow counts left after the retries, the centers
    retried and the most live blocks."""
    ci, ki, dd, n_hits, n_alive = sharded._search_ivf_flags(
        widx, centers, radius, k_blocks, center_block)
    kb = min(k_blocks, widx.blocks_per_shard)
    over_b = n_alive > kb
    over_h = n_hits > widx.max_hits
    if n_alive.size:
        st["max_alive"] = max(st["max_alive"], int(n_alive.max()))
    redo = np.nonzero(over_b | over_h)[0]
    if retry and redo.size and (kb < widx.blocks_per_shard or over_h.any()):
        kb2 = min(4 * kb, widx.blocks_per_shard)
        grown = dataclasses.replace(
            widx, max_hits=2 * widx.max_hits if over_h.any()
            else widx.max_hits)
        st["retried"] += int(redo.size)
        rc, rk, rd = _search_wave(grown, centers[redo], radius, kb2,
                                  max(1, center_block * kb // kb2), True, st)
        keep = ~np.isin(ci, redo)
        return (np.concatenate([ci[keep], redo[rc]]),
                np.concatenate([ki[keep], rk]),
                np.concatenate([dd[keep], rd]).astype(np.float32))
    st["over_blocks"] += int(over_b.sum())
    st["over_hits"] += int(over_h.sum())
    return ci, ki, dd


def search_segmented_sharded(sidx: stream.SegmentedIVF, centers: np.ndarray,
                             radius: float,
                             mesh: mesh_lib.Mesh | None = None,
                             k_blocks: int = 64, max_hits: int = 256,
                             center_block: int = 128,
                             retry_overflow: bool = True,
                             stats_out: dict | None = None):
    """All (center, kmer) pairs within ``radius``, the segments placed over
    the mesh's db axis in waves.

    The global-id contract of ``stream.search_segmented``; ``k_blocks`` and
    ``max_hits`` apply per segment shard.  With ``retry_overflow`` (the
    default) overflowing centers are searched again until none overflows:
    the result is then exact.  ``stats_out`` receives ``waves``,
    ``segments``, ``db_shards``, the overflow counts left after any retry
    (``over_blocks``, ``over_hits``, summed over waves), ``max_alive``
    (the most over waves), ``retried`` and ``wave_upload_ms``, each wave's
    placement time (copies and bounds passes).  Without ``stats_out``
    overflows that remain are warned about.

    ``mesh`` defaults to every visible CUDA device on the db axis; a mesh
    that spans processes raises, as the JAX function is single-process
    too.  A wave whose uploads do not fit a device's free memory is warned
    about, not shrunk.
    """
    if mesh is None:
        mesh = mesh_lib.make_mesh(data=1)
    sharded._check_local(mesh)
    segs = sidx.segments
    sp = _check_layout(segs)
    ndb = mesh.shape[DB]
    centers = np.asarray(centers)
    devices = {_canon(d) for d in mesh.flat()}
    st = {"over_blocks": 0, "over_hits": 0, "retried": 0, "max_alive": 0}
    upload_ms = []
    out_c, out_k, out_d = [], [], []
    warned = False
    for w0 in range(0, len(segs), ndb):
        wave = list(range(w0, min(w0 + ndb, len(segs))))
        if not warned:
            warned = _warn_memory(sidx, wave, mesh)
        # the placement's time: CUDA events on each device (read once the
        # wave's results are on the host), the host clock on the CPU
        t0, start = time.perf_counter(), _mark(devices)
        widx = _wave_index(sidx, wave, mesh, sp, max_hits)
        host_ms, end = (time.perf_counter() - t0) * 1e3, _mark(devices)
        ci, ki, dd = _search_wave(widx, centers, radius, k_blocks,
                                  center_block, retry_overflow, st)
        del widx                     # the wave's uploaded copies go back
        upload_ms.append(max((start[d].elapsed_time(end[d]) for d in start),
                             default=host_ms))
        out_c.append(ci)
        out_k.append(ki + segs[w0].offset)
        out_d.append(dd)
    ci = np.concatenate(out_c) if out_c else np.empty(0, np.int64)
    ki = np.concatenate(out_k) if out_k else np.empty(0, np.int64)
    dd = np.concatenate(out_d) if out_d else np.empty(0, np.float32)
    if stats_out is not None:
        stats_out.update(st, waves=len(upload_ms), segments=len(segs),
                         db_shards=ndb, wave_upload_ms=upload_ms)
    else:
        if st["over_blocks"]:
            warnings.warn(f"{st['over_blocks']} centers had more than "
                          f"k_blocks={k_blocks} surviving blocks on some "
                          "segment shard; raise k_blocks or retry for "
                          "guaranteed-exact results")
        if st["over_hits"]:
            warnings.warn(f"{st['over_hits']} centers filled a segment "
                          f"shard's max_hits={max_hits} slots; nearest hits "
                          "kept")
    return ci, ki, dd
