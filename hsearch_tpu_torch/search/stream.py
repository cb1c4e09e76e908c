"""Search over an index larger than device memory (counterpart of
hsearch_tpu/search/stream.py).

The database is cut into segments, each an IVF index of its own
(``ivf.build_index`` at a segment size the card holds easily).  Radius
search decomposes exactly over any partition of the database, so the
per-segment exactness and overflow contracts compose into the global ones
by plain union.

  * Each segment lives in host memory as its minimal byte set: the
    block-sorted int8 rows and the int32 order map.  Block centroids and
    radii are not stored: they are recomputed on the device after each
    upload (``_recompute_bounds``: on the card one launch of the
    hand-written ``block_bounds`` kernel per segment, csrc/block_bounds.cu,
    with no host loop).
  * On a CUDA device the byte sets are page-locked once, when the index
    is built or loaded, so each upload is one DMA that needs no staging.
    A search copies segment i+1 on a side stream, and bounds it there,
    while segment i is searched on the current stream: the upload is
    queued once segment i's kernels are (``ivf.search``'s
    ``after_dispatch``), so the copy runs under them.  The current stream
    waits for the side stream only before it touches the segment, and
    the segment's tensors are recorded on the current stream so the
    caching allocator does not hand their memory out again while the
    search still reads it.
  * A device budget keeps the leading segments resident across calls:
    the trade between throughput and resident fraction is a dial, not a
    cliff.

The 9.9M-protein IGC corpus is about 2.4e9 ~ 2^31 all-position points
(hclust/src/hclust/protein.hpp:2-4).  A resident segment costs about
1.75 kB per block of 32 points on the card (rows, order map, f32
centroid and radius), so one 80 GB card holds about 2^29 points
resident; past that, streaming is forced.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
import warnings

import numpy as np
import torch

from .. import _device
from ..core import embedding
from ..ops import distance
from ..utils import profiling
from . import ivf


@dataclasses.dataclass
class HostSegment:
    """One segment's host-resident byte set (block-sorted order)."""

    offset: int                 # first global point id of this segment
    n_points: int
    kmer_len: int
    db_sorted: np.ndarray       # (B, bs*L) int8
    order: np.ndarray           # (B, bs) int32 segment-local ids
    host_kmers: np.ndarray      # (n, L) int8, original order
    # page-locked torch tensors whose memory db_sorted and order view,
    # when the index lives on a CUDA device; None on the CPU
    pinned: tuple[torch.Tensor, torch.Tensor] | None = None

    @property
    def nbytes(self) -> int:
        return self.db_sorted.nbytes + self.order.nbytes


@dataclasses.dataclass
class SegmentedIVF:
    """Host-resident segmented index + optional device-resident prefix."""

    segments: list[HostSegment]
    n_points: int
    kmer_len: int
    block_size: int
    # device copies of the resident prefix (aligned with ``segments``;
    # None = streamed on every search)
    resident: list = dataclasses.field(default_factory=list)
    device: torch.device = torch.device("cpu")

    @property
    def num_segments(self) -> int:
        return len(self.segments)

    def resident_fraction(self) -> float:
        res = sum(s.n_points for s, r in zip(self.segments, self.resident)
                  if r is not None)
        return res / max(self.n_points, 1)


def _recompute_bounds(db_flat: torch.Tensor, order: torch.Tensor, n: int,
                      l: int, bchunk: int = 4096):
    """(B, bs*L) int8 rows -> block centroids (B, 8L) f32 and radii (B,):
    the build's bounds (``ivf._block_bounds``), so a recomputed block is
    bitwise the built one.  On a CUDA device that is one launch of the
    ``block_bounds`` kernel per segment; on the CPU its plain version in
    chunks of ``bchunk`` blocks.  Blocks whose rows are all sentinels get
    radius -inf and centroid 0: they can never test alive.
    """
    if db_flat.shape[1] != order.shape[1] * l:
        raise ValueError(f"rows of {db_flat.shape[1]} bytes are not "
                         f"{order.shape[1]} k-mers of length {l}")
    return ivf._block_bounds(db_flat, order, n, bchunk)


def _pinned_like(x: torch.Tensor) -> torch.Tensor:
    return torch.empty(x.shape, dtype=x.dtype, pin_memory=True)


def _host_segment(db: torch.Tensor, order: torch.Tensor, offset: int,
                  n_points: int, kmer_len: int, host_kmers: np.ndarray,
                  pin: bool) -> HostSegment:
    """A HostSegment over host copies of ``db`` and ``order`` (page-locked
    when ``pin``; the numpy fields then view the pinned memory)."""
    if pin:
        db_h, order_h = _pinned_like(db), _pinned_like(order)
        db_h.copy_(db)
        order_h.copy_(order)
    else:
        db_h, order_h = db.cpu(), order.cpu()
    return HostSegment(offset=offset, n_points=n_points, kmer_len=kmer_len,
                       db_sorted=db_h.numpy(), order=order_h.numpy(),
                       host_kmers=host_kmers,
                       pinned=(db_h, order_h) if pin else None)


def _to_host_segment(index: ivf.IVFIndex, offset: int,
                     pin: bool) -> HostSegment:
    """Strip a freshly built index down to the host byte set: its rows and
    order map copied to the host (page-locked when ``pin``), its k-mers
    kept; the bounds are recomputed at upload."""
    return _host_segment(index.db_sorted, index.order, offset,
                         index.n_points, index.kmer_len, index.host_kmers,
                         pin)


def host_segment_from_arrays(db_sorted: np.ndarray, order: np.ndarray,
                             offset: int, n_points: int, kmer_len: int,
                             pin: bool) -> HostSegment:
    """A HostSegment from its byte set as numpy (a checkpoint's arrays);
    the k-mers in original order are rebuilt from the block layout."""
    db = torch.from_numpy(np.ascontiguousarray(db_sorted, np.int8))
    od = torch.from_numpy(np.ascontiguousarray(order, np.int32))
    km = ivf.unsort_blocks(od.numpy(), db.numpy(), n_points, kmer_len,
                           np.int8)
    return _host_segment(db, od, offset, n_points, kmer_len, km, pin)


def _h2d(host: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """One host->device copy on the current stream; asynchronous when
    ``host`` is page-locked."""
    return host.to(dev, non_blocking=host.is_pinned())


def upload_segment(seg: HostSegment, device: str | torch.device = "cuda",
                   stream: torch.cuda.Stream | None = None,
                   events: list | None = None) -> ivf.IVFIndex:
    """Host segment -> device IVFIndex: the copies and the bounds pass.

    On a CUDA device the work is queued on ``stream`` (default: the
    current stream) without a host synchronisation; a caller that passes
    another stream must make its consumer wait for it (``wait_stream``)
    and record the tensors on the consumer's stream.  ``events``, when
    given, receives one (start, end) pair of CUDA events around the
    copies.  On the CPU the index's tensors view the host arrays.
    """
    dev = _device.resolve(device)
    if dev.type == "cpu":
        db = torch.from_numpy(seg.db_sorted)
        order = torch.from_numpy(seg.order)
        cent, rad = _recompute_bounds(db, order, seg.n_points, seg.kmer_len)
    else:
        db_h, order_h = seg.pinned if seg.pinned is not None else (
            torch.from_numpy(seg.db_sorted), torch.from_numpy(seg.order))
        # the constant table is made on the current stream, not the side
        # stream, so no other stream can read it before it exists
        distance.const("coords", dev)
        ctx = torch.cuda.stream(stream) if stream is not None \
            else contextlib.nullcontext()
        with ctx:
            if events is not None:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
            db = _h2d(db_h, dev)
            order = _h2d(order_h, dev)
            if events is not None:
                end.record()
                events.append((start, end))
            cent, rad = _recompute_bounds(db, order, seg.n_points,
                                          seg.kmer_len)
    return ivf.IVFIndex(db_sorted=db, order=order, block_centroid=cent,
                        block_radius=rad, n_points=seg.n_points,
                        host_kmers=seg.host_kmers, kmer_len=seg.kmer_len)


def segment_device_bytes(seg: HostSegment) -> int:
    """Device bytes of one resident segment: the int8 rows, the int32
    order map and the recomputed f32 centroids and radii (the card pads
    no lanes, unlike the TPU)."""
    b, bsl = seg.db_sorted.shape
    bs = seg.order.shape[1]
    d = seg.kmer_len * embedding.AA_DIM
    return b * bsl + b * bs * 4 + b * d * 4 + b * 4


# center block whose prune key matrix the residency reserve covers (the
# CLI's and chip_smoke's largest), and slack for the bounds pass and the
# verify's output
_RESERVE_CENTER_BLOCK = 1024
_RESERVE_SLACK = 512 << 20


def search_reserve_bytes(seg: HostSegment) -> int:
    """Device bytes a search of ``seg`` needs beside the segment itself:
    the prune's (center_block, Bp) f32 keys and group minima at
    ``_RESERVE_CENTER_BLOCK``."""
    bp = -(-seg.db_sorted.shape[0] // ivf._SELECT_GROUP) * ivf._SELECT_GROUP
    return 4 * _RESERVE_CENTER_BLOCK * (bp + bp // ivf._SELECT_GROUP)


def free_device_bytes(device: str | torch.device | None = None) -> int | None:
    """Free memory on a CUDA device, counting what PyTorch's caching
    allocator holds reserved but unallocated as free; None on the CPU."""
    dev = torch.device(device) if device is not None else None
    if dev is None or dev.type != "cuda":
        return None
    free, _ = torch.cuda.mem_get_info(dev)
    return int(free + torch.cuda.memory_reserved(dev)
               - torch.cuda.memory_allocated(dev))


def clamp_device_budget(budget: int, segments: list[HostSegment],
                        device: str | torch.device | None = None) -> int:
    """Clamp a residency budget so the resident segments, two streamed
    double-buffer slots, the prune keys of the largest segment at center
    block 1024 and a fixed slack fit the free device memory.

    The clamp only moves segments from resident to streamed: it changes
    how fast a search runs, never what it returns.  It warns when it
    bites."""
    if budget <= 0 or not segments:
        return max(budget, 0)
    free = free_device_bytes(device)
    if free is None:
        return budget
    reserve = (2 * max(segment_device_bytes(s) for s in segments)
               + max(search_reserve_bytes(s) for s in segments)
               + _RESERVE_SLACK)
    allowed = max(free - reserve, 0)
    if budget > allowed:
        warnings.warn(
            f"device residency budget {budget / 1e9:.2f} GB exceeds free "
            f"device memory minus the streaming and search reserve "
            f"({allowed / 1e9:.2f} GB usable of {free / 1e9:.2f} GB free); "
            "clamping: more segments will stream instead")
        return allowed
    return budget


def set_residency(sidx: SegmentedIVF, device_budget_bytes: int) -> None:
    """(Re)pin leading segments device-resident under a clamped budget.

    Drops the current resident copies first, then uploads segments in
    order until the budget is spent: how a checkpoint-loaded index (fully
    host-resident) gets its resident prefix back."""
    sidx.resident = [None] * len(sidx.segments)
    budget = clamp_device_budget(device_budget_bytes, sidx.segments,
                                 sidx.device)
    for i, seg in enumerate(sidx.segments):
        cost = segment_device_bytes(seg)
        if budget < cost:
            break
        sidx.resident[i] = upload_segment(seg, sidx.device)
        budget -= cost


def build_segmented(db_kmers, generator: torch.Generator,
                    segment_points: int = 1 << 22, block_size: int = 32,
                    device_budget_bytes: int = 0, progress=None,
                    device: str | torch.device = "cuda") -> SegmentedIVF:
    """Build a segmented index from an (N, L) array or an iterator of row
    chunks (at most one segment of rows is buffered beyond the segments'
    byte sets).

    Each segment is ``ivf.build_index`` with a seed drawn from
    ``generator`` (a CPU torch.Generator), so the same seed gives the same
    index from an array and from any chunking of it.  Leading segments
    keep their device copy while ``device_budget_bytes`` lasts (clamped
    against free device memory once the first segment's size is known);
    the device copy of every other segment is freed.  ``progress(i,
    points_so_far)`` is called after each segment.
    """
    dev = _device.resolve(device)
    pin = dev.type == "cuda"
    if hasattr(db_kmers, "shape"):
        n_total = db_kmers.shape[0]
        chunks = (db_kmers[s:s + segment_points]
                  for s in range(0, n_total, segment_points))
    else:
        chunks = iter(db_kmers)
    segments: list[HostSegment] = []
    resident: list = []
    budget = device_budget_bytes
    offset = 0
    kmer_len = None
    buf: list[np.ndarray] = []
    buffered = 0

    def flush(rows):
        nonlocal offset, budget, kmer_len
        kmer_len = rows.shape[1]
        seed = int(torch.randint(0, 2 ** 62, (), generator=generator))
        sub = ivf.build_index(rows, torch.Generator().manual_seed(seed),
                              block_size=block_size, device=dev)
        seg = _to_host_segment(sub, offset, pin)
        if not segments:
            budget = clamp_device_budget(budget, [seg], dev)
        segments.append(seg)
        cost = segment_device_bytes(seg)
        if budget >= cost:
            resident.append(sub)
            budget -= cost
        else:
            resident.append(None)
        del sub
        offset += seg.n_points
        if progress is not None:
            progress(len(segments), offset)

    for chunk in chunks:
        chunk = np.asarray(chunk, np.int8)
        buf.append(chunk)
        buffered += len(chunk)
        while buffered >= segment_points:
            rows = np.concatenate(buf) if len(buf) > 1 else buf[0]
            flush(rows[:segment_points])
            rest = rows[segment_points:]
            buf = [rest] if len(rest) else []
            buffered = len(rest)
    if buffered:
        flush(np.concatenate(buf) if len(buf) > 1 else buf[0])
    if not segments:
        raise ValueError("empty database")
    return SegmentedIVF(segments=segments, n_points=offset,
                        kmer_len=kmer_len, block_size=block_size,
                        resident=resident, device=dev)


def _adopt(index: ivf.IVFIndex, stream: torch.cuda.Stream) -> None:
    """Record a side-stream upload's tensors on ``stream``, where they are
    read, so their memory is not reused before that stream's work ends."""
    for t in (index.db_sorted, index.order, index.block_centroid,
              index.block_radius):
        t.record_stream(stream)


def _timed_wait(main: torch.cuda.Stream, side: torch.cuda.Stream):
    """``main.wait_stream(side)`` between two timing events recorded on
    ``main``: their elapsed time is how long ``main`` stalled on ``side``
    (read once both have run; recording them never synchronises)."""
    pair = (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))
    pair[0].record(main)
    main.wait_stream(side)
    pair[1].record(main)
    return pair


@profiling.spanned("stream.search_segmented")
def search_segmented(sidx: SegmentedIVF, centers: np.ndarray,
                     radius: float, k_blocks: int = 64,
                     max_hits: int = 256, center_block: int = 256,
                     retry_overflow: bool = True,
                     stats_out: dict | None = None,
                     pack_cap_frac: int = 4, h2d_events: list | None = None):
    """All (center, kmer) pairs within ``radius`` across every segment.

    The contract of ``ivf.search``, with global point ids: a radius hit
    set is the union of the per-segment hit sets, and each segment runs
    the whole engine including the lossless retry ladder.  The
    ``k_blocks`` cap applies per segment.  Streamed segments are double
    buffered (see the module docstring).  ``stats_out`` receives the
    summed overflow counts, ``max_alive``, ``segments``,
    ``resident_fraction``, the per-segment search walls ``seg_walls_s``,
    the summed ``d2h_bytes``, ``h2d_bytes``, ``host_d2_hits``,
    ``host_d2_native_hits``, ``graph_captures`` and ``graph_replays`` (0:
    segments run their center blocks eagerly, ``ivf.keep_eager``) of
    the segments' searches
    (``h2d_bytes`` with each streamed segment's upload) and, while a
    ``torch.profiler`` trace records on a CUDA device, ``upload_wait_ms``:
    the device time the current stream stalled on the uploads, from CUDA
    events read after the last result came back.
    ``h2d_events``, when given on a CUDA device, receives (segment, start,
    end) CUDA events around each streamed segment's copies.

    In a recording trace the call is the span ``stream.search_segmented``:
    per segment ``stream.segment`` around its ``ivf.search``, per
    streamed segment ``stream.upload`` (queueing its copies and bounds
    pass) and, on a CUDA device, ``stream.adopt`` (the wait for it).
    """
    dev = sidx.device
    cuda = dev.type == "cuda"
    main = torch.cuda.current_stream(dev) if cuda else None
    side = torch.cuda.Stream(dev) if cuda else None
    uploaded = 0                      # bytes of the streamed segments

    def fetch(i):
        nonlocal uploaded
        if sidx.resident[i] is not None:
            return sidx.resident[i]
        with profiling.span("stream.upload"):
            ev = [] if h2d_events is not None and cuda else None
            up = upload_segment(sidx.segments[i], dev, stream=side,
                                events=ev)
        if ev:
            h2d_events.append((i, *ev[0]))
        uploaded += sidx.segments[i].nbytes
        return up

    out_c, out_k, out_d = [], [], []
    seg_stats: list[dict] = []
    seg_walls: list[float] = []
    waits: list = []                  # (before, after) CUDA event pairs
    pending = None
    for i, seg in enumerate(sidx.segments):
        cur = pending if pending is not None else fetch(i)
        pending = None
        if cuda and sidx.resident[i] is None:
            # before the next upload is queued on the side stream: waiting
            # later would also wait for that upload
            with profiling.span("stream.adopt"):
                if stats_out is not None and profiling.recording():
                    waits.append(_timed_wait(main, side))
                else:
                    main.wait_stream(side)
                _adopt(cur, main)
        nxt: list = []

        def queue_next(i=i, nxt=nxt):
            # called by ivf.search once this segment's kernels are queued,
            # so the next copy and bounds pass run under them
            if i + 1 < len(sidx.segments):
                nxt.append(fetch(i + 1))

        st: dict = {}
        with profiling.span("stream.segment"):
            t0 = time.perf_counter()
            # the residency budget plans no CUDA graph pool per segment
            ci, ki, dd = ivf.search(
                ivf.keep_eager(cur), centers, radius, k_blocks=k_blocks,
                max_hits=max_hits, center_block=center_block,
                retry_overflow=retry_overflow, stats_out=st,
                pack_cap_frac=pack_cap_frac, after_dispatch=queue_next)
            seg_walls.append(round(time.perf_counter() - t0, 3))
        pending = nxt[0] if nxt else None
        seg_stats.append(st)
        out_c.append(ci)
        out_k.append(ki + seg.offset)
        out_d.append(dd)
        del cur                       # a streamed copy's memory goes back
    ci = np.concatenate(out_c) if out_c else np.empty(0, np.int64)
    ki = np.concatenate(out_k) if out_k else np.empty(0, np.int64)
    dd = np.concatenate(out_d) if out_d else np.empty(0, np.float32)
    if stats_out is not None:
        for k in ("over_blocks", "over_hits", "retried", "d2h_bytes",
                  "h2d_bytes", "host_d2_hits", "host_d2_native_hits",
                  "graph_captures", "graph_replays"):
            stats_out[k] = sum(s.get(k, 0) for s in seg_stats)
        stats_out["h2d_bytes"] += uploaded
        stats_out["max_alive"] = max(
            (s.get("max_alive", 0) for s in seg_stats), default=0)
        stats_out["segments"] = len(seg_stats)
        stats_out["resident_fraction"] = sidx.resident_fraction()
        stats_out["seg_walls_s"] = seg_walls
        if waits:
            # every event is behind a result already read back: no stall
            waits[-1][1].synchronize()
            stats_out["upload_wait_ms"] = sum(a.elapsed_time(b)
                                              for a, b in waits)
    return ci, ki, dd
