"""Batched banded affine-gap alignment scores on the device (counterpart
of hsearch_tpu/align/gapped_device.py).

The score-only companion of the host traceback aligner
(``hostops.align_gapped``).  ``banded_scores_plain`` is one loop over
query rows, each row a vectorized update of the 2*band+1 diagonal lanes
across all pairs at once (the JAX package's ``lax.scan``; about 20
PyTorch ops per row, int32 and bitwise equal to it).  ``banded_scores``
takes it for CPU tensors and runs the whole scan as one launch of the
``banded_scores`` CUDA kernel (csrc/banded_scores.cu, one warp per pair)
for CUDA tensors, bitwise equal.

The row recurrence has an intra-row dependency (E, the gap-in-query
chain).  With affine penalties and gap_open >= gap_ext, a gap opened from
an E-derived cell never beats extending the original gap, so E resolves
in one vectorized pass with the rescaling trick:

    E[jj] = max_{k<jj} (A[k] - go - (jj-1-k) ge)
          = cummax(A[k] - go + k*ge)[jj-1] - (jj-1) ge

where A = max(diagonal, F) is the E-independent part.  The x-drop row
abandonment uses the end-of-row best, identical to the reference's
running-best check (any lane that raises the best is within drop of it).
"""

from __future__ import annotations

import torch

from ..ops import cuda_kernels

NEG = -(1 << 28)


def banded_scores(q: torch.Tensor, qlen: torch.Tensor, d: torch.Tensor,
                  dlen: torch.Tensor, sub21: torch.Tensor, gap_open: int,
                  gap_ext: int, drop: int, band: int):
    """(P, Lq), (P,), (P, Ld), (P,) -> (score, q_ext, d_ext) per pair, on
    the device of ``q``: ``banded_scores_plain`` on the CPU, one launch
    of the CUDA kernel on the card (``cuda_kernels.banded_scores``)."""
    return cuda_kernels.banded_scores(q, qlen, d, dlen, sub21, gap_open,
                                      gap_ext, drop, band)


def banded_scores_plain(q: torch.Tensor, qlen: torch.Tensor,
                        d: torch.Tensor, dlen: torch.Tensor,
                        sub21: torch.Tensor, gap_open: int, gap_ext: int,
                        drop: int, band: int, stats_out: dict | None = None):
    """(P, Lq), (P,), (P, Ld), (P,) -> (score, q_ext, d_ext) per pair, on
    the device of ``q``, as a host loop over the query rows.

    Matches the traceback aligner's score and extents (requires
    gap_open >= gap_ext >= 0, true of the BLAST 11/1 defaults): global
    alignment from (0, 0) within the diagonal band |j - i| <= band, a gap
    of length g costs open + (g-1)*ext, best cell floored at 0,
    first-best in row-major order, x-drop row abandonment for rows
    i > 1.  Sequences hold AA indices 0..20 (20 = unknown); rows and
    columns beyond qlen/dlen are inactive.

    ``stats_out`` receives ``rows``: per pair, the rows that can still
    change its result (i <= qlen and not yet dead), which is where the
    kernel stops scanning."""
    dev = q.device
    p, lq = q.shape
    w = 2 * band + 1
    lanes = torch.arange(w, dtype=torch.int32, device=dev)
    go, ge = int(gap_open), int(gap_ext)
    dead_lim = NEG // 2
    qlen = qlen.to(torch.int32)
    dlen = dlen.to(torch.int32)
    sub_flat = sub21.to(torch.int32).reshape(-1)
    q = q.to(torch.int64)

    # row 0: d-gaps from the origin on lanes jj >= band (j = jj - band)
    j0 = (lanes[None, :] - band).expand(p, w)
    h0 = torch.where(j0 == 0, 0, -(go + (j0 - 1) * ge)).to(torch.int32)
    h0 = torch.where((j0 >= 0) & (j0 <= dlen[:, None]), h0, NEG)
    f0 = torch.full((p, w), NEG, dtype=torch.int32, device=dev)

    d_pad = torch.cat([d.to(torch.int64),
                       torch.full((p, 1), 20, dtype=torch.int64,
                                  device=dev)], dim=1)
    d_max = d_pad.shape[1] - 1
    rescale = lanes * ge                                      # (w,)
    # (jj-1)*ge for the de-rescaling; lane 0 is masked anyway
    descale = (rescale - ge).clamp(min=0)
    neg_col = torch.full((p, 1), NEG, dtype=torch.int32, device=dev)
    lane_pos = lanes[None, :] > 0

    h_prev, f_prev = h0, f0
    best = torch.zeros(p, dtype=torch.int32, device=dev)
    bi = torch.zeros(p, dtype=torch.int32, device=dev)
    bj = torch.full((p,), -band, dtype=torch.int32, device=dev)
    dead = torch.zeros(p, dtype=torch.bool, device=dev)
    rows = torch.zeros(p, dtype=torch.int32, device=dev)
    for i in range(1, lq + 1):
        if stats_out is not None:
            rows += (~dead) & (i <= qlen)
        j = (i - band) + lanes[None, :]                       # (1, w)
        in_band = (j >= 0) & (j <= dlen[:, None])
        # F: gap in d, from (i-1, jj+1)
        h_up = torch.cat([h_prev[:, 1:], neg_col], dim=1)
        f_up = torch.cat([f_prev[:, 1:], neg_col], dim=1)
        f = torch.maximum(h_up - go, f_up - ge).clamp(min=NEG)
        # diagonal from (i-1, jj): needs j > 0 and a live predecessor
        dc = torch.gather(d_pad, 1, (j - 1).clamp(0, d_max).long()
                          .expand(p, w))
        s = sub_flat[q[:, i - 1:i] * 21 + dc]
        diag = torch.where((j > 0) & (h_prev > dead_lim), h_prev + s, NEG)
        a = torch.where(in_band, torch.maximum(diag, f), NEG)
        # E: gap in q, intra-row chain via rescaled exclusive cummax
        m = (a - go).clamp(min=NEG) + rescale[None, :]
        pm = torch.cummax(m, dim=1).values
        e = torch.cat([neg_col, pm[:, :-1]], dim=1) - descale[None, :]
        e = torch.where(lane_pos & (j > 0), e, NEG).clamp(min=NEG)
        h = torch.maximum(a, e)
        h = torch.where(in_band & (i <= qlen)[:, None], h, NEG)
        # best update: strictly greater, row-major first occurrence
        rmax = h.amax(dim=1)
        rarg = torch.argmax(h, dim=1).to(torch.int32)
        upd = (~dead) & (rmax > best)
        best = torch.where(upd, rmax, best)
        bi = torch.where(upd, i, bi)
        bj = torch.where(upd, (i - band) + rarg, bj)
        alive = (h >= best[:, None] - drop).any(dim=1)
        if i > 1:
            dead = dead | ~alive
        h_prev, f_prev = h, f
    if stats_out is not None:
        stats_out["rows"] = rows
    return best, bi, bj
