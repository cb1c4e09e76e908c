"""Batched seed-extend: seed scoring, greedy exact extension, x-drop
ungapped extension (counterpart of hsearch_tpu/align/extend.py).

The reference extends one candidate at a time in scalar loops
(hash_search.cpp:528-588 seed+greedy, AlignFwd/AlignBwd :661-716).  Here a
batch of (query-pos, subject-pos) seed pairs extends in lock-step, as
PyTorch ops on the device of the inputs, in int32 and bitwise equal to the
JAX package:

  * ``extend_pairs_windowed``: every lane's residues gathered once into a
    seed-centred window, all five phases dense prefix scans over it; valid
    while every extension fits the window (the pipeline uses it on the
    CPU when the longest indexed protein is at most 512 residues);
  * ``extend_pairs`` / ``extend_pairs_packed``: the chunked form for any
    length, each phase a host loop of CHUNK-residue steps that ends once
    every lane is done (the JAX package's ``lax.while_loop``); the plain
    version of the ``extend_pairs`` kernel.

On the card the pipeline runs neither: ``ops/cuda_kernels.extend_pairs``
(csrc/extend_pairs.cu) extends each lane with a warp, 32 residues a
step, the chunked form's algorithm at that chunk width, for every
protein length and with no host synchronisation.

Semantics (parity with the reference):
  * the seed score adds full BLOSUM62 over the 10-residue local seed
    (hash_search.cpp:551-558); match counts exact residue equality;
  * greedy extension continues while the murphy10 *group* ids match
    (:564-586) but scores with full BLOSUM62;
  * x-drop: s < MINSCORE(-20) or s < max - drop stops the scan; the
    stopping element is still accumulated, the best prefix wins
    (:661-716);
  * unknown residues score NEGSCORE=-5 (paras.hpp:8) and never "match".

Every sum and scan names ``dtype=torch.int32`` (torch widens integer sums
to int64 otherwise); argmax/argmin return the first index on ties, over
int tensors (CUDA's argmax refuses bool).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import blosum
from . import reduced

CHUNK = 64
MINSCORE = -20        # paras.hpp:13
NEGSCORE = -5         # paras.hpp:8

# 21x21 substitution matrix: row/col 20 = unknown residue, scored -5.
_SUB = np.full((21, 21), NEGSCORE, np.int32)
_SUB[:20, :20] = blosum.BLOSUM62
# murphy10 group per AA index; unknown -> 10
_GROUP = np.concatenate([reduced.MURPHY10.astype(np.int32), [10]])

# the result fields the batched pipeline consumes, in pack order
PACK_KEYS = ("score", "match", "gate_score", "gate_match",
             "q_beg", "q_end", "d_beg", "d_end")

# sentinel score of out-of-window columns: summed over up to 1024 columns
# it stays inside int32, as in the JAX package
_BIG = 10 ** 6


def _tables(device: torch.device):
    """(flattened 21x21 substitution table, group table) on ``device``."""
    return (torch.as_tensor(_SUB.reshape(-1), device=device),
            torch.as_tensor(_GROUP, device=device))


def _sub(sub_flat: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """sub[a, b] for AA index tensors (0..20)."""
    return sub_flat[a.long() * 21 + b.long()]


def _codes(seq: torch.Tensor, grp_t: torch.Tensor):
    """seq (S,) AA indices (>= 20 unknown) -> (aa21, group) int32."""
    aa = seq.to(torch.int32).clamp(max=20)
    return aa, grp_t[aa.long()]


def _first_true(x: torch.Tensor) -> torch.Tensor:
    """Per row: index of the first True (0 when none), as int32."""
    return torch.argmax(x.to(torch.int32), dim=1).to(torch.int32)


def _first_false(x: torch.Tensor) -> torch.Tensor:
    """Per row: index of the first False (0 when none), as int32."""
    return torch.argmin(x.to(torch.int32), dim=1).to(torch.int32)


def _window(arr: torch.Tensor, base: torch.Tensor, sign: int):
    """A CHUNK window per lane: arr[clip(base + sign*i)], i in [0, CHUNK)."""
    offs = torch.arange(CHUNK, dtype=torch.int32, device=base.device)
    idx = base[:, None] + sign * offs[None, :]
    return arr[idx.long().clamp(0, arr.shape[0] - 1)]


def seed_scores(qaa, daa, qpos, dpos, seed_len: int):
    """Initial seed score/match over ``seed_len`` residues
    (hash_search.cpp:551-558).  Positions must be in range."""
    sub_flat, _ = _tables(qaa.device)
    offs = torch.arange(seed_len, dtype=torch.int64, device=qaa.device)
    qi = qaa[qpos.long()[:, None] + offs[None, :]]
    di = daa[dpos.long()[:, None] + offs[None, :]]
    score = _sub(sub_flat, qi, di).sum(dim=1, dtype=torch.int32)
    match = ((qi == di) & (qi < 20)).sum(dim=1, dtype=torch.int32)
    return score, match


def _greedy_phase(qaa, qgrp, daa, dgrp, qstart, dstart, limit, sign):
    """Greedy extension while murphy10 groups are equal.

    qstart/dstart: first position to test; limit: residues available in
    this direction (>= 0).  Returns (ext, score_delta, match_delta)."""
    sub_flat, _ = _tables(qaa.device)
    b = qstart.shape[0]
    offs = torch.arange(CHUNK, dtype=torch.int32, device=qaa.device)
    z = torch.zeros(b, dtype=torch.int32, device=qaa.device)
    ext, score, match = z, z, z
    done = torch.zeros(b, dtype=torch.bool, device=qaa.device)
    while not bool(done.all()):
        qw = _window(qaa, qstart + sign * ext, sign)
        dw = _window(daa, dstart + sign * ext, sign)
        qg = _window(qgrp, qstart + sign * ext, sign)
        dg = _window(dgrp, dstart + sign * ext, sign)
        in_range = (ext[:, None] + offs[None, :]) < limit[:, None]
        eq = in_range & (qg == dg) & (qg < 10)
        run = torch.where(eq.all(dim=1), CHUNK, _first_false(eq))
        run = torch.where(done, 0, run).to(torch.int32)
        sel = offs[None, :] < run[:, None]
        score = score + torch.where(sel, _sub(sub_flat, qw, dw), 0) \
            .sum(dim=1, dtype=torch.int32)
        match = match + (sel & (qw == dw) & (qw < 20)) \
            .sum(dim=1, dtype=torch.int32)
        ext = ext + run
        done = done | (run < CHUNK)
    return ext, score, match


def _xdrop_phase(qaa, daa, qstart, dstart, limit, score0, drop, sign):
    """X-drop ungapped extension (AlignFwd/AlignBwd,
    hash_search.cpp:661-716).  Returns (maxs - score0, best_ext,
    best_match)."""
    sub_flat, _ = _tables(qaa.device)
    b = qstart.shape[0]
    neg_inf = -(10 ** 6)
    offs = torch.arange(CHUNK, dtype=torch.int32, device=qaa.device)
    z = torch.zeros(b, dtype=torch.int32, device=qaa.device)
    l_tot, s, maxs = z, score0, score0
    best_ext, best_match, match_tot = z, z, z
    done = score0 < MINSCORE
    while not bool(done.all()):
        qw = _window(qaa, qstart + sign * l_tot, sign)
        dw = _window(daa, dstart + sign * l_tot, sign)
        in_range = (l_tot[:, None] + offs[None, :]) < limit[:, None]
        subs = torch.where(in_range, _sub(sub_flat, qw, dw), neg_inf)
        s_i = s[:, None] + torch.cumsum(subs, dim=1, dtype=torch.int32)
        rm_i = torch.maximum(maxs[:, None], torch.cummax(s_i, dim=1).values)
        viol = (s_i < MINSCORE) | (s_i < rm_i - drop)
        any_viol = viol.any(dim=1)
        t = torch.where(any_viol, _first_true(viol), CHUNK - 1)
        processed = torch.where(done, 0, t + 1).to(torch.int32)
        sel = offs[None, :] < processed[:, None]
        s_sel = torch.where(sel, s_i, neg_inf)
        chunk_max = s_sel.amax(dim=1)
        improved = chunk_max > maxs
        arg = torch.argmax(s_sel, dim=1)                    # first max
        match_i = torch.cumsum(((qw == dw) & (qw < 20) & in_range)
                               .to(torch.int32), dim=1, dtype=torch.int32)
        new_best_ext = l_tot + arg.to(torch.int32) + 1
        new_best_match = match_tot + torch.gather(
            match_i, 1, arg[:, None])[:, 0]
        best_ext = torch.where(improved, new_best_ext, best_ext)
        best_match = torch.where(improved, new_best_match, best_match)
        maxs = torch.maximum(maxs, chunk_max)
        last_at = (processed - 1).clamp(min=0).long()[:, None]
        s = torch.where(processed > 0, torch.gather(s_i, 1, last_at)[:, 0],
                        s)
        match_tot = match_tot + torch.where(
            processed > 0, torch.gather(match_i, 1, last_at)[:, 0], 0)
        l_tot = l_tot + processed
        done = done | any_viol | (processed == 0)
    return maxs - score0, best_ext, best_match


def extend_pairs(qseq, dseq, qpos, dpos, qlo, qhi, dlo, dhi, drop: int,
                 seed_len: int = 10):
    """Full extension of a batch of seed pairs.

    qseq/dseq: (Sq,), (Sd,) AA-index tensors (>= 20 unknown); qpos/dpos:
    (B,) seed start positions; qlo/qhi, dlo/dhi: (B,) sequence bounds
    [lo, hi); drop: x-drop threshold (UngapExtDrop, raw score).

    Returns a dict of (B,) int32 tensors: score, match, gate_score,
    gate_match, q_beg, q_end, d_beg, d_end (end exclusive), seed_q,
    seed_d, seed_span (hash_search.cpp:593-659, ungapped path)."""
    _, grp_t = _tables(qseq.device)
    qpos, dpos, qlo, qhi, dlo, dhi = (x.to(torch.int32) for x in
                                      (qpos, dpos, qlo, qhi, dlo, dhi))
    qaa, qgrp = _codes(qseq, grp_t)
    daa, dgrp = _codes(dseq, grp_t)
    score, match = seed_scores(qaa, daa, qpos, dpos, seed_len)

    # greedy forward from the seed end (hash_search.cpp:559-573)
    fwd_limit = torch.minimum(qhi - (qpos + seed_len),
                              dhi - (dpos + seed_len))
    gf_ext, gf_s, gf_m = _greedy_phase(
        qaa, qgrp, daa, dgrp, qpos + seed_len, dpos + seed_len,
        fwd_limit.clamp(min=0), +1)
    # greedy backward from seed start - 1 (:574-588)
    bwd_limit = torch.minimum(qpos - qlo, dpos - dlo)
    gb_ext, gb_s, gb_m = _greedy_phase(
        qaa, qgrp, daa, dgrp, qpos - 1, dpos - 1, bwd_limit.clamp(min=0), -1)

    score = score + gf_s + gb_s
    match = match + gf_m + gb_m
    local = seed_len + gf_ext + gb_ext          # unLocalCopy after greedy
    q_seed = qpos - gb_ext                      # moved seed begin
    d_seed = dpos - gb_ext

    # x-drop forward from the greedy-extended region end (:609-635)
    xf_limit = torch.minimum(qhi - (q_seed + local), dhi - (d_seed + local))
    xf_s, xf_ext, xf_m = _xdrop_phase(
        qaa, daa, q_seed + local, d_seed + local, xf_limit.clamp(min=0),
        score, drop, +1)
    # x-drop backward from the region start - 1 (:637-650)
    xb_limit = torch.minimum(q_seed - qlo, d_seed - dlo)
    xb_s, xb_ext, xb_m = _xdrop_phase(
        qaa, daa, q_seed - 1, d_seed - 1, xb_limit.clamp(min=0), score,
        drop, -1)

    # the reference gates on the post-greedy, pre-x-drop score and match
    # (hash_search.cpp:593)
    return dict(
        score=score + xf_s + xb_s, match=match + xf_m + xb_m,
        gate_score=score, gate_match=match,
        q_beg=q_seed - xb_ext, q_end=q_seed + local + xf_ext,
        d_beg=d_seed - xb_ext, d_end=d_seed + local + xf_ext,
        seed_q=q_seed, seed_d=d_seed, seed_span=local)


def extend_pairs_packed(qseq, dseq, inputs, drop: int,
                        seed_len: int = 10) -> torch.Tensor:
    """``extend_pairs`` on ONE (6, B) int32 input of rows (qpos, dpos,
    qlo, qhi, dlo, dhi), returning ONE (8, B) int32 stack of PACK_KEYS."""
    r = extend_pairs(qseq, dseq, *(inputs[i] for i in range(6)), drop,
                     seed_len)
    return torch.stack([r[k] for k in PACK_KEYS])


def _lead_run(ok: torch.Tensor):
    """Per lane: the length of the leading all-True run along dim 1, and
    the 0/1 mask of that run."""
    lead = torch.cumprod(ok.to(torch.int32), dim=1, dtype=torch.int32)
    return lead.sum(dim=1, dtype=torch.int32), lead


def _xdrop_dense(subs, match, score0, origin, drop: int):
    """Dense x-drop from per-lane ``origin`` columns over precomputed
    ``subs``/``match`` rows; mirrors ``_xdrop_phase`` exactly.  Returns
    (score_delta, ext, match_ct)."""
    w = subs.shape[1]
    col = torch.arange(w, dtype=torch.int32, device=subs.device)[None, :]
    on = col >= origin[:, None]
    s = score0[:, None] + torch.cumsum(torch.where(on, subs, 0), dim=1,
                                       dtype=torch.int32)
    # the running max is seeded with score0, as the chunked form's maxs
    m = torch.maximum(torch.cummax(torch.where(on, s, -_BIG), dim=1).values,
                      score0[:, None])
    viol = on & ((s < MINSCORE) | (s < m - drop))
    t = torch.where(viol.any(dim=1), _first_true(viol), w - 1)
    cand = on & (col <= t[:, None])
    s_cand = torch.where(cand, s, -_BIG)
    best = s_cand.amax(dim=1)
    arg = torch.argmax(s_cand, dim=1)                    # first max
    improved = (best > score0) & (score0 >= MINSCORE)
    pm = torch.cumsum(torch.where(on, match, 0), dim=1, dtype=torch.int32)
    ext = torch.where(improved, arg.to(torch.int32) - origin + 1, 0)
    mct = torch.where(improved, torch.gather(pm, 1, arg[:, None])[:, 0], 0)
    delta = torch.where(improved, best - score0, 0)
    return (delta.to(torch.int32), ext.to(torch.int32),
            mct.to(torch.int32))


def extend_pairs_windowed(qseq, dseq, inputs, drop: int, seed_len: int = 10,
                          win_pre: int = 128,
                          win_post: int = 144) -> torch.Tensor:
    """Window-dense twin of ``extend_pairs_packed``: every lane's residues
    are gathered once into a seed-centred (B, win_pre + win_post) window
    and all five phases run as dense prefix scans over it.  Ungapped
    extension advances query and subject in lock-step, so one column axis
    serves both sequences (column j = seed offset j - win_pre).

    Valid only when every lane's extension is window-contained:
    qpos - qlo <= win_pre, dpos - dlo <= win_pre, qhi - qpos and
    dhi - dpos <= win_post.  Bitwise equal to ``extend_pairs_packed``
    there."""
    qpos, dpos, qlo, qhi, dlo, dhi = (inputs[i].to(torch.int32)
                                      for i in range(6))
    sub_flat, grp_t = _tables(qseq.device)
    w = win_pre + win_post
    col = torch.arange(w, dtype=torch.int32, device=qseq.device)[None, :]
    qidx = qpos[:, None] + (col - win_pre)
    didx = dpos[:, None] + (col - win_pre)
    valid = (qidx >= qlo[:, None]) & (qidx < qhi[:, None]) \
        & (didx >= dlo[:, None]) & (didx < dhi[:, None])
    qaa = qseq[qidx.long().clamp(0, qseq.shape[0] - 1)].to(torch.int32) \
        .clamp(max=20)
    daa = dseq[didx.long().clamp(0, dseq.shape[0] - 1)].to(torch.int32) \
        .clamp(max=20)
    sub_qd = _sub(sub_flat, qaa, daa)
    subs = torch.where(valid, sub_qd, -_BIG)
    match = (valid & (qaa == daa) & (qaa < 20)).to(torch.int32)
    ge = valid & (grp_t[qaa.long()] == grp_t[daa.long()]) \
        & (grp_t[qaa.long()] < 10)

    p = win_pre
    # seed score over columns [p, p + seed_len)
    sc = slice(p, p + seed_len)
    score = torch.where(valid[:, sc], sub_qd[:, sc], NEGSCORE) \
        .sum(dim=1, dtype=torch.int32)
    match0 = match[:, sc].sum(dim=1, dtype=torch.int32)

    # greedy forward over columns >= p + seed_len
    gf, leadf = _lead_run(ge[:, p + seed_len:])
    score = score + (subs[:, p + seed_len:] * leadf).sum(dim=1,
                                                        dtype=torch.int32)
    match0 = match0 + (match[:, p + seed_len:] * leadf).sum(
        dim=1, dtype=torch.int32)
    # greedy backward over columns < p, scanned right to left
    gb, leadb = _lead_run(torch.flip(ge[:, :p], dims=[1]))
    score = score + (torch.flip(subs[:, :p], dims=[1]) * leadb).sum(
        dim=1, dtype=torch.int32)
    match0 = match0 + (torch.flip(match[:, :p], dims=[1]) * leadb).sum(
        dim=1, dtype=torch.int32)

    gate_score, gate_match = score, match0
    e_f = p + seed_len + gf          # first un-consumed forward column
    e_b = p - gb                     # first consumed column

    xf_s, xf_ext, xf_m = _xdrop_dense(subs, match, score, e_f, drop)
    xb_s, xb_ext, xb_m = _xdrop_dense(torch.flip(subs, dims=[1]),
                                      torch.flip(match, dims=[1]),
                                      score, w - e_b, drop)
    qbase = qpos - win_pre
    dbase = dpos - win_pre
    r = dict(score=score + xf_s + xb_s, match=match0 + xf_m + xb_m,
             gate_score=gate_score, gate_match=gate_match,
             q_beg=qbase + e_b - xb_ext, q_end=qbase + e_f + xf_ext,
             d_beg=dbase + e_b - xb_ext, d_end=dbase + e_f + xf_ext)
    return torch.stack([r[k].to(torch.int32) for k in PACK_KEYS])
