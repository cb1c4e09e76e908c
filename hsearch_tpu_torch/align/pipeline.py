"""Protein search pipeline: seed index -> batched extension -> statistics
-> ranked hits with m8/aln output (counterpart of
hsearch_tpu/align/pipeline.py).

CHashSearch::ProteinSearching / Searching / ExtendSeq2Set / CalRes /
SumEvalue / PrintRes (hash_search.cpp:263-1308): seed probing is a ragged
pass (the C++ host library, or torch ops on a CUDA device), the extension
runs batched on the device, and hit bookkeeping, Karlin-Altschul
statistics and output stay on the host (they run once per query over a
few dozen survivors).  Every ``Hit`` field equals the JAX
package's on the same inputs.

Reference quirks intentionally not reproduced (SURVEY §7):
  * the debug ``cout << "xx"`` in the hot path (hash_search.cpp:456);
  * the ``1848 * nFac`` subject-coordinate offset for duplicated names
    (:1155-1160);
  * two *different* unknown residues comparing as a "match" (:34).
"""

from __future__ import annotations

import dataclasses
import time
import warnings

import numpy as np
import torch

from .. import _device, native_ext
from ..core import alphabet, blosum
from ..ops import cuda_kernels
from ..utils import profiling
from . import blast_stat, extend, gapped_device, hostops, seed_index

SUMHSP_OVERLAP = 10       # paras.hpp:15
# residue budget per bulk string-render pass (_render_strings_all);
# module-level so tests can shrink it to exercise the multi-chunk path
_RENDER_CHUNK = 1 << 24


@dataclasses.dataclass(frozen=True)
class SearchParams:
    """pcluster.cpp:113-119 defaults."""

    evalue_threshold: float = 10.0    # dThr
    max_aln_per_query: int = 100      # nMaxAlnPer
    max_m8_per_query: int = 500       # nMaxHitPer
    min_length: int = 0               # nMinLen
    cand_max: int = 256               # per-probe candidate cap (device)
    pair_batch: int = 8192            # extension lanes per device call
    collapse_runs: int = 6            # seed-run collapse tolerance (0=off)
    probe_chunk: int = 1 << 24        # query RESIDUES per host-codes
                                      # chunk: bounds the per-chunk seed
                                      # code/validity arrays (~14 B per
                                      # residue)
    pair_budget: int = 1 << 26        # capped raw CANDIDATES per probe
                                      # slice (measured per position
                                      # from the index's bucket sizes):
                                      # bounds the raw (rows, dpos)
                                      # arrays and everything downstream
                                      # of one slice


def _as_int64(a: np.ndarray) -> np.ndarray:
    """uint32 codes or uint64 keys (all below 2^63) as int64 values."""
    a = np.ascontiguousarray(a)
    return a.view(np.int64) if a.dtype == np.uint64 else a.astype(np.int64)


class _LocalIds:
    """global protein id -> local row, dict-compatible surface.

    A 9.9M-entry {int: int} dict held ~1 GB of pointer-boxed ints and
    cost a hash probe per lookup; one int32 inverse array is 40 MB and
    vectorizes (used by the fromiter walks in _render_strings_all)."""

    __slots__ = ("inv",)

    def __init__(self, ids: np.ndarray):
        n = int(ids.max()) + 1 if len(ids) else 0
        self.inv = np.full(n, -1, np.int32)
        self.inv[ids] = np.arange(len(ids), dtype=np.int32)

    def __getitem__(self, gid) -> int:
        gid = int(gid)
        v = int(self.inv[gid]) if 0 <= gid < len(self.inv) else -1
        if v < 0:
            raise KeyError(gid)
        return v

    def get(self, gid, default=None):
        gid = int(gid)
        v = int(self.inv[gid]) if 0 <= gid < len(self.inv) else -1
        return default if v < 0 else v


@dataclasses.dataclass
class Hit:
    """One reported alignment (CHitUnit fields, hit_unit.hpp:6-34)."""

    query: int
    subject: int
    score: int
    bits: float
    evalue: float
    identity: float
    aln_len: int
    mismatch: int
    gap_open: int
    q_beg: int          # 1-based inclusive
    q_end: int
    d_beg: int
    d_end: int
    q_aln: str = ""
    d_aln: str = ""
    info: str = ""


class ProteinSearcher:
    """Seed-extend search of query proteins against a protein DB.

    db: object with ``names`` (list), ``seq`` (concatenated AA indices)
    and ``starts`` ((P+1,) offsets) — core.io.ProteinDB.

    groups: optional (len(subset),) dense group id per indexed protein.
    When set, ONE searcher batches many independent pre-cluster groups:
    seed probes stay group-local (group-partitioned seed index) and
    every query is scored under ITS group's Karlin-Altschul statistics
    (the reference builds BlastStat per group, hash_search.hpp:256) —
    the batched replacement for a fresh per-bucket index
    (pcluster.cpp:157-167).

    device: where the extension runs (default ``"cuda"``; ``"cpu"`` must
    be asked for).  The index build runs in the C++ host library
    (``native_ext``) and assembly in numpy; the seed probe and pair
    preparation run in the library on the CPU and as their torch twins on
    a CUDA device.
    """

    def __init__(self, db, params: SearchParams = SearchParams(),
                 subset: np.ndarray | None = None,
                 groups: np.ndarray | None = None,
                 device: str | torch.device = "cuda"):
        _t0 = time.perf_counter()
        self.device = _device.resolve(device)
        self.db = db
        self.params = params
        self.subset = subset
        if subset is None:
            seq, starts, self.ids = np.asarray(db.seq), \
                np.asarray(db.starts), np.arange(len(db.names))
        else:
            # compact the subset into its own concatenated array
            # (BuildProteinsIndex indexes only the group's proteins,
            # hash_search.cpp:164-261) — one vectorized gather; the
            # per-protein Python loop cost minutes at 1e6 proteins
            self.ids = np.asarray(subset)
            dstarts = np.asarray(db.starts)
            lens = (dstarts[self.ids + 1] - dstarts[self.ids]) \
                .astype(np.int64)
            total = int(lens.sum())
            starts = np.concatenate([[0], np.cumsum(lens)])
            # chunked gather: the one-shot vectorized form allocated
            # three total-size int64 temporaries (~29 GB at 1.19B aa,
            # part of the 9.9M-protein OOM); per-chunk temporaries are
            # bounded while the copy stays vectorized
            seq = np.empty(total, np.int32)
            src = np.asarray(db.seq)
            step = 1 << 20
            for lo in range(0, len(self.ids), step):
                ids_c = self.ids[lo:lo + step]
                lens_c = lens[lo:lo + step]
                tot_c = int(lens_c.sum())
                if not tot_c:
                    continue
                first_c = np.cumsum(lens_c) - lens_c
                offs = np.arange(tot_c, dtype=np.int64) \
                    - np.repeat(first_c, lens_c)
                base = int(starts[lo])
                seq[base:base + tot_c] = src[
                    np.repeat(dstarts[ids_c], lens_c) + offs]
        self.seq = np.asarray(seq, np.int32)
        self.starts = np.asarray(starts, np.int64)
        self.groups = None if groups is None else np.asarray(groups)
        # host probe view: the seed probe runs as a ragged host pass,
        # O(candidates) instead of a mostly empty (Q, cand_max) slab
        self.index, self._hview = seed_index.build_index_and_view(
            self.seq, self.starts, protein_groups=self.groups)
        # the concatenated residues on the device: queries and subjects
        # of the batched extension both index into it
        self._seq_dev = torch.as_tensor(self.seq, device=self.device)
        # on a CUDA device search_all's probe and pair preparation run
        # there too (hostops' torch twins of the host passes, which
        # dominated a run on the host)
        self._probe_dev = None
        if self.device.type == "cuda":
            self._upload_probe_view()
        # longest indexed protein, rounded up to a 64-grid: decides the
        # extension form (window-dense when every extension fits a
        # bounded window; chunked otherwise)
        lens = self.starts[1:] - self.starts[:-1]
        self._max_prot = int(lens.max()) if len(lens) else 0
        self._win = -(-max(self._max_prot, 1) // 64) * 64
        # global id -> local row, O(1) per lookup
        self._local_of = _LocalIds(self.ids)
        total_aa = int(self.starts[-1])
        self.stat = blast_stat.BlastStat(float(total_aa), len(self.ids),
                                         gapped=True)
        self._group_stats: dict[int, blast_stat.BlastStat] = {}
        self._stats_by_shape: dict[tuple, blast_stat.BlastStat] = {}
        self._group_counts = None      # lazy bincounts (stat_for_local)
        self._group_aa = None
        self.cutoffs = blast_stat.DEFAULT_CUTOFFS
        # seed pairs the batched search_all has extended so far
        self.pairs_extended = 0
        profiling.add("align/index_build", time.perf_counter() - _t0)

    def stat_for_local(self, local: int) -> blast_stat.BlastStat:
        """The statistics context of a local query row: its group's when
        group-partitioned, the whole DB's otherwise."""
        if self.groups is None:
            return self.stat
        g = int(self.groups[local])
        st = self._group_stats.get(g)
        if st is None:
            if self._group_counts is None:
                # one O(S) pass for every group's count and AA total
                # (a per-group == scan was O(G*S) across search_all)
                lens = (self.starts[1:] - self.starts[:-1]).astype(
                    np.float64)
                self._group_counts = np.bincount(self.groups)
                self._group_aa = np.bincount(self.groups, weights=lens)
            # groups with equal (aa, seqs) share identical statistics —
            # BlastStat's <1000 length-adjustment precompute is ~8 ms,
            # and family corpora repeat group shapes thousands of times
            sig = (float(self._group_aa[g]), int(self._group_counts[g]))
            st = self._stats_by_shape.get(sig)
            if st is None:
                st = blast_stat.BlastStat(sig[0], sig[1], gapped=True)
                self._stats_by_shape[sig] = st
            self._group_stats[g] = st
        return st

    def stat_for_global(self, global_id: int) -> blast_stat.BlastStat:
        local = self._local_of.get(int(global_id))
        return self.stat if local is None else self.stat_for_local(local)

    # -- internals --------------------------------------------------------
    def _pairs_for_query(self, qseq: np.ndarray, group: int | None = None):
        """All (qpos, dpos) candidate seed pairs for one query sequence."""
        if self.groups is not None and group is None:
            raise ValueError(
                "this searcher is group-partitioned; queries must name "
                "their group (search_sequence(group=...) or search_all)")
        # host ragged probe: only the full-suffix probe code matters —
        # the truncated PAD variants match exclusively subjects with
        # < 10 residues after the seed, which the SEED_LEN filter below
        # discards anyway (the reference also skips them,
        # hash_search.cpp:538-540)
        true_len = len(qseq)
        code, _, valid10, qgrp10 = seed_index.host_codes(
            np.asarray(qseq, np.int32), np.array([0, true_len]))
        qidx = np.nonzero(valid10)[0]
        qgroups = None
        if self.groups is not None:
            n_groups = len(np.asarray(self.index.group_starts)) - 1
            if not 0 <= group < n_groups:
                raise ValueError(
                    f"group id out of range [0, {n_groups}): {group}")
            qgroups = np.full(len(qidx), group, np.int64)
        rows, dpos, n_over = seed_index.probe_host(
            self._hview, code[qidx], qgrp10[qidx],
            self.params.cand_max, qgroups=qgroups)
        if n_over:
            warnings.warn(
                f"{n_over} seed buckets exceeded cand_max="
                f"{self.params.cand_max}; raise SearchParams.cand_max to "
                "extend every candidate of low-complexity seeds")
        qpos = qidx[rows]
        if dpos.size == 0:
            return qpos.astype(np.int64), dpos.astype(np.int64)
        # drop subjects without the full 10-residue local seed
        # (hash_search.cpp:538-540); pairs arrive (qpos, dpos)-sorted and
        # duplicate-free from the single-probe ragged pass
        pid = native_ext.searchsorted_right(self.starts, dpos) - 1
        ok = self.starts[pid + 1] - dpos >= seed_index.SEED_LEN
        qpos, dpos = qpos[ok], dpos[ok]
        if self.params.collapse_runs and len(qpos):
            dpid2 = native_ext.searchsorted_right(self.starts, dpos) - 1
            keep = hostops.collapse_diag_runs(
                qpos, dpos, np.zeros(len(qpos), np.int64), dpid2,
                self.params.collapse_runs, argsort=native_ext.argsort_u64)
            qpos, dpos = qpos[keep], dpos[keep]
        return qpos, dpos

    def _extend(self, qseq: np.ndarray, qpos: np.ndarray, dpos: np.ndarray):
        """Batched device extension of one query's seed pairs (the
        ``extend_pairs`` kernel on the card, the chunked form on the CPU);
        returns a host dict of result arrays."""
        p = self.params
        # floor + strict compare reproduces the reference's float test:
        # continue while deficit <= 8.938 <=> integer deficit <= 8
        drop = int(self.cutoffs.ungap_ext_drop)
        pid = native_ext.searchsorted_right(self.starts, dpos) - 1
        dev = self.device
        bounds = np.stack([qpos, dpos, np.zeros_like(qpos),
                           np.full_like(qpos, len(qseq)), self.starts[pid],
                           self.starts[pid + 1]]).astype(np.int32)
        inputs = torch.as_tensor(bounds, device=dev)
        qdev = torch.as_tensor(np.asarray(qseq, np.int32), device=dev)
        parts = [cuda_kernels.extend_pairs(
                     qdev, self._seq_dev, inputs[:, s:s + p.pair_batch],
                     drop, seed_index.SEED_LEN)
                 for s in range(0, qpos.shape[0], p.pair_batch)]
        arr = torch.cat(parts, dim=1).cpu().numpy() if parts \
            else np.zeros((len(extend.PACK_KEYS), 0), np.int32)
        return ({k: arr[i] for i, k in enumerate(extend.PACK_KEYS)}, pid)

    def _assemble(self, query_idx: int, qseq: np.ndarray, res, subj,
                  stat: blast_stat.BlastStat | None = None):
        """CalRes + SumEvalue + ranking (hash_search.cpp:950-1273).

        Gates, e-values, and extent dedup run vectorized over every
        candidate at once; aligned strings are rendered only for the hits
        actually returned.
        """
        cut = self.cutoffs
        st = stat if stat is not None else self.stat
        st.set_query(len(qseq))
        keep = (res["gate_score"] >= cut.ungap_ext_cut) & \
               (res["gate_match"] >= cut.min_match_for_expect)
        idx = np.nonzero(keep)[0]
        if idx.size == 0:
            return []
        score = np.asarray(res["score"])[idx].astype(np.int64)
        ev = st.raw_to_expect_vec(score)
        ok = ~((score < 30)
               & (ev > self.params.evalue_threshold))  # SUMHSP gate (:971)
        idx, score, ev = idx[ok], score[ok], ev[ok]
        if idx.size == 0:
            return []
        qb = np.asarray(res["q_beg"])[idx].astype(np.int64)
        qe = np.asarray(res["q_end"])[idx].astype(np.int64)
        dbg = np.asarray(res["d_beg"])[idx].astype(np.int64)
        de = np.asarray(res["d_end"])[idx].astype(np.int64)
        sj = np.asarray(subj)[idx].astype(np.int64)
        match = np.asarray(res["match"])[idx].astype(np.int64)
        # dedup identical (subject, extents), keeping the lowest e-value
        # (the reference's best[] replacement rule, :1040-1060)
        order = np.lexsort((ev, de, dbg, qe, qb, sj))
        kk = np.stack([sj, qb, qe, dbg, de], axis=1)[order]
        first = np.concatenate([[True], (kk[1:] != kk[:-1]).any(axis=1)])
        sel = order[first]
        bits = st.raw_to_bits_vec(score[sel])
        aln_len = qe[sel] - qb[sel]
        dlo = self.starts[sj[sel]]
        hits = [Hit(query=query_idx, subject=int(self.ids[s_]),
                    score=int(sc_), bits=float(b_), evalue=float(e_),
                    identity=m_ * 100.0 / max(al_, 1), aln_len=int(al_),
                    mismatch=int(al_ - m_), gap_open=0,
                    q_beg=int(q0_) + 1, q_end=int(q1_),
                    d_beg=int(d0_ - l_) + 1, d_end=int(d1_ - l_))
                for s_, sc_, b_, e_, m_, al_, q0_, q1_, d0_, d1_, l_
                in zip(sj[sel], score[sel], bits, ev[sel], match[sel],
                       aln_len, qb[sel], qe[sel], dbg[sel], de[sel], dlo)]
        hits.sort(key=lambda h: (h.subject, h.evalue))
        return self._finalize_query_hits(hits, st, qseq)

    def _finalize_query_hits(self, hits: list[Hit],
                             st: blast_stat.BlastStat,
                             qseq: np.ndarray,
                             render: bool = True) -> list[Hit]:
        """Per-subject SumEvalue walk (:1199-1273), threshold, e-value
        ranking, truncation, and aligned strings for ONE query's
        (subject, evalue)-sorted hits — shared by _assemble and
        _assemble_all so the two paths cannot drift.  render=False
        defers the aligned strings to the caller's bulk pass
        (_render_strings_all)."""
        out: list[Hit] = []
        i = 0
        while i < len(hits):
            j = i
            while j < len(hits) and hits[j].subject == hits[i].subject:
                j += 1
            group = hits[i:j]
            if len(group) > 1:
                group = self._sum_evalue(group, st)
            out.extend(group)
            i = j
        out = [h for h in out if h.evalue <= self.params.evalue_threshold]
        out.sort(key=lambda h: h.evalue)
        out = out[:max(self.params.max_m8_per_query,
                       self.params.max_aln_per_query)]
        if not render:
            return out
        # aligned strings only for the survivors
        for h in out:
            lo = int(self.starts[self._local_of[h.subject]])
            qi = np.asarray(qseq[h.q_beg - 1:h.q_end])
            di = np.asarray(self.seq[lo + h.d_beg - 1:lo + h.d_end])
            h.q_aln = _decode_bytes(qi).decode()
            h.d_aln = _decode_bytes(di).decode()
            h.info = _info_from_ints(qi, di)
        return out

    def _render_strings_all(self, hits: list[Hit]) -> None:
        """Aligned strings + match lines for every (ungapped, in-db-query)
        hit in ONE vectorized pass over the concatenated residues —
        per-hit rendering measured ~45 us/hit of small-array overheads
        (~4 s of a 1e4-protein tables=4 run)."""
        if not hits:
            return
        n = len(hits)
        ln = np.fromiter((h.aln_len for h in hits), np.int64, n)
        lq = np.fromiter((self._local_of[h.query] for h in hits),
                         np.int64, n)
        ld = np.fromiter((self._local_of[h.subject] for h in hits),
                         np.int64, n)
        qb = np.fromiter((h.q_beg for h in hits), np.int64, n)
        db_ = np.fromiter((h.d_beg for h in hits), np.int64, n)
        qlo = self.starts[lq] + qb - 1
        dlo = self.starts[ld] + db_ - 1
        # chunked over ~16M residues (_RENDER_CHUNK): the index arrays
        # amplify each rendered residue ~16x in int64 temporaries, so
        # one all-corpus-hits pass can reach tens of GB on
        # dense-homology corpora — chunking keeps the vectorized win
        # with bounded memory (a few hundred MB per pass)
        bound = np.searchsorted(np.cumsum(ln), np.arange(
            0, int(ln.sum()) + 1, _RENDER_CHUNK)[1:], side="left") + 1
        start = 0
        for stop in np.unique(np.append(bound, n)):
            stop = int(min(stop, n))
            if stop <= start:
                continue
            sl = slice(start, stop)
            lns = ln[sl]
            total = int(lns.sum())
            first = np.cumsum(lns) - lns
            offs = np.arange(total, dtype=np.int64) \
                - np.repeat(first, lns)
            qi = self.seq[np.repeat(qlo[sl], lns) + offs]
            di = self.seq[np.repeat(dlo[sl], lns) + offs]
            qbuf, dbuf, ibuf = _decode_bytes(qi), _decode_bytes(di), \
                _info_bytes(qi, di)
            for i in range(stop - start):
                a, b = int(first[i]), int(first[i] + lns[i])
                h = hits[start + i]
                h.q_aln = qbuf[a:b].decode()
                h.d_aln = dbuf[a:b].decode()
                h.info = ibuf[a:b].decode()
            start = stop

    def _assemble_all(self, query_local: np.ndarray, res, dpid,
                      render: bool = True):
        """Batched CalRes over every query's pairs at once.

        The gates, e-values, extent dedup, and rank orders are one
        vector pass (the per-query _assemble re-ran the same small ops
        ~120k times at 3e4 proteins, ~25% of cluster_proteins); Hit
        construction, SumEvalue, and the aligned strings stay per
        query.  λ/K/gap-decay are constants of the gapped parameter
        set, so only the per-query effective lengths (e_query_len,
        e_db_len) vary — gathered per pair below.  Kept behaviorally
        identical to _assemble: tests assert batched == per-query."""
        cut = self.cutoffs
        p = self.params
        keep = (res["gate_score"] >= cut.ungap_ext_cut) & \
               (res["gate_match"] >= cut.min_match_for_expect)
        idx = np.nonzero(keep)[0]
        if idx.size == 0:
            return []
        ql = query_local[idx]
        score = np.asarray(res["score"])[idx].astype(np.int64)
        qlen = self.starts[1:] - self.starts[:-1]
        nloc = len(self.ids)
        eq = np.zeros(nloc)
        ed = np.zeros(nloc)
        stats: dict[int, blast_stat.BlastStat] = {}
        for u in np.unique(ql):
            st = self.stat_for_local(int(u)) if self.groups is not None \
                else self.stat
            st.set_query(int(qlen[u]))
            eq[u], ed[u] = st.e_query_len, st.e_db_len
            stats[int(u)] = st
        st0 = self.stat
        ev = st0.K * ed[ql] * eq[ql] \
            * np.exp(-st0.L * score.astype(np.float64)) \
            / (1.0 - st0.gap_decay_rate)
        ok = ~((score < 30)
               & (ev > p.evalue_threshold))        # SUMHSP gate (:971)
        idx, ql, score, ev = idx[ok], ql[ok], score[ok], ev[ok]
        if idx.size == 0:
            return []
        qb = np.asarray(res["q_beg"])[idx].astype(np.int64) \
            - self.starts[ql]
        qe = np.asarray(res["q_end"])[idx].astype(np.int64) \
            - self.starts[ql]
        dbg = np.asarray(res["d_beg"])[idx].astype(np.int64)
        de = np.asarray(res["d_end"])[idx].astype(np.int64)
        sj = np.asarray(dpid)[idx].astype(np.int64)
        match = np.asarray(res["match"])[idx].astype(np.int64)
        # dedup identical (query, subject, extents), lowest e-value first
        order = np.lexsort((ev, de, dbg, qe, qb, sj, ql))
        kk = np.stack([ql, sj, qb, qe, dbg, de], axis=1)[order]
        first = np.concatenate([[True], (kk[1:] != kk[:-1]).any(axis=1)])
        sel = order[first]
        # final walk order: query, then GLOBAL subject id, then ascending
        # e-value (the reference's per-subject best-first rule; _assemble
        # sorts on global ids, and subset order is caller-chosen, so
        # sorting local rows would change equal-e-value tie order)
        gid_of = np.asarray(self.ids)
        o2 = sel[np.lexsort((ev[sel], gid_of[sj[sel]], ql[sel]))]
        ql, sj, score, ev = ql[o2], sj[o2], score[o2], ev[o2]
        qb, qe, dbg, de, match = qb[o2], qe[o2], dbg[o2], de[o2], match[o2]
        bits = st0.raw_to_bits_vec(score)   # λ/logK shared across stats
        aln_len = qe - qb
        dlo = self.starts[sj]
        gid_q = gid_of[ql]
        gid_s = gid_of[sj]

        def make_hits(rows: np.ndarray) -> list[Hit]:
            if len(rows) == 0:
                return []
            z = [a[rows].tolist() for a in
                 (gid_q, gid_s, score, bits, ev, match, aln_len,
                  qb, qe, dbg, de, dlo)]
            return [Hit(query=g, subject=s_, score=sc, bits=b_,
                        evalue=e_, identity=m_ * 100.0 / max(al_, 1),
                        aln_len=al_, mismatch=al_ - m_, gap_open=0,
                        q_beg=q0 + 1, q_end=q1,
                        d_beg=d0 - l_ + 1, d_end=d1 - l_)
                    for g, s_, sc, b_, e_, m_, al_, q0, q1, d0, d1, l_
                    in zip(*z)]

        # (query, subject) multi-HSP groups need the per-query SumEvalue
        # walk; every other query (the overwhelming majority after
        # diag-run collapsing) finalizes vectorized — threshold,
        # per-query e-value order, cap.  The per-query walk constructed
        # Hit objects for every deduped pair BEFORE thresholding and
        # looped Python per query (~1/4 of the assemble stage at 1e5).
        # Stable sorts keep _finalize_query_hits' tie order: its
        # list.sort(key=evalue) runs over the (subject, evalue)-sorted
        # slice, so equal e-values stay in subject order — as here.
        n_rows = len(ql)
        new_pair = np.ones(n_rows, bool)
        if n_rows > 1:
            new_pair[1:] = (ql[1:] != ql[:-1]) | (sj[1:] != sj[:-1])
        pair_id = np.cumsum(new_pair) - 1
        multi_pair = np.bincount(pair_id) > 1
        is_multi_q = np.zeros(len(self.ids), bool)
        is_multi_q[ql[multi_pair[pair_id]]] = True
        cap = max(p.max_m8_per_query, p.max_aln_per_query)

        srows = np.nonzero(~is_multi_q[ql]
                           & (ev <= p.evalue_threshold))[0]
        order = srows[np.argsort(ev[srows], kind="stable")]
        order = order[np.argsort(ql[order], kind="stable")]
        oql = ql[order]
        if len(oql):
            firstq = np.concatenate([[True], oql[1:] != oql[:-1]])
            startq = np.maximum.accumulate(
                np.where(firstq, np.arange(len(oql)), 0))
            order = order[np.arange(len(oql)) - startq < cap]
        out_simple = make_hits(order)

        mq = np.nonzero(is_multi_q)[0]
        if len(mq) == 0:
            out = out_simple
        else:
            # stitch: simple hits are already in ascending-query order;
            # splice each multi-HSP query's finalized walk at its spot
            oql = ql[order]
            out = []
            prev = 0
            for u in mq:
                cut = int(np.searchsorted(oql, u))
                out.extend(out_simple[prev:cut])
                prev = cut
                a = int(np.searchsorted(ql, u))
                b_ = int(np.searchsorted(ql, u, side="right"))
                hits = make_hits(np.arange(a, b_))
                st = stats[int(u)]
                st.set_query(int(qlen[u]))
                lo_q = int(self.starts[u])
                qseq = self.seq[lo_q:int(self.starts[u + 1])]
                out.extend(self._finalize_query_hits(hits, st, qseq,
                                                     render=False))
            out.extend(out_simple[prev:])
        if render:
            self._render_strings_all(out)  # one pass over every survivor
        return out

    def _sum_evalue(self, group: list[Hit],
                    st: blast_stat.BlastStat) -> list[Hit]:
        """SumEvalue (hash_search.cpp:1199-1273): combine non-overlapping
        HSPs on one subject into a sum-statistics e-value."""
        group = sorted(group, key=lambda h: h.evalue)
        chosen: list[Hit] = [group[0]]
        for h in group[1:]:
            half = (h.q_end - h.q_beg + 1) >> 1
            ov = min(SUMHSP_OVERLAP, half)
            if h.evalue >= 1 and h.score <= 30:
                continue
            overlaps = any(
                (h.q_beg <= c.q_end - ov and h.q_end >= c.q_beg + ov)
                or (c.q_beg <= h.q_end - ov and c.q_end >= h.q_beg + ov)
                for c in chosen)
            if not overlaps:
                chosen.append(h)
        if len(chosen) == 1:
            return chosen if chosen[0].evalue <= \
                self.params.evalue_threshold else group
        scores = [h.score for h in chosen[:5]]   # DEFAULT_SCORE_TOP
        subject_len = self._subject_len(chosen[0].subject)
        ev = st.sum_score_to_expect(scores, subject_len)
        if ev < self.params.evalue_threshold:
            for h in chosen:
                h.evalue = ev
            return chosen
        # combined e-value missed: keep the original hits with their own
        # e-values (the reference replaces only "if (!vRes.empty())",
        # hash_search.cpp:1268-1271; individual hits may still pass)
        return group

    def _subject_len(self, subject_id: int) -> int:
        local = self._local_of[int(subject_id)]
        return int(self.starts[local + 1] - self.starts[local])

    # -- public -----------------------------------------------------------
    def search_sequence(self, qseq: np.ndarray, query_idx: int = 0,
                        group: int | None = None) -> list[Hit]:
        """Hits of one query sequence (AA indices) against the DB.

        group: required when the searcher is group-partitioned — the
        query probes (and is scored under the statistics of) that group.
        """
        qseq = np.asarray(qseq, np.int32)
        if len(qseq) < seed_index.MER:
            return []
        qpos, dpos = self._pairs_for_query(qseq, group=group)
        if qpos.size == 0:
            return []
        res, subj = self._extend(qseq, qpos, dpos)
        stat = None
        if self.groups is not None:
            sel = np.nonzero(self.groups == group)[0]
            stat = self.stat_for_local(int(sel[0])) if sel.size else None
        return self._assemble(query_idx, qseq, res, subj, stat=stat)

    def _upload_probe_view(self) -> None:
        """Put the probe's arrays on the searcher's device once: the
        view's keys (as int64), positions and g10 table, the protein
        offsets and ids; search_all then probes and prepares pairs with
        hostops' torch twins."""
        v = self._hview
        self._probe_dev = {k: torch.as_tensor(a, device=self.device)
                           for k, a in (("keys", _as_int64(v.keys)),
                                        ("positions", v.positions),
                                        ("g10", v.g10_at),
                                        ("starts", self.starts),
                                        ("ids", self.ids.astype(np.int64)))}

    def _probe_prep_device(self, dq, exclude, tol: int):
        """The device twin of ``probe_host`` + ``native_ext.pair_prep`` for
        one slice of device query arrays (probe keys as int64, 4th-suffix
        groups, global query offsets): (six on the device, query_local,
        dpid, n_over)."""
        d = self._probe_dev
        qk, qg10, qglob = dq
        rows, dpos, n_over = hostops.probe_sorted_torch(
            d["keys"], d["positions"], qk, d["g10"], qg10,
            self.params.cand_max)
        six, qpid, dpid = hostops.pair_prep_torch(
            rows, dpos, qglob, d["starts"], d["ids"], exclude, tol)
        return six, qpid.cpu().numpy(), dpid.cpu().numpy(), n_over

    @property
    def windowed(self) -> bool:
        """Whether the batched extension on the CPU takes the window-dense
        form: every indexed protein is at most 512 residues long (else the
        chunked form).  On a CUDA searcher the ``extend_pairs`` kernel
        extends every length."""
        return self._win <= 512

    def extend_batch(self, six: torch.Tensor) -> torch.Tensor:
        """One (6, B) int32 device batch of packed seed pairs -> its
        (8, B) int32 PACK_KEYS result: the ``extend_pairs`` kernel on a
        CUDA searcher (no host synchronisation), on the CPU the form
        ``windowed`` picks.  Every form gives the same bits."""
        drop = int(self.cutoffs.ungap_ext_drop)
        if self.windowed and six.device.type == "cpu":
            return extend.extend_pairs_windowed(
                self._seq_dev, self._seq_dev, six, drop,
                seed_index.SEED_LEN, win_pre=self._win, win_post=self._win)
        return cuda_kernels.extend_pairs(self._seq_dev, self._seq_dev, six,
                                         drop, seed_index.SEED_LEN)

    def _extend_stream(self, six: np.ndarray) -> dict:
        """Batched device extension of one packed slice: every batch is
        queued first, each result queued as a non-blocking copy into one
        page-locked host buffer, then one synchronize harvests them all.
        Memory in flight stays bounded: each batch's temporaries return
        to the stream-ordered allocator as soon as the next batch is
        queued."""
        p = self.params
        n_pairs = six.shape[1]
        dev = self.device
        k = len(extend.PACK_KEYS)
        inputs = torch.as_tensor(six, device=dev)
        # batch i's (k, nb) result lands in one contiguous stretch of the
        # buffer, so each copy is a plain asynchronous device-to-host copy
        out = torch.empty(k * n_pairs, dtype=torch.int32,
                          pin_memory=dev.type == "cuda")
        for s in range(0, n_pairs, p.pair_batch):
            if s and s % (64 * p.pair_batch) == 0:
                profiling.heartbeat(
                    f"search_all: {s}/{n_pairs} slice pairs dispatched")
            r = self.extend_batch(inputs[:, s:s + p.pair_batch])
            out[k * s:k * (s + r.shape[1])].view(k, -1).copy_(
                r, non_blocking=True)
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()
        flat = out.numpy()
        arr = np.concatenate(
            [flat[k * s:k * min(s + p.pair_batch, n_pairs)].reshape(k, -1)
             for s in range(0, n_pairs, p.pair_batch)], axis=1) \
            if n_pairs else np.zeros((k, 0), np.int32)
        return {key: arr[i] for i, key in enumerate(extend.PACK_KEYS)}

    def search_all(self, batched: bool = True,
                   exclude_pairs: np.ndarray | None = None,
                   query_rows: np.ndarray | None = None,
                   hit_sink=None, render: bool = True) -> list[Hit]:
        """Every indexed protein as query (ProteinSearching,
        hash_search.cpp:263-289).

        batched=True STREAMS the whole pipeline per bounded query slice:
        seed codes, the ragged probe, pair prep, device extension, and
        assembly all run inside one slice before the next begins, so
        nothing O(corpus positions) or O(total pairs) is ever staged —
        the working set is O(slice) + the index (the structural
        9.9M-protein OOM: a full-corpus probe carried ~N^2/G pair
        arrays plus ~20 GB of corpus-wide code/validity tables).
        Slices cut at protein boundaries on a measured CANDIDATE budget
        (``SearchParams.pair_budget``; bucket sizes read from the index
        before each probe), so hit sets are concatenation-identical to
        the unchunked pipeline and per-query assembly never splits.
        Results are identical to the per-query path.

        exclude_pairs: optional SORTED uint64 array of directional
        ``(global_query_id << 32) | global_subject_id`` keys whose seed
        pairs are dropped before extension (batched path only).
        cluster_proteins passes each table's accumulated hit pairs so a
        later table never re-aligns — or re-reports — a pair an earlier
        table already found.

        query_rows: optional LOCAL row indices — only these proteins act
        as queries (all indexed proteins remain subjects).  A query's
        hits depend only on its own seeds and its group's index, so the
        full hit set partitions exactly by query: the distributed
        pipeline gives each process a query slice of one shared searcher
        (batched path only).

        hit_sink: optional callable(list[Hit]) — invoked once per slice
        with that slice's finalized hits IN ORDER (concatenating the
        calls reproduces the returned list exactly); when set,
        search_all returns [] and holds no hits, so corpus-scale runs
        can spill hits as they stream (batched path only).

        render=False skips the aligned-string/match-line rendering
        (q_aln/d_aln/info stay ""); every numeric m8 field is unchanged.
        """
        if not batched:
            if exclude_pairs is not None or query_rows is not None \
                    or hit_sink is not None or not render:
                raise ValueError("exclude_pairs/query_rows/hit_sink/"
                                 "render require batched=True")
            out = []
            for local, gid in enumerate(self.ids):
                qseq = self.seq[self.starts[local]:self.starts[local + 1]]
                grp = None if self.groups is None \
                    else int(self.groups[local])
                out.extend(self.search_sequence(qseq, query_idx=int(gid),
                                                group=grp))
            return out

        s_total = len(self.seq)
        out_all: list[Hit] = []
        if s_total < seed_index.SEED_LEN:
            return out_all
        p = self.params
        tol = int(p.collapse_runs or 0)
        plens = np.diff(self.starts)
        n_prot = len(self.ids)
        qr = None
        if query_rows is not None:
            qr = np.zeros(n_prot, bool)
            qr[np.asarray(query_rows)] = True
        n_over = 0
        pairs_done = 0
        exclude_dev = None
        if self._probe_dev is not None and exclude_pairs is not None:
            exclude_dev = torch.as_tensor(_as_int64(exclude_pairs),
                                          device=self.device)
        chunk_aa = int(p.probe_chunk)
        cand_budget = max(int(p.pair_budget), 1)
        p0 = 0
        while p0 < n_prot:
            # protein range holding ~chunk_aa residues (>= 1 protein)
            p1 = int(np.searchsorted(self.starts,
                                     int(self.starts[p0]) + chunk_aa,
                                     side="left"))
            p1 = min(max(p1, p0 + 1), n_prot)
            if qr is not None and not qr[p0:p1].any():
                p0 = p1
                continue
            _t0 = time.perf_counter()
            s0, s1 = int(self.starts[p0]), int(self.starts[p1])
            sub_starts = np.ascontiguousarray(self.starts[p0:p1 + 1]) - s0
            # per-chunk seed codes: the corpus-wide tables (code,
            # validity, qgrp10, qidx — ~34 B/residue) were the other
            # structural term of the 9.9M working set
            code_c, _, valid10_c, qgrp10_c = seed_index.host_codes(
                self.seq[s0:s1], sub_starts)
            qidx_c = np.nonzero(valid10_c)[0]
            del valid10_c
            if qr is not None:
                qr_at = np.repeat(qr[p0:p1], plens[p0:p1])
                qidx_c = qidx_c[qr_at[qidx_c]]
                del qr_at
            qgroups_c = None
            if self.groups is not None:
                g_at = np.repeat(self.groups[p0:p1].astype(np.int32),
                                 plens[p0:p1])
                qgroups_c = g_at[qidx_c].astype(np.int64)
                del g_at
            # candidate-budget probe slices, cut at protein boundaries
            # (assembly is per query, so a query's pairs never split)
            if self._probe_dev is None:
                counts = seed_index.bucket_counts(
                    self._hview, code_c[qidx_c], p.cand_max,
                    qgroups=qgroups_c)
            else:
                dq = [torch.as_tensor(a, device=self.device) for a in (
                    _as_int64(seed_index.query_keys(
                        self._hview, code_c[qidx_c], qgroups_c)),
                    qgrp10_c[qidx_c], qidx_c.astype(np.int64) + s0)]
                counts = hostops.bucket_counts_torch(
                    self._probe_dev["keys"], dq[0], p.cand_max).cpu().numpy()
            cum = np.cumsum(counts, dtype=np.int64)
            del counts
            profiling.add("align/probe", time.perf_counter() - _t0)
            a = 0
            while a < len(qidx_c):
                _t0 = time.perf_counter()
                base = int(cum[a - 1]) if a else 0
                b = int(np.searchsorted(cum, base + cand_budget,
                                        side="left")) + 1
                b = min(b, len(qidx_c))
                if b < len(qidx_c):
                    # extend to the owning protein's end (ascending)
                    pid_last = int(np.searchsorted(
                        sub_starts, int(qidx_c[b - 1]),
                        side="right")) - 1
                    b = int(np.searchsorted(
                        qidx_c, int(sub_starts[pid_last + 1]),
                        side="left"))
                    b = max(b, a + 1)
                sl = slice(a, b)
                if self._probe_dev is None:
                    rows, dpos, n_ov = seed_index.probe_host(
                        self._hview, code_c[qidx_c[sl]],
                        qgrp10_c[qidx_c[sl]], p.cand_max,
                        qgroups=None if qgroups_c is None
                        else qgroups_c[sl])
                    six_c, (ql_c, dpid_c) = native_ext.pair_prep(
                        rows, dpos, qidx_c[sl].astype(np.int64) + s0,
                        self.starts, self.ids, exclude_pairs, tol)
                    del rows, dpos  # 16 B/pair raw — dead once packed
                else:
                    six_c, ql_c, dpid_c, n_ov = self._probe_prep_device(
                        [x[sl] for x in dq], exclude_dev, tol)
                n_over += n_ov
                a = b
                profiling.add("align/probe", time.perf_counter() - _t0)
                if not six_c.shape[1]:
                    continue
                _t0 = time.perf_counter()
                res = self._extend_stream(six_c)
                n_slice = six_c.shape[1]
                del six_c
                profiling.add("align/extend", time.perf_counter() - _t0)
                _t0 = time.perf_counter()
                out = self._assemble_all(ql_c, res, dpid_c,
                                         render=render)
                del res, ql_c, dpid_c
                profiling.add("align/assemble",
                              time.perf_counter() - _t0)
                pairs_done += n_slice
                self.pairs_extended += n_slice
                profiling.heartbeat(
                    f"search_all: {pairs_done} pairs extended through "
                    f"protein {p1}/{n_prot}, +{len(out)} hits")
                if hit_sink is not None:
                    hit_sink(out)
                else:
                    out_all.extend(out)
            del code_c, qgrp10_c, qidx_c, qgroups_c, cum
            p0 = p1
        if n_over:
            warnings.warn(
                f"{n_over} seed buckets exceeded cand_max="
                f"{self.params.cand_max}; raise SearchParams.cand_max")
        return out_all


# gap-triggered windows scored per banded_scores call: bounds its
# (P, 2*band+1) row state
_GAPPED_BATCH = 1 << 16


def _sub21() -> np.ndarray:
    sub21 = np.full((21, 21), extend.NEGSCORE, np.int32)
    sub21[:20, :20] = blosum.BLOSUM62
    return sub21


def gapped_windows(searcher: ProteinSearcher, queries, margin: int = 16):
    """The windows of the gap-triggered hits (ungapped score >=
    ``cutoffs.gap_trigger``) of every ``(qseq, hits)`` query.

    Returns (where, wins, q, qlen, d, dlen): ``where`` the (query, hit)
    index of each window, ``wins`` its (qa, qb, da, db, dlo) bounds, and
    the padded (P, Lq) / (P, Ld) int32 residue windows (AA indices
    clipped to 20) with their lengths, as ``banded_scores`` takes them."""
    cut = searcher.cutoffs
    where, wins = [], []
    for qi, (qseq, hits) in enumerate(queries):
        for idx, h in enumerate(hits):
            if h.score < cut.gap_trigger:
                continue
            local = searcher._local_of[int(h.subject)]
            dlo = int(searcher.starts[local])
            dhi = int(searcher.starts[local + 1])
            wins.append((max(0, h.q_beg - 1 - margin),
                         min(len(qseq), h.q_end + margin),
                         max(dlo, dlo + h.d_beg - 1 - margin),
                         min(dhi, dlo + h.d_end + margin), dlo))
            where.append((qi, idx))
    n = len(wins)
    qlen = np.array([w[1] - w[0] for w in wins], np.int32)
    dlen = np.array([w[3] - w[2] for w in wins], np.int32)
    q = np.full((n, int(qlen.max()) if n else 0), 20, np.int32)
    d = np.full((n, int(dlen.max()) if n else 0), 20, np.int32)
    for r, ((qi, _), (qa, qb, da, db_, _)) in enumerate(zip(where, wins)):
        q[r, :qlen[r]] = np.minimum(queries[qi][0][qa:qb], 20)
        d[r, :dlen[r]] = np.minimum(searcher.seq[da:db_], 20)
    return where, wins, q, qlen, d, dlen


def refine_gapped(searcher: ProteinSearcher, qseq: np.ndarray,
                  hits: list[Hit], band: int = 32,
                  margin: int = 16) -> list[Hit]:
    """Re-align strong hits of one query with the banded gapped aligner
    (``refine_gapped_all`` for one query)."""
    return refine_gapped_all(searcher, [(qseq, hits)], band, margin)[0]


def refine_gapped_all(searcher: ProteinSearcher, queries,
                      band: int = 32, margin: int = 16) -> list[list[Hit]]:
    """Re-align the strong hits of every ``(qseq, hits)`` query with the
    banded gapped aligner (opt-in); returns each query's hit list.

    The reference declares a gapped stage above GapExtSCut but never
    invokes it (AlignGapped, hash_search.cpp:718-948); this is the
    working version: the gap-triggered hits of ALL queries are scored on
    the device in batches of ``_GAPPED_BATCH`` (``banded_scores``, one
    row loop per batch, where the JAX package runs one compiled program
    per query), and only hits whose gapped score improves get the host
    traceback (``native_ext.align_gapped``).  Scores, identity and
    extents update when the gapped alignment wins; e-values use the
    query's own statistics context (its group's when group-partitioned),
    so refined and unrefined hits share one e-value scale.  Equal, hit
    for hit, to the JAX package's per-query ``refine_gapped``.
    """
    _t0 = time.perf_counter()
    cut = searcher.cutoffs
    sub21 = _sub21()
    drop = int(round(cut.gap_ext_drop))
    where, wins, q, qlen, d, dlen = gapped_windows(searcher, queries,
                                                   margin)
    improves: dict[tuple, tuple] = {}
    dev = searcher.device
    sub_dev = torch.as_tensor(sub21, device=dev)
    for s in range(0, len(where), _GAPPED_BATCH):
        sl = slice(s, s + _GAPPED_BATCH)
        lq, ld = int(qlen[sl].max()), int(dlen[sl].max())
        sc, _, _ = gapped_device.banded_scores(
            torch.as_tensor(q[sl, :lq], device=dev),
            torch.as_tensor(qlen[sl], device=dev),
            torch.as_tensor(d[sl, :ld], device=dev),
            torch.as_tensor(dlen[sl], device=dev), sub_dev, cut.gap_open,
            cut.gap_extend, drop, band)
        for key, win, score in zip(where[sl], wins[sl],
                                   sc.cpu().numpy().tolist()):
            qi, idx = key
            if score > queries[qi][1][idx].score:
                improves[key] = win
    out_all = []
    for qi, (qseq, hits) in enumerate(queries):
        stat = searcher.stat_for_global(hits[0].query) if hits \
            else searcher.stat
        stat.set_query(len(qseq))
        out = []
        for idx, h in enumerate(hits):
            win = improves.get((qi, idx))
            if win is None:
                out.append(h)
                continue
            qa, qb, da, db_, dlo = win
            res = native_ext.align_gapped(
                np.minimum(qseq[qa:qb], 20).astype(np.int32),
                np.minimum(searcher.seq[da:db_], 20).astype(np.int32),
                sub21, cut.gap_open, cut.gap_extend, drop, band)
            if res is None or res[0] <= h.score:
                out.append(h)
                continue
            score, ops, e1, e2 = res
            out.append(_gapped_hit(searcher, qseq, h, stat, score, ops, e1,
                                   e2, qa, da, dlo))
        out_all.append(out)
    profiling.add("align/gapped", time.perf_counter() - _t0)
    return out_all


def _gapped_hit(searcher, qseq, h: Hit, stat, score, ops, e1, e2, qa, da,
                dlo) -> Hit:
    """``h`` with the gapped alignment's score, statistics, extents and
    strings (one vector pass over the alignment's columns)."""
    ops = np.asarray(ops)
    n_gap = int((ops != 0).sum())
    gap_open_count = int(((ops != 0)
                          & np.concatenate([[True],
                                            np.diff(ops) != 0])).sum())
    aln_len = len(ops)
    # the query / subject offset of each column that consumes a residue
    qstep, dstep, both = ops != 2, ops != 1, ops == 0
    qcol = qa + np.cumsum(qstep) - qstep
    dcol = da + np.cumsum(dstep) - dstep
    q_line = np.full(aln_len, ord("-"), np.uint8)
    d_line = q_line.copy()
    q_line[qstep] = np.frombuffer(_decode_bytes(qseq[qcol[qstep]]),
                                  np.uint8)
    d_line[dstep] = np.frombuffer(_decode_bytes(searcher.seq[dcol[dstep]]),
                                  np.uint8)
    qm, dm = qseq[qcol[both]], searcher.seq[dcol[both]]
    match = int((qm == dm).sum())
    info = np.full(aln_len, ord(" "), np.uint8)
    info[both] = np.frombuffer(_info_bytes(qm, dm), np.uint8)
    return dataclasses.replace(
        h, score=score, bits=stat.raw_to_bits(score),
        evalue=stat.raw_to_expect(score), aln_len=aln_len,
        identity=match * 100.0 / max(aln_len, 1),
        mismatch=aln_len - match - n_gap, gap_open=gap_open_count,
        q_beg=qa + 1, q_end=qa + e1, d_beg=da - dlo + 1,
        d_end=da - dlo + e2, q_aln=q_line.tobytes().decode(),
        d_aln=d_line.tobytes().decode(), info=info.tobytes().decode())


# positive-BLOSUM62 table of the match line (row/col 20 = unknown)
_POS62 = np.zeros((21, 21), bool)
_POS62[:20, :20] = blosum.BLOSUM62 > 0


def _info_bytes(qi: np.ndarray, di: np.ndarray) -> bytes:
    """Vectorized match line bytes: residue letter on identity, '+' on a
    positive BLOSUM62 score, ' ' otherwise (ungapped hits only)."""
    qi = np.minimum(qi, 20)
    di = np.minimum(di, 20)
    eq = qi == di
    chars = np.where(_POS62[qi, di], ord("+"), ord(" ")).astype(np.uint8)
    letters = np.full(len(qi), ord("X"), np.uint8)
    ok = qi < 20
    letters[ok] = alphabet._INDEX_TO_BYTE[qi[ok]]
    chars[eq] = letters[eq]
    return chars.tobytes()


def _decode_bytes(idx: np.ndarray) -> bytes:
    """Index array -> AA letter bytes ('X' for unknown)."""
    out = np.full(len(idx), ord("X"), np.uint8)
    ok = idx < 20
    out[ok] = alphabet._INDEX_TO_BYTE[np.asarray(idx)[ok]]
    return out.tobytes()


def _info_from_ints(qi: np.ndarray, di: np.ndarray) -> str:
    return _info_bytes(qi, di).decode()


def write_m8(path_or_file, hits: list[Hit], names_q, names_d) -> None:
    """blast -m8 tabular output (PrintM8, hash_search.cpp:1275-1300)."""
    close = False
    f = path_or_file
    if isinstance(path_or_file, str):
        f = open(path_or_file, "w")
        close = True
    try:
        for h in hits:
            if h.evalue < 0.01:
                ev = f"{h.evalue:.1e}"
            elif h.evalue < 10.0:
                ev = f"{h.evalue:.2f}"
            else:
                ev = f"{h.evalue:.0f}"
            f.write(f"{names_q[h.query]}\t{names_d[h.subject]}\t"
                    f"{h.identity:.1f}\t{h.aln_len}\t{h.mismatch}\t"
                    f"{h.gap_open}\t{h.q_beg}\t{h.q_end}\t{h.d_beg}\t"
                    f"{h.d_end}\t{ev}\t{h.bits:.1f}\n")
    finally:
        if close:
            f.close()


def write_aln(path_or_file, hits: list[Hit], names_q, names_d,
              max_out: int | None = None) -> None:
    """Readable alignment output (PrintAln, hash_search.cpp:1253-1273).

    max_out caps the emitted alignments (m_nMaxOut; the m8 writer has its
    own separate cap in the caller)."""
    close = False
    f = path_or_file
    if isinstance(path_or_file, str):
        f = open(path_or_file, "w")
        close = True
    if max_out is not None:
        hits = hits[:max_out]
    try:
        for h in hits:
            f.write(f"{names_q[h.query]} vs {names_d[h.subject]} "
                    f"bits={h.bits:.5g} E-value={h.evalue:.5g} "
                    f"identity={h.identity:.5g}% aln-len={h.aln_len} "
                    f"mismatch={h.mismatch} gap-openings={h.gap_open}\n")
            f.write(f"Query:\t{h.q_aln}\n      \t{h.info}\n"
                    f"Sbjct:\t{h.d_aln}\n\n")
    finally:
        if close:
            f.close()
