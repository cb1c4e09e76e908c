"""Murphy10 6-mer seed index over a protein database, as sorted codes
(counterpart of hsearch_tpu/align/seed_index.py).

The reference keeps a 10^6-entry bucket table over base-10 6-mer keys
plus, per bucket, a sorted ushort of the 4 following residues for range
narrowing (vDHash/vDComp, hash_search.cpp:200-248, CompShortLow/Up
:361-446).  Here both levels collapse into ONE sorted code per indexed
position:

    code = key6 * 16^3 + 3 suffix nibbles   (digits 0..9, unknown 10,
                                             past-sequence-end 15)

The value fits 32 bits (max 999999*4096+4095 < 2^32): the host keeps it
as numpy uint32, the device functions as int64 (torch's uint32 support is
partial), with the same values.  The 4th suffix residue is checked as a
post-filter on the gathered candidates (the g10 test): together the two
stages admit exactly the reference's candidate set.

The host passes (seed codes, the index sorts, ``probe_host``,
``bucket_counts``) run through the port's C++ host library
(``native_ext``); ``_codes_for``, ``query_probe_codes`` and ``probe`` are
the device twins the tests tie them to, run as torch ops on the device
of their inputs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import native_ext
from . import hostops, reduced

# the seed geometry (hostops' passes share it)
MER, SUFFIX, NARROW, SEED_LEN = (hostops.MER, hostops.SUFFIX,
                                 hostops.NARROW, hostops.SEED_LEN)
_PAD, _G10_PASS = hostops.PAD, hostops.G10_PASS
_GROUP21 = np.concatenate([reduced.MURPHY10.astype(np.int32), [10]])

#: group count below which the grouped index build sorts each group's
#: segment separately (temporaries bounded by the largest group) instead
#: of one full-size composite sort; above it, per-group selection passes
#: would cost n_groups full scans
_SEGMENTED_SORT_MAX_GROUPS = 1024

_U32 = 0xFFFFFFFF


@dataclasses.dataclass
class SeedIndex:
    """Sorted seed codes over every valid position of a protein DB (host
    numpy arrays).

    With ``group_starts`` set (group-partitioned index), positions are
    sorted by (protein group, code) and each group's codes occupy the
    contiguous slice [group_starts[g], group_starts[g+1]): probes are
    bounded to the querying protein's own group, so one index serves many
    independent pre-cluster groups at once (pcluster.cpp:157-167).
    """

    sorted_codes: np.ndarray    # (P,) uint32
    positions: np.ndarray       # (P,) int64 flat offsets, sorted like codes
    seq: np.ndarray             # (S,) int32 AA indices of the concatenated DB
    starts: np.ndarray          # (N+1,) int32 per-protein offsets
    group_starts: np.ndarray | None = None   # (G+1,) int32 or None
    g10_at: np.ndarray | None = None          # (S,) int8 4th-suffix groups

    @property
    def num_positions(self) -> int:
        return self.sorted_codes.shape[0]


def _groups(seq: torch.Tensor) -> torch.Tensor:
    g21 = torch.as_tensor(_GROUP21, dtype=torch.int64, device=seq.device)
    return g21[seq.long().clamp(max=20)]


def _seq_end(starts: torch.Tensor, s: int) -> torch.Tensor:
    pos = torch.arange(s, device=starts.device, dtype=starts.dtype)
    pid = torch.searchsorted(starts, pos, right=True) - 1
    return starts[pid + 1]


def _shifted(grp: torch.Tensor, i: int) -> torch.Tensor:
    if not i:
        return grp
    return torch.cat([grp[i:], grp.new_full((min(i, grp.shape[0]),), 10)])


def _codes_for(seq: torch.Tensor, starts: torch.Tensor):
    """Per-position seed code (int64 holding the uint32 value) and the
    validity of its 6-mer part."""
    s = seq.shape[0]
    starts = starts.long()
    grp = _groups(seq)
    seq_end = _seq_end(starts, s)
    idx = torch.arange(s, device=seq.device)
    key = torch.zeros(s, dtype=torch.int64, device=seq.device)
    valid = torch.ones(s, dtype=torch.bool, device=seq.device)
    for i in range(MER):
        g = _shifted(grp, i)
        key = key * 10 + g
        valid &= (g < 10) & (idx + i < seq_end)
    # uint32 arithmetic, as the host tables and the JAX package: a key
    # with unknown residues (digit 10, an invalid position) wraps
    code = (key * 16 ** NARROW) & _U32
    for i in range(NARROW):
        g = _shifted(grp, MER + i)
        nib = torch.where(idx + MER + i < seq_end, g, _PAD)
        code = (code + nib * 16 ** (NARROW - 1 - i)) & _U32
    return code, valid


def query_probe_codes(qseq: torch.Tensor, qstarts: torch.Tensor):
    """Per query position: the NARROW+1 probe codes (S, 4) int64 and the
    validity (all 10 seed residues in-sequence with valid murphy10 groups;
    the reference skips other seeds, hash_search.cpp:331-343)."""
    base, valid6 = _codes_for(qseq, qstarts)
    s = qseq.shape[0]
    grp = _groups(qseq)
    seq_end = _seq_end(qstarts.long(), s)
    idx = torch.arange(s, device=qseq.device)
    valid = valid6
    for i in range(SUFFIX):
        g = _shifted(grp, MER + i)
        valid &= (g < 10) & (idx + MER + i < seq_end)
    # truncated variants: the last j suffix nibbles replaced with PAD
    probes = [base]
    for j in range(1, NARROW + 1):
        scale = 16 ** j
        probes.append(torch.div(base, scale, rounding_mode="floor") * scale
                      + _PAD * ((scale - 1) // 15))
    return torch.stack(probes, dim=1), valid


def probe(index: SeedIndex, qcodes: torch.Tensor, qgrp10: torch.Tensor,
          cand_max: int):
    """(Q, P) probe codes -> (candidates (Q, P*cand_max) int32, n_over),
    on the device of ``qcodes``.

    The device oracle twin of ``probe_host``.  qgrp10: (Q,) the query's
    murphy10 group at seed position + 9; candidates that still have that
    residue must agree on it, shorter candidates pass.  Invalid slots hold
    -1; ``n_over`` counts buckets whose true size exceeded cand_max."""
    if index.group_starts is not None:
        raise ValueError("probe() does not support a group-partitioned "
                         "index; use probe_host with qgroups")
    dev = qcodes.device
    sc = torch.as_tensor(index.sorted_codes.astype(np.int64), device=dev)
    positions = torch.as_tensor(index.positions, dtype=torch.int64,
                                device=dev)
    qcodes = qcodes.long().contiguous()
    lo = torch.searchsorted(sc, qcodes, right=False)
    hi = torch.searchsorted(sc, qcodes, right=True)
    n_over = int((hi - lo > cand_max).sum())
    count = torch.clamp(hi - lo, max=cand_max)
    offs = torch.arange(cand_max, device=dev)
    sel = offs < count[..., None]                   # (Q, P, M)
    pos = torch.where(sel, lo[..., None] + offs, 0)
    if positions.shape[0]:
        ids = positions[pos].to(torch.int32)
    else:
        ids = torch.zeros(pos.shape, dtype=torch.int32, device=dev)
    s = index.seq.shape[0]
    qg = qgrp10.long()[:, None, None]
    if index.g10_at is not None:
        g10_at = torch.as_tensor(index.g10_at, device=dev)
        g10 = g10_at[ids.long().clamp(0, s - 1)].long()
        ok = (g10 == _G10_PASS) | (g10 == qg)
    else:
        # derive on the fly (indexes without the table)
        seq = torch.as_tensor(index.seq, device=dev)
        starts = torch.as_tensor(index.starts, dtype=torch.int64,
                                 device=dev)
        g10 = _groups(seq)[(ids.long() + MER + NARROW).clamp(0, s - 1)]
        seq_end = starts[torch.searchsorted(starts, ids.long().reshape(-1),
                                            right=True)].reshape(ids.shape)
        ok = ~((ids.long() + MER + NARROW) < seq_end) | (g10 == qg)
    ids = torch.where(sel & ok, ids, -1)
    return ids.reshape(qcodes.shape[0], -1), n_over


def host_codes(seq: np.ndarray, starts: np.ndarray):
    """Host seed tables: (code uint32, valid6, valid10, qgrp10).

    valid6 is the db-side rule (a valid 6-mer; shorter suffixes
    PAD-match), valid10 the query-side rule.  ``probe_host`` needs only
    the base (untruncated) probe code per position, so the truncated PAD
    variants are not materialized.  One pass of the host library
    (``native_ext.seed_codes``; ``hostops.host_codes_np`` is its twin)."""
    return native_ext.seed_codes(seq, starts, _GROUP21)[:4]


def g10_table(seq: np.ndarray, starts: np.ndarray) -> np.ndarray:
    """(S,) int8: murphy10 group of the 4th suffix residue at each
    position, or _G10_PASS past the owning sequence."""
    return hostops.g10_table(seq, starts, _GROUP21)


@dataclasses.dataclass
class HostSeedView:
    """Host-resident view of a SeedIndex for the ragged host probe.

    keys: the sorted probe keys: the uint32 codes directly or, for a
    group-partitioned index, the composite uint64 ``(group << 32) | code``
    (positions sort by (group, code), so the composite is globally sorted
    and one searchsorted serves every group).
    """

    keys: np.ndarray        # (P,) uint32 or uint64
    positions: np.ndarray   # (P,) int64
    g10_at: np.ndarray      # (S,) int8
    grouped: bool
    _keys64: np.ndarray | None = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def keys64(self) -> np.ndarray:
        """``keys`` widened to uint64, cached (grouped views: no copy)."""
        if self._keys64 is None:
            self._keys64 = np.ascontiguousarray(self.keys, np.uint64)
        return self._keys64


def _view_keys(sc: np.ndarray, group_starts: np.ndarray | None):
    sc = sc.astype(np.uint32)
    if group_starts is None:
        return sc
    gid = (np.searchsorted(group_starts, np.arange(len(sc)),
                           side="right") - 1).astype(np.uint64)
    return (gid << np.uint64(32)) | sc.astype(np.uint64)


def host_view(index: SeedIndex) -> HostSeedView:
    """Host projection of an existing SeedIndex (``build_index_and_view``
    assembles it from the build's own arrays when building fresh)."""
    sc = np.asarray(index.sorted_codes)
    pos = np.asarray(index.positions).astype(np.int64)
    g10 = np.asarray(index.g10_at) if index.g10_at is not None \
        else g10_table(np.asarray(index.seq), np.asarray(index.starts))
    gs = None if index.group_starts is None \
        else np.asarray(index.group_starts)
    return HostSeedView(keys=_view_keys(sc, gs), positions=pos,
                        g10_at=g10, grouped=gs is not None)


def query_keys(view: HostSeedView, qcodes, qgroups):
    """The probe keys of ``qcodes``: the uint32 codes or, for a
    group-partitioned view, the composite uint64 ``(group << 32) | code``
    (``qgroups`` required exactly then)."""
    if view.grouped != (qgroups is not None):
        raise ValueError("qgroups must be given exactly when the index "
                         "is group-partitioned")
    q = np.asarray(qcodes).astype(np.uint32)
    if view.grouped:
        return (np.asarray(qgroups).astype(np.uint64) << np.uint64(32)) \
            | q.astype(np.uint64)
    return q


def probe_host(view: HostSeedView, qcodes: np.ndarray, qgrp10: np.ndarray,
               cand_max: int, qgroups: np.ndarray | None = None):
    """Ragged host probe: (rows, dpos, n_over).

    qcodes: (Q,) base probe codes; qgrp10: (Q,) the query group at seed
    position + 9; qgroups: (Q,) group ids (required iff the view is
    group-partitioned).  Pairs come out sorted by (row, dpos) and
    duplicate-free; ``n_over`` counts buckets larger than cand_max
    (truncated to their first cand_max positions, as the device probe).
    """
    qk = query_keys(view, qcodes, qgroups)
    return native_ext.probe_sorted(view.keys64, view.positions,
                                   qk.astype(np.uint64), view.g10_at,
                                   np.asarray(qgrp10, np.int32), cand_max)


def bucket_counts(view: HostSeedView, qcodes: np.ndarray, cand_max: int,
                  qgroups: np.ndarray | None = None) -> np.ndarray:
    """Capped (pre-g10-filter) bucket size per probe position: the
    estimate the pipeline cuts probe slices on (an upper bound on what
    ``probe_host`` returns for the same positions)."""
    qk = query_keys(view, qcodes, qgroups).astype(np.uint64)
    # int64 bit patterns order like the uint64 keys (the sign bit is never
    # set); qk - 1 turns side="left" into a side="right" search, qk = 0
    # wrapping to -1 < every key
    keys = view.keys64.view(np.int64)
    hi = native_ext.searchsorted_right(keys, qk.view(np.int64))
    lo = native_ext.searchsorted_right(keys,
                                       (qk - np.uint64(1)).view(np.int64))
    return np.minimum(hi - lo, cand_max)


def build_index(seq: np.ndarray, starts: np.ndarray,
                protein_groups: np.ndarray | None = None) -> SeedIndex:
    """Index every valid seed position of the concatenated DB.

    protein_groups: optional (N,) dense group id 0..G-1 per protein; when
    given, positions sort by (group, code) and the index records each
    group's code slice so probes stay group-local."""
    return build_index_and_view(seq, starts, protein_groups)[0]


def build_index_and_view(seq: np.ndarray, starts: np.ndarray,
                         protein_groups: np.ndarray | None = None
                         ) -> tuple[SeedIndex, HostSeedView]:
    """``build_index`` plus the HostSeedView for ``probe_host``, both from
    the build's own host arrays (seed codes and sorts from the host
    library)."""
    codes, valid6, _, _, g10 = native_ext.seed_codes(seq, starts, _GROUP21)
    pos = np.nonzero(valid6)[0].astype(np.int32)
    c = codes[pos]
    del codes, valid6
    gs = None
    if protein_groups is None:
        order = native_ext.argsort_u64(c.astype(np.uint64))
        view_keys = None          # raw uint32 codes
        c_sorted = c[order]
        pos_sorted = pos[order].astype(np.int32)
        del order
    else:
        pg = np.asarray(protein_groups)
        n_groups = int(pg.max()) + 1 if pg.size else 0
        sorted_pg = not pg.size or bool((np.diff(pg) >= 0).all())
        if sorted_pg:
            # proteins arrive grouped, so valid positions are already
            # (group, position)-contiguous: group slices follow from
            # per-protein valid-seed counts
            pcnt = np.diff(np.searchsorted(pos, starts.astype(pos.dtype)))
            counts = np.bincount(pg, weights=pcnt.astype(np.float64),
                                 minlength=n_groups).astype(np.int64)
            del pcnt
            g = None
        else:
            g_at = np.repeat(pg.astype(np.int32), np.diff(starts))
            g = g_at[pos]
            del g_at
            counts = np.bincount(g, minlength=n_groups)
        gs64 = np.concatenate([[0], np.cumsum(counts)])
        gs = gs64.astype(np.int32)
        if sorted_pg and n_groups <= _SEGMENTED_SORT_MAX_GROUPS:
            # contiguous-slice segmented sort: the same stable
            # (group, code) order as the branches below
            view_keys = np.empty(len(c), np.uint64)
            c_sorted = np.empty(len(c), np.uint32)
            pos_sorted = np.empty(len(c), np.int32)
            for gi in range(n_groups):
                lo, hi = int(gs64[gi]), int(gs64[gi + 1])
                if hi == lo:
                    continue
                cg = c[lo:hi]
                if hi - lo < (1 << 31):
                    og = native_ext.argsort_u32(cg)
                else:
                    og = native_ext.argsort_u64(cg.astype(np.uint64))
                c_sorted[lo:hi] = cg[og]
                view_keys[lo:hi] = c_sorted[lo:hi]
                view_keys[lo:hi] |= np.uint64(gi) << np.uint64(32)
                pos_sorted[lo:hi] = pos[lo:hi][og]
                del cg, og
            del c, pos
        elif n_groups <= _SEGMENTED_SORT_MAX_GROUPS:
            # per-group selection and sort
            view_keys = np.empty(len(c), np.uint64)
            c_sorted = np.empty(len(c), np.uint32)
            pos_sorted = np.empty(len(c), np.int32)
            for gi in range(n_groups):
                sel = np.nonzero(g == gi)[0]
                if not len(sel):
                    continue
                cg = c[sel]
                og = native_ext.argsort_u64(cg.astype(np.uint64))
                lo, hi = int(gs64[gi]), int(gs64[gi + 1])
                cs = cg[og]
                c_sorted[lo:hi] = cs
                view_keys[lo:hi] = (np.uint64(gi) << np.uint64(32)) \
                    | cs.astype(np.uint64)
                pos_sorted[lo:hi] = pos[sel][og]
                del sel, cg, og, cs
            del g, c, pos
        else:
            # one stable argsort on the fused (group << 32) | code key
            # (the same order as np.lexsort((c, g)))
            if g is None:
                g = np.repeat(np.arange(n_groups, dtype=np.int32), counts)
            key = (g.astype(np.uint64) << np.uint64(32)) \
                | c.astype(np.uint64)
            del g
            order = native_ext.argsort_u64(key)
            view_keys = key[order]
            del key
            c_sorted = c[order]
            del c
            pos_sorted = pos[order].astype(np.int32)
            del pos, order
    # one positions array, int64, shared by index and view
    pos64 = pos_sorted.astype(np.int64)
    del pos_sorted
    index = SeedIndex(
        sorted_codes=c_sorted,
        positions=pos64,
        seq=np.asarray(seq, np.int32),
        starts=np.asarray(starts, np.int32),
        group_starts=gs,
        g10_at=g10)
    view = HostSeedView(
        keys=c_sorted if view_keys is None else view_keys,
        positions=pos64,
        g10_at=g10, grouped=gs is not None)
    return index, view
