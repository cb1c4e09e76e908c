"""hsearch_tpu_torch/native_ext.py (csrc/hostops.cpp, the port's OpenMP
host library) against its numpy twins and the JAX package's library: every
binding bitwise equal to both on the same seeded inputs, the call sites
that route through it (seed index, probe, pair preparation, gapped
traceback, union-find, FASTA), the thread pin, and a build that fails
loudly."""

import dataclasses
import io
import os

import jax
import numpy as np
import pytest
import torch

from hsearch_tpu import native_ext as jnat
from hsearch_tpu.align import pipeline as jpipe
from hsearch_tpu.align import seed_index as jseed
from hsearch_tpu.cluster import pcluster as jpc
from hsearch_tpu.core import io as jio
from hsearch_tpu_torch import native_ext as nat
from hsearch_tpu_torch.align import hostops, pipeline, seed_index
from hsearch_tpu_torch.cluster import pcluster, union_find
from hsearch_tpu_torch.core import alphabet, blosum, dataprep, embedding
from hsearch_tpu_torch.core import io as tio

GROUP21 = seed_index._GROUP21


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two OpenMP threads while this file runs: the test workers share the
    cores."""
    before = torch.get_num_threads(), nat.set_threads(0)
    nat.set_threads(2)
    yield
    torch.set_num_threads(before[0])
    nat.set_threads(before[1])


def _eq(*arrays):
    """Every array equal to the first, value and dtype."""
    for a in arrays[1:]:
        assert a.dtype == arrays[0].dtype
        np.testing.assert_array_equal(a, arrays[0])


def _random_db(rng, n=150, lmin=3, lmax=90):
    lens = rng.integers(lmin, lmax, n)
    starts = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    seq = rng.integers(0, 21, starts[-1]).astype(np.int32)
    return seq, starts


def _sub21():
    sub = np.full((21, 21), -5, np.int32)
    sub[:20, :20] = blosum.BLOSUM62
    return sub


# ---- FASTA, suffix array, union-find --------------------------------------

FASTA = (b"junk before\n>seq1 desc here\nARNDC\nQEGHI\n>seq2\twith tab\r\n"
         b"wwyyv\r\n>seq3\nAXB-1A\n>empty\n>seq5\nMK*\n")


def test_parse_fasta_bytes_equal_jax_and_python_parser():
    names, seq, starts = nat.parse_fasta_bytes(FASTA)
    jnames, jseq, jstarts = jnat.parse_fasta_bytes(FASTA)
    assert names == jnames == ["seq1", "seq2", "seq3", "empty", "seq5"]
    _eq(seq, jseq)
    _eq(starts, jstarts)
    assert starts.tolist() == [0, 10, 15, 19, 19, 21]
    # the pure-Python parser (an open file) on the same bytes, with the
    # library's 20 for unknown letters folded to INVALID
    py = tio.read_fasta(io.StringIO(FASTA.decode()), seed=None)
    np.testing.assert_array_equal(
        np.where(seq == 20, alphabet.INVALID, seq), py.seq)
    _eq(starts, py.starts)
    assert py.names[0] == names[0] and py.names[2:] == names[2:]


@pytest.mark.parametrize("seed", [None, 0, 7])
def test_read_fasta_path_equal_jax(tmp_path, seed):
    path = tmp_path / "p.fasta"
    path.write_bytes(FASTA)
    calls = nat.parse_fasta_bytes.calls
    got = tio.read_fasta(str(path), seed=seed)
    assert nat.parse_fasta_bytes.calls == calls + 1
    want = jio.read_fasta(str(path), seed=seed)
    assert got.names == want.names
    _eq(got.seq, want.seq)
    _eq(got.starts, want.starts)


@pytest.mark.parametrize("n,alphabet_size", [(0, 4), (1, 4), (500, 20),
                                             (400, 2)])
def test_suffix_array_equal_numpy_and_jax(rng, n, alphabet_size):
    seq = rng.integers(0, alphabet_size, n).astype(np.int32)
    if n >= 400:
        seq[100:300] = seq[:200]          # long repeats
    _eq(nat.suffix_array(seq), dataprep.suffix_array(seq),
        jnat.suffix_array(seq))


def test_union_find_labels_equal_python_and_jax(rng):
    n = 300
    src = np.concatenate([rng.integers(0, n, 200), np.full(50, 7)])
    dst = np.concatenate([rng.integers(0, n, 200), np.full(50, 8)])
    uf = union_find.UnionFind(n)
    uf.union_edges(src, dst)
    got = nat.union_find_labels(n, src, dst)
    _eq(got, uf.components(), jnat.union_find_labels(n, src, dst),
        union_find.connected_components(n, src, dst))
    assert got[7] == got[8] == min(got[7], 7)
    _eq(nat.union_find_labels(5, [], []), np.arange(5))
    with pytest.raises(ValueError, match="outside"):
        nat.union_find_labels(5, [0], [5])


# ---- gapped traceback -----------------------------------------------------

def _all_three(q, d, **kw):
    got = nat.align_gapped(q, d, _sub21(), **kw)
    want = jnat.align_gapped(q, d, _sub21(), **kw)
    twin = hostops.align_gapped(q, d, _sub21(), **kw)
    for other in (want, twin):
        assert got[0] == other[0] and got[2:] == other[2:]
        _eq(got[1], other[1])
    return got


def test_align_gapped_identical():
    q = alphabet.encode("ARNDCQEGHIKLMNP").astype(np.int32)
    score, ops, e1, e2 = _all_three(q, q)
    assert (ops == 0).all() and len(ops) == len(q)
    assert score == int(blosum.BLOSUM62[q, q].sum())
    assert e1 == e2 == len(q)


def test_align_gapped_with_gap():
    q = alphabet.encode("ARNDCQEGHIKMFPSTWYVA").astype(np.int32)
    d = np.concatenate([q[:10], alphabet.encode("A"), q[10:]]) \
        .astype(np.int32)
    score, ops, _, _ = _all_three(q, d, gap_open=11, gap_ext=1)
    assert (ops == 2).sum() == 1 and (ops == 0).sum() == len(q)
    assert score == int(blosum.BLOSUM62[q, q].sum()) - 11


@pytest.mark.parametrize("band,drop", [(32, 27), (4, 10), (1, 27)])
def test_align_gapped_random_equal_twin_and_jax(rng, band, drop):
    for _ in range(6):
        q = rng.integers(0, 21, int(rng.integers(20, 60))).astype(np.int32)
        d = q.copy()
        pos = rng.integers(0, len(d), 3)
        d[pos] = rng.integers(0, 21, 3)
        d = np.delete(d, rng.integers(5, len(d) - 5, 2))
        _all_three(q, d, band=band, drop=drop)
    assert nat.align_gapped(q[:0], d, _sub21()) is None
    assert jnat.align_gapped(q[:0], d, _sub21()) is None


def test_refine_gapped_improves_indel_hit_equal_jax(rng):
    base = rng.integers(0, 20, 120).astype(np.int32)
    seqs = [base, np.concatenate([base[:60], base[62:]])]
    starts = np.concatenate([[0], np.cumsum([len(s) for s in seqs])])
    seq = np.concatenate(seqs)
    tdb = tio.ProteinDB(names=["q", "s"], seq=seq, starts=starts)
    jdb = jio.ProteinDB(names=["q", "s"], seq=seq, starts=starts)
    ts = pipeline.ProteinSearcher(tdb, device="cpu")
    js = jpipe.ProteinSearcher(jdb)
    hits = [h for h in ts.search_sequence(base, 0) if h.subject == 1]
    jhits = [h for h in js.search_sequence(base, 0) if h.subject == 1]
    assert hits and [dataclasses.astuple(h) for h in hits] \
        == [dataclasses.astuple(h) for h in jhits]
    calls = nat.align_gapped.calls
    refined = pipeline.refine_gapped(ts, base, hits)
    assert nat.align_gapped.calls > calls
    want = jpipe.refine_gapped(js, base, jhits)
    assert [dataclasses.astuple(h) for h in refined] \
        == [dataclasses.astuple(h) for h in want]
    best = max(refined, key=lambda h: h.score)
    assert best.score > max(h.score for h in hits)
    assert best.gap_open >= 1
    assert best.aln_len > max(h.aln_len for h in hits)


# ---- seed-index passes ----------------------------------------------------

def test_seed_codes_equal_twin_and_jax(rng):
    seq, starts = _random_db(rng)
    got = nat.seed_codes(seq, starts, GROUP21)
    twin = hostops.seed_codes(seq, starts, GROUP21)
    want = jnat.seed_codes(seq, starts, jseed._GROUP21)
    for g, t, w in zip(got, twin, want):
        _eq(g, t, w)
    # host_codes is the library's first four tables
    for g, h in zip(got, seed_index.host_codes(seq, starts)):
        _eq(g, h)
    with pytest.raises(ValueError, match="starts"):
        nat.seed_codes(seq, starts + 1, GROUP21)


def test_argsort_u64_stable_equal_numpy_and_jax(rng):
    keys = rng.integers(0, 2**48, 50000, dtype=np.uint64)
    keys[::5] = keys[7]            # heavy duplicates: stability must hold
    keys[1000:1200] = 0
    keys[:10] = 2**64 - 1          # every byte pass, the top one too
    _eq(nat.argsort_u64(keys), hostops.argsort_u64(keys),
        jnat.argsort_u64(keys))
    _eq(nat.argsort_u64(np.zeros(0, np.uint64)), np.zeros(0, np.int64))


def test_argsort_u32_stable_equal_numpy_and_jax(rng):
    keys = rng.integers(0, 2**32, 40000, dtype=np.uint64).astype(np.uint32)
    keys[::3] = keys[11]
    keys[500:700] = 2**32 - 1
    _eq(nat.argsort_u32(keys), hostops.argsort_u32(keys),
        jnat.argsort_u32(keys))
    _eq(nat.argsort_u32(np.full(9, 4, np.uint32)),
        np.arange(9, dtype=np.int32))     # every pass uniform: skipped
    _eq(nat.argsort_u32(np.zeros(0, np.uint32)), np.zeros(0, np.int32))


def test_searchsorted_right_equal_numpy_and_jax(rng):
    a = np.sort(rng.integers(-50, 5000, 3000)).astype(np.int64)
    q = rng.integers(-100, 5100, 20000).astype(np.int64)
    q[:50] = a[:50]                # exact matches: side="right"
    _eq(nat.searchsorted_right(a, q), hostops.searchsorted_right(a, q),
        jnat.searchsorted_right(a, q))
    _eq(nat.searchsorted_right(a[:0], q[:5]), np.zeros(5, np.int64))


@pytest.mark.parametrize("grouped", [False, True])
def test_probe_sorted_equal_twin_and_jax(rng, grouped):
    seq, starts = _random_db(rng, lmin=20)
    # 6 more copies of the first protein: buckets above cand_max=4
    first = seq[:starts[1]]
    seq = np.concatenate([seq, *[first] * 6])
    starts = np.concatenate([starts, starts[-1] + len(first)
                             * np.arange(1, 7)])
    code, _, v10, qg = hostops.host_codes_np(seq, starts, GROUP21)
    qcodes, qgrp10 = code[v10], qg[v10]
    pg = None
    if grouped:
        pg = rng.integers(0, 6, len(starts) - 1)
        pg[0] = pg[-6:] = 0                 # the copies share a group
    _, view = seed_index.build_index_and_view(seq, starts, pg)
    _, jview = jseed.build_index_and_view(seq, starts, pg)
    _eq(view.keys, jview.keys)
    _eq(view.positions, jview.positions)
    qgroups = None
    if grouped:
        qgroups = pg[np.searchsorted(starts, np.nonzero(v10)[0],
                                     side="right") - 1]
    qk = seed_index.query_keys(view, qcodes, qgroups)
    for cand_max in (4, 64):       # a small cap truncates: n_over > 0
        calls = nat.probe_sorted.calls
        got = seed_index.probe_host(view, qcodes, qgrp10, cand_max, qgroups)
        assert nat.probe_sorted.calls == calls + 1
        twin = hostops.probe_sorted(view.keys, view.positions, qk,
                                    view.g10_at, qgrp10, cand_max)
        want = jnat.probe_sorted(jview.keys64, jview.positions,
                                 qk.astype(np.uint64), jview.g10_at,
                                 qgrp10.astype(np.int32), cand_max)
        for g, t, w in zip(got[:2], twin[:2], want[:2]):
            _eq(g, t, w)
        assert got[2] == twin[2] == want[2]
        assert len(got[0])
        if cand_max == 4:
            assert got[2] > 0


def test_probe_sorted_empty_queries(rng):
    seq, starts = _random_db(rng, n=10)
    _, view = seed_index.build_index_and_view(seq, starts)
    rows, dpos, n_over = seed_index.probe_host(
        view, np.zeros(0, np.uint32), np.zeros(0, np.int32), 8)
    assert rows.shape == dpos.shape == (0,) and n_over == 0
    assert rows.dtype == dpos.dtype == np.int64


def _homolog_db(rng):
    base = rng.integers(0, 20, 100).astype(np.int32)
    seqs = []
    for _ in range(12):
        s = base.copy()
        s[rng.choice(100, 5, replace=False)] = rng.integers(0, 20, 5)
        seqs.append(s)
    seqs.append(base[:12].copy())         # short subject: SEED_LEN edge
    starts = np.concatenate([[0], np.cumsum([len(s) for s in seqs])])
    names = [f"p{i}" for i in range(len(seqs))]
    seq = np.concatenate(seqs)
    return (tio.ProteinDB(names=names, seq=seq, starts=starts),
            jio.ProteinDB(names=names, seq=seq, starts=starts))


EXCLUDE = np.sort(np.array([(0 << 32) | 1, (2 << 32) | 3], np.uint64))


@pytest.mark.parametrize("exclude,tol", [(None, 0), (None, 16),
                                         (EXCLUDE, 0), (EXCLUDE, 16)])
def test_pair_prep_equal_twin_and_jax(rng, exclude, tol):
    tdb, _ = _homolog_db(rng)
    s = pipeline.ProteinSearcher(tdb, device="cpu")
    code, _, v10, qg = seed_index.host_codes(s.seq, s.starts)
    qidx = np.nonzero(v10)[0].astype(np.int64)
    rows, dpos, _ = seed_index.probe_host(s._hview, code[qidx], qg[qidx],
                                          s.params.cand_max)
    args = (rows, dpos, qidx, s.starts, s.ids, exclude, tol)
    six, pids = nat.pair_prep(*args)
    tsix, tq, td = hostops.pair_prep(*args)
    jsix, jpids = jnat.pair_prep(*args)
    _eq(six, tsix, jsix)
    _eq(pids, np.stack([tq, td]).astype(np.int32), jpids)
    assert six.shape[1] > 0
    if tol:
        assert six.shape[1] < len(rows)   # the collapse dropped seeds


def test_collapse_diag_runs_native_sort_equal_numpy_and_jax(rng):
    n = 5000
    qpid = rng.integers(0, 6, n)
    dpid = rng.integers(0, 6, n)
    dpos = rng.integers(0, 400, n)
    qpos = dpos + rng.integers(-3, 4, n)        # few diagonals: long runs
    qpos = np.abs(qpos)
    got = hostops.collapse_diag_runs(qpos, dpos, qpid, dpid, 8,
                                     argsort=nat.argsort_u64)
    _eq(got, hostops.collapse_diag_runs(qpos, dpos, qpid, dpid, 8),
        jpipe._collapse_diag_runs(qpos, dpos, qpid, dpid, 8))
    assert len(got) < n


@pytest.mark.parametrize("excluded", [False, True])
def test_search_all_host_path_equal_jax(rng, excluded):
    """search_all on the CPU (the library's probe and pair preparation,
    the diag-run collapse on) == the JAX package's, hit for hit."""
    tdb, jdb = _homolog_db(rng)
    ex = EXCLUDE if excluded else None
    nat.reset_calls()
    got = pipeline.ProteinSearcher(tdb, device="cpu").search_all(
        exclude_pairs=ex)
    counts = nat.call_counts()
    want = jpipe.ProteinSearcher(jdb).search_all(batched=True,
                                                 exclude_pairs=ex)
    assert [dataclasses.astuple(h) for h in got] \
        == [dataclasses.astuple(h) for h in want]
    assert got
    for name in ("seed_codes", "argsort_u64", "probe_sorted", "pair_prep",
                 "searchsorted_right"):
        assert counts[name] > 0, counts
    if excluded:
        assert not any(h.query == 0 and h.subject == 1 for h in got)


# ---- the reference's brute force ------------------------------------------

def test_brute_search_cpp_equal_loop_and_jax(rng):
    centers = rng.integers(0, 20, (5, 10)).astype(np.int32)
    kmers = np.repeat(centers, 40, axis=0)
    flip = rng.integers(0, 10, len(kmers))
    kmers[np.arange(len(kmers)), flip] = rng.integers(0, 20, len(kmers))
    kmers = np.concatenate([kmers, rng.integers(0, 20, (300, 10))]) \
        .astype(np.int32)
    radius = 20.0
    ci, ki, dist = nat.brute_search_cpp(centers, kmers, radius)
    jci, jki, jdist = jnat.brute_search_cpp(centers, kmers, radius)
    # the plain loop: per-position sums in the library's order
    dsq = np.asarray(embedding.DISTANCE_SQUARE, np.float64)
    d2 = np.zeros((len(centers), len(kmers)))
    for i in range(centers.shape[1]):
        d2 += dsq[centers[:, i][:, None], kmers[:, i][None, :]]
    wci, wki = np.nonzero(d2 <= radius ** 2)
    _eq(ci, wci.astype(np.int64), jci)
    _eq(ki, wki.astype(np.int64), jki)
    _eq(dist, np.sqrt(d2[wci, wki]), jdist)
    assert 0 < len(ci) < len(centers) * len(kmers)
    # capped: the first max_hits in (center, k-mer) order
    cci, cki, _ = nat.brute_search_cpp(centers, kmers, radius, max_hits=7)
    _eq(cci, ci[:7])
    _eq(cki, ki[:7])


# ---- IVF hit distances ----------------------------------------------------

def _bits(a):
    assert a.dtype == np.float32
    return a.view(np.int32)


@pytest.mark.parametrize("l", [1, 7, 8, 9, 10, 16, 25, 33])
def test_hit_sq_distance_equal_twin(rng, l):
    """2^20 random hits per length, below, at and past numpy's 8-wide
    unroll, the table's first and last rows among them: bitwise equal."""
    n, c, h = 4096, 1024, 1 << 20
    kmers = rng.integers(0, 20, (n, l)).astype(np.int8)
    centers = rng.integers(0, 20, (c, l)).astype(np.int8)
    for lo in range(0, h, 1 << 18):
        hc = rng.integers(0, c, 1 << 18)
        hk = rng.integers(0, n, 1 << 18)
        if lo == 0:
            hc[:4], hk[:4] = [0, c - 1, 0, c - 1], [0, n - 1, n - 1, 0]
        got = nat.hit_sq_distance(centers, hc, kmers, hk)
        want = embedding.hit_sq_distance_np(centers, hc, kmers, hk)
        np.testing.assert_array_equal(_bits(got), _bits(want))
    # int32 centers of the same residues: the same bits
    np.testing.assert_array_equal(
        _bits(nat.hit_sq_distance(centers.astype(np.int32), hc, kmers, hk)),
        _bits(want))


@pytest.mark.parametrize("l", [7, 8, 9, 16, 25, 33, 200])
def test_hit_sq_distance_sums_in_numpys_order(rng, l):
    """On a table of +-2^60 entries beside ones below 1, which cancel, the
    order of the float64 sum shows in the float32 result: the pass sums
    in numpy's order (pairwise, not sequential from 8 terms on) at every
    length."""
    dsq = np.where(rng.random((20, 20)) < 0.3,
                   rng.choice([-1.0, 1.0], (20, 20)) * 2.0 ** 60,
                   rng.random((20, 20)))
    kmers = rng.integers(0, 20, (512, l)).astype(np.int8)
    centers = rng.integers(0, 20, (64, l)).astype(np.int8)
    hc, hk = rng.integers(0, 64, 4096), rng.integers(0, 512, 4096)
    out = np.empty(4096, np.float32)
    assert nat._load().hs_hit_sq_distance(
        centers, 64, kmers, 512, l, hc, hk, 4096, dsq, out) == 0
    terms = dsq[centers[hc], kmers[hk]]
    want = terms.sum(axis=1, dtype=np.float64).astype(np.float32)
    np.testing.assert_array_equal(_bits(out), _bits(want))
    sequential = np.zeros(4096)
    for j in range(l):
        sequential += terms[:, j]
    # below 8 terms numpy's order is the sequential one; from 8 on it is not
    differ = (sequential.astype(np.float32) != want).mean()
    assert differ == 0 if l < 8 else differ > 0.01


def test_hit_sq_distance_every_residue_pair():
    """All 400 residue pairs at L = 25, as constant rows and as rows whose
    residue turns with the position: bitwise the twin, and the table's
    sums."""
    l = 25
    pos = np.arange(l)
    for step in (0, 7):
        rows = ((np.arange(20)[:, None] + step * pos) % 20).astype(np.int8)
        hc, hk = np.divmod(np.arange(400), 20)
        got = nat.hit_sq_distance(rows, hc, rows[::-1].copy(), hk)
        want = embedding.hit_sq_distance_np(rows, hc, rows[::-1].copy(), hk)
        np.testing.assert_array_equal(_bits(got), _bits(want))
        ref = embedding.DISTANCE_SQUARE[rows[hc], rows[::-1][hk]].sum(1)
        np.testing.assert_allclose(got, ref, rtol=1e-6)


def test_hit_sq_distance_no_hits_and_bad_input(rng):
    kmers = rng.integers(0, 20, (64, 25)).astype(np.int8)
    centers = kmers[:8]
    none = np.zeros(0, np.int64)
    for fn in (nat.hit_sq_distance, embedding.hit_sq_distance_np):
        out = fn(centers, none, kmers, none)
        assert out.dtype == np.float32 and out.shape == (0,)
    # the table is read in place: a copy is never made
    for table in (kmers[::2], np.asfortranarray(kmers),
                  kmers.astype(np.int32), kmers.astype(np.uint8)):
        with pytest.raises(ValueError, match="C-contiguous int8"):
            nat.hit_sq_distance(centers, none, table, none)
    one = np.zeros(1, np.int64)
    with pytest.raises(ValueError, match="outside"):
        nat.hit_sq_distance(centers, one, kmers, one + 64)
    with pytest.raises(ValueError, match="outside"):
        nat.hit_sq_distance(centers, one + 8, kmers, one)
    bad = kmers.copy()
    bad[0, 3] = 20
    with pytest.raises(ValueError, match="outside"):
        nat.hit_sq_distance(centers, one, bad, one)
    bad[0, 3] = -1
    with pytest.raises(ValueError, match="outside"):
        nat.hit_sq_distance(centers, one, bad, one)
    with pytest.raises(ValueError, match="0..19"):
        nat.hit_sq_distance(centers.astype(np.int32) + 1, one, kmers, one)


def test_ivf_build_holds_a_table_the_pass_reads(rng):
    """``build_index`` keeps ``host_kmers`` C-contiguous int8 whatever
    the layout and integer type of its input, so the pass reads it in
    place: strided, Fortran-order and int32 databases search to the same
    bits through the library; an index carrying a table the pass cannot
    read raises rather than copy it."""
    from hsearch_tpu_torch.search import ivf
    fam = rng.integers(0, 20, (64, 25), dtype=np.int32)
    db = fam[rng.integers(0, 64, 2048)]
    flips = rng.random(db.shape) < 0.08
    db[flips] = rng.integers(0, 20, int(flips.sum()))
    wide = np.zeros((2048, 50), np.int8)
    wide[:, ::2] = db
    centers = fam[:16]
    kw = dict(k_blocks=16, max_hits=512, retry_overflow=False)
    runs = []
    for table in (db.astype(np.int8), wide[:, ::2], np.asfortranarray(db),
                  db):
        idx = ivf.build_index(table, torch.Generator().manual_seed(0),
                              block_size=32, device="cpu")
        km = idx.host_kmers
        assert km.dtype == np.int8 and km.flags.c_contiguous
        np.testing.assert_array_equal(km, db)
        st: dict = {}
        runs.append((ivf.search(idx, centers, 35.0, stats_out=st, **kw),
                     st))
    (want, st0), *others = runs
    assert len(want[0]) > 100
    assert st0["host_d2_hits"] == len(want[0])
    for got, st in others:
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert st == st0
    bad = dataclasses.replace(idx, host_kmers=np.asfortranarray(km))
    with pytest.raises(ValueError, match="C-contiguous int8"):
        ivf.search(bad, centers, 35.0, **kw)


# ---- threads, build, counters ---------------------------------------------

def test_set_threads_and_default_process_threads():
    assert nat.set_threads(3) == 3
    assert nat.set_threads(0) == 3            # 0 reads the count back
    runtimes = nat.openmp_runtime()
    assert runtimes
    if len(runtimes) == 1:
        # torch and the library load one OpenMP runtime: one pool
        assert torch.get_num_threads() == 3
        assert nat.pin_threads(2) == 2 and torch.get_num_threads() == 2
    nat.set_threads(2)
    for nproc in (1, 2, 3, 64, 0):
        assert nat.default_process_threads(nproc) \
            == jnat.default_process_threads(nproc)
    assert nat.default_process_threads(10**6) == 1


def test_library_built_from_the_ports_source():
    assert nat.available()
    path = nat.lib_path()
    assert nat._load()._name == str(path)
    assert path.parent == nat._BUILD and nat._BUILD.name == "_build"
    assert nat._BUILD.parent.name == "hsearch_tpu_torch"
    assert nat.SOURCE.relative_to(nat._BUILD.parent).as_posix() \
        == "csrc/hostops.cpp"


@pytest.mark.parametrize("cxx", ["/nonexistent/g++", "false"])
def test_failed_build_raises(tmp_path, monkeypatch, cxx):
    """A missing or failing compiler raises RuntimeError with its name,
    leaves nothing behind and swaps in nothing."""
    monkeypatch.setattr(nat, "_BUILD", tmp_path / "fresh")
    monkeypatch.setattr(nat, "_lib", None)
    monkeypatch.setenv("CXX", cxx)
    with pytest.raises(RuntimeError, match=cxx):
        nat.argsort_u64(np.arange(4, dtype=np.uint64))
    with pytest.raises(RuntimeError, match=cxx):
        nat.build()
    assert not nat.available()
    assert nat._lib is None
    fresh = tmp_path / "fresh"
    assert not fresh.exists() or not any(fresh.iterdir())


def test_call_counters():
    nat.reset_calls()
    assert set(nat.call_counts().values()) == {0}
    nat.searchsorted_right(np.arange(4), np.arange(3))
    nat.argsort_u32(np.arange(3, dtype=np.uint32))
    counts = nat.call_counts()
    assert counts["searchsorted_right"] == counts["argsort_u32"] == 1
    assert sum(counts.values()) == 2
    assert set(counts) == {
        "parse_fasta_bytes", "suffix_array", "union_find_labels",
        "brute_search_cpp", "align_gapped", "seed_codes",
        "searchsorted_right", "argsort_u64", "argsort_u32", "pair_prep",
        "probe_sorted", "hit_sq_distance"}


# ---- end to end -------------------------------------------------------------

def _indel_families(n_fam=10, per_fam=4, plen=120, seed=5):
    """Families of near-identical proteins, every other member with a
    2-5 residue deletion, plus random proteins."""
    rng = np.random.default_rng(seed)
    seqs = []
    for _ in range(n_fam):
        base = rng.integers(0, 20, plen).astype(np.int32)
        for m in range(per_fam):
            s = base.copy()
            s[rng.choice(plen, 3, replace=False)] = rng.integers(0, 20, 3)
            if m % 2:
                at, k = int(rng.integers(30, 90)), int(rng.integers(2, 6))
                s = np.concatenate([s[:at], s[at + k:]])
            seqs.append(s)
    for _ in range(5):
        seqs.append(rng.integers(0, 20, int(rng.integers(60, 140)))
                    .astype(np.int32))
    starts = np.concatenate([[0], np.cumsum([len(s) for s in seqs])])
    names = [f"p{i}" for i in range(len(seqs))]
    seq = np.concatenate(seqs)
    return (tio.ProteinDB(names=names, seq=seq, starts=starts),
            jio.ProteinDB(names=names, seq=seq, starts=starts))


def test_cluster_proteins_gapped_equal_jax_through_the_library():
    tdb, jdb = _indel_families()
    jps = [jpc.klsh_init(jax.random.split(jax.random.PRNGKey(1), 1)[0],
                         jpc.FEATURE_SIZE, 12, 0.1)]
    tps = [pcluster.klsh_params_from_arrays(np.asarray(p.w), np.asarray(p.t),
                                            np.asarray(p.b)) for p in jps]
    # no KLSH bit within 1e-5 of its threshold: both packages form the
    # same pre-groups
    feats = jpc.protein_histograms(jdb).astype(np.float64)
    p = jps[0]
    margin = np.cos(feats @ np.asarray(p.w, np.float64)
                    + np.asarray(p.b, np.float64)) + np.asarray(p.t,
                                                                np.float64)
    assert float(np.abs(margin).min()) > 1e-5
    nat.reset_calls()
    got = pcluster.cluster_proteins(tdb, None, bits=12, sigma=0.1,
                                    gapped=True, klsh_params=tps,
                                    device="cpu")
    counts = nat.call_counts()
    want = jpc.cluster_proteins(jdb, jax.random.PRNGKey(1), bits=12,
                                sigma=0.1, gapped=True)
    assert [g.tolist() for g in got.pre_groups] \
        == [g.tolist() for g in want.pre_groups]
    np.testing.assert_array_equal(got.labels, want.labels)
    assert [dataclasses.astuple(h) for h in got.hits] \
        == [dataclasses.astuple(h) for h in want.hits]
    assert any(h.gap_open > 0 for h in got.hits)
    for name in ("align_gapped", "seed_codes", "probe_sorted", "pair_prep"):
        assert counts[name] > 0, counts
    assert os.path.basename(str(nat.lib_path())).startswith("hostops-")
