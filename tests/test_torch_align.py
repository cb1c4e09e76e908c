"""hsearch_tpu_torch/align against hsearch_tpu/align on the CPU: seed codes,
index and probes bitwise, the extension forms and the banded gapped scorer
bitwise in int32, the traceback equal to the native aligner's, the
statistics as exact floats, and ProteinSearcher hits equal field for field
(rendered strings included) with m8/aln files byte-identical."""

import dataclasses
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hsearch_tpu import native_ext
from hsearch_tpu.align import blast_stat as jbs
from hsearch_tpu.align import extend as jext
from hsearch_tpu.align import gapped_device as jgd
from hsearch_tpu.align import pipeline as jpipe
from hsearch_tpu.align import seed_index as jsi
from hsearch_tpu.core import io as jio
from hsearch_tpu_torch.align import blast_stat, extend, gapped_device
from hsearch_tpu_torch.align import hostops, pipeline, reduced, seed_index
from hsearch_tpu_torch.core import blosum
from hsearch_tpu_torch.core import io as tio


def _t(x):
    return torch.as_tensor(np.asarray(x))


# ---- seed codes, index, probes ----------------------------------------------

def _corpus(rng, n=40, lo=3, hi=50, alphabet=22):
    lens = rng.integers(lo, hi, n)
    seq = rng.integers(0, alphabet, int(lens.sum())).astype(np.int32)
    return seq, np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)


def test_reduced_alphabets_and_constants():
    from hsearch_tpu.align import reduced as jred
    for name, table in jred.ALPHABETS.items():
        np.testing.assert_array_equal(reduced.ALPHABETS[name], table)
    assert reduced.SIZES == jred.SIZES and reduced.MASK_GROUP == \
        jred.MASK_GROUP
    x = np.arange(25) % 23
    np.testing.assert_array_equal(reduced.reduce_seq(x), jred.reduce_seq(x))
    assert (seed_index.MER, seed_index.SUFFIX, seed_index.NARROW,
            seed_index.SEED_LEN) == (jsi.MER, jsi.SUFFIX, jsi.NARROW,
                                     jsi.SEED_LEN)


def test_host_codes_and_g10_equal_jax(rng):
    seq, starts = _corpus(rng)
    got = seed_index.host_codes(seq, starts)
    want = jsi.host_codes(seq, starts)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    np.testing.assert_array_equal(seed_index.g10_table(seq, starts),
                                  jsi.g10_table(seq, starts))
    # the numpy twins in the JAX package too (the fallback it tests the
    # native pass against)
    for g, w in zip(got, jsi._host_codes_np(seq, starts)):
        np.testing.assert_array_equal(g, w)


def test_device_codes_equal_jax(rng):
    seq, starts = _corpus(rng)
    code, valid = seed_index._codes_for(_t(seq), _t(starts))
    jcode, jvalid = jsi._codes_for(jnp.asarray(seq),
                                   jnp.asarray(starts, jnp.int32))
    np.testing.assert_array_equal(code.numpy(),
                                  np.asarray(jcode).astype(np.int64))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    probes, v10 = seed_index.query_probe_codes(_t(seq), _t(starts))
    jprobes, jv10 = jsi.query_probe_codes(jnp.asarray(seq),
                                          jnp.asarray(starts, jnp.int32))
    np.testing.assert_array_equal(probes.numpy(),
                                  np.asarray(jprobes).astype(np.int64))
    np.testing.assert_array_equal(v10.numpy(), np.asarray(jv10))
    # the host tables agree with the device codes
    hcode, hv6, hv10, _ = seed_index.host_codes(seq, starts)
    np.testing.assert_array_equal(hcode.astype(np.int64), code.numpy())
    np.testing.assert_array_equal(hv6, valid.numpy())
    np.testing.assert_array_equal(hv10, v10.numpy())


def _group_layout(rng, n_groups, sorted_groups):
    lens = rng.integers(12, 40, 60)
    seq = rng.integers(0, 8, int(lens.sum())).astype(np.int32)
    starts = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    # every id 0..G-1 present (dense), the rest drawn
    groups = rng.permutation(np.concatenate(
        [np.arange(n_groups), rng.integers(0, n_groups, 60 - n_groups)]))
    return seq, starts, np.sort(groups) if sorted_groups else groups


# the three sort branches of the grouped build, and the ungrouped one
BUILD_CASES = {"ungrouped": None, "sorted_groups": (5, True),
               "unsorted_groups": (5, False),
               "many_groups": (40, True)}


@pytest.mark.parametrize("case", sorted(BUILD_CASES))
def test_build_index_and_view_equal_jax(rng, monkeypatch, case):
    spec = BUILD_CASES[case]
    if spec is None:
        seq, starts = _corpus(rng, alphabet=8)
        groups = None
    else:
        seq, starts, groups = _group_layout(rng, *spec)
    if case == "many_groups":
        # take the one-composite-sort branch at a small group count
        monkeypatch.setattr(seed_index, "_SEGMENTED_SORT_MAX_GROUPS", 8)
        monkeypatch.setattr(jsi, "_SEGMENTED_SORT_MAX_GROUPS", 8)
    idx, view = seed_index.build_index_and_view(seq, starts, groups)
    jidx, jview = jsi.build_index_and_view(seq, starts, groups)
    for f in ("sorted_codes", "positions", "seq", "starts", "group_starts",
              "g10_at"):
        g, w = getattr(idx, f), getattr(jidx, f)
        if w is None:
            assert g is None
        else:
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=f)
    np.testing.assert_array_equal(view.keys, jview.keys)
    np.testing.assert_array_equal(view.positions, jview.positions)
    assert view.grouped == jview.grouped
    np.testing.assert_array_equal(seed_index.host_view(idx).keys,
                                  jsi.host_view(jidx).keys)


def test_probe_host_and_bucket_counts_equal_jax(rng):
    seq, starts = _corpus(rng, alphabet=8)          # many collisions
    # four more copies of the first 100 residues: buckets of 5 and more
    seq = np.concatenate([seq] + [seq[:100]] * 4)
    starts = np.concatenate([starts, starts[-1] + 100 * np.arange(1, 5)])
    idx, view = seed_index.build_index_and_view(seq, starts)
    _, jview = jsi.build_index_and_view(seq, starts)
    qseq = rng.integers(0, 8, 300).astype(np.int32)
    qseq[10:110] = seq[:100]
    code, _, v10, qg10 = seed_index.host_codes(qseq,
                                               np.array([0, len(qseq)]))
    q = np.nonzero(v10)[0]
    for cand_max in (512, 3):                        # 3 truncates buckets
        got = seed_index.probe_host(view, code[q], qg10[q], cand_max)
        want = jsi.probe_host(jview, code[q], qg10[q], cand_max)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2]
        np.testing.assert_array_equal(
            seed_index.bucket_counts(view, code[q], cand_max),
            jsi.bucket_counts(jview, code[q], cand_max))
    assert len(got[0]) > 50 and got[2] > 0
    with pytest.raises(ValueError, match="qgroups"):
        seed_index.probe_host(view, code[q], qg10[q], 8,
                              qgroups=np.zeros(len(q), np.int64))


def test_device_probe_equal_jax(rng):
    seq, starts = _corpus(rng, alphabet=8)
    idx, _ = seed_index.build_index_and_view(seq, starts)
    jidx = jsi.build_index(seq, starts)
    qseq = rng.integers(0, 8, 200).astype(np.int32)
    qseq[10:90] = seq[:80]
    qs = np.array([0, len(qseq)])
    codes, _ = seed_index.query_probe_codes(_t(qseq), _t(qs))
    g = seed_index._GROUP21[np.minimum(qseq, 20)]
    off = seed_index.MER + seed_index.NARROW
    qg10 = np.concatenate([g[off:], np.full(off, 10, g.dtype)])
    jcodes, _ = jsi.query_probe_codes(jnp.asarray(qseq),
                                      jnp.asarray(qs, jnp.int32))
    for cand_max in (16, 2):
        got, n_over = seed_index.probe(idx, codes, _t(qg10), cand_max)
        want, jn_over = jsi.probe(jidx, jcodes, jnp.asarray(qg10, jnp.int32),
                                  cand_max=cand_max)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert n_over == int(jn_over)
    # the on-the-fly g10 derivation (an index without the table)
    bare = dataclasses.replace(idx, g10_at=None)
    got2, _ = seed_index.probe(bare, codes, _t(qg10), 16)
    want2, _ = jsi.probe(dataclasses.replace(jidx, g10_at=None), jcodes,
                         jnp.asarray(qg10, jnp.int32), cand_max=16)
    np.testing.assert_array_equal(got2.numpy(), np.asarray(want2))
    assert (got2.numpy() >= 0).sum() > 20


def test_collapse_diag_runs_equal_jax(rng):
    n = 400
    qpos = rng.integers(0, 300, n)
    dpos = qpos + rng.integers(-3, 3, n) * 7
    qpid = rng.integers(0, 4, n)
    dpid = rng.integers(0, 5, n)
    for tol in (1, 6):
        np.testing.assert_array_equal(
            hostops.collapse_diag_runs(qpos, dpos, qpid, dpid, tol),
            jpipe._collapse_diag_runs(qpos, dpos, qpid, dpid, tol))


def test_probe_passes_torch_equal_numpy(rng):
    """The torch twins of the probe passes (what search_all runs on a
    CUDA device) are bitwise the numpy passes, on CPU tensors."""
    lens = rng.integers(12, 60, 50)
    # two residues, two murphy10 groups: buckets of dozens of positions
    seq = rng.integers(0, 2, int(lens.sum())).astype(np.int32)
    starts = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    groups = np.sort(rng.integers(0, 3, 50))
    _, view = seed_index.build_index_and_view(seq, starts, groups)
    code, _, v10, qg10 = seed_index.host_codes(seq, starts)
    qidx = np.nonzero(v10)[0]
    qgroups = np.repeat(groups, lens)[qidx]
    qk = seed_index.query_keys(view, code[qidx], qgroups)
    keys = _t(view.keys.view(np.int64))
    tq = _t(qk.view(np.int64))
    for cand_max in (256, 4):
        np.testing.assert_array_equal(
            hostops.bucket_counts_torch(keys, tq, cand_max).numpy(),
            seed_index.bucket_counts(view, code[qidx], cand_max, qgroups))
        got = hostops.probe_sorted_torch(keys, _t(view.positions), tq,
                                         _t(view.g10_at), _t(qg10[qidx]),
                                         cand_max)
        want = hostops.probe_sorted(view.keys, view.positions, qk,
                                    view.g10_at, qg10[qidx], cand_max)
        np.testing.assert_array_equal(got[0].numpy(), want[0])
        np.testing.assert_array_equal(got[1].numpy(), want[1])
        assert got[2] == want[2]
    assert got[2] > 0 and len(want[0]) > 1000
    rows, dpos = want[0], want[1]
    gids = rng.permutation(60)[:50].astype(np.int64)
    q = np.repeat(np.arange(50), 3)
    excl = np.unique((gids[q].astype(np.uint64) << np.uint64(32))
                     | gids[rng.integers(0, 50, 150)].astype(np.uint64))
    for exclude, tol in ((None, 0), (None, 6), (excl, 6), (excl[:0], 1)):
        g = hostops.pair_prep_torch(
            _t(rows), _t(dpos), _t(qidx.astype(np.int64)), _t(starts),
            _t(gids), None if exclude is None else _t(exclude.view(np.int64)),
            tol)
        w = hostops.pair_prep(rows, dpos, qidx.astype(np.int64), starts,
                              gids, exclude, tol)
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a.numpy(), b)
    assert g[0].dtype == torch.int32 and g[0].shape[1] > 100


def test_search_all_device_probe_branch_equals_jax():
    """search_all with the probe view uploaded (the branch a CUDA device
    takes), run here on CPU tensors: the JAX package's hits, with
    exclude_pairs, query_rows and tiny slices."""
    tdb, jdb = _family_db()
    g = np.arange(tdb.num_proteins) % 3
    subset = np.argsort(g, kind="stable")
    params = dict(probe_chunk=200, pair_budget=100)
    ts = pipeline.ProteinSearcher(tdb, pipeline.SearchParams(**params),
                                  subset=subset, groups=g[subset],
                                  device="cpu")
    ts._upload_probe_view()
    js = jpipe.ProteinSearcher(jdb, jpipe.SearchParams(**params),
                               subset=subset, groups=g[subset])
    excl = np.unique((np.arange(12, dtype=np.uint64) << np.uint64(32))
                     | (np.arange(12, dtype=np.uint64) + np.uint64(8)))
    for call in ({}, {"exclude_pairs": excl},
                 {"query_rows": np.arange(1, 40, 4)}):
        got, want = ts.search_all(**call), js.search_all(**call)
        assert _rows(got) == _rows(want) and len(got) > 10


# ---- extension --------------------------------------------------------------

def _family_lanes(rng, n_prot=24, plen=96, b=512):
    """Lanes over a corpus of one near-identical family plus noise: random
    seeds, same-offset family seeds (long extensions) and lanes hugging
    the window edges (qpos - qlo == plen, qhi - qpos small)."""
    prots = []
    base = rng.integers(0, 20, plen).astype(np.int32)
    for _ in range(n_prot // 2):
        p = base.copy()
        p[rng.integers(0, plen, 3)] = rng.integers(0, 20, 3)
        prots.append(p)
    for _ in range(n_prot // 2):
        prots.append(rng.integers(0, 21, plen).astype(np.int32))
    seq = np.concatenate(prots)
    starts = np.arange(n_prot + 1) * plen
    pid_q = rng.integers(0, n_prot, b)
    pid_d = rng.integers(0, n_prot, b)
    qpos = (starts[pid_q] + rng.integers(0, plen - 12, b)).astype(np.int32)
    dpos = (starts[pid_d] + rng.integers(0, plen - 12, b)).astype(np.int32)
    qpos[:128] = starts[rng.integers(0, n_prot // 2, 128)] + 7
    dpos[:128] = starts[rng.integers(0, n_prot // 2, 128)] + 7
    # the last residues of a protein: extension reaches both window edges
    qpos[128:160] = starts[rng.integers(1, n_prot // 2, 32)] - 10
    dpos[128:160] = starts[rng.integers(1, n_prot // 2, 32)] - 10
    qlo = starts[np.searchsorted(starts, qpos, "right") - 1].astype(np.int32)
    dlo = starts[np.searchsorted(starts, dpos, "right") - 1].astype(np.int32)
    six = np.stack([qpos, dpos, qlo, qlo + plen, dlo,
                    dlo + plen]).astype(np.int32)
    return seq, six, plen


def test_seed_scores_equal_jax(rng):
    seq, six, _ = _family_lanes(rng)
    aa = np.minimum(seq, 20)
    got = extend.seed_scores(_t(aa), _t(aa), _t(six[0]), _t(six[1]), 10)
    want = jext.seed_scores(jnp.asarray(aa), jnp.asarray(aa),
                            jnp.asarray(six[0]), jnp.asarray(six[1]), 10)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert g.dtype == torch.int32


@pytest.mark.parametrize("drop", [5, 9, 30])
def test_extension_forms_equal_jax(rng, drop):
    """extend_pairs (dict), extend_pairs_packed and extend_pairs_windowed
    (window-edge lanes included) each bitwise equal to the JAX package's,
    and the port's windowed form equal to its chunked form."""
    seq, six, plen = _family_lanes(rng)
    s, sj = _t(seq), jnp.asarray(seq)
    packed = extend.extend_pairs_packed(s, s, _t(six), drop, 10)
    jpacked = jext.extend_pairs_packed(sj, sj, jnp.asarray(six),
                                       jnp.int32(drop), 10)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked))
    win = extend.extend_pairs_windowed(s, s, _t(six), drop, 10,
                                       win_pre=plen, win_post=plen + 10)
    jwin = jext.extend_pairs_windowed(sj, sj, jnp.asarray(six),
                                      jnp.int32(drop), 10, win_pre=plen,
                                      win_post=plen + 10)
    np.testing.assert_array_equal(win.numpy(), np.asarray(jwin))
    np.testing.assert_array_equal(win.numpy(), packed.numpy())
    assert packed.dtype == win.dtype == torch.int32
    full = extend.extend_pairs(s, s, *(_t(x) for x in six), drop, 10)
    jfull = jext.extend_pairs(sj, sj, *(jnp.asarray(x) for x in six),
                              jnp.int32(drop), 10)
    assert set(full) == set(jfull)
    for k in full:
        np.testing.assert_array_equal(full[k].numpy(), np.asarray(jfull[k]),
                                      err_msg=k)
    # the family lanes really extend past one chunk and to the edges
    span = packed[5] - packed[4]
    assert int(span.max()) > extend.CHUNK and int((span >= plen - 8).sum())


def test_extend_pairs_high_identity_long_chunked(rng):
    """Identical proteins longer than several chunks: the chunked loops
    run many steps (greedy all the way to the protein ends)."""
    plen = 700
    base = rng.integers(0, 20, plen).astype(np.int32)
    seq = np.concatenate([base, base, rng.integers(0, 20, plen)
                          .astype(np.int32)])
    b = 64
    qpos = rng.integers(0, plen - 12, b).astype(np.int32)
    dpos = (qpos + np.where(np.arange(b) % 2, plen, 2 * plen)) \
        .astype(np.int32)
    dlo = np.where(np.arange(b) % 2, plen, 2 * plen).astype(np.int32)
    six = np.stack([qpos, dpos, np.zeros(b, np.int32),
                    np.full(b, plen, np.int32), dlo, dlo + plen])
    got = extend.extend_pairs_packed(_t(seq), _t(seq), _t(six), 9, 10)
    want = jext.extend_pairs_packed(jnp.asarray(seq), jnp.asarray(seq),
                                    jnp.asarray(six), jnp.int32(9), 10)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got[0, 1]) > 3 * plen      # the whole protein, greedy


# ---- gapped -----------------------------------------------------------------

def _sub21():
    s = np.full((21, 21), extend.NEGSCORE, np.int32)
    s[:20, :20] = blosum.BLOSUM62
    return s


def _gapped_pairs(rng, n_pairs=24, lmax=90):
    qs, ds = [], []
    for _ in range(n_pairs):
        lq = int(rng.integers(12, lmax))
        q = rng.integers(0, 21, lq, dtype=np.int32)
        d = q.copy()
        nmut = int(rng.integers(0, max(1, lq // 6)))
        d[rng.integers(0, lq, nmut)] = rng.integers(0, 20, nmut)
        if lq > 20 and rng.random() < 0.7:
            cut = int(rng.integers(5, lq - 5))
            d = np.concatenate([d[:cut], d[cut + int(rng.integers(1, 4)):]])
        if rng.random() < 0.3:
            d = rng.integers(0, 20, int(rng.integers(12, lmax)),
                             dtype=np.int32)
        qs.append(q)
        ds.append(d)
    q = np.full((n_pairs, max(map(len, qs))), 20, np.int32)
    d = np.full((n_pairs, max(map(len, ds))), 20, np.int32)
    for i, (a, b) in enumerate(zip(qs, ds)):
        q[i, :len(a)] = a
        d[i, :len(b)] = b
    return qs, ds, q, np.array([len(x) for x in qs], np.int32), d, \
        np.array([len(x) for x in ds], np.int32)


@pytest.mark.parametrize("drop", [1 << 20, 30])
def test_banded_scores_equal_jax(rng, drop):
    _, _, q, ql, d, dl = _gapped_pairs(rng)
    sub = _sub21()
    got = gapped_device.banded_scores(_t(q), _t(ql), _t(d), _t(dl),
                                      _t(sub), 11, 1, drop, 16)
    want = jgd.banded_scores(jnp.asarray(q), jnp.asarray(ql),
                             jnp.asarray(d), jnp.asarray(dl),
                             jnp.asarray(sub), 11, 1, drop, 16)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert g.dtype == torch.int32
    assert len(set(got[0].tolist())) > 5


def test_traceback_equals_native(rng):
    if not native_ext.available():
        native_ext.build()
    if not native_ext.available():
        pytest.skip("the JAX package's native library could not be built")
    qs, ds, *_ = _gapped_pairs(rng, n_pairs=12)
    sub = _sub21()
    n_gapped = 0
    for a, b in zip(qs, ds):
        for drop, band in ((27, 32), (30, 8)):
            got = hostops.align_gapped(a, b, sub, 11, 1, drop, band)
            want = native_ext.align_gapped(a, b, sub, 11, 1, drop, band)
            assert got[0] == want[0] and got[2:] == want[2:]
            np.testing.assert_array_equal(got[1], want[1])
            n_gapped += int((got[1] != 0).any())
    assert n_gapped > 3


# ---- statistics -------------------------------------------------------------

def test_blast_stat_exact_floats():
    for gapped in (True, False):
        for db_len, n_seqs in ((1e6, 1000), (3.3e4, 7), (480.0, 4)):
            st = blast_stat.BlastStat(db_len, n_seqs, gapped=gapped)
            jst = jbs.BlastStat(db_len, n_seqs, gapped=gapped)
            for qlen in (5, 11, 120, 999, 5000):
                st.set_query(qlen)
                jst.set_query(qlen)
                assert (st.e_query_len, st.e_db_len,
                        st.expected_hsp_length) == \
                    (jst.e_query_len, jst.e_db_len, jst.expected_hsp_length)
                for raw in (12, 30, 61, 250):
                    assert st.raw_to_expect(raw) == jst.raw_to_expect(raw)
                    assert st.raw_to_bits(raw) == jst.raw_to_bits(raw)
                    assert st.raw_to_expect_log10(raw) == \
                        jst.raw_to_expect_log10(raw)
                raws = np.array([12, 30, 61, 250])
                np.testing.assert_array_equal(st.raw_to_expect_vec(raws),
                                              jst.raw_to_expect_vec(raws))
                np.testing.assert_array_equal(st.raw_to_bits_vec(raws),
                                              jst.raw_to_bits_vec(raws))
                assert st.sum_score_to_expect([60, 45, 31], 300) == \
                    jst.sum_score_to_expect([60, 45, 31], 300)
    assert blast_stat.DEFAULT_CUTOFFS == blast_stat.AlignCutoffs(
        **dataclasses.asdict(jbs.DEFAULT_CUTOFFS))


# ---- the search pipeline ----------------------------------------------------

def _family_db(n=48, plen=60, n_fam=8, seed=1200, long_one=False):
    """Families of near-identical proteins (index i belongs to family
    i % n_fam), some with a short deletion; ``long_one`` appends one
    protein of 600 residues (the chunked extension's regime)."""
    rng = np.random.default_rng(seed)
    seqs = []
    for i in range(n):
        s = np.random.default_rng(seed + 7 + i % n_fam).integers(0, 20, plen)
        s[rng.choice(plen, 2, replace=False)] = rng.integers(0, 20, 2)
        if i % 5 == 3:
            s = np.concatenate([s[:30], s[33:]])
        seqs.append(s.astype(np.int32))
    if long_one:
        long = np.concatenate([seqs[0]] * 10)
        long[rng.integers(0, len(long), 20)] = rng.integers(0, 20, 20)
        seqs.append(long)
    starts = np.concatenate([[0], np.cumsum([len(s) for s in seqs])])
    names = [f"p{i}" for i in range(len(seqs))]
    seq = np.concatenate(seqs)
    return (tio.ProteinDB(names=names, seq=seq, starts=starts),
            jio.ProteinDB(names=names, seq=seq, starts=starts))


def _rows(hits):
    return [dataclasses.astuple(h) for h in hits]


SEARCH_CASES = {
    "ungrouped": dict(),
    "grouped": dict(grouped=True),
    "unsorted_subset": dict(subset=[5, 2, 7, 0, 3, 11, 13, 21],
                            params=dict(max_m8_per_query=3,
                                        max_aln_per_query=3)),
    "exclude_pairs": dict(grouped=True, exclude=True),
    "query_rows": dict(grouped=True, query_rows=True),
    "tiny_budgets": dict(grouped=True,
                         params=dict(probe_chunk=130, pair_budget=64,
                                     pair_batch=64), render_chunk=7),
    "chunked_extension": dict(long_one=True),
    "unbatched": dict(grouped=True, batched=False),
}


@pytest.mark.parametrize("case", sorted(SEARCH_CASES))
def test_search_all_equals_jax(monkeypatch, case):
    spec = SEARCH_CASES[case]
    tdb, jdb = _family_db(long_one=spec.get("long_one", False))
    n = tdb.num_proteins
    subset = groups = None
    if spec.get("grouped"):
        g = np.arange(n) % 3
        subset = np.argsort(g, kind="stable")
        groups = g[subset]
    if "subset" in spec:
        subset = np.array(spec["subset"])
    if "render_chunk" in spec:
        monkeypatch.setattr(pipeline, "_RENDER_CHUNK", spec["render_chunk"])
        monkeypatch.setattr(jpipe, "_RENDER_CHUNK", spec["render_chunk"])
    kw = spec.get("params", {})
    ts = pipeline.ProteinSearcher(tdb, pipeline.SearchParams(**kw),
                                  subset=subset, groups=groups, device="cpu")
    js = jpipe.ProteinSearcher(jdb, jpipe.SearchParams(**kw), subset=subset,
                               groups=groups)
    assert ts.windowed == (not spec.get("long_one", False))
    call = {}
    if spec.get("exclude"):
        # drop the pairs of queries 0..9 with their family members
        q = np.repeat(np.arange(10), 4)
        s = (q + np.tile(np.arange(4), 10) * 8) % n
        call["exclude_pairs"] = np.unique(
            (q.astype(np.uint64) << np.uint64(32)) | s.astype(np.uint64))
    if spec.get("query_rows"):
        call["query_rows"] = np.arange(0, n, 3)
    if "batched" in spec:
        call["batched"] = spec["batched"]
    got, want = ts.search_all(**call), js.search_all(**call)
    assert _rows(got) == _rows(want)
    assert len(got) > 10
    assert all(h.q_aln and h.info for h in got)
    if case == "tiny_budgets":
        streamed = []
        assert ts.search_all(hit_sink=streamed.extend) == []
        assert _rows(streamed) == _rows(want)
        unrendered = ts.search_all(render=False)
        assert [r[:13] for r in _rows(unrendered)] == \
            [r[:13] for r in _rows(want)]
        assert not any(h.q_aln for h in unrendered)
    # m8 and aln byte-identical
    for writer, jwriter in ((pipeline.write_m8, jpipe.write_m8),
                            (pipeline.write_aln, jpipe.write_aln)):
        a, b = io.StringIO(), io.StringIO()
        writer(a, got, tdb.names, tdb.names)
        jwriter(b, want, jdb.names, jdb.names)
        assert a.getvalue() == b.getvalue()


def test_search_sequence_and_refine_gapped_equal_jax():
    tdb, jdb = _family_db(n=24)
    ts = pipeline.ProteinSearcher(tdb, device="cpu")
    js = jpipe.ProteinSearcher(jdb)
    n_refined = 0
    for qi in (0, 3, 8):
        q = np.asarray(tdb.protein(qi))
        got = ts.search_sequence(q, query_idx=qi)
        want = js.search_sequence(q, query_idx=qi)
        assert _rows(got) == _rows(want) and got
        rg = pipeline.refine_gapped(ts, q, got)
        rw = jpipe.refine_gapped(js, q, want)
        assert _rows(rg) == _rows(rw)
        n_refined += sum(h.gap_open > 0 for h in rg)
    assert n_refined > 0
    # the batched form over all three queries at once
    queries = [(np.asarray(tdb.protein(qi)),
                ts.search_sequence(np.asarray(tdb.protein(qi)),
                                   query_idx=qi)) for qi in (0, 3, 8)]
    per_query = [pipeline.refine_gapped(ts, q, h) for q, h in queries]
    assert [_rows(x) for x in pipeline.refine_gapped_all(ts, queries)] == \
        [_rows(x) for x in per_query]
    with pytest.raises(ValueError, match="group-partitioned"):
        pipeline.ProteinSearcher(tdb, subset=np.arange(4),
                                 groups=np.array([0, 0, 1, 1]),
                                 device="cpu").search_sequence(
            np.asarray(tdb.protein(0)))


def test_write_aln_max_out_and_m8_formats():
    hits = [pipeline.Hit(query=0, subject=1, score=80, bits=33.25,
                         evalue=e, identity=97.5, aln_len=40, mismatch=1,
                         gap_open=0, q_beg=1, q_end=40, d_beg=2, d_end=41,
                         q_aln="AR", d_aln="AR", info="AR")
            for e in (1e-30, 0.5, 12.0)]
    jhits = [jpipe.Hit(**dataclasses.asdict(h)) for h in hits]
    names = ["a", "b"]
    for kw in ({}, {"max_out": 2}):
        a, b = io.StringIO(), io.StringIO()
        pipeline.write_aln(a, hits, names, names, **kw)
        jpipe.write_aln(b, jhits, names, names, **kw)
        assert a.getvalue() == b.getvalue()
    a, b = io.StringIO(), io.StringIO()
    pipeline.write_m8(a, hits, names, names)
    jpipe.write_m8(b, jhits, names, names)
    assert a.getvalue() == b.getvalue() and len(a.getvalue().split()) == 36
