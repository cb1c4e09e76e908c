"""The extend_pairs kernel's algorithm on the CPU.

``extend_lane`` is a per-lane scalar numpy reference of
hsearch_tpu_torch/csrc/extend_pairs.cu, written step for step as the
kernel runs (seed, greedy forward and backward, x-drop forward and
backward; accumulate, update the maximum, then test the stop).  On
seeded workloads it equals, in all 8 PACK_KEYS fields, the kernel's plain
version (the port's chunked ``extend_pairs_packed``), the window-dense
form where its window holds every extension, the wrapper's CPU path and
the JAX package's ``extend_pairs_packed``.  ``extend_batch`` on a CPU
searcher keeps its form: window-dense up to 512 residues, chunked beyond.

``extend_lane_group`` is a numpy model of the kernel's group algorithm,
step for step at group width G (the kernel's warp of 32, and 8 and 16,
since the algorithm does not depend on the width): the G pairs of a step
read at once, greedy's first failure from a ballot, x-drop's Hillis-Steele
inclusive sum scan from the carried score, its max scan keeping the first
maximum's rank, the stop test against max(carried max, scan) - drop and
the first violation from a ballot.  It equals the scalar reference at
every width, and the chunked form at chunk width G equals the JAX
package's: the width changes nothing.  kernel_checks.extend_tie_inputs
makes the running maximum tie across chunk boundaries at every width.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hsearch_tpu.align import extend as jext
from hsearch_tpu_torch.align import extend, pipeline, seed_index
from hsearch_tpu_torch.examples.bench_align import protein_families
from hsearch_tpu_torch.ops import cuda_kernels as ck
from hsearch_tpu_torch.ops import kernel_checks as kc

SUB, GRP = extend._SUB, extend._GROUP
MINSCORE = extend.MINSCORE
PAST_BOUND = -(10 ** 6)


def _aa(s, i):
    i = min(max(i, 0), len(s) - 1)
    return min(max(int(s[i]), 0), 20)


def _greedy(q, d, q0, d0, limit, sign):
    ext = score = match = 0
    while ext < limit:
        a, b = _aa(q, q0 + sign * ext), _aa(d, d0 + sign * ext)
        if GRP[a] != GRP[b] or GRP[a] >= 10:
            break
        score += SUB[a, b]
        match += a == b and a < 20
        ext += 1
    return ext, score, match


def _xdrop(q, d, q0, d0, limit, sign, score0, drop):
    if score0 < MINSCORE:
        return 0, 0, 0
    s = maxs = score0
    m = best_ext = best_match = 0
    i = 0
    while True:
        if i < limit:
            a, b = _aa(q, q0 + sign * i), _aa(d, d0 + sign * i)
            s += SUB[a, b]
            m += a == b and a < 20
        else:
            s += PAST_BOUND
        if s > maxs:
            maxs, best_ext, best_match = s, i + 1, m
        if s < MINSCORE or s < maxs - drop:
            break
        i += 1
    return maxs - score0, best_ext, best_match


def extend_lane(q, d, lane, drop, seed_len=10):
    """One lane (qpos, dpos, qlo, qhi, dlo, dhi) -> its 8 PACK_KEYS."""
    qpos, dpos, qlo, qhi, dlo, dhi = (int(x) for x in lane)
    score = match = 0
    for i in range(seed_len):
        a, b = _aa(q, qpos + i), _aa(d, dpos + i)
        score += SUB[a, b]
        match += a == b and a < 20
    fwd = max(0, min(qhi - (qpos + seed_len), dhi - (dpos + seed_len)))
    gf, s_, m_ = _greedy(q, d, qpos + seed_len, dpos + seed_len, fwd, 1)
    score, match = score + s_, match + m_
    bwd = max(0, min(qpos - qlo, dpos - dlo))
    gb, s_, m_ = _greedy(q, d, qpos - 1, dpos - 1, bwd, -1)
    score, match = score + s_, match + m_
    local = seed_len + gf + gb
    q_seed, d_seed = qpos - gb, dpos - gb
    xf_lim = max(0, min(qhi - (q_seed + local), dhi - (d_seed + local)))
    xf_s, xf_ext, xf_m = _xdrop(q, d, q_seed + local, d_seed + local,
                                xf_lim, 1, score, drop)
    xb_lim = max(0, min(q_seed - qlo, d_seed - dlo))
    xb_s, xb_ext, xb_m = _xdrop(q, d, q_seed - 1, d_seed - 1, xb_lim, -1,
                                score, drop)
    return (score + xf_s + xb_s, match + xf_m + xb_m, score, match,
            q_seed - xb_ext, q_seed + local + xf_ext, d_seed - xb_ext,
            d_seed + local + xf_ext)


def extend_reference(q, d, six, drop, seed_len=10):
    """(6, B) lanes -> (8, B) int32, lane by lane."""
    return np.array([extend_lane(q, d, six[:, j], drop, seed_len)
                     for j in range(six.shape[1])],
                    np.int32).reshape(-1, 8).T


# ---- workloads: (seq, six, plen), each from its own seed -------------------

def _lanes(rng, starts, plen, b, off_q=None, off_d=None, same=False):
    n = len(starts) - 1
    pq, pd = rng.integers(0, n, b), rng.integers(0, n, b)
    oq = rng.integers(0, plen - 9, b) if off_q is None else off_q
    od = (oq if same else rng.integers(0, plen - 9, b)) if off_d is None \
        else off_d
    return np.stack([starts[pq] + oq, starts[pd] + od, starts[pq],
                     starts[pq] + plen, starts[pd],
                     starts[pd] + plen]).astype(np.int32)


def _random(rng):
    plen = 90
    seq = rng.integers(0, 20, 30 * plen).astype(np.int32)
    return seq, _lanes(rng, np.arange(31) * plen, plen, 300), plen


def _high_identity(rng):
    plen = 200
    base = rng.integers(0, 20, plen)
    prots = [base.copy() for _ in range(12)]
    for p in prots:
        p[rng.integers(0, plen, 1)] = rng.integers(0, 20, 1)
    seq = np.concatenate(prots).astype(np.int32)
    return seq, _lanes(rng, np.arange(13) * plen, plen, 200,
                       same=True), plen


def _long(rng):
    """Proteins past 512 residues, near-identical: greedy and x-drop runs
    hundreds of residues long, over many of the chunked form's steps."""
    plen = 700
    base = rng.integers(0, 20, plen)
    prots = [base.copy() for _ in range(6)]
    for p in prots:
        p[rng.integers(0, plen, 3)] = rng.integers(0, 20, 3)
    seq = np.concatenate(prots).astype(np.int32)
    return seq, _lanes(rng, np.arange(7) * plen, plen, 96, same=True), plen


def _bounds(rng):
    """Seeds on a protein's first residue (no backward room) and ending on
    its last (no forward room), in both sequences."""
    plen = 64
    base = rng.integers(0, 20, plen)
    seq = np.concatenate([base] * 10).astype(np.int32)
    b = 200
    edge = rng.integers(0, 2, b) * (plen - 10)
    return seq, _lanes(rng, np.arange(11) * plen, plen, b, off_q=edge,
                       off_d=edge), plen


def _unknown(rng):
    """Residues at and above 20 (unknown), clipped to 20: they score -5
    and never match or extend greedily."""
    plen = 80
    base = rng.integers(0, 26, plen)
    prots = []
    for _ in range(16):
        p = base.copy()
        p[rng.integers(0, plen, 4)] = rng.integers(0, 26, 4)
        prots.append(p)
    seq = np.concatenate(prots).astype(np.int32)
    return seq, _lanes(rng, np.arange(17) * plen, plen, 200, same=True), plen


def _low_gate(rng):
    """Seeds whose post-greedy score is below MINSCORE: no x-drop."""
    plen = 60
    seq = rng.choice([20, 21, 25], 8 * plen).astype(np.int32)
    seq[:plen] = rng.integers(0, 20, plen)
    return seq, _lanes(rng, np.arange(9) * plen, plen, 64), plen


def _mixed(rng):
    seq, six = kc.extend_inputs(rng)
    return seq, six, 96


WORKLOADS = {"random": _random, "high_identity": _high_identity,
             "long": _long, "bounds": _bounds, "unknown": _unknown,
             "low_gate": _low_gate, "mixed": _mixed}


def _t(x):
    return torch.as_tensor(np.asarray(x))


@pytest.mark.parametrize("name", list(WORKLOADS))
@pytest.mark.parametrize("drop", [9, 30])
def test_reference_equals_every_form(name, drop):
    rng = np.random.default_rng(sorted(WORKLOADS).index(name) * 10 + drop)
    seq, six, plen = WORKLOADS[name](rng)
    want = extend_reference(seq, seq, six, drop)
    s, x = _t(seq), _t(six)
    ck.reset_launches()
    got = ck.extend_pairs(s, s, x, drop)
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        extend.extend_pairs_packed(s, s, x, drop).numpy(), want)
    jw = jext.extend_pairs_packed(jnp.asarray(seq), jnp.asarray(seq),
                                  jnp.asarray(six), jnp.int32(drop), 10)
    np.testing.assert_array_equal(np.asarray(jw), want)
    # the window-dense form, at the pipeline's window (every lane's
    # extension fits it)
    win = -(-plen // 64) * 64
    np.testing.assert_array_equal(extend.extend_pairs_windowed(
        s, s, x, drop, 10, win_pre=win, win_post=win).numpy(), want)
    assert ck.launch_counts()["extend_pairs"] == 0
    # the case each workload is there for really occurs
    gate, span = want[2], want[5] - want[4]
    if name == "low_gate":
        low = gate < MINSCORE
        assert low.sum() > 8 and (span[low] == 10).all()
    if name == "long":
        assert span.max() > 512
    if name == "bounds":
        assert (want[4] == six[2]).sum() > 20 and \
            (want[7] == six[5]).sum() > 20
    if name == "unknown":
        assert (seq >= 20).mean() > 0.1
    if name in ("high_identity", "mixed"):
        assert span.max() > extend.CHUNK


def test_wrapper_reads_a_column_slice_in_place():
    """A column slice of a wider batch (what _extend_stream hands over)
    gives the same lanes as the whole batch."""
    seq, six = kc.extend_inputs(np.random.default_rng(3), b=300)
    s, x = _t(seq), _t(six)
    whole = ck.extend_pairs(s, s, x, 9)
    part = x[:, 100:250]
    assert not part.is_contiguous()
    assert torch.equal(ck.extend_pairs(s, s, part, 9), whole[:, 100:250])
    assert torch.equal(ck.extend_pairs_plain(s, s, part, 9),
                       whole[:, 100:250])


@pytest.mark.parametrize("plen,windowed", [(120, True), (600, False)])
def test_extend_batch_on_cpu_keeps_its_form(monkeypatch, plen, windowed):
    """On the CPU extend_batch takes the window-dense form when every
    protein has at most 512 residues, else the kernel wrapper's plain
    version (the chunked form); both give the reference's result."""
    db, _ = protein_families(24, plen=plen, seed=5)
    s = pipeline.ProteinSearcher(db, device="cpu")
    assert s.windowed == windowed
    calls = []
    for mod, name in ((extend, "extend_pairs_windowed"),
                      (ck, "extend_pairs_plain")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _n=name, **k:
                            calls.append(_n) or _r(*a, **k))
    rng = np.random.default_rng(plen)
    pid = rng.integers(0, 24, (2, 200))
    off = rng.integers(0, plen - 10, (2, 200))
    six = np.stack([s.starts[pid[0]] + off[0], s.starts[pid[1]] + off[1],
                    s.starts[pid[0]], s.starts[pid[0] + 1],
                    s.starts[pid[1]], s.starts[pid[1] + 1]]).astype(np.int32)
    got = s.extend_batch(_t(six))
    assert calls == ["extend_pairs_windowed" if windowed
                     else "extend_pairs_plain"]
    want = extend_reference(s.seq, s.seq, six,
                            int(s.cutoffs.ungap_ext_drop),
                            seed_index.SEED_LEN)
    np.testing.assert_array_equal(got.numpy(), want)


# ---- the kernel's group algorithm, step for step ---------------------------

def _pairs(q, d, q0, d0, sign, i):
    """The clamped residue pairs at offsets i (a numpy vector) from
    (q0, d0) in direction sign, as the group's threads read them."""
    def at(s, x):
        return np.clip(s[np.clip(x, 0, len(s) - 1)], 0, 20)
    return at(q, q0 + sign * i), at(d, d0 + sign * i)


def _scan_sum(x):
    """Hillis-Steele inclusive sum over the group (shuffle up by 1, 2, 4,
    ...; rank t adds rank t - o where t >= o)."""
    o = 1
    while o < len(x):
        y = x.copy()
        y[o:] += x[:-o]
        x, o = y, o * 2
    return x


def _scan_max(x):
    """Hillis-Steele inclusive max with the first maximum's rank: rank t
    takes rank t - o's pair where that value is >= its own."""
    m, arg, o = x.copy(), np.arange(len(x)), 1
    while o < len(x):
        take = np.zeros(len(x), bool)
        take[o:] = m[:-o] >= m[o:]
        m2, a2 = m.copy(), arg.copy()
        m2[o:] = np.where(take[o:], m[:-o], m[o:])
        a2[o:] = np.where(take[o:], arg[:-o], arg[o:])
        m, arg, o = m2, a2, o * 2
    return m, arg


def _first(ballot, default):
    hit = np.flatnonzero(ballot)
    return int(hit[0]) if hit.size else default


def _greedy_group(q, d, q0, d0, limit, sign, g):
    ext = score = match = 0
    while True:
        i = ext + np.arange(g)
        a, b = _pairs(q, d, q0, d0, sign, i)
        run = _first(~((i < limit) & (GRP[a] == GRP[b]) & (GRP[a] < 10)), g)
        score += int(SUB[a[:run], b[:run]].sum())
        match += int(((a == b) & (a < 20))[:run].sum())
        ext += run
        if run < g:
            return ext, score, match


def _xdrop_group(q, d, q0, d0, limit, sign, score0, drop, g, events):
    if score0 < MINSCORE:
        return 0, 0, 0
    s = maxs = score0
    m_tot = l_tot = best_ext = best_match = 0
    while True:
        i = l_tot + np.arange(g)
        a, b = _pairs(q, d, q0, d0, sign, i)
        inr = i < limit
        mb = inr & (a == b) & (a < 20)
        sc = _scan_sum(np.where(inr, SUB[a, b], PAST_BOUND).astype(np.int64)) \
            + s
        mx, arg = _scan_max(sc)
        viol = (sc < MINSCORE) | (sc < np.maximum(maxs, mx) - drop)
        stop = _first(viol, g - 1)
        if mx[stop] > maxs:
            maxs = int(mx[stop])
            best_ext = l_tot + int(arg[stop]) + 1
            best_match = m_tot + int(mb[:arg[stop] + 1].sum())
        elif mx[stop] == maxs and best_ext > 0:
            events["tie_across_chunks"] += 1
        if (sc[:stop + 1] == mx[stop]).sum() > 1:
            events["tie_in_chunk"] += 1
        if l_tot + stop >= limit:
            events["past_bound_stop"] += 1
        s = int(sc[stop])
        m_tot += int(mb[:stop + 1].sum())
        l_tot += stop + 1
        if viol.any():
            return maxs - score0, best_ext, best_match


def extend_lane_group(q, d, lane, drop, g, events, seed_len=10):
    """One lane as the kernel's group of g threads runs it -> its 8
    PACK_KEYS; ``events`` counts what the x-drop steps met."""
    qpos, dpos, qlo, qhi, dlo, dhi = (int(x) for x in lane)
    a, b = _pairs(q, d, qpos, dpos, 1, np.arange(seed_len))
    score = int(SUB[a, b].sum())
    match = int(((a == b) & (a < 20)).sum())
    fwd = max(0, min(qhi - (qpos + seed_len), dhi - (dpos + seed_len)))
    gf, s_, m_ = _greedy_group(q, d, qpos + seed_len, dpos + seed_len, fwd,
                               1, g)
    score, match = score + s_, match + m_
    bwd = max(0, min(qpos - qlo, dpos - dlo))
    gb, s_, m_ = _greedy_group(q, d, qpos - 1, dpos - 1, bwd, -1, g)
    score, match = score + s_, match + m_
    if score < MINSCORE:
        events["low_gate"] += 1
    local = seed_len + gf + gb
    q_seed, d_seed = qpos - gb, dpos - gb
    xf_lim = max(0, min(qhi - (q_seed + local), dhi - (d_seed + local)))
    xf_s, xf_ext, xf_m = _xdrop_group(q, d, q_seed + local, d_seed + local,
                                      xf_lim, 1, score, drop, g, events)
    xb_lim = max(0, min(q_seed - qlo, d_seed - dlo))
    xb_s, xb_ext, xb_m = _xdrop_group(q, d, q_seed - 1, d_seed - 1, xb_lim,
                                      -1, score, drop, g, events)
    return (score + xf_s + xb_s, match + xf_m + xb_m, score, match,
            q_seed - xb_ext, q_seed + local + xf_ext, d_seed - xb_ext,
            d_seed + local + xf_ext)


def _ties(rng):
    seq, six = kc.extend_tie_inputs(rng)
    return seq, six, int((six[3] - six[2]).max())


CASES = {**WORKLOADS, "ties": _ties}


@functools.lru_cache(maxsize=None)
def _case(name, drop):
    """(seq, six, the scalar reference's result) of a workload; seeded by
    the workload's name and the drop alone."""
    rng = np.random.default_rng(list(CASES).index(name) * 100 + drop + 7)
    seq, six, _ = CASES[name](rng)
    return seq, six, extend_reference(seq, seq, six, drop)


@pytest.mark.parametrize("g", [8, 16, 32])
@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("drop", [9, 30])
def test_group_algorithm_is_the_scalar_reference(g, name, drop):
    seq, six, want = _case(name, drop)
    # long proteins: every third lane keeps the case inside its time
    lanes = range(0, six.shape[1], 3 if name == "long" else 1)
    events = dict.fromkeys(("tie_across_chunks", "tie_in_chunk",
                            "past_bound_stop", "low_gate"), 0)
    got = np.array([extend_lane_group(seq, seq, six[:, j], drop, g, events)
                    for j in lanes], np.int32).T
    np.testing.assert_array_equal(got, want[:, list(lanes)])
    if name == "ties":
        assert events["tie_across_chunks"] > 20, events
        assert events["tie_in_chunk"] > 20, events
        assert events["past_bound_stop"] > 20, events
        assert events["low_gate"] >= six.shape[1] // 8, events


@pytest.mark.parametrize("g", [8, 16, 32])
@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("drop", [9, 30])
def test_chunk_width_changes_nothing(monkeypatch, g, name, drop):
    """The port's chunked extend_pairs_packed at chunk width g (the
    kernel's group width) equals the JAX package's extend_pairs_packed in
    all 8 fields."""
    seq, six, want = _case(name, drop)
    monkeypatch.setattr(extend, "CHUNK", g)
    got = extend.extend_pairs_packed(_t(seq), _t(seq), _t(six), drop)
    jw = jext.extend_pairs_packed(jnp.asarray(seq), jnp.asarray(seq),
                                  jnp.asarray(six), jnp.int32(drop), 10)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(got.numpy(), want)
