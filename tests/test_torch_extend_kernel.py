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
"""

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
