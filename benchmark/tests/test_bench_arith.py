"""The copied recall arithmetic, the judge's sums and the roofline counts,
on hand-worked cases."""

import numpy as np
import pytest
import torch

from benchmark import judge, recall, reference, roofline
from benchmark.hitlog import HitLog


def test_weight_hand_worked():
    assert recall.weight(10.0, 35.0) == 1.0
    assert recall.weight(25.0, 35.0) == 1.0
    assert recall.weight(26.0, 35.0) == 0.5
    assert recall.weight(34.0, 35.0) == pytest.approx(0.1)
    got = recall.weight_array(np.array([0.0, 10.0, 25.0, 26.0, 28.0, 34.0]))
    np.testing.assert_allclose(got, [1, 1, 1, 0.5, 0.25, 0.1])


def test_recall_from_indices_hand_worked():
    tc, tk = np.array([0, 0, 1, 1]), np.array([1, 2, 3, 4])
    td = np.array([10.0, 26.0, 28.0, 34.0])     # weights 1, .5, .25, .1
    got = recall.recall_from_indices(tc, tk, td, np.array([0, 1]),
                                     np.array([1, 3]), 35.0)
    assert got == pytest.approx(1.25 / 1.85)
    assert recall.recall_from_indices(tc[:0], tk[:0], td[:0], tc, tk,
                                      35.0) == 1.0


def _case():
    g = torch.Generator().manual_seed(3)
    db = torch.randint(0, 20, (8, 3), generator=g, dtype=torch.int8)
    pool = torch.randint(0, 20, (2, 3), generator=g, dtype=torch.int8)
    tc, tr = torch.tensor([0, 0, 1, 1]), torch.tensor([1, 2, 3, 4])
    td2 = torch.tensor([10.0, 26.0, 28.0, 34.0], dtype=torch.float64) ** 2
    return db, pool, (tc, tr, td2)


def test_judge_recall_matches_copied_arithmetic():
    db, pool, truth = _case()
    ids = np.array([0, 1])
    one = (ids, (np.array([0, 1]), np.array([1, 3]),
                 np.array([10.0, 28.0], np.float32)))
    got = judge.compare(HitLog.of(8, [one]), truth, db, pool, 35.0)
    assert got["recall"] == pytest.approx(1.25 / 1.85)
    assert got["hit_error"] < 1e-7
    # a second batch of the same centers returns every true hit, one twice
    two = (ids, (np.array([0, 0, 0, 1, 1]), np.array([1, 1, 2, 3, 4]),
                 np.array([10, 10, 26, 28, 34], np.float32)))
    got = judge.compare(HitLog.of(8, [one, two]), truth, db, pool, 35.0)
    assert got["recall"] == pytest.approx((1.25 + 1.85) / 3.7)
    # the hit the second batch returned twice is one duplicate; the same
    # hit in two batches is none
    assert got["duplicates"] == 1
    assert judge.compare(HitLog.of(8, [one, one]), truth, db, pool,
                         35.0)["duplicates"] == 0
    # a batch sent but answered by a center outside it: inf, and no recall
    bad = (np.array([1]), (np.array([1]), np.array([3]),
                           np.array([28.0], np.float32)))
    got = judge.compare(HitLog.of(8, [bad]), truth, db, pool, 35.0)
    assert got["hit_error"] == float("inf") and got["recall"] == 0.0


def test_judge_hit_outside_truth_uses_reference_distance():
    db, pool, truth = _case()
    d2 = float(reference.pair_d2(db, pool, torch.tensor([0]),
                                 torch.tensor([5]))[0])
    hit = (np.array([0]), (np.array([0]), np.array([5]),
                           np.array([np.sqrt(d2)], np.float32)))
    got = judge.compare(HitLog.of(8, [hit]), truth, db, pool, 35.0)
    want = max(d2 - 35.0 ** 2, 0.0) / 35.0 ** 2
    assert got["hit_error"] == pytest.approx(want, rel=1e-6, abs=1e-7)
    assert got["outside_truth"] == 1


def test_checks_against_limits():
    cfg = {"correct": {"recall_min": 0.99, "hit_error_max": 1e-5}}
    sound = {"recall": 0.995, "hit_error": 2e-7, "duplicates": 0}
    ok = judge.checks(sound, 0, cfg)
    assert all(c["ok"] for c in ok.values())
    assert not judge.checks(dict(sound, recall=0.989), 0,
                            cfg)["recall"]["ok"]
    assert not judge.checks(dict(sound, hit_error=2e-5), 0,
                            cfg)["hit_error"]["ok"]
    assert not judge.checks(dict(sound, duplicates=1), 0,
                            cfg)["duplicates"]["ok"]
    assert not judge.checks(sound, 1, cfg)["failed_batches"]["ok"]


def test_prune_count_from_shape():
    # C=1024, B=131,072, D=200: 3 x 2CBD = 1.6106e11 flops at 495 TFLOP/s
    # = 3.2537e-4 s; bytes 4*(C*D + B*D + B + C*Bp + C*Bp/64 + C)
    # = 651,464,704 -> 1.9447e-4 s: bound by operations
    c, b, d = 1024, 131072, 200
    assert roofline.prune_least_s(c, b, d) == pytest.approx(
        6.0 * c * b * d / 495e12)
    t, by = roofline.bound_s(6.0 * c * b * d, 651_464_704,
                             roofline.PEAK_TF32_FLOPS)
    assert by == "operations" and t == pytest.approx(3.2537e-4, rel=1e-4)
    # a thin product is bound by its bytes; B is padded to 64 blocks
    bp = 128
    nbytes = 4.0 * (8 * 200 + 100 * 200 + 100 + 8 * bp + 8 * bp // 64 + 8)
    assert roofline.prune_least_s(8, 100, 200) == pytest.approx(
        nbytes / 3.35e12)


def test_verify_count_from_shape():
    # 4*C*L*20 + 12*C*kb + 4*C*kb*bs + 4*C = 2,048,000 + 3,145,728
    # + 33,554,432 + 4,096 = 38,752,256 bytes at 3.35 TB/s
    assert roofline.verify_least_s(1024, 256, 32, 25) == pytest.approx(
        38_752_256 / 3.35e12)
