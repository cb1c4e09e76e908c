"""Recall evaluation of accelerated search vs the brute-force oracle (own
copy of hsearch_tpu/search/evaluate.py; pure numpy).

Matches (center, kmer) pairs between the exact hit set and the accelerated
output and reports the distance-weighted recall TP / (TP + FN) with the
reference's weight (motif_both_points.cpp:67-87), plus the per-distance-bin
accuracy histogram written to ``<out>.accuracy.txt``; and the MEME-vs-search
motif coverage comparison of evaluate.cpp.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def weight(dis: float, radius: float) -> float:
    """Distance weight: 1 below distance 24; 1/(dis-24) above, clipped into
    [0, 1] (1 for out-of-range values of the reciprocal)."""
    if dis < 1e-7 or dis < 24.0:
        return 1.0
    w = 1.0 / (dis - 24.0)
    if w > 1.0 or w < 0.0:
        return 1.0
    return w


PIVOT2 = 49.38


def weight2(dis: float) -> float:
    """The offline evaluator's pivot-49.38 weighting."""
    if dis > PIVOT2:
        return min(dis / (2 * PIVOT2), 1.0)
    return 1.0 - dis / (2 * PIVOT2)


def weight_array(dis: np.ndarray) -> np.ndarray:
    """Vectorized weight()."""
    dis = np.asarray(dis, np.float64)
    w = np.where(dis < 24.0, 1.0, 1.0 / np.maximum(dis - 24.0, 1e-30))
    return np.clip(np.where((w > 1.0) | (w < 0.0), 1.0, w), 0.0, 1.0)


@dataclasses.dataclass
class RecallReport:
    tp: float
    fn: float
    recall: float
    n_truth: int
    n_found: int
    n_missed: int
    bins: dict  # bin -> (accuracy, tp_count, fn_count)


def weighted_recall(truth_pairs, truth_dist, found_pairs,
                    radius: float,
                    weighting: str = "search") -> RecallReport:
    """Distance-weighted recall of ``found`` against exact ``truth``.

    weighting: "search" = the in-run weight; "pivot" = the offline
    evaluator's 49.38 pivot.
    """
    wfun = (lambda d: weight(d, radius)) if weighting == "search" \
        else (lambda d: weight2(d))
    found = set(found_pairs)
    tp = fn = 0.0
    tp_map: dict[int, int] = {}
    fn_map: dict[int, int] = {}
    n_missed = 0
    for pair, dis in zip(truth_pairs, truth_dist):
        w = wfun(float(dis))
        b = int(float(dis) * 100 / 10)
        if pair in found:
            tp += w
            tp_map[b] = tp_map.get(b, 0) + 1
        else:
            fn += w
            n_missed += 1
            fn_map[b] = fn_map.get(b, 0) + 1
    bins = {}
    for b in sorted(set(tp_map) | set(fn_map)):
        t, f = tp_map.get(b, 0), fn_map.get(b, 0)
        bins[b] = (t / (t + f), t, f)
    recall = tp / (tp + fn) if (tp + fn) > 0 else 1.0
    return RecallReport(tp=tp, fn=fn, recall=recall,
                        n_truth=len(truth_dist), n_found=len(found),
                        n_missed=n_missed, bins=bins)


def recall_from_indices(truth_ci, truth_ki, truth_d, found_ci, found_ki,
                        radius: float) -> RecallReport:
    """Weighted recall from (center_idx, kmer_idx, dist) index arrays."""
    truth_pairs = list(zip(truth_ci.tolist(), truth_ki.tolist()))
    found_pairs = zip(found_ci.tolist(), found_ki.tolist())
    return weighted_recall(truth_pairs, truth_d, found_pairs, radius)


def write_accuracy_file(path: str, report: RecallReport) -> None:
    """Per-bin accuracy lines."""
    with open(path, "w") as f:
        for b, (acc, t, fe) in report.bins.items():
            if t and fe:
                f.write(f"{b} {acc} {t} {fe}\n")
            elif fe:
                f.write(f"{b} 0 fn {fe}\n")
            else:
                f.write(f"{b} 1 tp {t}\n")


def motif_protein_set_ratio(meme_pairs, hclust_triples):
    """MEME-vs-hclust motif coverage comparison (evaluate.cpp:19-63).

    meme_pairs: iterable of (motif, protein) from a MEME-style hit list;
    hclust_triples: iterable of (motif, protein, distance) from the
    search output.  Returns (sum_meme, sum_hclust, ratio) where each sum
    counts distinct proteins per motif over the union of motif names.
    """
    a: dict = {}
    for m, p in meme_pairs:
        a.setdefault(m, set()).add(p)
    b: dict = {}
    for m, p, _ in hclust_triples:
        b.setdefault(m, set()).add(p)
    motifs = set(a) | set(b)
    sum1 = sum(len(a.get(m, ())) for m in motifs)
    sum2 = sum(len(b.get(m, ())) for m in motifs)
    return sum1, sum2, (sum2 / sum1 if sum1 else float("inf"))
