"""The reference's distance-weighted recall (motif_both_points.cpp:67-87).

A copy of the port's ``search/evaluate.py`` arithmetic (``weight``,
``weight_array``, ``recall_from_indices``), kept here so that later edits
of the program cannot move the yardstick.  A true hit at distance d
weighs 1 below distance 24 and 1/(d - 24) above, clipped into [0, 1]; the
recall is the weight of the true hits found over the weight of all true
hits.
"""

from __future__ import annotations

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


def weight_array(dis: np.ndarray) -> np.ndarray:
    """Vectorized weight()."""
    dis = np.asarray(dis, np.float64)
    w = np.where(dis < 24.0, 1.0, 1.0 / np.maximum(dis - 24.0, 1e-30))
    return np.clip(np.where((w > 1.0) | (w < 0.0), 1.0, w), 0.0, 1.0)


def recall_from_indices(truth_ci, truth_ki, truth_d, found_ci, found_ki,
                        radius: float) -> float:
    """Weighted recall of the found (center, kmer) pairs against the true
    ones with their distances; 1.0 when there is no true hit."""
    found = set(zip(np.asarray(found_ci).tolist(),
                    np.asarray(found_ki).tolist()))
    tp = fn = 0.0
    for pair, dis in zip(zip(np.asarray(truth_ci).tolist(),
                             np.asarray(truth_ki).tolist()),
                         np.asarray(truth_d).tolist()):
        w = weight(float(dis), radius)
        if pair in found:
            tp += w
        else:
            fn += w
    return tp / (tp + fn) if (tp + fn) > 0 else 1.0
