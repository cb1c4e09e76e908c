"""Karlin-Altschul BLAST statistics for BLOSUM62 (host, float64; own copy
of hsearch_tpu/align/blast_stat.py).

Functional re-derivation of pcluster/src/pcluster/blast_stat.{hpp,cpp}:
raw-score -> bit-score / e-value conversion, sum statistics for multiple
HSPs on one subject, and the iterative effective-length ("edge effect")
adjustment (blast_stat.cpp:228-330, itself from NCBI blast_stat.c).
Fiddly scalar fixed-point code stays on host in f64 per SURVEY §7 — these
run once per query, never in the hot path.
"""

from __future__ import annotations

import dataclasses
import math

# Karlin-Altschul parameters for BLOSUM62 (blast_stat.hpp:16-27)
UNGAPPED = dict(L=0.318, K=0.134, H=0.401, alpha_d_lambda=2.492397,
                beta=-3.2, gap_decay=0.5)
GAPPED = dict(L=0.267, K=0.0410, H=0.140, alpha_d_lambda=7.116105,
              beta=-30.0, gap_decay=0.1)

DEFAULT_G = 50.0           # gap size constant (blast_stat.hpp:31-32)
DEFAULT_GAP_DECAY = 0.1    # sum-statistics decay (blast_stat.hpp:33)


def bits_to_raw_ungapped(bits: float) -> float:
    """blast_stat.cpp:68-72."""
    p = UNGAPPED
    return (bits * math.log(2) + math.log(p["K"])) / p["L"]


def bits_to_raw_gapped(bits: float) -> float:
    """blast_stat.cpp:75-78."""
    p = GAPPED
    return (bits * math.log(2) + math.log(p["K"])) / p["L"]


def _fac(r: int) -> float:
    n = 1
    for i in range(r, 1, -1):
        n *= i
    return float(n)


@dataclasses.dataclass
class BlastStat:
    """Per-database statistics context.

    gapped=True matches the reference's pcluster instantiation
    ``BlastStat(1, total_aa, num_seqs)`` (hash_search.hpp:256).
    """

    db_len: float
    db_num_seqs: int
    gapped: bool = True

    def __post_init__(self):
        p = GAPPED if self.gapped else UNGAPPED
        self.L = p["L"]
        self.K = p["K"]
        self.H = p["H"]
        self.alpha_d_lambda = p["alpha_d_lambda"]
        self.beta = p["beta"]
        self.gap_decay_rate = p["gap_decay"]
        self.logK = math.log(self.K)
        self.expected_hsp_length = 0.0
        self.e_query_len = 0.0
        self.e_db_len = self.db_len
        # adjustments memoized per query length.  The reference
        # precomputes all lengths < 1000 up front (SetDBInfo,
        # blast_stat.cpp:33-46; lengths <= 10 stay 0); corpora hit only
        # a handful of distinct lengths, and the eager 989-entry sweep
        # measured ~8 ms per distinct (db_len, seqs) shape — material
        # when group-partitioned search builds hundreds of shapes.
        self._adjust: dict[int, int] = {}

    # -- effective length -------------------------------------------------
    def set_query(self, query_length: int) -> None:
        """blastComputeLengthAdjustmentComp (blast_stat.cpp:220-227)."""
        adj = self._adjust.get(query_length)
        if adj is None:
            adj = 0 if query_length <= 10 \
                else self._length_adjustment(query_length)[0]
            self._adjust[query_length] = adj
        self._set_effective(adj, query_length)

    def _set_effective(self, adjustment: int, query_length: int) -> None:
        self.expected_hsp_length = float(adjustment)
        self.e_query_len = query_length - self.expected_hsp_length
        self.e_db_len = self.db_len - self.db_num_seqs * self.expected_hsp_length

    def _length_adjustment(self, query_length: int) -> tuple[int, bool]:
        """Iterative fixed point of f(l) = beta + (a/λ)(logK + log((m-l)(n-Nl)))
        (blast_stat.cpp:229-330).  Returns (adjustment, converged)."""
        m = float(query_length)
        n = self.db_len
        N = float(self.db_num_seqs)
        logK = self.logK
        a = N
        mb = m * N + n
        c = n * m - max(m, n) / self.K
        if c < 0:
            return 0, False
        ell_max = 2 * c / (mb + math.sqrt(mb * mb - 4 * a * c))
        ell_min, ell_next = 0.0, 0.0
        converged = False
        for i in range(1, 21):
            ell = ell_next
            ss = (m - ell) * (n - N * ell)
            ell_bar = self.alpha_d_lambda * (logK + math.log(ss)) + self.beta
            if ell_bar >= ell:
                ell_min = ell
                if ell_bar - ell_min <= 1.0:
                    converged = True
                    break
                if ell_min == ell_max:
                    break
            else:
                ell_max = ell
            if ell_min <= ell_bar <= ell_max:
                ell_next = ell_bar
            else:
                ell_next = ell_max if i == 1 else (ell_min + ell_max) / 2
        adjustment = int(ell_min)
        if converged:
            ell = math.ceil(ell_min)
            if ell <= ell_max:
                ss = (m - ell) * (n - N * ell)
                if self.alpha_d_lambda * (logK + math.log(ss)) + self.beta >= ell:
                    adjustment = int(ell)
        self._set_effective(adjustment, query_length)
        return adjustment, converged

    def effective_len(self, length: float) -> float:
        """calEffectiveLen (blast_stat.cpp:53-59)."""
        eff = length - self.expected_hsp_length
        return max(eff, 1.0 / self.K)

    # -- single-HSP statistics -------------------------------------------
    def raw_to_bits(self, raw: float) -> float:
        """blast_stat.cpp:62-66."""
        return (self.L * raw - self.logK) / math.log(2)

    def raw_to_expect(self, raw: float) -> float:
        """E = K m' n' e^{-λS} with gap-decay correction
        (blast_stat.cpp:81-96)."""
        e = self.K * self.e_db_len * self.e_query_len * math.exp(-self.L * raw)
        divisor = (1.0 - self.gap_decay_rate)  # nsegs == 1
        return e / divisor

    def raw_to_expect_vec(self, raw):
        """Vectorized raw_to_expect over an int/float array (used by the
        batched hit assembly — one exp over all candidates of a query)."""
        import numpy as np
        e = self.K * self.e_db_len * self.e_query_len * \
            np.exp(-self.L * np.asarray(raw, np.float64))
        return e / (1.0 - self.gap_decay_rate)

    def raw_to_bits_vec(self, raw):
        import numpy as np
        return (self.L * np.asarray(raw, np.float64) - self.logK) \
            / math.log(2)

    def raw_to_expect_log10(self, raw: float) -> float:
        """blast_stat.cpp:99-112 (returns -10000 when e underflows)."""
        e = self.raw_to_expect(raw)
        if e == 0.0:
            return -10000.0
        return math.log(e) / math.log(10)

    # -- sum statistics for multiple HSPs --------------------------------
    def sum_score(self, scores, subject_len: float) -> float:
        """Normalized sum score of r HSPs (blast_stat.cpp:122-134)."""
        tot = len(scores)
        total = float(sum(scores))
        e_subject = self.effective_len(subject_len)
        lgkmn = math.log(self.K * self.e_query_len * e_subject)
        return (self.L * total - lgkmn
                - (tot - 1) * (self.logK + 2 * math.log(DEFAULT_G))
                - math.log(_fac(tot)))

    def sum_score_to_expect(self, scores, subject_len: float) -> float:
        """E-value of an HSP set (blast_stat.cpp:115-150)."""
        tot = len(scores)
        sum_s = self.sum_score(scores, subject_len)
        sum_p = (math.exp(-sum_s) * sum_s ** (tot - 1)
                 / (_fac(tot) * _fac(tot - 1)))
        corrected = sum_p / (DEFAULT_GAP_DECAY ** (tot - 1)
                             * (1 - DEFAULT_GAP_DECAY))
        return (self.e_db_len / subject_len) * corrected


@dataclasses.dataclass(frozen=True)
class AlignCutoffs:
    """Derived alignment thresholds (InitAlignPara, hash_search.hpp:255-275)."""

    gap_open: int = 11          # GAPINI (paras.hpp:10)
    gap_extend: int = 1         # GAPEXT (paras.hpp:11)
    min_score: int = -20        # MINSCORE (paras.hpp:13)
    ungap_ext_cut: float = 11.0          # UngapExtSCut, blastp default
    min_match_for_expect: int = 4        # MinMatch4Exp
    ungap_ext_drop: float = bits_to_raw_ungapped(7.0)    # ~8.9 raw
    gap_ext_drop: float = bits_to_raw_gapped(15.0)       # ~27 raw
    gap_trigger: float = bits_to_raw_ungapped(25.0)      # GapExtSCut


DEFAULT_CUTOFFS = AlignCutoffs()
