# Copied verbatim from gatk_tpu/ops/pairhmm_host.py; only import lines may differ.
"""Host-side float64 reference PairHMM (GATK LoglessPairHMM equivalent).

Reference behavior: utils/pairhmm/LoglessPairHMM.java:48-70 (recurrence), :31-37
(free start deletions: D[0][j] = 2^1020/hapLen), :63-70 (final sum over M+I of the
last row). Used for golden tests and as the numerical oracle for the Pallas kernel
(tolerance 1e-5 in log10, mirroring VectorPairHMMUnitTest.java:100).

Vectorization: the M/I rows depend only on the previous row; the D row is a
first-order linear recurrence in j solved with scipy.signal.lfilter, so each
read×haplotype DP is O(R) numpy row ops instead of O(R*H) Python ops.
"""
from __future__ import annotations

import numpy as np
from scipy.signal import lfilter

from . import pairhmm_model as pm

INITIAL_CONDITION = 2.0**1020
INITIAL_CONDITION_LOG10 = np.log10(INITIAL_CONDITION)


def compute_log10_likelihood(
    hap_bases,
    read_bases,
    read_quals,
    ins_quals,
    del_quals,
    gcps,
    tristate=True,
) -> float:
    """log10 P(read | haplotype) under the logless 3-state PairHMM."""
    read_bases = np.frombuffer(bytes(read_bases), dtype=np.uint8) if isinstance(read_bases, (bytes, bytearray)) else np.asarray(read_bases, dtype=np.uint8)
    hap_bases = np.frombuffer(bytes(hap_bases), dtype=np.uint8) if isinstance(hap_bases, (bytes, bytearray)) else np.asarray(hap_bases, dtype=np.uint8)
    R, H = len(read_bases), len(hap_bases)

    trans = pm.qual_to_trans_probs(np.asarray(ins_quals), np.asarray(del_quals), np.asarray(gcps))
    prior = pm.base_priors(read_bases, read_quals, hap_bases, tristate=tristate)  # (R, H)

    # padded rows j=0..H; row index i runs 0..R with i=0 the boundary row
    m_prev = np.zeros(H + 1)
    x_prev = np.zeros(H + 1)
    y_prev = np.full(H + 1, INITIAL_CONDITION / H)

    for i in range(1, R + 1):
        t = trans[i - 1]
        m_row = np.zeros(H + 1)
        x_row = np.zeros(H + 1)
        m_row[1:] = prior[i - 1] * (
            m_prev[:-1] * t[pm.MATCH_TO_MATCH]
            + (x_prev[:-1] + y_prev[:-1]) * t[pm.INDEL_TO_MATCH]
        )
        x_row[1:] = m_prev[1:] * t[pm.MATCH_TO_INSERTION] + x_prev[1:] * t[pm.INSERTION_TO_INSERTION]
        # y_row[j] = tMD * m_row[j-1] + tDD * y_row[j-1], y_row[0] = 0
        y_row = np.zeros(H + 1)
        y_row[1:] = lfilter([t[pm.MATCH_TO_DELETION]], [1.0, -t[pm.DELETION_TO_DELETION]], m_row[:-1])
        m_prev, x_prev, y_prev = m_row, x_row, y_row

    final_sum = float(np.sum(m_prev[1:]) + np.sum(x_prev[1:]))
    return np.log10(final_sum) - INITIAL_CONDITION_LOG10


def compute_batch(pairs, tristate=True):
    """Compute likelihoods for a list of (hap, read, quals, insq, delq, gcp) tuples."""
    return np.array([compute_log10_likelihood(*p, tristate=tristate) for p in pairs])
