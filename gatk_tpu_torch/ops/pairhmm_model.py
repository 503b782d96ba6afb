# Copied verbatim from gatk_tpu/ops/pairhmm_model.py; only import lines may differ.
"""PairHMM transition/prior model tables (GATK PairHMMModel equivalent).

Reference behavior: utils/pairhmm/PairHMMModel.java (matchToMatch cache :83-96,
qualToTransProbs :108-120) and utils/pairhmm/LoglessPairHMM.java (priors :86-97).

The 3-state (M/I/D) FSA has, per read position with insertion qual i, deletion
qual d, gap-continuation qual g:
    matchToMatch         = 1 - min(1, 10^approxLog10Sum(-i/10, -d/10))
    matchToInsertion     = 10^(-i/10)
    matchToDeletion      = 10^(-d/10)
    indelToMatch         = 1 - 10^(-g/10)
    insertionToInsertion = deletionToDeletion = 10^(-g/10)
matchToMatch uses GATK's Jacobian-table approximate log10 sum; we replicate it so
host-side f64 results are bit-compatible with the Java implementation.

Priors: P(base obs | hap base) = 1-eps if bases match (or either is N) else eps/3
(TRISTATE_CORRECTION), eps = 10^(-baseQual/10).
"""
from __future__ import annotations

import numpy as np

from ..utils import quals as qu
from ..utils.mathx import approximate_log10_sum_log10

TRISTATE_CORRECTION = 3.0
INITIAL_CONDITION_LOG10 = 1020.0 * np.log10(2.0)  # logless scale factor 2^1020

# number of transition entries
MATCH_TO_MATCH = 0
INDEL_TO_MATCH = 1
MATCH_TO_INSERTION = 2
INSERTION_TO_INSERTION = 3
MATCH_TO_DELETION = 4
DELETION_TO_DELETION = 5
TRANS_PROB_ARRAY_LENGTH = 6

# matchToMatchProb[(i, j)] full 255x255 table (GATK stores the triangular half;
# the function is symmetric in (insQual, delQual))
_i = np.arange(qu.MAX_QUAL + 1, dtype=np.float64)
_log10_sum = approximate_log10_sum_log10(
    -0.1 * _i[:, None] * np.ones_like(_i)[None, :], -0.1 * _i[None, :] * np.ones_like(_i)[:, None]
)
with np.errstate(divide="ignore"):
    MATCH_TO_MATCH_PROB = np.power(
        10.0, np.log1p(-np.minimum(1.0, np.power(10.0, _log10_sum))) / np.log(10.0)
    )
del _i, _log10_sum


def _cap_qual(q):
    """Map unsigned byte to cache index, capping at MAX_QUAL like GATK."""
    q = np.asarray(q).astype(np.int64) & 0xFF
    return np.minimum(q, qu.MAX_QUAL)


def match_to_match_prob(ins_qual, del_qual):
    return MATCH_TO_MATCH_PROB[_cap_qual(ins_qual), _cap_qual(del_qual)]


def qual_to_trans_probs(ins_quals, del_quals, gcps):
    """Per-read-position transition probabilities, shape (..., 6) float64."""
    ins_quals = np.asarray(ins_quals)
    out = np.empty(ins_quals.shape + (TRANS_PROB_ARRAY_LENGTH,), dtype=np.float64)
    out[..., MATCH_TO_MATCH] = match_to_match_prob(ins_quals, del_quals)
    out[..., MATCH_TO_INSERTION] = qu.qual_to_error_prob(ins_quals)
    out[..., MATCH_TO_DELETION] = qu.qual_to_error_prob(del_quals)
    out[..., INDEL_TO_MATCH] = qu.qual_to_prob(gcps)
    gcp_err = qu.qual_to_error_prob(gcps)
    out[..., INSERTION_TO_INSERTION] = gcp_err
    out[..., DELETION_TO_DELETION] = gcp_err
    return out


def base_priors(read_bases, read_quals, hap_bases, tristate=True):
    """Prior matrix P(read base i | hap base j), shape (len(read), len(hap))."""
    read_bases = np.frombuffer(bytes(read_bases), dtype=np.uint8) if isinstance(read_bases, (bytes, bytearray)) else np.asarray(read_bases, dtype=np.uint8)
    hap_bases = np.frombuffer(bytes(hap_bases), dtype=np.uint8) if isinstance(hap_bases, (bytes, bytearray)) else np.asarray(hap_bases, dtype=np.uint8)
    p_match = qu.qual_to_prob(np.asarray(read_quals))
    p_mis = qu.qual_to_error_prob(np.asarray(read_quals)) / (TRISTATE_CORRECTION if tristate else 1.0)
    n = ord("N")
    match = (read_bases[:, None] == hap_bases[None, :]) | (read_bases[:, None] == n) | (hap_bases[None, :] == n)
    return np.where(match, p_match[:, None], p_mis[:, None])
