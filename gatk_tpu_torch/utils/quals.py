# Copied verbatim from gatk_tpu/utils/quals.py; only import lines may differ.
"""Phred quality-score conversions (GATK QualityUtils equivalent).

Reference behavior: src/main/java/org/broadinstitute/hellbender/utils/QualityUtils.java
(qual caches :48-56, byte->unsigned mapping :157). All functions are vectorized numpy;
device code uses the precomputed tables in `gatk_tpu.ops.tables`.
"""
from __future__ import annotations

import numpy as np

MAX_QUAL = 254
MAX_SAM_QUAL_SCORE = 93
MAX_REASONABLE_Q_SCORE = 60
MIN_USABLE_Q_SCORE = 6
MAPPING_QUALITY_UNAVAILABLE = 255

# qual -> error probability, indexed by unsigned byte value 0..255.
# GATK caches 0..254 and maps java bytes via (q & 0xff); index 255 wraps to qual 255.
_QUAL_RANGE = np.arange(256, dtype=np.float64)
QUAL_TO_ERROR_PROB = np.power(10.0, -_QUAL_RANGE / 10.0)
QUAL_TO_PROB = 1.0 - QUAL_TO_ERROR_PROB
QUAL_TO_ERROR_PROB_LOG10 = -_QUAL_RANGE / 10.0
with np.errstate(divide="ignore"):
    QUAL_TO_PROB_LOG10 = np.log10(QUAL_TO_PROB)


def qual_to_error_prob(qual):
    """10^(-q/10) for integer qual arrays (uint8 semantics)."""
    q = np.asarray(qual)
    if q.dtype.kind in "iu":
        return QUAL_TO_ERROR_PROB[q.astype(np.int64) & 0xFF]
    return np.power(10.0, -q / 10.0)


def qual_to_prob(qual):
    return 1.0 - qual_to_error_prob(qual)


def qual_to_error_prob_log10(qual):
    q = np.asarray(qual)
    if q.dtype.kind in "iu":
        return QUAL_TO_ERROR_PROB_LOG10[q.astype(np.int64) & 0xFF]
    return -np.asarray(qual, dtype=np.float64) / 10.0


def qual_to_prob_log10(qual):
    q = np.asarray(qual)
    return QUAL_TO_PROB_LOG10[q.astype(np.int64) & 0xFF]


def error_prob_to_qual(prob, max_qual: int = MAX_SAM_QUAL_SCORE):
    """-10*log10(p), rounded, clamped to [1, max_qual] (GATK errorProbToQual)."""
    p = np.asarray(prob, dtype=np.float64)
    with np.errstate(divide="ignore"):
        q = np.round(-10.0 * np.log10(p))
    q = np.where(np.isinf(q), max_qual, q)
    return np.clip(q, 1, max_qual).astype(np.int64)


def phred_scale_error_rate(error_rate):
    """-10*log10(p) unrounded."""
    return -10.0 * np.log10(np.asarray(error_rate, dtype=np.float64))
