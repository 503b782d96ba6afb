# Copied verbatim from gatk_tpu/utils/mathx.py; only import lines may differ.
"""Log-space math utilities (GATK MathUtils equivalent), vectorized.

Reference behavior: src/main/java/org/broadinstitute/hellbender/utils/MathUtils.java
(JacobianLogTable :421-435, approximateLog10SumLog10 :456-507) and
utils/NaturalLogUtils.java. We replicate the Jacobian-table approximation bit-for-bit
(table step 1e-4, max tolerance 8.0) because GATK's genotyping outputs depend on it;
exact log-sum-exp variants are also provided for device code.
"""
from __future__ import annotations

import numpy as np

LN10 = np.log(10.0)
INV_LN10 = 1.0 / LN10
LOG10_E = np.log10(np.e)

# --- JacobianLogTable replication -------------------------------------------------
JACOBIAN_TABLE_STEP = 1e-4
JACOBIAN_INV_STEP = 1.0 / JACOBIAN_TABLE_STEP
JACOBIAN_MAX_TOLERANCE = 8.0
_k = np.arange(int(JACOBIAN_MAX_TOLERANCE / JACOBIAN_TABLE_STEP) + 1, dtype=np.float64)
JACOBIAN_TABLE = np.log10(1.0 + np.power(10.0, -_k * JACOBIAN_TABLE_STEP))
del _k


def _jacobian_get(diff):
    """Table lookup log10(1 + 10^-diff) with GATK's fastRound quantization."""
    idx = (np.asarray(diff) * JACOBIAN_INV_STEP + 0.5).astype(np.int64)
    return JACOBIAN_TABLE[np.clip(idx, 0, len(JACOBIAN_TABLE) - 1)]


def approximate_log10_sum_log10(a, b=None):
    """GATK approximateLog10SumLog10 — pairwise or along last axis of an array."""
    if b is not None:
        a = np.asarray(a, dtype=np.float64)
        b = np.asarray(b, dtype=np.float64)
        lo, hi = np.minimum(a, b), np.maximum(a, b)
        diff = hi - lo
        corr = np.where(diff < JACOBIAN_MAX_TOLERANCE, _jacobian_get(diff), 0.0)
        out = hi + np.where(np.isneginf(lo), 0.0, corr)
        return out
    # array form: sequential accumulation starting from the max element,
    # matching MathUtils.approximateLog10SumLog10(double[]) iteration order
    vals = np.asarray(a, dtype=np.float64)
    if vals.ndim != 1:
        raise ValueError("array form expects 1-D input")
    if len(vals) == 0:
        return -np.inf
    mi = int(np.argmax(vals))
    acc = vals[mi]
    for i, v in enumerate(vals):
        if i == mi or np.isneginf(v):
            continue
        diff = acc - v
        if diff < JACOBIAN_MAX_TOLERANCE:
            acc += float(_jacobian_get(diff))
    return acc


def log10_sum_log10(vals, axis=None):
    """Exact log10(sum(10^vals)) via max-shift."""
    vals = np.asarray(vals, dtype=np.float64)
    m = np.max(vals, axis=axis, keepdims=True)
    m_safe = np.where(np.isneginf(m), 0.0, m)
    s = np.sum(np.power(10.0, vals - m_safe), axis=axis, keepdims=True)
    out = m_safe + np.log10(s)
    out = np.where(np.isneginf(m), -np.inf, out)
    if axis is None:
        return float(out)
    return np.squeeze(out, axis=axis)


def log_sum_log(vals, axis=None):
    """Exact ln(sum(e^vals)) via max-shift."""
    vals = np.asarray(vals, dtype=np.float64)
    m = np.max(vals, axis=axis, keepdims=True)
    m_safe = np.where(np.isneginf(m), 0.0, m)
    s = np.sum(np.exp(vals - m_safe), axis=axis, keepdims=True)
    out = m_safe + np.log(s)
    out = np.where(np.isneginf(m), -np.inf, out)
    if axis is None:
        return float(out)
    return np.squeeze(out, axis=axis)


def normalize_log10(vals, take_log10_of_output=True):
    """Normalize log10 values so probabilities sum to 1 (GATK normalizeLog10)."""
    s = log10_sum_log10(vals, axis=-1)
    normalized = np.asarray(vals, dtype=np.float64) - np.expand_dims(s, -1)
    return normalized if take_log10_of_output else np.power(10.0, normalized)


def normalize_from_log10_to_linear(vals):
    return normalize_log10(vals, take_log10_of_output=False)


def log10_factorial(n):
    from scipy.special import gammaln

    return gammaln(np.asarray(n, dtype=np.float64) + 1.0) * LOG10_E


def log10_binomial_coefficient(n, k):
    return log10_factorial(n) - log10_factorial(k) - log10_factorial(np.asarray(n) - np.asarray(k))


def log10_gamma(x):
    from scipy.special import gammaln

    return gammaln(np.asarray(x, dtype=np.float64)) * LOG10_E


def log1mexp(a):
    """ln(1 - e^a) for a <= 0, numerically stable (GATK NaturalLogUtils.log1mexp)."""
    a = np.asarray(a, dtype=np.float64)
    small = a < -0.693147  # ln(0.5)
    with np.errstate(invalid="ignore", divide="ignore"):
        out = np.where(small, np.log1p(-np.exp(a)), np.log(-np.expm1(a)))
    return out


def log10_one_minus_pow10(a):
    """log10(1 - 10^a) for a <= 0."""
    return log1mexp(np.asarray(a, dtype=np.float64) * LN10) * INV_LN10
