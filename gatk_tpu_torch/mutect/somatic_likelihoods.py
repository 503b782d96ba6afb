# Copied verbatim from gatk_tpu/mutect/somatic_likelihoods.py; only import lines may differ.
"""Somatic likelihoods: Dirichlet-multinomial allele-fraction EM and log evidence.

Reference behavior: mutect/SomaticLikelihoodsEngine.java (EM :25-44, logEvidence
:33-47), utils/Dirichlet.java (effectiveLogMultinomialWeights), docs/mutect/mutect.pdf.
All math in natural log.
"""
from __future__ import annotations

import math

import numpy as np

CONVERGENCE_THRESHOLD = 0.001
NEGLIGIBLE_RESPONSIBILITY = 1.0e-10


def digamma(x):
    """Vectorized digamma via upward recurrence + asymptotic series."""
    x = np.asarray(x, np.float64)
    scalar = x.ndim == 0
    x = np.atleast_1d(x).copy()
    result = np.zeros_like(x)
    # recurrence psi(x) = psi(x+1) - 1/x until x >= 10, then asymptotic series
    while (x < 10).any():
        small = x < 10
        result[small] -= 1.0 / x[small]
        x[small] += 1.0
    inv = 1.0 / x
    inv2 = inv * inv
    result += (np.log(x) - 0.5 * inv
               - inv2 * (1.0 / 12 - inv2 * (1.0 / 120 - inv2 * (1.0 / 252 - inv2 / 240))))
    return result[0] if scalar else result


def log_gamma(x):
    return np.vectorize(math.lgamma)(x)


def effective_log_multinomial_weights(alpha: np.ndarray) -> np.ndarray:
    """E[log p_i] under Dirichlet(alpha): digamma(alpha_i) - digamma(sum)."""
    return digamma(alpha) - digamma(alpha.sum())


def _log_posteriors(log_priors: np.ndarray, log_likelihoods: np.ndarray) -> np.ndarray:
    """posterior responsibilities per column; log_likelihoods: (n_alleles, n_reads)."""
    unnorm = log_priors[:, None] + log_likelihoods
    mx = unnorm.max(axis=0, keepdims=True)
    p = np.exp(unnorm - mx)
    return p / p.sum(axis=0, keepdims=True)


def allele_fractions_posterior(log_likelihoods: np.ndarray, prior_pseudocounts: np.ndarray) -> np.ndarray:
    """EM for the Dirichlet posterior over allele fractions.

    log_likelihoods: (n_alleles, n_reads) natural-log read-vs-allele likelihoods.
    """
    n_alleles = log_likelihoods.shape[0]
    posterior = np.ones(n_alleles)
    while True:
        counts = _log_posteriors(effective_log_multinomial_weights(posterior), log_likelihoods).sum(axis=1)
        new_posterior = counts + prior_pseudocounts
        done = np.abs(posterior - new_posterior).sum() / new_posterior.sum() < CONVERGENCE_THRESHOLD
        posterior = new_posterior
        if done:
            return posterior


def log_dirichlet_normalization(params: np.ndarray) -> float:
    return math.lgamma(params.sum()) - float(log_gamma(params).sum())


def log_evidence(log_likelihoods: np.ndarray, prior_pseudocounts: np.ndarray) -> float:
    """Variational lower bound on log P(reads) under the Dirichlet-multinomial model."""
    if log_likelihoods.shape[1] == 0:
        return 0.0
    posterior = allele_fractions_posterior(log_likelihoods, prior_pseudocounts)
    prior_contrib = log_dirichlet_normalization(prior_pseudocounts)
    posterior_contrib = -log_dirichlet_normalization(posterior)
    log_af = effective_log_multinomial_weights(posterior)
    resp = _log_posteriors(log_af, log_likelihoods)  # (n_alleles, n_reads)
    ll_contrib = np.where(resp < NEGLIGIBLE_RESPONSIBILITY, 0.0, log_likelihoods * resp).sum()
    entropy = np.where(resp < 1e-8, 0.0, resp * np.log(np.maximum(resp, 1e-300))).sum()
    return prior_contrib + posterior_contrib + ll_contrib - entropy


def effective_counts(log_likelihoods: np.ndarray) -> np.ndarray:
    """Sum of per-read normalized linear-space likelihoods (used for AD)."""
    if log_likelihoods.shape[1] == 0:
        return np.zeros(log_likelihoods.shape[0])
    mx = log_likelihoods.max(axis=0, keepdims=True)
    p = np.exp(log_likelihoods - mx)
    p /= p.sum(axis=0, keepdims=True)
    return p.sum(axis=1)


def log_likelihood_ratio(n_ref: int, alt_quals, repeat_factor: int = 1) -> float:
    """Mutect2 isActive log-odds of a non-error allele (Mutect2Engine.logLikelihoodRatio
    :607-676, including this fork's high-depth recall heuristic :621-643)."""
    alt_quals = np.asarray(alt_quals, np.float64)
    n_alt = repeat_factor * len(alt_quals)
    n = n_ref + n_alt

    if n_ref > 300:
        confident = int((alt_quals >= 18).sum())
        moderate = int(((alt_quals > 10) & (alt_quals < 18)).sum())
        if moderate > 20:
            confident += moderate // 2
        stepwise_low_freq = 0.0076 if n_ref > 490 else 0.016 * math.exp(-n_ref / 1000.0)
        if confident > n_ref * stepwise_low_freq:
            return 5.0
    if n_alt == 0:
        return -np.inf

    f_tilde_ratio = math.exp(float(digamma(n_ref + 1) - digamma(n_alt + 1)))
    eps = 10.0 ** (-alt_quals / 10.0)
    z_bar_alt = (1 - eps) / (1 - eps + eps * f_tilde_ratio)
    log_eps = -alt_quals * math.log(10.0) / 10.0
    log_one_minus_eps = np.log1p(-np.minimum(eps, 1 - 1e-300))
    entropy = -np.where(z_bar_alt <= 0, 0.0, z_bar_alt * np.log(np.maximum(z_bar_alt, 1e-300))) - np.where(
        z_bar_alt >= 1, 0.0, (1 - z_bar_alt) * np.log(np.maximum(1 - z_bar_alt, 1e-300))
    )
    read_sum = float((z_bar_alt * (log_one_minus_eps - log_eps) + entropy).sum())

    beta_entropy = -math.log(n + 1) - (
        math.lgamma(n + 1) - math.lgamma(n_alt + 1) - math.lgamma(n - n_alt + 1)
    )
    return beta_entropy + read_sum * repeat_factor
