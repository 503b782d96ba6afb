# Copied verbatim from gatk_tpu/vqsr/gmm.py; only import lines may differ.
"""Variational-Bayes Gaussian mixture model for VQSR.

Reference behavior: tools/walkers/vqsr/GaussianMixtureModel.java (k-means init
:86-123, VB E-step :125-140, normalizePMixtureLog10 :153-168),
MultivariateGaussian.java (VB denominator with digamma/Wishart terms :118-133,
MAP M-step with shrinkage toward the empirical prior :163-211, final MLE pass
:213-241), VariantRecalibratorEngine.java (EM loop :104-137, contrastive
evaluation :53-80, worst-annotation culprits :82-97).

Vectorized numpy (data x gaussians); all math f64. The per-iteration cost is a
handful of (N x D) x (D x D) matmuls.
"""
from __future__ import annotations

import math

import numpy as np
from scipy.special import digamma

LOG10 = math.log(10.0)
MIN_PROB_CONVERGENCE = 2e-3
MIN_ACCEPTABLE_LOD_SCORE = -20000.0
_COV_REG = 1e-6


class MultivariateGaussianSet:
    """K multivariate Gaussians over D annotations, stored as stacked arrays."""

    def __init__(self, k: int, d: int, shrinkage: float, dirichlet: float,
                 prior_counts: float, rng: np.random.Generator):
        self.k = k
        self.d = d
        self.shrinkage = shrinkage
        self.dirichlet = dirichlet
        self.prior_counts = prior_counts
        self.rng = rng
        self.mu = rng.standard_normal((k, d))
        self.sigma = np.stack([np.eye(d) for _ in range(k)])
        self.p_mixture_log10 = np.full(k, math.log10(1.0 / k))
        self.sum_prob = np.full(k, 1.0 / k)
        self.hyper_a = np.full(k, prior_counts)
        self.hyper_b = np.full(k, shrinkage)
        self.hyper_lambda = np.full(k, dirichlet)
        # empirical (prior) parameters: zero mean, (200 I)^-1 covariance
        self.empirical_mu = np.zeros(d)
        self.empirical_sigma = np.eye(d) / 200.0
        self._denom_log10 = None

    # ---------------- initialization ----------------
    def kmeans_init(self, x: np.ndarray, iterations: int):
        for _ in range(iterations):
            d2 = ((x[:, None, :] - self.mu[None, :, :]) ** 2).sum(-1)
            assign = d2.argmin(axis=1)
            for kk in range(self.k):
                pts = x[assign == kk]
                if len(pts):
                    self.mu[kk] = pts.mean(axis=0)
                else:
                    self.mu[kk] = self.rng.standard_normal(self.d)
        # random covariance init (initializeRandomSigma equivalent): SPD jitter
        for kk in range(self.k):
            a = self.rng.standard_normal((self.d, self.d)) * 0.2
            self.sigma[kk] = np.eye(self.d) * (0.55 + 1.25 * self.rng.random()) + a @ a.T

    # ---------------- VB E step ----------------
    def _vb_denominators(self):
        """log10 normalization per gaussian with digamma/Wishart corrections."""
        sum_lambda = self.hyper_lambda.sum()
        denom = np.empty(self.k)
        self._sigma_inv_scaled = np.empty_like(self.sigma)
        for kk in range(self.k):
            inv = np.linalg.inv(self.sigma[kk])
            self._sigma_inv_scaled[kk] = inv * self.hyper_a[kk]
            j = np.arange(1, self.d + 1)
            s = digamma((self.hyper_a[kk] + 1.0 - j) / 2.0).sum()
            sign, logdet = np.linalg.slogdet(self.sigma[kk])
            s -= logdet
            s += math.log(2.0) * self.d
            lam = 0.5 * s
            pi = digamma(self.hyper_lambda[kk]) - digamma(sum_lambda)
            beta = -self.d / (2.0 * self.hyper_b[kk])
            denom[kk] = (pi + lam + beta) / LOG10
        return denom

    def _log10_density(self, x: np.ndarray, denom: np.ndarray) -> np.ndarray:
        """(N, K) log10 densities with the given per-gaussian log10 denominators."""
        out = np.empty((x.shape[0], self.k))
        for kk in range(self.k):
            diff = x - self.mu[kk]
            q = np.einsum("ni,ij,nj->n", diff, self._sigma_inv_scaled[kk], diff)
            out[:, kk] = (-0.5 * q) / LOG10 + denom[kk]
        return out

    def expectation(self, x: np.ndarray) -> np.ndarray:
        denom = self._vb_denominators()
        log10p = self._log10_density(x, denom)
        m = log10p.max(axis=1, keepdims=True)
        p = 10.0 ** (log10p - m)
        self.resp = p / p.sum(axis=1, keepdims=True)
        return self.resp

    # ---------------- MAP M step ----------------
    def maximization(self, x: np.ndarray):
        r = self.resp
        for kk in range(self.k):
            w = r[:, kk]
            sum_prob = 1e-10 + w.sum()
            mu = (w[:, None] * x).sum(axis=0) / sum_prob
            shrink = (self.shrinkage * sum_prob) / (self.shrinkage + sum_prob)
            dmu = mu - self.empirical_mu
            wishart = shrink * np.outer(dmu, dmu)
            diff = x - mu
            scatter = (w[:, None, None] * (diff[:, :, None] * diff[:, None, :])).sum(axis=0)
            scatter += len(x) * _COV_REG * np.eye(self.d)
            self.sigma[kk] = scatter + self.empirical_sigma + wishart
            self.mu[kk] = (sum_prob * mu + self.shrinkage * self.empirical_mu) / (
                sum_prob + self.shrinkage)
            self.sum_prob[kk] = sum_prob
            self.hyper_a[kk] = sum_prob + self.prior_counts
            self.hyper_b[kk] = sum_prob + self.shrinkage
            self.hyper_lambda[kk] = sum_prob + self.dirichlet

    def normalize_mixture_log10(self) -> float:
        log10_sum = math.log10(self.sum_prob.sum())
        new = np.log10(self.sum_prob) - log10_sum
        # normalize in log10 space
        m = new.max()
        lin = 10.0 ** (new - m)
        new = new - (m + math.log10(lin.sum()))
        diff = np.abs(new - self.p_mixture_log10).sum()
        self.p_mixture_log10 = new
        return diff

    def finalize(self, x: np.ndarray):
        """MLE re-estimate with the final responsibilities (evaluateFinalModelParameters)."""
        r = self.resp
        for kk in range(self.k):
            w = r[:, kk]
            sum_prob = w.sum()
            if sum_prob <= 0:
                continue
            mu = (w[:, None] * x).sum(axis=0) / sum_prob
            diff = x - mu
            scatter = (w[:, None, None] * (diff[:, :, None] * diff[:, None, :])).sum(axis=0)
            scatter += len(x) * _COV_REG * np.eye(self.d)
            self.sigma[kk] = scatter / sum_prob
            self.mu[kk] = mu
            self.sum_prob[kk] = sum_prob
        self.normalize_mixture_log10()

    # ---------------- evaluation ----------------
    def precompute_evaluation(self):
        self._eval_inv = np.empty_like(self.sigma)
        self._eval_denom = np.empty(self.k)
        for kk in range(self.k):
            self._eval_inv[kk] = np.linalg.inv(self.sigma[kk])
            sign, logdet = np.linalg.slogdet(self.sigma[kk])
            self._eval_denom[kk] = (-0.5 * (self.d * math.log(2 * math.pi) + logdet)) / LOG10

    def evaluate_log10(self, x: np.ndarray) -> np.ndarray:
        """(N,) log10 sum_k pi_k N(x | mu_k, sigma_k)."""
        log10p = np.empty((x.shape[0], self.k))
        for kk in range(self.k):
            diff = x - self.mu[kk]
            q = np.einsum("ni,ij,nj->n", diff, self._eval_inv[kk], diff)
            log10p[:, kk] = self.p_mixture_log10[kk] + (-0.5 * q) / LOG10 + self._eval_denom[kk]
        m = log10p.max(axis=1, keepdims=True)
        return (m + np.log10((10.0 ** (log10p - m)).sum(axis=1, keepdims=True)))[:, 0]

    def evaluate_one_dimension_log10(self, x: np.ndarray, dim: int) -> np.ndarray:
        """(N,) marginal 1-D log10 mixture density on annotation `dim` (for culprits)."""
        log10p = np.empty((x.shape[0], self.k))
        for kk in range(self.k):
            var = self.sigma[kk][dim, dim]
            z = (x[:, dim] - self.mu[kk][dim]) ** 2 / var
            log10p[:, kk] = self.p_mixture_log10[kk] + \
                (-0.5 * (math.log(2 * math.pi * var) + z)) / LOG10
        m = log10p.max(axis=1, keepdims=True)
        return (m + np.log10((10.0 ** (log10p - m)).sum(axis=1, keepdims=True)))[:, 0]


def train_gmm(x: np.ndarray, max_gaussians: int, shrinkage=1.0, dirichlet=0.001,
              prior_counts=20.0, max_iterations=150, kmeans_iterations=100,
              seed=47382911) -> MultivariateGaussianSet:
    """VB-EM training (VariantRecalibratorEngine.variationalBayesExpectationMaximization)."""
    rng = np.random.default_rng(seed)
    k = min(max_gaussians, max(1, len(x) // 10)) if len(x) < 10 * max_gaussians else max_gaussians
    model = MultivariateGaussianSet(k, x.shape[1], shrinkage, dirichlet, prior_counts, rng)
    model.kmeans_init(x, kmeans_iterations)
    model.normalize_mixture_log10()
    model.expectation(x)
    for _ in range(max_iterations):
        model.maximization(x)
        change = model.normalize_mixture_log10()
        model.expectation(x)
        if change < MIN_PROB_CONVERGENCE:
            break
    model.finalize(x)
    model.precompute_evaluation()
    return model
