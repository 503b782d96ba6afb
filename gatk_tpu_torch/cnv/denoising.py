"""gCNV coherent denoising + per-interval copy-number HMM on PyTorch: the port
of gatk_tpu/cnv/denoising.py, with its names.

The model, its initialisation and its training are gatk_tpu's: rounds of
closed-form depth and bias M-steps around ADAM steps on the continuous
parameters (written out in the arithmetic order of gatk_tpu's adam_step,
:201-205), whose gradient comes from torch.autograd. Each round holds the
copy-number posteriors q fixed, so nothing differentiates through the HMM.
The posterior pass is one call, batched over samples, of
ops/cnv_hmm.hmm_forward_backward: the hand-written CUDA kernel on a card, its
plain PyTorch version on the CPU.

The model lives on `device` (devices.resolve_device: CUDA unless the
caller asks for the CPU). `fit` records the seconds of its posterior passes,
ADAM steps and scale steps in `stats`, each part between two device
synchronisations and inside a torch.profiler range named gcnv.<part>.
"""
from __future__ import annotations

import contextlib
import math
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..ops import cnv_hmm
from .. import devices

PARAM_NAMES = ("log_d", "b", "W", "z", "log_alpha")


@dataclass
class DenoisingConfig:
    max_copy_number: int = 5
    max_bias_factors: int = 5
    p_alt: float = 1e-6
    cnv_coherence_length: float = 10000.0
    mapping_error_rate: float = 0.01
    learning_rate: float = 0.05
    max_rounds: int = 12
    m_steps_per_round: int = 40
    depth_correction_tau: float = 10000.0


def _nb_logpmf(y, mu, alpha):
    """NegBin log pmf, mean mu, inverse-dispersion alpha (vectorized)."""
    return (torch.lgamma(y + alpha) - torch.lgamma(alpha) - torch.lgamma(y + 1.0)
            + alpha * (torch.log(alpha) - torch.log(alpha + mu))
            + y * (torch.log(mu) - torch.log(alpha + mu)))


class GermlineDenoisingModel:
    """Cohort-mode denoising + calling over a (samples x intervals) count matrix."""

    def __init__(self, counts: np.ndarray, interval_ploidy: np.ndarray,
                 contig_ids: np.ndarray, distances: np.ndarray,
                 interval_lengths: np.ndarray | None = None,
                 config: DenoisingConfig | None = None, seed: int = 1984, device=None):
        """counts: (S, T) int; interval_ploidy: (S, T) int (from contig ploidy);
        contig_ids: (T,) int chain id per interval; distances: (T-1,) bp between
        consecutive interval midpoints (huge where contig changes). The numpy
        draws are gatk_tpu's, so both packages start from the same parameters."""
        self.cfg = config or DenoisingConfig()
        self.device = devices.resolve_device(device)
        self.counts = self._tensor(counts)
        self.ploidy = self._tensor(interval_ploidy)
        S, T = counts.shape
        C = self.cfg.max_copy_number + 1
        self.S, self.T, self.C = S, T, C

        # chain-break mask: where contig changes, transitions reset to prior
        breaks = contig_ids[1:] != contig_ids[:-1]
        self.distances = self._tensor(np.where(breaks, 1e12, distances))

        rng = np.random.default_rng(seed)
        if interval_lengths is None:
            interval_lengths = np.ones(T)
        # explicit log-length offset so b_t only carries residual bias
        self.log_len = self._tensor(np.log(interval_lengths / interval_lengths.mean()))
        med = np.maximum(np.median(counts / (interval_lengths / interval_lengths.mean())[None, :],
                                   axis=1), 1.0)
        self.params = {
            "log_d": self._tensor(np.log(med / 2.0)),  # per-copy depth
            "b": torch.zeros(T, dtype=torch.float32, device=self.device),
            "W": self._tensor(rng.normal(0, 0.01, (T, self.cfg.max_bias_factors))),
            "z": self._tensor(rng.normal(0, 0.01, (S, self.cfg.max_bias_factors))),
            "log_alpha": torch.full((S,), math.log(50.0), dtype=torch.float32,
                                    device=self.device),  # inverse overdispersion
        }
        self.stats = {part: {"seconds": 0.0, "calls": 0}
                      for part in ("posteriors", "adam", "scale")}

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.array(a, np.float32), device=self.device)

    def params_from_numpy(self, params: dict) -> "GermlineDenoisingModel":
        """Takes the five parameter arrays (gatk_tpu's `params`, as numpy)."""
        self.params = {k: self._tensor(params[k]) for k in PARAM_NAMES}
        return self

    # ---------------- model pieces ----------------

    def _emission(self, params):
        """log p(y_st | c) for all states: (S, T, C)."""
        cfg = self.cfg
        bias = params["b"][None, :] + params["z"] @ params["W"].T  # (S, T)
        base_mu = torch.exp(params["log_d"][:, None] + self.log_len[None, :] + bias)
        c = torch.arange(self.C, dtype=torch.float32, device=self.device)
        mu = base_mu[:, :, None] * (c[None, None, :] + cfg.mapping_error_rate)
        alpha = torch.exp(params["log_alpha"])[:, None, None]
        return _nb_logpmf(self.counts[:, :, None], mu, alpha)

    def _prior_and_trans(self):
        cfg = self.cfg
        C = self.C
        c = torch.arange(C, dtype=torch.float32, device=self.device)
        # prior per (S, T, C): pi(c) = 1 - (C-1)*p_alt at baseline, p_alt elsewhere
        base = self.ploidy[:, :, None]  # (S, T, 1)
        pi = torch.where(c[None, None, :] == base, 1.0 - (C - 1) * cfg.p_alt, cfg.p_alt)
        log_pi = torch.log(pi)
        stay = torch.exp(-self.distances / cfg.cnv_coherence_length)  # (T-1,)
        return log_pi, stay

    @torch.no_grad()
    def _posteriors(self, params):
        """(S, T, C) log posteriors: every sample through the copy-number HMM
        in one call (gatk_tpu's vmap over samples, :140-149)."""
        log_em = self._emission(params)
        log_pi, stay = self._prior_and_trans()
        return cnv_hmm.hmm_forward_backward(log_em.contiguous(), log_pi.contiguous(),
                                            stay.contiguous())

    def _loss(self, params, q):
        """Negative expected complete-data log likelihood + parameter priors.

        b_t gets a broad prior (simulated/real per-interval bias spans decades);
        scale identifiability comes from the closed-form depth/bias M-steps."""
        log_em = self._emission(params)
        ell = torch.sum(q * log_em)
        prior = (
            -0.5 * torch.sum(params["b"] ** 2) / 25.0
            - 0.5 * torch.sum(params["W"] ** 2) / 1.0
            - 0.5 * torch.sum(params["z"] ** 2) / 1.0
        )
        return -(ell + prior)

    def _loss_and_grad(self, params, q):
        """(loss, {name: gradient}) by torch.autograd (gatk_tpu: jax.value_and_grad)."""
        leaves = {k: params[k].detach().requires_grad_(True) for k in PARAM_NAMES}
        loss = self._loss(leaves, q)
        grads = torch.autograd.grad(loss, [leaves[k] for k in PARAM_NAMES])
        return loss.detach(), dict(zip(PARAM_NAMES, grads))

    @torch.no_grad()
    def _closed_form_scale_updates(self, params, q):
        """Alternating exact M-steps for depth and per-interval bias given CN
        posteriors (Poisson-limit closed forms; a few sweeps suffice)."""
        cfg = self.cfg
        c = torch.arange(self.C, dtype=torch.float32, device=self.device)
        exp_c = torch.sum(q * (c[None, None, :] + cfg.mapping_error_rate), dim=2)  # (S, T)
        y = self.counts
        fac = torch.exp(self.log_len[None, :] + params["z"] @ params["W"].T)  # (S, T) w/o b, d
        b = params["b"]
        log_d = params["log_d"]
        for _ in range(3):
            denom_d = torch.sum(exp_c * fac * torch.exp(b)[None, :], dim=1)
            log_d = torch.log(torch.clamp(torch.sum(y, dim=1) / torch.clamp(denom_d, min=1e-10),
                                          min=1e-10))
            denom_b = torch.sum(exp_c * fac * torch.exp(log_d)[:, None], dim=0)
            b = torch.log(torch.clamp(torch.sum(y, dim=0) / torch.clamp(denom_b, min=1e-10),
                                      min=1e-10))
        return {**params, "log_d": log_d, "b": b}

    # ---------------- training ----------------

    def _adam_step(self, params, m, v, q, t):
        """One ADAM step (gatk_tpu's adam_step, :197-206): (params, m, v, loss)."""
        cfg = self.cfg
        b1, b2, eps = 0.9, 0.999, 1e-8
        loss, g = self._loss_and_grad(params, q)
        new_p, new_m, new_v = {}, {}, {}
        with torch.no_grad():
            for k in params:
                new_m[k] = b1 * m[k] + (1 - b1) * g[k]
                new_v[k] = b2 * v[k] + (1 - b2) * g[k] ** 2
                mhat = new_m[k] / (1 - b1 ** t)
                vhat = new_v[k] / (1 - b2 ** t)
                new_p[k] = params[k] - cfg.learning_rate * mhat / (torch.sqrt(vhat) + eps)
        return new_p, new_m, new_v, loss

    @contextlib.contextmanager
    def _part(self, name, calls=1):
        """Times one part of `fit` between device synchronisations, inside a
        torch.profiler range gcnv.<name>, into stats[name]."""
        devices.synchronize(self.device)
        t0 = time.perf_counter()
        with torch.profiler.record_function(f"gcnv.{name}"):
            yield
            devices.synchronize(self.device)
        self.stats[name]["seconds"] += time.perf_counter() - t0
        self.stats[name]["calls"] += calls

    def fit(self, verbose=False):
        cfg = self.cfg
        params = self.params

        m = {k: torch.zeros_like(v) for k, v in params.items()}
        v = {k: torch.zeros_like(v) for k, v in params.items()}

        # denoising warm-up: CN pinned at the ploidy baseline while the bias
        # model converges (gcnvkernel's denoising epochs before calling starts)
        base_q = torch.nn.functional.one_hot(self.ploidy.long(), self.C).float()
        t = 1
        warmup = max(2, cfg.max_rounds // 3)
        for rnd in range(cfg.max_rounds):
            if rnd < warmup:
                q = base_q
            else:
                with self._part("posteriors"):
                    q = torch.exp(self._posteriors(params))
            with self._part("scale"):
                params = self._closed_form_scale_updates(params, q)
            with self._part("adam", calls=cfg.m_steps_per_round):
                for _ in range(cfg.m_steps_per_round):
                    params, m, v, loss = self._adam_step(params, m, v, q, t)
                    t += 1
            with self._part("scale"):
                params = self._closed_form_scale_updates(params, q)
            if verbose:
                print(f"round {rnd}: loss {float(loss):.1f}")
        self.params = params
        with self._part("posteriors"):
            self.log_posteriors = self._posteriors(params).cpu().numpy()
        return self

    def copy_number_calls(self):
        """(cn (S,T), cnlp (S,T,C) phred ints, cnq (S,T))."""
        lp = self.log_posteriors
        cn = lp.argmax(axis=2)
        phred = np.round(-10.0 * (lp / math.log(10.0)))
        phred = np.clip(phred - phred.min(axis=2, keepdims=True), 0, 3000).astype(int)
        sorted_p = np.sort(phred, axis=2)
        cnq = sorted_p[:, :, 1]
        return cn, phred, cnq

    def denoised_copy_ratios(self):
        params = {k: p.cpu().numpy() for k, p in self.params.items()}
        bias = params["b"][None, :] + params["z"] @ params["W"].T
        base_mu = np.exp(params["log_d"][:, None] + self.log_len.cpu().numpy()[None, :] + bias)
        counts, ploidy = self.counts.cpu().numpy(), self.ploidy.cpu().numpy()
        return counts / np.maximum(base_mu * ploidy, 1e-10) * ploidy / 2.0
