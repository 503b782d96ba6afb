"""The copy-number HMM's forward-backward pass, batched over samples: the
PyTorch port of gatk_tpu/cnv/denoising.py:_hmm_forward_backward (:42-67) with
the transitions that GermlineDenoisingModel._posteriors builds (:140-149).

hmm_forward_backward(log_em, log_pi, stay) -> (S, T, C) log posteriors of
copy-number state c at interval t, from log emissions log_em (S, T, C), log
priors log_pi (S, T, C) and stay probabilities stay (T - 1,) shared by the
samples; the transition out of interval t is
    tr_t(c, c') = log(stay[t] * [c == c'] + (1 - stay[t]) * exp(log_pi[:, t + 1, c'])).
On a CUDA tensor the entry launches the hand-written kernel csrc/cnv_hmm.cu
(ops/_kernels.cnv_hmm) and raises if it cannot; on a CPU tensor it runs
hmm_forward_backward_reference, the plain version and the kernel's oracle.
The entry counts its launches and the states (S x T x C) they computed.
"""
from __future__ import annotations

import threading

import torch


def _logsumexp(x: torch.Tensor) -> torch.Tensor:
    """log-sum-exp over dim 1 of x (S, C, C'), as jax.scipy.special.logsumexp:
    the max (0 where it is not finite), plus the log of the terms' exps summed
    from 0 in order c = 0, 1, ..., C - 1 (the order the kernel sums in)."""
    m = x.amax(dim=1)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    s = torch.zeros_like(m)
    for c in range(x.shape[1]):
        s = s + torch.exp(x[:, c] - m)
    return torch.log(s) + m


def _transitions(stay_t: torch.Tensor, log_pi_next: torch.Tensor) -> torch.Tensor:
    """(S, C, C) log transitions of one step (denoising.py:143-146)."""
    eye = torch.eye(log_pi_next.shape[-1], dtype=log_pi_next.dtype, device=log_pi_next.device)
    return torch.log(stay_t * eye + (1.0 - stay_t) * torch.exp(log_pi_next)[:, None, :])


def hmm_forward_backward_reference(log_em: torch.Tensor, log_pi: torch.Tensor,
                                   stay: torch.Tensor) -> torch.Tensor:
    """The plain version: the sequential recurrence of denoising.py:42-67, one
    step at a time over the intervals, every sample at once."""
    S, T, C = log_em.shape
    alphas = [log_pi[:, 0] + log_em[:, 0]]
    for t in range(1, T):
        tr = _transitions(stay[t - 1], log_pi[:, t])
        alphas.append(_logsumexp(alphas[-1][:, :, None] + tr) + log_em[:, t])
    betas = [torch.zeros_like(alphas[0])]
    for t in range(T - 2, -1, -1):
        tr = _transitions(stay[t], log_pi[:, t + 1])
        v = log_em[:, t + 1] + betas[-1]
        betas.append(_logsumexp((tr + v[:, None, :]).transpose(1, 2)))
    log_post = torch.stack(alphas, dim=1) + torch.stack(betas[::-1], dim=1)
    return log_post - _logsumexp(log_post.reshape(S * T, C, 1)).reshape(S, T, 1)


class _HmmEntry:
    """`hmm_forward_backward(log_em, log_pi, stay)`: CUDA tensors launch the
    Hopper kernel, CPU tensors run the plain version. `launches` and `cells`
    count kernel launches and the states (S x T x C) they computed; the plain
    version is not counted."""

    def __init__(self):
        self._lock = threading.Lock()
        self.launches = 0
        self.cells = 0

    def reset(self):
        with self._lock:
            self.launches = 0
            self.cells = 0

    def __call__(self, log_em: torch.Tensor, log_pi: torch.Tensor,
                 stay: torch.Tensor) -> torch.Tensor:
        if log_em.device.type == "cpu":
            return hmm_forward_backward_reference(log_em, log_pi, stay)
        from . import _kernels

        out = _kernels.cnv_hmm(log_em, log_pi, stay)
        with self._lock:
            self.launches += 1
            self.cells += log_em.numel()
        return out


hmm_forward_backward = _HmmEntry()
