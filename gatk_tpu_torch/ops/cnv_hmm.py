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
hmm_forward_backward_reference, the sequential plain version and the oracle.
The entry counts its passes, the kernels they launched and the states
(S x T x C) they computed.

The kernel does not repeat the sequential recursion: it cuts the intervals
into chunks of CHUNK steps, takes the transition as diagonal plus rank one
(an O(C) step), and runs the chunks in parallel, every vector normalised at
every step. hmm_forward_backward_chunked_reference is the plain PyTorch
version of that association, for the tests and chip_smoke.py; nothing on the
main path calls it. The two association orders round differently: on a
32 x 10,000 x 6 shard the sequential float32 pass, whose log joints reach
|4e4| (0.004 a rounding step), is 0.01-0.03 off its float64 self, and the
chunked one 5e-4, half a rounding step of its largest log posteriors (the
emission, which reaches -4e3 for states far from the data, is added last);
the kernel is held to 1e-3 of the float64 pass.
"""
from __future__ import annotations

import threading

import torch

from ._kernels import CNV_HMM_CHUNK as CHUNK


def _logsumexp(x: torch.Tensor) -> torch.Tensor:
    """log-sum-exp over dim 1 of x (S, C, C'), as jax.scipy.special.logsumexp:
    the max (0 where it is not finite), plus the log of the terms' exps summed
    from 0 in order c = 0, 1, ..., C - 1."""
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
    step at a time over the intervals, every sample at once; in the dtype of
    its inputs (float64 inputs give the float64 oracle)."""
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


# ----------------------------------------------------------------- the chunked pass


def _lse(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """log-sum-exp over `dim`: the max (0 where it is not finite) plus the log
    of the summed exps, so an all -inf vector gives -inf and no NaN."""
    m = x.amax(dim)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    return torch.log(torch.exp(x - m.unsqueeze(dim)).sum(dim)) + m


def _normalised(x: torch.Tensor):
    """x less its log-sum-exp over the states, and that amount (0 where it is
    not finite, so an all -inf vector stays all -inf)."""
    n = _lse(x)
    n = torch.where(torch.isfinite(n), n, torch.zeros_like(n))
    return x - n[..., None], n


def _logaddexp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    m = torch.maximum(a, b)
    out = m + torch.log1p(torch.exp(torch.minimum(a, b) - m))
    return torch.where(m == float("-inf"), m, out)


def _step(x, em, lp, ls, lb, forward: bool):
    """One step of the diagonal-plus-rank-one recursion at position p (em of
    interval p - 1 forward, p backward; lp of interval p; ls, lb = log stay,
    log(1 - stay) of transition p - 1 -> p). The forward recursion carries
    y = alpha - em: with u = y_{p-1} + em_{p-1} normalised (lse 0 over the
    states), y_p(c') = logaddexp(ls + u(c'), lb + lp(c')). Backward, with
    v = em_p + beta_p normalised: beta_{p-1}(c) = logaddexp(ls + v(c),
    lb + lse_c'(lp(c') + v(c'))). Returns the new vector and the log-scale
    taken off the old one."""
    u, n = _normalised(x + em)
    w = lp if forward else _lse(lp + u)[..., None]
    return _logaddexp(ls + u, lb + w), n


def _chunks(T: int, chunk: int):
    """P chunks; chunk k spans intervals [begin_k, end_k], end_k = min(begin_k
    + chunk, T - 1): forward steps p = begin_k + 1 .. end_k, backward the same
    positions from end_k down. Returns (P, begin, end) (int64 tensors)."""
    P = max(1, -(-(T - 1) // chunk))
    begin = torch.arange(P) * chunk
    return P, begin, torch.clamp(begin + chunk, max=T - 1)


def _positions(T, begin, end, j, forward):
    """Step j's position in each chunk, clamped into [1, T - 1], and whether
    the chunk has a step j."""
    p = begin + 1 + j if forward else end - j
    return p.clamp(1, max(T - 1, 1)), j < end - begin


def _transfers(log_em, log_pi, ls, lb, begin, end, forward: bool):
    """Each chunk's C x C transfer in the log semiring: the chunk's steps run
    from every one-hot start (0 at state i, -inf elsewhere). Returns rows
    (S, K, C_i, C) and their log-scales acc (S, K, C_i): the transfer is
    rows[i] + acc[i]; the scales are kept apart and applied relative to their
    largest (one common scale per matrix) where the transfer is used."""
    S, T, C = log_em.shape
    K = len(begin)
    eye = torch.eye(C, dtype=torch.bool, device=log_em.device)
    x = torch.where(eye, 0.0, float("-inf")).to(log_em.dtype).expand(S, K, C, C).clone()
    acc = torch.zeros((S, K, C), dtype=log_em.dtype, device=log_em.device)
    for j in range(int((end - begin).max()) if K else 0):
        p, act = _positions(T, begin, end, j, forward)
        e = p - 1 if forward else p
        y, n = _step(x, log_em[:, e, None], log_pi[:, p, None], ls[p - 1, None, None],
                     lb[p - 1, None, None], forward)
        act = act.to(log_em.device)
        x = torch.where(act[None, :, None, None], y, x)
        acc = torch.where(act[None, :, None], acc + n, acc)
    return x, acc


def _less_max(x: torch.Tensor) -> torch.Tensor:
    """x less its max over the states (0 where that is not finite)."""
    m = x.amax(-1, keepdim=True)
    return x - torch.where(torch.isfinite(m), m, torch.zeros_like(m))


def _starts(first, rows, acc):
    """The scan over chunks: each chunk's start vector from the one before,
    out(j) = lse_i(x(i) + acc(i) - max acc + rows[i](j)), less its max, in the
    scan's order (first (S, C), rows (S, K, C, C), acc (S, K, C)) ->
    (S, K + 1, C)."""
    x = _less_max(first)
    out = [x]
    for q in range(rows.shape[1]):
        a = acc[:, q]
        d = a - a.amax(-1, keepdim=True)
        x = _less_max(_lse((x + d)[:, :, None] + rows[:, q], dim=1))
        out.append(x)
    return torch.stack(out, 1)


def _chunk_values(log_em, log_pi, ls, lb, begin, end, starts, forward: bool):
    """Every chunk's own y = alpha - em (forward) or beta (backward) at every interval,
    from its start vector, one step at a time over all chunks at once."""
    S, T, C = log_em.shape
    P = len(begin)
    vals = torch.empty_like(log_em)
    x = starts
    if forward:
        vals[:, begin] = x
        n = end - begin - 1
        n[-1] += 1  # the last chunk's forward steps reach T - 1
    else:
        vals[:, T - 1] = x[:, P - 1]
        n = end - begin
    for j in range(int(n.max())):
        p, _ = _positions(T, begin, end, j, forward)
        act = j < n
        e = p - 1 if forward else p
        y, _ = _step(x, log_em[:, e], log_pi[:, p], ls[p - 1, None], lb[p - 1, None], forward)
        x = torch.where(act.to(x.device)[None, :, None], y, x)
        t = p[act] if forward else p[act] - 1
        vals[:, t] = x[:, act]
    return vals


def hmm_forward_backward_chunked_reference(log_em: torch.Tensor, log_pi: torch.Tensor,
                                           stay: torch.Tensor, chunk: int = CHUNK) -> torch.Tensor:
    """The plain version of the kernel's association (csrc/cnv_hmm.cu): the
    structured step, chunks of `chunk` steps, each chunk's transfer from
    one-hot starts with one common log-scale, a scan over the chunks for
    their start vectors (each less its max), then each chunk's own values
    from its start, normalised at every step. Equal to the sequential pass in exact
    arithmetic; in the dtype of its inputs."""
    S, T, C = log_em.shape
    P, begin, end = _chunks(T, chunk)
    ls, lb = torch.log(stay), torch.log1p(-stay)
    fwd_rows, fwd_acc = _transfers(log_em, log_pi, ls, lb, begin[:-1], end[:-1], True)
    a = _starts(log_pi[:, 0], fwd_rows, fwd_acc)
    bwd_rows, bwd_acc = _transfers(log_em, log_pi, ls, lb, begin[1:], end[1:], False)
    b = _starts(torch.zeros_like(log_em[:, 0]), bwd_rows.flip(1), bwd_acc.flip(1)).flip(1)
    z = (_chunk_values(log_em, log_pi, ls, lb, begin, end, a, True)
         + _chunk_values(log_em, log_pi, ls, lb, begin, end, b, False))
    # the emission last: one rounding at its size where it is large
    return log_em + (z - _lse(z + log_em)[..., None])


class _HmmEntry:
    """`hmm_forward_backward(log_em, log_pi, stay)`: CUDA tensors launch the
    Hopper kernels, CPU tensors run the plain version. `passes` counts the
    passes on the card, `launches` the kernels they launched (as the C entry
    reports them) and `cells` the states (S x T x C) they computed; the plain
    version is not counted."""

    def __init__(self):
        self._lock = threading.Lock()
        self.passes = 0
        self.launches = 0
        self.cells = 0

    def reset(self):
        with self._lock:
            self.passes = 0
            self.launches = 0
            self.cells = 0

    def __call__(self, log_em: torch.Tensor, log_pi: torch.Tensor,
                 stay: torch.Tensor) -> torch.Tensor:
        if log_em.device.type == "cpu":
            return hmm_forward_backward_reference(log_em, log_pi, stay)
        from . import _kernels

        out, launched = _kernels.cnv_hmm_launch(log_em, log_pi, stay)
        with self._lock:
            self.passes += 1
            self.launches += launched
            self.cells += log_em.numel()
        return out


hmm_forward_backward = _HmmEntry()
