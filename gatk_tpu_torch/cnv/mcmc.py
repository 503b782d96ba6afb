"""ModelSegments' posterior chains on PyTorch: the port of gatk_tpu/cnv/mcmc.py,
with its names.

Reference: utils/mcmc/GibbsSampler.java + SliceSampler.java driving
copynumber/models/CopyRatioModeller.java (per-segment log2 copy-ratio means
with a global variance and per-point outlier indicators) and
AlleleFractionModeller.java (per-segment minor-allele fractions with a global
allelic-bias and outlier probability). Produces the posterior deciles written
to .modelFinal.seg (MultidimensionalModeller.java).

As in gatk_tpu, every segment's parameter takes its slice-sampling step at
once in each Gibbs sweep (step-out and shrinkage, Neal 2003), and point-level
likelihoods reduce to segments by a scatter-add (index_add_, gatk_tpu's
segment_sum). The sweeps run as a Python loop. The step-out and shrink loops
end on data, as gatk_tpu's lax.while_loops do: after each iteration the host
reads whether any parameter still needs one (a device synchronisation an
iteration, at most 8 step-out and 32 shrink iterations), so a chain launches
only the iterations its data need. Random numbers come from a torch.Generator
on the chain's device seeded with `seed`; they are not jax.random's, so the
chains agree with gatk_tpu's in distribution, not draw for draw. A beta draw
is x / (x + y) of two gamma draws. Each chain runs inside a torch.profiler
range named mcmc.<chain>.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import devices

_WIDTH_STEPS = 8  # max step-out doublings
_SHRINK_STEPS = 32  # max shrinkage steps


def _uniform(gen, n, device, lo=0.0, hi=1.0):
    """jax.random.uniform(key, (n,), minval=lo, maxval=hi) in form: lo + u * (hi - lo)."""
    return torch.rand(n, generator=gen, device=device) * (hi - lo) + lo


def _segment_sum(values, seg_ids, n_segments):
    return torch.zeros(n_segments, dtype=values.dtype, device=values.device).index_add_(
        0, seg_ids, values)


def _beta(gen, a, b):
    """One Beta(a, b) draw from two gamma draws (a, b 0-d tensors)."""
    x = torch._standard_gamma(a.reshape(1), generator=gen)
    y = torch._standard_gamma(b.reshape(1), generator=gen)
    return (x / (x + y))[0]


def _vector_slice_sample(gen, x0, logp, lower, upper, width):
    """One slice-sampling update for a VECTOR of independent parameters.

    logp(x_vec) -> per-parameter log densities (same shape as x_vec).
    Follows SliceSampler.java (step-out then shrink), vectorized with masks.
    """
    n = x0.shape[0]
    dev = x0.device
    logy = logp(x0) + torch.log(_uniform(gen, n, dev, 1e-12, 1.0))
    # initial bracket
    u = _uniform(gen, n, dev)
    left = torch.clamp(x0 - u * width, lower, upper)
    right = torch.clamp(left + width, lower, upper)

    # step out
    for _ in range(_WIDTH_STEPS):
        grow_l = (logp(left) > logy) & (left > lower)
        grow_r = (logp(right) > logy) & (right < upper)
        if not bool((grow_l | grow_r).any()):
            break
        left = torch.where(grow_l, torch.clamp(left - width, lower, upper), left)
        right = torch.where(grow_r, torch.clamp(right + width, lower, upper), right)

    # shrinkage
    x = x0
    accepted = torch.zeros(n, dtype=torch.bool, device=dev)
    for _ in range(_SHRINK_STEPS):
        prop = left + _uniform(gen, n, dev) * (right - left)
        ok = logp(prop) > logy
        newly = ok & ~accepted
        x = torch.where(newly, prop, x)
        accepted = accepted | ok
        # shrink bracket toward x0 where rejected
        left = torch.where(~ok & (prop < x0), torch.maximum(left, prop), left)
        right = torch.where(~ok & (prop >= x0), torch.minimum(right, prop), right)
        if bool(accepted.all()):
            break
    return torch.where(accepted, x, x0)


# ----------------------------------------------------------------------------
# copy-ratio model (models/CopyRatioModeller.java)
# ----------------------------------------------------------------------------

def _copy_ratio_chain(gen, y, seg_ids, n_segments, n_burn, n_samples):
    dev = y.device
    n_points = y.shape[0]
    y_min, y_max = torch.min(y), torch.max(y)
    span = torch.clamp(y_max - y_min, min=1e-3)
    log_outlier = -torch.log(span)
    var_max = torch.clamp(torch.var(y, correction=0), min=1e-4) * 4.0 + 1e-4

    seg_counts = _segment_sum(torch.ones(n_points, device=dev), seg_ids, n_segments)
    init_means = _segment_sum(y, seg_ids, n_segments) / torch.clamp(seg_counts, min=1.0)
    seg_n = torch.clamp(seg_counts, min=1.0)
    lower_means = (y_min - 1.0).expand(n_segments)
    upper_means = (y_max + 1.0).expand(n_segments)

    def sweep(state):
        means, var, outlier_prob, outlier = state

        # 1. outlier indicators: exact Bernoulli (CopyRatioSamplers indicator sampler)
        resid = y - means[seg_ids]
        log_in = torch.log1p(-outlier_prob) - 0.5 * torch.log(2 * math.pi * var) \
            - 0.5 * resid * resid / var
        log_out = torch.log(outlier_prob) + log_outlier
        p_out = torch.sigmoid(log_out - log_in)
        outlier = _uniform(gen, n_points, dev) < p_out

        # 2. outlier probability: Beta conjugate with prior (alpha=5, beta=95)
        n_out = torch.sum(outlier).float()
        outlier_prob = _beta(gen, 5.0 + n_out, 95.0 + n_points - n_out)
        outlier_prob = torch.clamp(outlier_prob, 1e-5, 0.5)

        # 3. variance: vector slice sample of a single global param; the sum of
        # squares does not depend on the variance, so it is taken once
        keep = ~outlier
        n_keep = torch.clamp(torch.sum(keep).float(), min=1.0)
        sum_resid2 = torch.sum(torch.where(keep, resid * resid, torch.zeros_like(resid)))

        def var_logp(v):
            vv = v[0]
            return (-0.5 * n_keep * torch.log(vv) - 0.5 * sum_resid2 / vv).reshape(1)

        var = _vector_slice_sample(gen, var.reshape(1), var_logp,
                                   torch.full((1,), 1e-6, device=dev), var_max.reshape(1),
                                   (var_max * 0.05).reshape(1))[0]

        # 4. segment means: all segments in parallel
        def means_logp(m):
            r = y - m[seg_ids]
            resid2 = torch.where(keep, r * r, torch.zeros_like(r))
            return -0.5 * _segment_sum(resid2, seg_ids, n_segments) / var

        width = torch.sqrt(var / seg_n) * 3.0 + 1e-4
        means = _vector_slice_sample(gen, means, means_logp, lower_means, upper_means, width)
        return means, var, outlier_prob, outlier

    state = (init_means, torch.clamp(torch.var(y, correction=0), min=1e-4),
             torch.tensor(0.05, device=dev), torch.zeros(n_points, dtype=torch.bool, device=dev))
    samples = []
    for _ in range(n_burn + n_samples):
        state = sweep(state)
        samples.append(state[0])
    return torch.stack(samples[n_burn:])


def _generator(seed, device):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def sample_copy_ratio_posteriors(seg_values, n_burn=50, n_samples=100, seed=0, device=None):
    """seg_values: list of per-segment arrays of log2 copy ratios.
    Returns (n_segments, 3) posterior 10/50/90 percentiles. The chain runs on
    `device` (devices.resolve_device: CUDA unless set otherwise)."""
    nonempty = [i for i, v in enumerate(seg_values) if len(v)]
    out = np.full((len(seg_values), 3), np.nan)
    if not nonempty:
        return out
    dev = devices.resolve_device(device)
    y = np.concatenate([np.asarray(seg_values[i], np.float32) for i in nonempty])
    seg_ids = np.concatenate([
        np.full(len(seg_values[i]), j, np.int64) for j, i in enumerate(nonempty)])
    with torch.profiler.record_function("mcmc.copy_ratio_chain"):
        samples = _copy_ratio_chain(_generator(seed, dev), torch.as_tensor(y, device=dev),
                                    torch.as_tensor(seg_ids, device=dev), len(nonempty),
                                    n_burn, n_samples).cpu().numpy()
    q = np.percentile(samples, [10, 50, 90], axis=0).T
    for j, i in enumerate(nonempty):
        out[i] = q[j]
    return out


# ----------------------------------------------------------------------------
# allele-fraction model (models/AlleleFractionModeller.java)
# ----------------------------------------------------------------------------

def _allele_fraction_chain(gen, alt, ref, seg_ids, n_segments, n_burn, n_samples):
    dev = alt.device
    n_points = alt.shape[0]
    total = alt + ref
    minor = torch.minimum(alt, ref).float()

    seg_counts = _segment_sum(torch.ones(n_points, device=dev), seg_ids, n_segments)

    def log_binom(n, k, p):
        p = torch.clamp(p, 1e-6, 1 - 1e-6)
        return k * torch.log(p) + (n - k) * torch.log1p(-p)

    def point_loglik(f, bias):
        """per-het log likelihood marginalized over alt-minor/ref-minor
        (AlleleFractionLikelihoods.hetLogLikelihood with a scalar bias)."""
        fs = f[seg_ids]
        # alt minor: alt fraction = f / (f + (1-f)*bias); ref minor: 1 - that
        p_alt_minor = fs / (fs + (1 - fs) * bias)
        p_ref_minor = (1 - fs) / ((1 - fs) + fs * bias)
        ll_alt = log_binom(total, alt, p_alt_minor)
        ll_ref = log_binom(total, alt, p_ref_minor)
        return torch.logaddexp(ll_alt, ll_ref) - math.log(2.0)

    width = 0.5 / torch.sqrt(torch.clamp(seg_counts, min=1.0)) + 0.01
    f_lower = torch.full((n_segments,), 1e-3, device=dev)
    f_upper = torch.full((n_segments,), 0.5, device=dev)

    def sweep(state):
        f, bias = state

        # global bias: slice sample (mean-bias sampler; gamma(alpha≈?) prior ~ 1)
        def bias_logp(b):
            bb = b[0]
            # weak gamma(10, 10) prior centered at 1
            return (torch.sum(point_loglik(f, bb)) + 9.0 * torch.log(bb) - 10.0 * bb).reshape(1)

        bias = _vector_slice_sample(gen, bias.reshape(1), bias_logp,
                                    torch.full((1,), 0.1, device=dev),
                                    torch.full((1,), 5.0, device=dev),
                                    torch.full((1,), 0.1, device=dev))[0]

        # per-segment minor fractions in parallel
        def f_logp(fv):
            ll = point_loglik(fv, bias)
            return _segment_sum(ll, seg_ids, n_segments)

        f = _vector_slice_sample(gen, f, f_logp, f_lower, f_upper, width)
        return f, bias

    init_f = torch.clamp(
        _segment_sum(minor, seg_ids, n_segments)
        / torch.clamp(_segment_sum(total.float(), seg_ids, n_segments), min=1.0),
        1e-3, 0.5)
    state = (init_f, torch.tensor(1.0, device=dev))
    samples = []
    for _ in range(n_burn + n_samples):
        state = sweep(state)
        samples.append(state[0])
    return torch.stack(samples[n_burn:])


def sample_allele_fraction_posteriors(seg_counts, n_burn=50, n_samples=100, seed=0, device=None):
    """seg_counts: list of per-segment lists of (ref_count, alt_count) het pairs.
    Returns (n_segments, 3) posterior 10/50/90 percentiles of the minor AF. The
    chain runs on `device` (devices.resolve_device: CUDA unless set otherwise)."""
    nonempty = [i for i, v in enumerate(seg_counts) if len(v)]
    out = np.full((len(seg_counts), 3), np.nan)
    if not nonempty:
        return out
    dev = devices.resolve_device(device)
    ref = np.concatenate([np.asarray([rc for rc, ac in seg_counts[i]], np.float32)
                          for i in nonempty])
    alt = np.concatenate([np.asarray([ac for rc, ac in seg_counts[i]], np.float32)
                          for i in nonempty])
    seg_ids = np.concatenate([
        np.full(len(seg_counts[i]), j, np.int64) for j, i in enumerate(nonempty)])
    with torch.profiler.record_function("mcmc.allele_fraction_chain"):
        samples = _allele_fraction_chain(_generator(seed, dev), torch.as_tensor(alt, device=dev),
                                         torch.as_tensor(ref, device=dev),
                                         torch.as_tensor(seg_ids, device=dev), len(nonempty),
                                         n_burn, n_samples).cpu().numpy()
    q = np.percentile(samples, [10, 50, 90], axis=0).T
    for j, i in enumerate(nonempty):
        out[i] = q[j]
    return out
