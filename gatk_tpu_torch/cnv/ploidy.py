# Copied verbatim from gatk_tpu/cnv/ploidy.py; only import lines may differ.
"""Germline contig ploidy determination.

Reference behavior: gcnvkernel models/model_ploidy.py (337 LoC): per-contig
counts modeled as NegBin(d_s * t_c * ploidy/2 * bias, psi); here the read depth
and per-sample overdispersion get MAP estimates and the ploidy posterior is an
exact discrete sum — no sampling needed at this model size.
"""
from __future__ import annotations

import math

import numpy as np


def _nb_logpmf(n, mu, alpha):
    """Negative binomial log pmf with mean mu and inverse-dispersion alpha."""
    from math import lgamma

    n = float(n)
    return (lgamma(n + alpha) - lgamma(alpha) - lgamma(n + 1)
            + alpha * math.log(alpha / (alpha + mu))
            + n * math.log(mu / (alpha + mu)))


def determine_contig_ploidy(contigs, contig_total_counts, contig_total_lengths,
                            priors_by_contig, autosomal_mean_ploidy=2.0):
    """Per-sample ploidy calls for one sample.

    contig_total_counts: {contig: total count}; contig_total_lengths: {contig:
    total bin length}. Returns (ploidies, gqs, read_depth) with read depth =
    per-base haploid coverage estimated from high-confidence diploid contigs.
    """
    # initial depth from all contigs assuming the max-prior ploidy
    num = 0.0
    den = 0.0
    cur = {}
    for c in contigs:
        prior = priors_by_contig[c]
        cur[c] = int(np.argmax(prior))
        if cur[c] > 0:
            num += contig_total_counts[c]
            den += contig_total_lengths[c] * cur[c]
    depth = num / max(den, 1.0)  # per-base per-copy coverage

    # coordinate ascent: re-estimate depth given called ploidies, recall ploidies
    ploidies = []
    gqs = []
    for _it in range(4):
        ploidies = []
        gqs = []
        for c in contigs:
            prior = priors_by_contig[c]
            log_post = np.full(len(prior), -np.inf)
            t = contig_total_lengths[c]
            n = contig_total_counts[c]
            alpha = 100.0  # mild overdispersion on aggregate counts
            for j in range(len(prior)):
                if prior[j] <= 0:
                    continue
                mu = max(depth * t * j, depth * t * 0.01 + 1e-6)  # ploidy-0 leak floor
                log_post[j] = math.log(prior[j]) + _nb_logpmf(n, mu, alpha)
            log_post -= log_post.max()
            post = np.exp(log_post)
            post /= post.sum()
            best = int(np.argmax(post))
            ploidies.append(best)
            p_err = max(1.0 - post[best], 1e-300)
            gqs.append(min(-10.0 * math.log10(p_err), 3000.0))
        new_cur = dict(zip(contigs, ploidies))
        num = sum(contig_total_counts[c] for c in contigs if new_cur[c] > 0)
        den = sum(contig_total_lengths[c] * new_cur[c] for c in contigs if new_cur[c] > 0)
        new_depth = num / max(den, 1.0)
        converged = new_cur == cur
        cur = new_cur
        depth = new_depth
        if converged:
            break
    return ploidies, gqs, depth


def determine_cohort_ploidy(sample_names, totals_per_sample, lengths, priors_by_contig,
                            n_iterations: int = 3):
    """Cohort-calibrated ploidy calls (model_ploidy.py fits per-contig
    multiplicative bias shared across samples).

    totals_per_sample: {sample: {contig: count}}; lengths: {contig: total length}.
    Returns {sample: (contigs, ploidies, gqs, depth)}.
    """
    contigs = [c for c in priors_by_contig]
    bias = {c: 1.0 for c in contigs}
    results = {}
    for _it in range(n_iterations):
        results = {}
        for s in sample_names:
            totals = totals_per_sample[s]
            ploidies, gqs, depth = _call_one(contigs, totals, lengths, priors_by_contig, bias)
            results[s] = (contigs, ploidies, gqs, depth)
        # per-contig bias: median over samples of observed/expected
        new_bias = {}
        for ci, c in enumerate(contigs):
            ratios = []
            for s in sample_names:
                _cs, ploidies, _g, depth = results[s]
                p = ploidies[ci]
                if p > 0 and depth > 0:
                    ratios.append(totals_per_sample[s][c] / (depth * lengths[c] * p))
            new_bias[c] = float(np.median(ratios)) if ratios else 1.0
        if all(abs(new_bias[c] - bias[c]) < 1e-4 for c in contigs):
            bias = new_bias
            break
        bias = new_bias
    return results


def _call_one(contigs, totals, lengths, priors_by_contig, bias):
    num = 0.0
    den = 0.0
    for c in contigs:
        p_map = int(np.argmax(priors_by_contig[c]))
        if p_map > 0:
            num += totals[c] / bias[c]
            den += lengths[c] * p_map
    depth = num / max(den, 1.0)
    ploidies, gqs = [], []
    for c in contigs:
        prior = priors_by_contig[c]
        log_post = np.full(len(prior), -np.inf)
        t = lengths[c]
        n = totals[c]
        alpha = 100.0
        for j in range(len(prior)):
            if prior[j] <= 0:
                continue
            mu = max(depth * t * j * bias[c], depth * t * 0.01 + 1e-6)
            log_post[j] = math.log(prior[j]) + _nb_logpmf(n, mu, alpha)
        log_post -= log_post.max()
        post = np.exp(log_post)
        post /= post.sum()
        best = int(np.argmax(post))
        ploidies.append(best)
        gqs.append(min(-10.0 * math.log10(max(1.0 - post[best], 1e-300)), 3000.0))
    return ploidies, gqs, depth
