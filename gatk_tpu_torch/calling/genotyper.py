# Copied verbatim from gatk_tpu/calling/genotyper.py; only import lines may differ.
"""Genotype likelihoods + exact allele-frequency calculation.

Reference behavior: genotyper/GenotypeLikelihoodCalculator.java (canonical-order GLs
via the het approximate-log-sum formula), genotyper/GenotypeAlleleCounts.java
(genotype enumeration), afcalc/AlleleFrequencyCalculator.java:116-240 (Dirichlet EM,
per-allele log10 P(count=0), QUAL = log10PNoVariant), utils/Dirichlet.java:66-69.

Pseudocounts: ref=het/std^2=10, snp=het*ref=0.01, indel=indelHet*ref=0.00125 with
standard genotype args (snpHeterozygosity=1e-3, indelHeterozygosity=1.25e-4,
heterozygosityStandardDeviation=1e-2).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass

import numpy as np
from scipy.special import gammaln

from ..utils.mathx import approximate_log10_sum_log10, log10_sum_log10

THRESHOLD_FOR_ALLELE_COUNT_CONVERGENCE = 0.1
DEFAULT_REF_PSEUDOCOUNT = 10.0
DEFAULT_SNP_PSEUDOCOUNT = 0.01
DEFAULT_INDEL_PSEUDOCOUNT = 0.00125
LOG10_E = np.log10(np.e)


def genotype_allele_counts(ploidy: int, n_alleles: int):
    """Enumerate genotypes in GATK/VCF canonical order as sorted allele tuples.

    Diploid order: (0,0),(0,1),(1,1),(0,2),(1,2),(2,2),...
    """
    if ploidy == 1:
        return [(a,) for a in range(n_alleles)]
    if ploidy == 2:
        return [(i, j) for j in range(n_alleles) for i in range(j + 1)]
    # general ploidy: combinations with repetition in colex order
    out = [()]
    for _ in range(ploidy):
        out = [g + (a,) for a in range(n_alleles) for g in out if not g or g[-1] <= a]
    # order by reversed-tuple colex to match canonical GATK ordering
    return sorted(set(tuple(sorted(g)) for g in out), key=lambda g: tuple(reversed(g)))


def log10_combination_count(gt: tuple) -> float:
    """log10(ploidy! / prod(count_a!)) for a genotype tuple."""
    ploidy = len(gt)
    counts = {}
    for a in gt:
        counts[a] = counts.get(a, 0) + 1
    num = gammaln(ploidy + 1)
    den = sum(gammaln(c + 1) for c in counts.values())
    return (num - den) * LOG10_E


def compute_genotype_likelihoods(values: np.ndarray, ploidy: int = 2) -> np.ndarray:
    """Canonical-order log10 genotype likelihoods from (n_alleles, n_reads) matrix
    (GenotypeLikelihoodCalculator.computeLog10GenotypeLikelihoods)."""
    n_alleles, n_reads = values.shape
    gts = genotype_allele_counts(ploidy, n_alleles)
    out = np.empty(len(gts))
    log10_ploidy = np.log10(ploidy)
    for gi, gt in enumerate(gts):
        distinct = sorted(set(gt))
        if len(distinct) == 1:
            out[gi] = values[distinct[0]].sum()
        elif len(distinct) == 2:
            a, b = distinct
            ca = gt.count(a)
            cb = ploidy - ca
            s = approximate_log10_sum_log10(
                values[a] + np.log10(ca), values[b] + np.log10(cb)
            ).sum()
            out[gi] = s - n_reads * log10_ploidy
        else:
            mx = values.max(axis=0)
            lin = np.power(10.0, values - mx[None, :])
            buf = np.zeros(n_reads)
            for a in distinct:
                buf += gt.count(a) * lin[a]
            out[gi] = np.log10(buf).sum() - n_reads * log10_ploidy + mx.sum()
    return out


def gls_to_pls(gl: np.ndarray) -> np.ndarray:
    """Integer phred-scaled likelihoods (GenotypeLikelihoods.getAsPLs)."""
    adjusted = -10.0 * (gl - gl.max())
    return np.floor(adjusted + 0.5).astype(np.int64)


def pls_to_gls(pl: np.ndarray) -> np.ndarray:
    return np.asarray(pl, np.float64) / -10.0


@dataclass
class AFCalculationResult:
    allele_counts_mle: np.ndarray  # per alt allele
    log10_p_no_variant: float
    log10_p_ref_by_allele: np.ndarray  # per alt allele

    @property
    def log10_prob_variant_present(self):
        # log10(1 - 10^log10PNoVariant)
        from ..utils.mathx import log10_one_minus_pow10

        return log10_one_minus_pow10(min(self.log10_p_no_variant, -1e-10))


class AlleleFrequencyCalculator:
    def __init__(
        self,
        ref_pseudocount=DEFAULT_REF_PSEUDOCOUNT,
        snp_pseudocount=DEFAULT_SNP_PSEUDOCOUNT,
        indel_pseudocount=DEFAULT_INDEL_PSEUDOCOUNT,
        ploidy=2,
    ):
        self.ref_pseudocount = ref_pseudocount
        self.snp_pseudocount = snp_pseudocount
        self.indel_pseudocount = indel_pseudocount
        self.ploidy = ploidy

    def calculate(self, allele_lengths, ref_length, sample_gls, ploidy=None,
                  span_del_index=None):
        """allele_lengths: list of allele string lengths (ref first);
        sample_gls: list of per-sample canonical-order log10 GL arrays (PL-derived).
        span_del_index: allele index of '*' if present — P(no variant) then
        sums genotypes over {ref, '*'} capped at 0 per sample
        (AlleleFrequencyCalculator.java:213-222).
        Returns AFCalculationResult.
        """
        ploidy = ploidy or self.ploidy
        n_alleles = len(allele_lengths)
        gts = genotype_allele_counts(ploidy, n_alleles)
        comb = np.array([log10_combination_count(g) for g in gts])
        # genotype -> allele count matrix (n_genotypes, n_alleles)
        count_mat = np.zeros((len(gts), n_alleles))
        for gi, g in enumerate(gts):
            for a in g:
                count_mat[gi, a] += 1

        prior_pseudo = np.array(
            [
                self.ref_pseudocount
                if i == 0
                else (self.snp_pseudocount if L == ref_length else self.indel_pseudocount)
                for i, L in enumerate(allele_lengths)
            ]
        )

        gl_mat = np.array(sample_gls)  # (n_samples, n_genotypes)
        allele_counts = np.zeros(n_alleles)
        log10_freqs = np.full(n_alleles, -np.log10(n_alleles))

        while True:
            # per-sample normalized genotype posteriors
            unnorm = gl_mat + comb[None, :] + count_mat.dot(log10_freqs)[None, :]
            norm = unnorm - log10_sum_log10(unnorm, axis=-1)[:, None]
            # effective allele counts via log-space accumulation
            with np.errstate(divide="ignore"):
                log_counts = norm[:, :, None] + np.log10(
                    np.maximum(count_mat[None, :, :], 1e-300)
                )
                log_counts = np.where(count_mat[None, :, :] > 0, log_counts, -np.inf)
            new_counts = np.power(10.0, log10_sum_log10(
                log_counts.reshape(-1, n_alleles), axis=0
            ))
            diff = np.abs(allele_counts - new_counts).max()
            allele_counts = new_counts
            posterior_pseudo = prior_pseudo + allele_counts
            log10_freqs = np.log10(posterior_pseudo / posterior_pseudo.sum())
            if diff <= THRESHOLD_FOR_ALLELE_COUNT_CONVERGENCE:
                break

        # final posteriors with converged frequencies
        unnorm = gl_mat + comb[None, :] + count_mat.dot(log10_freqs)[None, :]
        norm = unnorm - log10_sum_log10(unnorm, axis=-1)[:, None]

        if span_del_index is not None:
            # genotypes made only of {ref, '*'} count as non-variant, with the
            # per-sample sum capped at 0 (finite-precision guard; the cap is
            # what makes a *-only site's QUAL an IEEE -0.0)
            nonvar = np.array([gi for gi, g in enumerate(gts)
                               if all(a in (0, span_del_index) for a in g)])
            per_sample = log10_sum_log10(norm[:, nonvar], axis=-1)
            log10_p_no_variant = float(np.minimum(0.0, per_sample).sum())
        else:
            log10_p_no_variant = float(norm[:, 0].sum())

        n_alts = n_alleles - 1
        log10_p_ref_by_allele = np.zeros(n_alts)
        if n_alleles == 2:
            log10_p_ref_by_allele[0] = log10_p_no_variant
        else:
            for a in range(1, n_alleles):
                absent = count_mat[:, a] == 0
                per_sample = log10_sum_log10(norm[:, absent], axis=-1)
                per_sample = np.minimum(0.0, per_sample)
                log10_p_ref_by_allele[a - 1] = per_sample.sum()

        mle = np.rint(allele_counts).astype(int)[1:]
        return AFCalculationResult(mle, log10_p_no_variant, log10_p_ref_by_allele)
