# Copied verbatim from gatk_tpu/calling/dragen_genotypes.py; only import lines may differ.
"""DRAGEN advanced genotyping models: BQD + FRD.

Reference behavior: tools/walkers/genotyper/DRAGENGenotypesModel.java and
GenotypeLikelihoodCalculatorDRAGEN.java —
* BQD (base-quality dropout): for each homozygous genotype and error allele,
  reads on each strand are sorted by sequencer cycle ("feather end"); the model
  scans partitions N where the first N reads are error reads (prior = mean base
  quality * 2.5 minus a homopolymer adjustment) and the rest follow the
  homozygous genotype, taking the best-scoring partition per strand
  (:62-196).
* FRD (foreign-read detection): for each homozygous genotype and foreign
  allele, candidate log10 P(F) thresholds come from the DRAGEN mapping-quality
  table over the reads; for each threshold, a support-derived beta mixes the
  foreign-allele likelihood into each read, best threshold/strand-combination
  wins, with optional max-effective-depth damping (:221-400).
Final per-genotype likelihoods are max(standard, BQD, FRD)
(applyLikelihoodsAdjusmentToBaseline :164-173).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..utils.mathx import approximate_log10_sum_log10
from . import genotyper

FLAT_SNP_HET_PRIOR = 34.77
BQD_HOMOPOLYMER_PHRED_ADJUSTMENT_FACTOR = 5.0
BQD_FIXED_ERROR_RATE = 0.5
PHRED_SCALED_ADJUSTMENT_FOR_BQ_SCORE = 2.5
_LOG10_ERR = np.log10(BQD_FIXED_ERROR_RATE)
_LOG10_NON_ERR = np.log10(1.0 - BQD_FIXED_ERROR_RATE)

# DRAGENMappingQualityReadTransformer.java:21-22
_MQ_X = np.array([0, 30, 60, 100, 200, 256], float)
_MQ_Y = np.array([0, 30, 40, 45, 50, 50], float)


def map_mq_to_phred(mq: int) -> float:
    """mapMappingQualityToPhredLikelihoodScore: piecewise-linear interpolation."""
    return float(np.interp(mq, _MQ_X, _MQ_Y))


def forward_homopolymer_adjustment(padded_ref, offset: int, error_base: int) -> float:
    """FRDBQDUtils.computeForwardHomopolymerAdjustment (run to the left, cap 4)."""
    length = 0
    o = offset - 1
    while o >= 0 and length < 4 and padded_ref[o] == error_base:
        length += 1
        o -= 1
    return BQD_HOMOPOLYMER_PHRED_ADJUSTMENT_FACTOR * length


def reverse_homopolymer_adjustment(padded_ref, offset: int, error_base: int) -> float:
    length = 0
    o = offset + 1
    while o < len(padded_ref) and length < 4 and padded_ref[o] == error_base:
        length += 1
        o += 1
    return BQD_HOMOPOLYMER_PHRED_ADJUSTMENT_FACTOR * length


@dataclass
class DragenReadContainer:
    """DRAGENGenotypesModel.DragenReadContainer: read + SNP base offset +
    likelihood-matrix index (-1 when HMM-filtered)."""

    read: object
    offset: int         # index of the variant base in the read, -1 if none
    index: int          # row in the likelihood matrix, -1 if HMM-filtered
    phred_pf: float = 0.0

    @property
    def is_reverse(self):
        return self.read.is_reverse

    @property
    def has_base_quality(self):
        return self.offset != -1

    @property
    def base_quality(self):
        return int(self.read.quals[self.offset])

    def forwards_feather_end(self):
        soft_start = self.read.pos
        return (soft_start - self.read.unclipped_start()) + self.offset

    def reverse_feather_end(self):
        return (self.read.unclipped_end() - self.read.end) + \
            (len(self.read.bases) - self.offset)

    @property
    def mq_phred(self):
        return map_mq_to_phred(self.read.mapq)


def _read_offset_at(read, loc: int):
    from ..io import sam

    read_i = 0
    ref_i = read.pos
    for op, ln in zip(read.cigar_ops, read.cigar_lens):
        ln = int(ln)
        if op in (sam.OP_M, sam.OP_EQ, sam.OP_X):
            if ref_i <= loc < ref_i + ln:
                return read_i + (loc - ref_i)
            read_i += ln
            ref_i += ln
        elif op in (sam.OP_D, sam.OP_N):
            if ref_i <= loc < ref_i + ln:
                return -1
            ref_i += ln
        elif op in (sam.OP_I, sam.OP_S):
            read_i += ln
    return -1


def build_containers(reads, loc: int):
    """(strand_forward, strand_reverse) sorted by feather end then base quality
    (ReadFeatherEndForward/ReverseComparator :256-295)."""
    fwd, rev = [], []
    for i, r in enumerate(reads):
        c = DragenReadContainer(r, _read_offset_at(r, loc), i)
        (rev if r.is_reverse else fwd).append(c)
    fwd.sort(key=lambda c: (-c.forwards_feather_end(),
                            c.base_quality if c.has_base_quality else 0))
    rev.sort(key=lambda c: (-c.reverse_feather_end(),
                            c.base_quality if c.has_base_quality else 0))
    return fwd, rev


def _hom_index(allele_index: int, ploidy: int, n_alleles: int, gts) -> int:
    return gts.index(tuple([allele_index] * ploidy))


def calculate_bqd_likelihoods(ploidy, lik, alleles, strand_forward, strand_reverse,
                              padded_ref, offset):
    """calculateBQDLikelihoods (:62-102). lik: (n_alleles, n_reads) log10 matrix;
    alleles: allele strings (alleles[0] = ref). Returns per-genotype log10
    scores (-inf where the model does not apply)."""
    n_alleles = len(alleles)
    gts = genotyper.genotype_allele_counts(ploidy, n_alleles)
    out = np.full(len(gts), -np.inf)
    ref_len = len(alleles[0])
    for gt_a in range(n_alleles):
        idx = _hom_index(gt_a, ploidy, n_alleles, gts)
        for err_a in range(n_alleles):
            if (gt_a == err_a or len(alleles[gt_a]) != ref_len
                    or len(alleles[err_a]) != ref_len):
                continue
            err_base = ord(alleles[err_a][0])
            fwd_adj = forward_homopolymer_adjustment(padded_ref, offset, err_base)
            rev_adj = reverse_homopolymer_adjustment(padded_ref, offset, err_base)
            fwd = _bqd_strand(lik, strand_forward, fwd_adj, gt_a, err_a)
            rev = _bqd_strand(lik, strand_reverse, rev_adj, gt_a, err_a)
            out[idx] = max(out[idx], (fwd + rev) * -0.1)
    return out


def _bqd_strand(lik, containers, homopolymer_adjustment, hom_a, err_a):
    """computeBQDModelForStrandData (:115-196): best phred score over
    partitions N (first N reads = error tail)."""
    if not containers:
        return 0.0
    n = len(containers)
    cum_err = np.zeros(n + 1)
    cum_bq = np.zeros(n + 1)
    cum_gt = np.zeros(n + 1)
    total_bq = 0.0
    bq_count = 0
    for i, c in enumerate(containers, start=1):
        if c.index != -1:
            hom = lik[hom_a, c.index]
            err = lik[err_a, c.index]
        else:
            hom = err = 0.0
        phred = 0.0 if (hom == 0 and err == 0) else -10 * float(
            approximate_log10_sum_log10(np.array(err + _LOG10_ERR),
                                        np.array(hom + _LOG10_NON_ERR)))
        cum_err[i] = cum_err[i - 1] + phred
        cum_gt[i] = cum_gt[i - 1] + -10 * hom
        if c.has_base_quality:
            total_bq += c.base_quality
            bq_count += 1
        cum_bq[i] = max(0.0, (total_bq / (bq_count or 1))
                        * PHRED_SCALED_ADJUSTMENT_FOR_BQ_SCORE - homopolymer_adjustment)
    scores = cum_bq + cum_err + (cum_gt[-1] - cum_gt)
    return float(scores.min())


def calculate_frd_likelihoods(ploidy, lik, alleles, containers,
                              snp_apriori=FLAT_SNP_HET_PRIOR,
                              indel_apriori=FLAT_SNP_HET_PRIOR,
                              max_effective_depth=0):
    """calculateFRDLikelihoods (:221-306)."""
    n_alleles = len(alleles)
    gts = genotyper.genotype_allele_counts(ploidy, n_alleles)
    out = np.full(len(gts), -np.inf)
    ref_len = len(alleles[0])
    std_gl = genotyper.compute_genotype_likelihoods(lik, ploidy) \
        if max_effective_depth > 0 else None
    for f_a in range(n_alleles):
        is_indel = len(alleles[f_a]) != ref_len
        prior = 0.0 if f_a == 0 else (indel_apriori if is_indel else snp_apriori) * -0.1
        thresholds = sorted({c.mq_phred * -0.1 + prior for c in containers})
        for c in containers:
            c.phred_pf = c.mq_phred * -0.1 + prior
        for gt_a in range(n_alleles):
            if gt_a == f_a:
                continue
            idx = _hom_index(gt_a, ploidy, n_alleles, gts)
            best = max(
                _frd_strand(lik, gt_a, f_a, containers, lambda c: not c.is_reverse, thresholds),
                _frd_strand(lik, gt_a, f_a, containers, lambda c: c.is_reverse, thresholds),
                _frd_strand(lik, gt_a, f_a, containers, lambda c: True, thresholds),
                key=lambda t: t[0])
            if max_effective_depth > 0 and std_gl is not None:
                score, lpf = best
                mix_idx = gts.index(tuple(sorted((gt_a, f_a)))) if ploidy == 2 else idx
                ploidy_gl = std_gl[mix_idx] - (-np.log10(0.5))
                depth = lik.shape[1]
                adj = ploidy_gl + ((score - lpf - ploidy_gl)
                                   * (min(depth, max_effective_depth) / max(depth, 1)))
                out[idx] = max(out[idx], adj + lpf)
            else:
                out[idx] = max(out[idx], best[0])
    return out


def _frd_strand(lik, hom_a, f_a, containers, pred, thresholds):
    """computeFRDModelForStrandData (:318-400). Returns (score, lpf used)."""
    if not containers:
        return (-np.inf, 0.0)
    max_lpsi = -np.inf
    lpf_applied = 0.0
    for lpf in thresholds:
        ratio = 0.0
        denom = 0.0
        for c in containers:
            if c.index == -1 or not pred(c):
                continue
            lp_f = -np.inf if c.phred_pf + 1e-7 <= lpf else lik[f_a, c.index]
            lp_gt = lik[hom_a, c.index]
            if np.isneginf(lp_f):
                contrib = 0.0
            else:
                contrib = 10.0 ** (lp_f - float(approximate_log10_sum_log10(
                    np.array(lp_f), np.array(lp_gt))))
            ratio += contrib
            denom += 1
        if denom == 0:
            continue
        beta = min(ratio / denom, 0.5)
        if beta <= 0:
            continue
        log_beta = np.log10(beta)
        log_not_beta = np.log10(1.0 - beta)
        cum = 0.0
        for c in containers:
            if c.index == -1:
                continue
            lp_gt = lik[hom_a, c.index]
            if pred(c):
                lp_f = -np.inf if c.phred_pf + 1e-7 <= lpf else lik[f_a, c.index]
                cum += float(approximate_log10_sum_log10(
                    np.array(log_beta + lp_f), np.array(log_not_beta + lp_gt)))
            else:
                cum += lp_gt
        lpsi = lpf + cum
        if lpsi > max_lpsi:
            max_lpsi = lpsi
            lpf_applied = lpf
    return (max_lpsi, lpf_applied)


def apply_dragen_models(gl, lik, alleles, reads, loc, padded_ref, ref_start,
                        ploidy=2, use_bqd=True, use_frd=True,
                        max_effective_depth=0):
    """Merge BQD/FRD scores into the standard genotype likelihoods
    (DRAGENGenotypesModel.calculateLikelihoods :106-162 + the max-merge).
    gl: standard log10 genotype likelihoods; lik: (n_alleles, n_reads) read
    matrix; alleles: allele strings with ref first. Returns the merged array."""
    merged = np.array(gl, float)
    offset = loc - ref_start
    fwd, rev = build_containers(reads, loc)
    if use_bqd:
        bqd = calculate_bqd_likelihoods(ploidy, lik, alleles, fwd, rev,
                                        padded_ref, offset)
        merged = np.maximum(merged, bqd)
    if use_frd:
        frd = calculate_frd_likelihoods(ploidy, lik, alleles, fwd + rev,
                                        max_effective_depth=max_effective_depth)
        merged = np.maximum(merged, frd)
    return merged
