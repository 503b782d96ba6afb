# Copied verbatim from gatk_tpu/calling/likelihoods.py; only import lines may differ.
"""Allele likelihood matrices (utils/genotyper/AlleleLikelihoods.java equivalent).

Single-sample matrix of log10 P(read | allele), vectorized numpy. Implements
normalization vs the best allele (:416-441), haplotype->allele marginalization
(:718), poorly-modeled read filtering, and best-allele assignment with tie-breaking
(:1020), matching the reference's semantics.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

INFORMATIVE_THRESHOLD = 0.2  # LOG_10_INFORMATIVE_THRESHOLD (BestAllele)


@dataclass
class AlleleLikelihoods:
    """values[a, r] = log10 P(read r | allele a); alleles is any list of objects."""

    alleles: list
    reads: list  # read objects (must be stable identities)
    values: np.ndarray  # (n_alleles, n_reads) float64
    filtered_reads: list = field(default_factory=list)

    @property
    def n_alleles(self):
        return len(self.alleles)

    @property
    def n_reads(self):
        return len(self.reads)

    def ref_index(self):
        for i, a in enumerate(self.alleles):
            if getattr(a, "is_ref", False):
                return i
        return -1

    def normalize_likelihoods(self, cap: float, symmetric_to_ref: bool = True):
        """Cap likelihoods at best-allele + cap (cap<0); best includes ref when
        symmetric_to_ref (AlleleLikelihoods.normalizeLikelihoods)."""
        if self.n_alleles <= 1 or cap == -np.inf:
            return
        best = self.values.max(axis=0)
        floor = best + cap
        np.maximum(self.values, floor[None, :], out=self.values)

    def filter_poorly_modeled_reads(self, threshold_fn):
        """Remove reads whose best likelihood < threshold_fn(read)
        (filterPoorlyModeledEvidence)."""
        if self.n_reads == 0:
            return
        best = self.values.max(axis=0)
        thresholds = np.array([threshold_fn(r) for r in self.reads])
        keep = best >= thresholds
        if keep.all():
            return
        self.filtered_reads.extend([r for r, k in zip(self.reads, keep) if not k])
        self.reads = [r for r, k in zip(self.reads, keep) if k]
        self.values = self.values[:, keep]

    def marginalize(self, allele_to_haplotypes: dict):
        """New AlleleLikelihoods over alleles, taking the max over each allele's
        haplotype group (AlleleLikelihoods.marginalize :718)."""
        new_alleles = list(allele_to_haplotypes.keys())
        hap_index = {id(h): i for i, h in enumerate(self.alleles)}
        out = np.full((len(new_alleles), self.n_reads), -np.inf)
        for ai, allele in enumerate(new_alleles):
            idx = [hap_index[id(h)] for h in allele_to_haplotypes[allele] if id(h) in hap_index]
            if idx:
                out[ai] = self.values[idx].max(axis=0)
        return AlleleLikelihoods(new_alleles, list(self.reads), out)

    def retain_reads_overlapping(self, start: int, end: int):
        """Keep reads overlapping [start, end) (evidence qualifying for genotyping)."""
        keep = np.array([(r.pos < end and r.end > start) for r in self.reads], bool)
        self.reads = [r for r, k in zip(self.reads, keep) if k]
        self.values = self.values[:, keep]

    def best_alleles(self):
        """Per-read best allele index, second-best likelihood, and confidence
        (BestAllele semantics: best vs second-best)."""
        if self.n_reads == 0:
            return np.empty(0, int), np.empty(0), np.empty(0)
        order = np.argsort(-self.values, axis=0, kind="stable")
        best_idx = order[0]
        best = np.take_along_axis(self.values, best_idx[None, :], axis=0)[0]
        if self.n_alleles > 1:
            second = np.take_along_axis(self.values, order[1][None, :], axis=0)[0]
        else:
            second = np.full(self.n_reads, -np.inf)
        return best_idx, best, best - second

    def counts_by_allele(self):
        """Informative-read counts per allele (used for AD/DP annotations)."""
        best_idx, best, conf = self.best_alleles()
        counts = np.zeros(self.n_alleles, int)
        for i, c in zip(best_idx, conf):
            if c > INFORMATIVE_THRESHOLD:
                counts[i] += 1
        return counts
