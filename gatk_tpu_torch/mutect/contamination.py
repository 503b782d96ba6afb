# Copied verbatim from gatk_tpu/mutect/contamination.py; only import lines may differ.
"""Cross-sample contamination estimation.

Reference behavior: tools/walkers/contamination/{GetPileupSummaries,
CalculateContamination,ContaminationModel}.java: pileups at common biallelic
SNPs -> coverage filtering -> hom-alt based estimate (ref reads at hom-alt
sites are contaminant reads, scaled by the population ref-allele frequency).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

MIN_COVERAGE = 10
DEFAULT_LOW_COVERAGE_RATIO_THRESHOLD = 0.5
DEFAULT_HIGH_COVERAGE_RATIO_THRESHOLD = 3.0
BASE_ERROR_RATE = 1e-3  # errorRate in ContaminationModel hom-alt accounting


@dataclass
class PileupSite:
    contig: str
    position: int  # 1-based
    ref_count: int
    alt_count: int
    other_alt_count: int
    allele_frequency: float

    @property
    def total(self):
        return self.ref_count + self.alt_count + self.other_alt_count

    @property
    def alt_fraction(self):
        t = self.total
        return self.alt_count / t if t else 0.0


def read_pileup_table(path: str):
    sample = None
    sites = []
    with open(path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if line.startswith("#<METADATA>"):
                for kv in line[len("#<METADATA>"):].split():
                    if kv.startswith("SAMPLE="):
                        sample = kv[7:]
                continue
            if line.startswith("contig") or not line:
                continue
            f = line.split("\t")
            sites.append(PileupSite(f[0], int(f[1]), int(f[2]), int(f[3]), int(f[4]), float(f[5])))
    return sample, sites


def write_pileup_table(path: str, sample: str, sites):
    with open(path, "w") as fh:
        fh.write(f"#<METADATA>SAMPLE={sample}\n")
        fh.write("contig\tposition\tref_count\talt_count\tother_alt_count\tallele_frequency\n")
        for s in sites:
            fh.write(f"{s.contig}\t{s.position}\t{s.ref_count}\t{s.alt_count}\t"
                     f"{s.other_alt_count}\t{s.allele_frequency:.3f}\n")


def filter_sites_by_coverage(sites, low=DEFAULT_LOW_COVERAGE_RATIO_THRESHOLD,
                             high=DEFAULT_HIGH_COVERAGE_RATIO_THRESHOLD):
    covered = [s for s in sites if s.total > MIN_COVERAGE]
    if not covered:
        return []
    cov = np.array([s.total for s in covered], float)
    lo = np.median(cov) * low
    hi = cov.mean() * high
    return [s for s in covered if lo < s.total < hi]


def calculate_contamination(sites):
    """(contamination, standard_error) from hom-alt sites
    (ContaminationModel.calculateContaminationFromHoms)."""
    sites = filter_sites_by_coverage(sites)
    if not sites:
        return 0.0, 1.0

    def estimate(cut):
        homs = [s for s in sites if s.alt_fraction > cut]
        if not homs:
            return 0.0, 1.0
        ref_sum = sum(s.ref_count for s in homs)
        depth_sum = sum(s.total for s in homs)
        # expected contaminant ref reads: depth * (1 - f) per site; sequencing
        # error contributes BASE_ERROR_RATE/3 of depth
        weight = sum(s.total * (1.0 - s.allele_frequency) for s in homs)
        error_refs = BASE_ERROR_RATE * depth_sum / 3.0
        c = max(0.0, (ref_sum - error_refs) / max(weight, 1e-10))
        se = float(np.sqrt(max(c * (1 - c), 1e-12) / max(weight, 1.0)))
        return float(min(c, 1.0)), se

    # the hom-alt fraction cut must track the contamination level itself
    # (at 8% contamination hom-alt sites sit near alt fraction 0.92); iterate
    # like the reference's model-based genotyping does implicitly
    c, se = estimate(0.9)
    for _ in range(3):
        cut = min(0.9, 1.0 - 2.0 * c - 0.04)
        c, se = estimate(cut)
    return c, se
