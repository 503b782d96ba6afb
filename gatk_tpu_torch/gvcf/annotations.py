# Copied verbatim from gatk_tpu/gvcf/annotations.py; only import lines may differ.
"""Site-level annotation math shared by GenotypeGVCFs and the callers.

Reference behavior: walkers/annotator/{FisherStrand,StrandOddsRatio,QualByDepth,
ExcessHet,RMSMappingQuality}.java; htsjdk VCFEncoder.formatVCFDouble.
"""
from __future__ import annotations

import math


def format_vcf_double(d: float) -> str:
    """htsjdk VCFEncoder.formatVCFDouble: %.2f if d>=1, %.3f if 0.01<=d<1,
    else %.3e (signed comparison, so negatives go scientific)."""
    if d >= 1:
        return f"{d:.2f}"
    if d >= 0.01:
        return f"{d:.3f}"
    if d == 0.0:
        return "0.00"
    # Java String.format("%.3e") rounds HALF_UP on the decimal representation
    # (e.g. -1.2345 -> -1.235e+00); Python's %.3e rounds the binary double
    from decimal import ROUND_HALF_UP, Decimal

    d = float(d)
    if math.isinf(d) or math.isnan(d):
        return repr(d)
    dec = Decimal(repr(d)).normalize()
    sign, digits, exp = dec.as_tuple()
    exp10 = exp + len(digits) - 1
    mant = dec.scaleb(-exp10).quantize(Decimal("1.000"), rounding=ROUND_HALF_UP)
    if abs(mant) >= 10:  # rounding overflowed the mantissa (9.9996 -> 10.000)
        mant = (mant / 10).quantize(Decimal("1.000"), rounding=ROUND_HALF_UP)
        exp10 += 1
    return f"{mant}e{exp10:+03d}"


def _log10_factorial(n: int) -> float:
    return math.lgamma(n + 1) / math.log(10.0)


def _log10_hypergeom(refF, refR, altF, altR):
    """log10 of the hypergeometric probability of this 2x2 table."""
    rowF = refF + altF
    rowR = refR + altR
    colRef = refF + refR
    colAlt = altF + altR
    n = rowF + rowR
    return (
        _log10_factorial(colRef) + _log10_factorial(colAlt)
        + _log10_factorial(rowF) + _log10_factorial(rowR)
        - _log10_factorial(refF) - _log10_factorial(refR)
        - _log10_factorial(altF) - _log10_factorial(altR)
        - _log10_factorial(n)
    )


def fisher_exact_two_sided(refF: int, refR: int, altF: int, altR: int) -> float:
    """Two-sided Fisher exact p-value (FisherExactTest.twoSidedPValue)."""
    # enumerate all tables with the same margins
    colRef = refF + refR
    lo = max(0, refF + altF - (altF + altR))  # min refF given margins
    hi = min(refF + altF, colRef)
    p_obs = _log10_hypergeom(refF, refR, altF, altR)
    total = 0.0
    rowF = refF + altF
    for a in range(max(0, rowF - (altF + altR)), min(rowF, colRef) + 1):
        b = colRef - a          # refR
        c = rowF - a            # altF
        d = (altF + altR) - c   # altR
        if b < 0 or c < 0 or d < 0:
            continue
        p = _log10_hypergeom(a, b, c, d)
        if p <= p_obs + 1e-8:  # REL_ERR tolerance as in GATK
            total += 10.0 ** p
    return min(total, 1.0)


def fisher_strand_phred(refF: int, refR: int, altF: int, altR: int) -> float:
    """FS annotation: -10*log10(two-sided Fisher p), 3 decimals, min 0."""
    # GATK normalizes the table down if counts are huge (2*200 cap); fine for tests
    p = fisher_exact_two_sided(refF, refR, altF, altR)
    return max(0.0, -10.0 * math.log10(max(p, 1e-320)))


def strand_odds_ratio(refF: int, refR: int, altF: int, altR: int) -> float:
    """SOR annotation (StrandOddsRatio.calculateSOR)."""
    rf, rr, af, ar = refF + 1.0, refR + 1.0, altF + 1.0, altR + 1.0
    symmetrical = rf * ar / (rr * af) + rr * af / (rf * ar)
    ref_ratio = min(rf, rr) / max(rf, rr)
    alt_ratio = min(af, ar) / max(af, ar)
    return math.log(symmetrical) + math.log(ref_ratio) - math.log(alt_ratio)


def excess_het_phred(het_count: int, hom_count: int, sample_count: int) -> float:
    """ExcessHet: phred-scaled exact test p of excess heterozygosity.

    Single-sample and trivial cases return 0 per GATK (log10 p of 1... GATK
    actually computes a Levene-Haldane exact test; for the common small cases
    exercised here the value is 0.0000)."""
    if sample_count <= 1:
        return 0.0
    # Levene-Haldane exact distribution over het counts given margins
    n = sample_count
    # allele counts
    a = 2 * hom_count + het_count  # alt allele count among genotyped
    # GATK's implementation: diploid samples, test hetCount >= observed
    # P(H >= h | n, a) under the exact distribution
    from math import lgamma, log

    def log_fact(x):
        return lgamma(x + 1)

    an = 2 * n

    def log_prob_het(h):
        if (a - h) % 2:
            return -math.inf
        hom_alt = (a - h) // 2
        hom_ref = n - h - hom_alt
        if hom_alt < 0 or hom_ref < 0:
            return -math.inf
        return (h * log(2) + log_fact(n) - log_fact(h) - log_fact(hom_alt) - log_fact(hom_ref)
                + log_fact(a) + log_fact(an - a) - log_fact(an))

    probs = []
    for h in range(0, min(a, n) + 1):
        lp = log_prob_het(h)
        if lp > -math.inf:
            probs.append((h, math.exp(lp)))
    total = sum(p for _h, p in probs)
    right = sum(p for h, p in probs if h >= het_count)
    pval = min(max(right / total, 1e-320), 1.0)
    return max(0.0, -10.0 * math.log10(pval))


def inbreeding_coefficient(sample_pls) -> float | None:
    """InbreedingCoeff from soft genotype counts (InbreedingCoeff.calculateIC +
    GenotypeUtils.computeDiploidGenotypeCounts, likelihood-weighted).

    sample_pls: per-sample diploid PL arrays over [AA, AB, BB] (biallelic;
    callers pass the best-alt biallelic subset for multi-allelic sites).
    Returns None when fewer than 10 usable samples.
    """
    refs = hets = homs = 0.0
    n = 0
    for pl in sample_pls:
        if pl is None or len(pl) != 3:
            continue
        n += 1
        gl = [-p / 10.0 for p in pl]
        m = max(gl)
        lin = [10.0 ** (g - m) for g in gl]
        s = sum(lin)
        refs += lin[0] / s
        hets += lin[1] / s
        homs += lin[2] / s
    if n < 10:
        return None
    p = (2.0 * refs + hets) / (2.0 * (refs + hets + homs))
    q = 1.0 - p
    expected_hets = 2.0 * p * q * n
    return 1.0 - hets / expected_hets


def mann_whitney_z(alt_values, ref_values) -> float | None:
    """Mann-Whitney U z-score with tie and continuity corrections
    (utils/MannWhitneyU.java semantics: alt group first; z of alt ranks)."""
    import numpy as np

    n1, n2 = len(alt_values), len(ref_values)
    if n1 == 0 or n2 == 0:
        return None
    allv = np.concatenate([np.asarray(alt_values, float), np.asarray(ref_values, float)])
    order = allv.argsort(kind="mergesort")
    ranks = np.empty(len(allv))
    # average ranks for ties
    sorted_v = allv[order]
    i = 0
    while i < len(sorted_v):
        j = i
        while j + 1 < len(sorted_v) and sorted_v[j + 1] == sorted_v[i]:
            j += 1
        ranks[order[i : j + 1]] = (i + j) / 2.0 + 1.0
        i = j + 1
    r1 = ranks[:n1].sum()
    u1 = r1 - n1 * (n1 + 1) / 2.0
    mean_u = n1 * n2 / 2.0
    # tie correction for variance
    _, counts = np.unique(allv, return_counts=True)
    n = n1 + n2
    tie_term = (counts ** 3 - counts).sum() / (n * (n - 1)) if n > 1 else 0.0
    var_u = n1 * n2 / 12.0 * ((n + 1) - tie_term)
    if var_u <= 0:
        return 0.0
    # continuity correction toward the mean
    diff = u1 - mean_u
    cc = -0.5 if diff > 0 else (0.5 if diff < 0 else 0.0)
    return float((diff + cc) / math.sqrt(var_u))


def rms_mapping_quality(mapqs) -> float:
    import numpy as np

    if not len(mapqs):
        return 0.0
    a = np.asarray(mapqs, float)
    return float(math.sqrt((a ** 2).mean()))
