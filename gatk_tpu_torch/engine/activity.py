# Copied verbatim from gatk_tpu/engine/activity.py; only import lines may differ.
"""Active-region detection (HaplotypeCallerEngine.isActive + BandPassActivityProfile
+ ActivityProfile.popReadyAssemblyRegions equivalents), as batch array math.

Reference behavior:
  * HaplotypeCallerEngine.java:663-726 (per-locus ref-vs-any genotype likelihoods)
  * ReferenceConfidenceModel.java:399-524 (pileup element likelihood updates,
    REF_MODEL_DELETION_QUAL=30, isAltBeforeAssembly)
  * AlleleFrequencyCalculator.calculateSingleSampleBiallelicNonRefPosterior :272-287
  * BandPassActivityProfile.java (Gaussian kernel sigma=17, max filter 50,
    adaptive truncation at 1e-5; HQ-soft-clip state expansion)
  * ActivityProfile.java:300-468 (region boundary finding, best-cut local minima)

The streaming add/pop state machine is replaced by whole-shard vectorized passes:
scatter-add per-locus likelihoods, one convolution, then a linear scan for region
boundaries — identical outputs for whole-shard (forceConversion) evaluation.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
from scipy.special import gammaln

from ..utils import quals as qu
from ..utils.mathx import approximate_log10_sum_log10, log10_binomial_coefficient
from . import pileup as pileup_mod

REF_MODEL_DELETION_QUAL = 30
HQ_SOFTCLIP_QUAL_THRESHOLD = 28
AVERAGE_HQ_SOFTCLIPS_HQ_BASES_THRESHOLD = 6.0
LOG10_ONE_THIRD = -np.log10(3.0)

# AlleleFrequencyCalculator pseudocounts from standard genotype args
# (snpHeterozygosity=1e-3, heterozygosityStandardDeviation=1e-2 =>
#  refPseudocount=10, snpPseudocount=0.01)
DEFAULT_REF_PSEUDOCOUNT = 10.0
DEFAULT_SNP_PSEUDOCOUNT = 0.01
DEFAULT_INDEL_PSEUDOCOUNT = 0.00125

# activity profile defaults (AssemblyRegionArgumentCollection.java:22-27)
DEFAULT_MIN_REGION_SIZE = 50
DEFAULT_MAX_REGION_SIZE = 300
DEFAULT_REGION_PADDING = 100
DEFAULT_ACTIVE_PROB_THRESHOLD = 0.002
DEFAULT_MAX_PROB_PROPAGATION = 50
BAND_PASS_SIGMA = 17.0
MAX_FILTER_SIZE = 50
MIN_PROB_TO_KEEP_IN_FILTER = 1e-5


def make_band_pass_kernel(max_filter_size=MAX_FILTER_SIZE, sigma=BAND_PASS_SIGMA):
    """Adaptive-width normalized Gaussian kernel (BandPassActivityProfile:58-77)."""

    def kernel_of(fs):
        x = np.arange(2 * fs + 1, dtype=np.float64)
        k = np.exp(-((x - fs) ** 2) / (2.0 * sigma**2)) / (sigma * np.sqrt(2 * np.pi))
        return k / k.sum()

    full = kernel_of(max_filter_size)
    middle = max_filter_size
    filter_end = middle
    while filter_end > 0:
        if full[filter_end - 1] < MIN_PROB_TO_KEEP_IN_FILTER:
            break
        filter_end -= 1
    fs = middle - filter_end
    return kernel_of(fs), fs


BAND_PASS_KERNEL, BAND_PASS_FILTER_SIZE = make_band_pass_kernel()


_GL_LUT_CACHE: dict = {}


def _gl_luts(ploidy: int, alt_multiplier: float):
    """Per-(is_alt, qual) genotype-likelihood contribution tables, (ploidy+1, 512).

    Each pileup element's GL contribution depends only on (is_alt, eff_qual), so
    the per-element `where`/approximate-log-sum math collapses to a 2x256 grid
    evaluated once; elements then gather their row value and scatter via
    bincount. Values are computed with the exact same double-precision op
    sequence as the former per-element formulas, so results are bit-identical."""
    key = (ploidy, alt_multiplier)
    luts = _GL_LUT_CACHE.get(key)
    if luts is not None:
        return luts
    q = np.arange(256, dtype=np.uint8)
    p_good = qu.qual_to_prob_log10(q)
    p_err = qu.qual_to_error_prob_log10(q) + LOG10_ONE_THIRD
    # axis 0: is_alt (0 = matches ref, 1 = alt/deletion/adjacent)
    ref_lik = np.stack([p_good, p_err])
    nonref_lik = np.stack([p_err, p_good])
    w = np.array([1.0, alt_multiplier], dtype=np.float64)[:, None]
    log10_ploidy = np.log10(ploidy)
    rows = np.empty((ploidy + 1, 2, 256), dtype=np.float64)
    # qual-0 grid entries hit inf-inf -> nan inside the jacobian lookup; they
    # are unreachable (callers filter eff_qual > min_base_qual >= 0)
    with np.errstate(invalid="ignore"):
        rows[0] = w * (ref_lik + log10_ploidy)
        rows[ploidy] = w * (nonref_lik + log10_ploidy)
        for i in range(1, ploidy):
            j = ploidy - i
            rows[i] = w * approximate_log10_sum_log10(
                ref_lik + np.log10(j), nonref_lik + np.log10(i))
    luts = rows.reshape(ploidy + 1, 512)
    _GL_LUT_CACHE[key] = luts
    return luts


def compute_raw_activity(
    reads,
    span_start: int,
    span_end: int,
    ref_bases: np.ndarray,
    ploidy: int = 2,
    min_base_qual: int = 10,
    snp_pseudocount: float = DEFAULT_SNP_PSEUDOCOUNT,
    ref_pseudocount: float = DEFAULT_REF_PSEUDOCOUNT,
    alt_multiplier: float = 1.0,
):
    """Per-locus active probability + mean HQ soft clips, vectorized.

    ref_bases: uint8 array covering [span_start, span_end).
    Returns (probs, softclip_mean, softclip_is_hq) float arrays of span length.
    """
    n = span_end - span_start
    el = pileup_mod.build_pileup_elements(reads, span_start, span_end)
    pos, base, qual, flags = el["pos"], el["base"], el["qual"], el["flags"]
    read_idx = el["read_idx"]

    is_del = (flags & pileup_mod.F_DELETION) != 0
    eff_qual = np.where(is_del, REF_MODEL_DELETION_QUAL, qual).astype(np.uint8)
    # ReferenceConfidenceModel:418: skip iff qual <= min AND not a deletion (non-flow);
    # deletions carry the constant q30 so the single comparison covers both cases
    keep = eff_qual > min_base_qual
    pos, base, eff_qual, flags, read_idx, is_del = (
        a[keep] for a in (pos, base, eff_qual, flags, read_idx, is_del)
    )

    ref_at = ref_bases[pos]
    adjacency = (
        pileup_mod.F_BEFORE_DELETION
        | pileup_mod.F_AFTER_DELETION
        | pileup_mod.F_BEFORE_INSERTION
        | pileup_mod.F_AFTER_INSERTION
        | pileup_mod.F_NEXT_TO_SOFTCLIP
    )
    is_alt = (base != ref_at) | is_del | ((flags & adjacency) != 0)

    log10_ploidy = np.log10(ploidy)
    # genotype likelihood accumulation per locus (ploidy+1 entries): each
    # element's contribution is a pure function of (is_alt, eff_qual), so use
    # LUT gathers + bincount scatters (bit-identical to the former
    # where()/add.at formulation, ~10x faster on multi-million-element shards)
    luts = _gl_luts(ploidy, alt_multiplier)
    key = eff_qual.astype(np.int64)
    np.add(key, 256, out=key, where=is_alt)
    gl = np.empty((ploidy + 1, n))
    for i in range(ploidy + 1):
        gl[i] = np.bincount(pos, weights=luts[i][key], minlength=n)[:n]
    read_count = np.bincount(pos, minlength=n)[:n].astype(np.float64)
    gl -= read_count[None, :] * log10_ploidy

    # the engine round-trips GLs through integer PLs (GenotypeBuilder.PL), quantizing
    # to 0.1 log10 units — replicate for concordance
    pl = np.floor(-10.0 * (gl - gl.max(axis=0, keepdims=True)) + 0.5)
    gl = pl / -10.0

    # single-sample biallelic non-ref posterior (AlleleFrequencyCalculator:272-287)
    ncounts = np.arange(ploidy + 1, dtype=np.float64)
    prior = (
        log10_binomial_coefficient(ploidy, ncounts)
        + (gammaln(ncounts + snp_pseudocount) + gammaln(ploidy - ncounts + ref_pseudocount))
        * np.log10(np.e)
    )
    post = gl + prior[:, None]
    gl_max_is_ref = np.argmax(gl, axis=0) == 0
    post_max_is_ref = np.argmax(post, axis=0) == 0
    m = post.max(axis=0)
    with np.errstate(invalid="ignore"):
        lin = np.power(10.0, post - m[None, :])
    probs = 1.0 - lin[0] / lin.sum(axis=0)
    probs = np.where(gl_max_is_ref | post_max_is_ref | (read_count == 0), 0.0, probs)

    # HQ soft-clip running average per locus over alt+next-to-softclip elements
    sc_sum = np.zeros(n)
    sc_cnt = np.zeros(n)
    sc_mask = is_alt & ((flags & pileup_mod.F_NEXT_TO_SOFTCLIP) != 0)
    if sc_mask.any():
        hq_counts = {}
        ridx = read_idx[sc_mask]
        uniq = np.unique(ridx)
        for k in uniq:
            hq_counts[int(k)] = pileup_mod.count_high_quality_soft_clips(
                reads[int(k)], HQ_SOFTCLIP_QUAL_THRESHOLD
            )
        vals = np.array([hq_counts[int(k)] for k in ridx], np.float64)
        np.add.at(sc_sum, pos[sc_mask], vals)
        np.add.at(sc_cnt, pos[sc_mask], 1.0)
    with np.errstate(invalid="ignore"):
        sc_mean = np.where(sc_cnt > 0, sc_sum / np.maximum(sc_cnt, 1), 0.0)
    return probs, sc_mean


def band_pass(probs, sc_mean, contig_span, max_prob_propagation=DEFAULT_MAX_PROB_PROPAGATION):
    """Apply HQ-soft-clip expansion then Gaussian band-pass smoothing.

    contig_span: (span_start, contig_length) to drop mass beyond contig edges.
    """
    n = len(probs)
    span_start, contig_length = contig_span
    expanded = np.array(probs)
    is_hq = sc_mean > AVERAGE_HQ_SOFTCLIPS_HQ_BASES_THRESHOLD
    for x in np.nonzero(is_hq & (probs > 0))[0]:
        n_hq = min(int(sc_mean[x]), max_prob_propagation)
        lo = max(0, x - n_hq)
        hi = min(n - 1, x + n_hq)
        expanded[lo:hi + 1] += probs[x]
        expanded[x] -= probs[x]  # the center copy is included in the loop range

    out = np.zeros(n)
    fs = BAND_PASS_FILTER_SIZE
    conv = np.convolve(expanded, BAND_PASS_KERNEL, mode="full")  # length n + 2fs
    # position x receives conv[x + fs]; mass that falls off the contig is dropped
    out = conv[fs : fs + n]
    return out


@dataclass
class RawRegion:
    start: int  # span-relative
    end: int  # exclusive
    is_active: bool


def pop_regions(
    probs,
    threshold=DEFAULT_ACTIVE_PROB_THRESHOLD,
    min_region=DEFAULT_MIN_REGION_SIZE,
    max_region=DEFAULT_MAX_REGION_SIZE,
):
    """Segment the smoothed profile into active/inactive regions
    (ActivityProfile.popReadyAssemblyRegions with forceConversion semantics)."""
    n = len(probs)
    regions = []
    start = 0
    while start < n:
        remaining = n - start
        is_active = probs[start] > threshold
        limit = min(max_region, remaining)
        end_off = 0
        while end_off < limit and (probs[start + end_off] > threshold) == is_active:
            end_off += 1
        if is_active and end_off == max_region and end_off < remaining:
            end_off = _find_best_cut_site(probs[start : start + max_region + 1], end_off, min_region)
        regions.append(RawRegion(start, start + end_off, is_active))
        start += end_off
    return regions


def _find_best_cut_site(window, end_of_region, min_region):
    """Global minimum local-min within [min_region-1, end) (ActivityProfile:388-407)."""
    min_i = end_of_region - 1
    min_p = np.inf
    for i in range(end_of_region - 1, min_region - 2, -1):
        if i < 1 or i >= len(window) - 1:
            continue
        cur = window[i]
        if cur < min_p and window[i] <= window[i + 1] and window[i] < window[i - 1]:
            min_p = cur
            min_i = i
    return min_i + 1
