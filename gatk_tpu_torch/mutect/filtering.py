# Copied verbatim from gatk_tpu/mutect/filtering.py; only import lines may differ.
"""FilterMutectCalls: multi-pass probabilistic somatic call filtering.

A faithful re-architecture of the reference filtering engine:

- mutect/filtering/Mutect2FilteringEngine.java — per-variant error
  probabilities from a roster of Mutect2Filter subclasses, combined across
  error types (artifact / non-somatic / sequencing) treated as independent.
- mutect/clustering/SomaticClusteringModel.java — somatic allele-fraction
  spectrum: background + high-AF beta-binomial clusters plus BIC-selected
  binomial subclone clusters, EM-learned priors per indel length.
- mutect/filtering/ThresholdCalculator.java — threshold learned to optimize
  the F score (or bound the false-discovery rate).
- mutect/filtering/FilterMutectCalls.java — 2 learning passes + threshold
  pass + final apply pass, AS_FilterStatus allele-level filters, FAIL merge,
  filtering-stats output (FilteringOutputStats.java / FilterStats.java).

Hot math (beta-binomial log-pmfs over the cohort of candidate variants) is
vectorized numpy on host; this is control-plane work operating on kilobyte
tensors, not a TPU target.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
from scipy.special import betaln, digamma, gammaln, betainc

LN10 = math.log(10.0)

# ----------------------------------------------------------------------------
# filter names (utils/variant/GATKVCFConstants.java:182-206)
# ----------------------------------------------------------------------------
WEAK_EVIDENCE = "weak_evidence"
BASE_QUAL = "base_qual"
MAP_QUAL = "map_qual"
DUPLICATE = "duplicate"
STRAND_BIAS = "strand_bias"
CONTAMINATION = "contamination"
STRICT_STRAND = "strict_strand"
POSITION = "position"
LOW_ALLELE_FRAC = "low_allele_frac"
NORMAL_ARTIFACT = "normal_artifact"
N_RATIO = "n_ratio"
PANEL_OF_NORMALS = "panel_of_normals"
ORIENTATION = "orientation"
CLUSTERED_EVENTS = "clustered_events"
MULTIALLELIC = "multiallelic"
FRAGMENT = "fragment"
SLIPPAGE = "slippage"
HAPLOTYPE = "haplotype"
GERMLINE = "germline"
FAIL = "FAIL"
SITE = "SITE"  # SITE_LEVEL_FILTERS placeholder in AS_FilterStatus

ERROR_ARTIFACT = "artifact"
ERROR_NON_SOMATIC = "non_somatic"
ERROR_SEQUENCING = "sequencing"

EPSILON = 1.0e-10
MIN_REPORTABLE_ERROR_PROBABILITY = 0.1  # Mutect2FilteringEngine.java:31

AS_FILTER_STATUS_KEY = "AS_FilterStatus"


# ----------------------------------------------------------------------------
# math helpers (utils/NaturalLogUtils.java, MathUtils.java)
# ----------------------------------------------------------------------------

def log_sum_exp(xs):
    xs = np.asarray(xs, dtype=np.float64)
    m = np.max(xs)
    if not np.isfinite(m):
        return m
    return float(m + np.log(np.sum(np.exp(xs - m))))


def log1mexp(a: float) -> float:
    """log(1 - exp(a)) for a <= 0 (NaturalLogUtils.log1mexp)."""
    if a > 0:
        return math.nan
    if a == 0:
        return -math.inf
    return math.log1p(-math.exp(a)) if a < -0.693147 else math.log(-math.expm1(a))


def log_binom_coeff(n, k):
    return gammaln(n + 1) - gammaln(k + 1) - gammaln(n - k + 1)


def beta_binomial_log_prob(alpha, beta, n, k):
    """log BetaBinomial(k | n, alpha, beta) (validation/basicshortmutpileup/
    BetaBinomialDistribution.java), vectorized over any argument."""
    return (log_binom_coeff(n, k) + betaln(np.add(k, alpha), np.add(np.subtract(n, k), beta))
            - betaln(alpha, beta))


def binomial_log_prob(n, k, p):
    p = min(max(p, 0.0), 1.0)
    if p == 0.0:
        return 0.0 if k == 0 else -math.inf
    if p == 1.0:
        return 0.0 if k == n else -math.inf
    return float(log_binom_coeff(n, k) + k * math.log(p) + (n - k) * math.log1p(-p))


def binomial_prob(n, k, p):
    return math.exp(binomial_log_prob(n, k, p))


def posterior_probability_of_error(log_odds_real_vs_error: float, log_prior_real: float) -> float:
    """Mutect2FilteringEngine.posteriorProbabilityOfError: P(error) from the
    natural-log odds of real-vs-error and the natural-log prior of real."""
    log_real = log_odds_real_vs_error + log_prior_real
    log_error = log1mexp(log_prior_real)
    m = max(log_real, log_error)
    pr = math.exp(log_real - m)
    pe = math.exp(log_error - m)
    return pe / (pr + pe)


def error_prob_to_qual(p: float, max_qual: int = 93) -> int:
    """QualityUtils.errorProbToQual: phred-scale an error probability."""
    p = min(max(p, 0.0), 1.0)
    if p <= 0:
        return max_qual
    q = int(round(-10.0 * math.log10(p)))
    return max(1, min(max_qual, q))


def _clip01(p: float) -> float:
    return min(max(float(p), 0.0), 1.0)


# ----------------------------------------------------------------------------
# somatic clustering model (mutect/clustering/)
# ----------------------------------------------------------------------------

@dataclass
class Datum:
    """clustering/Datum.java: one alt allele of one candidate variant."""
    tumor_log_odds: float  # natural log
    artifact_prob: float
    non_somatic_prob: float
    alt_count: int
    total_count: int
    indel_length: int

    @property
    def non_sequencing_error_prob(self) -> float:
        return 1.0 - (1.0 - self.artifact_prob) * (1.0 - self.non_somatic_prob)


FLAT_BETA = (1.0, 1.0)


class BetaBinomialCluster:
    """clustering/BetaBinomialCluster.java: beta-binomial AF cluster with
    gradient-ascent beta-shape learning."""

    RATE = 0.01
    NUM_EPOCHS = 10

    def __init__(self, alpha: float, beta: float):
        self.alpha = alpha
        self.beta = beta

    def log_likelihood(self, total, alt):
        return beta_binomial_log_prob(self.alpha, self.beta, total, alt)

    def corrected_log_likelihood(self, datum: Datum) -> float:
        return corrected_log_likelihood(datum, self.alpha, self.beta)

    def learn(self, data: list, responsibilities: np.ndarray):
        alpha, beta = self.alpha, self.beta
        for _ in range(self.NUM_EPOCHS):
            for n, datum in enumerate(data):
                alt = datum.alt_count
                ref = datum.total_count - alt
                dg_total = digamma(datum.total_count + alpha + beta)
                dg_ab = digamma(alpha + beta)
                a_grad = digamma(alpha + alt) - dg_total - digamma(alpha) + dg_ab
                b_grad = digamma(beta + ref) - dg_total - digamma(beta) + dg_ab
                alpha = max(alpha + self.RATE * a_grad * responsibilities[n], 1.0)
                beta = max(beta + self.RATE * b_grad * responsibilities[n], 0.5)
        self.alpha, self.beta = alpha, beta

    def __str__(self):
        return f"alpha = {self.alpha:.2f}, beta = {self.beta:.2f}"


def _log_dirichlet_norm(*omega):
    return gammaln(sum(omega)) - sum(gammaln(w) for w in omega)


def corrected_log_likelihood(datum: Datum, alpha: float, beta: float) -> float:
    """BetaBinomialCluster.correctedLogLikelihood: tumor log odds corrected
    from the flat-beta AF prior of the somatic likelihoods model to this
    cluster's beta."""
    alt = datum.alt_count
    ref = datum.total_count - alt
    g = _log_dirichlet_norm
    correction = (g(alpha, beta) - g(alpha + alt, beta + ref)
                  - g(*FLAT_BETA) + g(FLAT_BETA[0] + alt, FLAT_BETA[1] + ref))
    return datum.tumor_log_odds + correction


class BinomialCluster:
    """clustering/BinomialCluster.java: near-discrete AF cluster as a sharp
    ("fuzzy binomial") beta-binomial with std-dev/mean = 0.01."""

    STD_DEV_OVER_MEAN = 0.01

    def __init__(self, mean: float):
        self._set_shape(mean)

    def _set_shape(self, unbounded_mean: float):
        mean = min(unbounded_mean, 1 - self.STD_DEV_OVER_MEAN)
        alpha_plus_beta = ((1 - mean) / (mean * self.STD_DEV_OVER_MEAN ** 2)) - 1
        self.alpha = mean * alpha_plus_beta
        self.beta = alpha_plus_beta - self.alpha

    def log_likelihood(self, total, alt):
        return beta_binomial_log_prob(self.alpha, self.beta, total, alt)

    def corrected_log_likelihood(self, datum: Datum) -> float:
        return corrected_log_likelihood(datum, self.alpha, self.beta)

    def learn(self, data: list, responsibilities: np.ndarray):
        alt = sum(d.alt_count * r for d, r in zip(data, responsibilities)) + 0.0001
        total = sum(d.total_count * r for d, r in zip(data, responsibilities)) + 0.0001
        self._set_shape(alt / total)

    def __str__(self):
        return f"mean = {self.alpha / (self.alpha + self.beta):.3f}"


class SomaticClusteringModel:
    """clustering/SomaticClusteringModel.java — allele-fraction spectrum model.

    Clusters: [0] broad background beta-binomial, [1] high-AF beta-binomial,
    [2..] binomial subclones split off the background by quantile-peak
    detection with a BIC acceptance test.
    """

    MAX_INDEL_SIZE_IN_PRIOR_MAP = 10
    NUM_INITIALIZATION_QUANTILES = 50
    MIN_QUANTILE_INDEX = int(0.1 * NUM_INITIALIZATION_QUANTILES)
    INITIAL_HIGH_AF_WEIGHT = 0.01
    MAX_FRACTION_OF_BACKGROUND_TO_SPLIT_OFF = 0.9
    REGULARIZING_PSEUDOCOUNT = 1.0
    NUM_ITERATIONS = 5
    MAX_BINOMIAL_CLUSTERS = 5
    OBVIOUS_ARTIFACT_PROBABILITY_THRESHOLD = 0.9
    LOG_ONE_THIRD = -math.log(3.0)

    def __init__(self, log_snv_prior: float, log_indel_prior: float,
                 initial_log_prior_of_variant_vs_artifact: float,
                 callable_sites: float | None):
        self.log_variant_priors = {}
        for n in range(-self.MAX_INDEL_SIZE_IN_PRIOR_MAP, self.MAX_INDEL_SIZE_IN_PRIOR_MAP + 1):
            self.log_variant_priors[n] = log_indel_prior
        self.log_variant_priors[0] = log_snv_prior
        self.log_variant_vs_artifact_prior = initial_log_prior_of_variant_vs_artifact
        self.callable_sites = callable_sites if (callable_sites or 0) >= 1 else None
        self.clusters = [BetaBinomialCluster(*FLAT_BETA), BetaBinomialCluster(10.0, 1.0)]
        self.log_cluster_weights = np.array(
            [math.log1p(self.INITIAL_HIGH_AF_WEIGHT), math.log(self.INITIAL_HIGH_AF_WEIGHT)])
        self.data: list[Datum] = []
        self.obvious_artifact_count = 0
        self._initialized = False

    # ---- recording ----

    def record(self, tumor_ads, tumor_log_odds, artifact_probs, non_somatic_probs, variant):
        """record one candidate site's alt alleles (symbolic alleles excluded)."""
        total_ad = int(sum(
            0 if alt.startswith("<") else ad
            for alt, ad in zip(variant.alts, tumor_ads[1:]))) + int(tumor_ads[0])
        for i in range(len(tumor_log_odds)):
            if variant.alts[i].startswith("<"):
                continue
            if artifact_probs[i] > self.OBVIOUS_ARTIFACT_PROBABILITY_THRESHOLD:
                self.obvious_artifact_count += 1
                continue
            if non_somatic_probs[i] > self.OBVIOUS_ARTIFACT_PROBABILITY_THRESHOLD:
                continue
            self.data.append(Datum(tumor_log_odds[i], artifact_probs[i], non_somatic_probs[i],
                                   int(tumor_ads[i + 1]), total_ad,
                                   indel_length(variant, i)))

    # ---- priors ----

    def log_prior_of_somatic_variant(self, variant, alt_index: int) -> float:
        return self._log_prior_by_indel_length(indel_length(variant, alt_index))

    def _log_prior_by_indel_length(self, ln: int) -> float:
        if ln not in self.log_variant_priors:
            self.log_variant_priors[ln] = min(self.log_variant_priors.values())
        return self.log_variant_priors[ln] + (self.LOG_ONE_THIRD if ln == 0 else 0.0)

    def log_prior_of_variant_vs_artifact(self) -> float:
        return self.log_variant_vs_artifact_prior

    # ---- likelihoods ----

    def _cluster_log_likelihoods(self, total: int, alt: int) -> np.ndarray:
        return np.array([w + c.log_likelihood(total, alt)
                         for w, c in zip(self.log_cluster_weights, self.clusters)])

    def log_likelihood_given_somatic(self, total: int, alt: int) -> float:
        return log_sum_exp(self._cluster_log_likelihoods(total, alt))

    def _background_prob_given_somatic(self, total: int, alt: int) -> float:
        lls = self._cluster_log_likelihoods(total, alt)
        p = np.exp(lls - log_sum_exp(lls))
        return float(p[0] / p.sum())

    def probability_of_sequencing_error(self, datum: Datum) -> float:
        lls = [w + c.corrected_log_likelihood(datum)
               for w, c in zip(self.log_cluster_weights, self.clusters)]
        variant_ll = log_sum_exp(lls)
        return posterior_probability_of_error(
            variant_ll, self._log_prior_by_indel_length(datum.indel_length))

    def _probability_of_somatic_variant(self, datum: Datum) -> float:
        seq_err = self.probability_of_sequencing_error(datum)
        return (1 - datum.artifact_prob) * (1 - datum.non_somatic_prob) * (1 - seq_err)

    # ---- learning ----

    def learn_and_clear(self):
        if not self._initialized:
            self._initialize_clusters()
        for _ in range(self.NUM_ITERATIONS):
            self._em_iteration(update_somatic_priors=True)
        self.data = []
        self.obvious_artifact_count = 0

    def _initialize_clusters(self):
        somatic_probs = np.array([self._probability_of_somatic_variant(d) for d in self.data]) \
            if self.data else np.zeros(0)
        previous_bic = -math.inf
        for _ in range(self.MAX_BINOMIAL_CLUSTERS):
            old_weights = self.log_cluster_weights.copy()
            if not self.data:
                break
            bg_given_somatic = np.array([
                self._background_prob_given_somatic(d.total_count, d.alt_count) for d in self.data])
            background_probs = somatic_probs * bg_given_somatic
            quantiles = self._allele_fraction_quantiles(somatic_probs)
            if quantiles.size == 0:
                break
            responsibilities = self._quantile_background_responsibilities(quantiles, background_probs)
            peaks_and_masses = self._peaks_and_masses(quantiles, responsibilities)
            if not peaks_and_masses:
                break
            peak, mass = max(peaks_and_masses, key=lambda pm: pm[1])
            if peak < quantiles[min(self.MIN_QUANTILE_INDEX, quantiles.size - 1)]:
                break
            total_mass = sum(m for _, m in peaks_and_masses)
            frac = min(self.MAX_FRACTION_OF_BACKGROUND_TO_SPLIT_OFF, mass / total_mass)
            new_cluster_log_weight = math.log(frac) + self.log_cluster_weights[0]
            # matches the reference (SomaticClusteringModel.java:186): the
            # background weight uses log1p(frac), an intentional conservative shrink
            new_background_weight = math.log1p(frac) + self.log_cluster_weights[0]
            self.clusters.append(BinomialCluster(peak))
            self.log_cluster_weights = np.concatenate([
                self.log_cluster_weights, [new_cluster_log_weight]])
            self.log_cluster_weights[0] = new_background_weight
            for _ in range(self.NUM_ITERATIONS):
                self._em_iteration(update_somatic_priors=False)
            lls = np.array([self.log_likelihood_given_somatic(d.total_count, d.alt_count)
                            for d in self.data])
            weighted_ll = float(np.sum(somatic_probs * lls))
            effective_count = float(np.sum(somatic_probs))
            n_params = 2 * len(self.clusters)
            bic = weighted_ll - n_params * math.log(max(effective_count, 1e-10))
            if bic < previous_bic:
                self.clusters.pop()
                self.log_cluster_weights = old_weights
                break
            previous_bic = bic
        self._initialized = True

    def _allele_fraction_quantiles(self, somatic_probs) -> np.ndarray:
        pairs = sorted(
            ((d.alt_count / max(d.total_count, 1), p) for d, p in zip(self.data, somatic_probs)),
            key=lambda x: x[0])
        total = sum(p for _, p in pairs)
        if total <= 0:
            return np.zeros(0)
        step = total / self.NUM_INITIALIZATION_QUANTILES
        out, cum, target = [], 0.0, step
        for af, p in pairs:
            cum += p
            if cum > target:
                out.append(af)
                while cum > target:
                    target += step
        return np.array(sorted(set(out)))

    def _quantile_background_responsibilities(self, quantiles, background_probs) -> np.ndarray:
        total = np.zeros(quantiles.size)
        for datum, bg in zip(self.data, background_probs):
            n, k = datum.total_count, datum.alt_count
            # posterior density of AF under a flat prior = (n+1) * Binom(k|n,f)
            with np.errstate(divide="ignore", invalid="ignore"):
                logs = (log_binom_coeff(n, k) + k * np.log(quantiles)
                        + (n - k) * np.log1p(-quantiles))
            dens = np.where(np.isfinite(logs), np.exp(logs), 0.0)
            total += dens * bg * (n + 1)
        return total

    def _peaks_and_masses(self, quantiles, responsibilities):
        peaks = []
        peak_mass, peak, peak_resp = 0.0, 0.0, 0.0
        n = quantiles.size
        for q in range(n):
            left_r = 0.0 if q == 0 else responsibilities[q - 1]
            r = responsibilities[q]
            right_r = 0.0 if q == n - 1 else responsibilities[q + 1]
            left_af = 0.0 if q == 0 else quantiles[q - 1]
            af = quantiles[q]
            peak_mass += (af - left_af) * (left_r + r) / 2.0
            if r > peak_resp:
                peak, peak_resp = af, r
            lc = int(r > left_r) - int(r < left_r)
            rc = int(r > right_r) - int(r < right_r)
            local_min = (lc < 0 and rc <= 0) or (lc <= 0 and rc < 0)
            if (local_min and q > 0) or q == n - 1:
                peaks.append((peak, peak_mass))
                peak_mass, peak, peak_resp = 0.0, af, r
        return peaks

    def _em_iteration(self, update_somatic_priors: bool):
        variant_counts_by_len: dict[int, float] = {
            n: 0.0 for n in range(-self.MAX_INDEL_SIZE_IN_PRIOR_MAP,
                                  self.MAX_INDEL_SIZE_IN_PRIOR_MAP + 1)}
        n_clusters = len(self.clusters)
        total_resp = np.zeros(n_clusters)
        all_resp = []
        for datum in self.data:
            somatic_prob = self._probability_of_somatic_variant(datum)
            variant_counts_by_len[datum.indel_length] = \
                variant_counts_by_len.get(datum.indel_length, 0.0) + somatic_prob
            lls = self._cluster_log_likelihoods(datum.total_count, datum.alt_count)
            resp_if_somatic = np.exp(lls - log_sum_exp(lls))
            resp_if_somatic /= resp_if_somatic.sum()
            resp = somatic_prob * resp_if_somatic
            total_resp += resp
            all_resp.append(resp)
        total_resp += self.REGULARIZING_PSEUDOCOUNT
        self.log_cluster_weights = np.log(total_resp / total_resp.sum())
        technical_artifact_count = self.obvious_artifact_count + sum(
            d.artifact_prob for d in self.data)
        variant_count = sum(variant_counts_by_len.values())
        if update_somatic_priors:
            self.log_variant_vs_artifact_prior = math.log(
                (variant_count + self.REGULARIZING_PSEUDOCOUNT)
                / (variant_count + technical_artifact_count + 2 * self.REGULARIZING_PSEUDOCOUNT))
            if self.callable_sites is not None:
                for n in range(-self.MAX_INDEL_SIZE_IN_PRIOR_MAP,
                               self.MAX_INDEL_SIZE_IN_PRIOR_MAP + 1):
                    ratio = variant_counts_by_len.get(n, 0.0) / self.callable_sites
                    self.log_variant_priors[n] = math.log(
                        max(ratio, 1.0e-8 if n == 0 else 1.0e-9))
        for c in range(n_clusters):
            resp_c = np.array([r[c] for r in all_resp]) if all_resp else np.zeros(0)
            self.clusters[c].learn(self.data, resp_c)

    def clustering_metadata(self):
        rows = []
        for n in range(-self.MAX_INDEL_SIZE_IN_PRIOR_MAP, self.MAX_INDEL_SIZE_IN_PRIOR_MAP + 1):
            kind = "SNV" if n == 0 else (
                ("deletion" if n < 0 else "insertion") + f" of length {abs(n)}")
            rows.append((f"Ln prior of {kind}", repr(self.log_variant_priors[n])))
        rows.append(("Background beta-binomial cluster",
                     f"weight = {math.exp(self.log_cluster_weights[0]):.4f}, {self.clusters[0]}"))
        rows.append(("High-AF beta-binomial cluster",
                     f"weight = {math.exp(self.log_cluster_weights[1]):.4f}, {self.clusters[1]}"))
        order = sorted(range(2, len(self.clusters)), key=lambda c: -self.log_cluster_weights[c])
        for c in order:
            rows.append(("Binomial cluster",
                         f"weight = {math.exp(self.log_cluster_weights[c]):.4f}, {self.clusters[c]}"))
        return rows


def indel_length(variant, alt_index: int) -> int:
    alt = variant.alts[alt_index]
    if alt.startswith("<") or alt == "*":
        return 0
    return len(alt) - len(variant.ref)


# ----------------------------------------------------------------------------
# threshold calculator (filtering/ThresholdCalculator.java)
# ----------------------------------------------------------------------------

class ThresholdCalculator:
    CONSTANT = "CONSTANT"
    FALSE_DISCOVERY_RATE = "FALSE_DISCOVERY_RATE"
    OPTIMAL_F_SCORE = "OPTIMAL_F_SCORE"

    def __init__(self, strategy: str = OPTIMAL_F_SCORE, initial_threshold: float = 0.1,
                 max_false_discovery_rate: float = 0.05, f_score_beta: float = 1.0):
        self.strategy = strategy
        self.threshold = initial_threshold
        self.max_fdr = max_false_discovery_rate
        self.f_score_beta = f_score_beta
        self.error_probabilities: list[float] = []

    def add_combined_error_probabilities(self, probs):
        self.error_probabilities.extend(probs)

    def relearn_threshold_and_clear(self):
        if self.strategy == self.FALSE_DISCOVERY_RATE:
            self.threshold = self.threshold_for_fdr(self.error_probabilities, self.max_fdr)
        elif self.strategy == self.OPTIMAL_F_SCORE:
            self.threshold = self.threshold_for_optimal_f_score(
                self.error_probabilities, self.f_score_beta)
        self.error_probabilities = []

    @staticmethod
    def threshold_for_optimal_f_score(posteriors, beta: float) -> float:
        posteriors = sorted(posteriors)
        n = len(posteriors)
        if n == 0:
            return 1.0  # nothing to filter; keep threshold permissive? ref: 0→filter all
        expected_tp = sum(1 - p for p in posteriors)
        tp = fp = 0.0
        fn = expected_tp
        best_idx, best_f = -1, 0.0
        b2 = beta * beta
        for i, p in enumerate(posteriors):
            tp += 1 - p
            fp += p
            fn -= 1 - p
            f = (1 + b2) * tp / ((1 + b2) * tp + b2 * fn + fp)
            if f >= best_f:
                best_idx, best_f = i, f
        if best_idx == -1:
            return 0.0
        return 1.0 if best_idx == n - 1 else posteriors[best_idx]

    @staticmethod
    def threshold_for_fdr(posteriors, requested_fpr: float) -> float:
        posteriors = sorted(posteriors)
        cumulative = 0.0
        for i, p in enumerate(posteriors):
            if (cumulative + p) / (i + 1) > requested_fpr:
                return posteriors[i - 1] if i > 0 else 0.0
            cumulative += p
        return 1.0


# ----------------------------------------------------------------------------
# filter argument collection (filtering/M2FiltersArgumentCollection.java)
# ----------------------------------------------------------------------------

@dataclass
class M2FilterArgs:
    threshold_strategy: str = ThresholdCalculator.OPTIMAL_F_SCORE
    f_score_beta: float = 1.0
    max_false_discovery_rate: float = 0.05
    initial_threshold: float = 0.1
    mitochondria: bool = False
    microbial: bool = False
    max_events_in_region: int = 3
    max_events_in_haplotype: int = 2
    max_alt_alleles: int = 1
    unique_alt_read_count: int = 0
    min_median_mapping_quality: int = -1  # -1 = by mode (30 / 20 mito+microbial)
    min_median_base_quality: int = 20
    max_median_fragment_length_difference: int = 10000
    min_median_read_position: int = 1
    max_n_ratio: float = math.inf
    min_reads_on_each_strand: int = 0
    min_af: float = 0.0
    log_snv_prior: float = -6 * LN10
    log_indel_prior: float = -7 * LN10
    initial_log_prior_of_variant_vs_artifact: float = -1 * LN10
    normal_p_value_threshold: float = 0.001
    min_slippage_length: int = 8
    slippage_rate: float = 0.1
    max_distance_to_filtered_call_on_same_haplotype: int = 100
    long_indel_length: int = 5
    contamination_estimate: float = 0.0
    contamination_by_sample: dict = field(default_factory=dict)
    tumor_segments: dict = field(default_factory=dict)  # sample -> [(contig, start, end, maf)]
    orientation_priors: dict = field(default_factory=dict)
    reference: object = None

    def effective_min_mmq(self) -> int:
        if self.min_median_mapping_quality >= 0:
            return self.min_median_mapping_quality
        return 20 if (self.mitochondria or self.microbial) else 30

    def effective_log_snv_prior(self) -> float:
        if self.mitochondria and self.log_snv_prior == -6 * LN10:
            return -2.5 * LN10
        return self.log_snv_prior

    def effective_log_indel_prior(self) -> float:
        if self.mitochondria and self.log_indel_prior == -7 * LN10:
            return -3.75 * LN10
        return self.log_indel_prior


# ----------------------------------------------------------------------------
# variant field access helpers
# ----------------------------------------------------------------------------

def _info_float_list(v, key):
    raw = v.info.get(key)
    if raw is None:
        return None
    return [float(x) for x in str(raw).split(",") if x not in ("", ".")]


def _info_int_list(v, key):
    raw = _info_float_list(v, key)
    return None if raw is None else [int(x) for x in raw]


def _sample_ints(sample, key):
    raw = sample.get(key)
    if raw in (None, "."):
        return None
    return [int(float(x)) for x in str(raw).split(",") if x not in ("", ".")]


def _sample_floats(sample, key):
    raw = sample.get(key)
    if raw in (None, "."):
        return None
    return [float(x) for x in str(raw).split(",") if x not in ("", ".")]


def get_tumor_log_odds(v):
    """TLOD (log10) → natural-log odds per alt (Mutect2FilteringEngine.getTumorLogOdds)."""
    t = _info_float_list(v, "TLOD")
    return None if t is None else [x * LN10 for x in t]


def weighted_median_posterior(depths_and_posteriors):
    """Mutect2Filter.weightedMedianPosteriorProbability."""
    total = sum(d for d, _ in depths_and_posteriors)
    cum = 0
    for d, p in sorted(depths_and_posteriors, key=lambda x: x[1]):
        cum += d
        if cum * 2 >= total:
            return p
    return 0.0


def get_strand_counts_by_allele(v):
    """per-allele (fwd, rev) counts incl. ref, from AS_SB_TABLE if present,
    else from the first sample's SB field (ref_f, ref_r, alt_f, alt_r; alt
    counts shared across alts) — StrandBiasUtils.getSBsForAlleles."""
    as_sb = v.info.get("AS_SB_TABLE")
    if as_sb:
        out = []
        for part in str(as_sb).split("|"):
            vals = [int(float(x)) for x in part.split(",") if x not in ("", ".")]
            out.append((vals + [0, 0])[:2])
        return out
    for s in v.samples:
        sb = _sample_ints(s, "SB")
        if sb and len(sb) == 4:
            return [[sb[0], sb[1]]] + [[sb[2], sb[3]] for _ in v.alts]
    return None


# ----------------------------------------------------------------------------
# filters
# ----------------------------------------------------------------------------

class Mutect2Filter:
    """filtering/Mutect2Filter.java equivalent; error_probabilities returns one
    probability per alt allele, or [] when the filter doesn't apply."""
    error_type = ERROR_ARTIFACT
    filter_name = ""
    phred_annotation = None  # INFO key for phred-scaled posterior
    required_annotations = ()
    is_variant_filter = False  # site-level (same prob for all alleles)

    def error_probabilities(self, v, engine):
        if all(k in v.info for k in self.required_annotations):
            return [_clip01(p) for p in self._calculate(v, engine)]
        return []

    def _calculate(self, v, engine):
        raise NotImplementedError

    def accumulate(self, v, error_probabilities, engine):
        pass

    def learn(self):
        pass

    def clear(self):
        pass


class VariantFilter(Mutect2Filter):
    is_variant_filter = True

    def _calculate(self, v, engine):
        p = self._calculate_single(v, engine)
        return [p] * len(v.alts)

    def _calculate_single(self, v, engine):
        raise NotImplementedError


class HardVariantFilter(VariantFilter):
    def _calculate_single(self, v, engine):
        return 1.0 if self.is_artifact(v, engine) else 0.0

    def is_artifact(self, v, engine):
        raise NotImplementedError


class HardAlleleFilter(Mutect2Filter):
    def _calculate(self, v, engine):
        return [1.0 if a else 0.0 for a in self.are_alleles_artifacts(v, engine)]

    def are_alleles_artifacts(self, v, engine):
        raise NotImplementedError


class TumorEvidenceFilter(Mutect2Filter):
    """weak_evidence (TumorEvidenceFilter.java): P(sequencing error) under the
    clustering model."""
    error_type = ERROR_SEQUENCING
    filter_name = WEAK_EVIDENCE
    phred_annotation = "SEQQ"
    required_annotations = ("TLOD",)

    def _calculate(self, v, engine):
        tumor_lods = get_tumor_log_odds(v)
        ads = engine.sum_ads(v, tumor=True, normal=False)
        total = int(ads.sum())
        model = engine.clustering
        return [model.probability_of_sequencing_error(
            Datum(tumor_lods[i], 0.0, 0.0, int(ads[i + 1]), total, indel_length(v, i)))
            for i in range(len(tumor_lods))]


class BaseQualityFilter(HardAlleleFilter):
    filter_name = BASE_QUAL
    required_annotations = ("MBQ",)

    def are_alleles_artifacts(self, v, engine):
        mbq = _info_int_list(v, "MBQ")
        return [q < engine.args.min_median_base_quality for q in mbq[1:]]


class MappingQualityFilter(HardAlleleFilter):
    filter_name = MAP_QUAL
    required_annotations = ("MMQ",)

    def are_alleles_artifacts(self, v, engine):
        mmq = _info_int_list(v, "MMQ")
        ref_q, alt_qs = mmq[0], list(mmq[1:])
        min_q = engine.args.effective_min_mmq()
        long_indel = engine.args.long_indel_length
        out = []
        for i, q in enumerate(alt_qs):
            if i < len(v.alts) and indel_length(v, i) >= long_indel:
                q = ref_q  # long indels borrow the ref MQ (MappingQualityFilter.java:31-38)
            out.append(q < min_q)
        return out


class DuplicatedAltReadFilter(HardAlleleFilter):
    filter_name = DUPLICATE
    # AS_UNIQ_ALT_READ_COUNT (UniqueAltReadCount.java:42), "|"-delimited per alt
    required_annotations = ("AS_UNIQ_ALT_READ_COUNT",)

    def are_alleles_artifacts(self, v, engine):
        raw = str(v.info["AS_UNIQ_ALT_READ_COUNT"])
        counts = [int(float(x)) for x in raw.split("|") if x not in ("", ".")]
        return [c <= engine.args.unique_alt_read_count for c in counts]


class StrictStrandBiasFilter(HardAlleleFilter):
    filter_name = STRICT_STRAND
    required_annotations = ()

    def are_alleles_artifacts(self, v, engine):
        if engine.args.min_reads_on_each_strand == 0:
            return []
        sbs = get_strand_counts_by_allele(v)
        if not sbs or len(sbs) <= 1:
            return []
        return [any(x == 0 for x in alt_sb) for alt_sb in sbs[1:]]


class ReadPositionFilter(HardAlleleFilter):
    filter_name = POSITION
    required_annotations = ("MPOS",)

    def are_alleles_artifacts(self, v, engine):
        mpos = _info_int_list(v, "MPOS")
        return [p > -1 and p < engine.args.min_median_read_position for p in mpos]


class MinAlleleFractionFilter(HardAlleleFilter):
    filter_name = LOW_ALLELE_FRAC
    required_annotations = ()

    def are_alleles_artifacts(self, v, engine):
        if engine.args.min_af <= 0:
            return []
        n_alts = len(v.alts)
        best = [0.0] * n_alts
        found = False
        for name, s in zip(engine.sample_names, v.samples):
            if name in engine.normal_samples:
                continue
            afs = _sample_floats(s, "AF")
            if afs is None:
                continue
            found = True
            for i in range(min(n_alts, len(afs))):
                best[i] = max(best[i], afs[i])
        if not found:
            return []
        return [b < engine.args.min_af for b in best]


class NRatioFilter(HardVariantFilter):
    filter_name = N_RATIO
    required_annotations = ("NCount",)

    def is_artifact(self, v, engine):
        ads = engine.sum_ads(v, tumor=True, normal=True)
        alt_count = int(ads.sum() - ads[0])
        if alt_count == 0:
            return False
        n_count = int(float(v.info.get("NCount", 0)))
        return n_count / alt_count >= engine.args.max_n_ratio


class PanelOfNormalsFilter(HardVariantFilter):
    filter_name = PANEL_OF_NORMALS
    required_annotations = ()

    def is_artifact(self, v, engine):
        return "PON" in v.info or "IN_PON" in v.info


class ClusteredEventsFilter(HardVariantFilter):
    filter_name = CLUSTERED_EVENTS
    required_annotations = ("ECNT", "ECNTH")

    def is_artifact(self, v, engine):
        ecnth = _info_int_list(v, "ECNTH")
        ecnt = int(float(v.info.get("ECNT", 0)))
        return (max(ecnth) > engine.args.max_events_in_haplotype
                or ecnt > engine.args.max_events_in_region)


class MultiallelicFilter(HardVariantFilter):
    filter_name = MULTIALLELIC
    required_annotations = ("TLOD",)
    MULTIALLELIC_LOD_THRESHOLD = 5.0

    def is_artifact(self, v, engine):
        tlods = _info_float_list(v, "TLOD")
        passing = sum(1 for t in tlods if t > self.MULTIALLELIC_LOD_THRESHOLD)
        return passing > engine.args.max_alt_alleles


class FragmentLengthFilter(HardVariantFilter):
    filter_name = FRAGMENT
    required_annotations = ("MFRL",)

    def is_artifact(self, v, engine):
        mfrl = _info_int_list(v, "MFRL")
        return abs(mfrl[1] - mfrl[0]) > engine.args.max_median_fragment_length_difference


class StrandArtifactFilter(Mutect2Filter):
    """strand_bias (StrandArtifactFilter.java): 3-state (fwd artifact / rev
    artifact / none) posterior with EM-learned artifact prior and beta shape."""
    error_type = ERROR_ARTIFACT
    filter_name = STRAND_BIAS
    phred_annotation = "STRANDQ"
    required_annotations = ()

    ALPHA_SEQ = 1.0
    BETA_SEQ_SNV = 1000.0
    BETA_SEQ_SHORT_INDEL = 5000.0
    BETA_SEQ_LONG_INDEL = 50000.0
    LONG_INDEL_SIZE = 3
    LONGEST_STRAND_ARTIFACT_INDEL_SIZE = 4
    INITIAL_ALPHA_STRAND = 1.0
    INITIAL_BETA_STRAND = 20.0
    INITIAL_PRIOR = 0.001
    ARTIFACT_PSEUDOCOUNT = 1.0
    NON_ARTIFACT_PSEUDOCOUNT = 1000.0

    def __init__(self):
        self.alpha_strand = self.INITIAL_ALPHA_STRAND
        self.beta_strand = self.INITIAL_BETA_STRAND
        self.prior = self.INITIAL_PRIOR
        self._e_steps = []  # (fwd_resp, rev_resp, fwd, rev, fwd_alt, rev_alt)

    def _calculate(self, v, engine):
        steps = self._artifact_probabilities(v)
        return [s[0] + s[1] for s in steps]

    def _artifact_probabilities(self, v):
        sbs = get_strand_counts_by_allele(v)
        if not sbs or len(sbs) <= 1:
            return []
        total_fwd = sum(sb[0] for sb in sbs)
        total_rev = sum(sb[1] for sb in sbs)
        out = []
        for i, alt_sb in enumerate(sbs[1:]):
            size = abs(indel_length(v, i)) if i < len(v.alts) else 0
            if alt_sb[0] + alt_sb[1] == 0 or size > self.LONGEST_STRAND_ARTIFACT_INDEL_SIZE:
                out.append((0.0, 0.0, total_fwd, total_rev, alt_sb[0], alt_sb[1]))
            else:
                out.append(self._strand_artifact_probability(
                    total_fwd, total_rev, alt_sb[0], alt_sb[1], size))
        return out

    def _strand_artifact_probability(self, fwd, rev, fwd_alt, rev_alt, indel_size):
        fwd_ll = (self._artifact_ll(fwd, fwd_alt)
                  + self._non_artifact_ll(rev, rev_alt, indel_size))
        rev_ll = (self._artifact_ll(rev, rev_alt)
                  + self._non_artifact_ll(fwd, fwd_alt, indel_size))
        none_ll = (float(log_binom_coeff(fwd, fwd_alt)) + float(log_binom_coeff(rev, rev_alt))
                   - float(log_binom_coeff(fwd + rev, fwd_alt + rev_alt))
                   + float(beta_binomial_log_prob(1, 1, fwd + rev, fwd_alt + rev_alt)))
        logs = np.array([fwd_ll + math.log(self.prior / 2),
                         rev_ll + math.log(self.prior / 2),
                         none_ll + math.log(1 - self.prior)])
        probs = np.exp(logs - log_sum_exp(logs))
        probs /= probs.sum()
        return (float(probs[0]), float(probs[1]), fwd, rev, fwd_alt, rev_alt)

    def _artifact_ll(self, n, k, alpha=None, beta=None):
        return float(beta_binomial_log_prob(
            alpha if alpha is not None else self.alpha_strand,
            beta if beta is not None else self.beta_strand, n, k))

    def _non_artifact_ll(self, n, k, indel_size):
        beta_seq = (self.BETA_SEQ_SNV if indel_size == 0 else
                    self.BETA_SEQ_SHORT_INDEL if indel_size < self.LONG_INDEL_SIZE
                    else self.BETA_SEQ_LONG_INDEL)
        return float(beta_binomial_log_prob(self.ALPHA_SEQ, beta_seq, n, k))

    def accumulate(self, v, error_probabilities, engine):
        self._e_steps.extend(self._artifact_probabilities(v))

    def learn(self):
        steps = self._e_steps
        potential = [s for s in steps if s[0] + s[1] > 0.1]
        total_art = sum(s[0] + s[1] for s in potential)
        total_non = sum(1 - s[0] - s[1] for s in steps)
        self.prior = ((total_art + self.ARTIFACT_PSEUDOCOUNT)
                      / (total_art + self.ARTIFACT_PSEUDOCOUNT
                         + total_non + self.NON_ARTIFACT_PSEUDOCOUNT))
        art_alt = sum(s[0] * s[4] + s[1] * s[5] for s in potential)
        art_depth = sum(s[0] * s[2] + s[1] * s[3] for s in potential)
        mean = ((art_alt + self.INITIAL_ALPHA_STRAND)
                / (art_depth + self.INITIAL_ALPHA_STRAND + self.INITIAL_BETA_STRAND))

        def objective(alpha):
            beta = (1 / mean - 1) * alpha
            return sum(s[0] * self._artifact_ll(s[2], s[4], alpha, beta)
                       + s[1] * self._artifact_ll(s[3], s[5], alpha, beta)
                       for s in potential)

        # brute-force single-parameter maximization (OptimizationUtils.max)
        grid = np.geomspace(0.01, 100, 60)
        vals = [objective(a) for a in grid]
        self.alpha_strand = float(grid[int(np.argmax(vals))])
        self.beta_strand = (1 / mean - 1) * self.alpha_strand
        self._e_steps = []

    def clear(self):
        self._e_steps = []


class PolymeraseSlippageFilter(VariantFilter):
    filter_name = SLIPPAGE
    phred_annotation = "STRQ"
    required_annotations = ("RPA", "RU")

    def _calculate_single(self, v, engine):
        rpa = _info_int_list(v, "RPA")
        if rpa is None or len(rpa) < 2:
            return 0.0
        ru = str(v.info.get("RU", ""))
        ref_str_bases = len(ru) * rpa[0]
        slips = rpa[0] - rpa[1]
        if ref_str_bases < engine.args.min_slippage_length or abs(slips) != 1:
            return 0.0
        ads = engine.sum_ads(v, tumor=True, normal=False)
        if ads.size < 2:
            return 0.0
        depth = int(ads.sum())
        alt_count = depth - int(ads[0])
        log_somatic = engine.clustering.log_likelihood_given_somatic(depth, alt_count)
        rate = engine.args.slippage_rate
        lik_slippage = float(betainc(ads[1] + 1, ads[0] + 1, rate))
        if lik_slippage <= 0:
            lik_slippage = binomial_prob(depth, int(ads[1]), rate)
        log_odds = log_somatic - math.log(max(lik_slippage, 1e-300))
        return engine.posterior_probability_of_error(v, log_odds, 0)


class GermlineFilter(VariantFilter):
    """germline (GermlineFilter.java): posterior that the max-LOD allele is a
    germline het/hom-alt rather than somatic, from POPAF + optional NLOD +
    tumor segmentation minor-allele fractions."""
    error_type = ERROR_NON_SOMATIC
    filter_name = GERMLINE
    phred_annotation = "GERMQ"
    required_annotations = ("TLOD", "POPAF")

    MIN_AF_FOR_GERMLINE_HOM_ALT = 0.9

    def _calculate_single(self, v, engine):
        somatic_log_odds = get_tumor_log_odds(v)
        max_i = int(np.argmax(somatic_log_odds))
        normal_lods = _info_float_list(v, "NLOD")
        neg_log10_afs = _info_float_list(v, "POPAF")
        population_af = 10.0 ** (-neg_log10_afs[max_i])
        if population_af < EPSILON:
            return 0.0
        if population_af > 1 - EPSILON:
            return 1.0
        counts = engine.sum_ads(v, tumor=True, normal=False)
        total = int(counts.sum())
        if total == 0:
            return 0.0
        alt_count = int(counts[max_i + 1])
        alt_af = engine.weighted_average_tumor_afs(v)[max_i]
        maf = self._minor_allele_fraction(v, engine, float(counts.sum()))
        log_germline_lik = math.log(0.5) + log_sum_exp([
            binomial_log_prob(total, alt_count, maf),
            binomial_log_prob(total, alt_count, 1 - maf)])
        log_somatic_lik = engine.clustering.log_likelihood_given_somatic(total, alt_count)
        log_odds_het = log_germline_lik - log_somatic_lik
        log_odds_hom = 0.0 if alt_af >= self.MIN_AF_FOR_GERMLINE_HOM_ALT else -math.inf
        normal_lod = (normal_lods[max_i] * LN10) if normal_lods else 0.0
        return self.germline_probability(
            -normal_lod, log_odds_het, log_odds_hom, population_af,
            engine.clustering.log_prior_of_somatic_variant(v, max_i))

    @staticmethod
    def germline_probability(normal_log_odds, log_odds_het, log_odds_hom,
                             population_af, log_prior_somatic):
        log_prior_not_somatic = log1mexp(log_prior_somatic)
        log_prior_het = math.log(max(2 * population_af * (1 - population_af), 1e-300))
        log_prior_hom = math.log(max(population_af ** 2, 1e-300))
        log_prior_not_germline = math.log(max((1 - population_af) ** 2, 1e-300))
        log_p_het = log_prior_het + log_odds_het + normal_log_odds + log_prior_not_somatic
        log_p_hom = log_prior_hom + log_odds_hom + normal_log_odds + log_prior_not_somatic
        log_p_germline = log_sum_exp([log_p_het, log_p_hom])
        log_p_somatic = log_prior_not_germline + log_prior_somatic
        m = max(log_p_germline, log_p_somatic)
        pg, ps = math.exp(log_p_germline - m), math.exp(log_p_somatic - m)
        return pg / (pg + ps)

    def _minor_allele_fraction(self, v, engine, total_ad):
        if total_ad <= 0:
            return 0.5
        weighted = 0.0
        for name, s in zip(engine.sample_names, v.samples):
            if name in engine.normal_samples:
                continue
            segs = engine.args.tumor_segments.get(name, [])
            maf = 0.5
            for contig, start, end, seg_maf in segs:
                if contig == v.contig and start <= v.pos <= end:
                    maf = seg_maf
                    break
            ad = _sample_ints(s, "AD") or [0]
            weighted += maf * sum(ad)
        return weighted / total_ad if weighted else 0.5


class NormalArtifactFilter(VariantFilter):
    filter_name = NORMAL_ARTIFACT
    required_annotations = ("NALOD", "TLOD")

    MIN_NORMAL_ARTIFACT_RATIO = 0.1
    IMPUTED_NORMAL_BASE_QUALITY = 30

    def _calculate_single(self, v, engine):
        tumor_lods = get_tumor_log_odds(v)
        max_i = int(np.argmax(tumor_lods))
        t_ads = engine.sum_ads(v, tumor=True, normal=False)
        t_depth, t_alt = int(t_ads.sum()), int(t_ads[max_i + 1])
        n_ads = engine.sum_ads(v, tumor=False, normal=True)
        n_depth, n_alt = int(n_ads.sum()), int(n_ads[max_i + 1])
        t_af = t_alt / t_depth if t_depth else 0.0
        n_af = n_alt / n_depth if n_depth else 0.0
        if n_af < self.MIN_NORMAL_ARTIFACT_RATIO * t_af:
            return 0.0
        nalods = _info_float_list(v, "NALOD")
        neg_log_odds = -nalods[max_i] * LN10
        p_artifact = posterior_probability_of_error(
            neg_log_odds, engine.clustering.log_prior_of_variant_vs_artifact())
        mbq = _info_int_list(v, "MBQ")
        median_ref_bq = mbq[0] if mbq else self.IMPUTED_NORMAL_BASE_QUALITY
        err = 10.0 ** (-median_ref_bq / 10.0)
        # 1 - P(X <= n_alt - 1) under Binom(n_depth, err)
        p_val = 1.0 - sum(binomial_prob(n_depth, k, err) for k in range(n_alt))
        return 1.0 if p_val < engine.args.normal_p_value_threshold else p_artifact


class ContaminationFilter(Mutect2Filter):
    error_type = ERROR_NON_SOMATIC
    filter_name = CONTAMINATION
    phred_annotation = "CONTQ"
    required_annotations = ("POPAF",)

    def _calculate(self, v, engine):
        n_alts = len(v.alts)
        per_allele = [[] for _ in range(n_alts)]
        neg_log10_afs = _info_float_list(v, "POPAF") or [math.inf] * n_alts
        afs = [10.0 ** (-x) for x in neg_log10_afs]
        for name, s in zip(engine.sample_names, v.samples):
            if name in engine.normal_samples:
                continue
            contamination = engine.args.contamination_by_sample.get(
                name, engine.args.contamination_estimate)
            contamination = max(0.0, min(contamination, 1 - EPSILON))
            ads = _sample_ints(s, "AD")
            if ads is None:
                continue
            total = sum(ads)
            for i in range(min(n_alts, len(ads) - 1)):
                alt = ads[i + 1]
                af = afs[i] if i < len(afs) else 0.0
                log_somatic = engine.clustering.log_likelihood_given_somatic(total, alt)
                single = (2 * af * (1 - af) * binomial_prob(total, alt, contamination / 2)
                          + af * af * binomial_prob(total, alt, contamination))
                many = binomial_prob(total, alt, contamination * af)
                log_contaminant = math.log(max(single, many, 1e-300))
                log_odds = log_somatic - log_contaminant
                post = engine.posterior_probability_of_error(v, log_odds, i)
                per_allele[i].append((alt, post))
        return [weighted_median_posterior(a) if a else 0.0 for a in per_allele]


class ReadOrientationFilter(Mutect2Filter):
    """orientation (ReadOrientationFilter.java): F1R2/F2R1 artifact posterior
    from LearnReadOrientationModel priors."""
    filter_name = ORIENTATION
    phred_annotation = "ROQ"
    required_annotations = ()

    def __init__(self, priors_by_sample: dict, reference):
        self.priors_by_sample = priors_by_sample
        self.reference = reference

    def error_probabilities(self, v, engine):
        if not self.priors_by_sample or self.reference is None or not v.is_snp():
            return []
        tlods = _info_float_list(v, "TLOD")
        if not tlods:
            return []
        from .orientation import orientation_artifact_probability as oap
        try:
            ctx = self.reference.fetch_bytes(v.contig, v.pos - 1, v.pos + 2).decode()
        except Exception:
            return []
        out = []
        for i, alt in enumerate(v.alts):
            if len(alt) != 1:
                out.append(0.0)
                continue
            pairs = []
            for name, s in zip(engine.sample_names, v.samples):
                if name in engine.normal_samples:
                    continue
                f1r2 = _sample_ints(s, "F1R2")
                f2r1 = _sample_ints(s, "F2R1")
                ad = _sample_ints(s, "AD")
                if f1r2 is None or f2r1 is None:
                    continue
                coll = self.priors_by_sample.get(name)
                if coll is None and self.priors_by_sample:
                    coll = next(iter(self.priors_by_sample.values()))
                p = oap(coll, ctx, alt, f1r2, f2r1, i)
                depth = ad[i + 1] if ad and len(ad) > i + 1 else sum(f1r2)
                pairs.append((depth, p))
            out.append(weighted_median_posterior(pairs) if pairs else 0.0)
        return [_clip01(p) for p in out]


class FilteredHaplotypeFilter(VariantFilter):
    """haplotype (FilteredHaplotypeFilter.java): propagate the worst artifact
    probability along a phased (PGT+PID) haplotype within a distance."""
    filter_name = HAPLOTYPE
    required_annotations = ()

    GERMLINE_PROBABILITY_TO_IGNORE_NORMAL_ARTIFACT = 0.25

    def __init__(self):
        self.accumulating: dict[str, list] = {}
        self.phased_probabilities: dict[str, list] = {}

    def _calculate_single(self, v, engine):
        phasing = self._phasing_string(v, engine)
        if phasing is None:
            return 0.0
        probs = self.phased_probabilities.get(phasing)
        if not probs:
            return 0.0
        max_dist = engine.args.max_distance_to_filtered_call_on_same_haplotype
        relevant = [p for pos, p in probs if abs(pos - v.pos) <= max_dist]
        return max(relevant) if relevant else 0.0

    def accumulate(self, v, error_probabilities, engine):
        by_filter = error_probabilities.by_filter
        germline_prob = max(
            (p for f, probs in by_filter.items() for p in probs
             if f.filter_name == GERMLINE), default=0.0)
        ignore_normal = germline_prob > self.GERMLINE_PROBABILITY_TO_IGNORE_NORMAL_ARTIFACT
        artifact_prob = max(
            (p for f, probs in by_filter.items() for p in probs
             if f.error_type != ERROR_NON_SOMATIC
             and not (ignore_normal and f.filter_name == NORMAL_ARTIFACT)
             and f.filter_name != self.filter_name), default=0.0)
        phasing = self._phasing_string(v, engine)
        if phasing is not None:
            self.accumulating.setdefault(phasing, []).append((v.pos, artifact_prob))

    def learn(self):
        self.phased_probabilities = self.accumulating
        self.accumulating = {}

    def clear(self):
        self.accumulating = {}

    @staticmethod
    def _phasing_string(v, engine):
        for name, s in zip(engine.sample_names, v.samples):
            if name in engine.normal_samples:
                continue
            pgt, pid = s.get("PGT"), s.get("PID")
            if pgt not in (None, ".") and pid not in (None, "."):
                return pgt + pid
        return None


# ----------------------------------------------------------------------------
# error-probability combination (filtering/ErrorProbabilities.java)
# ----------------------------------------------------------------------------

class ErrorProbabilities:
    def __init__(self, filters, v, engine):
        n_alts = len(v.alts)
        self.by_filter = {}
        for f in filters:
            probs = f.error_probabilities(v, engine)
            if probs:
                # pad/trim defensively to n_alts
                probs = (list(probs) + [0.0] * n_alts)[:n_alts]
                self.by_filter[f] = probs
        by_type = {ERROR_ARTIFACT: [], ERROR_NON_SOMATIC: [], ERROR_SEQUENCING: []}
        for f, probs in self.by_filter.items():
            by_type[f.error_type].append(probs)
        self.by_type_and_allele = {}
        for etype, lists in by_type.items():
            if lists:
                self.by_type_and_allele[etype] = [
                    max(lst[i] for lst in lists) for i in range(n_alts)]
            else:
                self.by_type_and_allele[etype] = [0.0] * n_alts
        self.combined = []
        for i in range(n_alts):
            true_prob = 1.0
            for etype in self.by_type_and_allele:
                true_prob *= 1.0 - self.by_type_and_allele[etype][i]
            self.combined.append(_clip01(1.0 - true_prob))

    @property
    def technical_artifact_probabilities(self):
        return self.by_type_and_allele[ERROR_ARTIFACT]

    @property
    def non_somatic_probabilities(self):
        return self.by_type_and_allele[ERROR_NON_SOMATIC]

    def variant_filters(self):
        return {f: probs[0] for f, probs in self.by_filter.items() if f.is_variant_filter}

    def allele_filters(self):
        return {f: probs for f, probs in self.by_filter.items() if not f.is_variant_filter}


# ----------------------------------------------------------------------------
# the engine
# ----------------------------------------------------------------------------

class Mutect2FilteringEngine:
    """filtering/Mutect2FilteringEngine.java equivalent."""

    def __init__(self, args: M2FilterArgs, sample_names, normal_samples=(),
                 callable_sites: float | None = None):
        self.args = args
        self.sample_names = list(sample_names)
        self.normal_samples = set(normal_samples)
        self.threshold_calculator = ThresholdCalculator(
            args.threshold_strategy, args.initial_threshold,
            args.max_false_discovery_rate, args.f_score_beta)
        self.clustering = SomaticClusteringModel(
            args.effective_log_snv_prior(), args.effective_log_indel_prior(),
            args.initial_log_prior_of_variant_vs_artifact, callable_sites)
        self.filters = self._build_filters(args)
        self._stats = FilteringOutputStats(self.filters)

    def _build_filters(self, args: M2FilterArgs):
        filters = [
            TumorEvidenceFilter(),
            BaseQualityFilter(),
            MappingQualityFilter(),
            DuplicatedAltReadFilter(),
            StrandArtifactFilter(),
            ContaminationFilter(),
            StrictStrandBiasFilter(),
            ReadPositionFilter(),
            MinAlleleFractionFilter(),
            NormalArtifactFilter(),
            NRatioFilter(),
            PanelOfNormalsFilter(),
        ]
        if args.orientation_priors:
            filters.append(ReadOrientationFilter(args.orientation_priors, args.reference))
        if not args.mitochondria and not args.microbial:
            filters.extend([
                ClusteredEventsFilter(),
                MultiallelicFilter(),
                FragmentLengthFilter(),
                PolymeraseSlippageFilter(),
                FilteredHaplotypeFilter(),
                GermlineFilter(),
            ])
        if args.microbial:
            filters.append(PolymeraseSlippageFilter())
        return filters

    # ---- helpers used by filters ----

    def is_tumor(self, sample_name: str) -> bool:
        return sample_name not in self.normal_samples

    def sum_ads(self, v, tumor=True, normal=False) -> np.ndarray:
        n = 1 + len(v.alts)
        ads = np.zeros(n, dtype=np.int64)
        for name, s in zip(self.sample_names, v.samples):
            is_normal = name in self.normal_samples
            if (tumor and not is_normal) or (normal and is_normal):
                sample_ads = _sample_ints(s, "AD")
                if sample_ads:
                    for i in range(min(n, len(sample_ads))):
                        ads[i] += sample_ads[i]
        return ads

    def weighted_average_tumor_afs(self, v):
        n_alts = len(v.alts)
        afs = np.zeros(n_alts)
        total_weight = 0.0
        for name, s in zip(self.sample_names, v.samples):
            if name in self.normal_samples:
                continue
            ad = _sample_ints(s, "AD") or [0]
            weight = float(sum(ad))
            total_weight += weight
            sample_afs = _sample_floats(s, "AF") or [0.0] * n_alts
            for i in range(min(n_alts, len(sample_afs))):
                afs[i] += weight * sample_afs[i]
        return afs / total_weight if total_weight else afs

    def posterior_probability_of_error(self, v, log_odds_real, alt_index) -> float:
        return posterior_probability_of_error(
            log_odds_real, self.clustering.log_prior_of_somatic_variant(v, alt_index))

    @property
    def threshold(self) -> float:
        return self.threshold_calculator.threshold

    # ---- passes ----

    def accumulate_data(self, v):
        if not v.alts or all(a == "<NON_REF>" for a in v.alts):
            return
        probs = ErrorProbabilities(self.filters, v, self)
        for f in self.filters:
            f.accumulate(v, probs, self)
        tumor_ads = self.sum_ads(v, tumor=True, normal=False)
        tumor_log_odds = get_tumor_log_odds(v)
        if tumor_log_odds is not None:
            self.clustering.record(
                tumor_ads, tumor_log_odds, probs.technical_artifact_probabilities,
                probs.non_somatic_probabilities, v)
        self.threshold_calculator.add_combined_error_probabilities(probs.combined)

    def learn_parameters(self):
        for f in self.filters:
            f.learn()
            f.clear()
        self.clustering.learn_and_clear()
        self.threshold_calculator.relearn_threshold_and_clear()
        self._stats.clear()

    def learn_threshold(self):
        self.threshold_calculator.relearn_threshold_and_clear()
        self._stats.clear()

    def apply_filters(self, v):
        """Final pass: set v.filters + AS_FilterStatus + phred annotations
        (applyFiltersAndAccumulateOutputStats)."""
        probs = ErrorProbabilities(self.filters, v, self)
        self._stats.record_call(probs, self.threshold - EPSILON)
        error_threshold = min(1 - EPSILON, max(EPSILON, self.threshold))
        n_alts = len(v.alts)

        site_filters: dict[str, float] = {}

        # allele-specific filters → per-allele status strings
        allele_status_by_filter = []
        for f, allele_probs in probs.allele_filters().items():
            allele_status_by_filter.append([
                f.filter_name if p > error_threshold else SITE for p in allele_probs])

        filters_by_allele = [[row[i] for row in allele_status_by_filter]
                             for i in range(n_alts)] if allele_status_by_filter else [[]] * n_alts
        distinct_by_allele = []
        for lst in filters_by_allele:
            distinct = list(dict.fromkeys(lst))
            if len(distinct) > 1 and SITE in distinct:
                distinct.remove(SITE)
            if not distinct:
                distinct = [SITE]
            distinct_by_allele.append(distinct)
        if allele_status_by_filter:
            as_status = []
            for i, alt in enumerate(v.alts):
                if alt.startswith("<"):
                    as_status.append(SITE)
                else:
                    as_status.append(",".join(distinct_by_allele[i]))
            v.info[AS_FILTER_STATUS_KEY] = "|".join(as_status)

        # allele filters promote to site filters when every allele fails the same way
        for statuses in allele_status_by_filter:
            if statuses and len(set(statuses)) == 1 and statuses[0] != SITE:
                site_filters[statuses[0]] = 1.0

        # variant(site)-level filters
        for f, p in probs.variant_filters().items():
            if f.phred_annotation and all(k in v.info for k in f.required_annotations):
                v.info[f.phred_annotation] = str(error_prob_to_qual(p))
            if p > error_threshold:
                site_filters[f.filter_name] = p

        # FAIL: all alleles filtered, but for different reasons
        if not site_filters and allele_status_by_filter and \
                any(d != [SITE] for d in distinct_by_allele):
            non_symbolic = [d for alt, d in zip(v.alts, distinct_by_allele)
                            if not alt.startswith("<")]
            if non_symbolic and not any(SITE in d for d in non_symbolic):
                site_filters[FAIL] = 1.0

        if site_filters:
            max_p = max(site_filters.values())
            cutoff = min(max_p, MIN_REPORTABLE_ERROR_PROBABILITY)
            v.filters = tuple(name for name, p in site_filters.items() if p >= cutoff)
        else:
            v.filters = ("PASS",)
        return v

    def write_filtering_stats(self, path: str):
        self._stats.write(path, self.threshold, self.clustering.clustering_metadata())


class FilteringOutputStats:
    """filtering/FilteringOutputStats.java: expected TP/FP/FN bookkeeping."""

    def __init__(self, filters):
        self.filters = filters
        self.clear()

    def clear(self):
        self.n_pass = 0
        self.tps = self.fps = self.fns = 0.0
        self.filter_fps = {f: 0.0 for f in self.filters}
        self.filter_fns = {f: 0.0 for f in self.filters}

    def record_call(self, probs: ErrorProbabilities, threshold: float):
        combined = probs.combined
        is_filtered = [p > threshold for p in combined]
        for p in combined:
            if p > threshold:
                self.fns += 1.0 - p
            else:
                self.n_pass += 1
                self.fps += p
                self.tps += 1 - p
        for i, p_comb in enumerate(combined):
            for f, allele_probs in probs.by_filter.items():
                p = allele_probs[i]
                if p > EPSILON and p > threshold - EPSILON:
                    self.filter_fns[f] += 1 - p_comb
                elif not is_filtered[i]:
                    self.filter_fps[f] += p

    def write(self, path: str, threshold: float, clustering_metadata):
        total_true = self.tps + self.fns
        with open(path, "w") as fh:
            fh.write(f"#<METADATA>SAMPLE=null\n")
            fh.write(f"#<METADATA>threshold={threshold:.6f}\n")
            fh.write(f"#<METADATA>fdr={(self.fps / max(self.n_pass, 1)):.6f}\n")
            fh.write(f"#<METADATA>sensitivity={(self.tps / total_true if total_true else 1.0):.6f}\n")
            for key, value in clustering_metadata:
                fh.write(f"#<METADATA>{key}={value}\n")
            fh.write("filter\tFP\tFDR\tFN\tFNR\n")
            for f in self.filters:
                fp, fn = self.filter_fps[f], self.filter_fns[f]
                if fp > 0 or fn > 0:
                    fdr = fp / self.n_pass if self.n_pass else 0.0
                    fnr = fn / total_true if total_true else 0.0
                    fh.write(f"{f.filter_name}\t{fp:.2f}\t{fdr:.2f}\t{fn:.2f}\t{fnr:.2f}\n")


# ----------------------------------------------------------------------------
# driver (FilterMutectCalls.java pass structure)
# ----------------------------------------------------------------------------

NUMBER_OF_LEARNING_PASSES = 2

MUTECT_FILTER_HEADER_LINES = [
    '##FILTER=<ID=PASS,Description="All filters passed">',
    '##FILTER=<ID=FAIL,Description="Fail the site if all alleles fail but for different reasons.">',
    '##FILTER=<ID=base_qual,Description="alt median base quality">',
    '##FILTER=<ID=clustered_events,Description="Clustered events observed in the tumor">',
    '##FILTER=<ID=contamination,Description="contamination">',
    '##FILTER=<ID=duplicate,Description="evidence for alt allele is overrepresented by apparent duplicates">',
    '##FILTER=<ID=fragment,Description="abs(ref - alt) median fragment length">',
    '##FILTER=<ID=germline,Description="Evidence indicates this site is germline, not somatic">',
    '##FILTER=<ID=haplotype,Description="Variant near filtered variant on same haplotype.">',
    '##FILTER=<ID=low_allele_frac,Description="Allele fraction is below specified threshold">',
    '##FILTER=<ID=map_qual,Description="ref - alt median mapping quality">',
    '##FILTER=<ID=multiallelic,Description="Site filtered because too many alt alleles pass tumor LOD">',
    '##FILTER=<ID=n_ratio,Description="Ratio of N to alt exceeds specified ratio">',
    '##FILTER=<ID=normal_artifact,Description="artifact_in_normal">',
    '##FILTER=<ID=orientation,Description="orientation bias detected by the orientation bias mixture model">',
    '##FILTER=<ID=panel_of_normals,Description="Blacklisted site in panel of normals">',
    '##FILTER=<ID=position,Description="median distance of alt variants from end of reads">',
    '##FILTER=<ID=slippage,Description="site filtered due to contraction of short tandem repeat region">',
    '##FILTER=<ID=strand_bias,Description="Evidence for alt allele comes from one read direction only">',
    '##FILTER=<ID=strict_strand,Description="Evidence for alt allele is not represented in both directions">',
    '##FILTER=<ID=weak_evidence,Description="Mutation does not meet likelihood threshold">',
    '##INFO=<ID=AS_FilterStatus,Number=A,Type=String,Description="Filter status for each allele, as assessed by ApplyVQSR. Note that the VCF filter field will reflect the most lenient/sensitive status across all alleles.">',
    '##INFO=<ID=GERMQ,Number=1,Type=Integer,Description="Phred-scaled quality that alt alleles are not germline variants">',
    '##INFO=<ID=SEQQ,Number=1,Type=Integer,Description="Phred-scaled quality that alt alleles are not sequencing errors">',
    '##INFO=<ID=STRQ,Number=1,Type=Integer,Description="Phred-scaled quality that alt alleles in STRs are not polymerase slippage errors">',
]


def read_mutect_stats(path: str) -> dict:
    """Parse the Mutect2 .stats sidecar (MutectStats.java table)."""
    stats = {}
    try:
        with open(path) as fh:
            header = fh.readline()
            for line in fh:
                parts = line.rstrip("\n").split("\t")
                if len(parts) >= 2:
                    try:
                        stats[parts[0]] = float(parts[1])
                    except ValueError:
                        pass
    except OSError:
        pass
    return stats


def run_filter_mutect_calls(variants, args: M2FilterArgs, sample_names,
                            normal_samples=(), callable_sites=None,
                            filtering_stats_path=None):
    """Run the full multi-pass filtering protocol in memory; mutates variants'
    FILTER / INFO fields and returns (n_pass, n_filtered, engine)."""
    engine = Mutect2FilteringEngine(args, sample_names, normal_samples, callable_sites)
    for n in range(NUMBER_OF_LEARNING_PASSES):
        for v in variants:
            engine.accumulate_data(v)
        engine.learn_parameters()
    for v in variants:  # threshold pass
        engine.accumulate_data(v)
    engine.learn_threshold()
    n_pass = n_filt = 0
    for v in variants:
        engine.apply_filters(v)
        if v.filters == ("PASS",):
            n_pass += 1
        else:
            n_filt += 1
    if filtering_stats_path:
        engine.write_filtering_stats(filtering_stats_path)
    return n_pass, n_filt, engine
