# Copied verbatim from gatk_tpu/recal/report.py; only import lines may differ.
"""GATKReport tables, RecalDatum math, and quality quantization.

Reference behavior: utils/report/GATKReportTable.java (format + column
width/alignment + SORT_BY_COLUMN ordering), utils/recalibration/RecalDatum.java
(Bayesian empirical quality), utils/recalibration/QualQuantizer.java (greedy
penalty-minimizing interval merging), QuantizationInfo.java.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from ..utils.quals import qual_to_error_prob

MAX_SAM_QUAL_SCORE = 93
MAX_PHRED_SCORE = 93
MAX_RECALIBRATED_Q_SCORE = 93
MAX_REASONABLE_Q_SCORE = 60
MAX_GATK_USABLE_Q_SCORE = 40
MIN_USABLE_Q_SCORE = 6
SMOOTHING_CONSTANT = 1

EVENT_TYPES = ("M", "I", "D")  # BASE_SUBSTITUTION, BASE_INSERTION, BASE_DELETION


# ---------------------------------------------------------------------------
# RecalDatum math (RecalDatum.java)
# ---------------------------------------------------------------------------

# log prior cache: Gaussian(mean=0, sigma=0.5) log density at integer deltas
_LOG_PRIOR_CACHE = np.array(
    [
        -0.5 * (d / 0.5) ** 2 - math.log(0.5 * math.sqrt(2 * math.pi))
        for d in range(MAX_GATK_USABLE_Q_SCORE + 1)
    ]
)

_LOG10 = math.log(10.0)


def java_log10(x: float) -> float:
    """Math.log10 stand-in. HotSpot's x86 log10 intrinsic differs from a
    correctly-rounded log10 by an ulp on some inputs, and GATK's truncated
    prior-offset logic in RecalDatum.getLogPrior is sensitive to that noise:
    against the reference's gatk4_combined.tbl gather golden, ~0.09% of rows
    land on the other side of a MAP-estimate tie (EmpiricalQuality +/-1).
    A correctly-rounded log10 minimizes that divergence."""
    return math.log10(x)


def java_round(x: float) -> int:
    """Math.round semantics: floor(x + 0.5) (half-up, unlike python's banker's rounding)."""
    return int(math.floor(x + 0.5))


def _log_binomial_probability(n: int, k: int, p: float) -> float:
    """log(C(n,k) p^k (1-p)^(n-k)) in natural log."""
    if p <= 0.0:
        return 0.0 if k == 0 else -math.inf
    if p >= 1.0:
        return 0.0 if k == n else -math.inf
    return (
        math.lgamma(n + 1)
        - math.lgamma(k + 1)
        - math.lgamma(n - k + 1)
        + k * math.log(p)
        + (n - k) * math.log1p(-p)
    )


def bayesian_estimate_of_empirical_quality(n_obs: int, n_errors: int, prior_mean_q: float) -> int:
    """argmax_q [ logPrior(|q - prior|) + logBinomial(q; n_obs, n_errors) ]."""
    best_q, best = 0, -math.inf
    for q in range(MAX_REASONABLE_Q_SCORE + 1):
        diff = min(abs(int(q - prior_mean_q)), MAX_GATK_USABLE_Q_SCORE)
        log_prior = _LOG_PRIOR_CACHE[diff]
        if n_obs == 0:
            ll = 0.0
        else:
            ll = _log_binomial_probability(n_obs, n_errors, qual_to_error_prob(q))
            if not math.isfinite(ll):
                ll = -np.finfo(np.float64).max
        post = log_prior + ll
        if post > best:
            best, best_q = post, q
    return best_q


@dataclass
class RecalDatum:
    """observations + (fractional) errors for one covariate bin."""

    num_observations: int = 0
    num_mismatches: float = 0.0
    reported_quality: float = 0.0
    _empirical: int | None = field(default=None, repr=False)

    def copy(self) -> "RecalDatum":
        d = RecalDatum(self.num_observations, self.num_mismatches, self.reported_quality)
        d._empirical = self._empirical
        return d

    def combine(self, other: "RecalDatum"):
        expected = self.calc_expected_errors() + other.calc_expected_errors()
        self.num_observations += other.num_observations
        self.num_mismatches += other.num_mismatches
        # Java Math.log10 semantics matter: the fp noise of the combined
        # reported quality feeds the truncated prior offset in the MAP estimate
        self.reported_quality = -10.0 * java_log10(expected / self.num_observations)
        self._empirical = None

    def calc_expected_errors(self) -> float:
        return self.num_observations * qual_to_error_prob(self.reported_quality)

    def empirical_quality(self, prior: float | None = None) -> float:
        if self._empirical is None:
            if prior is None:
                prior = self.reported_quality
            mismatches = int(self.num_mismatches + 0.5) + SMOOTHING_CONSTANT
            observations = self.num_observations + 2 * SMOOTHING_CONSTANT
            self._empirical = min(
                bayesian_estimate_of_empirical_quality(observations, mismatches, prior),
                MAX_RECALIBRATED_Q_SCORE,
            )
        return float(self._empirical)


# ---------------------------------------------------------------------------
# GATKReport (GATKReport.java / GATKReportTable.java)
# ---------------------------------------------------------------------------

GATKREPORT_HEADER_PREFIX = "#:GATKReport."
GATKTABLE_HEADER_PREFIX = "#:GATKTable"
LATEST_REPORT_VERSION = "v1.1"


class ReportTable:
    """In-memory GATKReport table with byte-faithful text output."""

    def __init__(self, name: str, description: str, columns, sort_by_column=True):
        """columns: list of (column_name, format) where format is e.g. '%d', '%.4f', '%s' or ''."""
        self.name = name
        self.description = description
        self.columns = list(columns)
        self.rows = []  # list of tuples of raw python values
        self.sort_by_column = sort_by_column

    def add_row(self, *values):
        if len(values) != len(self.columns):
            raise ValueError("row arity mismatch")
        self.rows.append(tuple(values))

    @staticmethod
    def _format_value(value, fmt: str) -> str:
        if value is None:
            return "null"
        if fmt == "" or fmt == "%s":
            if isinstance(value, bool):
                return "true" if value else "false"
            if isinstance(value, float):
                return f"{value:.8f}"
            return str(value)
        if fmt == "%d":
            return f"{int(value):d}"
        if fmt.startswith("%.") and fmt.endswith("f"):
            if isinstance(value, float) and not math.isfinite(value):
                return repr(value)
            nd = int(fmt[2:-1])
            return f"{float(value):.{nd}f}"
        return fmt % value

    @staticmethod
    def _sort_key(row):
        # GATKReportTable.ROW_COMPARATOR: typed comparison per column; mixed
        # types compare by toString. Our columns hold homogeneous types.
        out = []
        for v in row:
            if isinstance(v, bool):
                out.append(str(v).lower())
            elif isinstance(v, (int, float)):
                out.append(v)
            else:
                out.append(str(v))
        return out

    def render(self) -> str:
        rows = self.rows
        if self.sort_by_column:
            import functools

            def cmp(r1, r2):
                for v1, v2 in zip(r1, r2):
                    t1, t2 = type(v1), type(v2)
                    if t1 is not t2 or isinstance(v1, str) or v1 is None:
                        s1, s2 = self._format_str_java(v1), self._format_str_java(v2)
                        c = (s1 > s2) - (s1 < s2)
                    else:
                        c = (v1 > v2) - (v1 < v2)
                    if c:
                        return c
                return 0

            rows = sorted(rows, key=functools.cmp_to_key(cmp))

        formatted = [
            [self._format_value(v, self.columns[i][1]) for i, v in enumerate(row)]
            for row in rows
        ]
        widths, aligns = [], []
        for i, (cname, _fmt) in enumerate(self.columns):
            w = len(cname)
            right = True
            for row in formatted:
                w = max(w, len(row[i]))
                if not _is_right_align(row[i]):
                    right = False
            widths.append(w)
            aligns.append(right)

        fmts = ":".join(fmt or "%s" for _n, fmt in self.columns)
        lines = [f"{GATKTABLE_HEADER_PREFIX}:{len(self.columns)}:{len(rows)}:{fmts}:;"]
        lines.append(f"{GATKTABLE_HEADER_PREFIX}:{self.name}:{self.description}")
        lines.append("  ".join(f"{n:<{widths[i]}}" for i, (n, _f) in enumerate(self.columns)))
        for row in formatted:
            cells = [
                f"{c:>{widths[i]}}" if aligns[i] else f"{c:<{widths[i]}}"
                for i, c in enumerate(row)
            ]
            lines.append("  ".join(cells))
        lines.append("")
        return "\n".join(lines) + "\n"

    @staticmethod
    def _format_str_java(v) -> str:
        if v is None:
            return "null"
        if isinstance(v, bool):
            return "true" if v else "false"
        return str(v)


def _is_right_align(value: str) -> bool:
    if value in ("null", "NA"):
        return True
    try:
        float(value.strip())
        return True
    except ValueError:
        return False


def render_report(tables) -> str:
    out = [f"{GATKREPORT_HEADER_PREFIX}{LATEST_REPORT_VERSION}:{len(tables)}\n"]
    for t in tables:
        out.append(t.render())
    return "".join(out)


def parse_report(text: str):
    """Parse a GATKReport into a list of (name, description, columns, rows-of-strings).

    Values are returned as strings split on whitespace (sufficient because no
    GATKReport column value in the recal tables contains spaces).
    """
    lines = text.splitlines()
    if not lines or not lines[0].startswith(GATKREPORT_HEADER_PREFIX):
        raise ValueError("not a GATKReport")
    n_tables = int(lines[0].split(":")[2])
    tables = []
    i = 1
    for _ in range(n_tables):
        while i < len(lines) and not lines[i].startswith(GATKTABLE_HEADER_PREFIX):
            i += 1
        decl = lines[i].split(":")
        ncols, nrows = int(decl[2]), int(decl[3])
        fmts = decl[4 : 4 + ncols]
        i += 1
        name_desc = lines[i].split(":", 3)
        name, desc = name_desc[2], name_desc[3] if len(name_desc) > 3 else ""
        i += 1
        colnames = lines[i].split()
        i += 1
        rows = []
        for _r in range(nrows):
            rows.append(lines[i].split())
            i += 1
        tables.append((name, desc, list(zip(colnames, fmts)), rows))
    return tables


# ---------------------------------------------------------------------------
# Quality quantization (QualQuantizer.java / QuantizationInfo.java)
# ---------------------------------------------------------------------------


class _QualInterval:
    __slots__ = ("q_start", "q_end", "n_obs", "n_errors", "level", "fixed_qual", "subs", "merge_order")

    def __init__(self, q_start, q_end, n_obs, n_errors, level, fixed_qual=-1, subs=()):
        self.q_start = q_start
        self.q_end = q_end
        self.n_obs = n_obs
        self.n_errors = n_errors
        self.level = level
        self.fixed_qual = fixed_qual
        self.subs = tuple(subs)
        self.merge_order = 0

    def error_rate(self) -> float:
        if self.fixed_qual != -1:
            return qual_to_error_prob(self.fixed_qual)
        if self.n_obs == 0:
            return 0.0
        return (self.n_errors + 1) / (1.0 * (self.n_obs + 1))

    def qual(self) -> int:
        if self.fixed_qual != -1:
            return self.fixed_qual
        # QualityUtils.errorProbToQual: round then bound to [1, MAX_SAM_QUAL_SCORE]
        er = self.error_rate()
        if er <= 0.0:
            return MAX_SAM_QUAL_SCORE
        q = java_round(-10.0 * math.log10(er))
        return max(1, min(q, MAX_SAM_QUAL_SCORE))

    def merge(self, right: "_QualInterval") -> "_QualInterval":
        left = self
        if left.q_start > right.q_start:
            left, right = right, left
        return _QualInterval(
            left.q_start, right.q_end, left.n_obs + right.n_obs,
            left.n_errors + right.n_errors, max(left.level, right.level) + 1,
            -1, (left, right),
        )

    def penalty(self, min_interesting_qual: int) -> float:
        return self._calc_penalty(self.error_rate(), min_interesting_qual)

    def _calc_penalty(self, global_error_rate: float, min_interesting: int) -> float:
        if global_error_rate == 0.0:
            return 0.0
        if not self.subs:
            if self.q_end <= min_interesting:
                return 0.0
            return abs(math.log10(self.error_rate()) - math.log10(global_error_rate)) * self.n_obs
        return sum(s._calc_penalty(global_error_rate, min_interesting) for s in self.subs)


def quantize_quals(n_observations_per_qual, n_levels: int, min_interesting_qual: int = MIN_USABLE_Q_SCORE):
    """Greedy interval merging; returns list mapping original qual -> quantized qual."""
    intervals = []
    for q, n_obs in enumerate(n_observations_per_qual):
        n_err = int(math.floor(n_obs * qual_to_error_prob(q)))
        intervals.append(_QualInterval(q, q, int(n_obs), n_err, 0, fixed_qual=q))

    while len(intervals) > n_levels:
        best = None
        last_merge_order = 0
        for left, right in zip(intervals, intervals[1:]):
            merged = left.merge(right)
            last_merge_order = max(last_merge_order, left.merge_order, right.merge_order)
            if best is None or merged.penalty(min_interesting_qual) < best.penalty(min_interesting_qual):
                best = merged
        new_intervals = [iv for iv in intervals if iv not in best.subs]
        new_intervals.append(best)
        new_intervals.sort(key=lambda iv: iv.q_start)
        best.merge_order = last_merge_order + 1
        intervals = new_intervals

    mapping = [0] * len(n_observations_per_qual)
    for iv in intervals:
        for q in range(iv.q_start, iv.q_end + 1):
            mapping[q] = iv.qual()
    return mapping


class QuantizationInfo:
    def __init__(self, empirical_qual_counts, quantization_levels: int):
        self.empirical_qual_counts = list(empirical_qual_counts)
        self.quantization_levels = quantization_levels
        self.quantized_quals = quantize_quals(self.empirical_qual_counts, quantization_levels)

    @classmethod
    def from_qual_table(cls, qual_table_obs, qual_table_emp_q, quantization_levels: int):
        """qual_table_obs/emp_q: parallel arrays of (observations, empirical quality)."""
        hist = [0] * (MAX_SAM_QUAL_SCORE + 1)
        for obs, emp in zip(qual_table_obs, qual_table_emp_q):
            hist[java_round(emp)] += int(obs)
        return cls(hist, quantization_levels)

    def no_quantization(self):
        self.quantization_levels = MAX_SAM_QUAL_SCORE
        for i in range(self.quantization_levels):
            self.quantized_quals[i] = i

    def requantize(self, n_levels: int):
        self.quantization_levels = n_levels
        self.quantized_quals = quantize_quals(self.empirical_qual_counts, n_levels)

    def report_table(self) -> ReportTable:
        t = ReportTable("Quantized", "Quality quantization map",
                        [("QualityScore", "%d"), ("Count", "%d"), ("QuantizedScore", "%d")])
        for q in range(MAX_SAM_QUAL_SCORE + 1):
            t.add_row(q, self.empirical_qual_counts[q], self.quantized_quals[q])
        return t
