# Copied verbatim from gatk_tpu/utils/dragstr.py; only import lines may differ.
"""DRAGstr: STR reference analysis, parameter tables, and model calibration.

Reference behavior: utils/dragstr/DragstrParams.java (DEFAULT GOP/API/GCP
tables :49-115), DragstrParamUtils.java (text format :96-160),
DragstrReferenceAnalyzer.java (per-position best (period, repeats) STR
detection), tools/dragstr/STRDecimationTable.java (DEFAULT_DECIMATION_MATRIX
:69-78, keep-1-in-2^bit sampling), DragstrParametersEstimator.java (grid
maximum-likelihood over (API, GP) with het/hom mixture and per-length error
probabilities :120-231), DragstrParamsBuilder.java (GOP from GP/GCP matching
:37-72), CalibrateDragstrModel.java (case collection :747-781, minimum-case
gates :294-308).

TPU-first note: the estimator's (API x GP x cases) likelihood grid is evaluated
as one dense vectorized computation per repeat-length group.
"""
from __future__ import annotations

import math
import zipfile
from dataclasses import dataclass, field

import numpy as np

MAX_PERIOD = 8
MAX_REPEATS = 20

DEFAULT_GOP = np.array([
    [45.00, 45.00, 45.00, 45.00, 45.00, 45.00, 40.50, 33.50, 28.00, 24.00, 21.75, 21.75, 21.75, 21.75, 21.75, 21.75, 21.75, 21.75, 21.75, 21.75],
    [39.50, 39.50, 39.50, 39.50, 36.00, 30.00, 27.25, 25.00, 24.25, 24.75, 26.25, 26.25, 26.25, 26.25, 26.25, 26.25, 26.25, 26.25, 26.25, 26.75],
    [38.50, 41.00, 41.00, 41.00, 41.00, 37.50, 35.25, 34.75, 34.75, 33.25, 33.25, 33.25, 32.50, 30.75, 28.50, 29.00, 29.00, 29.00, 29.00, 29.00],
    [37.50, 39.00, 39.00, 37.75, 34.00, 34.00, 30.25, 30.25, 30.25, 30.25, 30.25, 30.25, 30.25, 30.25, 30.25, 31.75, 31.75, 31.75, 31.75, 31.75],
    [37.00, 40.00, 40.00, 40.00, 36.00, 35.00, 24.50, 24.50, 24.50, 24.50, 22.50, 22.50, 22.50, 23.50, 23.50, 23.50, 23.50, 23.50, 23.50, 23.50],
    [36.25, 40.00, 40.00, 40.00, 40.00, 40.00, 40.00, 40.00, 40.00, 40.00, 40.00, 40.00, 40.00, 40.00, 40.00, 40.00, 40.00, 40.00, 40.00, 40.00],
    [36.00, 40.50, 40.50, 40.50, 20.75, 20.75, 20.75, 20.75, 20.75, 20.75, 20.75, 20.75, 20.75, 20.75, 20.75, 20.75, 20.75, 20.75, 20.75, 20.75],
    [36.25, 39.75, 32.75, 32.75, 32.75, 32.75, 32.75, 32.75, 32.75, 32.75, 32.75, 32.75, 32.75, 32.75, 32.75, 32.75, 32.75, 32.75, 32.75, 32.75]])

DEFAULT_API = np.array([
    [39.00, 39.00, 37.00, 35.00, 32.00, 26.00, 20.00, 16.00, 12.00, 10.00, 8.00, 7.00, 7.00, 6.00, 6.00, 5.00, 5.00, 4.00, 4.00, 4.00],
    [30.00, 30.00, 29.00, 22.00, 17.00, 14.00, 11.00, 8.00, 6.00, 5.00, 4.00, 4.00, 3.00, 3.00, 3.00, 3.00, 3.00, 3.00, 2.00, 2.00],
    [27.00, 27.00, 25.00, 18.00, 14.00, 12.00, 9.00, 7.00, 5.00, 4.00, 3.00, 3.00, 3.00, 3.00, 2.00, 2.00, 2.00, 2.00, 2.00, 2.00],
    [27.00, 27.00, 18.00, 9.00, 9.00, 9.00, 9.00, 3.00, 3.00, 3.00, 3.00, 3.00, 2.00, 2.00, 2.00, 2.00, 2.00, 2.00, 2.00, 2.00],
    [29.00, 29.00, 18.00, 8.00, 8.00, 8.00, 4.00, 3.00, 3.00, 3.00, 2.00, 2.00, 2.00, 2.00, 2.00, 2.00, 2.00, 2.00, 2.00, 2.00],
    [25.00, 25.00, 10.00, 10.00, 10.00, 4.00, 3.00, 3.00, 3.00, 3.00, 3.00, 3.00, 3.00, 3.00, 3.00, 3.00, 3.00, 3.00, 3.00, 3.00],
    [21.00, 21.00, 11.00, 11.00, 5.00, 5.00, 5.00, 5.00, 5.00, 5.00, 5.00, 5.00, 5.00, 5.00, 5.00, 5.00, 5.00, 5.00, 5.00, 5.00],
    [18.00, 18.00, 10.00, 6.00, 4.00, 4.00, 4.00, 4.00, 4.00, 4.00, 4.00, 4.00, 4.00, 4.00, 4.00, 4.00, 4.00, 4.00, 4.00, 4.00]])

DEFAULT_GCP = np.array([[round(1000.0 / p) / 100.0] * MAX_REPEATS
                        for p in range(1, MAX_PERIOD + 1)])

# STRDecimationTable.DEFAULT_DECIMATION_MATRIX (keep 1 in 2^bit)
DEFAULT_DECIMATION = [
    [0],
    [0, 10, 10, 9, 8, 7, 5, 3, 1, 0],
    [0, 0, 9, 6, 3, 0],
    [0, 0, 8, 4, 1, 0],
    [0, 0, 6, 0],
    [0, 0, 5, 0],
    [0, 0, 4, 0],
    [0, 0, 1, 0],
    [0]]

# CalibrateDragstrModel.MINIMUM_CASES_BY_PERIOD_AND_LENGTH
MINIMUM_CASES = [
    [],
    [0, 200, 200, 200, 200, 200, 200, 200, 200, 200, 0],
    [0, 0, 200, 200, 200, 200, 0, 0, 0, 0, 0],
    [0, 0, 200, 200, 200, 0, 0, 0, 0, 0, 0],
    [0, 0, 200, 200, 0, 0, 0, 0, 0, 0, 0],
    [0, 0, 200, 0, 0, 0, 0, 0, 0, 0, 0],
    [0, 0, 200, 0, 0, 0, 0, 0, 0, 0, 0],
    [0, 0, 200, 0, 0, 0, 0, 0, 0, 0, 0],
    [0, 0, 200, 0, 0, 0, 0, 0, 0, 0, 0]]


@dataclass
class DragstrParams:
    gop: np.ndarray = field(default_factory=lambda: DEFAULT_GOP.copy())
    gcp: np.ndarray = field(default_factory=lambda: DEFAULT_GCP.copy())
    api: np.ndarray = field(default_factory=lambda: DEFAULT_API.copy())

    def write(self, path: str, annotations=()):
        """DragstrParamUtils.print format (golden-compatible)."""
        with open(path, "w") as fh:
            fh.write("#" * 92 + "\n")
            fh.write("# DragstrParams\n")
            fh.write("# -------------------------\n")
            for name, value in annotations:
                fh.write(f"# {name} = {value}\n")
            fh.write("#" * 92 + "\n")
            fh.write("  ".join(f"{r:>5d}" for r in range(1, MAX_REPEATS + 1)) + "\n")
            for label, table in (("GOP", self.gop), ("GCP", self.gcp), ("API", self.api)):
                fh.write(f"{label}:\n")
                for row in table:
                    fh.write("  ".join(f"{v:5.2f}" for v in row) + "\n")

    @staticmethod
    def read(path: str) -> "DragstrParams":
        tables = {}
        current = None
        rows = []
        with open(path) as fh:
            for ln in fh:
                ln = ln.rstrip("\n")
                if ln.startswith("#") or not ln.strip():
                    continue
                if ln.rstrip().endswith(":"):
                    if current:
                        tables[current] = np.array(rows)
                    current = ln.strip()[:-1]
                    rows = []
                    continue
                vals = ln.split()
                if current is None:
                    continue  # repeat-length header row
                rows.append([float(x) for x in vals])
        if current:
            tables[current] = np.array(rows)
        return DragstrParams(gop=tables["GOP"], gcp=tables["GCP"], api=tables["API"])


# ---------------------------------------------------------------------------
# STR reference analysis (DragstrReferenceAnalyzer)
# ---------------------------------------------------------------------------

def analyze_strs(bases: np.ndarray, max_period=MAX_PERIOD):
    """Per-position best (period, repeats): the (period, repeats) maximizing the
    number of consecutive unit copies starting at each position (smaller period
    wins ties). Vectorized over the sequence."""
    bases = np.asarray(bases, np.uint8)
    n = len(bases)
    best_period = np.ones(n, np.int32)
    best_repeats = np.zeros(n, np.int32)

    for p in range(1, max_period + 1):
        if n < 2 * p:
            break
        eq = np.zeros(n, bool)
        eq[: n - p] = bases[: n - p] == bases[p:]
        # run length of consecutive eq-True starting at i
        run = np.zeros(n + 1, np.int64)
        for i in range(n - 1, -1, -1):
            run[i] = run[i + 1] + 1 if eq[i] else 0
        repeats = 1 + run[:n] // p
        better = repeats > best_repeats
        best_repeats[better] = repeats[better]
        best_period[better] = p
    return best_period, best_repeats


def find_str_loci(bases: np.ndarray, max_period=MAX_PERIOD, max_repeats=MAX_REPEATS):
    """Maximal STR loci [(start0, period, repeats, end0_exclusive)] over a contig."""
    periods, repeats = analyze_strs(bases, max_period)
    n = len(bases)
    loci = []
    covered_until = {}
    for i in range(n):
        p = int(periods[i])
        r = int(repeats[i])
        end = i + p * r
        # skip suffixes of an already-emitted run with the same period
        if covered_until.get(p, -1) >= end and r > 1:
            continue
        loci.append((i, p, min(r, max_repeats), end))
        covered_until[p] = max(covered_until.get(p, -1), end)
    return loci


def decimate_loci(loci, decimation=DEFAULT_DECIMATION):
    """Keep 1 in 2^bit loci per (period, repeat) (STRDecimationTable masks)."""
    counters = {}
    out = []
    for locus in loci:
        _i, p, r, _end = locus
        row = decimation[p] if p < len(decimation) else [0]
        bit = row[r] if r < len(row) else 0
        mask = (1 << bit) - 1
        key = (p, min(r, MAX_REPEATS))
        c = counters.get(key, 0)
        counters[key] = c + 1
        if (c & mask) == 0:
            out.append(locus)
    return out


# ---------------------------------------------------------------------------
# STR table file (ComposeSTRTableFile output; zip of TSV + metadata)
# ---------------------------------------------------------------------------

def write_str_table(path: str, loci_by_contig: dict):
    """loci_by_contig: {contig: [(start0, period, repeats, end0)]}"""
    lines = ["#contig\tstart\tend\tperiod\trepeats"]
    for contig, loci in loci_by_contig.items():
        for (start0, p, r, end0) in loci:
            lines.append(f"{contig}\t{start0 + 1}\t{end0}\t{p}\t{r}")
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("str_table.tsv", "\n".join(lines) + "\n")


def read_str_table(path: str) -> dict:
    out = {}
    with zipfile.ZipFile(path) as z:
        text = z.read("str_table.tsv").decode()
    for ln in text.splitlines():
        if ln.startswith("#") or not ln.strip():
            continue
        contig, start1, end1, p, r = ln.split("\t")
        out.setdefault(contig, []).append((int(start1) - 1, int(p), int(r), int(end1)))
    return out


# ---------------------------------------------------------------------------
# parameter estimation (DragstrParametersEstimator)
# ---------------------------------------------------------------------------

def _log10_one_minus_pow10(x):
    return np.log10(-np.expm1(x * math.log(10.0)))


def estimate_params(cases_by_stratum, max_period=MAX_PERIOD, max_repeats=MAX_REPEATS,
                    phred_gp=np.arange(10.0, 50.0 + 1e-9, 1.0),
                    phred_api=np.arange(0.0, 40.0 + 1e-9, 1.0),
                    phred_gop=np.arange(10.0, 50.0 + 1e-9, 0.25),
                    het_to_hom=2.0, min_loci=50, api_mono_thresh=3.0) -> DragstrParams:
    """cases_by_stratum: {(period, repeats): [(n_depth, k_indels), ...]}."""
    log10_gp = -0.1 * phred_gp
    log10_api = -0.1 * phred_api
    log10_half = math.log10(0.5)
    log10_het_over_hom = math.log10(het_to_hom)
    max_log10_p_het = log10_het_over_hom - math.log10(1 + het_to_hom)

    builder_gp = np.zeros((max_period, max_repeats))
    builder_api = np.zeros((max_period, max_repeats))
    builder_gcp = np.array([[10.0 / p] * max_repeats for p in range(1, max_period + 1)])

    # per-gp per-length error probabilities
    log10_p_correct_pos = _log10_one_minus_pow10(log10_half + log10_gp)  # (G,)
    # het/hom mixture pieces per api
    log10_p_het = np.minimum(log10_api, max_log10_p_het)
    log10_p_hom = log10_p_het - log10_het_over_hom
    both = np.log10(10.0 ** log10_p_het + 10.0 ** log10_p_hom)
    log10_p_homref = _log10_one_minus_pow10(both)

    def min_gp_index(period):
        gp_min = math.ceil(-10 * math.log10(1 - 0.5 ** ((1.0 / (max_repeats * period)) / 2.0)))
        idx = np.searchsorted(phred_gp, gp_min)
        return min(idx, len(phred_gp) - 1)

    def group_loglik(period, repeat_range, cases):
        """(A, G) log10 likelihood over the api x gp grid for the case set."""
        A, G = len(phred_api), len(phred_gp)
        total = np.zeros((A, G))
        for r in range(repeat_range[0], repeat_range[1] + 1):
            rc = cases.get((period, r), [])
            if not rc:
                continue
            length = r * period
            l10_correct = length * log10_p_correct_pos  # (G,)
            l10_error = _log10_one_minus_pow10(l10_correct)
            nk = np.array(rc, float)  # (C, 2): n, k
            n_arr, k_arr = nk[:, 0], nk[:, 1]
            # hom-ref component: k errors, n-k correct  -> (C, G)
            homref = (k_arr[:, None] * l10_error[None, :]
                      + (n_arr - k_arr)[:, None] * l10_correct[None, :])
            het = n_arr * log10_half  # (C,)
            hom_ok = (n_arr == k_arr)
            # log10 sum over mixture components: (A, G, C)
            x1 = log10_p_homref[:, None, None] + homref.T[None, :, :]
            x2 = (log10_p_het[:, None] + het[None, :])[:, None, :] * np.ones((1, G, 1))
            m = np.maximum(x1, x2)
            s = 10.0 ** (x1 - m) + 10.0 ** (x2 - m)
            if hom_ok.any():
                x3 = np.where(hom_ok[None, None, :],
                              (log10_p_hom[:, None] + het[None, :])[:, None, :], -np.inf)
                s = s + np.where(np.isneginf(x3), 0.0, 10.0 ** (x3 - m))
            total += (m + np.log10(s)).sum(axis=2)
        return total

    for period in range(1, max_period + 1):
        # flanks with too little data get grouped
        sizes = [len(cases_by_stratum.get((period, r), [])) for r in range(0, max_repeats + 1)]
        accum = 0
        left = 0
        while left < max_repeats:
            left += 1
            accum += sizes[left]
            if accum >= min_loci:
                break
        accum = 0
        right = max_repeats
        while right > 1:
            right -= 1
            accum += sizes[right]
            if accum >= min_loci:
                break
        pending = []
        if right >= left:
            pending.append((1, left))
            for r in range(left + 1, right + 1):
                pending.append((r, r))
            pending.append((right + 1, max_repeats))
        else:
            pending.append((1, max_repeats))

        min_gp_i = min_gp_index(period)
        done = []
        while pending:
            rng = pending.pop(0)
            ll = group_loglik(period, rng, cases_by_stratum)
            ll[:, :min_gp_i] = -np.inf
            ai, gi = np.unravel_index(np.argmax(ll), ll.shape)
            gp_val, api_val = phred_gp[gi], phred_api[ai]
            if done:
                prev_rng = done[-1]
                prev_gp = builder_gp[period - 1][prev_rng[1] - 1]
                prev_api = builder_api[period - 1][prev_rng[1] - 1]
                if not (prev_gp >= gp_val and prev_api + api_mono_thresh >= api_val):
                    done.pop()
                    pending.insert(0, (prev_rng[0], rng[1]))
                    continue
            for r in range(rng[0], rng[1] + 1):
                builder_gp[period - 1][r - 1] = gp_val
                builder_api[period - 1][r - 1] = api_val
            done.append(rng)

    # GOP from GP/GCP matching (DragstrParamsBuilder.gopCalculation)
    gop = np.zeros_like(builder_gp)
    for i in range(max_period):
        period = i + 1
        c = 10.0 ** (-0.1 * builder_gcp[i, 0])
        gops = np.arange(0.0, 50.0 + 1e-9, 0.25)
        g = 10.0 ** (-0.1 * gops)
        pr_gap = g * c ** (period - 1) * (1.0 - c)
        pr_no_gap = (1 - 2 * g) ** (period + 1)
        ratio = pr_gap / pr_no_gap
        for j in range(max_repeats):
            target = 10.0 ** (-0.1 * builder_gp[i, j])
            best = gops[np.argmin(np.abs(ratio - target))]
            gop[i, j] = max(10.0, best)
    return DragstrParams(gop=gop, gcp=builder_gcp, api=builder_api)


def enough_cases(cases_by_stratum, max_period=MAX_PERIOD) -> bool:
    """CalibrateDragstrModel minimum-case gate."""
    for period in range(1, min(max_period, len(MINIMUM_CASES) - 1) + 1):
        row = MINIMUM_CASES[period]
        for r in range(1, len(row) - 1):
            if row[r] and len(cases_by_stratum.get((period, r), [])) < row[r]:
                return False
    return True


def collect_case(reads, contig_length, start0, end0, padding=5):
    """(n, k, minMQ, nSup) for one locus (CalibrateDragstrModel collect :747-781).
    start0/end0: 0-based half-open STR span."""
    str_start = start0 + 1  # 1-based inclusive
    str_end = end0
    padded_start = max(1, str_start - padding)
    padded_end = min(contig_length, str_end + padding)
    n = k = n_sup = 0
    min_mq = 255
    from ..io import sam

    for read in reads:
        read_start = read.pos + 1
        read_end = read.end
        if not (read_start <= padded_start and read_end >= padded_end):
            continue
        if read.is_supplementary:
            n_sup += 1
        min_mq = min(min_mq, read.mapq)
        ref_pos = read_start
        for op, ln in zip(read.cigar_ops, read.cigar_lens):
            op = int(op)
            ln = int(ln)
            if op == sam.OP_I and str_start <= ref_pos <= str_end + 1:
                k += 1
            elif op == sam.OP_D and ref_pos + ln - 1 >= str_start and ref_pos <= str_end:
                k += 1
            if op in (sam.OP_M, sam.OP_D, sam.OP_N, sam.OP_EQ, sam.OP_X):
                ref_pos += ln
            if ref_pos > str_end + 1:
                break
        n += 1
    return n, k, min_mq if min_mq != 255 else 0, n_sup
