# Copied verbatim from gatk_tpu/calling/as_annotations.py; only import lines may differ.
"""Allele-specific (AS_*) reducible annotations: raw data -> combine -> finalize.

Reference behavior: tools/walkers/annotator/allelespecific/ — AS_RankSumTest.java
(CompressedDataList int raws in VCF mode :110, z-score singleton histograms in
GVCF mode via makeRawAnnotationString :133-148, Histogram combine :273-284,
median finalize :199-210), AS_RMSMappingQuality.java (sum of squared MQ raws,
finalize sqrt(rawMQ/depth)), AS_FisherStrand/AS_StrandOddsRatio (finalize from
the combined AS_SB_TABLE contingency rows, StrandBiasTest.java),
AS_QualByDepth.java (per-allele qual over informative depth), and
utils/Histogram.java (binSize 0.1, "%.1f" keys, median :101-133).

The three-phase reduce path:
  * HC emits raw per-allele data (`AS_RAW_*`, `AS_SB_TABLE`) — integer
    value,count lists per allele in VCF mode; per-alt rank-sum z singletons in
    GVCF mode (matching expected.testVCFMode.gatk4.alleleSpecific.vcf and
    expected.testGVCFMode.gatk4.alleleSpecific.g.vcf shapes).
  * CombineGVCFs merges raw sections across samples with allele remapping
    (combine_* functions).
  * GenotypeGVCFs finalizes raw -> AS_FS / AS_SOR / AS_MQ / AS_QD /
    AS_*RankSum (finalize_* functions).
"""
from __future__ import annotations

import math

RAW_DELIM = "|"
REDUCED_DELIM = ","

# the five raw keys the reduce path carries (plus AS_SB_TABLE handled alongside)
RAW_RANKSUM_KEYS = ("AS_RAW_BaseQRankSum", "AS_RAW_MQRankSum", "AS_RAW_ReadPosRankSum")
RAW_KEYS = RAW_RANKSUM_KEYS + ("AS_RAW_MQ", "AS_SB_TABLE")
FINAL_BY_RAW = {
    "AS_RAW_BaseQRankSum": "AS_BaseQRankSum",
    "AS_RAW_MQRankSum": "AS_MQRankSum",
    "AS_RAW_ReadPosRankSum": "AS_ReadPosRankSum",
    "AS_RAW_MQ": "AS_MQ",
}


# ---------------------------------------------------------------------------
# Histogram (utils/Histogram.java port: binSize 0.1, %.1f keys)
# ---------------------------------------------------------------------------

BIN_SIZE = 0.1


def _bin_key(value: float) -> int:
    # Java Math.round: floor(x + 0.5) (half-up), not banker's rounding
    return int(math.floor(value / BIN_SIZE + 0.5))


class ZHistogram:
    """GATK utils/Histogram.java: values binned at 0.1, printed "%.1f,count"."""

    def __init__(self):
        self.counts = {}  # int bin key -> count

    def add(self, value: float, count: int = 1):
        if value != value:  # NaN
            return
        k = _bin_key(value)
        self.counts[k] = self.counts.get(k, 0) + count

    def merge(self, other: "ZHistogram"):
        for k, c in other.counts.items():
            self.counts[k] = self.counts.get(k, 0) + c

    def is_empty(self) -> bool:
        return not self.counts

    def median(self):
        """Histogram.java:101-133 median over binned keys."""
        n = sum(self.counts.values())
        if n == 0:
            return None
        odd = n % 2 == 1
        median_index = (n + 1) // 2
        counter = 0
        first = None
        for k in sorted(self.counts):
            counter += self.counts[k]
            if counter > median_index:
                if first is None:
                    return k * BIN_SIZE
                return (first + k) / 2.0 * BIN_SIZE
            if counter == median_index:
                if odd:
                    return k * BIN_SIZE
                first = float(k)
        return None

    def to_string(self) -> str:
        if not self.counts:
            return "NaN"
        parts = []
        for k in sorted(self.counts):
            parts.append(f"{k * BIN_SIZE:.1f}")
            parts.append(str(self.counts[k]))
        return ",".join(parts)


def parse_histogram_sections(raw: str, n_alleles: int):
    """AS_RankSumTest.parseRawDataString: '|'-separated per-allele value,count
    lists -> list of ZHistogram (one per allele; missing sections empty)."""
    hists = [ZHistogram() for _ in range(n_alleles)]
    if not raw:
        return hists
    sections = raw.split(RAW_DELIM)
    for i, sec in enumerate(sections[:n_alleles]):
        toks = sec.split(",")
        for j in range(0, len(toks) - 1, 2):
            if not toks[j]:
                continue
            try:
                value = float(toks[j])
            except ValueError:
                continue
            if value != value:
                continue
            if toks[j + 1]:
                hists[i].add(value, int(toks[j + 1]))
    return hists


def format_histogram_sections(hists, combined: bool = False) -> str:
    """makeRawAnnotationString (combined=False: empty alt sections print as
    'NaN', the empty Histogram's toString) vs makeCombinedAnnotationString
    (combined=True: empty sections print as '')."""
    out = []
    for i, h in enumerate(hists):
        if i == 0:
            out.append("")
        elif combined and h.is_empty():
            out.append("")
        else:
            out.append(h.to_string())
    return RAW_DELIM.join(out)


# ---------------------------------------------------------------------------
# Integer value lists (CompressedDataList<Integer> — HC VCF-mode raws)
# ---------------------------------------------------------------------------

def format_int_lists(per_allele_values) -> str:
    """CompressedDataList.toString per allele (value,count ascending), all
    allele sections populated (ref first) as in the HC VCF-mode golden."""
    secs = []
    for vals in per_allele_values:
        counts = {}
        for v in vals:
            counts[int(v)] = counts.get(int(v), 0) + 1
        secs.append(",".join(f"{k},{c}" for k, c in sorted(counts.items())))
    return RAW_DELIM.join(secs)


# ---------------------------------------------------------------------------
# AS_RAW_MQ (AS_RMSMappingQuality.java: per-allele sum of squared MQ)
# ---------------------------------------------------------------------------

def format_raw_mq(sums) -> str:
    return RAW_DELIM.join(f"{s:.2f}" for s in sums)


def parse_raw_mq(raw: str, n_alleles: int):
    out = [0.0] * n_alleles
    if not raw:
        return out
    for i, sec in enumerate(raw.split(RAW_DELIM)[:n_alleles]):
        try:
            out[i] = float(sec)
        except ValueError:
            out[i] = 0.0
    return out


def finalize_mq(raw_sums, allele_depths) -> list:
    """AS_RMSMappingQuality.finalizeRawData: sqrt(rawMQ / depth) per alt."""
    out = []
    for s, d in zip(raw_sums[1:], allele_depths[1:]):
        out.append(f"{math.sqrt(s / d):.2f}" if d > 0 else "NaN")
    return out


# ---------------------------------------------------------------------------
# AS_SB_TABLE (fwd,rev per allele)
# ---------------------------------------------------------------------------

def parse_sb_table(raw: str, n_alleles: int):
    out = [[0, 0] for _ in range(n_alleles)]
    if not raw:
        return out
    for i, sec in enumerate(raw.split(RAW_DELIM)[:n_alleles]):
        toks = sec.split(",")
        if len(toks) >= 2:
            try:
                out[i] = [int(toks[0]), int(toks[1])]
            except ValueError:
                pass
    return out


def format_sb_table(rows) -> str:
    return RAW_DELIM.join(f"{f},{r}" for f, r in rows)


def finalize_fs_sor(sb_rows):
    """AS_FisherStrand + AS_StrandOddsRatio finalize: per alt, the 2x2 table
    (ref_fwd, ref_rev, alt_fwd, alt_rev)."""
    from ..gvcf.annotations import fisher_strand_phred, strand_odds_ratio

    fs, sor = [], []
    rf, rr = sb_rows[0]
    for f, r in sb_rows[1:]:
        fs.append(f"{fisher_strand_phred(rf, rr, f, r):.3f}")
        sor.append(f"{strand_odds_ratio(rf, rr, f, r):.3f}")
    return fs, sor


# ---------------------------------------------------------------------------
# Rank-sum finalize
# ---------------------------------------------------------------------------

def finalize_ranksum(hists) -> list:
    """AS_RankSumTest.finalizeRawData: median of the combined per-alt z
    histogram, '%.3f', '.' when empty."""
    out = []
    for h in hists[1:]:
        m = h.median()
        out.append(f"{m:.3f}" if m is not None else ".")
    return out


# ---------------------------------------------------------------------------
# Combine (CombineGVCFs / ReferenceConfidenceVariantContextMerger path)
# ---------------------------------------------------------------------------

def combine_raw_fields(sample_infos, sample_allele_lists, merged_alleles):
    """Combine per-sample raw AS fields into merged-allele raw strings.

    sample_infos: list of per-sample INFO dicts (may lack AS keys).
    sample_allele_lists: per sample, the allele strings [ref, alt1, ...] in the
    sample's original section order, already REMAPPED to merged allele strings.
    merged_alleles: [ref, alt..., <NON_REF>] allele strings of the merged record.
    Returns dict of combined raw INFO entries (only keys present somewhere).
    """
    idx = {a: i for i, a in enumerate(merged_alleles)}
    n = len(merged_alleles)
    out = {}
    # rank-sum histograms
    for key in RAW_RANKSUM_KEYS:
        combined = [ZHistogram() for _ in range(n)]
        any_present = False
        for info, alleles in zip(sample_infos, sample_allele_lists):
            if info is None or key not in info:
                continue
            any_present = True
            hists = parse_histogram_sections(info[key], len(alleles))
            for a, h in zip(alleles, hists):
                if a in idx:
                    combined[idx[a]].merge(h)
        if any_present:
            out[key] = format_histogram_sections(combined, combined=True)
    # AS_RAW_MQ sums
    sums = [0.0] * n
    any_mq = False
    for info, alleles in zip(sample_infos, sample_allele_lists):
        if info is None or "AS_RAW_MQ" not in info:
            continue
        any_mq = True
        vals = parse_raw_mq(info["AS_RAW_MQ"], len(alleles))
        for a, v in zip(alleles, vals):
            if a in idx:
                sums[idx[a]] += v
    if any_mq:
        out["AS_RAW_MQ"] = format_raw_mq(sums)
    # AS_SB_TABLE sums
    rows = [[0, 0] for _ in range(n)]
    any_sb = False
    for info, alleles in zip(sample_infos, sample_allele_lists):
        if info is None or "AS_SB_TABLE" not in info:
            continue
        any_sb = True
        t = parse_sb_table(info["AS_SB_TABLE"], len(alleles))
        for a, (f, r) in zip(alleles, t):
            if a in idx:
                rows[idx[a]][0] += f
                rows[idx[a]][1] += r
    if any_sb:
        out["AS_SB_TABLE"] = format_sb_table(rows)
    return out


def subset_raw_fields(info, old_alleles, new_alleles):
    """Re-section raw AS strings when GenotypeGVCFs subsets alleles (drops
    NON_REF / uncalled alts)."""
    idx = {a: i for i, a in enumerate(old_alleles)}
    out = {}
    for key in RAW_RANKSUM_KEYS:
        if key not in info:
            continue
        hists = parse_histogram_sections(info[key], len(old_alleles))
        out[key] = format_histogram_sections(
            [hists[idx[a]] if a in idx else ZHistogram() for a in new_alleles],
            combined=True)
    if "AS_RAW_MQ" in info:
        vals = parse_raw_mq(info["AS_RAW_MQ"], len(old_alleles))
        out["AS_RAW_MQ"] = format_raw_mq(
            [vals[idx[a]] if a in idx else 0.0 for a in new_alleles])
    if "AS_SB_TABLE" in info:
        rows = parse_sb_table(info["AS_SB_TABLE"], len(old_alleles))
        out["AS_SB_TABLE"] = format_sb_table(
            [rows[idx[a]] if a in idx else [0, 0] for a in new_alleles])
    return out


def finalize_all(info, alleles, allele_depths, per_allele_qual=None):
    """GenotypeGVCFs finalize: raw AS_ INFO -> finalized AS_ INFO entries.

    alleles: the FINAL allele strings [ref, alts...] (no NON_REF);
    allele_depths: summed AD per final allele; per_allele_qual: optional list
    of per-alt quals (AS_QualByDepth's AS_QUAL).
    Returns dict of finalized entries (raw keys NOT included).
    """
    n = len(alleles)
    out = {}
    for key in RAW_RANKSUM_KEYS:
        if key in info:
            vals = finalize_ranksum(parse_histogram_sections(info[key], n))
            # an all-missing list is still emitted (".,." in the golden)
            out[FINAL_BY_RAW[key]] = REDUCED_DELIM.join(vals)
    if "AS_RAW_MQ" in info:
        out["AS_MQ"] = REDUCED_DELIM.join(
            finalize_mq(parse_raw_mq(info["AS_RAW_MQ"], n), allele_depths))
    if "AS_SB_TABLE" in info:
        fs, sor = finalize_fs_sor(parse_sb_table(info["AS_SB_TABLE"], n))
        out["AS_FS"] = REDUCED_DELIM.join(fs)
        out["AS_SOR"] = REDUCED_DELIM.join(sor)
    if per_allele_qual is not None:
        qd = []
        for q, d in zip(per_allele_qual, allele_depths[1:]):
            qd.append(f"{min(q / d, 35.0):.2f}" if d > 0 and q is not None else ".")
        if any(v != "." for v in qd):
            out["AS_QD"] = REDUCED_DELIM.join(qd)
    return out
