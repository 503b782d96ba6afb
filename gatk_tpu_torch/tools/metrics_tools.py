# Copied verbatim from gatk_tpu/tools/metrics_tools.py; only import lines may differ.
"""Picard-style QC metrics tools.

Reference parity: metrics/InsertSizeMetricsCollector.java (+ picard
CollectInsertSizeMetrics semantics: first-of-pair records, histogram-derived
median/MAD/width statistics with DEVIATIONS trimming for mean/sd),
picard MeanQualityByCycle (per-cycle mean with second-of-pair cycles appended
after the longest first read, reverse-strand cycle flip), picard
QualityScoreDistribution (base-quality histogram incl. OQ tag counts).
Output files follow the htsjdk MetricsFile text format.
"""
from __future__ import annotations

import argparse
import math

import numpy as np

from ..cli import register_tool
from ..engine import walkers
from ..io import sam


def _fmt(v) -> str:
    """htsjdk FormatUtil double formatting: up to 6 decimals, trailing zeros trimmed."""
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    if v is None:
        return ""
    s = f"{float(v):.6f}".rstrip("0").rstrip(".")
    return s if s not in ("-0", "") else "0"


def write_metrics_file(path, tool_name, metrics_class, columns, rows,
                       histogram=None, hist_bin_type="java.lang.Integer"):
    """histogram: (bin_label, [value_labels], {bin: [values]}) or None."""
    with open(path, "w") as fh:
        fh.write("## htsjdk.samtools.metrics.StringHeader\n")
        fh.write(f"# {tool_name}\n")
        fh.write("## htsjdk.samtools.metrics.StringHeader\n")
        fh.write("# Started on: gatk_tpu\n")
        fh.write("\n")
        if columns:
            fh.write(f"## METRICS CLASS\t{metrics_class}\n")
            fh.write("\t".join(columns) + "\n")
            for r in rows:
                fh.write("\t".join(_fmt(x) if not isinstance(x, str) else x for x in r) + "\n")
            fh.write("\n")
        if histogram is not None:
            bin_label, value_labels, values = histogram
            fh.write(f"## HISTOGRAM\t{hist_bin_type}\n")
            fh.write(bin_label + "\t" + "\t".join(value_labels) + "\n")
            for b in sorted(values):
                fh.write(str(b) + "\t" + "\t".join(_fmt(x) for x in values[b]) + "\n")
        fh.write("\n")


# ---------------------------------------------------------------------------
# CollectInsertSizeMetrics
# ---------------------------------------------------------------------------

def insert_size_statistics(hist: dict, deviations=10.0):
    """Picard InsertSizeMetrics computation from an insert-size histogram."""
    sizes = np.array(sorted(hist))
    counts = np.array([hist[s] for s in sizes], float)
    total = counts.sum()
    cum = np.cumsum(counts)

    def percentile_value(q):
        # htsjdk Histogram.getPercentile-ish: first bin reaching q of total
        target = q * total
        return float(sizes[np.searchsorted(cum, target, side="left")])

    median = percentile_value(0.5)
    # MAD: median of |x - median|
    dev_hist = {}
    for s, c in hist.items():
        d = abs(s - median)
        dev_hist[d] = dev_hist.get(d, 0) + c
    dsizes = np.array(sorted(dev_hist))
    dcounts = np.array([dev_hist[d] for d in dsizes], float)
    dcum = np.cumsum(dcounts)
    mad = float(dsizes[np.searchsorted(dcum, 0.5 * total, side="left")])

    # mean/sd over the histogram trimmed to median +/- deviations*MAD
    lo, hi = median - deviations * mad, median + deviations * mad
    mask = (sizes >= lo) & (sizes <= hi)
    tw = counts[mask].sum()
    mean = float((sizes[mask] * counts[mask]).sum() / tw)
    var = float(((sizes[mask] - mean) ** 2 * counts[mask]).sum() / max(tw - 1, 1))
    sd = math.sqrt(var)

    # symmetric widths around the median bin
    widths = {}
    med_i = int(median)
    for pct in (10, 20, 30, 40, 50, 60, 70, 80, 90, 99):
        target = total * pct / 100.0
        k = 0
        while True:
            covered = sum(hist.get(med_i + d, 0) for d in range(-k, k + 1))
            if covered >= target:
                widths[pct] = 2 * k + 1
                break
            k += 1
            if k > int(sizes[-1] - sizes[0]) + 1:
                widths[pct] = 2 * k + 1
                break
    return dict(median=median, mad=mad, min=int(sizes[0]), max=int(sizes[-1]),
                mean=mean, sd=sd, pairs=int(total), widths=widths)


class _InsertSizeWalker(walkers.ReadWalker):
    """CollectInsertSizeMetrics traversal as a ReadWalker (picard
    InsertSizeMetricsCollector over first-of-pair proper records)."""

    tool_name = "CollectInsertSizeMetrics"
    default_read_filters = ()
    include_duplicates = False

    def on_traversal_start(self):
        self.hists = {}  # orientation -> {size: count}

    def apply(self, r, ref_context):
        if (not r.is_paired or r.is_unmapped or r.mate_is_unmapped
                or not r.is_first_of_pair or r.is_secondary or r.is_supplementary
                or (r.is_duplicate and not self.include_duplicates) or r.tlen == 0):
            return
        mate_reverse = bool(r.flag & sam.MATE_REVERSE)
        if r.is_reverse == mate_reverse:
            orient = "TANDEM"
        else:
            leftmost_forward = (not r.is_reverse) if r.tlen > 0 else (not mate_reverse)
            orient = "FR" if leftmost_forward else "RF"
        self.hists.setdefault(orient, {})
        size = abs(r.tlen)
        self.hists[orient][size] = self.hists[orient].get(size, 0) + 1


@register_tool("CollectInsertSizeMetrics")
def collect_insert_size_metrics(argv):
    """Insert size distribution metrics (median/MAD/mean/width percentiles)."""
    from ..io import bam as bamio

    p = argparse.ArgumentParser(description="CollectInsertSizeMetrics")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("-H", "--histogram-plot-file", default=None)
    p.add_argument("--deviations", type=float, default=10.0)
    p.add_argument("--include-duplicates", action="store_true")
    p.add_argument("--minimum-pct", type=float, default=0.05)
    args = p.parse_args(argv)

    walker = _InsertSizeWalker(reads_path=args.input)
    walker.include_duplicates = args.include_duplicates
    walker.run()
    hists = walker.hists

    total = sum(sum(h.values()) for h in hists.values())
    orients = [o for o, h in hists.items()
               if sum(h.values()) > total * args.minimum_pct]

    columns = ["MEDIAN_INSERT_SIZE", "MEDIAN_ABSOLUTE_DEVIATION", "MIN_INSERT_SIZE",
               "MAX_INSERT_SIZE", "MEAN_INSERT_SIZE", "STANDARD_DEVIATION", "READ_PAIRS",
               "PAIR_ORIENTATION"] + [f"WIDTH_OF_{p}_PERCENT" for p in
                                      (10, 20, 30, 40, 50, 60, 70, 80, 90, 99)] + \
              ["SAMPLE", "LIBRARY", "READ_GROUP"]
    rows = []
    hist_values = {}
    labels = []
    for orient in sorted(orients, key=lambda o: ("FR", "RF", "TANDEM").index(o)):
        st = insert_size_statistics(hists[orient], args.deviations)
        rows.append([int(st["median"]), int(st["mad"]), st["min"], st["max"],
                     st["mean"], st["sd"], st["pairs"], orient] +
                    [st["widths"][p] for p in (10, 20, 30, 40, 50, 60, 70, 80, 90, 99)] +
                    ["", "", ""])
        labels.append(f"All_Reads.{orient.lower()}_count")
        for s, c in hists[orient].items():
            hist_values.setdefault(s, [0] * len(orients))
            hist_values[s][len(labels) - 1] = c

    write_metrics_file(args.output, "CollectInsertSizeMetrics (gatk_tpu)",
                       "picard.analysis.InsertSizeMetrics", columns, rows,
                       ("insert_size", labels, hist_values))
    print(f"wrote insert size metrics ({sum(len(h) for h in hists.values())} bins)")
    return 0


# ---------------------------------------------------------------------------
# MeanQualityByCycle
# ---------------------------------------------------------------------------

@register_tool("MeanQualityByCycle")
def mean_quality_by_cycle(argv):
    """Mean base quality per sequencing cycle (second-of-pair cycles appended)."""
    from ..io import bam as bamio

    p = argparse.ArgumentParser(description="MeanQualityByCycle")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("--chart", "--chart-output", default=None)
    p.add_argument("--aligned-reads-only", default="false")
    p.add_argument("--pf-reads-only", default="false")
    args = p.parse_args(argv)
    aligned_only = str(args.aligned_reads_only).lower() == "true"
    pf_only = str(args.pf_reads_only).lower() == "true"

    max_len = 512
    first_tot = np.zeros(max_len + 1)
    first_cnt = np.zeros(max_len + 1, np.int64)
    second_tot = np.zeros(max_len + 1)
    second_cnt = np.zeros(max_len + 1, np.int64)
    max_first = max_second = 0

    for r in bamio.BamReader(args.input):
        if pf_only and r.fails_vendor_quality:
            continue
        if aligned_only and r.is_unmapped:
            continue
        if r.is_secondary or r.is_supplementary:
            continue
        quals = r.quals.astype(np.float64)
        n = len(quals)
        if r.is_reverse:
            quals = quals[::-1]
        cyc = np.arange(1, n + 1)
        if r.is_paired and (r.flag & sam.SECOND_OF_PAIR):
            np.add.at(second_tot, cyc, quals)
            np.add.at(second_cnt, cyc, 1)
            max_second = max(max_second, n)
        else:
            np.add.at(first_tot, cyc, quals)
            np.add.at(first_cnt, cyc, 1)
            max_first = max(max_first, n)

    values = {}
    for c in range(1, max_first + 1):
        if first_cnt[c]:
            values[c] = [first_tot[c] / first_cnt[c]]
    for c in range(1, max_second + 1):
        if second_cnt[c]:
            values[max_first + c] = [second_tot[c] / second_cnt[c]]

    write_metrics_file(args.output, "MeanQualityByCycle (gatk_tpu)", None, None, None,
                       ("CYCLE", ["MEAN_QUALITY"], values))
    print(f"wrote mean quality for {len(values)} cycles")
    return 0


# ---------------------------------------------------------------------------
# QualityScoreDistribution
# ---------------------------------------------------------------------------

@register_tool("QualityScoreDistribution")
def quality_score_distribution(argv):
    """Distribution of base qualities (and OQ original qualities if present)."""
    from ..io import bam as bamio

    p = argparse.ArgumentParser(description="QualityScoreDistribution")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("--chart", "--chart-output", default=None)
    p.add_argument("--aligned-reads-only", default="false")
    p.add_argument("--pf-reads-only", default="false")
    p.add_argument("--include-no-calls", action="store_true")
    args = p.parse_args(argv)
    aligned_only = str(args.aligned_reads_only).lower() == "true"
    pf_only = str(args.pf_reads_only).lower() == "true"

    q_counts = np.zeros(128, np.int64)
    oq_counts = np.zeros(128, np.int64)
    saw_oq = False
    for r in bamio.BamReader(args.input):
        if pf_only and r.fails_vendor_quality:
            continue
        if aligned_only and r.is_unmapped:
            continue
        if r.is_secondary or r.is_supplementary:
            continue
        keep = np.ones(len(r.bases), bool) if args.include_no_calls else (r.bases != ord("N"))
        np.add.at(q_counts, r.quals[keep].astype(int), 1)
        oq = r.tags.get("OQ")
        if oq is not None:
            saw_oq = True
            oq_arr = np.frombuffer(oq.encode(), np.uint8).astype(int) - 33
            np.add.at(oq_counts, oq_arr[keep[: len(oq_arr)]], 1)

    labels = ["COUNT_OF_Q"] + (["COUNT_OF_OQ"] if saw_oq else [])
    values = {}
    for q in range(128):
        if q_counts[q] or (saw_oq and oq_counts[q]):
            values[q] = [int(q_counts[q])] + ([int(oq_counts[q])] if saw_oq else [])

    write_metrics_file(args.output, "QualityScoreDistribution (gatk_tpu)", None, None,
                       None, ("QUALITY", labels, values), hist_bin_type="java.lang.Byte")
    print(f"wrote quality distribution over {len(values)} quality bins")
    return 0


# ---------------------------------------------------------------------------
# CollectAlignmentSummaryMetrics (picard analysis/AlignmentSummaryMetrics)
# ---------------------------------------------------------------------------

_ASM_COLUMNS = [
    "CATEGORY", "TOTAL_READS", "PF_READS", "PCT_PF_READS", "PF_NOISE_READS",
    "PF_READS_ALIGNED", "PCT_PF_READS_ALIGNED", "PF_ALIGNED_BASES",
    "PF_HQ_ALIGNED_READS", "PF_HQ_ALIGNED_BASES", "PF_HQ_ALIGNED_Q20_BASES",
    "PF_HQ_MEDIAN_MISMATCHES", "PF_MISMATCH_RATE", "PF_HQ_ERROR_RATE",
    "PF_INDEL_RATE", "MEAN_READ_LENGTH", "READS_ALIGNED_IN_PAIRS",
    "PCT_READS_ALIGNED_IN_PAIRS", "PF_READS_IMPROPER_PAIRS",
    "PCT_PF_READS_IMPROPER_PAIRS", "BAD_CYCLES", "STRAND_BALANCE",
    "PCT_CHIMERAS", "PCT_ADAPTER",
]


class _AsmAccumulator:
    """One CATEGORY row (FIRST_OF_PAIR / SECOND_OF_PAIR / PAIR / UNPAIRED)."""

    HQ_MAPQ = 20

    def __init__(self, category):
        self.category = category
        self.total = self.pf = self.noise = self.aligned = 0
        self.aligned_bases = self.hq_reads = self.hq_bases = self.hq_q20 = 0
        self.hq_mismatches = []
        self.mismatches = self.indels = self.indel_events = 0
        self.read_len_sum = 0
        self.in_pairs = self.improper = self.plus_strand = 0
        self.chimeras = 0

    def add(self, r, nm):
        from ..io import sam as _sam

        self.total += 1
        if r.flag & 0x200:  # vendor-failed
            return
        self.pf += 1
        self.read_len_sum += len(r.bases)
        if r.is_unmapped:
            return
        self.aligned += 1
        aligned_len = int(sum(int(l) for o, l in zip(r.cigar_ops, r.cigar_lens)
                              if int(o) in (_sam.OP_M, _sam.OP_EQ, _sam.OP_X)))
        ins = sum(int(l) for o, l in zip(r.cigar_ops, r.cigar_lens) if int(o) == _sam.OP_I)
        dels = sum(1 for o in r.cigar_ops if int(o) == _sam.OP_D)
        inss = sum(1 for o in r.cigar_ops if int(o) == _sam.OP_I)
        self.aligned_bases += aligned_len + ins
        self.indel_events += dels + inss
        mism = max(0, (nm or 0) - ins - sum(
            int(l) for o, l in zip(r.cigar_ops, r.cigar_lens) if int(o) == _sam.OP_D))
        self.mismatches += mism
        if not r.is_reverse:
            self.plus_strand += 1
        if r.mapq >= self.HQ_MAPQ:
            self.hq_reads += 1
            self.hq_bases += aligned_len
            self.hq_q20 += int((r.quals >= 20).sum())
            self.hq_mismatches.append(mism)
        if r.is_paired:
            if not r.mate_is_unmapped:
                self.in_pairs += 1
                if r.ref_id != r.mate_ref_id:
                    self.chimeras += 1
            if not r.flag & 0x2:
                self.improper += 1

    def row(self):
        import numpy as _np

        def ratio(a, b):
            return a / b if b else 0.0

        return [
            self.category, self.total, self.pf, round(ratio(self.pf, self.total), 6),
            self.noise, self.aligned, round(ratio(self.aligned, self.pf), 6),
            self.aligned_bases, self.hq_reads, self.hq_bases, self.hq_q20,
            float(_np.median(self.hq_mismatches)) if self.hq_mismatches else 0.0,
            round(ratio(self.mismatches, self.aligned_bases), 6),
            round(ratio(sum(self.hq_mismatches), self.hq_bases), 6),
            round(ratio(self.indel_events, self.aligned_bases), 6),
            round(ratio(self.read_len_sum, self.pf), 6),
            self.in_pairs, round(ratio(self.in_pairs, self.aligned), 6),
            self.improper, round(ratio(self.improper, self.aligned), 6),
            0, round(ratio(self.plus_strand, self.aligned), 6),
            round(ratio(self.chimeras, self.in_pairs), 6), 0.0,
        ]


@register_tool("CollectAlignmentSummaryMetrics")
def collect_alignment_summary_metrics(argv):
    """Alignment summary metrics per read category (picard
    CollectAlignmentSummaryMetrics; AlignmentSummaryMetrics column set)."""
    import argparse

    from ..io import bam as bamio

    p = argparse.ArgumentParser(description="CollectAlignmentSummaryMetrics")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("-R", "--reference", default=None)
    args = p.parse_args(argv)
    cats = {"FIRST_OF_PAIR": _AsmAccumulator("FIRST_OF_PAIR"),
            "SECOND_OF_PAIR": _AsmAccumulator("SECOND_OF_PAIR"),
            "PAIR": _AsmAccumulator("PAIR"),
            "UNPAIRED": _AsmAccumulator("UNPAIRED")}
    for r in bamio.BamReader(args.input):
        if r.is_secondary or r.is_supplementary:
            continue
        nm = r.tags.get("NM") if r.tags else None
        if r.is_paired:
            cats["FIRST_OF_PAIR" if r.flag & 0x40 else "SECOND_OF_PAIR"].add(r, nm)
            cats["PAIR"].add(r, nm)
        else:
            cats["UNPAIRED"].add(r, nm)
    rows = [c.row() for c in cats.values() if c.total > 0]
    write_metrics_file(args.output, "CollectAlignmentSummaryMetrics",
                       "picard.analysis.AlignmentSummaryMetrics", _ASM_COLUMNS, rows)
    print(f"wrote {args.output}")
    return 0


@register_tool("CollectQualityYieldMetrics")
def collect_quality_yield_metrics(argv):
    """Base-yield metrics (picard CollectQualityYieldMetrics: total/PF reads and
    bases, Q20/Q30 base counts)."""
    import argparse

    from ..io import bam as bamio

    p = argparse.ArgumentParser(description="CollectQualityYieldMetrics")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-O", "--output", required=True)
    args = p.parse_args(argv)
    total_reads = pf_reads = total_bases = pf_bases = 0
    q20 = q30 = pf_q20 = pf_q30 = 0
    for r in bamio.BamReader(args.input):
        if r.is_secondary or r.is_supplementary:
            continue
        total_reads += 1
        n = len(r.bases)
        total_bases += n
        nq20 = int((r.quals >= 20).sum())
        nq30 = int((r.quals >= 30).sum())
        q20 += nq20
        q30 += nq30
        if not r.flag & 0x200:
            pf_reads += 1
            pf_bases += n
            pf_q20 += nq20
            pf_q30 += nq30
    cols = ["TOTAL_READS", "PF_READS", "READ_LENGTH", "TOTAL_BASES", "PF_BASES",
            "Q20_BASES", "PF_Q20_BASES", "Q30_BASES", "PF_Q30_BASES",
            "Q20_EQUIVALENT_YIELD", "PF_Q20_EQUIVALENT_YIELD"]
    read_len = round(total_bases / total_reads) if total_reads else 0
    rows = [[total_reads, pf_reads, read_len, total_bases, pf_bases,
             q20, pf_q20, q30, pf_q30, 0, 0]]
    write_metrics_file(args.output, "CollectQualityYieldMetrics",
                       "picard.analysis.CollectQualityYieldMetrics$QualityYieldMetrics",
                       cols, rows)
    print(f"wrote {args.output}")
    return 0


# ---------------------------------------------------------------------------
# Round-4 Picard metrics tranche (picard analysis/ tools exposed through GATK
# Main.java:109)
# ---------------------------------------------------------------------------


@register_tool("CollectBaseDistributionByCycle")
def collect_base_distribution_by_cycle(argv):
    """Per-cycle base composition percentages (picard
    analysis/CollectBaseDistributionByCycle: PCT_A/C/G/T/N per cycle,
    reverse-strand reads complemented+flipped, second-of-pair cycles appended)."""
    from ..io import bam as bamio

    p = argparse.ArgumentParser(description="CollectBaseDistributionByCycle")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("--aligned-reads-only", action="store_true")
    p.add_argument("--pf-reads-only", action="store_true")
    args = p.parse_args(argv)

    import numpy as np

    counts = {}  # cycle -> [A, C, G, T, N]
    comp = dict(zip(b"ACGTN", b"TGCAN"))
    max_first = 0
    reads1 = []
    for r in bamio.BamReader(args.input):
        if r.is_secondary or r.is_supplementary:
            continue
        if args.aligned_reads_only and r.is_unmapped:
            continue
        if args.pf_reads_only and (r.flag & 0x200):
            continue
        if not r.is_paired or r.is_first_of_pair:
            max_first = max(max_first, len(r.bases))
        reads1.append(r)
    for r in reads1:
        b = bytes(r.bases).upper()
        if r.is_reverse:
            b = bytes(comp.get(x, ord("N")) for x in reversed(b))
        offset = max_first if (r.is_paired and not r.is_first_of_pair) else 0
        for i, x in enumerate(b):
            cyc = offset + i + 1
            row = counts.setdefault(cyc, [0] * 5)
            row["ACGTN".find(chr(x)) if chr(x) in "ACGTN" else 4] += 1
    rows = []
    for cyc in sorted(counts):
        row = counts[cyc]
        total = sum(row) or 1
        rows.append([cyc] + [round(100.0 * c / total, 6) for c in row])
    write_metrics_file(args.output, "CollectBaseDistributionByCycle",
                       "picard.analysis.BaseDistributionByCycleMetrics",
                       ["READ_END", "CYCLE", "PCT_A", "PCT_C", "PCT_G", "PCT_T",
                        "PCT_N"],
                       [[2 if c > max_first else 1, c, a, g, t, u, n]
                        for c, a, g, t, u, n in rows])
    print(f"wrote base distribution for {len(rows)} cycles")
    return 0


@register_tool("CollectGcBiasMetrics")
def collect_gc_bias_metrics(argv):
    """GC bias metrics (picard analysis/CollectGcBiasMetrics): per-GC-bin
    window counts from the reference vs read starts, normalized coverage per
    bin, summary of AT/GC dropout."""
    from ..io import bam as bamio, fasta as fasta_mod

    p = argparse.ArgumentParser(description="CollectGcBiasMetrics")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-R", "--reference", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("-S", "--summary-output", default=None)
    p.add_argument("--scan-window-size", type=int, default=100)
    args = p.parse_args(argv)

    import numpy as np

    ref = fasta_mod.FastaReference(args.reference)
    win = args.scan_window_size
    window_counts = np.zeros(101, np.int64)  # windows per GC%
    read_counts = np.zeros(101, np.int64)  # read starts per GC%
    gc_of = {}
    rd = bamio.BamReader(args.input)
    for s in rd.header.sequences:
        seq = np.asarray(ref.fetch(s.name, 0, ref.contig_length(s.name)), np.uint8)
        up = seq | 0x20
        is_gc = (up == ord("g")) | (up == ord("c"))
        is_at = (up == ord("a")) | (up == ord("t"))
        csum_gc = np.concatenate([[0], np.cumsum(is_gc)])
        csum_valid = np.concatenate([[0], np.cumsum(is_gc | is_at)])
        n_win = max(0, len(seq) - win + 1)
        gc_pct = np.full(n_win, -1, np.int64)
        if n_win:
            gcs = csum_gc[win:] - csum_gc[:-win]
            valid = csum_valid[win:] - csum_valid[:-win]
            ok = valid == win
            gc_pct[ok] = np.round(100.0 * gcs[ok] / win).astype(np.int64)
            vals, cnts = np.unique(gc_pct[ok], return_counts=True)
            window_counts[vals] += cnts
        gc_of[s.name] = gc_pct
    total_reads = 0
    for r in rd:
        if r.is_unmapped or r.is_duplicate or r.is_secondary or r.is_supplementary:
            continue
        gp = gc_of.get(rd.header.sequences[r.ref_id].name)
        if gp is None or not (0 <= r.pos < len(gp)) or gp[r.pos] < 0:
            continue
        read_counts[gp[r.pos]] += 1
        total_reads += 1
    mean_per_window = total_reads / max(1, window_counts.sum())
    rows = []
    for gc in range(101):
        if window_counts[gc] == 0:
            continue
        norm = (read_counts[gc] / window_counts[gc]) / mean_per_window \
            if mean_per_window else 0.0
        rows.append(["All_Reads", gc, int(window_counts[gc]),
                     int(read_counts[gc]), round(norm, 6)])
    write_metrics_file(args.output, "CollectGcBiasMetrics",
                       "picard.analysis.GcBiasDetailMetrics",
                       ["ACCUMULATION_LEVEL", "GC", "WINDOWS", "READ_STARTS",
                        "NORMALIZED_COVERAGE"], rows)
    if args.summary_output:
        # dropout: percentage of reads "missing" from the low/high GC tails
        at_drop = sum(max(0.0, (window_counts[g] / max(1, window_counts.sum())
                                - read_counts[g] / max(1, total_reads)) * 100)
                      for g in range(0, 50))
        gc_drop = sum(max(0.0, (window_counts[g] / max(1, window_counts.sum())
                                - read_counts[g] / max(1, total_reads)) * 100)
                      for g in range(50, 101))
        write_metrics_file(args.summary_output, "CollectGcBiasMetrics",
                           "picard.analysis.GcBiasSummaryMetrics",
                           ["ACCUMULATION_LEVEL", "TOTAL_CLUSTERS",
                            "AT_DROPOUT", "GC_DROPOUT"],
                           [["All_Reads", total_reads, round(at_drop, 6),
                             round(gc_drop, 6)]])
    print(f"wrote GC bias metrics over {int(window_counts.sum())} windows")
    return 0


@register_tool("CollectOxoGMetrics")
def collect_oxog_metrics(argv):
    """CpCG oxidation artifact metrics (picard analysis/CollectOxoGMetrics):
    per-context counts of C>A artifacts split by read orientation, and the
    phred-scaled OXIDATION_Q."""
    from ..io import bam as bamio, fasta as fasta_mod

    p = argparse.ArgumentParser(description="CollectOxoGMetrics")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-R", "--reference", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("--context-size", type=int, default=1)
    p.add_argument("--minimum-quality-score", type=int, default=20)
    args = p.parse_args(argv)

    import math

    import numpy as np

    ref = fasta_mod.FastaReference(args.reference)
    rd = bamio.BamReader(args.input)
    # context -> [ref C observations, C>A on F1R2, C>A on F2R1]
    ctx_counts = {}
    cache = {}
    for r in rd:
        if r.is_unmapped or r.is_duplicate or r.mapq == 0:
            continue
        contig = rd.header.sequences[r.ref_id].name
        if contig not in cache:
            cache[contig] = bytes(ref.fetch(contig, 0, ref.contig_length(contig))).upper()
        seq = cache[contig]
        rp, ro = int(r.pos), 0
        is_f2r1 = r.is_reverse == bool(r.flag & 0x40)
        for op, ln in zip(r.cigar_ops, r.cigar_lens):
            op, ln = int(op), int(ln)
            if op in (sam.OP_M, sam.OP_EQ, sam.OP_X):
                for j in range(ln):
                    pos = rp + j
                    if not (args.context_size <= pos < len(seq) - args.context_size):
                        continue
                    if r.quals[ro + j] < args.minimum_quality_score:
                        continue
                    ref_b = seq[pos]
                    read_b = int(r.bases[ro + j]) & ~0x20  # uppercase fold
                    if ref_b == ord("C"):
                        ctx = seq[pos - args.context_size : pos + args.context_size + 1].decode()
                        row = ctx_counts.setdefault(ctx, [0, 0, 0])
                        row[0] += 1
                        if read_b == ord("A"):
                            row[2 if is_f2r1 else 1] += 1
                rp += ln
                ro += ln
            elif op in (sam.OP_I, sam.OP_S):
                ro += ln
            elif op in (sam.OP_D, sam.OP_N):
                rp += ln
    rows = []
    for ctx in sorted(ctx_counts):
        total, alt_f1r2, alt_f2r1 = ctx_counts[ctx]
        # oxoG shows as C>A on F1R2 only; error rate = excess over F2R1
        rate = max(1e-10, (alt_f1r2 - alt_f2r1) / max(1, total))
        oxo_q = min(100.0, -10 * math.log10(rate))
        rows.append([ctx, total, alt_f1r2, alt_f2r1, round(oxo_q, 4)])
    write_metrics_file(args.output, "CollectOxoGMetrics",
                       "picard.analysis.CollectOxoGMetrics$CpcgMetrics",
                       ["CONTEXT", "TOTAL_SITES", "ALT_NONOXO_BASES",
                        "ALT_OXO_BASES", "OXIDATION_Q"], rows)
    print(f"wrote OxoG metrics for {len(rows)} contexts")
    return 0


@register_tool("EstimateLibraryComplexity")
def estimate_library_complexity(argv):
    """Duplication-based library size estimate (picard
    EstimateLibraryComplexity): read pairs grouped by alignment-free 5' bases,
    duplicate sets counted, library size via the Lander-Waterman estimator."""
    from ..io import bam as bamio

    p = argparse.ArgumentParser(description="EstimateLibraryComplexity")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("--min-identical-bases", type=int, default=5)
    args = p.parse_args(argv)

    import math

    pair_keys = {}
    n_pairs = 0
    by_name = {}
    for r in bamio.BamReader(args.input):
        if not r.is_paired or r.is_secondary or r.is_supplementary:
            continue
        by_name.setdefault(r.name, []).append(bytes(r.bases[: args.min_identical_bases * 4]))
    for name, parts in by_name.items():
        if len(parts) < 2:
            continue
        key = tuple(sorted(parts[:2]))
        pair_keys[key] = pair_keys.get(key, 0) + 1
        n_pairs += 1
    unique_pairs = len(pair_keys)
    dup_pairs = n_pairs - unique_pairs

    def lander_waterman(n, u):
        """solve u = L * (1 - exp(-n/L)) for library size L."""
        if n <= 0 or u <= 0 or u >= n:
            return u
        lo, hi = u, u * 100000.0
        for _ in range(80):
            mid = (lo + hi) / 2
            est = mid * (1 - math.exp(-n / mid))
            if est > u:
                hi = mid
            else:
                lo = mid
        return (lo + hi) / 2

    lib_size = int(lander_waterman(n_pairs, unique_pairs))
    pct_dup = dup_pairs / n_pairs if n_pairs else 0.0
    write_metrics_file(args.output, "EstimateLibraryComplexity",
                       "picard.sam.DuplicationMetrics",
                       ["LIBRARY", "READ_PAIRS_EXAMINED", "READ_PAIR_DUPLICATES",
                        "PERCENT_DUPLICATION", "ESTIMATED_LIBRARY_SIZE"],
                       [["Unknown", n_pairs, dup_pairs, round(pct_dup, 6), lib_size]])
    print(f"examined {n_pairs} pairs, {dup_pairs} duplicates, "
          f"estimated library size {lib_size}")
    return 0


@register_tool("CollectMultipleMetrics")
def collect_multiple_metrics(argv):
    """Run several metrics collectors in one pass over the inputs (picard
    analysis/CollectMultipleMetrics: PROGRAM list; here each program routes to
    the standalone registered collector with <output>.<ext> files)."""
    from ..cli import TOOL_REGISTRY as _REG

    p = argparse.ArgumentParser(description="CollectMultipleMetrics")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-O", "--output", required=True, help="output file base name")
    p.add_argument("-R", "--reference", default=None)
    p.add_argument("--PROGRAM", action="append", default=None)
    args = p.parse_args(argv)
    programs = args.PROGRAM or ["CollectAlignmentSummaryMetrics",
                                "CollectInsertSizeMetrics",
                                "MeanQualityByCycle",
                                "QualityScoreDistribution",
                                "CollectBaseDistributionByCycle"]
    ext = {"CollectAlignmentSummaryMetrics": "alignment_summary_metrics",
           "CollectInsertSizeMetrics": "insert_size_metrics",
           "MeanQualityByCycle": "quality_by_cycle_metrics",
           "QualityScoreDistribution": "quality_distribution_metrics",
           "CollectBaseDistributionByCycle": "base_distribution_by_cycle_metrics",
           "CollectGcBiasMetrics": "gc_bias.detail_metrics",
           "CollectQualityYieldMetrics": "quality_yield_metrics"}
    n_ok = 0
    for prog in programs:
        if prog not in _REG:
            print(f"WARNING: unknown PROGRAM {prog}; skipping")
            continue
        sub = ["-I", args.input, "-O", f"{args.output}.{ext.get(prog, prog)}"]
        if prog in ("CollectAlignmentSummaryMetrics", "CollectGcBiasMetrics") \
                and args.reference:
            sub += ["-R", args.reference]
        rc = _REG[prog](sub)
        n_ok += rc == 0
    print(f"CollectMultipleMetrics: {n_ok}/{len(programs)} programs completed")
    return 0


@register_tool("GatherBamFiles")
def gather_bam_files(argv):
    """Concatenate scattered coordinate-sorted BAMs (picard GatherBamFiles)."""
    from ..io import bam as bamio

    p = argparse.ArgumentParser(description="GatherBamFiles")
    p.add_argument("-I", "--input", action="append", required=True)
    p.add_argument("-O", "--output", required=True)
    args = p.parse_args(argv)
    readers = [bamio.BamReader(path) for path in args.input]
    w = bamio.BamWriter(args.output, readers[0].header)
    n = 0
    for rd in readers:
        for r in rd:
            w.write(r)
            n += 1
    w.close()
    print(f"gathered {n} reads from {len(args.input)} BAMs into {args.output}")
    return 0


@register_tool("ScatterIntervalsByNs")
def scatter_intervals_by_ns(argv):
    """Partition the reference into N/ACGT blocks as an interval list (picard
    ScatterIntervalsByNs: maximal non-N stretches, OT=ACGT default)."""
    from ..io import fasta as fasta_mod

    p = argparse.ArgumentParser(description="ScatterIntervalsByNs")
    p.add_argument("-R", "--reference", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("-OT", "--output-type", choices=["ACGT", "N", "BOTH"],
                   default="ACGT")
    p.add_argument("-N", "--max-to-merge", type=int, default=1)
    args = p.parse_args(argv)

    import numpy as np

    ref = fasta_mod.FastaReference(args.reference)
    lines = []
    n_iv = 0
    with open(args.output, "w") as fh:
        fh.write("@HD\tVN:1.6\tSO:coordinate\n")
        for name in ref.contigs():
            fh.write(f"@SQ\tSN:{name}\tLN:{ref.contig_length(name)}\n")
        for name in ref.contigs():
            seq = np.asarray(ref.fetch(name, 0, ref.contig_length(name)), np.uint8)
            is_n = (seq | 0x20) == ord("n")
            # merge N runs shorter than max-to-merge into ACGT blocks
            padded = np.zeros(len(seq) + 2, np.int8)
            padded[1:-1] = is_n
            d = np.diff(padded)
            n_starts = np.nonzero(d == 1)[0]
            n_ends = np.nonzero(d == -1)[0]
            keep = (n_ends - n_starts) >= args.max_to_merge
            n_starts, n_ends = n_starts[keep], n_ends[keep]
            blocks = []  # (start, end, kind)
            pos = 0
            for s, e in zip(n_starts, n_ends):
                if s > pos:
                    blocks.append((pos, s, "ACGT"))
                blocks.append((s, e, "N"))
                pos = e
            if pos < len(seq):
                blocks.append((pos, len(seq), "ACGT"))
            for s, e, kind in blocks:
                if args.output_type in (kind, "BOTH"):
                    fh.write(f"{name}\t{s + 1}\t{e}\t+\t{kind}\n")
                    n_iv += 1
    print(f"wrote {n_iv} intervals to {args.output}")
    return 0


def _targeted_coverage_metrics(bam_path, ref_path, target_path, bait_path=None):
    """Shared engine for CollectHsMetrics / CollectTargetedPcrMetrics (picard
    analysis/directed/TargetedPcrMetricsCollector + HsMetricCollector): on/off
    target base accounting, fold-80 penalty, per-target mean coverage."""
    from ..engine import intervals as iv
    from ..io import bam as bamio

    def load_intervals(path):
        out = []
        for line in open(path):
            if line.startswith("@") or not line.strip():
                continue
            f = line.split("\t")
            out.append((f[0], int(f[1]) - 1, int(f[2])))
        return out

    targets = load_intervals(target_path)
    baits = load_intervals(bait_path) if bait_path else targets
    by_contig = {}
    for c, s, e in targets:
        by_contig.setdefault(c, []).append((s, e))
    bait_by_contig = {}
    for c, s, e in baits:
        bait_by_contig.setdefault(c, []).append((s, e))
    territory = sum(e - s for _, s, e in targets)
    cov = {(c, i): 0 for c, ivs in by_contig.items() for i in range(len(ivs))}
    depth = {}  # per-target arrays
    for c, ivs in by_contig.items():
        for i, (s, e) in enumerate(ivs):
            depth[(c, i)] = np.zeros(e - s, np.int64)
    total_bases = on_target = near_target = off_target = 0
    n_reads = 0
    rd = bamio.BamReader(bam_path)
    for r in rd:
        if r.is_unmapped or r.is_duplicate or r.is_secondary or r.is_supplementary:
            continue
        n_reads += 1
        contig = rd.header.sequences[r.ref_id].name
        aligned = sum(int(l) for o, l in zip(r.cigar_ops, r.cigar_lens)
                      if o in (sam.OP_M, sam.OP_EQ, sam.OP_X))
        total_bases += aligned
        hit = False
        for i, (s, e) in enumerate(by_contig.get(contig, [])):
            lo, hi = max(r.pos, s), min(r.end, e)
            if lo < hi:
                on_target += hi - lo
                depth[(contig, i)][lo - s : hi - s] += 1
                hit = True
        if not hit:
            near = any(r.pos < e + 250 and r.end > s - 250
                       for s, e in bait_by_contig.get(contig, []))
            if near:
                near_target += aligned
            else:
                off_target += aligned
    all_depths = np.concatenate(list(depth.values())) if depth else np.zeros(1)
    mean_cov = float(all_depths.mean())
    # fold-80: mean / 20th-percentile depth (PCT of target bases at depth)
    p20 = float(np.percentile(all_depths, 20))
    fold80 = mean_cov / p20 if p20 > 0 else 0.0
    pct_1x = float((all_depths >= 1).mean())
    pct_20x = float((all_depths >= 20).mean())
    sel = (on_target + near_target) / total_bases if total_bases else 0.0
    return dict(TERRITORY=territory, TOTAL_READS=n_reads,
                ON_TARGET_BASES=on_target, NEAR_TARGET_BASES=near_target,
                OFF_TARGET_BASES=off_target,
                PCT_SELECTED_BASES=round(sel, 6),
                MEAN_TARGET_COVERAGE=round(mean_cov, 6),
                FOLD_80_BASE_PENALTY=round(fold80, 6),
                PCT_TARGET_BASES_1X=round(pct_1x, 6),
                PCT_TARGET_BASES_20X=round(pct_20x, 6))


@register_tool("CollectHsMetrics")
def collect_hs_metrics(argv):
    """Hybrid-selection metrics for targeted panels (picard CollectHsMetrics)."""
    p = argparse.ArgumentParser(description="CollectHsMetrics")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("-R", "--reference", default=None)
    p.add_argument("--TARGET_INTERVALS", "--target-intervals",
                   dest="targets", required=True)
    p.add_argument("--BAIT_INTERVALS", "--bait-intervals",
                   dest="baits", default=None)
    args = p.parse_args(argv)
    m = _targeted_coverage_metrics(args.input, args.reference, args.targets,
                                   args.baits)
    cols = ["BAIT_SET"] + list(m.keys())
    write_metrics_file(args.output, "CollectHsMetrics",
                       "picard.analysis.directed.HsMetrics",
                       cols, [["targets"] + list(m.values())])
    print(f"HsMetrics: {m['ON_TARGET_BASES']} on-target bases, "
          f"mean target coverage {m['MEAN_TARGET_COVERAGE']}")
    return 0


@register_tool("CollectTargetedPcrMetrics")
def collect_targeted_pcr_metrics(argv):
    """Amplicon-panel coverage metrics (picard CollectTargetedPcrMetrics)."""
    p = argparse.ArgumentParser(description="CollectTargetedPcrMetrics")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("-R", "--reference", default=None)
    p.add_argument("--AMPLICON_INTERVALS", "--amplicon-intervals",
                   dest="amplicons", required=True)
    p.add_argument("--TARGET_INTERVALS", "--target-intervals",
                   dest="targets", required=True)
    args = p.parse_args(argv)
    m = _targeted_coverage_metrics(args.input, args.reference, args.targets,
                                   args.amplicons)
    cols = ["CUSTOM_AMPLICON_SET"] + list(m.keys())
    write_metrics_file(args.output, "CollectTargetedPcrMetrics",
                       "picard.analysis.directed.TargetedPcrMetrics",
                       cols, [["amplicons"] + list(m.values())])
    print(f"TargetedPcrMetrics: mean target coverage {m['MEAN_TARGET_COVERAGE']}")
    return 0


@register_tool("CollectSequencingArtifactMetrics")
def collect_sequencing_artifact_metrics(argv):
    """Pre-adapter / bait-bias artifact error rates by substitution + context
    (picard analysis/artifacts/CollectSequencingArtifactMetrics): per
    (ref, alt) substitution, counts split by read orientation; phred-scaled
    pre-adapter Q from the orientation-asymmetric excess."""
    from ..io import bam as bamio, fasta as fasta_mod

    p = argparse.ArgumentParser(description="CollectSequencingArtifactMetrics")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-R", "--reference", required=True)
    p.add_argument("-O", "--output", required=True, help="output base name")
    p.add_argument("--minimum-quality-score", type=int, default=20)
    args = p.parse_args(argv)

    import math

    ref = fasta_mod.FastaReference(args.reference)
    rd = bamio.BamReader(args.input)
    cache = {}
    # (ref_base, alt_base) -> [fwd_alt, rev_alt, total_ref_obs]
    subs = {}
    for r in rd:
        if r.is_unmapped or r.is_duplicate or r.mapq == 0:
            continue
        contig = rd.header.sequences[r.ref_id].name
        if contig not in cache:
            cache[contig] = bytes(ref.fetch(contig, 0, ref.contig_length(contig))).upper()
        seq = cache[contig]
        is_f2r1 = r.is_reverse == bool(r.flag & 0x40)
        rp, ro = int(r.pos), 0
        for op, ln in zip(r.cigar_ops, r.cigar_lens):
            op, ln = int(op), int(ln)
            if op in (sam.OP_M, sam.OP_EQ, sam.OP_X):
                for j in range(ln):
                    if r.quals[ro + j] < args.minimum_quality_score:
                        continue
                    rb = seq[rp + j] if rp + j < len(seq) else ord("N")
                    ab = int(r.bases[ro + j]) & ~0x20
                    if rb not in b"ACGT" or ab not in b"ACGT":
                        continue
                    for alt in b"ACGT":
                        if alt == rb:
                            continue
                        row = subs.setdefault((chr(rb), chr(alt)), [0, 0, 0])
                        row[2] += 1
                        if ab == alt:
                            row[1 if is_f2r1 else 0] += 1
                rp += ln
                ro += ln
            elif op in (sam.OP_I, sam.OP_S):
                ro += ln
            elif op in (sam.OP_D, sam.OP_N):
                rp += ln
    rows = []
    for (rb, ab), (fwd, rev, total) in sorted(subs.items()):
        rate = max(1e-10, abs(fwd - rev) / max(1, total))
        q = min(100.0, -10 * math.log10(rate))
        rows.append([rb, ab, total, fwd, rev, round(q, 4)])
    write_metrics_file(args.output + ".pre_adapter_detail_metrics",
                       "CollectSequencingArtifactMetrics",
                       "picard.analysis.artifacts.SequencingArtifactMetrics$PreAdapterDetailMetrics",
                       ["REF_BASE", "ALT_BASE", "PRO_REF_BASES", "PRO_ALT_BASES",
                        "CON_ALT_BASES", "QSCORE"], rows)
    print(f"wrote artifact metrics for {len(rows)} substitution classes")
    return 0


@register_tool("CrosscheckFingerprints")
def crosscheck_fingerprints(argv):
    """Sample identity crosscheck (picard fingerprint/CrosscheckFingerprints,
    reduced): genotype each input at the haplotype-map sites from pileup
    allele fractions, then LOD-score every pair of inputs for same-sample vs
    different-sample; EXPECTED MATCH when LOD > threshold."""
    from ..io import bam as bamio, vcf as vcfio

    p = argparse.ArgumentParser(description="CrosscheckFingerprints")
    p.add_argument("-I", "--input", action="append", required=True)
    p.add_argument("-H", "--haplotype-map", required=True,
                   help="VCF of fingerprinting SNP sites")
    p.add_argument("-O", "--output", required=True)
    p.add_argument("--lod-threshold", type=float, default=-5.0)
    args = p.parse_args(argv)

    import math

    sites = []
    for v in vcfio.VcfReader(args.haplotype_map):
        if v.is_snp() and len(v.alts) == 1:
            sites.append((v.contig, v.pos, v.ref.upper(), v.alts[0].upper()))

    def fingerprint(path):
        rd = bamio.BamReader(path)
        contig_ids = {s.name: i for i, s in enumerate(rd.header.sequences)}
        from ..calling.annotations import read_offset_at
        gts = {}
        for contig, pos, ref_a, alt_a in sites:
            if contig not in contig_ids:
                continue
            n_ref = n_alt = 0
            for r in rd.query(contig, pos, pos + 1):
                if r.is_unmapped or r.is_duplicate or r.mapq == 0:
                    continue
                off = read_offset_at(r, pos)
                if off is None:
                    continue
                b = chr(int(r.bases[off]) & ~0x20)
                if b == ref_a:
                    n_ref += 1
                elif b == alt_a:
                    n_alt += 1
            if n_ref + n_alt >= 2:
                af = n_alt / (n_ref + n_alt)
                gt = 0 if af < 0.2 else (2 if af > 0.8 else 1)
                gts[(contig, pos)] = gt
        sample = "unknown"
        for rg in rd.header.read_groups:
            sample = rg.get("SM", sample)
            break
        return sample, gts

    fps = [(path,) + fingerprint(path) for path in args.input]
    rows = []
    for i in range(len(fps)):
        for j in range(i + 1, len(fps)):
            pa, sa, ga = fps[i]
            pb, sb, gb = fps[j]
            common = set(ga) & set(gb)
            lod = 0.0
            for k in common:
                # match likelihood ratio per site: same genotype strongly
                # supports same sample (p_err = 0.05 genotyping error)
                if ga[k] == gb[k]:
                    lod += math.log10(0.95 / (1.0 / 3))
                else:
                    lod += math.log10(0.05 / (2.0 / 3))
            expected = sa == sb
            thr = abs(args.lod_threshold)
            # picard semantics: |LOD| < threshold is INCONCLUSIVE, not a
            # mismatch; only confidently-wrong pairs are UNEXPECTED
            if lod >= thr:
                result = "EXPECTED_MATCH" if expected else "UNEXPECTED_MATCH"
            elif lod <= -thr:
                result = "UNEXPECTED_MISMATCH" if expected else "EXPECTED_MISMATCH"
            else:
                result = "INCONCLUSIVE"
            rows.append([result, round(lod, 4), len(common), sa, sb, pa, pb])
    write_metrics_file(args.output, "CrosscheckFingerprints",
                       "picard.fingerprint.CrosscheckMetric",
                       ["RESULT", "LOD_SCORE", "DATA_POINTS", "LEFT_SAMPLE",
                        "RIGHT_SAMPLE", "LEFT_FILE", "RIGHT_FILE"], rows)
    n_bad = sum(1 for r in rows if "UNEXPECTED" in r[0])
    print(f"crosschecked {len(fps)} inputs: {len(rows)} pairs, {n_bad} unexpected")
    return 0 if n_bad == 0 else 1
