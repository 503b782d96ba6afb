# Copied verbatim from gatk_tpu/tools/bqsr_tools.py; only import lines may differ.
"""BaseRecalibrator / ApplyBQSR command line tools.

Reference behavior: tools/walkers/bqsr/BaseRecalibrator.java, ApplyBQSR.java.
"""
from __future__ import annotations

import argparse

import numpy as np

from ..cli import UserError, register_tool
from ..engine import intervals as iv
from ..io import bam, fasta, vcf
from ..recal import engine as recal_engine
from ..recal.apply import BQSRReadTransformer, RecalibrationReport
from ..recal.engine import BaseRecalibrationEngine, RecalArgs, bqsr_read_filter


def _read_group_identifiers(header):
    """(ordered identifiers, RG-id -> identifier map); identifier is PU if
    present else ID (ReadGroupCovariate.getReadGroupIdentifier)."""
    out = []
    id_map = {}
    for rg in header.read_groups:
        ident = rg.get("PU") or rg.get("ID")
        id_map[rg.get("ID")] = ident
        if ident not in out:
            out.append(ident)
    return out, id_map


class _KnownSites:
    """In-memory per-contig sorted known-site spans with sweep queries.

    When target intervals are given and the resource is tabix-indexed, only
    the overlapping BGZF blocks are decompressed (iter_vcf_features /
    FeatureDataSource.java:68) — whole-genome known-sites resources load in
    O(targets), not O(file)."""

    def __init__(self, paths, intervals=None):
        self.by_contig = {}
        for path in paths:
            for v in vcf.iter_vcf_features(path, intervals, pad=1000):
                # 1-based [start, end]; end covers the ref allele span
                self.by_contig.setdefault(v.contig, []).append((v.pos + 1, v.pos + len(v.ref)))
        for c in self.by_contig:
            self.by_contig[c].sort()
            self._starts = None

    def overlapping(self, contig, start_1b, end_1b):
        sites = self.by_contig.get(contig)
        if not sites:
            return []
        import bisect

        # all sites with start <= end_1b and end >= start_1b; starts sorted
        hi = bisect.bisect_right(sites, (end_1b + 1,)) if sites else 0
        out = []
        for s, e in sites[:hi]:
            if e >= start_1b:
                out.append((s, e))
        return out


@register_tool("BaseRecalibrator")
def base_recalibrator(argv):
    """Generate a base quality score recalibration table (pass 1 of BQSR)."""
    p = argparse.ArgumentParser(description="BaseRecalibrator")
    p.add_argument("-I", "--input", action="append", required=True)
    p.add_argument("-R", "--reference", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("-L", "--intervals", action="append", default=None)
    p.add_argument("--known-sites", action="append", default=[])
    p.add_argument("--indels-context-size", type=int, default=3)
    p.add_argument("--mismatches-context-size", type=int, default=2)
    p.add_argument("--low-quality-tail", type=int, default=2)
    p.add_argument("--maximum-cycle-value", type=int, default=500)
    p.add_argument("--quantizing-levels", type=int, default=16)
    p.add_argument("--enable-baq", action="store_true")
    p.add_argument("-indels", "--indels", action="store_true", default=True,
                   help="compute indel BQSR tables (default on, as in GATK4)")
    p.add_argument("--bqsr-baq-gap-open-penalty", type=float, default=40.0)
    args = p.parse_args(argv)

    if not args.known_sites:
        raise UserError("This calculation is critically dependent on being able to "
                        "skip over known variant sites; please provide --known-sites")

    ref = fasta.FastaReference(args.reference)
    known_intervals = None
    if args.intervals:
        hdr = bam.BamReader(args.input[0]).header
        lengths0 = {s.name: s.length for s in hdr.sequences}
        known_intervals = iv.parse_intervals_arg(args.intervals, lengths0)
    known = _KnownSites(args.known_sites, known_intervals)
    rargs = RecalArgs(
        mismatches_context_size=args.mismatches_context_size,
        indels_context_size=args.indels_context_size,
        low_quality_tail=args.low_quality_tail,
        maximum_cycle_value=args.maximum_cycle_value,
        quantizing_levels=args.quantizing_levels,
        enable_baq=args.enable_baq,
        baq_gop=args.bqsr_baq_gap_open_penalty,
    )

    n = 0
    eng = None
    for path in args.input:
        reader = bam.BamReader(path)
        if eng is None:
            idents, id_map = _read_group_identifiers(reader.header)
            eng = BaseRecalibrationEngine(idents, rargs, id_map)
        lengths = {s.name: s.length for s in reader.header.sequences}
        contig_cache = {}

        def ref_fetch_for(contig):
            if contig not in contig_cache:
                contig_cache.clear()  # keep one contig resident
                contig_cache[contig] = ref.fetch(contig, 0, lengths[contig])
            seq = contig_cache[contig]

            def fetch(s, e):
                return seq[s:e]

            return fetch

        if args.intervals:
            read_iter = (
                r
                for s in args.intervals
                for t in [iv.parse_interval(s, lengths)]
                for r in reader.query(t.contig, t.start, t.end)
            )
        else:
            read_iter = iter(reader)
        for read in read_iter:
            if not bqsr_read_filter(read):
                continue
            contig = reader.header.sequences[read.ref_id].name
            fetch = ref_fetch_for(contig)
            sites = known.overlapping(contig, read.pos + 1, read.end)
            eng.process_read(read, fetch, lengths[contig], sites)
            n += 1

    eng.finalize()
    eng.write_report(args.output)
    print(f"processed {n} reads; wrote {args.output}")
    return 0


@register_tool("ApplyBQSR")
def apply_bqsr(argv):
    """Apply a recalibration table to base qualities (pass 2 of BQSR)."""
    p = argparse.ArgumentParser(description="ApplyBQSR")
    p.add_argument("-I", "--input", action="append", required=True)
    p.add_argument("-R", "--reference", default=None)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("-L", "--intervals", action="append", default=None)
    p.add_argument("--bqsr-recal-file", "-bqsr", required=True)
    p.add_argument("--quantize-quals", type=int, default=0)
    p.add_argument("--preserve-qscores-less-than", type=int, default=6)
    p.add_argument("--global-qscore-prior", type=float, default=-1.0)
    p.add_argument("--allow-missing-read-groups", action="store_true")
    args = p.parse_args(argv)

    report = RecalibrationReport(args.bqsr_recal_file)
    n = 0
    for path in args.input:
        reader = bam.BamReader(path)
        _idents, id_map = _read_group_identifiers(reader.header)
        transformer = BQSRReadTransformer(
            report, quantization_levels=args.quantize_quals,
            global_q_score_prior=args.global_qscore_prior,
            preserve_q_less_than=args.preserve_qscores_less_than,
            allow_missing_read_groups=args.allow_missing_read_groups,
            rg_id_to_identifier=id_map,
        )
        writer = bam.BamWriter(args.output, reader.header)
        if args.intervals:
            lengths = {s.name: s.length for s in reader.header.sequences}
            read_iter = (
                r
                for s in args.intervals
                for t in [iv.parse_interval(s, lengths)]
                for r in reader.query(t.contig, t.start, t.end)
            )
        else:
            read_iter = iter(reader)
        for read in read_iter:
            if len(read.quals):  # unmapped reads are recalibrated too (ReadWalker)
                transformer.apply(read)
            writer.write(read)
            n += 1
        writer.close()
    print(f"wrote {n} reads to {args.output}")
    return 0


@register_tool("MarkDuplicates")
def mark_duplicates_tool(argv):
    """Mark duplicate reads (MarkDuplicatesSpark/Picard-compatible flags)."""
    p = argparse.ArgumentParser(description="MarkDuplicates")
    p.add_argument("-I", "--input", action="append", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("-M", "--metrics-file", default=None)
    p.add_argument("--do-not-mark-unmapped-mates", action="store_true")
    p.add_argument("--optical-duplicate-pixel-distance", type=int, default=100)
    args = p.parse_args(argv)

    from ..preprocessing import markdup

    n_dup_total = 0
    all_metrics = {}
    for path in args.input:
        reader = bam.BamReader(path)
        reads = list(reader)
        n_dup, _ = markdup.mark_duplicates(
            reads, reader.header, dont_mark_unmapped_mates=args.do_not_mark_unmapped_mates)
        n_dup_total += n_dup
        if args.metrics_file:
            for lib, m in markdup.collect_duplication_metrics(
                    reads, reader.header,
                    pixel_distance=args.optical_duplicate_pixel_distance).items():
                cur = all_metrics.get(lib)
                if cur is None:
                    all_metrics[lib] = m
                else:
                    for k, v in m.items():
                        if isinstance(v, int):
                            cur[k] += v
        writer = bam.BamWriter(args.output, reader.header)
        for r in reads:
            writer.write(r)
        writer.close()
    if args.metrics_file:
        # picard DuplicationMetrics layout
        from .metrics_tools import write_metrics_file

        cols = ["LIBRARY", "UNPAIRED_READS_EXAMINED", "READ_PAIRS_EXAMINED",
                "SECONDARY_OR_SUPPLEMENTARY_RDS", "UNMAPPED_READS",
                "UNPAIRED_READ_DUPLICATES", "READ_PAIR_DUPLICATES",
                "READ_PAIR_OPTICAL_DUPLICATES", "PERCENT_DUPLICATION",
                "ESTIMATED_LIBRARY_SIZE"]
        rows = []
        for lib in sorted(all_metrics):
            m = all_metrics[lib]
            rows.append([lib] + [m[c] if m.get(c) is not None else ""
                                 for c in cols[1:]])
        write_metrics_file(args.metrics_file, "MarkDuplicates",
                           "picard.sam.DuplicationMetrics", cols, rows)
    print(f"marked {n_dup_total} duplicates")
    return 0


@register_tool("GatherBQSRReports")
def gather_bqsr_reports(argv):
    """Gather scattered BQSR recalibration tables into one report
    (RecalibrationReport.gatherReportsOntoOneReport: RecalDatum.combine merges,
    quantization recomputed from the merged quality histogram)."""
    import argparse as _ap
    import gzip as _gzip

    from ..recal.report import (QuantizationInfo, RecalDatum, ReportTable,
                                java_round, render_report)

    p = _ap.ArgumentParser(description="GatherBQSRReports")
    p.add_argument("-I", "--input", action="append", required=True)
    p.add_argument("-O", "--output", required=True)
    args = p.parse_args(argv)

    from ..recal.report import parse_report

    def read_text(path):
        with open(path, "rb") as fh:
            raw = fh.read()
        if raw[:2] == b"\x1f\x8b":
            raw = _gzip.decompress(raw)
        return raw.decode()

    reports = [parse_report(read_text(path)) for path in args.input]
    by_name = [{t[0]: t for t in r} for r in reports]

    args_table = by_name[0]["Arguments"]
    quantizing_levels = int(dict(args_table[3])["quantizing_levels"])

    # merge RecalTable0 (full RecalDatum.combine semantics)
    t0 = {}
    for r in by_name:
        for row in r["RecalTable0"][3]:
            rg, ev, emp_q, est_q, obs, err = row
            d = RecalDatum(int(obs), float(err), float(est_q))
            key = (rg, ev)
            if key in t0:
                t0[key].combine(d)
            else:
                t0[key] = d

    # merge RecalTable1/RecalTable2 with RecalDatum.combine: the reported quality
    # is recomputed from expected errors, whose floating-point noise affects the
    # truncated prior offset in the empirical-quality MAP (matches GATK exactly)
    def merge_simple(name, key_idx, obs_idx, err_idx, qual_idx):
        out = {}
        for r in by_name:
            for row in r[name][3]:
                key = tuple(row[i] for i in key_idx)
                d = RecalDatum(int(row[obs_idx]), float(row[err_idx]), float(row[qual_idx]))
                if key in out:
                    out[key].combine(d)
                else:
                    out[key] = d
        return out

    t1 = merge_simple("RecalTable1", (0, 1, 2), 4, 5, 1)
    t2 = merge_simple("RecalTable2", (0, 1, 2, 3, 4), 6, 7, 1)

    # quantization histogram from the merged quality-score table
    hist = [0] * 94
    for (rg, q, ev), d in t1.items():
        hist[java_round(d.empirical_quality())] += d.num_observations
    qi = QuantizationInfo(hist, quantizing_levels)

    # render with the single-run table signatures (byte-faithful writer)
    arguments = ReportTable("Arguments", args_table[1],
                            [(c, f) for c, f in args_table[2]])
    for row in args_table[3]:
        arguments.add_row(*row)

    rt0 = ReportTable("RecalTable0", "", [
        ("ReadGroup", "%s"), ("EventType", "%s"), ("EmpiricalQuality", "%.4f"),
        ("EstimatedQReported", "%.4f"), ("Observations", "%d"), ("Errors", "%.2f")])
    for (rg, ev), d in sorted(t0.items()):
        rt0.add_row(rg, ev, d.empirical_quality(), d.reported_quality,
                    d.num_observations, d.num_mismatches)

    rt1 = ReportTable("RecalTable1", "", [
        ("ReadGroup", "%s"), ("QualityScore", "%d"), ("EventType", "%s"),
        ("EmpiricalQuality", "%.4f"), ("Observations", "%d"), ("Errors", "%.2f")])
    for (rg, q, ev), d in sorted(t1.items(), key=lambda kv: (kv[0][0], int(kv[0][1]), kv[0][2])):
        rt1.add_row(rg, int(q), ev, d.empirical_quality(), d.num_observations,
                    d.num_mismatches)

    rt2 = ReportTable("RecalTable2", "", [
        ("ReadGroup", "%s"), ("QualityScore", "%d"), ("CovariateValue", "%s"),
        ("CovariateName", "%s"), ("EventType", "%s"), ("EmpiricalQuality", "%.4f"),
        ("Observations", "%d"), ("Errors", "%.2f")])
    for (rg, q, cv, cn, ev), d in sorted(
            t2.items(), key=lambda kv: (kv[0][0], int(kv[0][1]), kv[0][2], kv[0][3], kv[0][4])):
        rt2.add_row(rg, int(q), cv, cn, ev, d.empirical_quality(),
                    d.num_observations, d.num_mismatches)

    with open(args.output, "w") as fh:
        fh.write(render_report([arguments, qi.report_table(), rt0, rt1, rt2]))
    print(f"gathered {len(args.input)} reports -> {args.output}")
    return 0


@register_tool("GatherTranches")
def gather_tranches(argv):
    """Gather scattered tranche files (sums counts per target sensitivity)."""
    import argparse as _ap

    from ..vqsr.tranches import Tranche, read_tranches, write_tranches

    p = _ap.ArgumentParser(description="GatherTranches")
    p.add_argument("-I", "--input", action="append", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("--mode", default="SNP")
    args = p.parse_args(argv)

    merged = {}
    for path in args.input:
        for t in read_tranches(path):
            key = t.target_truth_sensitivity
            if key in merged:
                m = merged[key]
                m.num_known += t.num_known
                m.num_novel += t.num_novel
                m.accessible_truth_sites += t.accessible_truth_sites
                m.calls_at_truth_sites += t.calls_at_truth_sites
                m.min_vqslod = min(m.min_vqslod, t.min_vqslod)
            else:
                merged[key] = Tranche(**t.__dict__)
    for t in merged.values():
        t.truth_sensitivity = (t.calls_at_truth_sites / t.accessible_truth_sites
                               if t.accessible_truth_sites else 0.0)
    write_tranches(args.output, list(merged.values()), args.mode)
    print(f"gathered {len(args.input)} tranche files -> {args.output}")
    return 0
