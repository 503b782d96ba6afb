# Copied verbatim from gatk_tpu/tools/mutect_tool.py; only import lines and the Mutect2 --device flag (mutect_tool.py:37-38) differ.
"""Mutect2 command line tool (tools/walkers/mutect/Mutect2.java equivalent)."""
from __future__ import annotations

import argparse

from ..cli import register_tool
from ..engine import intervals as iv
from ..io import bam, fasta, vcf
from ..mutect.engine import M2Args, Mutect2Engine
from .. import devices


@register_tool("Mutect2")
def mutect2(argv):
    """Call somatic SNVs and indels via local assembly of haplotypes."""
    p = argparse.ArgumentParser(description="Mutect2")
    p.add_argument("-I", "--input", action="append", required=True)
    p.add_argument("-R", "--reference", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("-L", "--intervals", action="append", default=None)
    p.add_argument("--tumor-sample", default=None)
    p.add_argument("--normal-sample", action="append", default=[])
    p.add_argument("--mitochondria-mode", action="store_true")
    p.add_argument("--tumor-lod-to-emit", "--emit-lod", type=float, default=None)
    p.add_argument("--initial-tumor-lod", type=float, default=None)
    p.add_argument("--min-AF", "--minimum-allele-fraction", type=float, default=0.0)
    p.add_argument("--max-reads-per-alignment-start", type=int, default=50)
    p.add_argument("--f1r2-tar-gz", default=None,
                   help="collect F1R2 counts while calling (for LearnReadOrientationModel)")
    p.add_argument("--germline-resource", default=None,
                   help="population VCF with AF (e.g. gnomAD); drives POPAF. "
                        "Indexed (.tbi) resources are queried per site, never "
                        "fully decompressed")
    p.add_argument("--af-of-alleles-not-in-resource", "--default-af",
                   dest="default_af", type=float, default=-1.0)
    p.add_argument("--dont-clip-ITR-artifacts", dest="dont_clip_itr_artifacts",
                   action="store_true",
                   help="disable palindrome-artifact read clipping")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the PairHMM runs: the CUDA kernel, or its plain "
                        "PyTorch version on the host")
    args = p.parse_args(argv)
    devices.set_default_device(args.device)

    m2args = M2Args(
        mitochondria_mode=args.mitochondria_mode,
        min_af=args.min_AF,
        max_reads_per_alignment_start=args.max_reads_per_alignment_start,
        dont_clip_itr_artifacts=args.dont_clip_itr_artifacts,
    )
    if args.tumor_lod_to_emit is not None:
        m2args.emission_log10_odds = args.tumor_lod_to_emit
    if args.initial_tumor_lod is not None:
        m2args.initial_log10_odds = args.initial_tumor_lod

    ref = fasta.FastaReference(args.reference)
    from ..io.cram import open_reads
    reader = open_reads(args.input[0], reference=ref)
    lengths = {s.name: s.length for s in reader.header.sequences}
    sample = args.tumor_sample
    if sample is None:
        for rg in reader.header.read_groups:
            if rg.get("SM"):
                sample = rg["SM"]
                break
        sample = sample or "SAMPLE"

    eng = Mutect2Engine(ref, tumor_sample=sample, normal_samples=args.normal_sample, args=m2args)
    if args.germline_resource:
        from ..mutect.engine import make_germline_af_lookup
        # M2ArgumentCollection.getDefaultAlleleFrequency :164-166
        default_af = args.default_af if args.default_af >= 0 else (
            4e-3 if args.mitochondria_mode else
            (1e-6 if args.normal_sample else 5e-8))
        eng.germline_af = make_germline_af_lookup(args.germline_resource, default_af)

    if args.intervals:
        targets = iv.parse_intervals_arg(args.intervals, lengths)
    else:
        targets = [iv.Interval(s.name, 0, s.length) for s in reader.header.sequences]

    f1r2_counts = None
    if args.f1r2_tar_gz:
        from ..mutect import orientation as ob
        f1r2_counts = ob.F1R2Counts(sample)

    from ..engine.progress import ProgressMeter
    pm = ProgressMeter("Mutect2", unit="variants").start()
    all_variants = []
    callable_sites = 0
    for t in targets:
        reads = list(reader.query(t.contig, max(0, t.start - 300), min(lengths[t.contig], t.end + 300)))
        found = eng.call_interval(reads, t)
        all_variants.extend(found)
        pm.update(f"{t.contig}:{t.end}", n=len(found))
        callable_sites += eng.count_callable_sites(reads, t)
        if f1r2_counts is not None:
            from ..mutect.engine import m2_read_filter
            ref_bytes = ref.fetch(t.contig, t.start, t.end)
            ob.collect_f1r2_counts([r for r in reads if m2_read_filter(r)],
                                   ref_bytes, t.start, f1r2_counts)

    if f1r2_counts is not None:
        from ..mutect import orientation as ob
        ob.write_f1r2_targz(f1r2_counts, args.f1r2_tar_gz)

    pm.stop()
    all_variants.sort(key=lambda v: (v.contig, v.pos))
    header_lines = [
        '##INFO=<ID=DP,Number=1,Type=Integer,Description="Approximate read depth">',
        '##INFO=<ID=ECNT,Number=1,Type=Integer,Description="Number of events in this haplotype">',
        '##INFO=<ID=ECNTH,Number=A,Type=Integer,Description="Number of events in the best supporting haplotype for each alt allele">',
        '##INFO=<ID=TLOD,Number=A,Type=Float,Description="Log 10 likelihood ratio score of variant existing versus not existing">',
        '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
        '##FORMAT=<ID=AD,Number=R,Type=Integer,Description="Allelic depths">',
        '##FORMAT=<ID=AF,Number=A,Type=Float,Description="Allele fractions of alternate alleles">',
        '##FORMAT=<ID=DP,Number=1,Type=Integer,Description="Approximate read depth">',
        '##FORMAT=<ID=F1R2,Number=R,Type=Integer,Description="Count of reads in F1R2 pair orientation supporting each allele">',
        '##FORMAT=<ID=F2R1,Number=R,Type=Integer,Description="Count of reads in F2R1 pair orientation supporting each allele">',
        f"##tumor_sample={sample}",
    ]
    w = vcf.VcfWriter(args.output, [sample],
                      contigs=[(s.name, s.length) for s in reader.header.sequences],
                      extra_header_lines=header_lines)
    for v in all_variants:
        w.write(v)
    w.close()
    # stats sidecar (MutectStats.java format; consumed by FilterMutectCalls /
    # MergeMutectStats — cf. mutect/mito/unfiltered.vcf.stats golden)
    with open(args.output + ".stats", "w") as fh:
        fh.write("statistic\tvalue\n")
        fh.write(f"callable\t{callable_sites}\n")
    print(f"wrote {len(all_variants)} variants to {args.output}")
    return 0


@register_tool("FilterMutectCalls")
def filter_mutect_calls(argv):
    """Filter somatic SNVs and indels called by Mutect2.

    Reference: mutect/filtering/FilterMutectCalls.java — 2 learning passes,
    a threshold pass, and a final apply pass over the full probabilistic
    filter roster with the learned somatic clustering model.
    """
    import argparse as _ap

    from ..io import vcf as vcfio
    from ..mutect.filtering import (
        M2FilterArgs, MUTECT_FILTER_HEADER_LINES, ThresholdCalculator,
        read_mutect_stats, run_filter_mutect_calls)

    p = _ap.ArgumentParser(description="FilterMutectCalls")
    p.add_argument("-V", "--variant", required=True)
    p.add_argument("-R", "--reference", default=None)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("--stats", default=None, help="Mutect2 stats file (default <vcf>.stats)")
    p.add_argument("--filtering-stats", default=None)
    p.add_argument("--mitochondria-mode", action="store_true")
    p.add_argument("--microbial-mode", action="store_true")
    p.add_argument("--threshold-strategy", default="OPTIMAL_F_SCORE",
                   choices=["CONSTANT", "FALSE_DISCOVERY_RATE", "OPTIMAL_F_SCORE"])
    p.add_argument("--f-score-beta", type=float, default=1.0)
    p.add_argument("--false-discovery-rate", type=float, default=0.05)
    p.add_argument("--initial-threshold", type=float, default=0.1)
    p.add_argument("--min-median-base-quality", type=int, default=20)
    p.add_argument("--min-median-mapping-quality", type=int, default=-1)
    p.add_argument("--min-median-read-position", type=int, default=1)
    p.add_argument("--max-events-in-region", type=int, default=3)
    p.add_argument("--max-events-in-haplotype", type=int, default=2)
    p.add_argument("--max-alt-allele-count", type=int, default=1)
    p.add_argument("--unique-alt-read-count", type=int, default=0)
    p.add_argument("--max-median-fragment-length-difference", type=int, default=10000)
    p.add_argument("--max-n-ratio", type=float, default=float("inf"))
    p.add_argument("--min-reads-per-strand", type=int, default=0)
    p.add_argument("--min-allele-fraction", type=float, default=0.0)
    p.add_argument("--min-slippage-length", type=int, default=8)
    p.add_argument("--pcr-slippage-rate", type=float, default=0.1)
    p.add_argument("--distance-on-haplotype", type=int, default=100)
    p.add_argument("--long-indel-length", type=int, default=5)
    p.add_argument("--normal-p-value-threshold", type=float, default=0.001)
    p.add_argument("--log-snv-prior", type=float, default=None)
    p.add_argument("--log-indel-prior", type=float, default=None)
    p.add_argument("--contamination-table", action="append", default=[])
    p.add_argument("--contamination-estimate", type=float, default=0.0)
    p.add_argument("--tumor-segmentation", action="append", default=[])
    p.add_argument("--orientation-bias-artifact-priors", "--ob-priors", action="append",
                   default=[], help="tar.gz of artifact priors from LearnReadOrientationModel")
    args = p.parse_args(argv)

    orientation_priors = {}
    for path in args.orientation_bias_artifact_priors:
        from ..mutect.orientation import read_artifact_priors_targz
        orientation_priors.update(read_artifact_priors_targz(path))
    reference = None
    if orientation_priors:
        if args.reference is None:
            raise SystemExit("--ob-priors requires -R/--reference for context lookup")
        from ..io import fasta
        reference = fasta.FastaReference(args.reference)

    contamination_by_sample = {}
    for path in args.contamination_table:
        with open(path) as fh:
            header = fh.readline().rstrip("\n").split("\t")
            for line in fh:
                parts = line.rstrip("\n").split("\t")
                if len(parts) >= 2:
                    contamination_by_sample[parts[0]] = float(parts[1])

    tumor_segments = {}
    for path in args.tumor_segmentation:
        sample = None
        segs = []
        with open(path) as fh:
            cols = None
            for line in fh:
                if line.startswith("#<METADATA>SAMPLE="):
                    sample = line.rstrip("\n").split("=", 1)[1]
                elif line.startswith("#"):
                    continue
                elif cols is None:
                    cols = line.rstrip("\n").split("\t")
                else:
                    parts = line.rstrip("\n").split("\t")
                    row = dict(zip(cols, parts))
                    segs.append((row.get("contig", row.get("CONTIG")),
                                 int(row.get("start", row.get("START", 0))),
                                 int(row.get("end", row.get("END", 0))),
                                 float(row.get("minor_allele_fraction",
                                               row.get("MINOR_ALLELE_FRACTION", 0.5)))))
        if sample:
            tumor_segments[sample] = segs

    reader = vcfio.VcfReader(args.variant)
    variants = list(reader)
    normal_samples = {line.split("=", 1)[1].strip()
                      for line in reader.header_lines if line.startswith("##normal_sample=")}

    stats_path = args.stats or (args.variant + ".stats")
    stats = read_mutect_stats(stats_path)
    callable_sites = stats.get("callable")

    import math as _math
    filter_args = M2FilterArgs(
        threshold_strategy=args.threshold_strategy,
        f_score_beta=args.f_score_beta,
        max_false_discovery_rate=args.false_discovery_rate,
        initial_threshold=args.initial_threshold,
        mitochondria=args.mitochondria_mode,
        microbial=args.microbial_mode,
        max_events_in_region=args.max_events_in_region,
        max_events_in_haplotype=args.max_events_in_haplotype,
        max_alt_alleles=args.max_alt_allele_count,
        unique_alt_read_count=args.unique_alt_read_count,
        min_median_mapping_quality=args.min_median_mapping_quality,
        min_median_base_quality=args.min_median_base_quality,
        max_median_fragment_length_difference=args.max_median_fragment_length_difference,
        min_median_read_position=args.min_median_read_position,
        max_n_ratio=args.max_n_ratio,
        min_reads_on_each_strand=args.min_reads_per_strand,
        min_af=args.min_allele_fraction,
        normal_p_value_threshold=args.normal_p_value_threshold,
        min_slippage_length=args.min_slippage_length,
        slippage_rate=args.pcr_slippage_rate,
        max_distance_to_filtered_call_on_same_haplotype=args.distance_on_haplotype,
        long_indel_length=args.long_indel_length,
        contamination_estimate=args.contamination_estimate,
        contamination_by_sample=contamination_by_sample,
        tumor_segments=tumor_segments,
        orientation_priors=orientation_priors,
        reference=reference,
    )
    if args.log_snv_prior is not None:
        filter_args.log_snv_prior = args.log_snv_prior
    if args.log_indel_prior is not None:
        filter_args.log_indel_prior = args.log_indel_prior

    filtering_stats = args.filtering_stats or (args.output + ".filteringStats.tsv")
    n_pass, n_filt, _ = run_filter_mutect_calls(
        variants, filter_args, reader.samples, normal_samples,
        callable_sites=callable_sites, filtering_stats_path=filtering_stats)

    w = vcfio.VcfWriter(args.output, reader.samples,
                        extra_header_lines=reader.header_lines + MUTECT_FILTER_HEADER_LINES)
    for v in variants:
        w.write(v)
    w.close()
    print(f"{n_pass} passing, {n_filt} filtered -> {args.output}")
    return 0


@register_tool("GetPileupSummaries")
def get_pileup_summaries(argv):
    """Tabulate pileup counts at common biallelic SNP sites."""
    import argparse as _ap

    import numpy as np

    from ..engine import pileup as pileup_mod
    from ..mutect.contamination import PileupSite, write_pileup_table

    p = _ap.ArgumentParser(description="GetPileupSummaries")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-V", "--variant", required=True, help="population VCF with AF")
    p.add_argument("-L", "--intervals", action="append", default=None)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("--minimum-population-allele-frequency", type=float, default=0.01)
    p.add_argument("--maximum-population-allele-frequency", type=float, default=0.2)
    args = p.parse_args(argv)

    from ..io import bam as bamio, vcf as vcfio

    reader = bamio.BamReader(args.input)
    sample = reader.header.read_groups[0].get("SM", "SAMPLE") if reader.header.read_groups else "SAMPLE"
    lengths = {s.name: s.length for s in reader.header.sequences}
    intervals = (iv.parse_intervals_arg(args.intervals, lengths)
                 if args.intervals else None)
    sites = []
    for v in vcfio.iter_vcf_features(args.variant, intervals):
        if len(v.alts) != 1 or not v.is_snp():
            continue
        af = v.info.get("AF")
        if af is None:
            continue
        af = float(str(af).split(",")[0])
        if not (args.minimum_population_allele_frequency <= af <= args.maximum_population_allele_frequency):
            continue
        ref_b = ord(v.ref)
        alt_b = ord(v.alts[0])
        refs = alts = others = 0
        for r in reader.query(v.contig, v.pos, v.pos + 1):
            if r.is_unmapped or r.is_duplicate or r.is_secondary or r.mapq < 50:
                continue
            pos, base, qual, flags = pileup_mod.expand_read(r)
            here = pos == v.pos
            if not here.any():
                continue
            i = int(np.nonzero(here)[0][0])
            if flags[i] & pileup_mod.F_DELETION or qual[i] < 10:
                continue
            b = int(base[i])
            if b == ref_b:
                refs += 1
            elif b == alt_b:
                alts += 1
            else:
                others += 1
        sites.append(PileupSite(v.contig, v.pos + 1, refs, alts, others, af))
    write_pileup_table(args.output, sample, sites)
    print(f"wrote {len(sites)} pileup summaries")
    return 0


@register_tool("CalculateContamination")
def calculate_contamination_tool(argv):
    """Estimate cross-sample contamination from pileup summaries."""
    import argparse as _ap

    from ..mutect.contamination import calculate_contamination, read_pileup_table

    p = _ap.ArgumentParser(description="CalculateContamination")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("--matched-normal", default=None)
    args = p.parse_args(argv)

    sample, sites = read_pileup_table(args.input)
    c, se = calculate_contamination(sites)
    with open(args.output, "w") as fh:
        fh.write("sample\tcontamination\terror\n")
        fh.write(f"{sample}\t{c}\t{se}\n")
    print(f"{sample}: contamination {c:.4f} +/- {se:.4f}")
    return 0


@register_tool("CollectF1R2Counts")
def collect_f1r2_counts_tool(argv):
    """Collect F1R2 read counts for the read-orientation artifact model."""
    import argparse as _ap

    from ..engine import intervals as ivx
    from ..io import bam as bamio, fasta as fastaio
    from ..mutect import orientation as ob
    from ..mutect.engine import m2_read_filter

    p = _ap.ArgumentParser(description="CollectF1R2Counts")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-R", "--reference", required=True)
    p.add_argument("-O", "--output", required=True, help="output .tar.gz")
    p.add_argument("-L", "--intervals", action="append", default=None)
    p.add_argument("--f1r2-min-bq", type=int, default=20)
    p.add_argument("--f1r2-median-mq", type=int, default=50)
    p.add_argument("--f1r2-max-depth", type=int, default=ob.DEFAULT_MAX_DEPTH)
    args = p.parse_args(argv)

    ref = fastaio.FastaReference(args.reference)
    reader = bamio.BamReader(args.input)
    lengths = {s.name: s.length for s in reader.header.sequences}
    sample = "SAMPLE"
    for rg in reader.header.read_groups:
        if rg.get("SM"):
            sample = rg["SM"]
            break

    if args.intervals:
        targets = [ivx.parse_interval(s, lengths) for s in args.intervals]
    else:
        targets = [ivx.Interval(s.name, 0, s.length) for s in reader.header.sequences]

    counts = ob.F1R2Counts(sample, args.f1r2_max_depth)
    for t in targets:
        reads = [r for r in reader.query(t.contig, t.start, t.end) if m2_read_filter(r)]
        ref_bytes = ref.fetch(t.contig, t.start, t.end)
        ob.collect_f1r2_counts(reads, ref_bytes, t.start, counts,
                               min_bq=args.f1r2_min_bq, min_median_mq=args.f1r2_median_mq)
    ob.write_f1r2_targz(counts, args.output)
    print(f"collected F1R2 counts over {len(targets)} intervals -> {args.output}")
    return 0


@register_tool("LearnReadOrientationModel")
def learn_read_orientation_model_tool(argv):
    """Learn artifact-prior probabilities for the orientation bias mixture model."""
    import argparse as _ap

    from ..mutect import orientation as ob

    p = _ap.ArgumentParser(description="LearnReadOrientationModel")
    p.add_argument("-I", "--input", action="append", required=True,
                   help="one or more CollectF1R2Counts .tar.gz")
    p.add_argument("-O", "--output", required=True, help="output .tar.gz of priors")
    p.add_argument("--convergence-threshold", type=float, default=ob.DEFAULT_CONVERGENCE_THRESHOLD)
    p.add_argument("--num-em-iterations", type=int, default=ob.DEFAULT_MAX_EM_ITERATIONS)
    p.add_argument("--max-depth", type=int, default=ob.DEFAULT_MAX_DEPTH)
    args = p.parse_args(argv)

    merged = {}
    for path in args.input:
        for sample, counts in ob.read_f1r2_targz(path, args.max_depth).items():
            if sample in merged:
                merged[sample].add(counts)
            else:
                merged[sample] = counts

    collections = [ob.learn_artifact_priors(c, args.convergence_threshold,
                                            args.num_em_iterations)
                   for c in merged.values()]
    ob.write_artifact_priors_targz(collections, args.output)
    for coll in collections:
        print(f"{coll.sample}: learned priors for {coll.num_unique_contexts()} unique contexts")
    return 0


@register_tool("MergeMutectStats")
def merge_mutect_stats(argv):
    """Merge the stats output by scatters of a single Mutect2 job.

    Reference: mutect/MergeMutectStats.java — 'callable' aggregates by sum.
    """
    p = argparse.ArgumentParser(description="MergeMutectStats")
    p.add_argument("--stats", action="append", required=True)
    p.add_argument("-O", "--output", required=True)
    args = p.parse_args(argv)

    from ..mutect.filtering import read_mutect_stats

    totals: dict[str, float] = {}
    for path in args.stats:
        for key, value in read_mutect_stats(path).items():
            totals[key] = totals.get(key, 0.0) + value
    with open(args.output, "w") as fh:
        fh.write("statistic\tvalue\n")
        for key, value in totals.items():
            fh.write(f"{key}\t{value:.1f}\n" if value != int(value) else f"{key}\t{int(value)}\n")
    print(f"merged {len(args.stats)} stats files -> {args.output}")
    return 0


@register_tool("CreateSomaticPanelOfNormals")
def create_somatic_panel_of_normals(argv):
    """Make a panel of normals (PoN) for use with Mutect2.

    Reference: mutect/CreateSomaticPanelOfNormals.java — collate sites with
    artifacts (germline probability < --max-germline-probability) in at least
    --min-sample-count normals into a sites-only VCF with FRACTION and a
    fitted beta shape (fitBeta, :205-230).
    """
    import math as _math

    import numpy as np

    from ..mutect.filtering import beta_binomial_log_prob, binomial_prob

    p = argparse.ArgumentParser(description="CreateSomaticPanelOfNormals")
    p.add_argument("-V", "--variant", action="append", required=True,
                   help="normal-sample Mutect2 tumor-only VCFs (repeatable)")
    p.add_argument("-O", "--output", required=True)
    p.add_argument("--min-sample-count", type=int, default=2)
    p.add_argument("--germline-resource", default=None)
    p.add_argument("--max-germline-probability", type=float, default=0.5)
    args = p.parse_args(argv)

    ARTIFACT_PRIOR = 0.001
    ARTIFACT_ALPHA, ARTIFACT_BETA = 1.0, 7.0
    NEGLIGIBLE_AF = 1.0e-8

    germline_af = {}
    if args.germline_resource:
        for v in vcf.VcfReader(args.germline_resource):
            af = v.info.get("AF")
            if af is not None:
                germline_af[(v.contig, v.pos, v.ref)] = sum(
                    float(x) for x in str(af).split(",") if x not in ("", "."))

    def germline_probability(af, alt, total):
        if af < NEGLIGIBLE_AF or af > 1:
            return 0.0
        het_prior = 2 * af * (1 - af)
        hom_prior = af * af
        het_lik = binomial_prob(total, alt, 0.5)
        hom_lik = binomial_prob(total, alt, 0.98)
        artifact_lik = _math.exp(float(beta_binomial_log_prob(
            ARTIFACT_ALPHA, ARTIFACT_BETA, total, alt)))
        germ = het_prior * het_lik + hom_prior * hom_lik
        art = ARTIFACT_PRIOR * artifact_lik
        return germ / (germ + art) if germ + art > 0 else 0.0

    # gather genotype AD data per site across all normals
    sites: dict[tuple, dict] = {}
    contigs = None
    sample_names = []
    for path in args.variant:
        reader = vcf.VcfReader(path)
        sample_names.extend(reader.samples or ["NORMAL"])
        for v in reader:
            if not v.alts or (len(v.alts) == 1 and v.alts[0] == "*"):
                continue
            key = (v.contig, v.pos, v.ref)
            entry = sites.setdefault(key, {"alts": v.alts, "genotypes": []})
            if len(v.alts) > len(entry["alts"]):
                entry["alts"] = v.alts
            for s in v.samples:
                ad = s.get("AD")
                if ad not in (None, "."):
                    entry["genotypes"].append([int(x) for x in ad.split(",")])

    n_samples = max(len(args.variant), 1)

    def fit_beta(alt_ref_counts):
        total_alt = sum(a for a, _ in alt_ref_counts)
        total_ref = sum(r for _, r in alt_ref_counts)
        mn = min(total_alt, total_ref)
        base_alpha = (total_alt + 1.0) / (mn + 1)
        base_beta = (total_ref + 1.0) / (mn + 1)
        scales = np.geomspace(0.5, 1000.0, 40)
        best_s, best_ll = 1.0, -_math.inf
        for s in scales:
            ll = sum(float(beta_binomial_log_prob(base_alpha * s, base_beta * s, a + r, a))
                     for a, r in alt_ref_counts)
            if ll > best_ll:
                best_s, best_ll = s, ll
        return base_alpha * best_s, base_beta * best_s

    records = []
    for (contig, pos, ref), entry in sorted(sites.items()):
        gts = entry["genotypes"]
        af = germline_af.get((contig, pos, ref), 0.0)
        multi = len(entry["alts"]) > 1
        variant_gts = []
        for ad in gts:
            alt = sum(ad[1:])
            if multi:
                variant_gts.append(ad)
            elif alt > 0 and germline_probability(af, alt, sum(ad)) < args.max_germline_probability:
                variant_gts.append(ad)
        if len(variant_gts) < args.min_sample_count:
            continue
        fraction = len(variant_gts) / n_samples
        counts = [(sum(ad[1:]), ad[0]) for ad in variant_gts]
        alpha, beta = fit_beta(counts)
        records.append(vcf.Variant(
            contig=contig, pos=pos, ref=ref, alts=entry["alts"], qual=None,
            filters=(), info={"FRACTION": f"{fraction:.3f}",
                              "BETA": f"{alpha:.2f},{beta:.2f}"}))

    header = [
        '##INFO=<ID=FRACTION,Number=1,Type=Float,Description="Fraction of samples exhibiting artifact">',
        '##INFO=<ID=BETA,Number=2,Type=Float,Description="Beta distribution parameters to fit artifact allele fractions">',
    ] + [f"##normal_sample={s}" for s in sample_names]
    w = vcf.VcfWriter(args.output, [], extra_header_lines=header, write_format=False)
    for rec in records:
        w.write(rec)
    w.close()
    print(f"panel of normals: {len(records)} sites from {n_samples} normals -> {args.output}")
    return 0


def _merge_as_filter(v, applied, filter_name):
    """AlleleFilterUtils.getMergedASFilterString: append filter_name to each
    failing allele's AS_FilterStatus entry."""
    existing = str(v.info.get("AS_FilterStatus", "")).split("|") if v.info.get("AS_FilterStatus") else ["SITE"] * len(v.alts)
    while len(existing) < len(v.alts):
        existing.append("SITE")
    out = []
    for i in range(len(v.alts)):
        entry = existing[i]
        if i < len(applied) and applied[i]:
            parts = [p for p in entry.split(",") if p not in ("SITE", "PASS", "")]
            parts.append(filter_name)
            entry = ",".join(parts)
        out.append(entry)
    return "|".join(out)


@register_tool("NuMTFilterTool")
def numt_filter_tool(argv):
    """Filter mitochondrial alleles whose depth is consistent with a nuclear
    NuMT copy (mutect/filtering/NuMTFilterTool.java: Poisson cutoff from the
    median autosomal coverage)."""
    from scipy.stats import poisson

    from ..io import vcf as vcfio

    p = argparse.ArgumentParser(description="NuMTFilterTool")
    p.add_argument("-V", "--variant", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("--autosomal-coverage", type=float, default=0.0)
    p.add_argument("--max-numt-autosomal-copies", type=float, default=4.0)
    args = p.parse_args(argv)

    cutoff = 0
    if args.autosomal_coverage > 0 and args.max_numt_autosomal_copies > 0:
        lam = args.autosomal_coverage * args.max_numt_autosomal_copies / 2.0
        cutoff = int(poisson.ppf(1 - 0.01, lam))

    reader = vcfio.VcfReader(args.variant)
    variants = list(reader)
    n_filtered = 0
    for v in variants:
        ads = [0] * len(v.alts)
        for s in v.samples:
            raw = s.get("AD")
            if raw in (None, "."):
                continue
            vals = [int(x) for x in raw.split(",")]
            for i in range(min(len(v.alts), len(vals) - 1)):
                ads[i] = max(ads[i], vals[i + 1])
        applied = [d < cutoff for d in ads]
        if applied and all(applied):
            v.filters = tuple(sorted(set(v.filters) - {"PASS", "."} | {"possible_numt"}))
            n_filtered += 1
        if any(applied):
            v.info["AS_FilterStatus"] = _merge_as_filter(v, applied, "possible_numt")
    header = ['##FILTER=<ID=possible_numt,Description="Alt depth is below expected coverage of NuMT in autosome">']
    w = vcfio.VcfWriter(args.output, reader.samples,
                        extra_header_lines=reader.header_lines + header)
    for v in variants:
        w.write(v)
    w.close()
    print(f"{n_filtered} sites flagged possible_numt -> {args.output}")
    return 0


@register_tool("MTLowHeteroplasmyFilterTool")
def mt_low_heteroplasmy_filter_tool(argv):
    """Two-pass filter: if more than --max-allowed-low-hets unfiltered low-
    heteroplasmy sites exist, filter all of them
    (mutect/filtering/MTLowHeteroplasmyFilterTool.java)."""
    from ..io import vcf as vcfio

    p = argparse.ArgumentParser(description="MTLowHeteroplasmyFilterTool")
    p.add_argument("-V", "--variant", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("--max-allowed-low-hets", type=int, default=3)
    p.add_argument("--low-het-threshold", type=float, default=0.1)
    args = p.parse_args(argv)

    reader = vcfio.VcfReader(args.variant)
    variants = list(reader)

    def allele_afs(v):
        afs = [0.0] * len(v.alts)
        for s in v.samples:
            raw = s.get("AF")
            if raw in (None, "."):
                continue
            vals = [float(x) for x in raw.split(",")]
            for i in range(min(len(afs), len(vals))):
                afs[i] = max(afs[i], vals[i])
        return afs

    low_het_sites = sum(
        1 for v in variants
        if v.filters in ((), ("PASS",)) and max(allele_afs(v), default=0.0) < args.low_het_threshold)
    failed = low_het_sites > args.max_allowed_low_hets
    n_filtered = 0
    if failed:
        for v in variants:
            applied = [af < args.low_het_threshold for af in allele_afs(v)]
            if applied and all(applied):
                v.filters = tuple(sorted(set(v.filters) - {"PASS", "."} | {"mt_many_low_hets"}))
                n_filtered += 1
            if any(applied):
                v.info["AS_FilterStatus"] = _merge_as_filter(v, applied, "mt_many_low_hets")
    header = ['##FILTER=<ID=mt_many_low_hets,Description="Low heteroplasmy sites are filtered when at least x low het sites pass all other filters">']
    w = vcfio.VcfWriter(args.output, reader.samples,
                        extra_header_lines=reader.header_lines + header)
    for v in variants:
        w.write(v)
    w.close()
    print(f"{low_het_sites} low-het sites, {n_filtered} filtered -> {args.output}")
    return 0


@register_tool("GetNormalArtifactData")
def get_normal_artifact_data(argv):
    """Collect normal-artifact training data per locus
    (mutect/GetNormalArtifactData.java: at each pileup locus, the best normal
    non-ref allele's counts in normal and tumor, p-value-based downsampling,
    NormalArtifactRecord table columns normal_alt/normal_dp/tumor_alt/
    tumor_dp/downsampling/type)."""
    import numpy as np

    from ..engine import pileup as pileup_mod
    from ..engine.intervals import Interval, parse_interval
    from ..mutect.engine import m2_read_filter
    from ..mutect.filtering import binomial_prob
    from ..utils.javarandom import get_random_generator

    p = argparse.ArgumentParser(description="GetNormalArtifactData")
    p.add_argument("-I", "--input", action="append", required=True)
    p.add_argument("-R", "--reference", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("-L", "--intervals", action="append", default=None)
    p.add_argument("--normal-sample", action="append", required=True)
    p.add_argument("--error-prob", type=float, default=0.001)
    args = p.parse_args(argv)

    ref = fasta.FastaReference(args.reference)
    from ..io.cram import open_reads
    readers = [open_reads(path, reference=ref) for path in args.input]
    normal_samples = set(args.normal_sample)

    def sample_of(reader):
        for rg in reader.header.read_groups:
            if rg.get("SM"):
                return rg["SM"]
        return "SAMPLE"

    lengths = {s.name: s.length for s in readers[0].header.sequences}
    targets = ([parse_interval(s, lengths) for s in args.intervals]
               if args.intervals else
               [Interval(n, 0, l) for n, l in lengths.items()])

    rng = get_random_generator()
    base_order = b"ACGT"
    rows = []
    for t in targets:
        # per-position base counts for normal and tumor pools
        span = t.end - t.start
        counts = {True: np.zeros((span, 5), np.int64),
                  False: np.zeros((span, 5), np.int64)}
        for reader in readers:
            is_normal = sample_of(reader) in normal_samples
            for r in reader.query(t.contig, t.start, t.end):
                if not m2_read_filter(r):
                    continue
                pos, base, qual, _flags = pileup_mod.expand_read(r)
                sel = (pos >= t.start) & (pos < t.end)
                for pp, bb in zip(pos[sel], base[sel]):
                    bi = base_order.find(bb)
                    counts[is_normal][pp - t.start, bi if bi >= 0 else 4] += 1
        ref_bases = ref.fetch_bytes(t.contig, t.start, t.end).upper()
        normal, tumor = counts[True], counts[False]
        for i in range(span):
            n_depth = int(normal[i].sum())
            if n_depth == 0:
                continue
            ref_i = base_order.find(ref_bases[i:i + 1])
            non_ref = [b for b in range(4) if b != ref_i]
            best = max(non_ref, key=lambda b: normal[i, b])
            n_alt = int(normal[i, best])
            if n_alt == 0 or n_alt > 0.2 * n_depth:
                continue
            t_depth = int(tumor[i].sum())
            t_alt = int(tumor[i, best])
            p_val = 1.0 - sum(binomial_prob(t_depth, k, args.error_prob)
                              for k in range(t_alt))
            downsample = max(1.0 - p_val, 0.05)
            if rng.next_double() > downsample:
                continue
            if t_alt > 0.5 * max(t_depth, 1):
                continue
            rows.append((n_alt, n_depth, t_alt, t_depth, downsample, "SNV"))

    with open(args.output, "w") as fh:
        fh.write("normal_alt\tnormal_dp\ttumor_alt\ttumor_dp\tdownsampling\ttype\n")
        for row in rows:
            fh.write(f"{row[0]}\t{row[1]}\t{row[2]}\t{row[3]}\t{row[4]:.3f}\t{row[5]}\n")
    print(f"{len(rows)} normal artifact records -> {args.output}")
    return 0


@register_tool("GatherNormalArtifactData")
def gather_normal_artifact_data(argv):
    """Concatenate per-shard GetNormalArtifactData tables
    (mutect/GatherNormalArtifactData.java: header from the first table, data
    rows from all, in argument order)."""
    p = argparse.ArgumentParser(description="GatherNormalArtifactData")
    p.add_argument("-I", "--input", action="append", required=True)
    p.add_argument("-O", "--output", required=True)
    args = p.parse_args(argv)
    n = 0
    with open(args.output, "w") as out:
        for i, path in enumerate(args.input):
            with open(path) as fh:
                header = fh.readline()
                if i == 0:
                    out.write(header)
                for line in fh:
                    out.write(line)
                    n += 1
    print(f"gathered {n} normal artifact records from {len(args.input)} tables")
    return 0
