# Copied verbatim from gatk_tpu/tools/varianteval_tool.py; only import lines may differ.
"""VariantEval: callset evaluation report (stratifiers x evaluators).

Reference behavior: tools/walkers/varianteval/VariantEval.java +
VariantEvalEngine.java — evaluation modules (-EV) over the cartesian product of
stratification states (-ST), with Novelty standard; output is a GATKReport of
one table per evaluation module (VariantEvalReportWriter.java).
"""
from __future__ import annotations

import argparse
import os

from ..cli import UserError, register_tool
from ..vareval import evaluators as ev_mod
from ..vareval import stratifiers as st_mod
from ..vareval.framework import EvalContext, StratificationManager, classify, sample_genotypes


def _load_track(paths):
    """(contig, pos) -> list of Variants for comp/dbsnp resources. Each
    variant gets its source VCF's sample names attached (the comp-genotype
    subsetting in ValidationReport.update2 needs them)."""
    from ..io import vcf as vcfio

    track: dict = {}
    for path in paths:
        names = vcfio.VcfReader(path).samples if path.endswith((".vcf", ".vcf.gz")) else []
        for rv in vcfio.iter_vcf_features(path):
            rv.sample_names = names
            track.setdefault((rv.contig, rv.pos), []).append(rv)
    return track


def _subset_comp(comp, eval_samples):
    """ValidationReport.update2 doSubset: when the comp has genotypes for all
    the eval samples, classify the comp over that subset only."""
    names = getattr(comp, "sample_names", None)
    if (comp is None or not comp.samples or not eval_samples or not names
            or not all(s in names for s in eval_samples)):
        return comp
    import copy

    idx = [names.index(s) for s in eval_samples]
    sub = copy.copy(comp)
    sub.samples = [comp.samples[i] for i in idx]
    sub.sample_names = list(eval_samples)
    return sub


@register_tool("VariantEval")
def variant_eval(argv):
    """Evaluate callsets with composable stratifiers x evaluators."""
    from ..io import vcf as vcfio
    from ..recal.report import ReportTable

    p = argparse.ArgumentParser(description="VariantEval")
    p.add_argument("--eval", action="append", required=True)
    p.add_argument("--comp", action="append", default=[])
    p.add_argument("-D", "--dbsnp", default=None)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("-R", "--reference", default=None)
    p.add_argument("-ST", "--stratification-module", action="append", default=[],
                   help=f"additional stratifiers: {sorted(st_mod.STRATIFIER_REGISTRY)}")
    p.add_argument("-no-st", "--do-not-use-all-standard-stratifications",
                   dest="no_st", action="store_true")
    p.add_argument("-EV", "--eval-module", action="append", default=[],
                   help=f"evaluators: {sorted(ev_mod.EVALUATOR_REGISTRY)}")
    p.add_argument("-no-ev", "--do-not-use-all-standard-modules",
                   dest="no_ev", action="store_true")
    p.add_argument("-keep-ac0", "--keep-ac0", dest="keep_ac0",
                   action="store_true",
                   help="retain AC=0 (monomorphic-in-samples) eval sites")
    p.add_argument("-select", "--select-exps", action="append", default=[],
                   help="JEXL expressions for the JexlExpression stratifier")
    p.add_argument("-select-name", "--select-names", action="append", default=[],
                   help="names for the -select expressions")
    p.add_argument("-L", "--intervals", action="append", default=None,
                   help="traversal intervals (file or contig:start-end); sets "
                        "nProcessedLoci like the walker engine's locus count")
    p.add_argument("-ped", "--pedigree", default=None,
                   help=".ped file for Family stratification / "
                        "MendelianViolationEvaluator")
    p.add_argument("-strat-intervals", "--strat-intervals", default=None,
                   help="feature file for the IntervalStratification module")
    p.add_argument("-mvq", "--mendelian-violation-qual-threshold", type=float,
                   default=50.0)
    p.add_argument("-pedValidationType", "--pedigree-validation-type",
                   dest="ped_validation", default="STRICT",
                   choices=["STRICT", "SILENT"],
                   help="STRICT: every pedigree sample must exist in the "
                        "eval callset (PedigreeValidationType)")
    args = p.parse_args(argv)

    processed_loci = None
    if args.intervals:
        processed_loci = 0
        seen_spans = []
        for spec in args.intervals:
            if spec.endswith((".vcf", ".vcf.gz")):
                for rec in vcfio.VcfReader(spec):
                    seen_spans.append((rec.contig, rec.pos, rec.pos + len(rec.ref)))
            elif not os.path.exists(spec):
                from ..engine import intervals as iv_mod

                it = iv_mod.parse_interval(spec)
                seen_spans.append((it.contig, it.start, it.end))
            else:
                from ..engine import intervals as iv_mod

                for it in iv_mod.load_interval_file(spec):
                    seen_spans.append((it.contig, it.start, it.end))
        # merge overlaps per contig (IntervalUtils union semantics)
        by_c = {}
        for c, s0, e0 in seen_spans:
            by_c.setdefault(c, []).append((s0, e0))
        for spans in by_c.values():
            spans.sort()
            cur_s, cur_e = spans[0]
            for s0, e0 in spans[1:]:
                if s0 <= cur_e:
                    cur_e = max(cur_e, e0)
                else:
                    processed_loci += cur_e - cur_s
                    cur_s, cur_e = s0, e0
            processed_loci += cur_e - cur_s
        merged_spans = by_c

        def in_intervals(contig, pos):
            for s0, e0 in merged_spans.get(contig, ()):
                if s0 <= pos < e0:
                    return True
            return False
    else:
        def in_intervals(contig, pos):
            return True

    st_names = list(dict.fromkeys(
        ([] if args.no_st else list(st_mod.STANDARD_STRATIFICATIONS))
        + args.stratification_module))
    ev_names = list(dict.fromkeys(
        ([] if args.no_ev else list(ev_mod.STANDARD_EVALUATORS)) + args.eval_module))
    for n in st_names:
        if n not in st_mod.STRATIFIER_REGISTRY:
            raise UserError(f"unknown stratification module {n}")
    for n in ev_names:
        if n not in ev_mod.EVALUATOR_REGISTRY:
            raise UserError(f"unknown eval module {n}")

    ref = None
    if args.reference:
        from ..io import fasta

        ref = fasta.FastaReference(args.reference)

    dbsnp = _load_track([args.dbsnp]) if args.dbsnp else {}
    comp_tracks = {"dbsnp": dbsnp} if args.dbsnp else {}
    for i, path in enumerate(args.comp):
        comp_tracks[f"comp{i + 1}" if len(args.comp) > 1 else "comp"] = _load_track([path])
    if not comp_tracks:
        comp_tracks = {"none": {}}

    select_exprs = list(zip(args.select_names or [], args.select_exps or []))

    # pedigree: families + trio rows for the Family stratifier / MV evaluator
    # (utils/samples/SampleDB; trios with a '0' parent are silent no-ops)
    ped_families: dict = {}
    ped_trios: list = []
    if args.pedigree:
        with open(args.pedigree) as fh:
            for ln in fh:
                f = ln.split()
                if len(f) < 4 or ln.startswith("#"):
                    continue
                fam, sid, father, mother = f[0], f[1], f[2], f[3]
                ped_families.setdefault(fam, []).append(sid)
                if father != "0" or mother != "0":
                    ped_trios.append((fam, mother, father, sid))
    if args.pedigree and args.ped_validation == "STRICT":
        # SampleDBBuilder PedigreeValidationType.STRICT: all pedigree samples
        # must be present in the eval callset
        eval_sample_names = set(vcfio.VcfReader(args.eval[0]).samples)
        ped_sample_names = {s for fam in ped_families.values() for s in fam}
        missing = sorted(ped_sample_names - eval_sample_names)
        if missing:
            raise UserError(
                "Samples found in the pedigree file but not in the callset: "
                + ", ".join(missing) + " (use -pedValidationType SILENT to "
                "ignore)")
    ev_mod.MendelianViolationEvaluator.trios = ped_trios
    ev_mod.MendelianViolationEvaluator.min_gq = \
        args.mendelian_violation_qual_threshold
    family_mode = bool(ped_families) and "Family" in (
        args.stratification_module or [])
    family_levels = sorted(ped_families) + ["all"] if family_mode else ()

    strat_intervals = []
    if args.strat_intervals:
        from ..engine.intervals import Interval as _Iv

        with open(args.strat_intervals) as fh:
            for ln in fh:
                # tolerant BED: whitespace-separated, trailing '#' comments
                f = ln.split("#", 1)[0].split()
                if len(f) >= 3:
                    strat_intervals.append(_Iv(f[0], int(f[1]), int(f[2])))

    def subset_to_samples(v, names, all_names):
        """VariantEvalEngine.getSubsetOfVariantContext: keep the named samples
        (input order), re-derive alleles from the remaining genotypes and
        remap GT indices (htsjdk subContextFromSamples(deriveAlleles=true))."""
        import copy as _copy

        keep = [i for i, n in enumerate(all_names) if n in names]
        samples = [v.samples[i] for i in keep if i < len(v.samples)]
        used = set()
        for g in samples:
            for a in g.get("GT", ".").replace("|", "/").split("/"):
                if a not in (".", ""):
                    used.add(int(a))
        alt_map = {0: 0}
        new_alts = []
        for ai in sorted(used):
            if ai == 0:
                continue
            new_alts.append(v.alts[ai - 1])
            alt_map[ai] = len(new_alts)
        out_samples = []
        for g in samples:
            gt = g.get("GT", ".")
            sep = "|" if "|" in gt else "/"
            parts = gt.replace("|", "/").split("/")
            new_gt = sep.join("." if a in (".", "") else str(alt_map[int(a)])
                              for a in parts)
            g2 = dict(g)
            g2["GT"] = new_gt
            out_samples.append(g2)
        v2 = _copy.copy(v)
        v2.alts = tuple(new_alts)
        v2.samples = out_samples
        v2.info = dict(v.info)
        return v2, [all_names[i] for i in keep]

    def make_stratifier(name, first_eval_samples, comp_name="none",
                        eval_name="eval"):
        cls = st_mod.STRATIFIER_REGISTRY[name]
        if name == "Sample":
            return cls(first_eval_samples)
        if name == "CpG":
            return cls(ref)
        s = cls()
        if name == "CompFeatureInput":
            s.comp_name = comp_name
        elif name == "EvalFeatureInput":
            s.eval_name = eval_name
        elif name == "JexlExpression":
            s.expressions = select_exprs
        elif name == "Family" and family_mode:
            s.family_levels = tuple(family_levels)
        elif name == "IntervalStratification":
            if not args.strat_intervals:
                raise UserError("-strat-intervals must be provided when "
                                "IntervalStratification is enabled")
            s.intervals = strat_intervals
        return s

    tables: dict[str, ReportTable] = {}
    hist_rows = []
    for ei, path in enumerate(args.eval):
        eval_name = f"eval{ei + 1}" if len(args.eval) > 1 else "eval"
        reader = vcfio.VcfReader(path)
        variants = [v for v in reader if in_intervals(v.contig, v.pos)]
        for comp_name, track in comp_tracks.items():
            stratifiers = [make_stratifier(n, reader.samples, comp_name,
                                           eval_name) for n in st_names]
            manager = StratificationManager(
                stratifiers,
                [ev_mod.EVALUATOR_REGISTRY[n] for n in ev_names])
            include_filtered = "Filter" in st_names or "FilterType" in st_names
            for v in variants:
                is_filtered = bool(v.filters and v.filters != ("PASS",))
                if is_filtered and not include_filtered:
                    continue  # default: evaluate unfiltered sites only
                key = (v.contig, v.pos)
                comps = track.get(key, [])
                comp = next((c for c in comps if c.ref == v.ref), comps[0] if comps else None)
                comp = _subset_comp(comp, reader.samples)
                comp_match = comp is not None and any(
                    a in comp.alts for a in v.alts)
                known = key in dbsnp and any(
                    v.ref == kv.ref and a in kv.alts
                    for kv in dbsnp[key] for a in v.alts)
                n_no_calls = sum(
                    1 for smp in v.samples
                    if smp.get("GT", ".").startswith(".")) if "GT" in v.fmt_keys else 0
                if family_mode:
                    # one per-family-subsetted context per family level
                    # (VariantEvalEngine.bindVariantContexts per-family path)
                    for level in family_levels:
                        names = reader.samples if level == "all" else \
                            ped_families[level]
                        vf, kept = subset_to_samples(v, set(names),
                                                     reader.samples)
                        ctx = EvalContext(
                            vf, classify(vf), known, comp, comp_match,
                            is_filtered, sample_genotypes(vf),
                            n_no_calls=n_no_calls, keep_ac0=args.keep_ac0,
                            eval_samples=kept, family_name=level)
                        manager.update(ctx)
                    continue
                ctx = EvalContext(
                    v, classify(v), known, comp, comp_match, is_filtered,
                    sample_genotypes(v), n_no_calls=n_no_calls,
                    keep_ac0=args.keep_ac0, eval_samples=reader.samples)
                manager.update(ctx)
            # comparison-order-2 evaluators (ValidationReport): comp-only
            # sites inside the traversal also count (VariantEvalEngine's
            # union-site driving for getComparisonOrder()==2 modules)
            eval_keys = {(v.contig, v.pos) for v in variants}
            for key in sorted(track.keys()):
                if key in eval_keys or not in_intervals(*key):
                    continue
                comp = _subset_comp(track[key][0], reader.samples)
                ctx = EvalContext(None, None, False, comp, False, False, [],
                                  n_no_calls=0, keep_ac0=args.keep_ac0,
                                  eval_samples=reader.samples)
                manager.update(ctx)
            if processed_loci is not None:
                manager.set_processed_loci(processed_loci)
            for tname, cols, rows in manager.tables(comp_name, eval_name):
                if tname == "IndelLengthHistogram":
                    # expanded per-length rows (the reference emits a molten table)
                    for key in sorted(manager.contexts):
                        evi = ev_names.index("IndelLengthHistogram")
                        h = manager.contexts[key][evi]
                        for length, freq in h.histogram_rows():
                            hist_rows.append([comp_name, eval_name, *key, length, freq])
                    continue
                t = tables.get(tname)
                if t is None:
                    t = ReportTable(tname, _TABLE_DESCRIPTIONS.get(tname, tname), cols)
                    tables[tname] = t
                for r in rows:
                    t.add_row(*r)

    if "IndelLengthHistogram" in ev_names and hist_rows:
        cols = ([("IndelLengthHistogram", "%s"), ("CompFeatureInput", "%s"),
                 ("EvalFeatureInput", "%s")] + [(n, "%s") for n in st_names]
                + [("Length", "%d"), ("Freq", "%.8f")])
        t = ReportTable("IndelLengthHistogram",
                        _TABLE_DESCRIPTIONS["IndelLengthHistogram"], cols)
        for r in hist_rows:
            t.add_row("IndelLengthHistogram", *r)
        tables["IndelLengthHistogram"] = t

    ordered = [tables[n] for n in sorted(tables)]
    with open(args.output, "w") as fh:
        fh.write(f"#:GATKReport.v1.1:{len(ordered)}\n")
        for ti, t in enumerate(ordered):
            fh.write(t.render())
            if ti < len(ordered) - 1:  # blank line BETWEEN tables only
                fh.write("\n")
    print(f"evaluated {len(args.eval)} callset(s) x {len(st_names)} stratifier(s) "
          f"x {len(ev_names)} module(s) -> {args.output}")
    return 0


_TABLE_DESCRIPTIONS = {
    "CompOverlap": "The overlap between eval and comp sites",
    "CountVariants": "Counts different classes of variants in the sample",
    "TiTvVariantEvaluator": "Ti/Tv Variant Evaluator",
    "MendelianViolationEvaluator": "Mendelian Violation Evaluator",
    "IndelSummary": "Evaluation summary for indels",
    "IndelLengthHistogram": "Indel length histogram",
    "MultiallelicSummary": "Evaluation summary for multi-allelic variants",
    "ValidationReport": "Assess site accuracy and sensitivity of callset against follow-up validation assay",
    "VariantSummary": "1000 Genomes Phase I summary of variants table",
}


@register_tool("AlleleFrequencyQC")
def allele_frequency_qc(argv):
    """Array-vs-population allele-frequency concordance QC
    (tools/walkers/varianteval/AlleleFrequencyQC.java): runs the
    VariantAFEvaluator over comp-AF logit bins for the array callset and the
    population callset, then a modified chi-squared over per-bin mean-AF
    differences with constant variance; emits an AlleleFrequencyQCMetric
    metrics file (SAMPLE, pvalue, chi-squared)."""
    import math

    import numpy as np

    from ..io import vcf as vcfio

    p = argparse.ArgumentParser(description="AlleleFrequencyQC")
    p.add_argument("--eval", action="append", required=True,
                   help="array VCF (and optionally the population VCF as a "
                        "second eval track; added automatically if omitted)")
    p.add_argument("--comp", required=True, help="population (expected-AF) VCF")
    p.add_argument("-O", "--output", required=True)
    p.add_argument("-R", "--reference", default=None)
    p.add_argument("-L", "--intervals", action="append", default=None)
    p.add_argument("-pvalue-threshold", "--pvalue-threshold", type=float,
                   default=0.05)
    p.add_argument("-allowed-variance", "--allowed-variance", type=float,
                   default=0.01)
    p.add_argument("-debug-file", "--debug-file", default=None)
    args = p.parse_args(argv)

    # comp records by locus; -L <compVcf> restricts traversal to comp sites
    comp_by_pos = {}
    for cv in vcfio.VcfReader(args.comp):
        comp_by_pos.setdefault((cv.contig, cv.pos), cv).info
    comp_sites = set(comp_by_pos)

    # ##sampleAlias header line names the metric sample (AlleleFrequencyQC:49)
    sample = "SAMPLE"
    rd0 = vcfio.VcfReader(args.eval[0])
    for h in rd0.header_lines:
        if h.startswith("##sampleAlias="):
            sample = h.split("=", 1)[1]

    LOG_LIMIT = 30

    def logit_bucket(af):
        af = af + 1e-6
        score = float(np.float32(-10.0 * math.log10(af / (1.0 - af))))
        return min(LOG_LIMIT, max(-LOG_LIMIT, math.floor(score + 0.5)))

    def max_af(v):
        raw = v.info.get("AF", 0.0)
        vals = str(raw).split(",")
        return max(float(x) for x in vals)

    tracks = list(args.eval)
    if args.comp not in tracks:
        tracks.append(args.comp)  # the -eval:thousand_genomes track
    # bin -> per-track [sum_af, n_called]; all logit bins pre-exist
    # (StratificationManager materializes the full state product)
    acc = {b: [[0.0, 0] for _ in tracks] for b in
           range(-LOG_LIMIT, LOG_LIMIT + 1)}
    for ti, path in enumerate(tracks):
        for v in vcfio.VcfReader(path):
            if (v.contig, v.pos) not in comp_sites:
                continue
            if v.filters and v.filters != ("PASS",):
                continue  # Filter stratifier: only 'called' rows feed the stat
            if not v.is_snp():
                continue
            comp = comp_by_pos.get((v.contig, v.pos))
            af = max_af(comp) if comp is not None else 0.0
            b = logit_bucket(af)
            cell = acc[b][ti]
            if v.samples and "GT" in v.fmt_keys:
                for g in v.samples:
                    gt = g.get("GT", ".")
                    if gt.startswith("."):
                        continue
                    alleles = gt.replace("|", "/").split("/")
                    n_ref = sum(a == "0" for a in alleles)
                    # (PLOIDY - numReferenceAlleles)/PLOIDY with Java int
                    # division (VariantAFEvaluator.java:57) — replicated
                    cell[0] += (2 - n_ref) // 2
                    cell[1] += 1
            else:
                cell[0] += float(v.info.get("AF", 0.0) if not isinstance(
                    v.info.get("AF", 0.0), str)
                    else v.info["AF"].split(",")[0])
                cell[1] += 1

    variance = args.allowed_variance
    chi_sq = 0.0
    for b, cells in acc.items():
        avgs = [(s / n if n else 0.0) for s, n in cells]
        if len(avgs) >= 2:
            chi_sq += (avgs[0] - avgs[1]) ** 2
    chi_sq /= variance ** 2
    from scipy.stats import chi2 as _chi2

    dof = len(acc) - 1
    pval = 1.0 - float(_chi2.cdf(chi_sq, dof))

    with open(args.output, "w") as fh:
        fh.write("## METRICS CLASS\torg.broadinstitute.hellbender.metrics."
                 "analysis.AlleleFrequencyQCMetric\n")
        fh.write("SAMPLE\tMETRIC_TYPE\tMETRIC_VALUE\tCHI_SQ_VALUE\n")
        # MetricsFile rows end with a trailing tab + a final blank line
        fh.write(f"{sample}\tAllele Frequency\t{pval:.6f}\t{chi_sq:.6f}\t\n\n")
    if pval < args.pvalue_threshold:
        print(f"Allele frequencies between your array VCF and the expected "
              f"VCF do not match with a significant pvalue of {pval}")
    print(f"AlleleFrequencyQC: chi_sq={chi_sq:.6f} pval={pval:.6f} -> "
          f"{args.output}")
    return 0
