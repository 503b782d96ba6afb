# Copied verbatim from gatk_tpu/tools/gvcf_tools.py; only import lines may differ.
"""CombineGVCFs / GenotypeGVCFs command line tools."""
from __future__ import annotations

import argparse

from ..cli import UserError, register_tool
from ..gvcf import genotype_gvcfs as gg
from ..io import vcf


@register_tool("GenotypeGVCFs")
def genotype_gvcfs_tool(argv):
    """Perform joint genotyping on one or more samples' GVCFs."""
    p = argparse.ArgumentParser(description="GenotypeGVCFs")
    p.add_argument("-V", "--variant", required=True)
    p.add_argument("-R", "--reference", default=None)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("-L", "--intervals", action="append", default=None)
    p.add_argument("--standard-min-confidence-threshold-for-calling", "-stand-call-conf",
                   type=float, default=30.0)
    p.add_argument("--include-non-variant-sites", action="store_true")
    p.add_argument("--sample-ploidy", type=int, default=2)
    p.add_argument("-keep-combined", "--keep-combined-raw-annotations",
                   dest="keep_combined", action="store_true",
                   help="retain the combined raw AS_* annotations (and "
                        "AS_QUAL) alongside the finalized values")
    args = p.parse_args(argv)

    from ..utils.javarandom import reset_random_generator

    reset_random_generator()
    if args.variant.startswith("gendb://"):
        # GenomicsDB-workspace input: combine the cohort store in memory first
        # (FeatureDataSource GENOMIC_DB_URI_SCHEME path)
        if args.reference is None:
            raise UserError("GenotypeGVCFs on a gendb:// workspace requires -R")
        reader = _GendbReader(args.variant, args.reference, args.intervals)
    else:
        reader = vcf.VcfReader(args.variant)
    # GATK emits samples in lexicographic order regardless of input order
    sample_order = sorted(range(len(reader.samples)), key=lambda i: reader.samples[i])
    sorted_samples = [reader.samples[i] for i in sample_order]
    out = []
    for v in reader:
        alts = [a for a in v.alts if a != gg.NON_REF and a != "*"]
        if not alts:
            if args.include_non_variant_sites:
                out.append(gg.homref_site_record(v, sample_order))
            continue  # hom-ref block
        records = [(v, v.samples[i]) for i in sample_order]
        res = gg.regenotype_records_at_site(
            records, reader.samples, ploidy=args.sample_ploidy,
            standard_confidence=args.standard_min_confidence_threshold_for_calling,
            include_non_variants=args.include_non_variant_sites,
            keep_combined_raw=args.keep_combined,
        )
        if res is not None:
            out.append(res)
            if args.include_non_variant_sites and res.alts and \
                    any("1" in s.get("GT", "").replace("|", "/").split("/")
                        for s in res.samples):
                out.extend(gg.spanning_deletion_records(res))

    header_lines = [
        '##INFO=<ID=AC,Number=A,Type=Integer,Description="Allele count in genotypes">',
        '##INFO=<ID=AF,Number=A,Type=Float,Description="Allele Frequency">',
        '##INFO=<ID=AN,Number=1,Type=Integer,Description="Total number of alleles in called genotypes">',
        '##INFO=<ID=DP,Number=1,Type=Integer,Description="Approximate read depth">',
        '##INFO=<ID=QD,Number=1,Type=Float,Description="Variant Confidence/Quality by Depth">',
        '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
        '##FORMAT=<ID=AD,Number=R,Type=Integer,Description="Allelic depths">',
        '##FORMAT=<ID=DP,Number=1,Type=Integer,Description="Read depth">',
        '##FORMAT=<ID=GQ,Number=1,Type=Integer,Description="Genotype quality">',
        '##FORMAT=<ID=PL,Number=G,Type=Integer,Description="Phred-scaled genotype likelihoods">',
    ]
    w = vcf.VcfWriter(args.output, sorted_samples, extra_header_lines=header_lines)
    for v in out:
        w.write(v)
    w.close()
    print(f"wrote {len(out)} variants to {args.output}")
    return 0


@register_tool("CombineGVCFs")
def combine_gvcfs_tool(argv):
    """Combine per-sample GVCFs into a multi-sample GVCF."""
    p = argparse.ArgumentParser(description="CombineGVCFs")
    p.add_argument("-V", "--variant", action="append", required=True)
    p.add_argument("-R", "--reference", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("-L", "--intervals", action="append", default=None)
    args = p.parse_args(argv)

    from ..engine import intervals as ivx
    from ..gvcf import combine
    from ..io import fasta

    ref = fasta.FastaReference(args.reference)
    readers = [vcf.VcfReader(path) for path in args.variant]
    all_samples = [s for r in readers for s in r.samples]

    # group records per contig per input
    per_input = []
    contigs_seen = []
    for r in readers:
        by_contig = {}
        for v in r:
            by_contig.setdefault(v.contig, ([], []))
            by_contig[v.contig][0].append(v)
            by_contig[v.contig][1].append(v.samples[0] if v.samples else {})
        per_input.append(by_contig)
        for c in by_contig:
            if c not in contigs_seen:
                contigs_seen.append(c)

    out_all = []
    for contig in contigs_seen:
        # tolerate MT/chrM naming differences between gvcf and reference
        ref_contig = contig
        if ref_contig not in ref.contig_order:
            alias = {"MT": "chrM", "chrM": "MT"}.get(contig)
            if alias in ref.contig_order:
                ref_contig = alias
            else:
                raise UserError(f"contig {contig} not in reference")
        seq = ref.fetch(ref_contig, 0, ref.contig_length(ref_contig))
        seq_upper = bytes(seq).upper()

        streams = [bc.get(contig, ([], [])) for bc in per_input]
        interval = None
        if args.intervals:
            for s in args.intervals:
                t = ivx.parse_interval(s, {contig: len(seq_upper)})
                if t.contig == contig:
                    interval = (t.start, t.end)
        out_all.extend(combine.combine_gvcfs(
            streams, all_samples, lambda p0: seq_upper[p0], contig, interval=interval))

    header_lines = [
        '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
        '##FORMAT=<ID=DP,Number=1,Type=Integer,Description="Read depth">',
        '##FORMAT=<ID=GQ,Number=1,Type=Integer,Description="Genotype quality">',
        '##FORMAT=<ID=MIN_DP,Number=1,Type=Integer,Description="Minimum DP in block">',
        '##FORMAT=<ID=PL,Number=G,Type=Integer,Description="Phred-scaled genotype likelihoods">',
        '##INFO=<ID=END,Number=1,Type=Integer,Description="Stop position of the interval">',
        f'##ALT=<ID=NON_REF,Description="Represents any possible alternative allele">',
    ]
    w = vcf.VcfWriter(args.output, all_samples, extra_header_lines=header_lines)
    for v in out_all:
        w.write(v)
    w.close()
    print(f"wrote {len(out_all)} records to {args.output}")
    return 0


@register_tool("ReblockGVCF")
def reblock_gvcf_tool(argv):
    """Condense hom-ref blocks in a single-sample GVCF (new GQ bands, drop uncalled alts)."""
    import argparse as _ap

    from ..gvcf.reblock import INFO_KEYS_TO_REMOVE, ReblockEngine

    # annotation class name -> INFO key (Barclay -A names)
    ann_keys = {"Coverage": "DP", "RMSMappingQuality": "MQ",
                "ReadPosRankSumTest": "ReadPosRankSum",
                "MappingQualityRankSumTest": "MQRankSum",
                "BaseQualityRankSumTest": "BaseQRankSum",
                "FisherStrand": "FS", "StrandOddsRatio": "SOR",
                "QualByDepth": "QD"}

    p = _ap.ArgumentParser(description="ReblockGVCF")
    p.add_argument("-V", "--variant", required=True)
    p.add_argument("-R", "--reference", default=None)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("-GQB", "--gvcf-gq-bands", type=int, action="append", default=None)
    p.add_argument("-drop-low-quals", "--drop-low-quals", action="store_true")
    p.add_argument("-rgq-threshold", "--rgq-threshold-to-no-call", type=float, default=0.0)
    p.add_argument("-do-qual-approx", "--do-qual-score-approximation", action="store_true")
    p.add_argument("--keep-all-alts", action="store_true")
    p.add_argument("--floor-blocks", action="store_true")
    p.add_argument("-A", "--annotation", action="append", default=None)
    p.add_argument("--disable-tool-default-annotations", default=None)
    p.add_argument("-L", "--intervals", action="append", default=None)
    args = p.parse_args(argv)

    from ..io import vcf as vcfio

    reference = None
    if args.reference:
        from ..io import fasta
        reference = fasta.FastaReference(args.reference)

    keep = None
    if args.annotation:
        keep = [ann_keys.get(a, a) for a in args.annotation]

    reader = vcfio.VcfReader(args.variant)
    if len(reader.samples) != 1:
        raise SystemExit("ReblockGVCF requires a single-sample GVCF input")

    intervals = None
    if args.intervals:
        from ..engine import intervals as ivx
        intervals = [ivx.parse_interval(s, {}) for s in args.intervals]

    eng = ReblockEngine(
        gq_bands=args.gvcf_gq_bands or (20, 100),
        drop_low_quals=args.drop_low_quals,
        rgq_threshold=args.rgq_threshold_to_no_call,
        do_qual_approx=args.do_qual_score_approximation,
        keep_all_alts=args.keep_all_alts,
        floor_blocks=args.floor_blocks,
        annotations_to_keep=keep,
        reference=reference,
    )
    n_in = 0
    for v in reader:
        if intervals is not None:
            end = int(v.info.get("END", v.pos + len(v.ref)))
            if not any(t.contig == v.contig and v.pos < t.end and end > t.start
                       for t in intervals):
                continue
        eng.process(v)
        n_in += 1
    records = eng.finish()

    header = [ln for ln in reader.header_lines
              if not ln.startswith("##GVCFBlock")
              and not any(ln.startswith(f"##INFO=<ID={k},") for k in INFO_KEYS_TO_REMOVE)]
    extra = [
        '##INFO=<ID=RAW_MQandDP,Number=2,Type=Integer,Description="Raw data (sum of squared MQ and total depth) for improved RMS Mapping Quality calculation.">',
        '##INFO=<ID=RAW_GT_COUNT,Number=3,Type=Integer,Description="Counts of genotypes w.r.t. the reference allele: 0/0, 0/*, */*">',
        '##INFO=<ID=QUALapprox,Number=1,Type=Integer,Description="Sum of PL[0] values; used to approximate the QUAL score">',
        '##INFO=<ID=VarDP,Number=1,Type=Integer,Description="(informative) depth over variant genotypes">',
    ]
    for ln in extra:
        key = ln.split("ID=")[1].split(",")[0]
        if not any(f"ID={key}," in h for h in header):
            header.append(ln)
    w = vcfio.VcfWriter(args.output, reader.samples, extra_header_lines=header)
    for v in records:
        w.write(v)
    w.close()
    print(f"reblocked {n_in} records -> {len(records)} records in {args.output}")
    return 0


class _GendbReader:
    """Adapter that combines a GvcfStore workspace in memory and iterates the
    merged multi-sample records (CombineGVCFs semantics over gendb:// input)."""

    def __init__(self, uri, reference_path, intervals=None):
        from ..engine import intervals as ivx
        from ..gvcf import combine
        from ..io import fasta
        from ..io.gvcf_store import GvcfStore

        store = GvcfStore(uri)
        ref = fasta.FastaReference(reference_path)
        self.samples = list(store.samples)
        self._records = []
        for contig in store.contigs:
            ref_contig = contig
            if ref_contig not in ref.contig_order:
                alias = {"MT": "chrM", "chrM": "MT"}.get(contig)
                if alias in ref.contig_order:
                    ref_contig = alias
                else:
                    raise UserError(f"contig {contig} not in reference")
            seq_upper = bytes(ref.fetch(ref_contig, 0, ref.contig_length(ref_contig))).upper()
            interval = None
            if intervals:
                for s in intervals:
                    t = ivx.parse_interval(s, {contig: len(seq_upper)})
                    if t.contig == contig:
                        interval = (t.start, t.end)
            _samples, per_sample = store.query(
                contig, *(interval if interval else (None, None)))
            streams = [(recs, [r.samples[0] if r.samples else {} for r in recs])
                       for recs in per_sample]
            self._records.extend(combine.combine_gvcfs(
                streams, self.samples, lambda p0: seq_upper[p0], contig,
                interval=interval))

    def __iter__(self):
        return iter(self._records)


@register_tool("GenomicsDBImport")
def genomicsdb_import(argv):
    """Import single-sample GVCFs into a columnar cohort workspace (gendb://)."""
    p = argparse.ArgumentParser(description="GenomicsDBImport")
    p.add_argument("-V", "--variant", action="append", required=True)
    p.add_argument("--genomicsdb-workspace-path", default=None)
    p.add_argument("--genomicsdb-update-workspace-path", default=None)
    p.add_argument("-L", "--intervals", action="append", default=None)
    p.add_argument("--batch-size", type=int, default=0)
    args = p.parse_args(argv)

    from ..io.gvcf_store import GvcfStore

    if args.genomicsdb_workspace_path:
        import os as _os
        ws = args.genomicsdb_workspace_path
        if _os.path.exists(ws) and _os.listdir(ws):
            raise UserError(f"workspace {ws} already exists; use "
                            "--genomicsdb-update-workspace-path to append")
        store = GvcfStore.create(ws)
    elif args.genomicsdb_update_workspace_path:
        store = GvcfStore(args.genomicsdb_update_workspace_path)
    else:
        raise UserError("provide --genomicsdb-workspace-path or "
                        "--genomicsdb-update-workspace-path")

    for path in args.variant:
        store.import_gvcf(path)
    print(f"workspace now holds {len(store.samples)} samples over "
          f"{len(store.contigs)} contigs")
    return 0


@register_tool("CalculateGenotypePosteriors")
def calculate_genotype_posteriors(argv):
    """Refine genotype calls with population and/or family (pedigree) priors."""
    import argparse as _ap

    from ..gvcf import posteriors as pp

    p = _ap.ArgumentParser(description="CalculateGenotypePosteriors")
    p.add_argument("-V", "--variant", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("-R", "--reference", default=None)
    p.add_argument("-L", "--intervals", action="append", default=None)
    p.add_argument("--supporting-callsets", "-supporting", action="append", default=[])
    p.add_argument("-ped", "--pedigree", default=None)
    p.add_argument("--de-novo-prior", type=float, default=1e-6)
    p.add_argument("--global-prior-snp", type=float, default=1e-3)
    p.add_argument("--global-prior-indel", type=float, default=1e-3)
    p.add_argument("--num-reference-samples-if-no-call", type=int, default=0)
    p.add_argument("--discovered-allele-count-priors-off", action="store_true")
    p.add_argument("--ignore-input-samples", action="store_true")
    p.add_argument("--default-to-allele-count", action="store_true")
    p.add_argument("--use-flat-priors-for-indels", action="store_true")
    p.add_argument("--skip-population-priors", action="store_true")
    p.add_argument("--skip-family-priors", action="store_true")
    args = p.parse_args(argv)

    resources_by_pos = {}
    for path in args.supporting_callsets:
        for r in vcf.VcfReader(path):
            resources_by_pos.setdefault((r.contig, r.pos), []).append(r)

    trios = []
    if args.pedigree and not args.skip_family_priors:
        trios = pp.read_pedigree(args.pedigree)

    reader = vcf.VcfReader(args.variant)
    sample_index = {s: i for i, s in enumerate(reader.samples)}

    extra = [
        '##FORMAT=<ID=PP,Number=G,Type=Integer,Description="Phred-scaled Posterior Genotype Probabilities">',
        '##INFO=<ID=PG,Number=G,Type=Integer,Description="Genotype Likelihood Prior">',
    ]
    if trios:
        extra += [
            '##FORMAT=<ID=JL,Number=1,Type=Integer,Description="Phred-scaled joint likelihood of the genotype combination (before applying family priors)">',
            '##FORMAT=<ID=JP,Number=1,Type=Integer,Description="Phred-scaled joint posterior probability of the genotype combination (after applying family priors)">',
        ]
    # GATK emits samples in lexicographic order (getSamplesForVariants is sorted)
    order = sorted(range(len(reader.samples)), key=lambda i: reader.samples[i])
    out_samples = [reader.samples[i] for i in order]
    w = vcf.VcfWriter(args.output, out_samples,
                      extra_header_lines=reader.header_lines + extra)
    n = 0
    for v in reader:
        if trios:
            v = pp.apply_family_priors(v, trios, sample_index, args.de_novo_prior)
        if not args.skip_population_priors:
            resources = resources_by_pos.get((v.contig, v.pos), [])
            v = pp.calculate_population_posteriors(
                v, resources,
                num_ref_if_missing=0 if resources else args.num_reference_samples_if_no_call,
                snp_prior=args.global_prior_snp, indel_prior=args.global_prior_indel,
                use_input_samples=not args.ignore_input_samples,
                use_mleac=not args.default_to_allele_count,
                ignore_input_for_missing=args.discovered_allele_count_priors_off,
                flat_indels=args.use_flat_priors_for_indels)
        v.samples = [v.samples[i] for i in order]
        w.write(v)
        n += 1
    w.close()
    print(f"wrote {n} records to {args.output}")
    return 0

@register_tool("GnarlyGenotyper")
def gnarly_genotyper(argv):
    """Quick-and-dirty large-cohort joint genotyping on combined GVCF records.

    Reference: gnarlyGenotyper/GnarlyGenotyperEngine.java — QUALapprox
    thresholding with SNP/indel heterozygosity priors (:9-10), NON_REF
    trimming with PL/AD subsetting and GT calling from PLs
    (iterateOnGenotypes), AC/AF/AN from called genotypes, ExcessHet from
    genotype counts, FS/SOR from the summed SB table, QD = QUALapprox/VarDP.
    """
    import math

    import numpy as np

    from ..gvcf import annotations as ann
    from ..gvcf import genotype_gvcfs as gg

    p = argparse.ArgumentParser(description="GnarlyGenotyper")
    p.add_argument("-V", "--variant", required=True)
    p.add_argument("-R", "--reference", default=None)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("-L", "--intervals", action="append", default=None)
    p.add_argument("--keep-all-sites", action="store_true")
    p.add_argument("--max-alternate-alleles", type=int, default=6)
    args = p.parse_args(argv)

    SNP_HET, INDEL_HET = 1e-3, 1.25e-4  # HomoSapiensConstants
    SNP_QUAL_THRESHOLD = 30.0 - 10 * math.log10(SNP_HET)
    INDEL_QUAL_THRESHOLD = 30.0 - 10 * math.log10(INDEL_HET)

    if args.variant.startswith("gendb://"):
        if args.reference is None:
            raise UserError("GnarlyGenotyper on a gendb:// workspace requires -R")
        reader = _GendbReader(args.variant, args.reference, args.intervals)
    else:
        reader = vcf.VcfReader(args.variant)
    samples = list(reader.samples)

    def pl_index_to_pair(idx):
        # canonical diploid genotype ordering: (j,k) j<=k at k(k+1)/2+j
        k = 0
        while (k + 1) * (k + 2) // 2 <= idx:
            k += 1
        j = idx - k * (k + 1) // 2
        return j, k

    out = []
    for v in reader:
        alleles = [v.ref] + list(v.alts)
        has_non_ref = v.alts and v.alts[-1] == gg.NON_REF
        targets = alleles[:-1] if has_non_ref else alleles
        concrete_alts = [a for a in targets[1:] if a != "*"]
        if not concrete_alts:
            continue
        n_target = len(targets)
        n_gts = n_target * (n_target + 1) // 2

        # QUALapprox: INFO if present (ReblockGVCF emits it), else per-sample PL[0] sum
        if "QUALapprox" in v.info:
            qual_approx = float(v.info["QUALapprox"])
        else:
            qual_approx = 0.0
            for s in v.samples:
                pl = s.get("PL")
                if pl not in (None, "."):
                    qual_approx += float(pl.split(",")[0])
        has_snp = any(len(a) == len(v.ref) and a != "*" for a in targets[1:])
        is_indel = not has_snp
        site_prior = INDEL_HET if is_indel else SNP_HET
        threshold = INDEL_QUAL_THRESHOLD if is_indel else SNP_QUAL_THRESHOLD
        if qual_approx < threshold:
            if not args.keep_all_sites:
                continue

        # genotypes: trim NON_REF, call GT from PLs
        new_samples = []
        ac = np.zeros(n_target, int)
        an = 0
        sb_sum = np.zeros(4, int)
        het = hom_var = 0
        var_dp = 0
        for s in v.samples:
            new_s = {}
            pl = s.get("PL")
            ad = s.get("AD")
            if ad not in (None, "."):
                ad_vals = [int(x) for x in ad.split(",")][:n_target]
                new_s["AD"] = ",".join(str(x) for x in ad_vals)
            else:
                ad_vals = None
            if pl in (None, "."):
                new_s["GT"] = "./."
                new_samples.append(new_s)
                continue
            pls = [int(x) for x in pl.split(",")][:n_gts]
            order = sorted(pls)
            gq = (order[1] - order[0]) if len(order) > 1 else 0
            j, k = pl_index_to_pair(int(np.argmin(pls)))
            new_s["GT"] = f"{j}/{k}"
            new_s["GQ"] = str(min(gq, 99))
            new_s["PL"] = ",".join(str(x - order[0]) for x in pls)
            if "DP" in s and s["DP"] != ".":
                new_s["DP"] = s["DP"]
            an += 2
            ac[j] += 1
            ac[k] += 1
            if j != k:
                het += 1
            elif k != 0:
                hom_var += 1
            if (j, k) != (0, 0) and ad_vals:
                var_dp += sum(ad_vals)
            sb = s.get("SB")
            if sb not in (None, "."):
                sb_sum += np.array([int(x) for x in sb.split(",")][:4])
            new_samples.append(new_s)

        if an == 0:
            continue
        info = {}
        info["AC"] = ",".join(str(int(x)) for x in ac[1:])
        info["AF"] = ",".join(f"{x / an:.3f}" for x in ac[1:])
        info["AN"] = str(an)
        if qual_approx < threshold:  # keep-all-sites path
            filters = ("LowQual",)
        else:
            filters = ()
        ref_count = max(an // 2 - het - hom_var, 0)
        info["ExcessHet"] = f"{ann.excess_het_phred(het, hom_var, ref_count + het + hom_var):.4f}"
        info["FS"] = ann.format_vcf_double(
            ann.fisher_strand_phred(int(sb_sum[0]), int(sb_sum[1]), int(sb_sum[2]), int(sb_sum[3])))
        info["SOR"] = ann.format_vcf_double(
            ann.strand_odds_ratio(int(sb_sum[0]), int(sb_sum[1]), int(sb_sum[2]), int(sb_sum[3])))
        if "RAW_MQandDP" in v.info:
            sq, dp = (float(x) for x in str(v.info["RAW_MQandDP"]).split(",")[:2])
            if dp > 0:
                info["MQ"] = f"{math.sqrt(sq / dp):.2f}"
        if var_dp > 0:
            qd = qual_approx / var_dp
            info["QD"] = f"{min(qd, 35.0):.2f}"
        qual = qual_approx + 10 * math.log10(site_prior)
        out.append(vcf.Variant(
            contig=v.contig, pos=v.pos, ref=v.ref, alts=tuple(targets[1:]),
            qual=round(qual, 2), filters=filters, info=info,
            fmt_keys=("GT", "AD", "DP", "GQ", "PL"),
            samples=new_samples))

    header_lines = [
        '##FILTER=<ID=LowQual,Description="Low quality">',
        '##INFO=<ID=AC,Number=A,Type=Integer,Description="Allele count in genotypes">',
        '##INFO=<ID=AF,Number=A,Type=Float,Description="Allele Frequency">',
        '##INFO=<ID=AN,Number=1,Type=Integer,Description="Total number of alleles in called genotypes">',
        '##INFO=<ID=ExcessHet,Number=1,Type=Float,Description="Phred-scaled p-value for exact test of excess heterozygosity">',
        '##INFO=<ID=FS,Number=1,Type=Float,Description="Phred-scaled p-value using Fisher exact test to detect strand bias">',
        '##INFO=<ID=MQ,Number=1,Type=Float,Description="RMS Mapping Quality">',
        '##INFO=<ID=QD,Number=1,Type=Float,Description="Variant Confidence/Quality by Depth">',
        '##INFO=<ID=SOR,Number=1,Type=Float,Description="Symmetric Odds Ratio of 2x1x2 contingency table to detect strand bias">',
        '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
        '##FORMAT=<ID=AD,Number=R,Type=Integer,Description="Allelic depths">',
        '##FORMAT=<ID=DP,Number=1,Type=Integer,Description="Read depth">',
        '##FORMAT=<ID=GQ,Number=1,Type=Integer,Description="Genotype quality">',
        '##FORMAT=<ID=PL,Number=G,Type=Integer,Description="Phred-scaled genotype likelihoods">',
    ]
    w = vcf.VcfWriter(args.output, samples, extra_header_lines=header_lines)
    for rec in out:
        w.write(rec)
    w.close()
    print(f"wrote {len(out)} variants to {args.output}")
    return 0
