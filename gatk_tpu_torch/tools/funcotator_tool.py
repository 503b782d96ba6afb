# Copied verbatim from gatk_tpu/tools/funcotator_tool.py; only import lines may differ.
"""Funcotator command line tool.

Reference parity: tools/funcotator/Funcotator.java — per-variant functional
annotation from datasource directories (gencode type), VCF FUNCOTATION INFO
output and MAF output renderers (vcfOutput/mafOutput packages).
"""
from __future__ import annotations

import argparse

from ..cli import UserError, register_tool
from ..io import vcf as vcfio

FIELDS = ["hugoSymbol", "ncbiBuild", "chromosome", "start", "end",
          "variantClassification", "secondaryVariantClassification", "variantType",
          "refAllele", "altAllele", "annotationTranscript", "transcriptStrand",
          "transcriptExon", "cDnaChange", "codonChange", "proteinChange"]

MAF_COLUMNS = ["Hugo_Symbol", "NCBI_Build", "Chromosome", "Start_Position",
               "End_Position", "Strand", "Variant_Classification", "Variant_Type",
               "Reference_Allele", "Tumor_Seq_Allele1", "Tumor_Seq_Allele2",
               "Annotation_Transcript", "cDNA_Change", "Codon_Change", "Protein_Change"]

# Funcotator VariantClassification -> MAF Variant_Classification
MAF_CLASSIFICATION = {
    "MISSENSE": "Missense_Mutation", "NONSENSE": "Nonsense_Mutation",
    "NONSTOP": "Nonstop_Mutation", "SILENT": "Silent",
    "SPLICE_SITE": "Splice_Site", "IN_FRAME_DEL": "In_Frame_Del",
    "IN_FRAME_INS": "In_Frame_Ins", "FRAME_SHIFT_INS": "Frame_Shift_Ins",
    "FRAME_SHIFT_DEL": "Frame_Shift_Del", "START_CODON_SNP": "Translation_Start_Site",
    "START_CODON_INS": "Translation_Start_Site", "START_CODON_DEL": "Translation_Start_Site",
    "FIVE_PRIME_UTR": "5'UTR", "THREE_PRIME_UTR": "3'UTR",
    "FIVE_PRIME_FLANK": "5'Flank", "INTRON": "Intron", "IGR": "IGR",
    "RNA": "RNA", "LINCRNA": "lincRNA",
}


@register_tool("Funcotator")
def funcotator(argv):
    """Functionally annotate variants (gene, classification, protein change)."""
    from ..funcotator import gencode as gc
    from ..io import vcf as vcfio

    p = argparse.ArgumentParser(description="Funcotator")
    p.add_argument("-V", "--variant", required=True)
    p.add_argument("-R", "--reference", default=None)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("--data-sources-path", action="append", required=True)
    p.add_argument("--ref-version", default=None, help="e.g. hg19 / hg38")
    p.add_argument("--output-file-format", default="VCF", choices=["VCF", "MAF"])
    p.add_argument("--transcript-selection-mode", default="CANONICAL")
    args = p.parse_args(argv)

    from ..funcotator import datasources as dsrc

    sources, factories = dsrc.load_data_sources(args.data_sources_path,
                                                args.ref_version)
    if not sources:
        # tolerate datasource dirs given as the gencode dir itself (old layout)
        try:
            sources = [gc.GencodeDataSource.load(p, args.ref_version)
                       for p in args.data_sources_path]
        except FileNotFoundError:
            raise UserError("no gencode datasource found")

    ref_fetch = None
    if args.reference:
        from ..io import fasta as fastaio

        _ref = fastaio.FastaReference(args.reference)

        def ref_fetch(contig, start1, end1):
            try:
                end1 = min(end1, _ref.contig_length(contig))
                return _ref.fetch(contig, start1 - 1, end1).tobytes().decode()
            except (KeyError, ValueError):
                return ""

    from ..engine import walkers

    class FuncotatorWalker(walkers.VariantWalker):
        """VariantWalker traversal (Funcotator.java extends VariantWalker):
        per-record annotation with the standard lifecycle/ProgressMeter."""

        tool_name = "Funcotator"

        def on_traversal_start(self):
            self.annotated = []

        def apply(self, v):
            per_alt = []
            for alt in v.alts:
                if alt.startswith("<") or alt == "*":
                    per_alt.append(gc.Funcotation(variant_type="NA"))
                    continue
                best = None
                for ds in sources:
                    f = gc.classify(v.contig, v.pos + 1, v.ref, alt, ds,
                                    args.transcript_selection_mode,
                                    ref_fetch=ref_fetch)
                    if best is None or gc._severity(f.classification) > \
                            gc._severity(best.classification):
                        best = f
                # secondary data sources keyed by gencode gene/transcript
                extra = {}
                for fac in factories:
                    extra.update(fac.annotate(v, alt, best.hugo_symbol or None,
                                              best.transcript_id or None))
                best.extra_fields = extra
                per_alt.append(best)
            self.annotated.append((v, per_alt))

    walker = FuncotatorWalker(variant_path=args.variant)
    walker.run()
    annotated = walker.annotated
    reader = walker.variant_reader
    factory_fields = [f for fac in factories for f in fac.field_names]

    build = sources[0].build
    if args.output_file_format == "VCF":
        all_fields = FIELDS + factory_fields
        header = reader.header_lines + [
            '##INFO=<ID=FUNCOTATION,Number=A,Type=String,Description="Functional annotation from the Funcotator tool.  Funcotation fields are: '
            + "|".join(all_fields) + '">']
        w = vcfio.VcfWriter(args.output, reader.samples, extra_header_lines=header,
                            write_format=bool(reader.samples))
        for v, per_alt in annotated:
            values = []
            for alt, f in zip(v.alts, per_alt):
                end = v.pos + len(v.ref)
                vals = [f.hugo_symbol, build, v.contig, str(v.pos + 1), str(end),
                        f.classification, f.secondary, f.variant_type, v.ref, alt,
                        f.transcript_id, f.strand, f.exon, f.cdna_change,
                        f.codon_change, f.protein_change]
                extra = getattr(f, "extra_fields", {})
                vals += [extra.get(k, "") for k in factory_fields]
                values.append("[" + "|".join(x.replace("|", "_").replace(",", "_")
                                             for x in vals) + "]")
            v.info = dict(v.info)
            v.info["FUNCOTATION"] = ",".join(values)
            w.write(v)
        w.close()
    else:  # MAF
        with open(args.output, "w") as fh:
            fh.write("#version 2.4\n")
            fh.write("\t".join(MAF_COLUMNS) + "\n")
            for v, per_alt in annotated:
                for alt, f in zip(v.alts, per_alt):
                    # MAF indel conventions (mafOutput/MafOutputRendererConstants
                    # / oncotator): trim the VCF anchor base; insertions use
                    # ref '-' with [anchor, anchor+1], deletions use alt '-'
                    # spanning the deleted bases
                    ref_a, alt_a = v.ref, alt
                    start1 = v.pos + 1
                    k = 0
                    while k < min(len(ref_a), len(alt_a)) and ref_a[k] == alt_a[k]:
                        k += 1
                    if len(alt_a) > len(ref_a) and k == len(ref_a):  # insertion
                        maf_ref, maf_alt = "-", alt_a[k:]
                        maf_start = start1 + k - 1  # last shared base
                        maf_end = maf_start + 1
                    elif len(alt_a) < len(ref_a) and k == len(alt_a):  # deletion
                        maf_ref, maf_alt = ref_a[k:], "-"
                        maf_start = start1 + k
                        maf_end = maf_start + len(maf_ref) - 1
                    else:
                        maf_ref, maf_alt = ref_a, alt_a
                        maf_start = start1
                        maf_end = start1 + len(ref_a) - 1
                    fh.write("\t".join([
                        f.hugo_symbol or "Unknown", build, v.contig.lstrip("chr") or v.contig,
                        str(maf_start), str(maf_end), "+",
                        MAF_CLASSIFICATION.get(f.classification, f.classification),
                        f.variant_type, maf_ref, maf_ref, maf_alt, f.transcript_id,
                        f.cdna_change, f.codon_change, f.protein_change]) + "\n")
    print(f"annotated {len(annotated)} variants -> {args.output}")
    return 0


# ---------------------------------------------------------------------------
# FilterFuncotations (tools/funcotator/FilterFuncotations.java + filtrationRules/)
# ---------------------------------------------------------------------------

# filtrationRules/AutosomalRecessiveConstants.java:8
AUTOSOMAL_RECESSIVE_GENES = ("ATP7B", "MUTYH")
CLINVAR_SIGNIFICANCE_MATCHING = ("Pathogenic", "Likely_pathogenic",
                                 "Pathogenic/Likely_pathogenic")
CLINVAR_MAX_MAF = 0.05
LOF_MAX_MAF = 0.01
LOF_CLASSIFICATIONS = ("FRAME_SHIFT_DEL", "FRAME_SHIFT_INS", "NONSENSE",
                       "START_CODON_DEL", "SPLICE_SITE")


def _parse_funcotation_map(v, keys):
    """FUNCOTATION INFO '[a|b|c],[...]' -> per-alt {key: value} dicts."""
    raw = v.info.get("FUNCOTATION", "")
    if not raw or raw is True:
        return []
    out = []
    for part in str(raw).split("],["):
        vals = part.strip("[]").split("|")
        out.append(dict(zip(keys, vals)))
    return out


def _get_suffix(fmap, suffix, default=""):
    """Match a funcotation field by exact name or `Gencode_NN_`-style suffix."""
    for k, val in fmap.items():
        if k == suffix or k.endswith("_" + suffix):
            return val or default
    return default


def _max_maf(fmap, af_source):
    """Max sub-population allele frequency from ExAC/gnomAD funcotation fields
    (filtrationRules/AlleleFrequency{Exac,Gnomad}Utils.java)."""
    prefix = "ExAC_AF_" if af_source == "exac" else "gnomAD"
    best = 0.0
    for k, val in fmap.items():
        if (af_source == "exac" and k.startswith("ExAC_") and "_AF_" in "_" + k) or \
           (af_source == "gnomad" and k.startswith("gnomAD") and "_AF_" in k):
            try:
                best = max(best, max(float(x) for x in str(val).split("_")
                                     if x not in ("", ".")))
            except ValueError:
                continue
    return best


@register_tool("FilterFuncotations")
def filter_funcotations(argv):
    """Filter variants on clinically-significant funcotations
    (tools/funcotator/FilterFuncotations.java): CLINVAR, LOF, LMM and
    autosomal-recessive two-hit rules; non-matching records get NOT_CLINSIG."""
    p = argparse.ArgumentParser(description="FilterFuncotations")
    p.add_argument("-V", "--variant", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("--ref-version", default="hg38", choices=["b37", "hg19", "hg38"])
    p.add_argument("--allele-frequency-data-source", default="gnomad",
                   choices=["exac", "gnomad"])
    args = p.parse_args(argv)

    reader = vcfio.VcfReader(args.variant)
    keys = None
    for line in reader.header_lines:
        if line.startswith("##INFO=<ID=FUNCOTATION") and "fields are: " in line:
            keys = line.split("fields are: ")[1].split('"')[0].split("|")
    if keys is None:
        raise UserError("input VCF has no FUNCOTATION INFO header "
                        "(run Funcotator first)")

    records = list(reader)
    # first pass (ArHetvarFilter): count het calls per AR gene
    ar_het_counts = {}
    for v in records:
        fmaps = _parse_funcotation_map(v, keys)
        for fmap in fmaps:
            gene = _get_suffix(fmap, "hugoSymbol")
            if gene in AUTOSOMAL_RECESSIVE_GENES:
                for g in v.samples:
                    gt = sorted(g.get("GT", "./.").replace("|", "/").split("/"))
                    if len(gt) == 2 and gt[0] != gt[1] and "." not in gt:
                        ar_het_counts[gene] = ar_het_counts.get(gene, 0) + 1

    headers = list(reader.header_lines) + [
        '##FILTER=<ID=NOT_CLINSIG,Description="Filter for clinically insignificant variants">',
        '##INFO=<ID=CLINSIG,Number=1,Type=String,Description="Rule(s) which caused this annotation to be flagged as clinically significant.">']
    w = vcfio.VcfWriter(args.output, reader.samples, extra_header_lines=headers,
                        write_format=bool(reader.samples))
    n_sig = 0
    for v in records:
        matched = set()
        for fmap in _parse_funcotation_map(v, keys):
            maf = _max_maf(fmap, args.allele_frequency_data_source)
            # ClinVarFilter: ACMG disease + pathogenic significance + MAF<=0.05
            if (_get_suffix(fmap, "ACMG_recommendation_Disease_Name")
                    and any(s in _get_suffix(fmap, "ClinVar_VCF_CLNSIG")
                            for s in CLINVAR_SIGNIFICANCE_MATCHING)
                    and maf <= CLINVAR_MAX_MAF):
                matched.add("CLINVAR")
            # LofFilter: LoF classification + LOF mechanism + MAF<=0.01
            if (_get_suffix(fmap, "variantClassification") in LOF_CLASSIFICATIONS
                    and _get_suffix(fmap, "ACMGLMMLof_LOF_Mechanism") == "YES"
                    and maf <= LOF_MAX_MAF):
                matched.add("LOF")
            # LmmFilter: flagged by LMM
            if _get_suffix(fmap, "LMMKnown_LMM_FLAGGED").lower() == "true":
                matched.add("LMM")
            # AR two-hit: hom-var in an AR gene, or >=2 hets in the same AR gene
            gene = _get_suffix(fmap, "hugoSymbol")
            if gene in AUTOSOMAL_RECESSIVE_GENES:
                homvar = any(
                    len(set(g.get("GT", "./.").replace("|", "/").split("/"))) == 1
                    and g.get("GT", "./.").split("/")[0] not in ("0", ".")
                    for g in v.samples)
                if homvar or ar_het_counts.get(gene, 0) >= 2:
                    matched.add("AR")
        info = dict(v.info)
        if matched:
            info["CLINSIG"] = ",".join(sorted(matched))
            v.filters = ("PASS",)
            n_sig += 1
        else:
            v.filters = ("NOT_CLINSIG",)
        v.info = info
        w.write(v)
    w.close()
    print(f"FilterFuncotations: {n_sig}/{len(records)} records clinically significant")
    return 0


@register_tool("FuncotatorDataSourceDownloader")
def funcotator_data_source_downloader(argv):
    """Obtain and unpack Funcotator datasource bundles
    (tools/funcotator/FuncotatorDataSourceDownloader.java). This runtime has no
    network egress, so the tool operates on a local bundle archive
    (--local-bundle, tar.gz as distributed by the Broad) — it extracts,
    validates the per-datasource config layout, and prints the canonical
    download URLs for the germline/somatic bundles when no bundle is given."""
    p = argparse.ArgumentParser(description="FuncotatorDataSourceDownloader")
    p.add_argument("--germline", action="store_true")
    p.add_argument("--somatic", action="store_true")
    p.add_argument("--local-bundle", default=None,
                   help="local datasource .tar.gz to unpack instead of downloading")
    p.add_argument("-O", "--output", default=None, help="extraction directory")
    p.add_argument("--extract-after-download", action="store_true")
    p.add_argument("--validate-integrity", action="store_true")
    args = p.parse_args(argv)

    kind = "somatic" if args.somatic else "germline"
    urls = {
        "germline": "gs://broad-public-datasets/funcotator/funcotator_dataSources.v1.8.hg38.20230908g.tar.gz",
        "somatic": "gs://broad-public-datasets/funcotator/funcotator_dataSources.v1.8.hg38.20230908s.tar.gz",
    }
    if not args.local_bundle:
        print(f"No network egress available in this runtime; fetch the {kind} "
              f"bundle out-of-band and re-run with --local-bundle:")
        print(f"  {urls[kind]}")
        return 0
    import os
    import tarfile

    out_dir = args.output or os.path.splitext(
        os.path.splitext(os.path.basename(args.local_bundle))[0])[0]
    os.makedirs(out_dir, exist_ok=True)
    n_cfg = 0
    with tarfile.open(args.local_bundle, "r:*") as tar:
        tar.extractall(out_dir, filter="data")
    for root, _dirs, files in os.walk(out_dir):
        for f in files:
            if f.endswith(".config"):
                n_cfg += 1
                if args.validate_integrity:
                    cfg = {}
                    for line in open(os.path.join(root, f)):
                        if "=" in line:
                            k, v = line.split("=", 1)
                            cfg[k.strip()] = v.strip()
                    for req in ("name", "type"):
                        if req not in cfg:
                            from ..cli import UserError
                            raise UserError(
                                f"datasource config {f} missing '{req}'")
    print(f"extracted datasource bundle to {out_dir} ({n_cfg} datasource configs)")
    return 0
