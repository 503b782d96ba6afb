# Copied verbatim from gatk_tpu/tools/analysis_tools.py; only import lines and the ReadsPipeline --device flag (analysis_tools.py:521), passed on to HaplotypeCaller (:540), differ.
"""Analysis/validation tools: Concordance, DepthOfCoverage,
LeftAlignAndTrimVariants, VariantsToTable, ReadsPipeline.

Reference behavior: tools/walkers/validation/Concordance.java,
tools/walkers/coverage/DepthOfCoverage.java,
tools/walkers/variantutils/LeftAlignAndTrimVariants.java,
tools/walkers/variantutils/VariantsToTable.java,
tools/spark/pipelines/ReadsPipelineSpark.java.
"""
from __future__ import annotations

import argparse
import math
import re

import numpy as np

from .. import devices
from ..cli import UserError, register_tool
from ..engine import walkers
from ..engine import intervals as iv
from ..io import bam, fasta, vcf


def _genotype_alleles(v, sample_idx=0):
    """Set of called allele strings for a sample (ref + alts)."""
    if not v.samples:
        return None
    gt = v.samples[sample_idx].get("GT", ".")
    if "." in gt:
        return None
    return {v.alleles[int(i)] for i in gt.replace("|", "/").split("/")}


@register_tool("Concordance")
def concordance(argv):
    """Evaluate a callset against a truth VCF: TP/FP/FN, sensitivity, precision."""
    p = argparse.ArgumentParser(description="Concordance")
    p.add_argument("--evaluation", "-eval", required=True)
    p.add_argument("--truth", required=True)
    p.add_argument("--summary", required=True)
    p.add_argument("-L", "--intervals", action="append", default=None)
    args = p.parse_args(argv)

    def load(path):
        out = {}
        for v in vcf.VcfReader(path):
            if v.filters and v.filters != ("PASS",):
                continue  # only unfiltered/PASS records count (Concordance.java)
            for alt in v.alts:
                if alt.startswith("<") or alt == "*":
                    continue
                out[(v.contig, v.pos, v.ref, alt)] = v
        return out

    ev = load(args.evaluation)
    tr = load(args.truth)
    if args.intervals:
        ts = [iv.parse_interval(s) for s in args.intervals]

        def inside(k):
            return any(t.contig == k[0] and t.start <= k[1] < t.end for t in ts)

        ev = {k: v for k, v in ev.items() if inside(k)}
        tr = {k: v for k, v in tr.items() if inside(k)}

    def is_snp(k):
        return len(k[2]) == 1 and len(k[3]) == 1

    rows = []
    for kind, pred in (("SNP", is_snp), ("INDEL", lambda k: not is_snp(k))):
        tp = sum(1 for k in ev if k in tr and pred(k))
        fp = sum(1 for k in ev if k not in tr and pred(k))
        fn = sum(1 for k in tr if k not in ev and pred(k))
        sens = tp / (tp + fn) if tp + fn else 0.0
        prec = tp / (tp + fp) if tp + fp else 0.0
        rows.append((kind, tp, fp, fn, sens, prec))

    with open(args.summary, "w") as fh:
        fh.write("type\tTP\tFP\tFN\tSENSITIVITY\tPRECISION\n")
        for kind, tp, fp, fn, sens, prec in rows:
            fh.write(f"{kind}\t{tp}\t{fp}\t{fn}\t{sens:.3f}\t{prec:.3f}\n")
    for kind, tp, fp, fn, sens, prec in rows:
        print(f"{kind}: TP={tp} FP={fp} FN={fn} sensitivity={sens:.3f} precision={prec:.3f}")
    return 0


@register_tool("DepthOfCoverage")
def depth_of_coverage(argv):
    """Per-locus and summary depth over intervals."""
    p = argparse.ArgumentParser(description="DepthOfCoverage")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-L", "--intervals", action="append", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("--min-base-quality", type=int, default=0)
    args = p.parse_args(argv)

    from ..engine import pileup as pileup_mod

    reader = bam.BamReader(args.input)
    lengths = {s.name: s.length for s in reader.header.sequences}
    lines = ["Locus\tTotal_Depth\tAverage_Depth_sample\tDepth_for_sample"]
    total = 0
    n_loci = 0
    for s in args.intervals:
        t = iv.parse_interval(s, lengths)
        depth = np.zeros(t.end - t.start, np.int64)
        for r in reader.query(t.contig, t.start, t.end):
            if r.is_unmapped or r.is_duplicate or r.is_secondary:
                continue
            pos, base, qual, flags = pileup_mod.expand_read(r)
            keep = (pos >= t.start) & (pos < t.end) & (qual >= args.min_base_quality) \
                & ((flags & pileup_mod.F_DELETION) == 0)
            np.add.at(depth, pos[keep] - t.start, 1)
        for i, d in enumerate(depth):
            lines.append(f"{t.contig}:{t.start + i + 1}\t{d}\t{d:.2f}\t{d}")
        total += int(depth.sum())
        n_loci += len(depth)
    with open(args.output, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    print(f"mean depth {total / max(n_loci, 1):.2f} over {n_loci} loci")
    return 0


def left_align_variant(v, ref_fetch):
    """Shift an indel to its leftmost representation and trim shared bases
    (LeftAlignAndTrimVariants / GATKVariantContextUtils.leftAlignAndTrim)."""
    if len(v.alts) != 1 or v.alts[0].startswith("<") or v.alts[0] == "*":
        return v
    ref, alt, pos = v.ref, v.alts[0], v.pos
    if len(ref) == len(alt):
        return v
    # left-shift: while both alleles end with the same base, strip it and
    # prepend the previous reference base
    while pos > 0 and ref[-1] == alt[-1]:
        prev = ref_fetch(v.contig, pos - 1)
        ref = prev + ref[:-1]
        alt = prev + alt[:-1]
        pos -= 1
    # trim common suffix (keep >=1 base each)
    while len(ref) > 1 and len(alt) > 1 and ref[-1] == alt[-1]:
        ref, alt = ref[:-1], alt[:-1]
    # trim common prefix (keep the 1-base indel anchor)
    while len(ref) > 1 and len(alt) > 1 and ref[0] == alt[0] and ref[1] == alt[1]:
        ref, alt = ref[1:], alt[1:]
        pos += 1
    v.pos, v.ref, v.alts = pos, ref, (alt,)
    return v


@register_tool("LeftAlignAndTrimVariants")
def left_align_and_trim(argv):
    """Left-align indels and trim shared bases."""
    p = argparse.ArgumentParser(description="LeftAlignAndTrimVariants")
    p.add_argument("-V", "--variant", required=True)
    p.add_argument("-R", "--reference", required=True)
    p.add_argument("-O", "--output", required=True)
    args = p.parse_args(argv)

    ref = fasta.FastaReference(args.reference)
    cache = {}

    def fetch1(contig, pos):
        if contig not in cache:
            cache.clear()
            cache[contig] = bytes(ref.fetch(contig, 0, ref.contig_length(contig))).upper()
        return chr(cache[contig][pos])

    reader = vcf.VcfReader(args.variant)
    out = [left_align_variant(v, fetch1) for v in reader]
    out.sort(key=lambda v: (v.contig, v.pos))
    w = vcf.VcfWriter(args.output, reader.samples, extra_header_lines=reader.header_lines)
    for v in out:
        w.write(v)
    w.close()
    print(f"wrote {len(out)} records")
    return 0


@register_tool("VariantsToTable")
def variants_to_table(argv):
    """Extract VCF fields into a TSV (VariantsToTable.java:122-585; byte-level
    quirks reproduced: htsjdk phred-qual round-trip, '[x, y]' bracket-strip
    leading spaces on split AS fields, FT-unfiltered -> NA, molten AS skip)."""
    p = argparse.ArgumentParser(description="VariantsToTable")
    p.add_argument("-V", "--variant", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("-F", "--fields", action="append", default=[])
    p.add_argument("-GF", "--genotype-fields", action="append", default=[])
    p.add_argument("-ASF", "--as-fields", action="append", default=[])
    p.add_argument("-ASGF", "--as-genotype-fields", action="append",
                   default=[])
    p.add_argument("-SMA", "--split-multi-allelic", action="store_true")
    p.add_argument("--moltenize", action="store_true")
    p.add_argument("-raw", "--show-filtered", action="store_true")
    p.add_argument("-EMD", "--error-if-missing-data", action="store_true")
    p.add_argument("-L", "--intervals", action="append", default=None)
    args = p.parse_args(argv)
    w = _VariantsToTableWalker(variant_path=args.variant,
                               intervals=args.intervals)
    w.args = args
    w.run()
    return 0


_NA = "NA"


def _java_phred_qual(q):
    """Double.toString(vc.getPhredScaledQual()): the parse/-10 store/*-10 read
    round trip reintroduces binary noise (469.32 -> 469.32000000000005);
    missing qual prints -10.0 (htsjdk NO_LOG10_PERROR = 1)."""
    if q is None:
        return "-10.0"
    return repr(-10.0 * (q / -10.0))


def _vc_type(v):
    """htsjdk VariantContext.Type strings."""
    if not v.alts:
        return "NO_VARIATION"
    kinds = set()
    for a in v.alts:
        if a.startswith("<") or a == "*" or "[" in a or "]" in a:
            kinds.add("SYMBOLIC")
        elif len(a) == len(v.ref):
            kinds.add("SNP" if len(a) == 1 else "MNP")
        else:
            kinds.add("INDEL")
    return kinds.pop() if len(kinds) == 1 else "MIXED"


_TRANSITIONS = {("A", "G"), ("G", "A"), ("C", "T"), ("T", "C")}


def _gt_type(gt):
    """htsjdk GenotypeType from a GT string."""
    alleles = gt.replace("|", "/").split("/")
    called = [a for a in alleles if a != "."]
    if not called:
        return "NO_CALL"
    if len(called) != len(alleles):
        return "MIXED"
    if all(a == "0" for a in called):
        return "HOM_REF"
    if len(set(called)) == 1:
        return "HOM_VAR"
    return "HET"


class _VariantsToTableWalker(walkers.VariantWalker):
    """VariantsToTable as a VariantWalker (tools/walkers/variantutils/
    VariantsToTable.java extends VariantWalker)."""

    tool_name = "VariantsToTable"
    default_read_filters = ()

    # ---- standard getters (VariantsToTable.java:526-575) ----

    def _count_gt(self, v, want):
        return str(sum(1 for s in v.samples
                       if _gt_type(s.get("GT", ".")) == want))

    def _getter(self, field, v):
        if field == "CHROM":
            return v.contig
        if field == "POS":
            return str(v.pos + 1)
        if field == "REF":
            return v.ref
        if field == "ALT":
            return ",".join(v.alts) if v.alts else "."
        if field == "EVENTLENGTH":
            max_len = 0
            for a in v.alts:
                ln = len(a) - len(v.ref)
                if abs(ln) > abs(max_len):
                    max_len = ln
            return str(max_len)
        if field == "QUAL":
            return _java_phred_qual(v.qual)
        if field == "TRANSITION":
            if len(v.alts) == 1 and len(v.ref) == 1 and len(v.alts[0]) == 1 \
                    and v.alts[0] not in ("*",) and not v.alts[0].startswith("<"):
                return "1" if (v.ref, v.alts[0]) in _TRANSITIONS else "0"
            return "-1"
        if field == "FILTER":
            return "PASS" if self._not_filtered(v) else ",".join(v.filters)
        if field == "ID":
            return v.id
        if field == "HET":
            return self._count_gt(v, "HET")
        if field == "HOM-REF":
            return self._count_gt(v, "HOM_REF")
        if field == "HOM-VAR":
            return self._count_gt(v, "HOM_VAR")
        if field == "NO-CALL":
            return self._count_gt(v, "NO_CALL")
        if field == "TYPE":
            return _vc_type(v)
        if field == "VAR":
            return str(int(self._count_gt(v, "HET")) +
                       int(self._count_gt(v, "HOM_VAR")))
        if field == "NSAMPLES":
            return str(len(v.samples))
        if field == "NCALLED":
            return str(len(v.samples) - int(self._count_gt(v, "NO_CALL")))
        if field == "MULTI-ALLELIC":
            return "true" if len(v.alts) > 1 else "false"
        if field == "SAMPLE_NAME":
            return self.variant_reader.samples[0]
        return None

    _GETTER_NAMES = frozenset(
        ["CHROM", "POS", "REF", "ALT", "EVENTLENGTH", "QUAL", "TRANSITION",
         "FILTER", "ID", "HET", "HOM-REF", "HOM-VAR", "NO-CALL", "TYPE",
         "VAR", "NSAMPLES", "NCALLED", "MULTI-ALLELIC", "SAMPLE_NAME"])

    @staticmethod
    def _not_filtered(v):
        return not v.filters or v.filters == ("PASS",)

    def on_traversal_start(self):
        args = self.args
        rdr = self.variant_reader
        self.fields = list(args.fields)
        self.gfs = list(args.genotype_fields)
        self.asfs = list(args.as_fields)
        self.asgfs = list(args.as_genotype_fields)
        # header Number= count types for AS splitting (A vs R)
        self.count_type = {}
        for line in rdr.header_lines:
            m = re.match(r"##(INFO|FORMAT)=<ID=([^,]+),Number=([^,]+)", line)
            if m:
                self.count_type[(m.group(1), m.group(2))] = m.group(3)
        # default fields: mandatory columns + header INFO ids + FORMAT (GT 1st)
        if not (self.fields or self.gfs or self.asfs or self.asgfs):
            self.fields = ["CHROM", "POS", "ID", "REF", "ALT", "QUAL",
                           "FILTER"]
            self.fields += sorted(k for t, k in self.count_type
                                  if t == "INFO")
            fmts = sorted(k for t, k in self.count_type if t == "FORMAT")
            if "GT" in fmts:
                fmts.remove("GT")
                fmts.insert(0, "GT")
            self.gfs = fmts
        if self.gfs or self.asgfs:
            self.samples = sorted(set(rdr.samples))
            if not self.samples:
                self.gfs, self.asgfs = [], []
        else:
            self.samples = []
        self.sample_idx = {s: i for i, s in enumerate(rdr.samples)}
        self.n_records = 0
        self.out_lines = []
        if args.moltenize:
            self.out_lines.append("RecordID\tSample\tVariable\tValue")
        else:
            cols = self.fields + self.asfs + [
                f"{s.replace(' ', '_')}.{g}" for s in self.samples
                for g in self.gfs + self.asgfs]
            self.out_lines.append("\t".join(cols))

    # ---- value plumbing (addFieldValue / prettyPrintObject) ----

    @staticmethod
    def _add(val, records):
        if len(records) == 1:
            records[0].append(",".join(val) if isinstance(val, list)
                              else str(val))
        elif isinstance(val, list) and len(val) == len(records):
            for rec, item in zip(records, val):
                rec.append(str(item))
        else:
            s = ",".join(val) if isinstance(val, list) else str(val)
            for rec in records:
                rec.append(s)

    def _missing(self, field, records, v):
        if self.args.error_if_missing_data:
            raise UserError(f"Missing field {field} in vc at "
                            f"{v.contig}:{v.pos + 1}")
        self._add(_NA, records)

    def _add_as(self, parts, records, number):
        """addAlleleSpecificFieldValue: R-type drops the ref section."""
        if number == "R":
            parts = parts[1:]
        self._add(parts, records)

    def _gt_string(self, v, sample):
        gt = sample.get("GT", "./.")
        sep = "|" if "|" in gt else "/"
        out = []
        for a in gt.replace("|", "/").split("/"):
            out.append("." if a == "." else v.alleles[int(a)])
        return sep.join(out)

    def extract_fields(self, v):
        split = self.args.split_multi_allelic
        n = len(v.alts) if split else 1
        records = [[] for _ in range(n)]  # SMA with 0 alts emits no rows
        for field in self.fields:
            if split and field == "ALT":
                self._add(list(v.alts) if len(v.alts) > 1 else v.alts[0],
                          records)
            elif field in self._GETTER_NAMES:
                self._add(self._getter(field, v), records)
            elif field in v.info:
                raw = v.info[field]
                if raw is True:
                    self._add("true", records)
                elif "," in raw:
                    self._add(raw.split(","), records)  # htsjdk List attr
                else:
                    self._add(raw, records)
            elif field.endswith("*"):
                pre = field[:-1]
                vals = sorted({("true" if val is True else str(val))
                               for key, val in v.info.items()
                               if key.startswith(pre)})
                self._add(",".join(vals) if vals else _NA, records)
            else:
                self._missing(field, records, v)
        for field in self.asfs:
            if field in v.info:
                raw = str(v.info[field])
                if split:
                    # getAttributeAsString on a List: "[a, b]" -> strip
                    # brackets -> split "," keeps the leading spaces
                    parts = raw.split(",")
                    parts = parts[:1] + [" " + p for p in parts[1:]]
                    self._add_as(parts, records,
                                 self.count_type.get(("INFO", field)))
                else:
                    self._add(raw.replace(",", ", "), records)
            else:
                self._missing(field, records, v)
        if self.gfs or self.asgfs:
            self._genotype_fields(v, records)
        return records

    def _genotype_fields(self, v, records):
        split = self.args.split_multi_allelic
        for name in self.samples:
            si = self.sample_idx.get(name)
            sample = v.samples[si] if si is not None and \
                si < len(v.samples) else {}
            for gf in self.gfs:
                val = sample.get(gf)
                if gf == "GT" and "GT" in sample:
                    self._add(self._gt_string(v, sample), records)
                elif val is None or val == "." or \
                        (gf == "FT" and val == "."):
                    self._missing(gf, records, v)
                elif gf == "GQ":
                    # htsjdk stores GQ as int: Math.round of the parsed value
                    self._add(str(math.floor(float(val) + 0.5)), records)
                else:
                    self._add(val, records)  # raw text, never split (arrays)
            for gf in self.asgfs:
                val = sample.get(gf)
                if val is None or val == ".":
                    self._missing(gf, records, v)
                elif split:
                    if gf == "AD":
                        depths = val.split(",")
                        self._add([f"{depths[0]},{d}" for d in depths[1:]],
                                  records)
                    else:
                        self._add_as(val.split(","), records,
                                     self.count_type.get(("FORMAT", gf)))
                else:
                    self._add(val, records)

    def apply(self, v):
        if not (self.args.show_filtered or self._not_filtered(v)):
            return
        self.n_records += 1
        for rec in self.extract_fields(v):
            if self.args.moltenize:
                self._emit_molten(rec)
            else:
                self.out_lines.append("\t".join(rec))

    def _emit_molten(self, rec):
        # emitMoltenizedOutput: -F fields as "site" rows, then sample x GF
        # rows reading the record sequentially — when -ASF fields are present
        # their values get attributed to the GF rows (reference quirk
        # :326-341, index++ runs straight past the AS columns)
        idx = 0
        for field in self.fields:
            self.out_lines.append(
                f"{self.n_records}\tsite\t{field}\t{rec[idx]}")
            idx += 1
        for name in self.samples:
            for gf in self.gfs:
                self.out_lines.append(
                    f"{self.n_records}\t{name.replace(' ', '_')}\t{gf}\t"
                    f"{rec[idx]}")
                idx += 1

    def on_traversal_success(self):
        with open(self.args.output, "w") as fh:
            fh.write("\n".join(self.out_lines) + "\n")
        print(f"wrote {self.n_records} records")


@register_tool("ReadsPipeline")
def reads_pipeline(argv):
    """MarkDuplicates -> BQSR -> HaplotypeCaller in one command
    (ReadsPipelineSpark equivalent, single-host)."""
    p = argparse.ArgumentParser(description="ReadsPipeline")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-R", "--reference", required=True)
    p.add_argument("--known-sites", action="append", default=[])
    p.add_argument("-O", "--output", required=True, help="output VCF")
    p.add_argument("-L", "--intervals", action="append", default=None)
    p.add_argument("--emit-ref-confidence", "-ERC", choices=["NONE", "GVCF"], default="NONE")
    p.add_argument("--adaptive-pruning", action="store_true")
    p.add_argument("--max-reads-per-alignment-start", type=int, default=50)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the PairHMM runs: the CUDA kernel, or its plain "
                        "PyTorch version on the host")
    args = p.parse_args(argv)
    devices.set_default_device(args.device)

    import tempfile

    from . import bqsr_tools, hc_tool

    with tempfile.TemporaryDirectory() as td:
        md_bam = f"{td}/md.bam"
        bqsr_tools.mark_duplicates_tool(["-I", args.input, "-O", md_bam])
        final_bam = md_bam
        if args.known_sites:
            table = f"{td}/recal.table"
            recal_args = ["-I", md_bam, "-R", args.reference, "-O", table]
            for ks in args.known_sites:
                recal_args += ["--known-sites", ks]
            bqsr_tools.base_recalibrator(recal_args)
            final_bam = f"{td}/recal.bam"
            bqsr_tools.apply_bqsr(["-I", md_bam, "--bqsr-recal-file", table, "-O", final_bam])
        hc_args = ["-I", final_bam, "-R", args.reference, "-O", args.output,
                   "-ERC", args.emit_ref_confidence, "--device", args.device,
                   "--max-reads-per-alignment-start", str(args.max_reads_per_alignment_start)]
        if args.adaptive_pruning:
            hc_args.append("--adaptive-pruning")
        if args.intervals:
            for s in args.intervals:
                hc_args += ["-L", s]
        hc_tool.haplotype_caller(hc_args)
    print(f"pipeline complete -> {args.output}")
    return 0
