# Copied verbatim from gatk_tpu/tools/misc_tools.py; only import lines may differ.
"""Small diagnostic/utility tool tranche.

Reference tools: PrintReadsHeader.java, CountBasesInReference (ReferenceWalker
example family), PrintBGZFBlockInformation.java, DumpTabixIndex.java,
CompareIntervalLists.java, CompareBaseQualities.java,
FixMisencodedBaseQualityReads.java, AddOriginalAlignmentTags.java,
AnnotateVcfWithBamDepth.java, RemoveNearbyIndels.java, HtsgetReader.java,
GtfToBed.java, LeftAlignIndels.java.
"""
from __future__ import annotations

import argparse

import numpy as np

from .. import devices
from ..cli import UserError, register_tool
from ..engine import intervals as iv
from ..io import bam as bamio, sam as samio, vcf as vcfio


@register_tool("PrintReadsHeader")
def print_reads_header(argv):
    """Write the SAM header of a reads file (PrintReadsHeader.java)."""
    p = argparse.ArgumentParser(description="PrintReadsHeader")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-O", "--output", required=True)
    args = p.parse_args(argv)
    from ..io.cram import open_reads

    reads = open_reads(args.input)
    with open(args.output, "w") as fh:
        fh.write(reads.header.text)
    return 0


@register_tool("CountBasesInReference")
def count_bases_in_reference(argv):
    """Count reference bases by symbol (ReferenceWalker traversal)."""
    p = argparse.ArgumentParser(description="CountBasesInReference")
    p.add_argument("-R", "--reference", required=True)
    p.add_argument("-L", "--intervals", action="append", default=None)
    args = p.parse_args(argv)
    from ..engine.walkers import ReferenceWalker

    counts: dict[str, int] = {}

    class W(ReferenceWalker):
        tool_name = "CountBasesInReference"

        def apply(self, ctx):
            arr = np.frombuffer(bytes(ctx.bases()), np.uint8)
            for b, n in zip(*np.unique(arr, return_counts=True)):
                key = chr(b).upper()
                counts[key] = counts.get(key, 0) + int(n)

    W(reference_path=args.reference, intervals=args.intervals).run()
    total = sum(counts.values())
    for k in sorted(counts):
        print(f"{k}\t{counts[k]}")
    print(f"total\t{total}")
    return 0


@register_tool("PrintBGZFBlockInformation")
def print_bgzf_block_information(argv):
    """Print the offset/size of every BGZF block (PrintBGZFBlockInformation.java)."""
    p = argparse.ArgumentParser(description="PrintBGZFBlockInformation")
    p.add_argument("--bgzf-file", required=True)
    args = p.parse_args(argv)
    from ..io.bgzf import _read_block_size

    with open(args.bgzf_file, "rb") as fh:
        data = fh.read()
    off = n = 0
    while off < len(data):
        bsize = _read_block_size(data, off)
        import zlib

        # ISIZE: last 4 bytes of the gzip member = uncompressed size
        isize = int.from_bytes(data[off + bsize - 4 : off + bsize], "little")
        n += 1
        print(f"Block #{n} at file offset {off}: compressed size {bsize}, "
              f"uncompressed size {isize}")
        if bsize == 28 and isize == 0:
            print("(BGZF EOF marker)")
        off += bsize
    print(f"{n} BGZF blocks total")
    return 0


@register_tool("DumpTabixIndex")
def dump_tabix_index(argv):
    """Textual dump of a .tbi index (DumpTabixIndex.java)."""
    p = argparse.ArgumentParser(description="DumpTabixIndex")
    p.add_argument("--tabix-index", required=True)
    p.add_argument("-O", "--output", required=True)
    args = p.parse_args(argv)
    from ..io.tabix import TbxIndex

    idx = TbxIndex(args.tabix_index)
    with open(args.output, "w") as fh:
        fh.write(f"format: {idx.fmt}  colSeq: {idx.col_seq}  colBeg: {idx.col_beg}"
                 f"  colEnd: {idx.col_end}  meta: {chr(idx.meta)}  skip: {idx.skip}\n")
        fh.write(f"sequences: {len(idx.names)}\n")
        for name in idx.names:
            tid = idx.tid[name]
            bins, linear = idx.bins[tid], idx.linear[tid]
            fh.write(f"{name}: {len(bins)} bins, {len(linear)} linear-index entries\n")
            for b in sorted(bins):
                fh.write(f"  bin {b}: {len(bins[b])} chunks\n")
    return 0


@register_tool("CompareIntervalLists")
def compare_interval_lists(argv):
    """Compare two interval lists for equal genomic territory
    (CompareIntervalLists.java)."""
    p = argparse.ArgumentParser(description="CompareIntervalLists")
    p.add_argument("-L", required=True, dest="first")
    p.add_argument("-L2", required=True, dest="second")
    p.add_argument("-R", "--reference", default=None)
    args = p.parse_args(argv)

    def load(path):
        spans = {}
        for itv in iv.load_interval_file(path):
            spans.setdefault(itv.contig, []).append((itv.start, itv.end))
        return {c: _merge(v) for c, v in spans.items()}

    a, b = load(args.first), load(args.second)
    if a == b:
        print("Interval lists are equal")
        return 0
    only_a = _territory_diff(a, b)
    only_b = _territory_diff(b, a)
    print(f"Interval lists differ: {only_a} bp only in {args.first}, "
          f"{only_b} bp only in {args.second}")
    raise UserError("Interval lists differ")


def _merge(spans):
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _territory_diff(a, b):
    total = 0
    for contig, spans in a.items():
        other = b.get(contig, [])
        for s, e in spans:
            covered = sum(max(0, min(e, oe) - max(s, os_)) for os_, oe in other)
            total += (e - s) - covered
    return total


@register_tool("CompareBaseQualities")
def compare_base_qualities(argv):
    """Compare base qualities of two name-matched BAMs (CompareBaseQualities.java)."""
    p = argparse.ArgumentParser(description="CompareBaseQualities")
    p.add_argument("inputs", nargs=2)
    p.add_argument("--throw-on-diff", action="store_true")
    args = p.parse_args(argv)
    from ..io.cram import open_reads

    def keyed(path):
        out = {}
        for r in open_reads(path):
            out[(r.name, r.flag & 0xC0)] = r.quals
        return out

    a, b = keyed(args.inputs[0]), keyed(args.inputs[1])
    if set(a) != set(b):
        raise UserError("BAMs contain different reads")
    n_diff = sum(0 if np.array_equal(a[k], b[k]) else 1 for k in a)
    print(f"{len(a)} reads compared; {n_diff} with differing quals")
    if n_diff and args.throw_on_diff:
        raise UserError(f"{n_diff} reads differ in base qualities")
    return 0


@register_tool("FixMisencodedBaseQualityReads")
def fix_misencoded_base_quality_reads(argv):
    """Rewrite Illumina-1.5 (+64) quals to standard +33
    (FixMisencodedBaseQualityReads.java via MisencodedBaseQualityReadTransformer)."""
    p = argparse.ArgumentParser(description="FixMisencodedBaseQualityReads")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-O", "--output", required=True)
    args = p.parse_args(argv)
    from ..engine.transformers import misencoded_quals
    from ..io.cram import open_reads

    src = open_reads(args.input)
    w = bamio.BamWriter(args.output, src.header)
    n = 0
    for r in src:
        w.write(misencoded_quals(r))
        n += 1
    w.close()
    print(f"fixed {n} reads")
    return 0


@register_tool("AddOriginalAlignmentTags")
def add_original_alignment_tags(argv):
    """Add OA (original alignment) and XM (mate contig) tags
    (AddOriginalAlignmentTags.java)."""
    p = argparse.ArgumentParser(description="AddOriginalAlignmentTags")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-O", "--output", required=True)
    args = p.parse_args(argv)
    from ..io.cram import open_reads

    src = open_reads(args.input)
    names = [s.name for s in src.header.sequences]
    w = bamio.BamWriter(args.output, src.header)
    n = 0
    for r in src:
        contig = names[r.ref_id] if 0 <= r.ref_id < len(names) else "*"
        strand = "-" if r.is_reverse else "+"
        cigar = samio.cigar_to_string(r.cigar_ops, r.cigar_lens) or "*"
        r.tags["OA"] = f"{contig},{r.pos + 1},{strand},{cigar},{r.mapq},;"
        mate = (names[r.mate_ref_id]
                if 0 <= r.mate_ref_id < len(names) else "*")
        r.tags["XM"] = mate
        w.write(r)
        n += 1
    w.close()
    print(f"tagged {n} reads")
    return 0


@register_tool("AnnotateVcfWithBamDepth")
def annotate_vcf_with_bam_depth(argv):
    """Add BAM_DEPTH INFO = pileup depth in a BAM at each variant site
    (AnnotateVcfWithBamDepth.java)."""
    p = argparse.ArgumentParser(description="AnnotateVcfWithBamDepth")
    p.add_argument("-V", "--variant", required=True)
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-O", "--output", required=True)
    args = p.parse_args(argv)
    from ..io.cram import open_reads

    reads = open_reads(args.input)
    reader = vcfio.VcfReader(args.variant)
    headers = list(reader.header_lines) + [
        '##INFO=<ID=BAM_DEPTH,Number=1,Type=Integer,Description="pileup depth">']
    w = vcfio.VcfWriter(args.output, reader.samples, extra_header_lines=headers)
    n = 0
    for v in reader:
        depth = sum(1 for r in reads.query(v.contig, v.pos, v.pos + 1)
                    if not r.is_unmapped and not r.is_duplicate
                    and not r.is_secondary and not r.is_supplementary)
        info = dict(v.info)
        info["BAM_DEPTH"] = str(depth)
        v.info = info
        w.write(v)
        n += 1
    w.close()
    print(f"annotated {n} variants")
    return 0


@register_tool("RemoveNearbyIndels")
def remove_nearby_indels(argv):
    """Drop indels within --min-indel-spacing of another indel
    (RemoveNearbyIndels.java)."""
    p = argparse.ArgumentParser(description="RemoveNearbyIndels")
    p.add_argument("-V", "--variant", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("--min-indel-spacing", type=int, default=50)
    args = p.parse_args(argv)

    reader = vcfio.VcfReader(args.variant)
    records = list(reader)

    def is_indel(v):
        return any(len(a) != len(v.ref) for a in v.alts)

    keep = [True] * len(records)
    last_indel = None
    for i, v in enumerate(records):
        if not is_indel(v):
            continue
        if (last_indel is not None
                and v.contig == records[last_indel].contig
                and v.pos - records[last_indel].pos < args.min_indel_spacing):
            keep[i] = False
            keep[last_indel] = False
        last_indel = i
    w = vcfio.VcfWriter(args.output, reader.samples,
                        extra_header_lines=reader.header_lines)
    n = 0
    for v, k in zip(records, keep):
        if k:
            w.write(v)
            n += 1
    w.close()
    print(f"kept {n} of {len(records)} variants")
    return 0


@register_tool("HtsgetReader")
def htsget_reader(argv):
    """Download reads for an ID from an htsget server (HtsgetReader.java)."""
    p = argparse.ArgumentParser(description="HtsgetReader")
    p.add_argument("--url", required=True, help="htsget endpoint")
    p.add_argument("--id", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("--reference-name", default=None)
    p.add_argument("--start", type=int, default=None)
    p.add_argument("--end", type=int, default=None)
    args = p.parse_args(argv)
    from ..io.htsget import download_reads

    download_reads(args.url, args.id, args.output,
                   reference_name=args.reference_name,
                   start=args.start, end=args.end)
    print(f"wrote {args.output}")
    return 0


@register_tool("GtfToBed")
def gtf_to_bed(argv):
    """Extract gene (or transcript) records from a GTF into BED
    (GtfToBed.java)."""
    p = argparse.ArgumentParser(description="GtfToBed")
    p.add_argument("-G", "--gtf-path", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("--sort-by-transcript", action="store_true")
    args = p.parse_args(argv)
    import gzip

    feature_type = "transcript" if args.sort_by_transcript else "gene"
    op = gzip.open if args.gtf_path.endswith(".gz") else open
    rows = []
    with op(args.gtf_path, "rt") as fh:
        for line in fh:
            if line.startswith("#"):
                continue
            f = line.rstrip("\n").split("\t")
            if len(f) < 9 or f[2] != feature_type:
                continue
            attrs = f[8]
            name = ""
            for key in ("gene_name", "transcript_id", "gene_id"):
                tag = key + ' "'
                if tag in attrs:
                    name = attrs.split(tag, 1)[1].split('"', 1)[0]
                    break
            rows.append((f[0], int(f[3]) - 1, int(f[4]), name))
    rows.sort()
    with open(args.output, "w") as fh:
        for contig, start, end, name in rows:
            fh.write(f"{contig}\t{start}\t{end}\t{name}\n")
    print(f"wrote {len(rows)} {feature_type} records")
    return 0


@register_tool("LeftAlignIndels")
def left_align_indels(argv):
    """Left-align indels in read cigars against the reference
    (LeftAlignIndels.java via CigarUtils.leftAlignCigarSequentially)."""
    p = argparse.ArgumentParser(description="LeftAlignIndels")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-R", "--reference", required=True)
    p.add_argument("-O", "--output", required=True)
    args = p.parse_args(argv)
    from ..io import fasta
    from ..io.cram import open_reads

    ref = fasta.FastaReference(args.reference)
    src = open_reads(args.input, reference=ref)
    names = [s.name for s in src.header.sequences]
    w = bamio.BamWriter(args.output, src.header)
    n = n_changed = 0
    for r in src:
        n += 1
        if (not r.is_unmapped and 0 <= r.ref_id < len(names)
                and any(op in (samio.OP_I, samio.OP_D) for op in r.cigar_ops)):
            contig = names[r.ref_id]
            ref_seg = ref.fetch(contig, r.pos, r.end)
            new_ops, new_lens = _left_align_cigar(
                r.cigar_ops, r.cigar_lens, bytes(r.bases), bytes(ref_seg))
            if (new_ops != list(r.cigar_ops) or new_lens != list(r.cigar_lens)):
                r.cigar_ops = np.array(new_ops, np.uint8)
                r.cigar_lens = np.array(new_lens, np.int32)
                n_changed += 1
        w.write(r)
    w.close()
    print(f"left-aligned {n_changed} of {n} reads")
    return 0


def _left_align_cigar(ops, lens, read_bases: bytes, ref_bases: bytes):
    """Shift each I/D run left while the repeated sequence allows
    (AlignmentUtils.leftAlignIndels core loop)."""
    ops = [int(o) for o in ops]
    lens = [int(l) for l in lens]
    from ..io import sam

    changed = True
    while changed:
        changed = False
        read_pos = ref_pos = 0
        for i, (op, ln) in enumerate(zip(ops, lens)):
            if op in (sam.OP_I, sam.OP_D) and i > 0 and ops[i - 1] == sam.OP_M:
                seq = (read_bases[read_pos : read_pos + ln] if op == sam.OP_I
                       else ref_bases[ref_pos : ref_pos + ln])
                shift = 0
                while (shift < lens[i - 1]
                       and read_pos - shift - 1 >= 0 and ref_pos - shift - 1 >= 0
                       and read_bases[read_pos - shift - 1]
                       == seq[(ln - 1 - (shift % ln))]
                       and ref_bases[ref_pos - shift - 1]
                       == seq[(ln - 1 - (shift % ln))]):
                    shift += 1
                if shift > 0:
                    lens[i - 1] -= shift
                    if i + 1 < len(ops) and ops[i + 1] == sam.OP_M:
                        lens[i + 1] += shift
                    else:
                        ops.insert(i + 1, sam.OP_M)
                        lens.insert(i + 1, shift)
                    if lens[i - 1] == 0:
                        del ops[i - 1]
                        del lens[i - 1]
                    changed = True
                    break
            if sam.CONSUMES_READ[op]:
                read_pos += ln
            if sam.CONSUMES_REF[op]:
                ref_pos += ln
    return ops, lens


@register_tool("GatherPileupSummaries")
def gather_pileup_summaries(argv):
    """Concatenate scattered GetPileupSummaries tables
    (GatherPileupSummaries.java)."""
    p = argparse.ArgumentParser(description="GatherPileupSummaries")
    p.add_argument("-I", "--input", action="append", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("--sequence-dictionary", default=None)
    args = p.parse_args(argv)
    from ..mutect.contamination import read_pileup_table, write_pileup_table

    sample = None
    sites = []
    for path in args.input:
        s, rows = read_pileup_table(path)
        if sample is None:
            sample = s
        elif s != sample:
            raise UserError(f"sample mismatch: {s} vs {sample}")
        sites.extend(rows)
    write_pileup_table(args.output, sample or "SAMPLE", sites)
    print(f"gathered {len(sites)} sites from {len(args.input)} tables")
    return 0


@register_tool("CalculateMixingFractions")
def calculate_mixing_fractions(argv):
    """Estimate per-sample mixing fractions of a pooled BAM from sample-private
    het SNPs (CalculateMixingFractions.java): for each sample, the fraction is
    proportional to the mean alt fraction at sites where only that sample is
    het, normalized over samples."""
    p = argparse.ArgumentParser(description="CalculateMixingFractions")
    p.add_argument("-V", "--variant", required=True, help="multi-sample VCF")
    p.add_argument("-I", "--input", required=True, help="pooled BAM")
    p.add_argument("-O", "--output", required=True)
    args = p.parse_args(argv)
    from ..io.cram import open_reads

    reader = vcfio.VcfReader(args.variant)
    samples = reader.samples
    reads = open_reads(args.input)
    alt_frac_sum = {s: 0.0 for s in samples}
    site_count = {s: 0 for s in samples}
    for v in reader:
        if len(v.alts) != 1 or len(v.ref) != 1 or len(v.alts[0]) != 1:
            continue
        hets = [i for i, sm in enumerate(v.samples)
                if sorted(sm.get("GT", "./.").replace("|", "/").split("/")) == ["0", "1"]]
        homref = [i for i, sm in enumerate(v.samples)
                  if sm.get("GT", "./.").replace("|", "/") in ("0/0",)]
        if len(hets) != 1 or len(hets) + len(homref) != len(samples):
            continue  # sample-private het sites only
        ref_b, alt_b = ord(v.ref), ord(v.alts[0])
        n_ref = n_alt = 0
        from ..calling.annotations import read_offset_at

        for r in reads.query(v.contig, v.pos, v.pos + 1):
            if r.is_unmapped or r.is_duplicate or r.is_secondary or r.mapq < 20:
                continue
            off = read_offset_at(r, v.pos)
            if off is None:
                continue
            b = r.bases[off]
            if b == ref_b:
                n_ref += 1
            elif b == alt_b:
                n_alt += 1
        if n_ref + n_alt >= 10:
            s = samples[hets[0]]
            alt_frac_sum[s] += n_alt / (n_ref + n_alt)
            site_count[s] += 1
    # a het in sample s at fraction f implies mixing fraction 2f
    raw = {s: (2.0 * alt_frac_sum[s] / site_count[s] if site_count[s] else 0.0)
           for s in samples}
    total = sum(raw.values()) or 1.0
    with open(args.output, "w") as fh:
        fh.write("SAMPLE\tMIXING_FRACTION\n")
        for s in samples:
            fh.write(f"{s}\t{raw[s] / total:.4f}\n")
    print(f"wrote mixing fractions for {len(samples)} samples")
    return 0


@register_tool("AnalyzeCovariates")
def analyze_covariates(argv):
    """Summarize before/after BQSR recalibration tables into a csv of
    quality-vs-covariate rows (AnalyzeCovariates.java; the reference also
    renders a PDF via R — here the csv is the artifact, matching its
    intermediate .csv output)."""
    p = argparse.ArgumentParser(description="AnalyzeCovariates")
    p.add_argument("-before", "--before-report-file", default=None)
    p.add_argument("-after", "--after-report-file", default=None)
    p.add_argument("-bqsr", "--bqsr-recal-file", default=None)
    p.add_argument("--intermediate-csv-file", "-csv", dest="csv", required=True)
    args = p.parse_args(argv)
    from ..recal.report import parse_report

    inputs = [("BEFORE", args.before_report_file), ("AFTER", args.after_report_file),
              ("BQSR", args.bqsr_recal_file)]
    inputs = [(tag, path) for tag, path in inputs if path]
    if not inputs:
        raise UserError("provide at least one of -before/-after/-bqsr")
    rows = []
    for tag, path in inputs:
        with open(path) as fh:
            tables = parse_report(fh.read())
        for name, _desc, columns, table_rows in tables:
            if name != "RecalTable1":
                continue
            cols = [c[0] for c in columns]
            for row in table_rows:
                d = dict(zip(cols, row))
                rows.append((tag, d.get("ReadGroup", ""), d.get("QualityScore", ""),
                             d.get("EventType", ""), d.get("EmpiricalQuality", ""),
                             d.get("Observations", ""), d.get("Errors", "")))
    with open(args.csv, "w") as fh:
        fh.write("Recalibration,ReadGroup,QualityScore,EventType,"
                 "EmpiricalQuality,Observations,Errors\n")
        for r in rows:
            fh.write(",".join(str(x) for x in r) + "\n")
    print(f"wrote {len(rows)} covariate rows to {args.csv}")
    return 0


@register_tool("CallableLoci")
def callable_loci(argv):
    """Classify every locus as CALLABLE / NO_COVERAGE / LOW_COVERAGE /
    POOR_MAPPING_QUALITY / EXCESSIVE_COVERAGE / REF_N and emit a BED of
    state runs plus a state-count summary
    (walkers/coverage/CallableLoci.java:315-345 state machine, exact
    defaults)."""
    p = argparse.ArgumentParser(description="CallableLoci")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-R", "--reference", required=True)
    p.add_argument("-O", "--output", required=True, help="BED of state runs")
    p.add_argument("--summary", required=True)
    p.add_argument("-L", "--intervals", action="append", default=None)
    p.add_argument("--max-low-mapq", type=int, default=1)
    p.add_argument("--min-mapping-quality", type=int, default=10)
    p.add_argument("--min-base-quality", type=int, default=20)
    p.add_argument("--min-depth", type=int, default=4)
    p.add_argument("--min-depth-for-low-mapq", type=int, default=10)
    p.add_argument("--max-fraction-of-low-mapq-reads", type=float, default=0.1)
    p.add_argument("--max-depth", type=int, default=-1)
    args = p.parse_args(argv)
    from ..engine import pileup as pileup_mod
    from ..io import fasta
    from ..io.cram import open_reads

    ref = fasta.FastaReference(args.reference)
    reads_src = open_reads(args.input, reference=ref)
    lengths = {s.name: s.length for s in reads_src.header.sequences}
    targets = (iv.parse_intervals_arg(args.intervals, lengths) if args.intervals
               else [iv.Interval(n, 0, l) for n, l in lengths.items()])

    STATES = ("REF_N", "CALLABLE", "NO_COVERAGE", "LOW_COVERAGE",
              "EXCESSIVE_COVERAGE", "POOR_MAPPING_QUALITY")
    totals = {s: 0 for s in STATES}
    with open(args.output, "w") as bed:
        for t in targets:
            span = t.end - t.start
            raw = np.zeros(span, np.int32)
            qc = np.zeros(span, np.int32)
            lowmq = np.zeros(span, np.int32)
            for r in reads_src.query(t.contig, t.start, t.end):
                if r.is_unmapped or r.is_duplicate or r.is_secondary:
                    continue
                pos, _base, qual, flags = pileup_mod.expand_read(r)
                sel = (pos >= t.start) & (pos < t.end)
                idx = (pos[sel] - t.start).astype(np.int64)
                np.add.at(raw, idx, 1)
                if r.mapq <= args.max_low_mapq:
                    np.add.at(lowmq, idx, 1)
                if r.mapq >= args.min_mapping_quality:
                    is_del = (flags[sel] & pileup_mod.F_DELETION) != 0
                    ok = (qual[sel] >= args.min_base_quality) | is_del
                    np.add.at(qc, idx[ok], 1)
            ref_bases = np.frombuffer(
                bytes(ref.fetch_bytes(t.contig, t.start, t.end)), np.uint8)
            is_n = (ref_bases == ord("N")) | (ref_bases == ord("n"))
            state = np.full(span, 1, np.int8)  # CALLABLE
            state[raw == 0] = 2
            poor = (raw >= args.min_depth_for_low_mapq) & (
                lowmq >= args.max_fraction_of_low_mapq_reads * raw) & (raw > 0)
            state[poor] = 5
            low = (~poor) & (raw > 0) & (qc < args.min_depth)
            state[low] = 3
            if args.max_depth > 0:
                exc = (~poor) & (~low) & (raw >= args.max_depth)
                state[exc] = 4
            state[is_n] = 0
            # run-length encode into BED rows
            changes = np.nonzero(np.diff(state))[0] + 1
            starts = np.concatenate([[0], changes])
            ends = np.concatenate([changes, [span]])
            for s0, e0 in zip(starts, ends):
                name = STATES[state[s0]]
                bed.write(f"{t.contig}\t{t.start + s0}\t{t.start + e0}\t{name}\n")
                totals[name] += int(e0 - s0)
    with open(args.summary, "w") as fh:
        fh.write(f"{'state':>21} nBases\n")
        for s in STATES:
            fh.write(f"{s:>21} {totals[s]}\n")
    print(f"CallableLoci: {totals}")
    return 0


@register_tool("LocalAssembler")
def local_assembler(argv):
    """Assemble the reads of a genomic region into contigs, written as FASTA
    and GFA-1 (tools/LocalAssembler.java: unitig assembly of a small region;
    here the read-threading de Bruijn assembler + SeqGraph simplification
    produce the contigs and the graph edges)."""
    p = argparse.ArgumentParser(description="LocalAssembler")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-R", "--reference", required=True)
    p.add_argument("-L", "--intervals", action="append", required=True)
    p.add_argument("--assembly-name", default="assembly")
    p.add_argument("--fasta-file", default=None)
    p.add_argument("--gfa-file", default=None)
    p.add_argument("--kmer-size", type=int, action="append", default=None)
    args = p.parse_args(argv)
    from ..assembly import assembler
    from ..io import fasta
    from ..io.cram import open_reads

    ref = fasta.FastaReference(args.reference)
    reads_src = open_reads(args.input, reference=ref)
    lengths = {s.name: s.length for s in reads_src.header.sequences}
    targets = iv.parse_intervals_arg(args.intervals, lengths)
    fasta_path = args.fasta_file or f"{args.assembly_name}.fa"
    gfa_path = args.gfa_file or f"{args.assembly_name}.gfa"
    contigs = []
    links = []
    for t in targets:
        region_reads = [r for r in reads_src.query(t.contig, t.start, t.end)
                        if not r.is_unmapped and not r.is_duplicate
                        and not r.is_secondary]
        ref_bases = ref.fetch(t.contig, t.start, t.end)
        kw = {}
        if args.kmer_size:
            kw["kmer_sizes"] = tuple(args.kmer_size)
        result = assembler.assemble(region_reads, ref_bases, t.start, **kw)
        for i, hap in enumerate(result.haplotypes):
            tag = "ref" if i == 0 else f"h{i}"
            contigs.append((f"{args.assembly_name}_{t.contig}_{t.start + 1}_{tag}",
                            bytes(hap.bases).decode()))
        # GFA links: successive contigs overlap through the reference span
        for i in range(1, len(result.haplotypes)):
            links.append((contigs[-len(result.haplotypes)][0],
                          contigs[-len(result.haplotypes) + i][0]))
    with open(fasta_path, "w") as fh:
        for name, seq in contigs:
            fh.write(f">{name}\n")
            for i in range(0, len(seq), 80):
                fh.write(seq[i : i + 80] + "\n")
    with open(gfa_path, "w") as fh:
        fh.write("H\tVN:Z:1.0\n")
        for name, seq in contigs:
            fh.write(f"S\t{name}\t{seq}\tLN:i:{len(seq)}\n")
        for a, b in links:
            fh.write(f"L\t{a}\t+\t{b}\t+\t0M\n")
    print(f"assembled {len(contigs)} contigs -> {fasta_path}, {gfa_path}")
    return 0


@register_tool("VCFComparator")
def vcf_comparator(argv):
    """Compare an actual VCF against an expected VCF record-by-record with
    configurable tolerances (walkers/variantutils/VCFComparator.java).
    Exit 0 when equivalent; UserError listing differences otherwise."""
    p = argparse.ArgumentParser(description="VCFComparator")
    p.add_argument("-V", "--variant", action="append", required=True,
                   help="two VCFs: actual then expected (or use twice)")
    p.add_argument("--ignore-quals", action="store_true")
    p.add_argument("--qual-change-allowed", type=float, default=0.001)
    p.add_argument("--dp-change-allowed", type=int, default=0)
    p.add_argument("--rank-sum-change-allowed", type=float, default=0.0)
    p.add_argument("--ignore-annotations", action="store_true")
    p.add_argument("--ignore-genotype-annotations", action="store_true")
    p.add_argument("--ignore-genotype-phasing", action="store_true")
    p.add_argument("--ignore-filters", action="store_true")
    p.add_argument("--ignore-attribute", action="append", default=[])
    p.add_argument("--positions-only", action="store_true")
    p.add_argument("--warn-on-errors", action="store_true")
    args = p.parse_args(argv)
    if len(args.variant) != 2:
        raise UserError("provide exactly two -V inputs: actual and expected")
    actual = {(v.contig, v.pos): v for v in vcfio.VcfReader(args.variant[0])}
    expected = {(v.contig, v.pos): v for v in vcfio.VcfReader(args.variant[1])}
    errors = []
    for key in sorted(set(actual) | set(expected)):
        a, e = actual.get(key), expected.get(key)
        loc = f"{key[0]}:{key[1] + 1}"
        if a is None:
            errors.append(f"{loc}: missing from actual")
            continue
        if e is None:
            errors.append(f"{loc}: unexpected record in actual")
            continue
        if args.positions_only:
            continue
        if a.ref != e.ref or tuple(a.alts) != tuple(e.alts):
            errors.append(f"{loc}: alleles {a.ref}>{a.alts} vs {e.ref}>{e.alts}")
            continue
        if not args.ignore_quals and a.qual is not None and e.qual is not None:
            if abs(a.qual - e.qual) > args.qual_change_allowed:
                errors.append(f"{loc}: QUAL {a.qual} vs {e.qual}")
        if not args.ignore_filters and tuple(a.filters) != tuple(e.filters):
            errors.append(f"{loc}: FILTER {a.filters} vs {e.filters}")
        if not args.ignore_annotations:
            keys = (set(a.info) | set(e.info)) - set(args.ignore_attribute)
            for k in sorted(keys):
                av, ev = a.info.get(k), e.info.get(k)
                if av == ev:
                    continue
                if k == "DP" and av is not None and ev is not None:
                    if abs(int(av) - int(ev)) <= args.dp_change_allowed:
                        continue
                if k.endswith("RankSum") and av is not None and ev is not None:
                    try:
                        if abs(float(av) - float(ev)) <= args.rank_sum_change_allowed:
                            continue
                    except ValueError:
                        pass
                errors.append(f"{loc}: INFO {k} {av} vs {ev}")
        for si, (sa, se) in enumerate(zip(a.samples, e.samples)):
            ga, ge = sa.get("GT", "."), se.get("GT", ".")
            if args.ignore_genotype_phasing:
                norm = lambda g: sorted(g.replace("|", "/").split("/"))  # noqa: E731
                same_gt = norm(ga) == norm(ge)
            else:
                same_gt = ga == ge
            if not same_gt:
                errors.append(f"{loc}: sample {si} GT {ga} vs {ge}")
            elif not args.ignore_genotype_annotations:
                for k in sorted((set(sa) | set(se)) - {"GT"}):
                    if sa.get(k) != se.get(k):
                        errors.append(f"{loc}: sample {si} {k} {sa.get(k)} vs {se.get(k)}")
    if errors:
        for e_ in errors[:50]:
            print(e_)
        if args.warn_on_errors:
            print(f"WARNING: {len(errors)} differences")
            return 0
        raise UserError(f"{len(errors)} differences between VCFs")
    print("VCFs are equivalent")
    return 0


@register_tool("CompareReferences")
def compare_references(argv):
    """Compare reference FASTAs: per-contig MD5/length table plus a summary of
    which references contain each sequence (tools/reference/
    CompareReferences.java; FIND_SNPS_ONLY base comparison supported)."""
    p = argparse.ArgumentParser(description="CompareReferences")
    p.add_argument("-R", "--reference", required=True)
    p.add_argument("-refcomp", "--references-to-compare", action="append",
                   required=True)
    p.add_argument("-O", "--output", default=None)
    p.add_argument("--display-only-differing-sequences", action="store_true")
    p.add_argument("--base-comparison", default="OFF",
                   choices=["OFF", "FIND_SNPS_ONLY"])
    args = p.parse_args(argv)
    import hashlib

    from ..io import fasta

    paths = [args.reference] + args.references_to_compare
    refs = [fasta.FastaReference(pth) for pth in paths]
    names = [pth.split("/")[-1] for pth in paths]
    # md5 per (ref, contig) of the uppercase sequence (the dictionary MD5)
    table = {}
    all_contigs = []
    for ri, ref in enumerate(refs):
        for contig in ref.index:
            if contig not in all_contigs:
                all_contigs.append(contig)
            seq = bytes(ref.fetch_bytes(contig)).upper()
            table[(ri, contig)] = (hashlib.md5(seq).hexdigest(), len(seq))
    lines = ["\t".join(["MD5", "Length"] + names)]
    n_diff = 0
    for contig in all_contigs:
        entries = [table.get((ri, contig)) for ri in range(len(refs))]
        md5s = {e[0] for e in entries if e}
        differing = len(md5s) > 1 or any(e is None for e in entries)
        if differing:
            n_diff += 1
        if args.display_only_differing_sequences and not differing:
            continue
        md5 = next(e[0] for e in entries if e)
        length = next(e[1] for e in entries if e)
        cols = [contig if e and e[0] == md5 else
                (f"{contig}*" if e else "---") for e in entries]
        lines.append("\t".join([md5, str(length)] + cols))
    out_text = "\n".join(lines) + "\n"
    if args.output:
        with open(args.output, "w") as fh:
            fh.write(out_text)
    else:
        print(out_text, end="")
    if args.base_comparison == "FIND_SNPS_ONLY":
        for contig in all_contigs:
            entries = [table.get((ri, contig)) for ri in range(len(refs))]
            if None in entries or len({e[0] for e in entries}) == 1:
                continue
            if len({e[1] for e in entries}) != 1:
                continue  # SNP scan needs equal lengths
            base0 = np.frombuffer(bytes(refs[0].fetch_bytes(contig)).upper(), np.uint8)
            for ri in range(1, len(refs)):
                basei = np.frombuffer(bytes(refs[ri].fetch_bytes(contig)).upper(), np.uint8)
                for pos in np.nonzero(base0 != basei)[0][:100]:
                    print(f"SNP {contig}:{pos + 1} {chr(base0[pos])}->{chr(basei[pos])}"
                          f" ({names[0]} vs {names[ri]})")
    print(f"{n_diff} differing sequences" if n_diff else "References match")
    return 0


@register_tool("FlowPairHMMAlignReadsToHaplotypes")
def flow_pairhmm_align_reads_to_haplotypes(argv):
    """Score every read against every haplotype with the flow-based PairHMM
    and write the likelihood matrix as TSV
    (FlowPairHMMAlignReadsToHaplotypes.java)."""
    p = argparse.ArgumentParser(description="FlowPairHMMAlignReadsToHaplotypes")
    p.add_argument("-I", "--input", required=True, help="reads BAM")
    p.add_argument("-H", "--haplotypes", required=True,
                   help="haplotypes FASTA (each contig is one haplotype)")
    p.add_argument("-O", "--output", required=True)
    p.add_argument("--flow-order", default="TGCA")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the PairHMM runs: the CUDA kernel, or its plain "
                        "PyTorch version on the host")
    args = p.parse_args(argv)
    devices.set_default_device(args.device)
    from ..io import fasta
    from ..io.cram import open_reads
    from ..ops import flow, flow_pairhmm

    hap_ref = fasta.FastaReference(args.haplotypes)
    hap_names = list(hap_ref.index)
    fhaps = [flow.FlowBasedHaplotype(
        np.frombuffer(bytes(hap_ref.fetch_bytes(n)), np.uint8), args.flow_order)
        for n in hap_names]
    reads = [r for r in open_reads(args.input) if len(r.bases)]
    freads = [flow.flow_read_from_sam(r, args.flow_order) for r in reads]
    mat = flow_pairhmm.compute_flow_likelihood_matrix(fhaps, freads)
    with open(args.output, "w") as fh:
        fh.write("read\t" + "\t".join(hap_names) + "\n")
        for ri, r in enumerate(reads):
            fh.write(r.name + "\t" + "\t".join(
                f"{mat[ri, hi]:.4f}" for hi in range(len(hap_names))) + "\n")
    print(f"scored {len(reads)} reads x {len(hap_names)} haplotypes")
    return 0


@register_tool("RevertBaseQualityScores")
def revert_base_quality_scores(argv):
    """Restore original base qualities from the OQ tag
    (RevertBaseQualityScores.java)."""
    p = argparse.ArgumentParser(description="RevertBaseQualityScores")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-O", "--output", required=True)
    args = p.parse_args(argv)
    from ..io.cram import open_reads

    src = open_reads(args.input)
    w = bamio.BamWriter(args.output, src.header)
    n = n_reverted = 0
    for r in src:
        oq = r.tags.get("OQ")
        if isinstance(oq, str):
            r.quals = (np.frombuffer(oq.encode(), np.uint8) - 33).astype(np.uint8)
            del r.tags["OQ"]
            n_reverted += 1
        w.write(r)
        n += 1
    w.close()
    print(f"reverted {n_reverted} of {n} reads")
    return 0


@register_tool("TransferReadTags")
def transfer_read_tags(argv):
    """Copy tags (e.g. RX/UMI) from an unmapped BAM onto the name-matched
    reads of an aligned BAM (TransferReadTags.java)."""
    p = argparse.ArgumentParser(description="TransferReadTags")
    p.add_argument("-I", "--input", required=True, help="aligned BAM")
    p.add_argument("--unmapped-sam", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("--read-tags", action="append", default=["RX"])
    args = p.parse_args(argv)
    from ..io.cram import open_reads

    tag_src: dict = {}
    for r in open_reads(args.unmapped_sam):
        tag_src[r.name] = {t: r.tags[t] for t in args.read_tags if t in r.tags}
    src = open_reads(args.input)
    w = bamio.BamWriter(args.output, src.header)
    n = 0
    for r in src:
        extra = tag_src.get(r.name)
        if extra:
            r.tags.update(extra)
        w.write(r)
        n += 1
    w.close()
    print(f"transferred tags onto {n} reads")
    return 0


@register_tool("ReadAnonymizer")
def read_anonymizer(argv):
    """Replace read bases with the reference bases they align to (and quals
    with a constant), de-identifying the sample (ReadAnonymizer.java)."""
    p = argparse.ArgumentParser(description="ReadAnonymizer")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-R", "--reference", required=True)
    p.add_argument("-O", "--output", required=True)
    args = p.parse_args(argv)
    from ..io import fasta, sam
    from ..io.cram import open_reads

    ref = fasta.FastaReference(args.reference)
    src = open_reads(args.input, reference=ref)
    names = [s.name for s in src.header.sequences]
    w = bamio.BamWriter(args.output, src.header)
    n = 0
    for r in src:
        if not r.is_unmapped and 0 <= r.ref_id < len(names):
            ref_seg = ref.fetch_bytes(names[r.ref_id], r.pos, r.end)
            new_bases = r.bases.copy()
            read_i = 0
            ref_i = 0
            for op, ln in zip(r.cigar_ops, r.cigar_lens):
                ln = int(ln)
                if op in (sam.OP_M, sam.OP_EQ, sam.OP_X):
                    new_bases[read_i : read_i + ln] = np.frombuffer(
                        bytes(ref_seg[ref_i : ref_i + ln]), np.uint8)
                    read_i += ln
                    ref_i += ln
                elif sam.CONSUMES_READ[op]:
                    read_i += ln
                elif sam.CONSUMES_REF[op]:
                    ref_i += ln
            r.bases = new_bases
            r.quals = np.full(len(new_bases), 60, np.uint8)
        w.write(r)
        n += 1
    w.close()
    print(f"anonymized {n} reads")
    return 0


@register_tool("PrintDistantMates")
def print_distant_mates(argv):
    """Emit reads whose mate maps to another contig or far away
    (PrintDistantMates.java)."""
    p = argparse.ArgumentParser(description="PrintDistantMates")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("--distance", type=int, default=2_000_000)
    args = p.parse_args(argv)
    from ..io.cram import open_reads

    src = open_reads(args.input)
    w = bamio.BamWriter(args.output, src.header)
    n = 0
    for r in src:
        if r.is_unmapped or not r.is_paired or r.mate_is_unmapped:
            continue
        if r.mate_ref_id != r.ref_id or abs(r.mate_pos - r.pos) >= args.distance:
            w.write(r)
            n += 1
    w.close()
    print(f"wrote {n} distant-mate reads")
    return 0


@register_tool("GenerateToolDocs")
def generate_tool_docs(argv):
    """Render per-tool help and an index into a docs directory — the Barclay
    gatkDoc equivalent over the argparse registry (Main.java doc-gen task;
    help text comes from each tool's parser like Barclay's @Argument docs)."""
    p = argparse.ArgumentParser(description="GenerateToolDocs")
    p.add_argument("-O", "--output-dir", required=True)
    args = p.parse_args(argv)
    import contextlib
    import io
    import os

    from ..cli import TOOL_REGISTRY

    os.makedirs(args.output_dir, exist_ok=True)
    index = ["# gatk_tpu tool documentation", ""]
    n = 0
    for name in sorted(TOOL_REGISTRY):
        if name == "GenerateToolDocs":
            continue
        fn = TOOL_REGISTRY[name]
        summary = (fn.__doc__ or "").strip().splitlines()
        summary = summary[0] if summary else ""
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                fn(["--help"])
        except SystemExit:
            pass
        except Exception:  # tools without argparse help
            pass
        help_text = buf.getvalue()
        with open(os.path.join(args.output_dir, f"{name}.md"), "w") as fh:
            fh.write(f"# {name}\n\n{summary}\n\n```\n{help_text}\n```\n")
        index.append(f"- [{name}]({name}.md) — {summary}")
        n += 1
    with open(os.path.join(args.output_dir, "index.md"), "w") as fh:
        fh.write("\n".join(index) + "\n")
    print(f"documented {n} tools in {args.output_dir}")
    return 0


@register_tool("SplitCRAM")
def split_cram(argv):
    """Split a CRAM (or BAM) into shards of at least --shard-records records
    (tools/SplitCRAM.java; output template must contain %d)."""
    p = argparse.ArgumentParser(description="SplitCRAM")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-O", "--output", required=True,
                   help="template containing %%d, e.g. shard_%%04d.cram")
    p.add_argument("--shard-records", type=int, default=10_000_000)
    p.add_argument("--shard-max-output-count", type=int, default=0)
    p.add_argument("-R", "--reference", default=None)
    args = p.parse_args(argv)
    if "%" not in args.output:
        raise UserError("output template must contain %d")
    from ..io.cram import open_reads
    from ..io.cram_writer import CramWriter

    ref = None
    if args.reference:
        from ..io import fasta

        ref = fasta.FastaReference(args.reference)
    src = open_reads(args.input, reference=ref)

    def make_writer(idx):
        path = args.output % idx
        if path.endswith(".cram"):
            return path, CramWriter(path, src.header)
        return path, bamio.BamWriter(path, src.header)

    shard = 0
    in_shard = 0
    total = 0
    path, w = make_writer(shard)
    paths = [path]
    for r in src:
        if in_shard >= args.shard_records:
            w.close()
            if args.shard_max_output_count and shard + 1 >= args.shard_max_output_count:
                break
            shard += 1
            in_shard = 0
            path, w = make_writer(shard)
            paths.append(path)
        w.write(r)
        in_shard += 1
        total += 1
    w.close()
    print(f"split {total} records into {len(paths)} shards")
    return 0


@register_tool("MethylationTypeCaller")
def methylation_type_caller(argv):
    """Call methylation-state coverage from a bisulfite BAM: at reference C
    sites, unconverted=C / converted=T on forward-strand reads (alt T); at
    reference G sites, unconverted=G / converted=A on reverse-strand reads
    (alt A); emits sites with any methylation coverage with
    UNCONVERTED_BASE_COV / CONVERTED_BASE_COV / REFERENCE_CONTEXT INFO
    (walkers/MethylationTypeCaller.java:92-150, exact keys)."""
    p = argparse.ArgumentParser(description="MethylationTypeCaller")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-R", "--reference", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("-L", "--intervals", action="append", default=None)
    args = p.parse_args(argv)
    from ..engine import pileup as pileup_mod
    from ..io import fasta
    from ..io.cram import open_reads

    ref = fasta.FastaReference(args.reference)
    src = open_reads(args.input, reference=ref)
    lengths = {s.name: s.length for s in src.header.sequences}
    targets = (iv.parse_intervals_arg(args.intervals, lengths) if args.intervals
               else [iv.Interval(n, l and 0, l) for n, l in lengths.items()])
    comp = {"A": "T", "C": "G", "G": "C", "T": "A", "N": "N"}
    w = vcfio.VcfWriter(args.output, [], extra_header_lines=[
        '##INFO=<ID=UNCONVERTED_BASE_COV,Number=1,Type=Integer,Description="Count of reads supporting methylation that are unconverted">',
        '##INFO=<ID=CONVERTED_BASE_COV,Number=1,Type=Integer,Description="Count of reads supporting methylation that are converted">',
        '##INFO=<ID=REFERENCE_CONTEXT,Number=1,Type=String,Description="Forward Strand Reference context">'])
    n = 0
    for t in targets:
        span = t.end - t.start
        fwd = {b: np.zeros(span, np.int32) for b in "ACGT"}
        rev = {b: np.zeros(span, np.int32) for b in "ACGT"}
        for r in src.query(t.contig, t.start, t.end):
            if r.is_unmapped or r.is_duplicate or r.is_secondary:
                continue
            pos, base, _q, flags = pileup_mod.expand_read(r)
            sel = (pos >= t.start) & (pos < t.end) & \
                  ((flags & pileup_mod.F_DELETION) == 0)
            tgt = rev if r.is_reverse else fwd
            idx = (pos[sel] - t.start).astype(np.int64)
            bs = base[sel]
            for b in "ACGT":
                np.add.at(tgt[b], idx[bs == ord(b)], 1)
        ref_seq = bytes(ref.fetch_bytes(t.contig, t.start,
                                        min(t.end + 2, ref.contig_length(t.contig))))
        for i in range(span):
            rb = chr(ref_seq[i]).upper()
            if rb == "C":
                unconv, conv = int(fwd["C"][i]), int(fwd["T"][i])
                alt = "T"
                context = ref_seq[i : i + 2].decode().upper()
            elif rb == "G":
                unconv, conv = int(rev["G"][i]), int(rev["A"][i])
                alt = "A"
                raw = ref_seq[max(0, i - 1) : i + 1].decode().upper()
                context = "".join(comp.get(c, "N") for c in raw[::-1])
            else:
                continue
            if unconv + conv == 0:
                continue
            w.write(vcfio.Variant(
                t.contig, t.start + i, rb, (alt,),
                info={"UNCONVERTED_BASE_COV": str(unconv),
                      "CONVERTED_BASE_COV": str(conv),
                      "REFERENCE_CONTEXT": context}))
            n += 1
    w.close()
    print(f"wrote {n} methylation records")
    return 0


@register_tool("EvaluateInfoFieldConcordance")
def evaluate_info_field_concordance(argv):
    """Compare a numeric INFO field between matched records of two VCFs:
    SNP/indel mean difference + std (walkers/vqsr/
    EvaluateInfoFieldConcordance.java)."""
    p = argparse.ArgumentParser(description="EvaluateInfoFieldConcordance")
    p.add_argument("--eval", required=True)
    p.add_argument("--truth", required=True)
    p.add_argument("--eval-info-key", required=True)
    p.add_argument("--truth-info-key", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("--epsilon", type=float, default=1e-7)
    args = p.parse_args(argv)
    truth = {(v.contig, v.pos, v.ref, tuple(v.alts)): v
             for v in vcfio.VcfReader(args.truth)}
    snp_d, indel_d = [], []
    for v in vcfio.VcfReader(args.eval):
        tv = truth.get((v.contig, v.pos, v.ref, tuple(v.alts)))
        if tv is None:
            continue
        a, b = v.info.get(args.eval_info_key), tv.info.get(args.truth_info_key)
        if a is None or b is None:
            continue
        try:
            d = abs(float(str(a).split(",")[0]) - float(str(b).split(",")[0]))
        except ValueError:
            continue
        is_snp = len(v.ref) == 1 and all(len(x) == 1 for x in v.alts)
        (snp_d if is_snp else indel_d).append(d)
    with open(args.output, "w") as fh:
        fh.write("type\tcount\tmean_abs_diff\tstd\n")
        for name, vals in (("SNP", snp_d), ("INDEL", indel_d)):
            if vals:
                fh.write(f"{name}\t{len(vals)}\t{np.mean(vals):.6f}\t{np.std(vals):.6f}\n")
            else:
                fh.write(f"{name}\t0\tNA\tNA\n")
    bad = [d for d in snp_d + indel_d if d > args.epsilon]
    print(f"{len(snp_d)} SNPs, {len(indel_d)} indels compared; "
          f"{len(bad)} above epsilon")
    return 0


@register_tool("CountFalsePositives")
def count_false_positives(argv):
    """Count PASS variants outside truth intervals, per type, normalized by
    callable territory (walkers/validation/CountFalsePositives.java)."""
    p = argparse.ArgumentParser(description="CountFalsePositives")
    p.add_argument("-V", "--variant", required=True)
    p.add_argument("-L", "--intervals", required=True,
                   help="callable intervals file")
    p.add_argument("--truth", default=None, help="truth VCF; sites in it are TP")
    p.add_argument("-O", "--output", required=True)
    args = p.parse_args(argv)
    targets = iv.load_interval_file(args.intervals)
    territory = sum(t.end - t.start for t in targets)
    truth_keys = set()
    if args.truth:
        truth_keys = {(v.contig, v.pos, v.ref, tuple(v.alts))
                      for v in vcfio.VcfReader(args.truth)}
    snp_fp = indel_fp = 0
    for v in vcfio.VcfReader(args.variant):
        if v.filters and v.filters != ("PASS",):
            continue
        if (v.contig, v.pos, v.ref, tuple(v.alts)) in truth_keys:
            continue
        if not any(v.contig == t.contig and t.start <= v.pos < t.end
                   for t in targets):
            continue
        if len(v.ref) == 1 and all(len(a) == 1 for a in v.alts):
            snp_fp += 1
        else:
            indel_fp += 1
    with open(args.output, "w") as fh:
        fh.write("type\tfalse_positives\tterritory_bp\tfp_per_mb\n")
        for name, c in (("SNP", snp_fp), ("INDEL", indel_fp)):
            rate = c / (territory / 1e6) if territory else 0.0
            fh.write(f"{name}\t{c}\t{territory}\t{rate:.3f}\n")
    print(f"SNP FP {snp_fp}, INDEL FP {indel_fp} over {territory} bp")
    return 0


@register_tool("CheckReferenceCompatibility")
def check_reference_compatibility(argv):
    """Check a BAM/VCF sequence dictionary against a reference: name/length
    (and MD5 where present) per contig
    (tools/reference/CheckReferenceCompatibility.java)."""
    p = argparse.ArgumentParser(description="CheckReferenceCompatibility")
    p.add_argument("-refcomp", "--references-to-compare", required=True)
    p.add_argument("-I", "--input", default=None, help="BAM with @SQ dictionary")
    p.add_argument("-V", "--variant", default=None, help="VCF with ##contig lines")
    p.add_argument("-O", "--output", default=None)
    args = p.parse_args(argv)
    from ..io import fasta

    ref = fasta.FastaReference(args.references_to_compare)
    dict_entries = []
    if args.input:
        from ..io.cram import open_reads

        for s in open_reads(args.input).header.sequences:
            dict_entries.append((s.name, s.length))
    elif args.variant:
        for line in vcfio.VcfReader(args.variant).header_lines:
            if line.startswith("##contig="):
                body = line[len("##contig=<"):].rstrip(">")
                kv = dict(x.split("=", 1) for x in body.split(",") if "=" in x)
                if "ID" in kv:
                    dict_entries.append((kv["ID"], int(kv.get("length", -1))))
    else:
        raise UserError("provide -I or -V")
    lines = ["contig\tstatus"]
    compatible = True
    for name, length in dict_entries:
        if name not in ref.index:
            lines.append(f"{name}\tMISSING_FROM_REFERENCE")
            compatible = False
        elif length >= 0 and ref.contig_length(name) != length:
            lines.append(f"{name}\tLENGTH_MISMATCH "
                         f"({length} vs {ref.contig_length(name)})")
            compatible = False
        else:
            lines.append(f"{name}\tCOMPATIBLE")
    text = "\n".join(lines) + ("\nCOMPATIBLE\n" if compatible else "\nINCOMPATIBLE\n")
    if args.output:
        with open(args.output, "w") as fh:
            fh.write(text)
    print(text, end="")
    return 0 if compatible else 1


@register_tool("PrintReadCounts")
def print_read_counts(argv):
    """Split a multi-sample DepthEvidence rd.txt (or pass through a counts
    tsv) into per-sample counts files named {prefix}{sample}.counts.tsv
    (sv/PrintReadCounts.java)."""
    import gzip as _gz

    p = argparse.ArgumentParser(description="PrintReadCounts")
    p.add_argument("--input-counts", "-F", required=True)
    p.add_argument("--output-prefix", required=True)
    args = p.parse_args(argv)
    path = args.input_counts
    op = _gz.open if path.endswith(".gz") else open
    with op(path, "rt") as fh:
        lines = fh.read().splitlines()
    if ".counts.tsv" in path:
        out = f"{args.output_prefix}SAMPLE.counts.tsv"
        with open(out, "w") as fh:
            fh.write("\n".join(lines) + "\n")
        print(f"wrote {out}")
        return 0
    samples = None
    rows = []
    for line in lines:
        if line.startswith("#"):
            f = line.lstrip("#").split("\t")
            if len(f) > 3:
                samples = f[3:]
            continue
        rows.append(line.split("\t"))
    if samples is None:
        samples = [f"S{i}" for i in range(len(rows[0]) - 3)] if rows else []
    outs = []
    for si, sample in enumerate(samples):
        out = f"{args.output_prefix}{sample}.counts.tsv"
        with open(out, "w") as fh:
            fh.write("CONTIG\tSTART\tEND\tCOUNT\n")
            for f in rows:
                fh.write(f"{f[0]}\t{int(f[1]) + 1}\t{f[2]}\t{f[3 + si]}\n")
        outs.append(out)
    print(f"wrote {len(outs)} counts files")
    return 0


@register_tool("DownsampleByDuplicateSet")
def downsample_by_duplicate_set(argv):
    """Drop a fraction of UMI duplicate sets (molecules) from a
    UMI-grouped BAM, keeping whole molecules
    (walkers/consensus/DownsampleByDuplicateSet.java). Molecules are keyed by
    the MI tag when present, else (start, UMI from RX)."""
    p = argparse.ArgumentParser(description="DownsampleByDuplicateSet")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("--fraction-to-keep", type=float, required=True)
    p.add_argument("--seed", type=int, default=42)
    args = p.parse_args(argv)
    if not 0.0 <= args.fraction_to_keep <= 1.0:
        raise UserError("fraction-to-keep must be in [0, 1]")
    import hashlib

    from ..io.cram import open_reads

    src = open_reads(args.input)
    w = bamio.BamWriter(args.output, src.header)
    kept_sets = set()
    dropped_sets = set()
    n_reads = 0
    for r in src:
        key = r.tags.get("MI") or f"{min(r.pos, r.mate_pos)}:{r.tags.get('RX', '')}"
        if key in dropped_sets:
            continue
        if key not in kept_sets:
            h = hashlib.sha1(f"{args.seed}:{key}".encode()).digest()
            if int.from_bytes(h[:8], "big") / 2**64 < args.fraction_to_keep:
                kept_sets.add(key)
            else:
                dropped_sets.add(key)
                continue
        w.write(r)
        n_reads += 1
    w.close()
    print(f"kept {len(kept_sets)} of {len(kept_sets) + len(dropped_sets)} "
          f"duplicate sets ({n_reads} reads)")
    return 0


@register_tool("TagGermlineEvents")
def tag_germline_events(argv):
    """Tag tumor segments that match a normal's segments as
    POSSIBLE_GERMLINE (copynumber/utils/TagGermlineEvents.java: reciprocal
    match within --padding bp of both endpoints and same CALL)."""
    p = argparse.ArgumentParser(description="TagGermlineEvents")
    p.add_argument("--segments", "-S", required=True, help="tumor called .seg")
    p.add_argument("--called-matched-normal-seg-file", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("--germline-tag-padding", type=int, default=1000)
    args = p.parse_args(argv)

    def read_seg(path):
        header = []
        cols = None
        rows = []
        with open(path) as fh:
            for line in fh:
                line = line.rstrip("\n")
                if line.startswith("@"):
                    header.append(line)
                elif cols is None:
                    cols = line.split("\t")
                else:
                    rows.append(line.split("\t"))
        return header, cols, rows

    header, cols, rows = read_seg(args.segments)
    _h2, cols_n, rows_n = read_seg(args.called_matched_normal_seg_file)

    def col(cs, *names):
        for n in names:
            if n in cs:
                return cs.index(n)
        return None

    ci, si, ei = (col(cols, "CONTIG", "Chromosome"), col(cols, "START", "Start"),
                  col(cols, "END", "End"))
    calli = col(cols, "CALL", "Call")
    ci_n, si_n, ei_n = (col(cols_n, "CONTIG", "Chromosome"),
                        col(cols_n, "START", "Start"), col(cols_n, "END", "End"))
    calli_n = col(cols_n, "CALL", "Call")
    pad = args.germline_tag_padding
    with open(args.output, "w") as fh:
        for h in header:
            fh.write(h + "\n")
        fh.write("\t".join(cols + ["POSSIBLE_GERMLINE"]) + "\n")
        n_tagged = 0
        for row in rows:
            tag = "0"
            call = row[calli] if calli is not None else "0"
            if call not in ("0", "", "."):
                for rn in rows_n:
                    if rn[ci_n] != row[ci]:
                        continue
                    call_n = rn[calli_n] if calli_n is not None else "0"
                    if call_n != call:
                        continue
                    if abs(int(rn[si_n]) - int(row[si])) <= pad and \
                            abs(int(rn[ei_n]) - int(row[ei])) <= pad:
                        tag = "1"
                        n_tagged += 1
                        break
            fh.write("\t".join(row + [tag]) + "\n")
    print(f"tagged {n_tagged} segments as POSSIBLE_GERMLINE")
    return 0


@register_tool("AnnotateVcfWithExpectedAlleleFraction")
def annotate_vcf_with_expected_allele_fraction(argv):
    """Annotate a multi-sample VCF with the expected pooled allele fraction:
    sum over samples of mixing_fraction * {0 hom-ref, 0.5 het, 1.0 hom-var}
    (walkers/validation/AnnotateVcfWithExpectedAlleleFraction.java:38)."""
    p = argparse.ArgumentParser(description="AnnotateVcfWithExpectedAlleleFraction")
    p.add_argument("-V", "--variant", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("--mixing-fractions", required=True,
                   help="CalculateMixingFractions output table")
    args = p.parse_args(argv)
    fractions = {}
    with open(args.mixing_fractions) as fh:
        for i, line in enumerate(fh):
            f = line.strip().split("\t")
            if i == 0 or len(f) < 2:
                continue
            fractions[f[0]] = float(f[1])
    reader = vcfio.VcfReader(args.variant)
    headers = list(reader.header_lines) + [
        '##INFO=<ID=AF_EXP,Number=1,Type=Float,Description="expected allele fraction in pooled bam">']
    w = vcfio.VcfWriter(args.output, reader.samples, extra_header_lines=headers)
    n = 0
    for v in reader:
        af = 0.0
        for name, s in zip(reader.samples, v.samples):
            gt = s.get("GT", "./.").replace("|", "/").split("/")
            alts = sum(1 for t in gt if t not in ("0", ".", ""))
            called = sum(1 for t in gt if t not in (".", ""))
            if called:
                af += fractions.get(name, 0.0) * (alts / called)
        info = dict(v.info)
        info["AF_EXP"] = f"{af:.6g}"
        v.info = info
        w.write(v)
        n += 1
    w.close()
    print(f"annotated {n} variants with AF_EXP")
    return 0


@register_tool("MergeAnnotatedRegions")
def merge_annotated_regions(argv):
    """Merge touching/overlapping segments with identical annotation values
    (copynumber/utils/MergeAnnotatedRegions.java)."""
    p = argparse.ArgumentParser(description="MergeAnnotatedRegions")
    p.add_argument("--segments", "-S", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("--max-merge-distance", type=int, default=0)
    args = p.parse_args(argv)
    header = []
    cols = None
    rows = []
    with open(args.segments) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if line.startswith("@"):
                header.append(line)
            elif cols is None:
                cols = line.split("\t")
            else:
                rows.append(line.split("\t"))
    ci, si, ei = cols.index("CONTIG"), cols.index("START"), cols.index("END")
    ann_idx = [i for i in range(len(cols)) if i not in (ci, si, ei)]
    rows.sort(key=lambda r: (r[ci], int(r[si])))
    merged = []
    for r in rows:
        if merged:
            m = merged[-1]
            touching = (m[ci] == r[ci]
                        and int(r[si]) <= int(m[ei]) + 1 + args.max_merge_distance)
            same_ann = all(m[i] == r[i] for i in ann_idx)
            if touching and same_ann:
                m[ei] = str(max(int(m[ei]), int(r[ei])))
                continue
        merged.append(list(r))
    with open(args.output, "w") as fh:
        for h in header:
            fh.write(h + "\n")
        fh.write("\t".join(cols) + "\n")
        for m in merged:
            fh.write("\t".join(m) + "\n")
    print(f"merged {len(rows)} segments into {len(merged)}")
    return 0


@register_tool("CombineSegmentBreakpoints")
def combine_segment_breakpoints(argv):
    """Union the breakpoints of two segment files into non-overlapping
    intervals carrying the selected annotation columns from each input
    (suffixes applied on collision)
    (copynumber/utils/CombineSegmentBreakpoints.java)."""
    p = argparse.ArgumentParser(description="CombineSegmentBreakpoints")
    p.add_argument("--segments", "-S", action="append", required=True)
    p.add_argument("--labels", action="append", default=None)
    p.add_argument("--columns-of-interest", action="append", required=True)
    p.add_argument("-O", "--output", required=True)
    args = p.parse_args(argv)
    if len(args.segments) != 2:
        raise UserError("exactly two --segments inputs required")
    labels = args.labels or ["1", "2"]

    def read_seg(path):
        cols = None
        rows = []
        with open(path) as fh:
            for line in fh:
                line = line.rstrip("\n")
                if line.startswith("@") or not line.strip():
                    continue
                if cols is None:
                    cols = line.split("\t")
                else:
                    rows.append(dict(zip(cols, line.split("\t"))))
        return cols, rows

    cols_a, segs_a = read_seg(args.segments[0])
    cols_b, segs_b = read_seg(args.segments[1])
    interest = args.columns_of_interest
    # output column names, suffixing collisions
    out_cols = []
    col_map = []  # (source_index, source_col, out_name)
    for src_i, cols in ((0, cols_a), (1, cols_b)):
        for c in interest:
            if c not in cols:
                continue
            other = cols_b if src_i == 0 else cols_a
            name = f"{c}_{labels[src_i]}" if c in other else c
            out_cols.append(name)
            col_map.append((src_i, c, name))
    # breakpoint union per contig
    contigs = sorted({s["CONTIG"] for s in segs_a + segs_b})
    out_rows = []
    for contig in contigs:
        bps = set()
        for s in segs_a + segs_b:
            if s["CONTIG"] == contig:
                bps.add(int(s["START"]))
                bps.add(int(s["END"]) + 1)
        bps = sorted(bps)
        for lo, hi in zip(bps, bps[1:]):
            start, end = lo, hi - 1
            if end < start:
                continue
            row = {"CONTIG": contig, "START": str(start), "END": str(end)}
            keep = False
            for src_i, c, name in col_map:
                segs = segs_a if src_i == 0 else segs_b
                val = ""
                for s in segs:
                    if s["CONTIG"] == contig and int(s["START"]) <= start \
                            and end <= int(s["END"]):
                        val = s.get(c, "")
                        keep = keep or bool(val)
                        break
                row[name] = val
            if keep:
                out_rows.append(row)
    with open(args.output, "w") as fh:
        hdr = ["CONTIG", "START", "END"] + out_cols
        fh.write("\t".join(hdr) + "\n")
        for row in out_rows:
            fh.write("\t".join(row.get(c, "") for c in hdr) + "\n")
    print(f"wrote {len(out_rows)} combined segments")
    return 0


@register_tool("FuncotateSegments")
def funcotate_segments(argv):
    """Annotate copy-number segments with the genes they overlap using the
    GENCODE data source (funcotator/FuncotateSegments.java: genes column =
    comma-separated gene list, gene_start/gene_end columns)."""
    p = argparse.ArgumentParser(description="FuncotateSegments")
    p.add_argument("--segments", "-S", required=True)
    p.add_argument("--gtf", required=True, help="GENCODE GTF")
    p.add_argument("-O", "--output", required=True)
    args = p.parse_args(argv)
    from ..funcotator.gencode import load_gtf

    transcripts = load_gtf(args.gtf)
    genes = {}
    for t in transcripts.values():
        key = (t.contig, t.gene_name)
        if key in genes:
            s, e = genes[key]
            genes[key] = (min(s, t.start), max(e, t.end))
        else:
            genes[key] = (t.start, t.end)
    header = []
    cols = None
    out = []
    with open(args.segments) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if line.startswith("@"):
                header.append(line)
            elif cols is None:
                cols = line.split("\t")
            else:
                f = dict(zip(cols, line.split("\t")))
                contig, start, end = f["CONTIG"], int(f["START"]), int(f["END"])
                hit = sorted(
                    (gs, ge, name) for (c, name), (gs, ge) in genes.items()
                    if c == contig and gs <= end and ge >= start)
                f["genes"] = ",".join(n for _s, _e, n in hit)
                f["gene_start"] = str(hit[0][0]) if hit else ""
                f["gene_end"] = str(hit[-1][1]) if hit else ""
                out.append(f)
    with open(args.output, "w") as fh:
        for h in header:
            fh.write(h + "\n")
        hdr = cols + ["genes", "gene_start", "gene_end"]
        fh.write("\t".join(hdr) + "\n")
        for f in out:
            fh.write("\t".join(f.get(c, "") for c in hdr) + "\n")
    print(f"funcotated {len(out)} segments")
    return 0


@register_tool("CheckPileup")
def check_pileup(argv):
    """Compare the internal pileup against a samtools mpileup file: depth and
    base string per covered locus (walkers/qc/CheckPileup.java). Reports
    mismatches; exits nonzero unless --continue-after-error."""
    p = argparse.ArgumentParser(description="CheckPileup")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-R", "--reference", required=True)
    p.add_argument("--pileup", required=True, help="samtools mpileup output")
    p.add_argument("-L", "--intervals", action="append", default=None)
    p.add_argument("--continue-after-error", action="store_true")
    args = p.parse_args(argv)
    from ..engine import pileup as pileup_mod
    from ..io import fasta
    from ..io.cram import open_reads

    ref = fasta.FastaReference(args.reference)
    src = open_reads(args.input, reference=ref)
    expected = {}
    with open(args.pileup) as fh:
        for line in fh:
            f = line.rstrip("\n").split("\t")
            if len(f) < 4:
                continue
            expected[(f[0], int(f[1]) - 1)] = int(f[3])
    n_ok = 0
    mismatches = []
    by_contig: dict = {}
    for (contig, pos), depth in expected.items():
        by_contig.setdefault(contig, []).append((pos, depth))
    for contig, sites in by_contig.items():
        sites.sort()
        lo, hi = sites[0][0], sites[-1][0] + 1
        depth_arr = {}
        for r in src.query(contig, lo, hi):
            if r.is_unmapped or r.is_duplicate or r.is_secondary:
                continue
            pos, _b, _q, flags = pileup_mod.expand_read(r)
            sel = (flags & pileup_mod.F_DELETION) == 0
            for pp in pos[sel]:
                depth_arr[int(pp)] = depth_arr.get(int(pp), 0) + 1
        for pos, depth in sites:
            got = depth_arr.get(pos, 0)
            if got == depth:
                n_ok += 1
            else:
                mismatches.append((contig, pos + 1, depth, got))
    for contig, pos1, want, got in mismatches[:25]:
        print(f"MISMATCH {contig}:{pos1} expected depth {want}, got {got}")
    print(f"{n_ok} loci match, {len(mismatches)} mismatch")
    if mismatches and not args.continue_after_error:
        raise UserError(f"{len(mismatches)} pileup mismatches")
    return 0


@register_tool("PostProcessReadsForRSEM")
def post_process_reads_for_rsem(argv):
    """Prepare a transcriptome-aligned BAM for RSEM: keep only properly
    paired reads and write mates adjacently in queryname groups
    (tools/PostProcessReadsForRSEM.java)."""
    p = argparse.ArgumentParser(description="PostProcessReadsForRSEM")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-O", "--output", required=True)
    args = p.parse_args(argv)
    from ..io.cram import open_reads

    src = open_reads(args.input)
    groups: dict = {}
    order = []
    for r in src:
        if not r.is_paired or r.is_unmapped or r.mate_is_unmapped:
            continue
        if not (r.flag & 0x2):  # properly paired only
            continue
        if r.name not in groups:
            order.append(r.name)
        groups.setdefault(r.name, []).append(r)
    w = bamio.BamWriter(args.output, src.header)
    n = 0
    for name in order:
        pair = groups[name]
        if len(pair) < 2:
            continue
        pair.sort(key=lambda r: 0 if r.is_first_of_pair else 1)
        for r in pair:
            w.write(r)
            n += 1
    w.close()
    print(f"wrote {n} reads in {sum(1 for nm in order if len(groups[nm]) >= 2)} pairs")
    return 0


@register_tool("CalculateAverageCombinedAnnotations")
def calculate_average_combined_annotations(argv):
    """Divide GenomicsDB-summed INFO annotations by the number of called
    non-ref samples to approximate their average
    (tools/CalculateAverageCombinedAnnotations.java). The divided value is
    written as <KEY>_AVERAGE alongside the original."""
    p = argparse.ArgumentParser(description="CalculateAverageCombinedAnnotations")
    p.add_argument("-V", "--variant", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("--summed-annotation-to-divide", "-A", action="append",
                   required=True)
    args = p.parse_args(argv)
    reader = vcfio.VcfReader(args.variant)
    headers = list(reader.header_lines) + [
        f'##INFO=<ID={k}_AVERAGE,Number=1,Type=Float,Description="average of {k}">'
        for k in args.summed_annotation_to_divide]
    w = vcfio.VcfWriter(args.output, reader.samples, extra_header_lines=headers)
    n = 0
    for v in reader:
        n_nonref = 0
        for s in v.samples:
            gt = s.get("GT", "./.").replace("|", "/").split("/")
            if any(t not in ("0", ".", "") for t in gt):
                n_nonref += 1
        if n_nonref:
            info = dict(v.info)
            for k in args.summed_annotation_to_divide:
                raw = info.get(k)
                if raw is None:
                    continue
                try:
                    info[f"{k}_AVERAGE"] = f"{float(str(raw).split(',')[0]) / n_nonref:.5g}"
                except ValueError:
                    pass
            v.info = info
        w.write(v)
        n += 1
    w.close()
    print(f"processed {n} variants")
    return 0


@register_tool("ReferenceBlockConcordance")
def reference_block_concordance(argv):
    """GVCF reference-block concordance histograms: per-GVCF
    (confidence, length) block histograms plus a per-base
    truth-vs-eval confidence concordance histogram
    (walkers/validation/ReferenceBlockConcordance.java)."""
    p = argparse.ArgumentParser(description="ReferenceBlockConcordance")
    p.add_argument("--eval", required=True)
    p.add_argument("--truth", required=True)
    p.add_argument("--truth-block-histogram", required=True)
    p.add_argument("--eval-block-histogram", required=True)
    p.add_argument("--confidence-concordance-histogram", required=True)
    args = p.parse_args(argv)

    def ref_blocks(path):
        """[(contig, start, end1_incl, gq)] for <NON_REF>-only records."""
        out = []
        for v in vcfio.VcfReader(path):
            if tuple(v.alts) not in (("<NON_REF>",), ()):
                continue
            end = int(v.info.get("END", v.pos + len(v.ref)))
            gq = v.samples[0].get("GQ", "0") if v.samples else "0"
            out.append((v.contig, v.pos, end, int(gq)))
        return out

    truth_blocks = ref_blocks(args.truth)
    eval_blocks = ref_blocks(args.eval)

    def write_block_hist(path, blocks):
        hist: dict = {}
        for _c, start, end, gq in blocks:
            key = (gq, end - start)
            hist[key] = hist.get(key, 0) + 1
        with open(path, "w") as fh:
            fh.write("confidence,length\tcount\n")
            for (gq, ln), c in sorted(hist.items()):
                fh.write(f"{gq},{ln}\t{c}\n")

    write_block_hist(args.truth_block_histogram, truth_blocks)
    write_block_hist(args.eval_block_histogram, eval_blocks)
    # per-base joint confidence histogram
    joint: dict = {}
    by_contig: dict = {}
    for c, s, e, gq in eval_blocks:
        by_contig.setdefault(c, []).append((s, e, gq))
    for c, ts, te, tgq in truth_blocks:
        for es, ee, egq in by_contig.get(c, ()):
            ov = min(te, ee) - max(ts, es)
            if ov > 0:
                key = (tgq, egq)
                joint[key] = joint.get(key, 0) + ov
    with open(args.confidence_concordance_histogram, "w") as fh:
        fh.write("truth_confidence,eval_confidence\tcount\n")
        for (tgq, egq), c in sorted(joint.items()):
            fh.write(f"{tgq},{egq}\t{c}\n")
    print(f"truth blocks {len(truth_blocks)}, eval blocks {len(eval_blocks)}")
    return 0


@register_tool("ConvertCountsToDepthFile")
def convert_counts_to_depth_file(argv):
    """Convert a counts.tsv (CollectReadCounts) into a single-sample
    DepthEvidence rd.txt file (sv/ConvertCountsToDepthFile.java)."""
    import gzip as _gz

    p = argparse.ArgumentParser(description="ConvertCountsToDepthFile")
    p.add_argument("-F", "--counts-file", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("--sample-name", default="SAMPLE")
    args = p.parse_args(argv)
    rows = []
    op = _gz.open if args.counts_file.endswith(".gz") else open
    with op(args.counts_file, "rt") as fh:
        for line in fh:
            if line.startswith(("@", "#", "CONTIG")):
                continue
            f = line.split()
            if len(f) >= 4:
                rows.append((f[0], int(f[1]) - 1, int(f[2]), f[3]))
    opw = _gz.open if args.output.endswith(".gz") else open
    with opw(args.output, "wt") as fh:
        fh.write(f"#Chr\tStart\tEnd\t{args.sample_name}\n")
        for contig, start, end, count in rows:
            fh.write(f"{contig}\t{start}\t{end}\t{count}\n")
    print(f"wrote {len(rows)} depth records")
    return 0


@register_tool("MergeAnnotatedRegionsByAnnotation")
def merge_annotated_regions_by_annotation(argv):
    """Merge neighboring segments whose given annotation values match exactly
    (copynumber/utils/MergeAnnotatedRegionsByAnnotation.java): same contig,
    within --max-merge-distance, all --annotations-to-match equal; other
    columns keep conflicting values joined with '__'."""
    p = argparse.ArgumentParser(description="MergeAnnotatedRegionsByAnnotation")
    p.add_argument("--segments", required=True)
    p.add_argument("--annotations-to-match", action="append", required=True)
    p.add_argument("--max-merge-distance", type=int, default=1_000_000)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("--output-contig-column", default="CONTIG")
    p.add_argument("--output-start-column", default="START")
    p.add_argument("--output-end-column", default="END")
    args = p.parse_args(argv)

    header_meta = []
    rows = []
    cols = None
    for line in open(args.segments):
        if line.startswith("@") or line.startswith("#"):
            header_meta.append(line.rstrip("\n"))
            continue
        f = line.rstrip("\n").split("\t")
        if cols is None:
            cols = f
            continue
        rows.append(dict(zip(cols, f)))
    ccol = "CONTIG" if "CONTIG" in (cols or []) else (cols or ["CONTIG"])[0]
    scol = "START" if "START" in (cols or []) else None
    ecol = "END" if "END" in (cols or []) else None
    if not rows or scol is None or ecol is None:
        raise UserError("segment file must have CONTIG/START/END columns")
    merged = []
    for row in rows:
        if merged:
            prev = merged[-1]
            same = (prev[ccol] == row[ccol]
                    and int(row[scol]) - int(prev[ecol]) <= args.max_merge_distance
                    and all(prev.get(a) == row.get(a)
                            for a in args.annotations_to_match))
            if same:
                prev[ecol] = row[ecol]
                for c in cols:
                    if c in (ccol, scol, ecol) or c in args.annotations_to_match:
                        continue
                    if prev.get(c) != row.get(c):
                        parts = prev.get(c, "").split("__")
                        if row.get(c, "") not in parts:
                            prev[c] = prev.get(c, "") + "__" + row.get(c, "")
                continue
        merged.append(dict(row))
    out_cols = [args.output_contig_column, args.output_start_column,
                args.output_end_column] + [c for c in cols
                                           if c not in (ccol, scol, ecol)]
    with open(args.output, "w") as fh:
        for m in header_meta:
            fh.write(m + "\n")
        fh.write("\t".join(out_cols) + "\n")
        for row in merged:
            vals = [row[ccol], row[scol], row[ecol]] + [
                row.get(c, "") for c in cols if c not in (ccol, scol, ecol)]
            fh.write("\t".join(vals) + "\n")
    print(f"merged {len(rows)} -> {len(merged)} segments")
    return 0


@register_tool("CRAMIssue8768Detector")
def cram_issue_8768_detector(argv):
    """Detect base corruption from GATK issue 8768 in a CRAM
    (tools/CRAMIssue8768Detector.java): per container, compare read bases to
    the reference; containers whose mismatch rate exceeds the threshold are
    flagged as likely corrupt."""
    p = argparse.ArgumentParser(description="CRAMIssue8768Detector")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("-R", "--reference", required=True)
    p.add_argument("--output-tsv", default=None)
    p.add_argument("--mismatch-rate-threshold", type=float, default=0.05)
    args = p.parse_args(argv)

    from ..io import fasta as fasta_mod, sam as sam_mod
    from ..io.cram import open_reads

    ref = fasta_mod.FastaReference(args.reference)
    rd = open_reads(args.input, reference=ref)
    ref_cache = {}
    window = 10000
    stats = {}  # (contig, window_index) -> [mismatches, bases]
    for r in rd:
        if r.is_unmapped or r.ref_id < 0:
            continue
        contig = rd.header.sequences[r.ref_id].name
        if contig not in ref_cache:
            ref_cache[contig] = ref.fetch(contig, 0, ref.contig_length(contig))
        rb = ref_cache[contig]
        rp, ro = int(r.pos), 0
        mism = total = 0
        for op, ln in zip(r.cigar_ops, r.cigar_lens):
            op, ln = int(op), int(ln)
            if op in (sam_mod.OP_M, sam_mod.OP_EQ, sam_mod.OP_X):
                seg_r = np.asarray(rb[rp : rp + ln], np.uint8)
                seg_q = np.asarray(r.bases[ro : ro + len(seg_r)], np.uint8)
                # case-insensitive base compare (ASCII | 0x20 folds case)
                mism += int(np.count_nonzero(
                    (seg_r | 0x20) != (seg_q | 0x20)))
                total += len(seg_r)
                rp += ln
                ro += ln
            elif op == sam_mod.OP_I or op == sam_mod.OP_S:
                ro += ln
            elif op in (sam_mod.OP_D, sam_mod.OP_N):
                rp += ln
        key = (contig, int(r.pos) // window)
        s = stats.setdefault(key, [0, 0])
        s[0] += mism
        s[1] += total
    bad = []
    lines = [f"CRAM 8768 corruption analysis: {args.input}"]
    for key in sorted(stats):
        m, t = stats[key]
        rate = m / t if t else 0.0
        if rate > args.mismatch_rate_threshold:
            bad.append((key, rate))
            lines.append(f"  SUSPECT window {key[0]}:{key[1] * window + 1}-"
                         f"{(key[1] + 1) * window}: mismatch rate {rate:.4f}")
    verdict = ("CORRUPT: high-mismatch windows detected" if bad
               else "OK: no evidence of issue 8768 corruption")
    lines.append(verdict)
    with open(args.output, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    if args.output_tsv:
        with open(args.output_tsv, "w") as fh:
            fh.write("CONTIG\tWINDOW_START\tMISMATCHES\tBASES\tRATE\n")
            for (contig, wi), s in sorted(stats.items()):
                rate = s[0] / s[1] if s[1] else 0.0
                fh.write(f"{contig}\t{wi * window + 1}\t{s[0]}\t{s[1]}\t{rate:.5f}\n")
    print(verdict)
    return 0
