# Copied verbatim from gatk_tpu/tools/variant_tools.py; only import lines may differ.
"""Variant utility tools: SelectVariants, VariantFiltration, ValidateVariants,
SplitIntervals, MergeVcfs, LeftAlignAndTrimVariants.

Reference behavior: tools/walkers/variantutils/SelectVariants.java,
filters/VariantFiltration.java, ValidateVariants.java, SplitIntervals.java.
"""
from __future__ import annotations

import argparse
import os
import re

from ..cli import UserError, register_tool
from ..engine import walkers
from ..engine import intervals as iv
from ..io import bam, fasta, vcf

_SELECT_TYPES = {"SNP", "INDEL", "MNP", "MIXED", "SYMBOLIC", "NO_VARIATION"}


def _variant_type(v):
    if not v.alts:
        return "NO_VARIATION"
    if any(a.startswith("<") for a in v.alts):
        return "SYMBOLIC"
    kinds = set()
    for a in v.alts:
        if a == "*":
            kinds.add("SYMBOLIC")
        elif len(a) == len(v.ref):
            kinds.add("SNP" if len(a) == 1 else "MNP")
        else:
            kinds.add("INDEL")
    return kinds.pop() if len(kinds) == 1 else "MIXED"


_EXPR_RE = re.compile(r"^\s*(\w+)\s*(<=|>=|<|>|==|!=)\s*(-?[\d.eE+]+)\s*$")


def _eval_filter_expression(expr: str, v) -> bool:
    """True if the expression matches (i.e. the variant FAILS the filter).
    Supports conjunctions with '||' / '&&' of simple INFO comparisons (the
    common subset of GATK's JEXL usage)."""
    for or_part in expr.split("||"):
        ands = or_part.split("&&")
        ok = True
        for a in ands:
            m = _EXPR_RE.match(a)
            if not m:
                raise UserError(f"unsupported filter expression: '{a.strip()}'")
            key, op, val = m.groups()
            raw = v.info.get(key)
            if raw is None:
                ok = False
                break
            x = float(str(raw).split(",")[0])
            y = float(val)
            ok = {"<": x < y, ">": x > y, "<=": x <= y, ">=": x >= y,
                  "==": x == y, "!=": x != y}[op]
            if not ok:
                break
        if ok and ands:
            return True
    return False


@register_tool("ValidateVariants")
def validate_variants(argv):
    """Validate a VCF: sorted positions, allele well-formedness, ref match."""
    p = argparse.ArgumentParser(description="ValidateVariants")
    p.add_argument("-V", "--variant", required=True)
    p.add_argument("-R", "--reference", default=None)
    args = p.parse_args(argv)

    ref = fasta.FastaReference(args.reference) if args.reference else None
    last = {}
    n = 0
    for v in vcf.VcfReader(args.variant):
        n += 1
        if v.contig in last and v.pos < last[v.contig]:
            raise UserError(f"variant at {v.contig}:{v.pos + 1} out of order")
        last[v.contig] = v.pos
        if not re.fullmatch(r"[ACGTNacgtn]+", v.ref):
            raise UserError(f"malformed REF '{v.ref}' at {v.contig}:{v.pos + 1}")
        for a in v.alts:
            if not (a == "*" or a.startswith("<") or re.fullmatch(r"[ACGTNacgtn]+", a)):
                raise UserError(f"malformed ALT '{a}' at {v.contig}:{v.pos + 1}")
        if ref is not None and v.contig in ref.contig_order:
            actual = bytes(ref.fetch(v.contig, v.pos, v.pos + len(v.ref))).decode().upper()
            if actual != v.ref.upper():
                raise UserError(
                    f"the REF allele ({v.ref}) at {v.contig}:{v.pos + 1} does not "
                    f"match the reference ({actual})")
    print(f"validated {n} records; no errors found")
    return 0


@register_tool("SplitIntervals")
def split_intervals(argv):
    """Split intervals into roughly equal scatter files (SplitIntervals.java)."""
    p = argparse.ArgumentParser(description="SplitIntervals")
    p.add_argument("-R", "--reference", default=None)
    p.add_argument("-L", "--intervals", action="append", default=None)
    p.add_argument("--scatter-count", type=int, required=True)
    p.add_argument("-O", "--output", required=True)
    args = p.parse_args(argv)

    spans = []
    if args.intervals:
        for s in args.intervals:
            t = iv.parse_interval(s)
            spans.append((t.contig, t.start, t.end))
    elif args.reference:
        ref = fasta.FastaReference(args.reference)
        for c in ref.contig_order:
            spans.append((c, 0, ref.contig_length(c)))
    else:
        raise UserError("provide -L intervals or -R reference")

    total = sum(e - s for _c, s, e in spans)
    per_shard = max(1, -(-total // args.scatter_count))
    os.makedirs(args.output, exist_ok=True)
    shard = []
    shards = [shard]
    room = per_shard
    for c, s, e in spans:
        while e - s > 0:
            take = min(room, e - s)
            shard.append((c, s, s + take))
            s += take
            room -= take
            if room == 0 and len(shards) < args.scatter_count:
                shard = []
                shards.append(shard)
                room = per_shard
    for i, sh in enumerate(shards):
        path = os.path.join(args.output, f"{i:04d}-scattered.interval_list")
        with open(path, "w") as fh:
            for c, s, e in sh:
                fh.write(f"{c}\t{s + 1}\t{e}\t+\t.\n")
    print(f"wrote {len(shards)} interval shards to {args.output}")
    return 0


@register_tool("MergeVcfs")
def merge_vcfs(argv):
    """Concatenate + coordinate-sort VCFs with identical samples (GatherVcfs)."""
    p = argparse.ArgumentParser(description="MergeVcfs")
    p.add_argument("-I", "--input", action="append", required=True)
    p.add_argument("-O", "--output", required=True)
    args = p.parse_args(argv)

    readers = [vcf.VcfReader(path) for path in args.input]
    samples = readers[0].samples
    for r in readers[1:]:
        if r.samples != samples:
            raise UserError("inputs have different sample columns")
    variants = [v for r in readers for v in r]
    variants.sort(key=lambda v: (v.contig, v.pos))
    w = vcf.VcfWriter(args.output, samples, extra_header_lines=readers[0].header_lines)
    for v in variants:
        w.write(v)
    w.close()
    print(f"wrote {len(variants)} records")
    return 0


@register_tool("FlagStat")
def flagstat(argv):
    """Read flag statistics (samtools flagstat / FlagStat.java)."""
    p = argparse.ArgumentParser(description="FlagStat")
    p.add_argument("-I", "--input", required=True)
    args = p.parse_args(argv)

    stats = dict(total=0, secondary=0, supplementary=0, duplicates=0, mapped=0,
                 paired=0, read1=0, read2=0, proper=0, both_mapped=0, singletons=0)
    from ..io import sam

    for r in bam.BamReader(args.input):
        stats["total"] += 1
        if r.is_secondary:
            stats["secondary"] += 1
        if r.is_supplementary:
            stats["supplementary"] += 1
        if r.is_duplicate:
            stats["duplicates"] += 1
        if not r.is_unmapped:
            stats["mapped"] += 1
        if r.is_paired:
            stats["paired"] += 1
            if r.flag & sam.FIRST_OF_PAIR:
                stats["read1"] += 1
            if r.flag & sam.SECOND_OF_PAIR:
                stats["read2"] += 1
            if r.flag & 0x2:
                stats["proper"] += 1
            if not r.is_unmapped and not r.mate_is_unmapped:
                stats["both_mapped"] += 1
            if not r.is_unmapped and r.mate_is_unmapped:
                stats["singletons"] += 1
    for k, v in stats.items():
        print(f"{v} {k}")
    return 0


@register_tool("SortSam")
def sort_sam(argv):
    """Coordinate-sort a BAM."""
    p = argparse.ArgumentParser(description="SortSam")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("--SORT_ORDER", "--sort-order", default="coordinate")
    args = p.parse_args(argv)

    reader = bam.BamReader(args.input)
    reads = list(reader)
    if args.SORT_ORDER == "coordinate":
        reads.sort(key=lambda r: (r.ref_id if r.ref_id >= 0 else 1 << 30, r.pos))
    elif args.SORT_ORDER == "queryname":
        reads.sort(key=lambda r: r.name)
    else:
        raise UserError(f"unsupported sort order {args.SORT_ORDER}")
    w = bam.BamWriter(args.output, reader.header)
    for r in reads:
        w.write(r)
    w.close()
    print(f"sorted {len(reads)} reads ({args.SORT_ORDER})")
    return 0


@register_tool("GatherVcfs")
def gather_vcfs(argv):
    """Concatenate block-ordered VCF shards without re-sorting (picard
    GatherVcfs / GatherVcfsCloud: inputs must be non-overlapping and in
    genomic order; the scatter-gather fast path)."""
    p = argparse.ArgumentParser(description="GatherVcfs")
    p.add_argument("-I", "--input", action="append", required=True)
    p.add_argument("-O", "--output", required=True)
    args = p.parse_args(argv)
    readers = [vcf.VcfReader(path) for path in args.input]
    samples = readers[0].samples
    w = vcf.VcfWriter(args.output, samples, extra_header_lines=readers[0].header_lines)
    last = None
    n = 0
    for r in readers:
        if r.samples != samples:
            raise UserError("inputs have different sample columns")
        for v in r:
            key = (v.contig, v.pos)
            if last is not None and v.contig == last[0] and key < last:
                raise UserError(
                    f"input shards overlap/are out of order at {v.contig}:{v.pos + 1}")
            last = key
            w.write(v)
            n += 1
    w.close()
    print(f"gathered {n} records from {len(readers)} shards")
    return 0


@register_tool("SortVcf")
def sort_vcf(argv):
    """Sort a VCF in sequence-dictionary order (picard SortVcf)."""
    p = argparse.ArgumentParser(description="SortVcf")
    p.add_argument("-I", "--input", action="append", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("-SD", "--sequence-dictionary", default=None,
                   help=".dict file fixing the contig order (default: order of "
                        "first appearance)")
    args = p.parse_args(argv)
    readers = [vcf.VcfReader(path) for path in args.input]
    order: dict[str, int] = {}
    if args.sequence_dictionary:
        for line in open(args.sequence_dictionary):
            if line.startswith("@SQ"):
                for f in line.split("\t"):
                    if f.startswith("SN:"):
                        order[f[3:].strip()] = len(order)
    variants = [v for r in readers for v in r]
    for v in variants:
        if v.contig not in order:
            order[v.contig] = len(order)
    variants.sort(key=lambda v: (order[v.contig], v.pos))
    w = vcf.VcfWriter(args.output, readers[0].samples,
                      extra_header_lines=readers[0].header_lines)
    for v in variants:
        w.write(v)
    w.close()
    print(f"sorted {len(variants)} records")
    return 0


def _read_chain_file(path):
    """Parse a UCSC liftover chain file into per-source-contig block lists:
    (src_start, src_end, dst_contig, dst_start, flip, dst_size)."""
    blocks: dict[str, list] = {}
    with open(path) as fh:
        header = None
        src_off = dst_off = 0
        for line in fh:
            line = line.strip()
            if not line:
                header = None
                continue
            if line.startswith("chain"):
                f = line.split()
                # chain score tName tSize tStrand tStart tEnd qName qSize qStrand qStart qEnd id
                header = dict(src=f[2], src_size=int(f[3]), src_start=int(f[5]),
                              dst=f[7], dst_size=int(f[8]), dst_strand=f[9],
                              dst_start=int(f[10]))
                src_off = header["src_start"]
                dst_off = header["dst_start"]
                continue
            if header is None:
                continue
            f = line.split()
            size = int(f[0])
            blocks.setdefault(header["src"], []).append(
                (src_off, src_off + size, header["dst"], dst_off,
                 header["dst_strand"] == "-", header["dst_size"]))
            if len(f) == 3:
                src_off += size + int(f[1])
                dst_off += size + int(f[2])
            else:
                header = None
    for c in blocks:
        blocks[c].sort()
    return blocks


@register_tool("LiftoverVcf")
def liftover_vcf(argv):
    """Lift VCF records between assemblies via a chain file (picard LiftoverVcf:
    per-record coordinate mapping, REJECT file for unmapped/ref-mismatch sites)."""
    import bisect

    p = argparse.ArgumentParser(description="LiftoverVcf")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("-C", "--chain", required=True)
    p.add_argument("-R", "--reference", required=True, help="TARGET reference")
    p.add_argument("--reject", required=True)
    args = p.parse_args(argv)
    chain = _read_chain_file(args.chain)
    ref = fasta.FastaReference(args.reference)
    reader = vcf.VcfReader(args.input)
    lifted, rejects = [], []
    for v in reader:
        blocks = chain.get(v.contig, [])
        i = bisect.bisect_right([b[0] for b in blocks], v.pos) - 1
        if i < 0 or v.pos + len(v.ref) > blocks[i][1]:
            rejects.append((v, "NoTarget"))
            continue
        src_start, _src_end, dst, dst_start, flip, dst_size = blocks[i]
        if flip:
            rejects.append((v, "ReverseStrand"))  # strand flips not lifted
            continue
        new_pos = dst_start + (v.pos - src_start)
        tgt = ref.fetch(dst, new_pos, new_pos + len(v.ref)).tobytes().decode()
        if tgt.upper() != v.ref.upper():
            rejects.append((v, "MismatchedRefAllele"))
            continue
        lifted.append(vcf.Variant(contig=dst, pos=new_pos, ref=v.ref, alts=v.alts,
                                  qual=v.qual, filters=v.filters, info=v.info,
                                  fmt_keys=v.fmt_keys, samples=v.samples,
                                  id=v.id))
    lifted.sort(key=lambda v: (v.contig, v.pos))
    w = vcf.VcfWriter(args.output, reader.samples,
                      extra_header_lines=reader.header_lines)
    for v in lifted:
        w.write(v)
    w.close()
    rw = vcf.VcfWriter(args.reject, reader.samples,
                       extra_header_lines=reader.header_lines)
    for v, why in rejects:
        v.filters = (why,)
        rw.write(v)
    rw.close()
    print(f"lifted {len(lifted)} records, rejected {len(rejects)}")
    return 0


@register_tool("VariantAnnotator")
def variant_annotator(argv):
    """Annotate VCF records with pluggable annotations computed from a BAM
    pileup (walkers/annotator/VariantAnnotator.java; -A/-AX select
    annotations by their reference class names)."""
    p = argparse.ArgumentParser(description="VariantAnnotator")
    p.add_argument("-V", "--variant", required=True)
    p.add_argument("-I", "--input", default=None, help="BAM for pileup annotations")
    p.add_argument("-R", "--reference", default=None)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("-L", "--intervals", action="append", default=None)
    p.add_argument("-A", "--annotation", action="append", default=[])
    p.add_argument("-G", "--annotation-group", action="append", default=[])
    p.add_argument("-AX", "--annotations-to-exclude", action="append", default=[])
    p.add_argument("--pedigree", default=None,
                   help="PED file for family annotations (PossibleDeNovo, "
                        "TransmittedSingleton)")
    p.add_argument("--flow-order-for-annotations", default="TGCA")
    args = p.parse_args(argv)

    from ..calling.annotations import (ANNOTATION_REGISTRY, STANDARD_SET,
                                       VariantAnnotatorEngine)

    trios = []
    if args.pedigree:
        # PED: family individual father mother sex phenotype (tab/space)
        by_id = {}
        for line in open(args.pedigree):
            f = line.split()
            if len(f) >= 4 and not line.startswith("#"):
                by_id[f[1]] = (f[3], f[2])  # (mother, father)
        for child, (mother, father) in by_id.items():
            if mother != "0" and father != "0":
                trios.append((mother, father, child))

    engine = VariantAnnotatorEngine(
        list(args.annotation_group) or STANDARD_SET, extra=args.annotation,
        exclude=args.annotations_to_exclude)
    reference = None
    if args.reference:
        from ..io import fasta

        reference = fasta.FastaReference(args.reference)
    reads_src = None
    if args.input:
        from ..io.cram import open_reads

        reads_src = open_reads(args.input, reference=reference)
    reader = vcf.VcfReader(args.variant)
    targets = [iv.parse_interval(s) for s in args.intervals] if args.intervals else None
    info_keys = sorted({k for a in engine.annotations for k in a.keys})
    headers = list(reader.header_lines) + [
        f"##INFO=<ID={k},Number=.,Type=String,Description=\"gatk_tpu VariantAnnotator\">"
        for k in info_keys]
    w = vcf.VcfWriter(args.output, reader.samples, extra_header_lines=headers)
    n = 0
    for v in reader:
        if targets is not None and not any(
                v.contig == t.contig and t.start <= v.pos < t.end for t in targets):
            continue
        reads = []
        if reads_src is not None:
            reads = [r for r in reads_src.query(v.contig, v.pos, v.pos + max(1, len(v.ref)))
                     if not r.is_unmapped and not r.is_duplicate and r.mapq > 0]
        genotypes = dict(zip(reader.samples, v.samples)) if v.samples else None
        new_info, new_fmt = engine.annotate_split(
            v, reads, reference, genotypes=genotypes, trios=trios,
            flow_order=args.flow_order_for_annotations)
        merged = dict(v.info)
        for k, val in new_info.items():
            merged[k] = True if val is None else val
        v.info = merged
        if new_fmt and v.samples:
            v.samples[0].update(new_fmt)
        w.write(v)
        n += 1
    w.close()
    print(f"annotated {n} variants to {args.output}")
    return 0
