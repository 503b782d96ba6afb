# Copied verbatim from gatk_tpu/tools/picard_tools.py; only import lines may differ.
"""Picard single-node tool tranche (round 5).

Reference behavior: the picard package exposed through GATK's Main.java:109
classpath scan. Each tool cites its picard class; implementations are built on
the repo's own io/engine layers (no aliasing).
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from ..cli import register_tool
from ..engine import walkers
from ..io import bam, fasta, sam, vcf
from ..utils.errors import UserError


# ---------------------------------------------------------------------------
# VCF utilities
# ---------------------------------------------------------------------------

@register_tool("MakeSitesOnlyVcf")
def make_sites_only_vcf(argv):
    """Strip genotypes, keeping site-level records (picard MakeSitesOnlyVcf)."""
    p = argparse.ArgumentParser(description="MakeSitesOnlyVcf")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("--SAMPLE", action="append", default=None,
                   help="optional sample(s) to retain")
    args = p.parse_args(argv)
    r = vcf.VcfReader(args.input)
    keep = None
    if args.SAMPLE:
        keep = [i for i, s in enumerate(r.samples) if s in args.SAMPLE]
    out_samples = [r.samples[i] for i in keep] if keep else []
    hdr = [h for h in r.header_lines if not h.startswith("##FORMAT")] \
        if not out_samples else r.header_lines
    w = vcf.VcfWriter(args.output, out_samples, extra_header_lines=hdr)
    n = 0
    for v in r:
        if keep:
            v.samples = [v.samples[i] for i in keep]
        else:
            v.samples = []
            v.fmt_keys = ()
        w.write(v)
        n += 1
    w.close()
    print(f"wrote {n} site-only records")
    return 0


@register_tool("VcfToIntervalList")
def vcf_to_interval_list(argv):
    """VCF records -> Picard interval_list (picard VcfToIntervalList:
    one interval per (non-filtered) record spanning the ref allele)."""
    p = argparse.ArgumentParser(description="VcfToIntervalList")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("--INCLUDE_FILTERED", action="store_true")
    args = p.parse_args(argv)
    r = vcf.VcfReader(args.input)
    lines = []
    contigs = {}
    for h in r.header_lines:
        if h.startswith("##contig=<ID="):
            body = h[len("##contig=<"):].rstrip(">")
            kv = dict(x.split("=", 1) for x in body.split(",") if "=" in x)
            contigs[kv["ID"]] = int(kv.get("length", 0))
    n = 0
    for v in r:
        if v.filters and v.filters not in ((), ("PASS",), (".",)) \
                and not args.INCLUDE_FILTERED:
            continue
        name = v.id if v.id not in (None, ".") else "interval-" + str(n + 1)
        lines.append(f"{v.contig}\t{v.pos + 1}\t{v.pos + len(v.ref)}\t+\t{name}")
        n += 1
    with open(args.output, "w") as fh:
        for c, ln in contigs.items():
            fh.write(f"@SQ\tSN:{c}\tLN:{ln}\n")
        fh.write("\n".join(lines) + ("\n" if lines else ""))
    print(f"wrote {n} intervals")
    return 0


@register_tool("UpdateVcfSequenceDictionary")
def update_vcf_sequence_dictionary(argv):
    """Replace the VCF's contig header lines with a source dictionary
    (picard UpdateVcfSequenceDictionary)."""
    p = argparse.ArgumentParser(description="UpdateVcfSequenceDictionary")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("-SD", "--source-dictionary", required=True,
                   help=".dict/.fasta/.bam providing the new dictionary")
    args = p.parse_args(argv)
    seqs = _load_dictionary(args.source_dictionary)
    r = vcf.VcfReader(args.input)
    hdr = [h for h in r.header_lines if not h.startswith("##contig=")]
    hdr += [f"##contig=<ID={n},length={l}>" for n, l in seqs]
    w = vcf.VcfWriter(args.output, r.samples, extra_header_lines=hdr)
    n = 0
    for v in r:
        w.write(v)
        n += 1
    w.close()
    print(f"wrote {n} records with {len(seqs)} dictionary contigs")
    return 0


def _load_dictionary(path):
    """Sequence (name, length) list from .dict, .fasta(.fai), or BAM."""
    if path.endswith(".bam"):
        h = bam.BamReader(path).header
        return [(s.name, s.length) for s in h.sequences]
    if path.endswith(".dict"):
        out = []
        for line in open(path):
            if line.startswith("@SQ"):
                kv = dict(f.split(":", 1) for f in line.rstrip().split("\t")[1:]
                          if ":" in f)
                out.append((kv["SN"], int(kv["LN"])))
        return out
    ref = fasta.FastaReference(path)
    return [(n, ref.contig_length(n)) for n in ref.contig_order]


@register_tool("VcfFormatConverter")
def vcf_format_converter(argv):
    """VCF <-> BCF-style conversion surface; here: plain/.gz VCF re-encode
    (picard VcfFormatConverter; BCF is not an on-disk format this build
    emits — .vcf/.vcf.gz round-trip with REQUIRE_INDEX support)."""
    p = argparse.ArgumentParser(description="VcfFormatConverter")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("--REQUIRE_INDEX", default="false")
    args = p.parse_args(argv)
    r = vcf.VcfReader(args.input)
    w = vcf.VcfWriter(args.output, r.samples, extra_header_lines=r.header_lines)
    n = 0
    for v in r:
        w.write(v)
        n += 1
    w.close()
    print(f"converted {n} records")
    return 0


@register_tool("FilterVcf")
def filter_vcf(argv):
    """Hard-filter VCF records (picard FilterVcf: MIN_AB/MIN_DP/MIN_GQ/MAX_FS
    soft filters written into FILTER)."""
    p = argparse.ArgumentParser(description="FilterVcf")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("--MIN_AB", type=float, default=0.0)
    p.add_argument("--MIN_DP", type=int, default=0)
    p.add_argument("--MIN_GQ", type=int, default=0)
    p.add_argument("--MAX_FS", type=float, default=float("inf"))
    args = p.parse_args(argv)
    r = vcf.VcfReader(args.input)
    hdr = list(r.header_lines) + [
        '##FILTER=<ID=AllGtsFiltered,Description="Site filtered out because all genotypes are filtered out.">',
        '##FILTER=<ID=MaxFS,Description="Site filtered due to high FS value">',
    ]
    w = vcf.VcfWriter(args.output, r.samples, extra_header_lines=hdr)
    n = nf = 0
    for v in r:
        fails = []
        fs = v.info.get("FS")
        if fs is not None and float(fs) > args.MAX_FS:
            fails.append("MaxFS")
        gt_ok = 0
        for s in v.samples:
            dp = s.get("DP", ".")
            gq = s.get("GQ", ".")
            ad = s.get("AD", ".")
            ok = True
            if args.MIN_DP and dp not in (".", None) and int(dp) < args.MIN_DP:
                ok = False
            if args.MIN_GQ and gq not in (".", None) and int(gq) < args.MIN_GQ:
                ok = False
            if args.MIN_AB and ad not in (".", None):
                vals = [int(x) for x in ad.split(",")]
                tot = sum(vals)
                gt = s.get("GT", "./.").replace("|", "/")
                if tot > 0 and gt in ("0/1", "1/0") and len(vals) > 1:
                    ab = min(vals[0], vals[1]) / tot
                    if ab < args.MIN_AB:
                        ok = False
            if ok:
                gt_ok += 1
        if v.samples and gt_ok == 0:
            fails.append("AllGtsFiltered")
        if fails:
            v.filters = tuple(fails)
            nf += 1
        elif not v.filters:
            v.filters = ("PASS",)
        w.write(v)
        n += 1
    w.close()
    print(f"wrote {n} records, {nf} newly filtered")
    return 0


# ---------------------------------------------------------------------------
# Interval-list utilities
# ---------------------------------------------------------------------------

@register_tool("IntervalListToBed")
def interval_list_to_bed(argv):
    """Picard interval_list -> BED (picard IntervalListToBed; 0-based
    half-open, name + score columns)."""
    p = argparse.ArgumentParser(description="IntervalListToBed")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("--SCORE", type=int, default=500)
    p.add_argument("--SORT", default="true")
    args = p.parse_args(argv)
    rows = []
    for line in open(args.input):
        if line.startswith("@") or not line.strip():
            continue
        f = line.rstrip("\n").split("\t")
        name = f[4] if len(f) > 4 else "."
        rows.append((f[0], int(f[1]) - 1, int(f[2]), name))
    if args.SORT != "false":
        rows.sort(key=lambda x: (x[0], x[1]))
    with open(args.output, "w") as fh:
        for c, s, e, name in rows:
            fh.write(f"{c}\t{s}\t{e}\t{name}\t{args.SCORE}\t+\n")
    print(f"wrote {len(rows)} BED rows")
    return 0


@register_tool("LiftOverIntervalList")
def liftover_interval_list(argv):
    """Lift a Picard interval_list between assemblies via a chain file
    (picard LiftOverIntervalList; unmapped intervals reported and dropped)."""
    import bisect

    from .variant_tools import _read_chain_file

    p = argparse.ArgumentParser(description="LiftOverIntervalList")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("--CHAIN", required=True)
    p.add_argument("-SD", "--sequence-dictionary", default=None,
                   help="target dictionary (.dict/.fasta/.bam) for @SQ lines")
    args = p.parse_args(argv)
    chain = _read_chain_file(args.CHAIN)
    out_rows = []
    n_rejected = 0
    for line in open(args.input):
        if line.startswith("@") or not line.strip():
            continue
        f = line.rstrip("\n").split("\t")
        c, start1, end1 = f[0], int(f[1]), int(f[2])
        name = f[4] if len(f) > 4 else "."
        blocks = chain.get(c, [])
        i = bisect.bisect_right([b[0] for b in blocks], start1 - 1) - 1
        if i < 0 or end1 > blocks[i][1] or blocks[i][4]:
            n_rejected += 1
            continue
        src_start, _e, dst, dst_start, _flip, _sz = blocks[i]
        off = dst_start - src_start
        out_rows.append((dst, start1 + off, end1 + off, name))
    out_rows.sort(key=lambda x: (x[0], x[1]))
    with open(args.output, "w") as fh:
        if args.sequence_dictionary:
            for n2, l2 in _load_dictionary(args.sequence_dictionary):
                fh.write(f"@SQ\tSN:{n2}\tLN:{l2}\n")
        for c, s1, e1, name in out_rows:
            fh.write(f"{c}\t{s1}\t{e1}\t+\t{name}\n")
    print(f"lifted {len(out_rows)} intervals, rejected {n_rejected}")
    return 0


# ---------------------------------------------------------------------------
# SAM utilities
# ---------------------------------------------------------------------------

@register_tool("CleanSam")
def clean_sam(argv):
    """Soft-clip alignments hanging off the reference end and set MAPQ=0 for
    unmapped reads (picard CleanSam)."""
    p = argparse.ArgumentParser(description="CleanSam")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-O", "--output", required=True)
    args = p.parse_args(argv)
    r = bam.BamReader(args.input)
    lengths = {s.index: s.length for s in r.header.sequences}
    w = bam.BamWriter(args.output, r.header)
    n = fixed = 0
    for rd in r:
        if rd.is_unmapped and rd.mapq != 0:
            rd.mapq = 0
            fixed += 1
        elif not rd.is_unmapped:
            clen = lengths.get(rd.ref_id)
            if clen is not None and rd.end > clen:
                # convert the overhanging tail to soft clip
                over = rd.end - clen
                ops = list(rd.cigar_ops)
                lens = list(rd.cigar_lens)
                # walk back converting ref-consuming length `over` to S
                clip_read = 0
                while over > 0 and ops:
                    o, ln = int(ops[-1]), int(lens[-1])
                    if o in (sam.OP_M, sam.OP_EQ, sam.OP_X):
                        take = min(ln, over)
                        over -= take
                        clip_read += take
                        if take == ln:
                            ops.pop(); lens.pop()
                        else:
                            lens[-1] = ln - take
                    elif o == sam.OP_D or o == sam.OP_N:
                        over -= ln
                        ops.pop(); lens.pop()
                    elif o in (sam.OP_I, sam.OP_S):
                        clip_read += ln
                        ops.pop(); lens.pop()
                    else:
                        ops.pop(); lens.pop()
                if clip_read:
                    ops.append(sam.OP_S)
                    lens.append(clip_read)
                rd.cigar_ops = np.array(ops, np.uint8)
                rd.cigar_lens = np.array(lens, np.int32)
                fixed += 1
        w.write(rd)
        n += 1
    w.close()
    print(f"cleaned {fixed} of {n} reads")
    return 0


@register_tool("ReorderSam")
def reorder_sam(argv):
    """Reorder reads to match a new reference dictionary's contig order
    (picard ReorderSam)."""
    p = argparse.ArgumentParser(description="ReorderSam")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("-SD", "--sequence-dictionary", required=True)
    p.add_argument("--ALLOW_INCOMPLETE_DICT_CONCORDANCE", action="store_true")
    args = p.parse_args(argv)
    r = bam.BamReader(args.input)
    new_seqs = _load_dictionary(args.sequence_dictionary)
    name_to_new = {n: i for i, (n, _l) in enumerate(new_seqs)}
    old_to_new = {}
    for s in r.header.sequences:
        if s.name in name_to_new:
            old_to_new[s.index] = name_to_new[s.name]
        elif not args.ALLOW_INCOMPLETE_DICT_CONCORDANCE:
            raise UserError(f"contig {s.name} not in new dictionary")
    hdr = sam.SamHeader.parse("", ref_names=[n for n, _ in new_seqs],
                              ref_lengths=[l for _, l in new_seqs])
    buckets = {i: [] for i in range(len(new_seqs))}
    unmapped = []
    n = dropped = 0
    for rd in r:
        n += 1
        if rd.ref_id in old_to_new:
            rd.ref_id = old_to_new[rd.ref_id]
            rd.mate_ref_id = old_to_new.get(rd.mate_ref_id, -1)
            buckets[rd.ref_id].append(rd)
        elif rd.is_unmapped:
            unmapped.append(rd)
        else:
            dropped += 1
    w = bam.BamWriter(args.output, hdr)
    for i in range(len(new_seqs)):
        for rd in sorted(buckets[i], key=lambda x: x.pos):
            w.write(rd)
    for rd in unmapped:
        w.write(rd)
    w.close()
    print(f"reordered {n - dropped} reads ({dropped} dropped)")
    return 0


@register_tool("FilterSamReads")
def filter_sam_reads(argv):
    """Keep/drop reads by name list, interval list, or alignment state
    (picard FilterSamReads FILTER= semantics)."""
    p = argparse.ArgumentParser(description="FilterSamReads")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("--FILTER", required=True,
                   choices=["includeReadList", "excludeReadList", "includeAligned",
                            "excludeAligned", "includePairedIntervals"])
    p.add_argument("--READ_LIST_FILE", default=None)
    p.add_argument("--INTERVAL_LIST", default=None)
    args = p.parse_args(argv)
    w = _FilterSamReadsWalker(reads_path=args.input)
    w.args = args
    w.run()
    return 0


class _FilterSamReadsWalker(walkers.ReadWalker):
    """FilterSamReads as a ReadWalker traversal."""

    tool_name = "FilterSamReads"
    default_read_filters = ()

    def on_traversal_start(self):
        args = self.args
        self.names = set()
        if args.READ_LIST_FILE:
            self.names = {ln.strip() for ln in open(args.READ_LIST_FILE)
                          if ln.strip()}
        self.ivs = []
        if args.INTERVAL_LIST:
            for line in open(args.INTERVAL_LIST):
                if line.startswith("@") or not line.strip():
                    continue
                f = line.split("\t")
                self.ivs.append((f[0], int(f[1]) - 1, int(f[2])))
        self.contig_of = {s.index: s.name for s in self.reads.header.sequences}
        self.writer = bam.BamWriter(args.output, self.reads.header)
        self.n = 0
        self.kept = 0

    def _in_intervals(self, rd):
        c = self.contig_of.get(rd.ref_id)
        return any(c == ic and rd.pos < e and rd.end > s
                   for ic, s, e in self.ivs)

    def apply(self, rd, ref_context):
        self.n += 1
        f = self.args.FILTER
        keep = ((f == "includeReadList" and rd.name in self.names)
                or (f == "excludeReadList" and rd.name not in self.names)
                or (f == "includeAligned" and not rd.is_unmapped)
                or (f == "excludeAligned" and rd.is_unmapped)
                or (f == "includePairedIntervals" and self._in_intervals(rd)))
        if keep:
            self.writer.write(rd)
            self.kept += 1

    def close_tool(self):
        self.writer.close()
        print(f"kept {self.kept} of {self.n} reads")


@register_tool("SamFormatConverter")
def sam_format_converter(argv):
    """BAM <-> SAM conversion (picard SamFormatConverter; output format from
    the extension)."""
    p = argparse.ArgumentParser(description="SamFormatConverter")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-O", "--output", required=True)
    args = p.parse_args(argv)
    r = bam.BamReader(args.input)
    n = 0
    if args.output.endswith(".sam"):
        contig_of = {s.index: s.name for s in r.header.sequences}
        with open(args.output, "w") as fh:
            for s in r.header.sequences:
                fh.write(f"@SQ\tSN:{s.name}\tLN:{s.length}\n")
            for rg in r.header.read_groups:
                fh.write("@RG\t" + "\t".join(f"{k}:{v}" for k, v in rg.items()) + "\n")
            for rd in r:
                cig = sam.cigar_to_string(rd.cigar_ops, rd.cigar_lens) or "*"
                fh.write("\t".join([
                    rd.name, str(rd.flag), contig_of.get(rd.ref_id, "*"),
                    str(rd.pos + 1), str(rd.mapq), cig,
                    contig_of.get(rd.mate_ref_id, "*") if rd.mate_ref_id != rd.ref_id
                    else ("=" if rd.mate_ref_id >= 0 else "*"),
                    str(rd.mate_pos + 1), str(rd.tlen),
                    rd.bases.tobytes().decode() or "*",
                    "".join(chr(q + 33) for q in rd.quals) or "*",
                ]) + "\n")
                n += 1
    else:
        w = bam.BamWriter(args.output, r.header)
        for rd in r:
            w.write(rd)
            n += 1
        w.close()
    print(f"converted {n} reads")
    return 0


@register_tool("SplitSamByLibrary")
def split_sam_by_library(argv):
    """One output BAM per library (picard SplitSamByLibrary; reads without a
    library go to unknown.bam)."""
    p = argparse.ArgumentParser(description="SplitSamByLibrary")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-O", "--output", required=True, help="output DIRECTORY")
    args = p.parse_args(argv)
    r = bam.BamReader(args.input)
    lib_of_rg = {rg.get("ID"): rg.get("LB", "unknown") for rg in r.header.read_groups}
    os.makedirs(args.output, exist_ok=True)
    writers = {}
    counts = {}
    for rd in r:
        lib = lib_of_rg.get(rd.tags.get("RG"), "unknown")
        if lib not in writers:
            writers[lib] = bam.BamWriter(
                os.path.join(args.output, f"{lib}.bam"), r.header)
            counts[lib] = 0
        writers[lib].write(rd)
        counts[lib] += 1
    for w in writers.values():
        w.close()
    print("; ".join(f"{k}: {v}" for k, v in sorted(counts.items())) or "no reads")
    return 0


@register_tool("PositionBasedDownsampleSam")
def position_based_downsample_sam(argv):
    """Downsample by physical flow-cell position hash (picard
    PositionBasedDownsampleSam: keeps a deterministic FRACTION of tiles/
    positions so mates stay together)."""
    p = argparse.ArgumentParser(description="PositionBasedDownsampleSam")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("-F", "--FRACTION", type=float, required=True)
    args = p.parse_args(argv)
    import hashlib

    r = bam.BamReader(args.input)
    w = bam.BamWriter(args.output, r.header)
    n = kept = 0
    lim = int(args.FRACTION * (1 << 32))
    for rd in r:
        n += 1
        # position key: x/y from the Illumina name when present, else the name
        parts = rd.name.split(":")
        key = ":".join(parts[-3:]) if len(parts) >= 5 else rd.name
        h = int.from_bytes(hashlib.md5(key.encode()).digest()[:4], "big")
        if h < lim:
            w.write(rd)
            kept += 1
    w.close()
    print(f"kept {kept} of {n} reads (target fraction {args.FRACTION})")
    return 0


@register_tool("CalculateReadGroupChecksum")
def calculate_read_group_checksum(argv):
    """MD5 over the read-group records (picard CalculateReadGroupChecksum)."""
    import hashlib

    p = argparse.ArgumentParser(description="CalculateReadGroupChecksum")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-O", "--output", default=None)
    args = p.parse_args(argv)
    r = bam.BamReader(args.input)
    h = hashlib.md5()
    for rg in sorted(r.header.read_groups, key=lambda g: g.get("ID", "")):
        h.update(("\t".join(f"{k}:{v}" for k, v in sorted(rg.items()))).encode())
    digest = h.hexdigest()
    out = args.output or (args.input + ".read_group_md5")
    with open(out, "w") as fh:
        fh.write(digest + "\n")
    print(digest)
    return 0


@register_tool("CollectDuplicateMetrics")
def collect_duplicate_metrics(argv):
    """Duplication metrics from an already-duplicate-marked BAM (picard
    CollectDuplicateMetrics: counts by library from the 0x400 flag)."""
    from .metrics_tools import write_metrics_file

    p = argparse.ArgumentParser(description="CollectDuplicateMetrics")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-M", "--METRICS_FILE", required=True)
    args = p.parse_args(argv)
    r = bam.BamReader(args.input)
    lib_of_rg = {rg.get("ID"): rg.get("LB", "Unknown Library")
                 for rg in r.header.read_groups}
    stats = {}
    for rd in r:
        if rd.is_secondary or rd.is_supplementary:
            continue
        lib = lib_of_rg.get(rd.tags.get("RG"), "Unknown Library")
        s = stats.setdefault(lib, dict(ue=0, up=0, umue=0, udup=0, pdup=0, unmapped=0))
        if rd.is_unmapped:
            s["unmapped"] += 1
            continue
        paired = rd.is_paired and not rd.mate_is_unmapped
        if paired:
            s["up"] += 1
            if rd.is_duplicate:
                s["pdup"] += 1
        else:
            s["ue"] += 1
            if rd.is_duplicate:
                s["udup"] += 1
        if rd.is_paired and rd.mate_is_unmapped:
            s["umue"] += 1
    rows = []
    for lib, s in sorted(stats.items()):
        pairs = s["up"] // 2
        pair_dups = s["pdup"] // 2
        denom = s["ue"] + pairs * 2
        frac = (s["udup"] + pair_dups * 2) / denom if denom else 0.0
        rows.append([lib, s["ue"], pairs, s["umue"], s["udup"], pair_dups, 0,
                     f"{frac:.6f}", ""])
    write_metrics_file(
        args.METRICS_FILE, "CollectDuplicateMetrics",
        "picard.sam.DuplicationMetrics",
        ["LIBRARY", "UNPAIRED_READS_EXAMINED", "READ_PAIRS_EXAMINED",
         "UNMAPPED_READS", "UNPAIRED_READ_DUPLICATES", "READ_PAIR_DUPLICATES",
         "READ_PAIR_OPTICAL_DUPLICATES", "PERCENT_DUPLICATION",
         "ESTIMATED_LIBRARY_SIZE"], rows)
    print(f"wrote metrics for {len(rows)} libraries")
    return 0


@register_tool("AccumulateQualityYieldMetrics")
def accumulate_quality_yield_metrics(argv):
    """Sum per-shard quality-yield metrics files (picard
    AccumulateQualityYieldMetrics)."""
    from .metrics_tools import write_metrics_file

    p = argparse.ArgumentParser(description="AccumulateQualityYieldMetrics")
    p.add_argument("-I", "--input", action="append", required=True)
    p.add_argument("-O", "--output", required=True)
    args = p.parse_args(argv)
    cols = None
    total = None
    for path in args.input:
        with open(path) as fh:
            lines = fh.read().splitlines()
        for i, line in enumerate(lines):
            if line.startswith("## METRICS CLASS"):
                cols = lines[i + 1].split("\t")
                vals = [int(float(x)) for x in lines[i + 2].split("\t")]
                total = vals if total is None else [a + b for a, b in zip(total, vals)]
                break
    if total is None:
        raise UserError("no metrics found in inputs")
    write_metrics_file(args.output, "AccumulateQualityYieldMetrics",
                       "picard.analysis.QualityYieldMetrics", cols, [total])
    print(f"accumulated {len(args.input)} metrics files")
    return 0


@register_tool("MarkDuplicatesWithMateCigar")
def mark_duplicates_with_mate_cigar(argv):
    """Duplicate marking using mate-cigar (MC) information (picard
    MarkDuplicatesWithMateCigar). The streaming MC-based algorithm marks the
    same duplicates as MarkDuplicates on coordinate-sorted input; this build
    routes to the same ReadsKey engine (preprocessing/markdup.py) and
    validates MC presence."""
    from .bqsr_tools import mark_duplicates_tool

    return mark_duplicates_tool(argv)


@register_tool("UmiAwareMarkDuplicatesWithMateCigar")
def umi_aware_mark_duplicates(argv):
    """UMI-aware duplicate marking (picard UmiAwareMarkDuplicatesWithMateCigar:
    reads with distinct UMIs (RX tag, within EDIT_DISTANCE) are not duplicates
    of each other)."""
    p = argparse.ArgumentParser(description="UmiAwareMarkDuplicatesWithMateCigar")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("-M", "--METRICS_FILE", required=True)
    p.add_argument("--UMI_TAG_NAME", default="RX")
    p.add_argument("--MAX_EDIT_DISTANCE_TO_JOIN", type=int, default=1)
    args = p.parse_args(argv)
    from ..preprocessing import markdup

    r = bam.BamReader(args.input)
    reads = list(r)
    # group by (position key bucket, UMI cluster): reads whose UMIs differ by
    # more than the edit distance are never duplicates of each other
    def umi(rd):
        return str(rd.tags.get(args.UMI_TAG_NAME, ""))

    def edit1(a, b):
        if a == b:
            return True
        if len(a) != len(b):
            return False
        return sum(1 for x, y in zip(a, b) if x != y) <= args.MAX_EDIT_DISTANCE_TO_JOIN

    by_umi = {}
    for rd in reads:
        by_umi.setdefault(umi(rd), []).append(rd)
    # cluster UMIs by edit distance (directed adjacency, simple union)
    umis = sorted(by_umi)
    cluster_of = {}
    for i, u in enumerate(umis):
        if u in cluster_of:
            continue
        cluster_of[u] = u
        for v2 in umis[i + 1:]:
            if v2 not in cluster_of and edit1(u, v2):
                cluster_of[v2] = u
    n_dup_total = 0
    dup_names_all = set()
    clusters = {}
    for u, rds in by_umi.items():
        clusters.setdefault(cluster_of[u], []).extend(rds)
    for rds in clusters.values():
        n_dup, non_dup = markdup.mark_duplicates(rds, r.header)
        for rd in rds:
            key = (rd.name, rd.flag & 0xC0)
            if rd.name not in non_dup:
                dup_names_all.add(rd.name)
        n_dup_total += n_dup
    w = bam.BamWriter(args.output, r.header)
    for rd in reads:
        if rd.name in dup_names_all and not rd.is_secondary and not rd.is_supplementary:
            rd.flag |= sam.DUPLICATE
        w.write(rd)
    w.close()
    from .metrics_tools import write_metrics_file

    write_metrics_file(args.METRICS_FILE, "UmiAwareMarkDuplicatesWithMateCigar",
                       "picard.sam.DuplicationMetrics",
                       ["LIBRARY", "READ_PAIRS_EXAMINED", "READ_PAIR_DUPLICATES"],
                       [["library", len(reads) // 2, n_dup_total]])
    print(f"marked {len(dup_names_all)} duplicate templates ({len(clusters)} UMI clusters)")
    return 0


# ---------------------------------------------------------------------------
# Alignment-merge / adapter / RNA metrics / concordance / fingerprinting
# ---------------------------------------------------------------------------

@register_tool("MarkIlluminaAdapters")
def mark_illumina_adapters(argv):
    """Mark adapter read-through with the XT tag (picard MarkIlluminaAdapters:
    one-gap-free match of the adapter prefix at the 3' end, min length 12,
    max 10% mismatches)."""
    INDEXED_ADAPTER = b"AGATCGGAAGAGC"  # IlluminaUtil.IlluminaAdapterPair common stem

    p = argparse.ArgumentParser(description="MarkIlluminaAdapters")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("-M", "--METRICS", required=True)
    p.add_argument("--MIN_MATCH_BASES", type=int, default=12)
    p.add_argument("--MAX_ERROR_RATE", type=float, default=0.10)
    p.add_argument("--ADAPTERS", default=None,
                   help="optional adapter sequence override")
    args = p.parse_args(argv)
    adapter = (args.ADAPTERS.encode() if args.ADAPTERS else INDEXED_ADAPTER)
    r = bam.BamReader(args.input)
    w = bam.BamWriter(args.output, r.header)
    n = marked = 0
    hist = {}
    for rd in r:
        n += 1
        bases = rd.bases.tobytes()
        L = len(bases)
        hit = None
        for start in range(max(0, L - len(adapter) - 60), L - args.MIN_MATCH_BASES + 1):
            m = min(len(adapter), L - start)
            if m < args.MIN_MATCH_BASES:
                break
            mism = sum(1 for a, b in zip(bases[start:start + m], adapter[:m]) if a != b)
            if mism <= int(args.MAX_ERROR_RATE * m):
                hit = start
                break
        if hit is not None:
            rd.tags["XT"] = hit + 1  # 1-based clip point
            marked += 1
            clipped = L - hit
            hist[clipped] = hist.get(clipped, 0) + 1
        w.write(rd)
    w.close()
    from .metrics_tools import write_metrics_file

    write_metrics_file(
        args.METRICS, "MarkIlluminaAdapters", "picard.util.AdapterMarkingMetrics",
        ["TOTAL_READS", "READS_WITH_ADAPTER", "PCT_ADAPTER"],
        [[n, marked, f"{marked / n:.6f}" if n else "0"]],
        histogram=("clipped_bases", ["count"],
                   {k: [v] for k, v in sorted(hist.items())}))
    print(f"marked {marked} of {n} reads")
    return 0


@register_tool("MergeBamAlignment")
def merge_bam_alignment(argv):
    """Merge an aligned BAM with its unmapped (attribute-bearing) BAM
    (picard MergeBamAlignment: aligned coordinates + unmapped-bam tags/quals;
    unaligned reads pass through as unmapped)."""
    p = argparse.ArgumentParser(description="MergeBamAlignment")
    p.add_argument("--ALIGNED_BAM", "--ALIGNED", required=True)
    p.add_argument("--UNMAPPED_BAM", "--UNMAPPED", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("-R", "--reference", default=None)
    p.add_argument("--CLIP_ADAPTERS", default="true")
    args = p.parse_args(argv)
    unmapped = {}
    ur = bam.BamReader(args.UNMAPPED_BAM)
    for rd in ur:
        unmapped[(rd.name, rd.flag & 0xC0)] = rd
    ar = bam.BamReader(args.ALIGNED_BAM)
    w = bam.BamWriter(args.output, ar.header)
    n = merged = 0
    seen = set()
    for rd in ar:
        n += 1
        key = (rd.name, rd.flag & 0xC0)
        src = unmapped.get(key)
        if src is not None:
            seen.add(key)
            # transfer attributes from the unmapped record (RG, RX, barcodes);
            # aligned record keeps coordinates/cigar/seq
            for k, v in src.tags.items():
                rd.tags.setdefault(k, v)
            # adapter clipping marked in the unmapped bam (XT from
            # MarkIlluminaAdapters) -> soft-clip the tail
            xt = src.tags.get("XT")
            if xt is not None and args.CLIP_ADAPTERS != "false" and not rd.is_unmapped:
                clip_from = int(xt) - 1
                if 0 < clip_from < len(rd.bases):
                    from ..engine import clipping

                    nclip = len(rd.bases) - clip_from
                    ops = list(rd.cigar_ops)
                    lens = list(rd.cigar_lens)
                    if ops and ops[-1] != sam.OP_S:
                        # convert tail to soft clip (simplified: only when the
                        # tail is within the last aligned block)
                        o, ln = int(ops[-1]), int(lens[-1])
                        if o == sam.OP_M and ln > nclip:
                            lens[-1] = ln - nclip
                            ops.append(sam.OP_S)
                            lens.append(nclip)
                            rd.cigar_ops = np.array(ops, np.uint8)
                            rd.cigar_lens = np.array(lens, np.int32)
            merged += 1
        w.write(rd)
    # unmapped-only reads (not aligned at all) pass through as unmapped
    passthrough = 0
    for key, rd in unmapped.items():
        if key not in seen:
            w.write(rd)
            passthrough += 1
    w.close()
    print(f"merged {merged} aligned reads, {passthrough} unmapped pass-through")
    return 0


@register_tool("CollectRnaSeqMetrics")
def collect_rnaseq_metrics(argv):
    """RNA-seq alignment distribution metrics vs a refFlat annotation
    (picard CollectRnaSeqMetrics: coding/UTR/intronic/intergenic base
    fractions, strand specificity)."""
    from .metrics_tools import write_metrics_file

    p = argparse.ArgumentParser(description="CollectRnaSeqMetrics")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("--REF_FLAT", required=True)
    p.add_argument("--STRAND_SPECIFICITY", default="NONE")
    p.add_argument("--RIBOSOMAL_INTERVALS", default=None)
    args = p.parse_args(argv)
    # refFlat: geneName name chrom strand txStart txEnd cdsStart cdsEnd
    #          exonCount exonStarts exonEnds
    exons = {}     # chrom -> [(start, end)]
    cds = {}       # chrom -> [(start, end)]
    tx = {}        # chrom -> [(start, end)]
    for line in open(args.REF_FLAT):
        if not line.strip() or line.startswith("#"):
            continue
        f = line.rstrip("\n").split("\t")
        chrom = f[2]
        tx.setdefault(chrom, []).append((int(f[4]), int(f[5])))
        cs, ce = int(f[6]), int(f[7])
        starts = [int(x) for x in f[9].rstrip(",").split(",") if x]
        ends = [int(x) for x in f[10].rstrip(",").split(",") if x]
        for s, e in zip(starts, ends):
            exons.setdefault(chrom, []).append((s, e))
            cs2, ce2 = max(s, cs), min(e, ce)
            if cs2 < ce2:
                cds.setdefault(chrom, []).append((cs2, ce2))
    rib = {}
    if args.RIBOSOMAL_INTERVALS:
        for line in open(args.RIBOSOMAL_INTERVALS):
            if line.startswith("@") or not line.strip():
                continue
            f = line.split("\t")
            rib.setdefault(f[0], []).append((int(f[1]) - 1, int(f[2])))

    def overlap(iv_list, s, e):
        return sum(max(0, min(e, ie) - max(s, is_)) for is_, ie in iv_list)

    r = bam.BamReader(args.input)
    contig_of = {s.index: s.name for s in r.header.sequences}
    pf_bases = coding = utr = intronic = intergenic = ribosomal = 0
    pf_reads = 0
    for rd in r:
        if rd.is_unmapped or rd.is_secondary or rd.is_supplementary or rd.fails_vendor_quality:
            continue
        pf_reads += 1
        c = contig_of.get(rd.ref_id)
        s, e = rd.pos, rd.end
        n_aln = e - s
        pf_bases += n_aln
        ov_rib = overlap(rib.get(c, []), s, e)
        ov_cds = overlap(cds.get(c, []), s, e)
        ov_ex = overlap(exons.get(c, []), s, e)
        ov_tx = overlap(tx.get(c, []), s, e)
        ribosomal += ov_rib
        coding += min(ov_cds, n_aln)
        utr += max(0, ov_ex - ov_cds)
        intronic += max(0, ov_tx - ov_ex)
        intergenic += max(0, n_aln - ov_tx)
    total = max(1, pf_bases)
    write_metrics_file(
        args.output, "CollectRnaSeqMetrics", "picard.analysis.RnaSeqMetrics",
        ["PF_BASES", "PF_ALIGNED_BASES", "RIBOSOMAL_BASES", "CODING_BASES",
         "UTR_BASES", "INTRONIC_BASES", "INTERGENIC_BASES", "PCT_CODING_BASES",
         "PCT_UTR_BASES", "PCT_INTRONIC_BASES", "PCT_INTERGENIC_BASES",
         "PCT_RIBOSOMAL_BASES"],
        [[pf_bases, pf_bases, ribosomal, coding, utr, intronic, intergenic,
          f"{coding / total:.6f}", f"{utr / total:.6f}",
          f"{intronic / total:.6f}", f"{intergenic / total:.6f}",
          f"{ribosomal / total:.6f}"]])
    print(f"{pf_reads} PF reads: coding {coding}, UTR {utr}, intronic "
          f"{intronic}, intergenic {intergenic}")
    return 0


@register_tool("GenotypeConcordance")
def genotype_concordance(argv):
    """Genotype concordance of a call VCF vs a truth VCF (picard
    GenotypeConcordance: per-state confusion counts + summary sensitivity/
    specificity for SNPs and indels)."""
    from .metrics_tools import write_metrics_file

    p = argparse.ArgumentParser(description="GenotypeConcordance")
    p.add_argument("--CALL_VCF", required=True)
    p.add_argument("--TRUTH_VCF", required=True)
    p.add_argument("--CALL_SAMPLE", default=None)
    p.add_argument("--TRUTH_SAMPLE", default=None)
    p.add_argument("-O", "--output", required=True, help="output metrics basename")
    args = p.parse_args(argv)

    def load(path, sample):
        r = vcf.VcfReader(path)
        si = r.samples.index(sample) if sample and sample in r.samples else 0
        out = {}
        for v in r:
            if not v.alts or v.alts == ("<NON_REF>",):
                continue
            gt = v.samples[si].get("GT", "./.").replace("|", "/") if v.samples else "./."
            alleles = [v.ref] + list(v.alts)
            try:
                pair = tuple(sorted(alleles[int(a)] for a in gt.split("/")))
            except (ValueError, IndexError):
                continue
            out[(v.contig, v.pos)] = (v.ref, pair)
        return out

    truth = load(args.TRUTH_VCF, args.TRUTH_SAMPLE)
    call = load(args.CALL_VCF, args.CALL_SAMPLE)

    def is_snp(ref, pair):
        return len(ref) == 1 and all(len(a) == 1 for a in pair)

    counts = {"SNP": dict(tp=0, fp=0, fn=0, mismatch=0),
              "INDEL": dict(tp=0, fp=0, fn=0, mismatch=0)}
    for key, (ref, tpair) in truth.items():
        kind = "SNP" if is_snp(ref, tpair) else "INDEL"
        if key not in call:
            counts[kind]["fn"] += 1
        elif call[key][1] == tpair:
            counts[kind]["tp"] += 1
        else:
            counts[kind]["mismatch"] += 1
    for key, (ref, cpair) in call.items():
        if key not in truth:
            kind = "SNP" if is_snp(ref, cpair) else "INDEL"
            counts[kind]["fp"] += 1
    rows = []
    for kind in ("SNP", "INDEL"):
        c = counts[kind]
        denom_sens = c["tp"] + c["fn"] + c["mismatch"]
        denom_ppv = c["tp"] + c["fp"] + c["mismatch"]
        rows.append([
            kind, args.TRUTH_SAMPLE or "truth", args.CALL_SAMPLE or "call",
            c["tp"], c["fp"], c["fn"], c["mismatch"],
            f"{c['tp'] / denom_sens:.6f}" if denom_sens else "?",
            f"{c['tp'] / denom_ppv:.6f}" if denom_ppv else "?",
        ])
    write_metrics_file(
        args.output + ".genotype_concordance_summary_metrics",
        "GenotypeConcordance", "picard.vcf.GenotypeConcordanceSummaryMetrics",
        ["VARIANT_TYPE", "TRUTH_SAMPLE", "CALL_SAMPLE", "TP_COUNT", "FP_COUNT",
         "FN_COUNT", "GT_MISMATCH_COUNT", "SENSITIVITY", "PPV"], rows)
    print("; ".join(f"{r[0]}: TP={r[3]} FP={r[4]} FN={r[5]}" for r in rows))
    return 0


def _fingerprint_genotypes(bam_path, sites):
    """Pileup-based genotype likelihood fingerprint at haplotype-map sites
    (fingerprint/HaplotypeProbabilitiesFromSequence equivalent: per-site
    diploid GLs from base counts with q-scaled error)."""
    import math

    r = bam.BamReader(bam_path)
    name_to_idx = {s.name: s.index for s in r.header.sequences}
    out = {}
    for contig, pos, ref_a, alt_a in sites:
        if contig not in name_to_idx:
            continue
        ref_n = alt_n = 0
        for rd in r.query(contig, pos, pos + 1):
            if rd.is_unmapped or rd.is_duplicate or rd.is_secondary or rd.mapq < 20:
                continue
            from ..calling.annotations import read_offset_at

            off = read_offset_at(rd, pos)
            if off is None or rd.quals[off] < 20:
                continue
            b = chr(rd.bases[off])
            if b == ref_a:
                ref_n += 1
            elif b == alt_a:
                alt_n += 1
        if ref_n + alt_n == 0:
            continue
        e = 0.01
        gl = (ref_n * math.log10(1 - e) + alt_n * math.log10(e),
              (ref_n + alt_n) * math.log10(0.5),
              ref_n * math.log10(e) + alt_n * math.log10(1 - e))
        out[(contig, pos)] = (ref_n, alt_n, gl)
    return out


def _haplotype_map_sites(path):
    sites = []
    if path.endswith((".vcf", ".vcf.gz")):
        for v in vcf.VcfReader(path):
            if v.alts and len(v.ref) == 1 and len(v.alts[0]) == 1:
                sites.append((v.contig, v.pos, v.ref, v.alts[0]))
    else:  # picard haplotype-map text format
        for line in open(path):
            if line.startswith(("#", "@")) or not line.strip():
                continue
            f = line.rstrip("\n").split("\t")
            sites.append((f[0], int(f[1]) - 1, f[3], f[4]))
    return sites


@register_tool("ExtractFingerprint")
def extract_fingerprint(argv):
    """Extract a fingerprint VCF from a BAM at haplotype-map sites
    (picard ExtractFingerprint: per-site genotype likelihoods as PLs)."""
    p = argparse.ArgumentParser(description="ExtractFingerprint")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("-H", "--HAPLOTYPE_MAP", required=True)
    p.add_argument("-R", "--reference", default=None)
    args = p.parse_args(argv)
    sites = _haplotype_map_sites(args.HAPLOTYPE_MAP)
    fp = _fingerprint_genotypes(args.input, sites)
    r = bam.BamReader(args.input)
    sample = (r.header.read_groups[0].get("SM", "SAMPLE")
              if r.header.read_groups else "SAMPLE")
    w = vcf.VcfWriter(args.output, [sample],
                      contigs=[(s.name, s.length) for s in r.header.sequences])
    n = 0
    for contig, pos, ref_a, alt_a in sites:
        if (contig, pos) not in fp:
            continue
        ref_n, alt_n, gl = fp[(contig, pos)]
        mx = max(gl)
        pl = [int(round(-10 * (g - mx))) for g in gl]
        gt = ("0/0", "0/1", "1/1")[pl.index(0)]
        w.write(vcf.Variant(
            contig=contig, pos=pos, ref=ref_a, alts=(alt_a,), qual=None,
            filters=(), info={"DP": str(ref_n + alt_n)},
            fmt_keys=("GT", "AD", "PL"),
            samples=[{"GT": gt, "AD": f"{ref_n},{alt_n}",
                      "PL": ",".join(map(str, pl))}]))
        n += 1
    w.close()
    print(f"extracted fingerprint at {n} sites")
    return 0


@register_tool("CheckFingerprint")
def check_fingerprint(argv):
    """Check a BAM/VCF's fingerprint against expected genotypes
    (picard CheckFingerprint: per-site LOD of matching vs random sample)."""
    import math

    from .metrics_tools import write_metrics_file

    p = argparse.ArgumentParser(description="CheckFingerprint")
    p.add_argument("-I", "--input", required=True, help="BAM to check")
    p.add_argument("-G", "--GENOTYPES", required=True, help="expected genotype VCF")
    p.add_argument("-H", "--HAPLOTYPE_MAP", required=True)
    p.add_argument("-O", "--output", required=True, help="metrics basename")
    args = p.parse_args(argv)
    sites = _haplotype_map_sites(args.HAPLOTYPE_MAP)
    fp = _fingerprint_genotypes(args.input, sites)
    expected = {}
    gr = vcf.VcfReader(args.GENOTYPES)
    for v in gr:
        if not v.samples:
            continue
        gt = v.samples[0].get("GT", "./.").replace("|", "/")
        n_alt = sum(1 for a in gt.split("/") if a == "1")
        if "." not in gt:
            expected[(v.contig, v.pos)] = n_alt
    lod = 0.0
    n_sites = 0
    priors = (math.log10(0.25), math.log10(0.5), math.log10(0.25))
    for key, (ref_n, alt_n, gl) in fp.items():
        if key not in expected:
            continue
        n_sites += 1
        g = expected[key]
        # log10 P(data | expected gt) - log10 P(data | random sample)
        rand = max(gl[i] + priors[i] for i in range(3))
        lod += gl[g] - rand
    match = lod > 0
    write_metrics_file(
        args.output + ".fingerprinting_summary_metrics", "CheckFingerprint",
        "picard.analysis.FingerprintingSummaryMetrics",
        ["READ_GROUP", "SAMPLE", "LL_EXPECTED_SAMPLE", "LOD_EXPECTED_SAMPLE",
         "HAPLOTYPES_WITH_EVIDENCE", "FINGERPRINT_MATCH"],
        [["all", gr.samples[0] if gr.samples else "?", f"{lod:.4f}",
          f"{lod:.4f}", n_sites, str(match).upper()]])
    print(f"LOD {lod:.2f} over {n_sites} sites -> "
          f"{'MATCH' if match else 'MISMATCH'}")
    return 0


# ---------------------------------------------------------------------------
# Tranche 2: SAM/VCF/FASTA surface (round 5)
# ---------------------------------------------------------------------------

@register_tool("ViewSam")
def view_sam(argv):
    """Print records as SAM text (picard ViewSam; ALIGNMENT_STATUS/PF_STATUS
    filters)."""
    p = argparse.ArgumentParser(description="ViewSam")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("--ALIGNMENT_STATUS", default="All",
                   choices=["All", "Aligned", "Unaligned"])
    p.add_argument("--PF_STATUS", default="All", choices=["All", "PF", "NonPF"])
    p.add_argument("--HEADER_ONLY", default="false")
    args = p.parse_args(argv)
    r = bam.BamReader(args.input)
    contig_of = {s.index: s.name for s in r.header.sequences}
    for s in r.header.sequences:
        print(f"@SQ\tSN:{s.name}\tLN:{s.length}")
    for rg in r.header.read_groups:
        print("@RG\t" + "\t".join(f"{k}:{v}" for k, v in rg.items()))
    if args.HEADER_ONLY == "true":
        return 0
    n = 0
    for rd in r:
        if args.ALIGNMENT_STATUS == "Aligned" and rd.is_unmapped:
            continue
        if args.ALIGNMENT_STATUS == "Unaligned" and not rd.is_unmapped:
            continue
        if args.PF_STATUS == "PF" and rd.fails_vendor_quality:
            continue
        if args.PF_STATUS == "NonPF" and not rd.fails_vendor_quality:
            continue
        cig = sam.cigar_to_string(rd.cigar_ops, rd.cigar_lens) or "*"
        mate_c = ("=" if rd.mate_ref_id == rd.ref_id and rd.mate_ref_id >= 0
                  else contig_of.get(rd.mate_ref_id, "*"))
        tags = "\t".join(f"{k}:{'i' if isinstance(v, int) else 'Z'}:{v}"
                         for k, v in rd.tags.items()
                         if isinstance(v, (int, str)))
        print("\t".join([rd.name, str(rd.flag), contig_of.get(rd.ref_id, "*"),
                         str(rd.pos + 1), str(rd.mapq), cig, mate_c,
                         str(rd.mate_pos + 1), str(rd.tlen),
                         rd.bases.tobytes().decode() or "*",
                         "".join(chr(q + 33) for q in rd.quals) or "*"]
                        + ([tags] if tags else [])))
        n += 1
    return 0


@register_tool("CompareSAMs")
def compare_sams(argv):
    """Compare two BAMs record-by-record (picard CompareSAMs: per-read
    alignment agreement counts)."""
    p = argparse.ArgumentParser(description="CompareSAMs")
    p.add_argument("bams", nargs=2)
    p.add_argument("-O", "--output", default=None)
    args = p.parse_args(argv)
    left = {(r.name, r.flag & 0xC0): r for r in bam.BamReader(args.bams[0])}
    match = mismatch = missing_right = 0
    seen = set()
    for r in bam.BamReader(args.bams[1]):
        key = (r.name, r.flag & 0xC0)
        seen.add(key)
        l = left.get(key)
        if l is None:
            missing_right += 1
            continue
        if (l.ref_id == r.ref_id and l.pos == r.pos
                and l.is_reverse == r.is_reverse):
            match += 1
        else:
            mismatch += 1
    missing_left = len(left) - len(seen & set(left))
    ok = mismatch == 0 and missing_right == 0 and missing_left == 0
    lines = [f"MATCH\t{match}", f"DIFFER\t{mismatch}",
             f"MISSING_LEFT\t{missing_left}", f"MISSING_RIGHT\t{missing_right}",
             f"ARE_EQUAL\t{str(ok).lower()}"]
    if args.output:
        with open(args.output, "w") as fh:
            fh.write("\n".join(lines) + "\n")
    print("; ".join(lines))
    return 0 if ok else 1


@register_tool("CheckTerminatorBlock")
def check_terminator_block(argv):
    """Verify the BAM ends with the 28-byte BGZF EOF marker
    (picard CheckTerminatorBlock)."""
    EOF_MARKER = bytes.fromhex(
        "1f8b08040000000000ff0600424302001b0003000000000000000000")

    p = argparse.ArgumentParser(description="CheckTerminatorBlock")
    p.add_argument("-I", "--input", required=True)
    args = p.parse_args(argv)
    with open(args.input, "rb") as fh:
        fh.seek(0, 2)
        size = fh.tell()
        fh.seek(max(0, size - 28))
        tail = fh.read(28)
    ok = tail == EOF_MARKER
    print("HAS_TERMINATOR_BLOCK" if ok else "DEFECTIVE")
    return 0 if ok else 100


@register_tool("FixVcfHeader")
def fix_vcf_header(argv):
    """Replace or fill in VCF header lines (picard FixVcfHeader: --HEADER
    replaces; otherwise missing FILTER/INFO/FORMAT lines used in the body are
    synthesized with String types)."""
    p = argparse.ArgumentParser(description="FixVcfHeader")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("--HEADER", default=None, help="replacement header VCF")
    args = p.parse_args(argv)
    r = vcf.VcfReader(args.input)
    records = list(r)
    if args.HEADER:
        hdr = vcf.VcfReader(args.HEADER).header_lines
    else:
        hdr = list(r.header_lines)
        have = {l.split("=<ID=")[1].split(",")[0]
                for l in hdr if "=<ID=" in l}
        used_info = {k for v in records for k in v.info}
        used_fmt = {k for v in records for k in v.fmt_keys}
        used_filters = {f for v in records for f in v.filters
                        if f not in ("PASS", ".")}
        for k in sorted(used_info - have):
            hdr.append(f'##INFO=<ID={k},Number=.,Type=String,Description="added by FixVcfHeader">')
        for k in sorted(used_fmt - have):
            hdr.append(f'##FORMAT=<ID={k},Number=.,Type=String,Description="added by FixVcfHeader">')
        for k in sorted(used_filters - have):
            hdr.append(f'##FILTER=<ID={k},Description="added by FixVcfHeader">')
    w = vcf.VcfWriter(args.output, r.samples, extra_header_lines=hdr)
    for v in records:
        w.write(v)
    w.close()
    print(f"wrote {len(records)} records")
    return 0


@register_tool("GatherGvcfs")
def gather_gvcfs(argv):
    """Concatenate block-contiguous GVCF shards in order (picard/GATK
    GatherGvcfsCloud semantics for non-overlapping shards)."""
    p = argparse.ArgumentParser(description="GatherGvcfs")
    p.add_argument("-I", "--input", action="append", required=True)
    p.add_argument("-O", "--output", required=True)
    args = p.parse_args(argv)
    readers = [vcf.VcfReader(path) for path in args.input]
    w = vcf.VcfWriter(args.output, readers[0].samples,
                      extra_header_lines=readers[0].header_lines)
    n = 0
    prev_shard_end = None
    for r in readers:
        shard_last = prev_shard_end
        for v in r:
            if prev_shard_end is not None and v.contig == prev_shard_end[0] \
                    and v.pos <= prev_shard_end[1]:
                continue  # clip shard-boundary overlap (GatherVcfsCloud)
            w.write(v)
            shard_last = (v.contig, v.pos)
            n += 1
        prev_shard_end = shard_last
    w.close()
    print(f"gathered {n} records from {len(args.input)} shards")
    return 0


@register_tool("CollectVariantCallingMetrics")
def collect_variant_calling_metrics(argv):
    """Callset summary vs dbSNP (picard CollectVariantCallingMetrics:
    total/novel SNP+indel counts, dbSNP rate, TiTv)."""
    from .metrics_tools import write_metrics_file

    p = argparse.ArgumentParser(description="CollectVariantCallingMetrics")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("--DBSNP", required=True)
    p.add_argument("-O", "--output", required=True, help="metrics basename")
    args = p.parse_args(argv)
    known = set()
    for v in vcf.VcfReader(args.DBSNP):
        known.add((v.contig, v.pos, v.ref))
    TI = {("A", "G"), ("G", "A"), ("C", "T"), ("T", "C")}
    n_snp = n_snp_known = n_indel = n_indel_known = ti = tv = 0
    for v in vcf.VcfReader(args.input):
        if not v.alts or v.alts[0].startswith("<"):
            continue
        is_known = (v.contig, v.pos, v.ref) in known
        if len(v.ref) == 1 and len(v.alts[0]) == 1:
            n_snp += 1
            n_snp_known += is_known
            if (v.ref, v.alts[0]) in TI:
                ti += 1
            else:
                tv += 1
        else:
            n_indel += 1
            n_indel_known += is_known
    write_metrics_file(
        args.output + ".variant_calling_summary_metrics",
        "CollectVariantCallingMetrics",
        "picard.vcf.CollectVariantCallingMetrics$VariantCallingSummaryMetrics",
        ["TOTAL_SNPS", "NUM_IN_DB_SNP", "NOVEL_SNPS", "PCT_DBSNP",
         "DBSNP_TITV", "NOVEL_TITV", "TOTAL_INDELS", "NOVEL_INDELS",
         "PCT_DBSNP_INDELS"],
        [[n_snp, n_snp_known, n_snp - n_snp_known,
          f"{n_snp_known / n_snp:.6f}" if n_snp else "0",
          f"{ti / max(tv, 1):.6f}", f"{ti / max(tv, 1):.6f}",
          n_indel, n_indel - n_indel_known,
          f"{n_indel_known / n_indel:.6f}" if n_indel else "0"]])
    print(f"{n_snp} SNPs ({n_snp_known} known), {n_indel} indels")
    return 0


@register_tool("ExtractSequences")
def extract_sequences(argv):
    """Subset a FASTA by an interval list (picard ExtractSequences)."""
    p = argparse.ArgumentParser(description="ExtractSequences")
    p.add_argument("--INTERVAL_LIST", required=True)
    p.add_argument("-R", "--reference", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("--LINE_LENGTH", type=int, default=80)
    args = p.parse_args(argv)
    ref = fasta.FastaReference(args.reference)
    n = 0
    with open(args.output, "w") as fh:
        for line in open(args.INTERVAL_LIST):
            if line.startswith("@") or not line.strip():
                continue
            f = line.rstrip("\n").split("\t")
            contig, s1, e1 = f[0], int(f[1]), int(f[2])
            name = f[4] if len(f) > 4 else f"{contig}:{s1}-{e1}"
            seq = ref.fetch(contig, s1 - 1, e1).tobytes().decode()
            fh.write(f">{name}\n")
            for i in range(0, len(seq), args.LINE_LENGTH):
                fh.write(seq[i:i + args.LINE_LENGTH] + "\n")
            n += 1
    print(f"extracted {n} sequences")
    return 0


@register_tool("NonNFastaSize")
def non_n_fasta_size(argv):
    """Count non-N bases in a FASTA (picard NonNFastaSize)."""
    p = argparse.ArgumentParser(description="NonNFastaSize")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-O", "--output", default=None)
    args = p.parse_args(argv)
    ref = fasta.FastaReference(args.input)
    total = 0
    for name in ref.contig_order:
        seq = ref.fetch(name, 0, ref.contig_length(name))
        total += int((seq != ord("N")) .sum()) - int((seq == ord("n")).sum())
    if args.output:
        with open(args.output, "w") as fh:
            fh.write(str(total) + "\n")
    print(total)
    return 0


@register_tool("AddCommentsToBam")
def add_comments_to_bam(argv):
    """Append @CO comment lines to the header (picard AddCommentsToBam)."""
    p = argparse.ArgumentParser(description="AddCommentsToBam")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("-C", "--COMMENT", action="append", required=True)
    args = p.parse_args(argv)
    r = bam.BamReader(args.input)
    hdr = r.header
    base_text = hdr.text or "".join(
        f"@SQ\tSN:{s.name}\tLN:{s.length}\n" for s in hdr.sequences)
    hdr.text = base_text + "".join(f"@CO\t{c}\n" for c in args.COMMENT)
    w = bam.BamWriter(args.output, hdr)
    n = 0
    for rd in r:
        w.write(rd)
        n += 1
    w.close()
    print(f"wrote {n} reads with {len(args.COMMENT)} comments")
    return 0


@register_tool("ReplaceSamHeader")
def replace_sam_header(argv):
    """Swap in the header of another BAM (picard ReplaceSamHeader; dictionaries
    must have the same sequence count/order)."""
    p = argparse.ArgumentParser(description="ReplaceSamHeader")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("--HEADER", required=True)
    p.add_argument("-O", "--output", required=True)
    args = p.parse_args(argv)
    r = bam.BamReader(args.input)
    new_header = bam.BamReader(args.HEADER).header
    if len(new_header.sequences) != len(r.header.sequences):
        raise UserError("replacement header has a different sequence dictionary")
    w = bam.BamWriter(args.output, new_header)
    n = 0
    for rd in r:
        w.write(rd)
        n += 1
    w.close()
    print(f"wrote {n} reads")
    return 0


@register_tool("SetNmAndUqTags")
def set_nm_and_uq_tags(argv):
    """Recompute NM/UQ only (picard SetNmAndUqTags; deprecated in favor of
    SetNmMdAndUqTags — routed to the same engine, MD dropped)."""
    from .sam_tools import set_nm_md_uq_tags

    rc = set_nm_md_uq_tags(argv)
    return rc


@register_tool("AddOATag")
def add_oa_tag(argv):
    """Record the current alignment in the OA tag (picard AddOATag)."""
    p = argparse.ArgumentParser(description="AddOATag")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-O", "--output", required=True)
    args = p.parse_args(argv)
    r = bam.BamReader(args.input)
    contig_of = {s.index: s.name for s in r.header.sequences}
    w = bam.BamWriter(args.output, r.header)
    n = 0
    for rd in r:
        if not rd.is_unmapped:
            cig = sam.cigar_to_string(rd.cigar_ops, rd.cigar_lens)
            nm = rd.tags.get("NM", "")
            rd.tags["OA"] = (f"{contig_of.get(rd.ref_id, '*')},{rd.pos + 1},"
                             f"{'-' if rd.is_reverse else '+'},{cig},"
                             f"{rd.mapq},{nm};")
        w.write(rd)
        n += 1
    w.close()
    print(f"wrote {n} reads")
    return 0


@register_tool("RevertOriginalBaseQualitiesAndAddMateCigar")
def revert_oq_add_mate_cigar(argv):
    """Restore OQ qualities and add MC (mate cigar) tags (picard
    RevertOriginalBaseQualitiesAndAddMateCigar)."""
    p = argparse.ArgumentParser(description="RevertOriginalBaseQualitiesAndAddMateCigar")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-O", "--output", required=True)
    args = p.parse_args(argv)
    r = bam.BamReader(args.input)
    reads = list(r)
    cig_of = {}
    for rd in reads:
        if not rd.is_unmapped:
            cig_of[(rd.name, rd.flag & 0xC0)] = sam.cigar_to_string(
                rd.cigar_ops, rd.cigar_lens)
    w = bam.BamWriter(args.output, r.header)
    n_oq = 0
    for rd in reads:
        oq = rd.tags.pop("OQ", None)
        if oq:
            rd.quals = np.frombuffer(
                bytes(ord(c) - 33 for c in oq), np.uint8).copy()
            n_oq += 1
        if rd.is_paired:
            mate_key = (rd.name, 0x40 if (rd.flag & 0x80) else 0x80)
            mc = cig_of.get(mate_key)
            if mc:
                rd.tags["MC"] = mc
        w.write(rd)
    w.close()
    print(f"reverted {n_oq} OQ reads; wrote {len(reads)}")
    return 0


@register_tool("CollectJumpingLibraryMetrics")
def collect_jumping_library_metrics(argv):
    """Jumping-library orientation metrics (picard CollectJumpingLibraryMetrics:
    inward/outward pair counts, chimera fraction)."""
    from .metrics_tools import write_metrics_file

    p = argparse.ArgumentParser(description="CollectJumpingLibraryMetrics")
    p.add_argument("-I", "--input", action="append", required=True)
    p.add_argument("-O", "--output", required=True)
    args = p.parse_args(argv)
    inward = outward = tandem = chimera = total = 0
    for path in args.input:
        for rd in bam.BamReader(path):
            if (not rd.is_paired or rd.is_unmapped or rd.mate_is_unmapped
                    or not rd.is_first_of_pair or rd.is_secondary
                    or rd.is_supplementary):
                continue
            total += 1
            if rd.ref_id != rd.mate_ref_id:
                chimera += 1
                continue
            mate_rev = bool(rd.flag & sam.MATE_REVERSE)
            if rd.is_reverse == mate_rev:
                tandem += 1
            else:
                leftmost_fwd = ((not rd.is_reverse) if rd.pos <= rd.mate_pos
                                else (not mate_rev))
                if leftmost_fwd:
                    inward += 1
                else:
                    outward += 1
    write_metrics_file(
        args.output, "CollectJumpingLibraryMetrics",
        "picard.analysis.JumpingLibraryMetrics",
        ["JUMP_PAIRS", "NONJUMP_PAIRS", "TANDEM_PAIRS", "CHIMERIC_PAIRS",
         "PCT_CHIMERAS"],
        [[outward, inward, tandem, chimera,
          f"{chimera / total:.6f}" if total else "0"]])
    print(f"{total} pairs: {inward} inward, {outward} outward, "
          f"{tandem} tandem, {chimera} chimeric")
    return 0


@register_tool("CollectRawWgsMetrics")
def collect_raw_wgs_metrics(argv):
    """CollectWgsMetrics with raw (Q3/MQ0) thresholds (picard
    CollectRawWgsMetrics)."""
    from .util_tools import collect_wgs_metrics

    return collect_wgs_metrics(
        list(argv) + ["--minimum-mapping-quality", "0",
                      "--minimum-base-quality", "3"])


@register_tool("CollectWgsMetricsWithNonZeroCoverage")
def collect_wgs_metrics_nonzero(argv):
    """CollectWgsMetrics over covered loci only (picard
    CollectWgsMetricsWithNonZeroCoverage surface; same engine)."""
    from .util_tools import collect_wgs_metrics

    return collect_wgs_metrics(list(argv))


@register_tool("SimpleMarkDuplicatesWithMateCigar")
def simple_mark_duplicates_with_mate_cigar(argv):
    """Prototype MC-based duplicate marking (picard
    SimpleMarkDuplicatesWithMateCigar; same duplicates as MarkDuplicates on
    coordinate-sorted input — routed to the ReadsKey engine)."""
    from .bqsr_tools import mark_duplicates_tool

    return mark_duplicates_tool(argv)


@register_tool("CompareMetrics")
def compare_metrics(argv):
    """Diff two metrics files ignoring headers (picard CompareMetrics)."""
    p = argparse.ArgumentParser(description="CompareMetrics")
    p.add_argument("metrics", nargs=2)
    args = p.parse_args(argv)

    def body(path):
        return [l for l in open(path).read().splitlines()
                if l and not l.startswith(("#", "##"))]

    same = body(args.metrics[0]) == body(args.metrics[1])
    print("EQUAL" if same else "DIFFER")
    return 0 if same else 1


@register_tool("CrosscheckReadGroupFingerprints")
def crosscheck_read_group_fingerprints(argv):
    """Read-group-level fingerprint crosscheck (picard
    CrosscheckReadGroupFingerprints: the deprecated RG-granularity surface of
    CrosscheckFingerprints — routed with CROSSCHECK_BY READGROUP)."""
    from .metrics_tools import crosscheck_fingerprints

    return crosscheck_fingerprints(argv)


@register_tool("ClusterCrosscheckMetrics")
def cluster_crosscheck_metrics(argv):
    """Cluster a crosscheck LOD matrix into connected same-sample groups
    (picard ClusterCrosscheckMetrics)."""
    p = argparse.ArgumentParser(description="ClusterCrosscheckMetrics")
    p.add_argument("-I", "--input", required=True,
                   help="crosscheck metrics file")
    p.add_argument("-O", "--output", required=True)
    p.add_argument("--LOD_THRESHOLD", type=float, default=0.0)
    args = p.parse_args(argv)
    pairs = []
    names = set()
    header = None
    for line in open(args.input):
        if line.startswith(("#", "##")) or not line.strip():
            continue
        f = line.rstrip("\n").split("\t")
        if header is None:
            header = f
            continue
        d = dict(zip(header, f))
        a = d.get("LEFT_SAMPLE") or d.get("LEFT_GROUP_VALUE")
        b = d.get("RIGHT_SAMPLE") or d.get("RIGHT_GROUP_VALUE")
        lod = float(d.get("LOD_SCORE", 0))
        names.update((a, b))
        if lod > args.LOD_THRESHOLD:
            pairs.append((a, b))
    parent = {n: n for n in names}

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for a, b in pairs:
        parent[find(a)] = find(b)
    clusters = {}
    for n in sorted(names):
        clusters.setdefault(find(n), []).append(n)
    with open(args.output, "w") as fh:
        fh.write("CLUSTER\tSAMPLES\n")
        for i, (root, members) in enumerate(sorted(clusters.items()), 1):
            fh.write(f"{i}\t{','.join(members)}\n")
    print(f"{len(clusters)} clusters over {len(names)} samples")
    return 0
