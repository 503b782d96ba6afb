# Copied verbatim from gatk_tpu/tools/rnaseq_tools.py; only import lines may differ.
"""RNA-seq tools: SplitNCigarReads + ASEReadCounter.

Reference behavior: tools/walkers/rnaseq/SplitNCigarReads.java (splitNCigarRead
:208-272, splitReadBasedOnCigar :283-314 via softClipToRegionIncludingClippedBases,
repairSupplementaryTags :321-334 -> SA tags, NDN refactoring via
readtransformers NDNCigarReadTransformer, 255->60 MQ transform),
OverhangFixingManager.java (fixSplit :242-273, overhangingBasesMismatch
:309-332, splice tracking :146-186), tools/walkers/rnaseq/ASEReadCounter.java.
"""
from __future__ import annotations

import argparse

import numpy as np

from ..cli import UserError, register_tool
from ..engine import walkers
from ..io import sam
from ..io.reads import Read

CIGAR_CHARS = "MIDNSHP=X"
_READ_CONSUMING = {sam.OP_M, sam.OP_I, sam.OP_S, sam.OP_EQ, sam.OP_X}
_REF_CONSUMING = {sam.OP_M, sam.OP_D, sam.OP_N, sam.OP_EQ, sam.OP_X}


def cigar_str(read: Read) -> str:
    return "".join(f"{int(l)}{CIGAR_CHARS[int(o)]}"
                   for o, l in zip(read.cigar_ops, read.cigar_lens))


def refactor_ndn(ops, lens):
    """NDNCigarReadTransformer: collapse N-D-N runs into a single N."""
    ops = list(int(o) for o in ops)
    lens = list(int(l) for l in lens)
    out_o, out_l = [], []
    i = 0
    while i < len(ops):
        if (ops[i] == sam.OP_N and i + 2 < len(ops) and ops[i + 1] == sam.OP_D
                and ops[i + 2] == sam.OP_N):
            total = lens[i] + lens[i + 1] + lens[i + 2]
            i += 3
            # keep absorbing further D/N extensions (e.g. N D N D N)
            while i + 1 < len(ops) and ops[i] == sam.OP_D and ops[i + 1] == sam.OP_N:
                total += lens[i] + lens[i + 1]
                i += 2
            out_o.append(sam.OP_N)
            out_l.append(total)
        else:
            out_o.append(ops[i])
            out_l.append(lens[i])
            i += 1
    return np.array(out_o, np.uint8), np.array(out_l, np.int32)


def _count_ref_and_clips(ops, lens, start, stop):
    """CigarUtils.countRefBasesAndClips over element range [start, stop)."""
    total = 0
    for k in range(start, stop):
        op = int(ops[k])
        if op in _REF_CONSUMING or op in (sam.OP_S, sam.OP_H):
            total += int(lens[k])
    return total


def _soft_clip_section(read: Read, first: int, second: int, new_pos: int) -> Read:
    """Keep cigar elements [first, second) aligned; soft-clip the rest
    (ReadClipper.softClipToRegionIncludingClippedBases equivalent for sections)."""
    ops, lens = read.cigar_ops, read.cigar_lens
    lead_h = []
    k0 = 0
    while k0 < first and int(ops[k0]) == sam.OP_H:
        lead_h.append((sam.OP_H, int(lens[k0])))
        k0 += 1
    tail_h = []
    k1 = len(ops)
    while k1 > second and int(ops[k1 - 1]) == sam.OP_H:
        tail_h.insert(0, (sam.OP_H, int(lens[k1 - 1])))
        k1 -= 1
    lead_s = sum(int(lens[k]) for k in range(k0, first) if int(ops[k]) in _READ_CONSUMING)
    tail_s = sum(int(lens[k]) for k in range(second, k1) if int(ops[k]) in _READ_CONSUMING)

    new_ops, new_lens = [], []
    for o, ln in lead_h:
        new_ops.append(o)
        new_lens.append(ln)
    if lead_s:
        new_ops.append(sam.OP_S)
        new_lens.append(lead_s)
    for k in range(first, second):
        new_ops.append(int(ops[k]))
        new_lens.append(int(lens[k]))
    if tail_s:
        new_ops.append(sam.OP_S)
        new_lens.append(tail_s)
    for o, ln in tail_h:
        new_ops.append(o)
        new_lens.append(ln)

    out = read.copy()
    out.pos = new_pos
    out.cigar_ops = np.array(new_ops, np.uint8)
    out.cigar_lens = np.array(new_lens, np.int32)
    return out


def soft_clip_by_read_coords(read: Read, start: int, stop: int) -> Read:
    """Soft-clip read-coordinate range [start, stop] (ReadClipper.softClipByReadCoordinates)."""
    # expand cigar per read base
    per_base = []
    for o, ln in zip(read.cigar_ops, read.cigar_lens):
        o = int(o)
        if o in _READ_CONSUMING:
            per_base.extend([o] * int(ln))
    n = len(per_base)
    clip = np.zeros(n, bool)
    clip[start:stop + 1] = True
    # walk original cigar, emitting S for clipped read bases
    read_i = 0
    pending = []  # (op, len) output
    for o, ln in zip(read.cigar_ops, read.cigar_lens):
        o = int(o)
        ln = int(ln)
        if o == sam.OP_H:
            pending.append((o, ln))
        elif o in _READ_CONSUMING:
            j = 0
            while j < ln:
                c = clip[read_i + j]
                j2 = j
                while j2 < ln and clip[read_i + j2] == c:
                    j2 += 1
                pending.append((sam.OP_S if c else o, j2 - j))
                j = j2
            read_i += ln
        else:  # D or N: kept unless later found adjacent to a clip
            pending.append((o, ln))
    # recompute pos: ref advance for clipped leading M/=/X bases (plus interior D/N)
    adv = 0
    read_i = 0
    for o, ln in zip(read.cigar_ops, read.cigar_lens):
        o = int(o)
        ln = int(ln)
        if o in (sam.OP_M, sam.OP_EQ, sam.OP_X):
            k = 0
            while k < ln and clip[read_i + k]:
                adv += 1
                k += 1
            if k < ln:
                break
            read_i += ln
        elif o in (sam.OP_I, sam.OP_S):
            k = 0
            while k < ln and clip[read_i + k]:
                k += 1
            if k < ln:
                break
            read_i += ln
        elif o in (sam.OP_D, sam.OP_N):
            if read_i > 0 or adv > 0:
                adv += ln
        elif o == sam.OP_H:
            continue
        if o in _READ_CONSUMING and read_i >= n:
            break
    new_pos = read.pos + adv
    # merge adjacent same ops; drop D/N adjacent to S
    merged = []
    for o, ln in pending:
        if ln == 0:
            continue
        if merged and merged[-1][0] == o:
            merged[-1][1] += ln
        else:
            merged.append([o, ln])
    # remove D/N that touch S or the read ends
    changed = True
    while changed:
        changed = False
        for i, (o, ln) in enumerate(merged):
            if o in (sam.OP_D, sam.OP_N):
                left = merged[i - 1][0] if i > 0 else None
                right = merged[i + 1][0] if i < len(merged) - 1 else None
                if left in (sam.OP_S, sam.OP_H, None) or right in (sam.OP_S, sam.OP_H, None):
                    del merged[i]
                    changed = True
                    break
    out = read.copy()
    out.pos = new_pos
    out.cigar_ops = np.array([o for o, _ in merged], np.uint8)
    out.cigar_lens = np.array([l for _, l in merged], np.int32)
    return out


class Splice:
    __slots__ = ("contig", "start", "end", "reference")

    def __init__(self, contig, start, end):
        self.contig = contig
        self.start = start  # 0-based inclusive
        self.end = end      # 0-based inclusive
        self.reference = None


class SplitNCigarEngine:
    """Splits N-containing reads and soft-clips mismatching exon overhangs."""

    def __init__(self, reference=None, fix_ndn=False, skip_mq_transform=False,
                 max_mismatches_in_overhang=1, max_bases_in_overhang=40,
                 do_not_fix_overhangs=False, process_secondary=False):
        self.ref = reference
        self.fix_ndn = fix_ndn
        self.skip_mq_transform = skip_mq_transform
        self.max_mismatches = max_mismatches_in_overhang
        self.max_overhang = max_bases_in_overhang
        self.do_not_fix = do_not_fix_overhangs or reference is None
        self.process_secondary = process_secondary
        self.splices = {}  # (contig, start, end) -> Splice
        self.families = []  # list of [Read]

    # ---------------- read processing ----------------
    def _transform(self, read: Read):
        if not self.skip_mq_transform and read.mapq == 255:
            read.mapq = 60
        if self.fix_ndn:
            read.cigar_ops, read.cigar_lens = refactor_ndn(read.cigar_ops, read.cigar_lens)
        return read

    def process_read(self, read: Read, contig: str):
        read = self._transform(read.copy())
        if not self.process_secondary and read.is_secondary:
            self.families.append([read])
            return
        sections = self._sections(read)
        if sections is None:
            self.families.append([read])
            return
        splits = []
        ops, lens = read.cigar_ops, read.cigar_lens
        for (first, second, end_idx) in sections:
            start_ref = read.unclipped_start() + _count_ref_and_clips(ops, lens, 0, first)
            splits.append(_soft_clip_section(read, first, second, start_ref))
            if end_idx is not None and not self.do_not_fix:
                split_start = start_ref + _count_ref_and_clips(ops, lens, first, end_idx)
                split_end = split_start + int(lens[end_idx]) - 1
                self._add_splice(contig, split_start, split_end)
        self.families.append(splits)

    def _sections(self, read: Read):
        """[(firstIdx, secondIdx, nElementIdx|None)] per consecutive non-N section,
        or None if the read has no N."""
        ops = [int(o) for o in read.cigar_ops]
        lens = read.cigar_lens
        if sam.OP_N not in ops:
            return None
        sections = []
        has_match = False
        first = 0
        for i, op in enumerate(ops):
            if op in (sam.OP_M, sam.OP_EQ, sam.OP_X, sam.OP_I, sam.OP_D):
                has_match = True
            if op == sam.OP_N:
                if has_match:
                    sections.append((first, i, i))
                first = i + 1
                has_match = False
        if first < len(ops) and has_match:
            sections.append((first, len(ops), None))
        if not sections:
            return None
        # trim leading/trailing D within each section
        out = []
        for (f, s, n_idx) in sections:
            while int(read.cigar_ops[f]) == sam.OP_D:
                f += 1
            while int(read.cigar_ops[s - 1]) == sam.OP_D:
                s -= 1
            out.append((f, s, n_idx))
        return out

    # ---------------- splices + overhang fixing ----------------
    def _add_splice(self, contig, start, end):
        key = (contig, start, end)
        if key in self.splices:
            return
        sp = Splice(contig, start, end)
        if self.ref is not None:
            sp.reference = self.ref.fetch(contig, start, end + 1)
        self.splices[key] = sp

    def _fix_family(self, family):
        if self.do_not_fix:
            return family
        out = []
        for read in family:
            if read.is_unmapped or (not self.process_secondary and read.is_secondary):
                out.append(read)
                continue
            for sp in self.splices.values():
                read = self._fix_split(read, sp) or read
            out.append(read)
        return out

    def _fix_split(self, read: Read, splice: Splice):
        u_start = read.unclipped_start()
        u_end = read.unclipped_end()
        if u_end < splice.start or u_start > splice.end:
            return None
        read_bases_len = sum(int(l) for o, l in zip(read.cigar_ops, read.cigar_lens)
                             if int(o) in (sam.OP_M, sam.OP_I, sam.OP_EQ, sam.OP_X))
        if u_start <= splice.end and u_start > splice.start and u_end > splice.end:
            # left overhang: read begins inside the intron
            overhang = splice.end - read.pos + 1
            if self._mismatch(read.bases, read.pos - u_start, read_bases_len,
                              splice.reference, len(splice.reference) - overhang, overhang):
                return soft_clip_by_read_coords(read, 0, splice.end - u_start)
        elif u_end >= splice.start and u_end < splice.end and u_start < splice.start:
            overhang = u_end - splice.start + 1
            span = read.end - splice.start
            if self._mismatch(read.bases, len(read.bases) - overhang, read_bases_len,
                              splice.reference, 0, span):
                return soft_clip_by_read_coords(read, len(read.bases) - overhang,
                                                len(read.bases) - 1)
        return None

    def _mismatch(self, bases, read_start, read_len, reference, ref_start, span):
        if reference is None or span < 1 or span > self.max_overhang or span > read_len // 2:
            return False
        n = 0
        for i in range(span):
            if read_start + i >= len(bases) or ref_start + i >= len(reference):
                break
            if bases[read_start + i] != reference[ref_start + i]:
                n += 1
                if n > self.max_mismatches:
                    return True
        return n >= (span + 1) // 2


def _repair_tags(family):
    """Remove tags invalidated by splitting (SplitNCigarReads.TAGS_TO_REMOVE);
    SA/supplementary marking happens in the tool once positions are final."""
    for r in family:
        for tag in ("NM", "MD", "NH"):
            r.tags.pop(tag, None)
    return family


@register_tool("SplitNCigarReads")
def split_n_cigar_reads(argv):
    """Split reads with N in their cigar (spanning splice junctions) into exon segments."""
    p = argparse.ArgumentParser(description="SplitNCigarReads")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-R", "--reference", default=None)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("-L", "--intervals", action="append", default=None)
    p.add_argument("-fixNDN", "--refactor-cigar-string", action="store_true")
    p.add_argument("--skip-mapping-quality-transform", "-skip-mq-transform",
                   action="store_true")
    p.add_argument("--max-mismatches-in-overhang", type=int, default=1)
    p.add_argument("--max-bases-in-overhang", type=int, default=40)
    p.add_argument("--do-not-fix-overhangs", action="store_true")
    p.add_argument("--process-secondary-alignments", action="store_true")
    args = p.parse_args(argv)
    w = _SplitNCigarWalker(reads_path=args.input, reference_path=args.reference,
                           intervals=args.intervals)
    w.args = args
    w.run()
    return 0


class _SplitNCigarWalker(walkers.ReadWalker):
    """SplitNCigarReads as a ReadWalker (tools/walkers/rnaseq/
    SplitNCigarReads.java extends ReadWalker)."""

    tool_name = "SplitNCigarReads"
    default_read_filters = ()

    def on_traversal_start(self):
        args = self.args
        self.names = [s.name for s in self.reads.header.sequences]
        self.eng = SplitNCigarEngine(
            reference=self.reference, fix_ndn=args.refactor_cigar_string,
            skip_mq_transform=args.skip_mapping_quality_transform,
            max_mismatches_in_overhang=args.max_mismatches_in_overhang,
            max_bases_in_overhang=args.max_bases_in_overhang,
            do_not_fix_overhangs=args.do_not_fix_overhangs,
            process_secondary=args.process_secondary_alignments)

    def apply(self, read, ref_context):
        if read.is_unmapped:
            self.eng.families.append([read])
            return
        self.eng.process_read(read, self.names[read.ref_id])

    def on_traversal_success(self):
        from ..io import bam as bamio

        args = self.args
        eng = self.eng
        names = self.names
        out_reads = []
        for family in eng.families:
            family = eng._fix_family(family)
            _repair_tags(family)
            if len(family) > 1:
                contig = names[family[0].ref_id]
                entries = [f"{contig},{r.pos + 1},{'-' if r.is_reverse else '+'},"
                           f"{cigar_str(r)},{r.mapq},{r.tags.get('NM', '*')};"
                           for r in family]
                for i, r in enumerate(family):
                    if i > 0:
                        r.flag |= sam.SUPPLEMENTARY
                    others = [entries[j] for j in ([0] if i else []) +
                              [j for j in range(1, len(family)) if j != i]]
                    r.tags["SA"] = "".join(others)
            out_reads.extend(family)

        out_reads.sort(key=lambda r: (r.ref_id if r.ref_id >= 0 else 1 << 30, r.pos))
        w = bamio.BamWriter(args.output, self.reads.header)
        for r in out_reads:
            w.write(r)
        w.close()
        print(f"wrote {len(out_reads)} reads to {args.output}")


@register_tool("ASEReadCounter")
def ase_read_counter(argv):
    """Allele-specific expression read counts at het sites (ASEReadCounter.java)."""
    from ..engine import pileup as pileup_mod
    from ..io import bam as bamio, vcf as vcfio

    p = argparse.ArgumentParser(description="ASEReadCounter")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-V", "--variant", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("-R", "--reference", default=None)
    p.add_argument("--min-mapping-quality", type=int, default=0)
    p.add_argument("--min-base-quality", type=int, default=0)
    p.add_argument("--min-depth", "-min-depth", type=int, default=-1)
    args = p.parse_args(argv)

    reader = bamio.BamReader(args.input)
    rows = []
    for v in vcfio.VcfReader(args.variant):
        if not v.is_snp() or len(v.alts) != 1 or not v.samples:
            continue
        gt = v.samples[0].get("GT", ".").replace("|", "/")
        if sorted(gt.split("/")) != ["0", "1"]:
            continue
        ref_b, alt_b = ord(v.ref), ord(v.alts[0])
        refs = alts = others = low_mapq = low_bq = raw = improper = 0
        for r in reader.query(v.contig, v.pos, v.pos + 1):
            if r.is_unmapped or r.is_duplicate or r.is_secondary:
                continue
            raw += 1
            if r.mapq < args.min_mapping_quality:
                low_mapq += 1
                continue
            pos_arr, base, qual, flags = pileup_mod.expand_read(r)
            here = pos_arr == v.pos
            if not here.any():
                continue
            i = int(np.nonzero(here)[0][0])
            if flags[i] & pileup_mod.F_DELETION:
                continue
            if qual[i] < args.min_base_quality:
                low_bq += 1
                continue
            b = int(base[i])
            if b == ref_b:
                refs += 1
            elif b == alt_b:
                alts += 1
            else:
                others += 1
        total = refs + alts
        if args.min_depth > 0 and total < args.min_depth:
            continue
        rows.append((v.contig, v.pos + 1, v.id or ".", v.ref, v.alts[0],
                     refs, alts, total, low_mapq, low_bq, raw, others, improper))

    with open(args.output, "w") as fh:
        fh.write("contig\tposition\tvariantID\trefAllele\taltAllele\trefCount\taltCount\t"
                 "totalCount\tlowMAPQDepth\tlowBaseQDepth\trawDepth\totherBases\timproperPairs\n")
        for r in rows:
            fh.write("\t".join(str(x) for x in r) + "\n")
    print(f"wrote {len(rows)} sites to {args.output}")
    return 0


@register_tool("GeneExpressionEvaluation")
def gene_expression_evaluation(argv):
    """Fragment-based gene expression from RNA-seq alignments + GFF3
    (walkers/rnaseq/GeneExpressionEvaluation.java): count each fragment toward
    the grouping features its alignment blocks overlap (EQUAL or PROPORTIONAL
    multi-overlap weighting), split sense/antisense by transcription strand;
    TSV columns gene_label/contig/start/stop/strand/sense_antisense/counts."""
    p = argparse.ArgumentParser(description="GeneExpressionEvaluation")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-G", "--gff-file", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("--grouping-type", action="append", default=None)
    p.add_argument("--overlap-type", action="append", default=None)
    p.add_argument("--feature-label-key", choices=["NAME", "ID"], default="NAME")
    p.add_argument("--multi-overlap-method", choices=["EQUAL", "PROPORTIONAL"],
                   default="PROPORTIONAL")
    p.add_argument("--read-strands", choices=["FORWARD_REVERSE", "REVERSE_FORWARD",
                                              "FORWARD_FORWARD"],
                   default="FORWARD_REVERSE")
    p.add_argument("--minimum-mapping-quality", type=int, default=60)
    args = p.parse_args(argv)
    grouping = set(args.grouping_type or ["gene"])
    overlap = set(args.overlap_type or ["exon"])
    label_key = "Name" if args.feature_label_key == "NAME" else "ID"

    # GFF3 parse: grouping features + their overlap-type descendants
    import gzip as _gzip
    groups = {}  # feature id -> dict(contig,start,end,strand,label)
    child_to_group = {}
    exon_intervals = []  # (contig, start, end, group_id)
    op = _gzip.open if args.gff_file.endswith(".gz") else open
    rows = []
    with op(args.gff_file, "rt") as fh:
        for line in fh:
            if line.startswith("#") or not line.strip():
                continue
            f = line.rstrip("\n").split("\t")
            if len(f) < 9:
                continue
            attrs = dict(kv.split("=", 1) for kv in f[8].split(";") if "=" in kv)
            rows.append((f[0], f[2], int(f[3]) - 1, int(f[4]), f[6], attrs))
    for contig, ftype, start, end, strand, attrs in rows:
        if ftype in grouping:
            fid = attrs.get("ID", attrs.get(label_key, f"{contig}:{start}"))
            groups[fid] = dict(contig=contig, start=start, end=end, strand=strand,
                               label=attrs.get(label_key, attrs.get("ID", fid)))
    # resolve Parent chains to grouping features
    parent_of = {}
    for contig, ftype, start, end, strand, attrs in rows:
        if "ID" in attrs and "Parent" in attrs:
            parent_of[attrs["ID"]] = attrs["Parent"].split(",")[0]

    def group_of(attrs):
        cur = attrs.get("Parent", "").split(",")[0]
        seen = set()
        while cur and cur not in seen:
            if cur in groups:
                return cur
            seen.add(cur)
            cur = parent_of.get(cur, "")
        return None

    for contig, ftype, start, end, strand, attrs in rows:
        if ftype in overlap:
            gid = group_of(attrs) or (attrs.get("ID") if attrs.get("ID") in groups else None)
            if gid:
                exon_intervals.append((contig, start, end, gid))
    # if no overlap-type children found, fall back to the grouping spans
    if not exon_intervals:
        exon_intervals = [(g["contig"], g["start"], g["end"], fid)
                          for fid, g in groups.items()]
    by_contig = {}
    for contig, start, end, gid in exon_intervals:
        by_contig.setdefault(contig, []).append((start, end, gid))

    from ..io import fasta as _fasta
    from ..io.cram import open_reads
    reads_src = open_reads(args.input)
    counts = {fid: [0.0, 0.0] for fid in groups}  # [sense, antisense]
    seen_frags = set()
    for r in reads_src:
        if (r.is_unmapped or r.is_duplicate or r.mapq < args.minimum_mapping_quality
                or (r.flag & 0x100) or (r.flag & 0x800)):
            continue
        if r.is_paired and (r.flag & 0x80) and not r.mate_is_unmapped:
            continue  # count fragments once, at read 1 (second-of-pair skipped)
        if r.name in seen_frags:
            continue
        seen_frags.add(r.name)
        # alignment blocks (M/=/X stretches)
        blocks = []
        rp = r.pos
        for op_, ln in zip(r.cigar_ops, r.cigar_lens):
            ln = int(ln)
            if op_ in (0, 7, 8):
                blocks.append((rp, rp + ln))
                rp += ln
            elif op_ in (2, 3):
                rp += ln
        ivs = by_contig.get(reads_src.header.sequences[r.ref_id].name, [])
        hit_bases = {}
        total_bases = sum(e - s for s, e in blocks)
        for bs, be in blocks:
            for s, e, gid in ivs:
                o = min(be, e) - max(bs, s)
                if o > 0:
                    hit_bases[gid] = hit_bases.get(gid, 0) + o
        if not hit_bases:
            continue
        if args.multi_overlap_method == "EQUAL":
            weights = {gid: 1.0 / len(hit_bases) for gid in hit_bases}
        else:
            # PROPORTIONAL (GeneExpressionEvaluation.MultiOverlapMethod): weight
            # by overlapped bases; uncovered bases dilute the normalization
            weights = {gid: b / total_bases for gid, b in hit_bases.items()}
            extra = 1.0 - min(1.0, sum(hit_bases.values()) / total_bases)
            z = sum(weights.values()) + extra
            weights = {gid: w / z for gid, w in weights.items()}
        # fragment transcription strand: R1 forward => forward fragment
        # (FORWARD_REVERSE protocol); flip for REVERSE_FORWARD
        frag_reverse = r.is_reverse
        if args.read_strands == "REVERSE_FORWARD":
            frag_reverse = not frag_reverse
        for gid, wgt in weights.items():
            sense = (groups[gid]["strand"] == "-") == frag_reverse
            counts[gid][0 if sense else 1] += wgt
    sample = "sample"
    if reads_src.header.read_groups:
        sample = reads_src.header.read_groups[0].get("SM", "sample")
    with open(args.output, "w") as out:
        out.write("gene_label\tcontig\tstart\tstop\tstrand\tsense_antisense\t"
                  f"{sample}_counts\n")
        for fid, g in groups.items():
            s, a = counts[fid]
            out.write(f"{g['label']}\t{g['contig']}\t{g['start'] + 1}\t{g['end']}\t"
                      f"{g['strand']}\tsense\t{s:.2f}\n")
            if g["strand"] in ("+", "-"):
                out.write(f"{g['label']}\t{g['contig']}\t{g['start'] + 1}\t{g['end']}\t"
                          f"{g['strand']}\tantisense\t{a:.2f}\n")
    print(f"wrote expression for {len(groups)} features to {args.output}")
    return 0
