# Copied verbatim from gatk_tpu/tools/sam_tools.py; only import lines may differ.
"""Read-level utility tools (the Picard/GATK read-tools surface: MergeSamFiles,
RevertSam, ValidateSamFile, BuildBamIndex, FixMateInformation, SetNmMdAndUqTags,
ClipReads, DownsampleSam, SplitReads, ...).

Reference behavior: picard/sam/* (wrapped by GATK Main.java:109) and
tools/{ClipReads,SplitReads,DownsampleSam,GetSampleName}.java.
"""
from __future__ import annotations

import argparse
import struct

import numpy as np

from ..cli import register_tool
from ..engine import walkers
from ..io import bam, bgzf, sam


def _open_readers(paths):
    return [bam.BamReader(p) for p in paths]


@register_tool("MergeSamFiles")
def merge_sam_files(argv):
    """K-way merge of coordinate-sorted BAMs (picard MergeSamFiles)."""
    import heapq

    p = argparse.ArgumentParser(description="MergeSamFiles")
    p.add_argument("-I", "--input", action="append", required=True)
    p.add_argument("-O", "--output", required=True)
    args = p.parse_args(argv)
    readers = _open_readers(args.input)
    header = readers[0].header
    # merge read groups from all inputs
    seen_rg = {rg.get("ID") for rg in header.read_groups}
    for r in readers[1:]:
        for rg in r.header.read_groups:
            if rg.get("ID") not in seen_rg:
                header.read_groups.append(rg)
                seen_rg.add(rg.get("ID"))
    w = bam.BamWriter(args.output, header)
    n = 0
    streams = [iter(r) for r in readers]
    heap = []
    for i, s in enumerate(streams):
        rd = next(s, None)
        if rd is not None:
            heap.append((rd.ref_id & 0xFFFFFFFF, rd.pos, i, rd))
    heapq.heapify(heap)
    while heap:
        _, _, i, rd = heapq.heappop(heap)
        w.write(rd)
        n += 1
        nxt = next(streams[i], None)
        if nxt is not None:
            heapq.heappush(heap, (nxt.ref_id & 0xFFFFFFFF, nxt.pos, i, nxt))
    w.close()
    print(f"wrote {n} reads to {args.output}")
    return 0


@register_tool("RevertSam")
def revert_sam(argv):
    """Strip alignment information, restoring a pre-alignment state (picard
    RevertSam: restore OQ, clear flags/cigar/mapq, drop alignment tags)."""
    p = argparse.ArgumentParser(description="RevertSam")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("--remove-alignment-information", default="true")
    p.add_argument("--restore-original-qualities", default="true")
    p.add_argument("--attributes-to-clear", action="append",
                   default=["NM", "UQ", "PG", "MD", "MQ", "SA", "MC", "AS"])
    args = p.parse_args(argv)
    reader = bam.BamReader(args.input)
    remove_aln = args.remove_alignment_information == "true"
    header = reader.header
    if remove_aln:
        header.sort_order = "queryname"
    w = bam.BamWriter(args.output, header)
    reads = list(reader)
    if remove_aln:
        reads.sort(key=lambda r: r.name)
    n = 0
    for r in reads:
        if args.restore_original_qualities == "true" and r.tags and "OQ" in r.tags:
            oq = r.tags.pop("OQ")
            r.quals = np.frombuffer(oq.encode(), np.uint8).astype(np.int32) - 33
            r.quals = r.quals.astype(np.uint8)
        for t in args.attributes_to_clear:
            if r.tags:
                r.tags.pop(t, None)
        if remove_aln:
            if r.is_reverse:
                comp = np.arange(256, dtype=np.uint8)
                for a, b in zip(b"ACGTacgt", b"TGCAtgca"):
                    comp[a] = b
                r.bases = comp[r.bases[::-1]]
                r.quals = r.quals[::-1].copy()
            # keep paired/first/second flags only
            r.flag = r.flag & (sam.PAIRED | 0x40 | 0x80) | sam.UNMAPPED | (
                sam.MATE_UNMAPPED if r.is_paired else 0)
            r.ref_id = -1
            r.pos = -1
            r.mapq = 0
            r.cigar_ops = np.zeros(0, np.uint8)
            r.cigar_lens = np.zeros(0, np.int32)
            r.mate_ref_id = -1
            r.mate_pos = -1
            r.tlen = 0
        w.write(r)
        n += 1
    w.close()
    print(f"reverted {n} reads")
    return 0


@register_tool("ValidateSamFile")
def validate_sam_file(argv):
    """Validate record-level invariants (picard ValidateSamFile SUMMARY mode):
    cigar length vs sequence, qual length, ref bounds, mate consistency,
    coordinate sort order, flag sanity."""
    p = argparse.ArgumentParser(description="ValidateSamFile")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-M", "--mode", choices=["SUMMARY", "VERBOSE"], default="SUMMARY")
    p.add_argument("--max-output", type=int, default=100)
    args = p.parse_args(argv)
    reader = bam.BamReader(args.input)
    n_refs = len(reader.header.sequences)
    lengths = [s.length for s in reader.header.sequences]
    errors: dict[str, int] = {}
    details = []
    mates: dict[str, object] = {}

    def err(kind, read, msg):
        errors[kind] = errors.get(kind, 0) + 1
        if len(details) < args.max_output:
            details.append(f"ERROR: Read name {read.name}, {msg}")

    last = (-1, -1)
    coord_sorted = reader.header.sort_order == "coordinate"
    n = 0
    for r in reader:
        n += 1
        if not r.is_unmapped:
            if r.ref_id < 0 or r.ref_id >= n_refs:
                err("INVALID_REFERENCE_INDEX", r, f"reference index {r.ref_id} out of range")
            else:
                span = sam.cigar_ref_length(r.cigar_ops, r.cigar_lens)
                if r.pos + span > lengths[r.ref_id]:
                    err("CIGAR_MAPS_OFF_REFERENCE", r, "alignment extends past end of contig")
            if len(r.cigar_ops) and sam.cigar_read_length(r.cigar_ops, r.cigar_lens) != len(r.bases):
                err("INVALID_CIGAR", r, "CIGAR read length does not match sequence length")
            if coord_sorted:
                key = (r.ref_id & 0xFFFFFFFF, r.pos)
                if key < last:
                    err("RECORD_OUT_OF_ORDER", r, "record out of coordinate order")
                last = key
        if len(r.quals) != len(r.bases):
            err("MISMATCH_READ_LENGTH_AND_QUALS_LENGTH", r, "quals length != read length")
        if r.is_paired:
            other = mates.pop(r.name, None)
            if other is not None:
                if (other.mate_ref_id != r.ref_id or other.mate_pos != r.pos) and not r.is_unmapped:
                    err("MISMATCH_MATE_ALIGNMENT_START", r, "mate alignment start mismatch")
            else:
                mates[r.name] = r
        elif r.flag & (0x40 | 0x80):
            err("INVALID_FLAG_FIRST_OF_PAIR", r, "first/second-of-pair flag on unpaired read")
    if not errors:
        print("No errors found")
        return 0
    if args.mode == "VERBOSE":
        for d in details:
            print(d)
    print("## HISTOGRAM\tjava.lang.String")
    print("Error Type\tCount")
    for kind in sorted(errors):
        print(f"ERROR:{kind}\t{errors[kind]}")
    return 2  # picard exit code on validation failure


def _bgzf_block_table(path):
    """[(compressed_offset, uncompressed_start)] per BGZF block, from the BSIZE
    extra field and the ISIZE trailer (SAM spec 4.1) — no payload decompression."""
    table = []
    u = 0
    with open(path, "rb") as fh:
        data = fh.read()
    off = 0
    while off < len(data):
        if data[off : off + 2] != b"\x1f\x8b":
            raise ValueError("not a BGZF stream")
        xlen = struct.unpack_from("<H", data, off + 10)[0]
        extra = data[off + 12 : off + 12 + xlen]
        bsize = None
        e = 0
        while e < len(extra):
            si1, si2, slen = extra[e], extra[e + 1], struct.unpack_from("<H", extra, e + 2)[0]
            if si1 == 66 and si2 == 67:
                bsize = struct.unpack_from("<H", extra, e + 4)[0] + 1
            e += 4 + slen
        isize = struct.unpack_from("<I", data, off + bsize - 4)[0]
        table.append((off, u))
        u += isize
        off += bsize
    return table


@register_tool("BuildBamIndex")
def build_bam_index(argv):
    """Write a .bai (binning + linear index) for a coordinate-sorted BAM
    (picard BuildBamIndex; SAM spec section 5.2). Closes the index-writing gap:
    the same binning scheme our BaiIndex reader queries."""
    p = argparse.ArgumentParser(description="BuildBamIndex")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-O", "--output", default=None)
    args = p.parse_args(argv)
    out_path = args.output or args.input + ".bai"

    blocks = _bgzf_block_table(args.input)
    block_c = [c for c, _ in blocks]
    block_u = [u for _, u in blocks]
    import bisect

    def voffset(u):
        i = bisect.bisect_right(block_u, u) - 1
        return (block_c[i] << 16) | (u - block_u[i])

    data = bgzf.decompress_file(args.input)
    # skip header
    (l_text,) = struct.unpack_from("<i", data, 4)
    off = 8 + l_text
    (n_ref,) = struct.unpack_from("<i", data, off)
    off += 4
    for _ in range(n_ref):
        (l_name,) = struct.unpack_from("<i", data, off)
        off += 8 + l_name

    bins = [dict() for _ in range(n_ref)]
    linear = [dict() for _ in range(n_ref)]
    counts = [[0, 0] for _ in range(n_ref)]  # per ref: [mapped, unmapped]
    spans = [[None, 0] for _ in range(n_ref)]  # per ref: [first, last] voffset
    n_unmapped = 0
    while off < len(data):
        (block_size,) = struct.unpack_from("<i", data, off)
        rec_end = off + 4 + block_size
        ref_id, pos = struct.unpack_from("<ii", data, off + 4)
        flag_nc = struct.unpack_from("<I", data, off + 16)[0]
        n_cigar = flag_nc & 0xFFFF
        flag = flag_nc >> 16
        v_start, v_end = voffset(off), voffset(rec_end)
        if ref_id < 0:
            n_unmapped += 1
        elif flag & sam.UNMAPPED:
            # placed-unmapped reads count in the contig's pseudo-bin
            counts[ref_id][1] += 1
            if spans[ref_id][0] is None:
                spans[ref_id][0] = v_start
            spans[ref_id][1] = v_end
        else:
            l_read_name = struct.unpack_from("<B", data, off + 12)[0]
            cig_off = off + 4 + 32 + l_read_name
            cigar = np.frombuffer(data, "<u4", n_cigar, cig_off)
            span = int(np.sum((cigar >> 4)[np.isin(cigar & 0xF, (0, 2, 3, 7, 8))])) or 1
            b = bam._reg2bin(pos, pos + span)
            bins[ref_id].setdefault(b, []).append((v_start, v_end))
            counts[ref_id][0] += 1
            if spans[ref_id][0] is None:
                spans[ref_id][0] = v_start
            spans[ref_id][1] = v_end
            for w in range(pos >> 14, (pos + span - 1 >> 14) + 1):
                cur = linear[ref_id].get(w)
                if cur is None or v_start < cur:
                    linear[ref_id][w] = v_start
        off = rec_end

    out = [b"BAI\x01", struct.pack("<i", n_ref)]
    for rid in range(n_ref):
        # merge adjacent chunks per bin
        bin_chunks = {}
        for b, chunks in bins[rid].items():
            merged = []
            for beg, end in sorted(chunks):
                if merged and beg <= merged[-1][1]:
                    merged[-1] = (merged[-1][0], max(merged[-1][1], end))
                else:
                    merged.append((beg, end))
            bin_chunks[b] = merged
        has_meta = spans[rid][0] is not None
        out.append(struct.pack("<i", len(bin_chunks) + (1 if has_meta else 0)))
        for b in sorted(bin_chunks):
            out.append(struct.pack("<Ii", b, len(bin_chunks[b])))
            for beg, end in bin_chunks[b]:
                out.append(struct.pack("<QQ", beg, end))
        if has_meta:
            # pseudo-bin 37450: ref span voffsets + mapped/unmapped counts
            out.append(struct.pack("<Ii", bam.BaiIndex.MAX_BIN, 2))
            out.append(struct.pack("<QQ", spans[rid][0], spans[rid][1]))
            out.append(struct.pack("<QQ", counts[rid][0], counts[rid][1]))
        if linear[rid]:
            n_win = max(linear[rid]) + 1
            ioff = []
            prev = 0
            for w in range(n_win):
                prev = linear[rid].get(w, prev)
                ioff.append(prev)
            out.append(struct.pack("<i", n_win))
            out.append(struct.pack(f"<{n_win}Q", *ioff))
        else:
            out.append(struct.pack("<i", 0))
    out.append(struct.pack("<Q", n_unmapped))
    with open(out_path, "wb") as fh:
        fh.write(b"".join(out))
    print(f"wrote index {out_path}")
    return 0


@register_tool("GetSampleName")
def get_sample_name(argv):
    """Emit the single sample name from the BAM header (tools/GetSampleName.java)."""
    p = argparse.ArgumentParser(description="GetSampleName")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-O", "--output", default=None)
    args = p.parse_args(argv)
    reader = bam.BamReader(args.input)
    samples = {rg.get("SM") for rg in reader.header.read_groups if rg.get("SM")}
    if len(samples) != 1:
        from ..cli import UserError

        raise UserError(f"expected exactly one sample, found {sorted(samples)}")
    name = samples.pop()
    if args.output:
        with open(args.output, "w") as fh:
            fh.write(name + "\n")
    print(name)
    return 0


@register_tool("CountBases")
def count_bases(argv):
    """Count bases in a BAM (tools/CountBases.java)."""
    p = argparse.ArgumentParser(description="CountBases")
    p.add_argument("-I", "--input", action="append", required=True)
    args = p.parse_args(argv)
    total = sum(len(r.bases) for path in args.input for r in bam.BamReader(path))
    print(total)
    return 0


@register_tool("DownsampleSam")
def downsample_sam(argv):
    """Keep a deterministic fraction of read templates by name hash (picard
    DownsampleSam ConstantMemory strategy: all records of a template share the
    fate, independent of position)."""
    import hashlib

    p = argparse.ArgumentParser(description="DownsampleSam")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("-P", "--probability", type=float, required=True)
    p.add_argument("-R", "--random-seed", type=int, default=1)
    args = p.parse_args(argv)
    reader = bam.BamReader(args.input)
    w = bam.BamWriter(args.output, reader.header)
    kept = total = 0
    thresh = int(args.probability * 0xFFFFFFFF)
    seed = args.random_seed.to_bytes(8, "little", signed=True)
    for r in reader:
        total += 1
        h = int.from_bytes(hashlib.md5(seed + r.name.encode()).digest()[:4], "little")
        if h <= thresh:
            w.write(r)
            kept += 1
    w.close()
    print(f"kept {kept}/{total} reads")
    return 0


@register_tool("UnmarkDuplicates")
def unmark_duplicates(argv):
    """Clear the duplicate flag on all reads (tools/UnmarkDuplicates.java)."""
    p = argparse.ArgumentParser(description="UnmarkDuplicates")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-O", "--output", required=True)
    args = p.parse_args(argv)
    reader = bam.BamReader(args.input)
    w = bam.BamWriter(args.output, reader.header)
    for r in reader:
        r.flag &= ~sam.DUPLICATE
        w.write(r)
    w.close()
    return 0


@register_tool("FixMateInformation")
def fix_mate_information(argv):
    """Set mate position/ref/tlen and MQ/MC tags from the mate's actual
    alignment (picard FixMateInformation)."""
    p = argparse.ArgumentParser(description="FixMateInformation")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-O", "--output", required=True)
    args = p.parse_args(argv)
    reader = bam.BamReader(args.input)
    reads = list(reader)
    by_name: dict[str, list] = {}
    for r in reads:
        if r.is_paired and not r.flag & (0x100 | 0x800):
            by_name.setdefault(r.name, []).append(r)
    fixed = 0
    for group in by_name.values():
        if len(group) != 2:
            continue
        a, b = group
        for x, y in ((a, b), (b, a)):
            x.mate_ref_id = y.ref_id
            x.mate_pos = y.pos
            x.tags["MQ"] = y.mapq
            x.tags["MC"] = sam.cigar_to_string(y.cigar_ops, y.cigar_lens)
        if a.ref_id == b.ref_id and not a.is_unmapped and not b.is_unmapped:
            lo = min(a.pos, b.pos)
            hi = max(a.end, b.end)
            tl = hi - lo
            first, second = (a, b) if a.pos <= b.pos else (b, a)
            first.tlen, second.tlen = tl, -tl
        else:
            a.tlen = b.tlen = 0
        fixed += 1
    w = bam.BamWriter(args.output, reader.header)
    for r in reads:
        w.write(r)
    w.close()
    print(f"fixed {fixed} pairs")
    return 0


@register_tool("SetNmMdAndUqTags")
def set_nm_md_uq_tags(argv):
    """Recompute NM/MD/UQ against the reference (picard SetNmMdAndUqTags;
    htsjdk SequenceUtil.calculateMdAndNmTags)."""
    from ..io import fasta

    p = argparse.ArgumentParser(description="SetNmMdAndUqTags")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("-R", "--reference", required=True)
    args = p.parse_args(argv)
    reader = bam.BamReader(args.input)
    ref = fasta.FastaReference(args.reference)
    names = [s.name for s in reader.header.sequences]
    w = bam.BamWriter(args.output, reader.header)
    for r in reader:
        if not r.is_unmapped and 0 <= r.ref_id < len(names):
            span = sam.cigar_ref_length(r.cigar_ops, r.cigar_lens)
            rb = ref.fetch(names[r.ref_id], r.pos, r.pos + span)
            nm = 0
            uq = 0
            md = []
            match_run = 0
            ri = qi = 0
            for op, ln in zip(r.cigar_ops, r.cigar_lens):
                op, ln = int(op), int(ln)
                if op in (sam.OP_M, sam.OP_EQ, sam.OP_X):
                    seg_r = rb[ri : ri + ln]
                    seg_q = r.bases[qi : qi + ln]
                    mism = np.nonzero(seg_r != seg_q)[0]
                    prev = -1
                    for m in mism:
                        md.append(str(match_run + int(m) - prev - 1))
                        md.append(chr(seg_r[m]))
                        match_run = 0
                        prev = int(m)
                        nm += 1
                        uq += int(r.quals[qi + m])
                    match_run += ln - 1 - (int(mism[-1]) if len(mism) else -1)
                    ri += ln
                    qi += ln
                elif op == sam.OP_I:
                    nm += ln
                    qi += ln
                elif op == sam.OP_D:
                    md.append(str(match_run))
                    md.append("^" + rb[ri : ri + ln].tobytes().decode())
                    match_run = 0
                    nm += ln
                    ri += ln
                elif op == sam.OP_S:
                    qi += ln
                elif op == sam.OP_N:
                    ri += ln
            md.append(str(match_run))
            r.tags["NM"] = nm
            r.tags["MD"] = "".join(md)
            r.tags["UQ"] = uq
        w.write(r)
    w.close()
    return 0


@register_tool("SplitReads")
def split_reads(argv):
    """Split a BAM by sample / read group / library into separate outputs
    (tools/SplitReads.java)."""
    import os

    p = argparse.ArgumentParser(description="SplitReads")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-O", "--output", default=".", help="output directory")
    p.add_argument("--split-sample", action="store_true")
    p.add_argument("--split-read-group", action="store_true")
    p.add_argument("--split-library-name", action="store_true")
    args = p.parse_args(argv)
    reader = bam.BamReader(args.input)
    rg_map = {rg.get("ID"): rg for rg in reader.header.read_groups}
    base = os.path.splitext(os.path.basename(args.input))[0]
    writers: dict[str, bam.BamWriter] = {}

    def key_for(r):
        rg = rg_map.get(r.tags.get("RG")) if r.tags else None
        parts = []
        if args.split_sample:
            parts.append((rg or {}).get("SM", "unknown"))
        if args.split_read_group:
            parts.append((rg or {}).get("ID", "unknown"))
        if args.split_library_name:
            parts.append((rg or {}).get("LB", "unknown"))
        return ".".join(parts) if parts else "all"

    for r in reader:
        k = key_for(r)
        if k not in writers:
            writers[k] = bam.BamWriter(
                os.path.join(args.output, f"{base}.{k}.bam"), reader.header)
        writers[k].write(r)
    for w in writers.values():
        w.close()
    print(f"wrote {len(writers)} outputs")
    return 0


@register_tool("SplitSamByNumberOfReads")
def split_sam_by_number_of_reads(argv):
    """Split into chunks of N reads (picard SplitSamByNumberOfReads)."""
    import os

    p = argparse.ArgumentParser(description="SplitSamByNumberOfReads")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-O", "--output", required=True, help="output directory")
    p.add_argument("--split-to-n-reads", "-N_READS", type=int, required=True)
    p.add_argument("--out-prefix", default="shard")
    args = p.parse_args(argv)
    reader = bam.BamReader(args.input)
    os.makedirs(args.output, exist_ok=True)
    n = shard = 0
    w = None
    for r in reader:
        if w is None or n >= args.split_to_n_reads:
            if w is not None:
                w.close()
            shard += 1
            n = 0
            w = bam.BamWriter(
                os.path.join(args.output, f"{args.out_prefix}_{shard:04d}.bam"),
                reader.header)
        w.write(r)
        n += 1
    if w is not None:
        w.close()
    print(f"wrote {shard} shards")
    return 0


@register_tool("ClipReads")
def clip_reads(argv):
    """Clip read cycles / low-qual tails (tools/ClipReads.java: --QT qual
    trimming, --CT cycle ranges; soft-clip representation)."""
    p = argparse.ArgumentParser(description="ClipReads")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("-L", "--intervals", action="append", default=None)
    p.add_argument("-QT", "--q-trimming-threshold", type=int, default=-1)
    p.add_argument("-CT", "--cycles-to-trim", default=None,
                   help="e.g. 1-5,140-151 (1-based cycle ranges)")
    args = p.parse_args(argv)
    w = _ClipReadsWalker(reads_path=args.input, intervals=args.intervals)
    w.args = args
    w.run()
    return 0


class _ClipReadsWalker(walkers.ReadWalker):
    """ClipReads as a ReadWalker (tools/ClipReads.java extends ReadWalker)."""

    tool_name = "ClipReads"
    default_read_filters = ()

    def on_traversal_start(self):
        from ..engine import clipping

        self._clip = clipping
        args = self.args
        self.writer = bam.BamWriter(args.output, self.reads.header)
        self.ranges = []
        if args.cycles_to_trim:
            for part in args.cycles_to_trim.split(","):
                lo, hi = part.split("-")
                self.ranges.append((int(lo) - 1, int(hi)))
        self.n = 0

    def apply(self, r, ref_context):
        args = self.args
        if args.q_trimming_threshold >= 0 and len(r.quals):
            # clip the longest low-qual suffix (ClipReads QUAL mode)
            q = r.quals
            keep = len(q)
            while keep > 0 and q[keep - 1] <= args.q_trimming_threshold:
                keep -= 1
            if keep == 0:
                return
            if keep < len(q):
                r = self._clip.hard_clip_by_read_coords(r, keep, len(q) - 1)
        for lo, hi in self.ranges:
            if lo < len(r.bases):
                r.quals = r.quals.copy()
                r.quals[lo:hi] = 2  # mask cycles at Q2 (soft representation)
        self.writer.write(r)
        self.n += 1

    def close_tool(self):
        self.writer.close()
        print(f"wrote {self.n} reads")


@register_tool("BamIndexStats")
def bam_index_stats(argv):
    """Per-contig aligned/unaligned record counts from the .bai pseudo-bin
    (picard BamIndexStats)."""
    p = argparse.ArgumentParser(description="BamIndexStats")
    p.add_argument("-I", "--input", required=True)
    args = p.parse_args(argv)
    reader = bam.BamReader(args.input)
    idx = reader.index
    if idx is None:
        from ..cli import UserError

        raise UserError(f"no .bai index for {args.input}")
    for s in reader.header.sequences:
        aligned = unaligned = 0
        meta = idx.meta.get(s.index)
        if meta and len(meta) >= 2:
            aligned, unaligned = meta[1]
        print(f"{s.name} length=\t{s.length}\tAligned= {aligned}\tUnaligned= {unaligned}")
    return 0


@register_tool("BwaSpark")
def bwa_spark(argv):
    """Align reads against a reference (tools/spark/bwa/BwaSpark.java; the
    bwa-mem JNI replaced by the from-scratch seed-and-extend aligner,
    align/seed_extend.py). Accepts a BwaMemIndexImageCreator .img or builds
    the index from -R directly."""
    p = argparse.ArgumentParser(description="BwaSpark")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-R", "--reference", default=None)
    p.add_argument("--bwa-mem-index-image", default=None)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("--spark-master", default=None)
    args, _unknown = p.parse_known_args(argv)

    import numpy as np

    from ..align.seed_extend import SeedExtendAligner
    from ..io import bam as bamio, fasta, sam as sam_mod

    if args.bwa_mem_index_image:
        z = np.load(args.bwa_mem_index_image)
        aligner = SeedExtendAligner.__new__(SeedExtendAligner)
        aligner.k = int(z["k"])
        aligner.names = [str(x) for x in z["names"]]
        aligner.lengths = [int(x) for x in z["lengths"]]
        aligner.offsets = z["offsets"]
        aligner.ref = z["ref"]
        aligner.idx_hash = z["idx_hash"]
        aligner.idx_pos = z["idx_pos"]
        aligner.max_hits = int(z["max_hits"])
        names, lengths = aligner.names, aligner.lengths
    elif args.reference:
        ref = fasta.FastaReference(args.reference)
        names = ref.contigs()
        lengths = [ref.contig_length(n) for n in names]
        aligner = SeedExtendAligner(
            [(n, ref.fetch(n, 0, ref.contig_length(n))) for n in names])
    else:
        from ..cli import UserError
        raise UserError("provide -R or --bwa-mem-index-image")

    rd = bamio.BamReader(args.input)
    header = sam_mod.SamHeader(
        sequences=[sam_mod.SequenceRecord(n, l, i)
                   for i, (n, l) in enumerate(zip(names, lengths))],
        read_groups=rd.header.read_groups)
    w = bamio.BamWriter(args.output, header)
    n_aln = n_un = 0
    from ..io.reads import Read

    for r in rd:
        aln = aligner.align(np.asarray(r.bases, np.uint8))
        if aln is None:
            rr = r.copy()
            rr.flag = (rr.flag | sam_mod.UNMAPPED) & ~sam_mod.REVERSE
            rr.ref_id, rr.pos, rr.mapq = -1, -1, 0
            w.write(rr)
            n_un += 1
            continue
        bases = r.bases
        quals = r.quals
        if aln.is_reverse:
            from ..align.seed_extend import revcomp
            bases = revcomp(np.asarray(bases, np.uint8))
            quals = np.asarray(quals)[::-1].copy()
        w.write(Read(name=r.name, flag=(r.flag & 0x1) | (0x10 if aln.is_reverse else 0),
                     ref_id=aln.contig_index, pos=aln.pos, mapq=aln.mapq,
                     cigar_ops=aln.cigar_ops, cigar_lens=aln.cigar_lens,
                     bases=np.asarray(bases, np.uint8),
                     quals=np.asarray(quals, np.uint8),
                     tags={"NM": aln.nm, "AS": aln.score}))
        n_aln += 1
    w.close()
    print(f"BwaSpark: aligned {n_aln} reads ({n_un} unmapped) -> {args.output}")
    return 0


@register_tool("BwaAndMarkDuplicatesPipelineSpark")
def bwa_and_mark_duplicates_pipeline(argv):
    """Align then mark duplicates in one invocation
    (tools/spark/pipelines/BwaAndMarkDuplicatesPipelineSpark.java)."""
    p = argparse.ArgumentParser(description="BwaAndMarkDuplicatesPipelineSpark")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-R", "--reference", default=None)
    p.add_argument("--bwa-mem-index-image", default=None)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("--spark-master", default=None)
    args, _unknown = p.parse_known_args(argv)
    import os
    import tempfile

    from ..cli import TOOL_REGISTRY as _REG

    tmp = tempfile.mktemp(suffix=".bam")
    try:
        sub = ["-I", args.input, "-O", tmp]
        if args.reference:
            sub += ["-R", args.reference]
        if args.bwa_mem_index_image:
            sub += ["--bwa-mem-index-image", args.bwa_mem_index_image]
        rc = _REG["BwaSpark"](sub)
        if rc:
            return rc
        return _REG["MarkDuplicates"](["-I", tmp, "-O", args.output,
                                       "-M", args.output + ".metrics"])
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


@register_tool("CompareDuplicatesSpark")
def compare_duplicates(argv):
    """Compare duplicate marking between two BAMs
    (tools/spark/validation/CompareDuplicatesSpark.java): same reads, count
    agreement on the duplicate flag; non-zero exit on mismatch unless
    --throw-on-diff false."""
    p = argparse.ArgumentParser(description="CompareDuplicatesSpark")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-I2", "--input2", required=True)
    p.add_argument("-O", "--output", default=None)
    p.add_argument("--throw-on-diff", default="true")
    args, _unknown = p.parse_known_args(argv)

    from ..io import bam as bamio

    def dup_map(path):
        return {(r.name, r.is_first_of_pair): r.is_duplicate
                for r in bamio.BamReader(path)
                if not r.is_secondary and not r.is_supplementary}

    a = dup_map(args.input)
    b = dup_map(args.input2)
    common = set(a) & set(b)
    agree = sum(1 for k in common if a[k] == b[k])
    diff = len(common) - agree
    lines = [f"common reads: {len(common)}",
             f"duplicate-flag agreement: {agree}",
             f"disagreements: {diff}",
             f"only in first: {len(a) - len(common)}",
             f"only in second: {len(b) - len(common)}"]
    report = "\n".join(lines)
    print(report)
    if args.output:
        with open(args.output, "w") as fh:
            fh.write(report + "\n")
    return 1 if (diff and args.throw_on_diff == "true") else 0
