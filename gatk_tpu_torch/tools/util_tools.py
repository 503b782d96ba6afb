# Copied verbatim from gatk_tpu/tools/util_tools.py; only import lines may differ.
"""Small Picard-style utility tools.

Reference parity: picard SamToFastq / FastqToSam / AddOrReplaceReadGroups /
BedToIntervalList / IntervalListTools / CollectWgsMetrics (basic subset),
tools/walkers/variantutils/UpdateVCFSequenceDictionary.java, picard
RenameSampleInVcf / SplitVcfs.
"""
from __future__ import annotations

import argparse
import gzip
import os

import numpy as np

from ..cli import UserError, register_tool
from ..engine import walkers
from ..io import sam


def _revcomp_bytes(arr):
    comp = np.zeros(256, np.uint8)
    for a, b in zip(b"ACGTNacgtn", b"TGCANtgcan"):
        comp[a] = b
    return comp[arr][::-1]


@register_tool("SamToFastq")
def sam_to_fastq(argv):
    """Convert a BAM/SAM to FASTQ (pairs split into F/F2 when requested)."""
    p = argparse.ArgumentParser(description="SamToFastq")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-F", "--fastq", required=True)
    p.add_argument("-F2", "--second-end-fastq", default=None)
    p.add_argument("--include-non-pf-reads", default="false")
    args = p.parse_args(argv)
    w = _SamToFastqWalker(reads_path=args.input)
    w.args = args
    w.run()
    return 0


class _SamToFastqWalker(walkers.ReadWalker):
    """SamToFastq as a ReadWalker (picard SamToFastq read traversal)."""

    tool_name = "SamToFastq"
    default_read_filters = ()

    def on_traversal_start(self):
        args = self.args

        def opener(path):
            return gzip.open(path, "wt") if path.endswith(".gz") else open(path, "w")

        self.out1 = opener(args.fastq)
        self.out2 = opener(args.second_end_fastq) if args.second_end_fastq else None
        self.n = 0

    def apply(self, r, ref_context):
        args = self.args
        if r.is_secondary or r.is_supplementary:
            return
        if r.fails_vendor_quality and args.include_non_pf_reads.lower() != "true":
            return
        bases = r.bases
        quals = r.quals
        if r.is_reverse:
            bases = _revcomp_bytes(bases)
            quals = quals[::-1]
        rec = (f"@{r.name}\n{bases.tobytes().decode()}\n+\n"
               f"{(quals + 33).astype(np.uint8).tobytes().decode()}\n")
        if self.out2 is not None and r.is_paired and (r.flag & sam.SECOND_OF_PAIR):
            self.out2.write(rec)
        else:
            self.out1.write(rec)
        self.n += 1

    def close_tool(self):
        self.out1.close()
        if self.out2:
            self.out2.close()
        print(f"wrote {self.n} reads")


@register_tool("FastqToSam")
def fastq_to_sam(argv):
    """Convert FASTQ (optionally paired) to an unmapped BAM."""
    from ..io import bam as bamio
    from ..io.reads import Read

    p = argparse.ArgumentParser(description="FastqToSam")
    p.add_argument("-F1", "--fastq", required=True)
    p.add_argument("-F2", "--fastq2", default=None)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("-SM", "--sample-name", required=True)
    p.add_argument("-RG", "--read-group-name", default="A")
    args = p.parse_args(argv)

    def read_fastq(path):
        op = gzip.open if path.endswith(".gz") else open
        with op(path, "rt") as fh:
            while True:
                name = fh.readline().rstrip()
                if not name:
                    return
                seq = fh.readline().rstrip()
                fh.readline()
                qual = fh.readline().rstrip()
                yield name[1:].split()[0], seq, qual

    header = sam.SamHeader(
        sequences=[],
        read_groups=[{"ID": args.read_group_name, "SM": args.sample_name}],
    )
    w = bamio.BamWriter(args.output, header)
    n = 0

    def mk(name, seq, qual, flag):
        return Read(name, flag, -1, -1, 0,
                    np.zeros(0, np.uint8), np.zeros(0, np.int32),
                    np.frombuffer(seq.encode(), np.uint8).copy(),
                    np.frombuffer(qual.encode(), np.uint8) - 33,
                    tags={"RG": args.read_group_name})

    if args.fastq2:
        for (n1, s1, q1), (n2, s2, q2) in zip(read_fastq(args.fastq), read_fastq(args.fastq2)):
            w.write(mk(n1, s1, q1, sam.PAIRED | sam.UNMAPPED | sam.MATE_UNMAPPED | sam.FIRST_OF_PAIR))
            w.write(mk(n2, s2, q2, sam.PAIRED | sam.UNMAPPED | sam.MATE_UNMAPPED | sam.SECOND_OF_PAIR))
            n += 2
    else:
        for name, seq, qual in read_fastq(args.fastq):
            w.write(mk(name, seq, qual, sam.UNMAPPED))
            n += 1
    w.close()
    print(f"wrote {n} unmapped reads to {args.output}")
    return 0


@register_tool("AddOrReplaceReadGroups")
def add_or_replace_read_groups(argv):
    """Assign all reads to a single new read group."""
    from ..io import bam as bamio

    p = argparse.ArgumentParser(description="AddOrReplaceReadGroups")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("-ID", "--rg-id", default="1")
    p.add_argument("-LB", "--rg-lb", required=True)
    p.add_argument("-PL", "--rg-pl", required=True)
    p.add_argument("-PU", "--rg-pu", required=True)
    p.add_argument("-SM", "--rg-sm", required=True)
    args = p.parse_args(argv)

    reader = bamio.BamReader(args.input)
    header = reader.header
    rg = {"ID": args.rg_id, "LB": args.rg_lb, "PL": args.rg_pl,
          "PU": args.rg_pu, "SM": args.rg_sm}
    header.read_groups = [rg]
    rg_line = "@RG\t" + "\t".join(f"{k}:{v}" for k, v in rg.items())
    lines = [ln for ln in header.text.splitlines() if not ln.startswith("@RG")]
    header.text = "\n".join(lines + [rg_line]) + "\n" if lines or rg_line else ""
    w = bamio.BamWriter(args.output, header)
    n = 0
    for r in reader:
        r.tags["RG"] = args.rg_id
        w.write(r)
        n += 1
    w.close()
    print(f"rewrote {n} reads with read group {args.rg_id}")
    return 0


@register_tool("BedToIntervalList")
def bed_to_interval_list(argv):
    """Convert a BED file to a Picard interval_list (needs a sequence dictionary)."""
    p = argparse.ArgumentParser(description="BedToIntervalList")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-SD", "--sequence-dictionary", required=True)
    p.add_argument("-O", "--output", required=True)
    args = p.parse_args(argv)

    header = []
    with open(args.sequence_dictionary) as fh:
        for ln in fh:
            if ln.startswith(("@HD", "@SQ")):
                header.append(ln.rstrip("\n"))
    opener = gzip.open if args.input.endswith(".gz") else open
    n = 0
    with opener(args.input, "rt") as src, open(args.output, "w") as out:
        for ln in header:
            out.write(ln + "\n")
        for ln in src:
            if ln.startswith(("#", "track", "browser")) or not ln.strip():
                continue
            f = ln.rstrip("\n").split("\t")
            name = f[3] if len(f) > 3 and f[3] else "."
            strand = f[5] if len(f) > 5 and f[5] in "+-" else "+"
            out.write(f"{f[0]}\t{int(f[1]) + 1}\t{f[2]}\t{strand}\t{name}\n")
            n += 1
    print(f"wrote {n} intervals")
    return 0


@register_tool("IntervalListTools")
def interval_list_tools(argv):
    """Sort/merge/intersect/subtract interval lists; optional scatter output."""
    from ..cnv.cnv_io import read_interval_list

    p = argparse.ArgumentParser(description="IntervalListTools")
    p.add_argument("-I", "--input", action="append", required=True)
    p.add_argument("-SI", "--second-input", action="append", default=[])
    p.add_argument("-O", "--output", required=True)
    p.add_argument("--action", default="CONCAT",
                   choices=["CONCAT", "UNION", "INTERSECT", "SUBTRACT"])
    p.add_argument("--scatter-count", type=int, default=1)
    args = p.parse_args(argv)

    def merged(paths):
        ivs = []
        for path in paths:
            ivs.extend(read_interval_list(path))
        ivs.sort()
        out = []
        for c, s, e in ivs:
            if out and out[-1][0] == c and s <= out[-1][2] + 1:
                out[-1] = (c, out[-1][1], max(out[-1][2], e))
            else:
                out.append((c, s, e))
        return out

    header = []
    with open(args.input[0]) as fh:
        for ln in fh:
            if ln.startswith("@"):
                header.append(ln.rstrip("\n"))

    a = merged(args.input)
    if args.action in ("INTERSECT", "SUBTRACT"):
        b = merged(args.second_input)
        out = []
        for c, s, e in a:
            pieces = [(s, e)]
            for c2, s2, e2 in b:
                if c2 != c:
                    continue
                nxt = []
                for (ps, pe) in pieces:
                    if args.action == "INTERSECT":
                        lo, hi = max(ps, s2), min(pe, e2)
                        if lo <= hi:
                            nxt.append((lo, hi))
                    else:  # SUBTRACT
                        if e2 < ps or s2 > pe:
                            nxt.append((ps, pe))
                        else:
                            if ps < s2:
                                nxt.append((ps, s2 - 1))
                            if pe > e2:
                                nxt.append((e2 + 1, pe))
                pieces = nxt
            if args.action == "INTERSECT":
                # intersect keeps overlaps with ANY b interval: recompute properly
                pieces = []
                for c2, s2, e2 in b:
                    if c2 == c:
                        lo, hi = max(s, s2), min(e, e2)
                        if lo <= hi:
                            pieces.append((lo, hi))
            out.extend((c, ps, pe) for ps, pe in sorted(pieces))
    else:
        out = a

    def write_list(path, ivs):
        with open(path, "w") as fh:
            for ln in header:
                fh.write(ln + "\n")
            for c, s, e in ivs:
                fh.write(f"{c}\t{s}\t{e}\t+\t.\n")

    if args.scatter_count > 1:
        os.makedirs(args.output, exist_ok=True)
        total = sum(e - s + 1 for _c, s, e in out)
        per = max(total // args.scatter_count, 1)
        shard, acc, idx = [], 0, 0
        for iv in out:
            shard.append(iv)
            acc += iv[2] - iv[1] + 1
            if acc >= per and idx < args.scatter_count - 1:
                d = os.path.join(args.output, f"temp_{idx + 1:04d}_of_{args.scatter_count}")
                os.makedirs(d, exist_ok=True)
                write_list(os.path.join(d, "scattered.interval_list"), shard)
                shard, acc, idx = [], 0, idx + 1
        d = os.path.join(args.output, f"temp_{idx + 1:04d}_of_{args.scatter_count}")
        os.makedirs(d, exist_ok=True)
        write_list(os.path.join(d, "scattered.interval_list"), shard)
        print(f"scattered {len(out)} intervals into {idx + 1} lists")
    else:
        write_list(args.output, out)
        print(f"wrote {len(out)} intervals")
    return 0


@register_tool("CollectWgsMetrics")
def collect_wgs_metrics(argv):
    """Whole-genome coverage metrics (mean/median coverage, % bases at depth)."""
    from ..engine import pileup as pileup_mod
    from ..io import bam as bamio
    from .metrics_tools import write_metrics_file

    p = argparse.ArgumentParser(description="CollectWgsMetrics")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-R", "--reference", default=None)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("--minimum-mapping-quality", type=int, default=20)
    p.add_argument("--minimum-base-quality", type=int, default=20)
    p.add_argument("--coverage-cap", type=int, default=250)
    args = p.parse_args(argv)

    reader = bamio.BamReader(args.input)
    lengths = {i: s.length for i, s in enumerate(reader.header.sequences)}
    depth = {}
    for r in reader:
        if (r.is_unmapped or r.is_duplicate or r.is_secondary or r.is_supplementary
                or r.mapq < args.minimum_mapping_quality):
            continue
        pos, base, qual, flags = pileup_mod.expand_read(r)
        ok = (qual >= args.minimum_base_quality) & ((flags & pileup_mod.F_DELETION) == 0)
        arr = depth.setdefault(r.ref_id, np.zeros(lengths.get(r.ref_id, 0), np.int32))
        np.add.at(arr, pos[ok], 1)

    genome = sum(lengths.values())
    all_depths = np.concatenate([d for d in depth.values()]) if depth else np.zeros(1)
    pad = genome - len(all_depths)
    if pad > 0:
        all_depths = np.concatenate([all_depths, np.zeros(pad, np.int32)])
    capped = np.minimum(all_depths, args.coverage_cap)
    mean = capped.mean()
    median = float(np.median(capped))
    sd = capped.std()
    cols = ["GENOME_TERRITORY", "MEAN_COVERAGE", "SD_COVERAGE", "MEDIAN_COVERAGE"] + \
           [f"PCT_{x}X" for x in (1, 5, 10, 15, 20, 30)]
    row = [genome, mean, sd, median] + \
          [float((all_depths >= x).mean()) for x in (1, 5, 10, 15, 20, 30)]
    hist = {}
    binned = np.bincount(capped.astype(int), minlength=args.coverage_cap + 1)
    for d, c in enumerate(binned):
        if c:
            hist[d] = [int(c)]
    write_metrics_file(args.output, "CollectWgsMetrics (gatk_tpu)",
                       "picard.analysis.WgsMetrics", cols, [row],
                       ("coverage", ["count"], hist))
    print(f"mean coverage {mean:.2f}x over {genome} bases")
    return 0


@register_tool("UpdateVCFSequenceDictionary")
def update_vcf_sequence_dictionary(argv):
    """Replace a VCF's contig header lines from a dictionary/reference source."""
    from ..io import vcf as vcfio

    p = argparse.ArgumentParser(description="UpdateVCFSequenceDictionary")
    p.add_argument("-V", "--variant", required=True)
    p.add_argument("--source-dictionary", "-source-dictionary", required=True)
    p.add_argument("-O", "--output", required=True)
    args = p.parse_args(argv)

    contigs = []
    with open(args.source_dictionary) as fh:
        for ln in fh:
            if ln.startswith("@SQ"):
                d = dict(f.split(":", 1) for f in ln.rstrip().split("\t")[1:])
                contigs.append((d["SN"], int(d["LN"])))
    reader = vcfio.VcfReader(args.variant)
    header = [ln for ln in reader.header_lines if not ln.startswith("##contig=")]
    w = vcfio.VcfWriter(args.output, reader.samples, contigs=contigs,
                        extra_header_lines=header, write_format=bool(reader.samples))
    n = 0
    for v in reader:
        w.write(v)
        n += 1
    w.close()
    print(f"rewrote {n} records with {len(contigs)} contigs")
    return 0


@register_tool("RenameSampleInVcf")
def rename_sample_in_vcf(argv):
    """Rename the (single) sample in a VCF."""
    from ..io import vcf as vcfio

    p = argparse.ArgumentParser(description="RenameSampleInVcf")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("--new-sample-name", required=True)
    p.add_argument("--old-sample-name", default=None)
    args = p.parse_args(argv)

    reader = vcfio.VcfReader(args.input)
    if len(reader.samples) != 1:
        raise UserError("RenameSampleInVcf requires a single-sample VCF")
    if args.old_sample_name and reader.samples[0] != args.old_sample_name:
        raise UserError(f"existing sample is {reader.samples[0]}, not {args.old_sample_name}")
    w = vcfio.VcfWriter(args.output, [args.new_sample_name],
                        extra_header_lines=reader.header_lines)
    n = 0
    for v in reader:
        w.write(v)
        n += 1
    w.close()
    print(f"renamed sample to {args.new_sample_name} ({n} records)")
    return 0


@register_tool("SplitVcfs")
def split_vcfs(argv):
    """Split a VCF into SNP and indel files."""
    from ..io import vcf as vcfio

    p = argparse.ArgumentParser(description="SplitVcfs")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("--snp-output", required=True)
    p.add_argument("--indel-output", required=True)
    args = p.parse_args(argv)

    reader = vcfio.VcfReader(args.input)
    ws = vcfio.VcfWriter(args.snp_output, reader.samples,
                         extra_header_lines=reader.header_lines,
                         write_format=bool(reader.samples))
    wi = vcfio.VcfWriter(args.indel_output, reader.samples,
                         extra_header_lines=reader.header_lines,
                         write_format=bool(reader.samples))
    ns = ni = 0
    for v in reader:
        if v.is_snp():
            ws.write(v)
            ns += 1
        elif v.is_indel():
            wi.write(v)
            ni += 1
    ws.close()
    wi.close()
    print(f"{ns} SNPs, {ni} indels")
    return 0


@register_tool("IndexFeatureFile")
def index_feature_file(argv):
    """Create a tabix (.tbi) index for a BGZF-compressed feature file
    (tools/IndexFeatureFile.java; htslib tbx_index_build semantics in
    io/tabix.write_tbi)."""
    import argparse

    from ..io import tabix

    p = argparse.ArgumentParser(description="IndexFeatureFile")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-O", "--output", default=None,
                   help="index path (default <input>.tbi)")
    p.add_argument("--preset", choices=["vcf", "bed", "gff"], default=None,
                   help="format preset (default: by file extension)")
    args = p.parse_args(argv)

    name = args.input.lower()
    preset = args.preset or ("bed" if ".bed" in name else
                             "gff" if (".gff" in name or ".gtf" in name) else "vcf")
    conf = {"vcf": tabix.CONF_VCF, "bed": tabix.CONF_BED, "gff": tabix.CONF_GFF}[preset]
    dest = tabix.write_tbi(args.input, conf, args.output)
    print(f"wrote index {dest}")
    return 0


@register_tool("PrintFileDiagnostics")
def print_file_diagnostics(argv):
    """Print structural diagnostics for a genomics file
    (tools/PrintFileDiagnostics.java: HTSAnalyzer per file type — here BAM/CRAM
    container+block layout, .bai index bin/chunk stats, VCF header census)."""
    p = argparse.ArgumentParser(description="PrintFileDiagnostics")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("--count-limit", type=int, default=1000)
    args = p.parse_args(argv)

    lines = []
    path = args.input
    if path.endswith(".cram"):
        from ..io import cram as cram_mod
        lines.append(f"CRAM file: {path}")
        with open(path, "rb") as fh:
            magic = fh.read(6)
            version = magic[4]
            lines.append(f"  magic: {magic[:4]!r} version {magic[4]}.{magic[5]}")
            n = 0
            while n < args.count_limit:
                pos = fh.tell()
                ch = cram_mod._read_container_header(fh, version)
                if ch is None:
                    break
                lines.append(
                    f"  container@{pos}: len={ch.length} ref={ch.ref_id} "
                    f"start={ch.start} span={ch.span} records={ch.n_records} "
                    f"blocks={ch.n_blocks}")
                if ch.ref_id == -1 and ch.n_records == 0 and ch.length <= 15:
                    lines.append("  EOF container")
                    break
                fh.seek(ch.length, 1)  # header reader leaves fh at payload start
                n += 1
            if n >= args.count_limit:
                lines.append(f"  ... (stopped at count-limit {args.count_limit})")
    elif path.endswith(".bam"):
        from ..io import bam as bam_mod
        rd = bam_mod.BamReader(path)
        h = rd.header
        lines.append(f"BAM file: {path}")
        lines.append(f"  contigs: {len(h.sequences)}")
        lines.append(f"  read groups: {len(h.read_groups)}")
        n = sum(1 for _ in zip(rd, range(args.count_limit)))
        lines.append(f"  first records scanned: {n}")
        import os as _os
        bai = path + ".bai"
        if _os.path.exists(bai):
            sz = _os.path.getsize(bai)
            lines.append(f"  index: {bai} ({sz} bytes)")
    elif path.endswith((".vcf", ".vcf.gz")):
        from ..io import vcf as vcf_mod
        rd = vcf_mod.VcfReader(path)
        lines.append(f"VCF file: {path}")
        lines.append(f"  header lines: {len(rd.header_lines)}")
        lines.append(f"  samples: {len(rd.samples)}")
        kinds = {}
        for l in rd.header_lines:
            k = l.split("=", 1)[0].lstrip("#")
            kinds[k] = kinds.get(k, 0) + 1
        for k in sorted(kinds):
            lines.append(f"  {k}: {kinds[k]}")
    else:
        lines.append(f"file: {path} (no specialized analyzer; size "
                     f"{__import__('os').path.getsize(path)} bytes)")
    with open(args.output, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    print("\n".join(lines))
    return 0


@register_tool("BwaMemIndexImageCreator")
def bwa_mem_index_image_creator(argv):
    """Create a serialized aligner index image from a FASTA
    (tools/BwaMemIndexImageCreator.java; here the image is the seed-extend
    aligner's kmer index — align/seed_extend.py — stored as an .img npz)."""
    p = argparse.ArgumentParser(description="BwaMemIndexImageCreator")
    p.add_argument("-I", "--input", required=True, help="reference FASTA")
    p.add_argument("-O", "--output", default=None,
                   help="output image (default <fasta>.img)")
    args = p.parse_args(argv)
    import numpy as np

    from ..align.seed_extend import SeedExtendAligner
    from ..io import fasta as fasta_mod

    ref = fasta_mod.FastaReference(args.input)
    contigs = [(n, ref.fetch(n, 0, ref.contig_length(n))) for n in ref.contigs()]
    aligner = SeedExtendAligner(contigs)
    out = args.output or args.input + ".img"
    np.savez_compressed(out if out.endswith(".npz") else out,
                        names=np.array(aligner.names),
                        lengths=np.array(aligner.lengths, np.int64),
                        offsets=aligner.offsets, ref=aligner.ref,
                        idx_hash=aligner.idx_hash, idx_pos=aligner.idx_pos,
                        k=np.int64(aligner.k), max_hits=np.int64(aligner.max_hits))
    import os as _os
    # numpy appends .npz; normalize to the requested name
    if not out.endswith(".npz") and _os.path.exists(out + ".npz"):
        _os.replace(out + ".npz", out)
    # sidecar BWT/FM-index (the bwa-class seed structure) when native lib built
    from ..align import fmindex

    if fmindex.available():
        fm = fmindex.FMIndex.build(
            [(n, np.asarray(s, np.uint8)) for n, s in contigs])
        fm.save(out + ".fmi")
        print(f"wrote aligner index image to {out} (+ {out}.fmi FM-index)")
    else:
        print(f"wrote aligner index image to {out}")
    return 0
