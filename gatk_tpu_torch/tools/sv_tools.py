# Copied verbatim from gatk_tpu/tools/sv_tools.py; only import lines may differ.
"""Structural-variant tools: SVAnnotate + SVCluster.

Reference parity: tools/walkers/sv/SVAnnotateEngine.java (per-type transcript
consequence rules :184-377 — LOF/COPY_GAIN/TSS_DUP/DUP_PARTIAL/INT_EXON_DUP/
PARTIAL_EXON_DUP/UTR/INTRONIC/INV_SPAN/BREAKEND_EXONIC/MSV_EXON_OVERLAP,
promoter windows, intergenic NEAREST_TSS), tools/sv/SVCluster.java +
tools/sv/cluster/CanonicalSVLinkage.java (single-linkage clustering by type
with reciprocal-overlap/breakend-window criteria).
"""
from __future__ import annotations

import argparse

from ..cli import register_tool

# GATKSVVCFConstants
LOF = "PREDICTED_LOF"
INT_EXON_DUP = "PREDICTED_INTRAGENIC_EXON_DUP"
COPY_GAIN = "PREDICTED_COPY_GAIN"
DUP_PARTIAL = "PREDICTED_DUP_PARTIAL"
PARTIAL_EXON_DUP = "PREDICTED_PARTIAL_EXON_DUP"
INTRONIC = "PREDICTED_INTRONIC"
INV_SPAN = "PREDICTED_INV_SPAN"
UTR = "PREDICTED_UTR"
MSV_EXON_OVERLAP = "PREDICTED_MSV_EXON_OVERLAP"
PROMOTER = "PREDICTED_PROMOTER"
BREAKEND_EXON = "PREDICTED_BREAKEND_EXONIC"
INTERGENIC = "PREDICTED_INTERGENIC"
NEAREST_TSS = "PREDICTED_NEAREST_TSS"
TSS_DUP = "PREDICTED_TSS_DUP"
NONCODING_SPAN = "PREDICTED_NONCODING_SPAN"
NONCODING_BREAKPOINT = "PREDICTED_NONCODING_BREAKPOINT"

MSV_EXON_OVERLAP_CLASSIFICATIONS = {LOF, INT_EXON_DUP, DUP_PARTIAL, PARTIAL_EXON_DUP, TSS_DUP}


def _tss(t):
    return t.start if t.strand == "+" else t.end


def _spans(v_start, v_end, f_start, f_end):
    return v_start <= f_start and v_end >= f_end


def _breakends_inside(v_start, v_end, f_start, f_end):
    if f_end < v_start or f_start > v_end or _spans(v_start, v_end, f_start, f_end):
        return 0
    if f_start <= v_start and f_end >= v_end:
        return 2
    return 1


def _utr_features(t):
    """UTR spans derived from exons minus CDS (GTF may lack explicit UTR rows)."""
    if not t.cds:
        return []
    cds_lo = min(s for s, _ in t.cds)
    cds_hi = max(e for _, e in t.cds)
    utrs = []
    for s, e in t.exons:
        if s < cds_lo:
            utrs.append((s, min(e, cds_lo - 1)))
        if e > cds_hi:
            utrs.append((max(s, cds_hi + 1), e))
    return [u for u in utrs if u[0] <= u[1]]


def _simple_consequence(v_start, v_end, t):
    for s, e in t.cds:
        if s <= v_end and e >= v_start:
            return LOF
    for s, e in _utr_features(t):
        if s <= v_end and e >= v_start:
            return UTR
    return INTRONIC


def annotate_sv_transcript(v_start, v_end, sv_type, t):
    """Consequence of an SV segment on one protein-coding transcript."""
    tss = _tss(t)
    overlaps_tss = v_start <= tss <= v_end
    if sv_type in ("INS", "CTX_INS"):
        return _simple_consequence(v_start, v_end, t)
    if sv_type == "DEL":
        return LOF if overlaps_tss else _simple_consequence(v_start, v_end, t)
    if sv_type in ("DUP", "CNV"):
        if _spans(v_start, v_end, t.start, t.end):
            cons = COPY_GAIN
        elif overlaps_tss:
            cons = TSS_DUP
        elif not (t.start <= v_start and v_end <= t.end):
            cons = DUP_PARTIAL
        else:
            n_bp_cds = n_bp_utr = n_cds_span = n_utr_span = 0
            for s, e in t.cds:
                if e < v_start or s > v_end:
                    continue
                if _spans(v_start, v_end, s, e):
                    n_cds_span += 1
                else:
                    n_bp_cds += _breakends_inside(v_start, v_end, s, e)
            for s, e in _utr_features(t):
                if e < v_start or s > v_end:
                    continue
                if _spans(v_start, v_end, s, e):
                    n_utr_span += 1
                else:
                    n_bp_utr += _breakends_inside(v_start, v_end, s, e)
            if n_bp_cds == 2 or (n_bp_cds == 1 and n_bp_utr == 1):
                cons = LOF
            elif n_bp_cds == 1:
                cons = PARTIAL_EXON_DUP
            elif n_cds_span > 0:
                cons = INT_EXON_DUP
            elif n_bp_utr > 0 or n_utr_span > 0:
                cons = UTR
            else:
                cons = INTRONIC
        if sv_type == "CNV" and cons in MSV_EXON_OVERLAP_CLASSIFICATIONS:
            return MSV_EXON_OVERLAP
        return cons
    if sv_type == "INV":
        if _spans(v_start, v_end, t.start, t.end):
            return INV_SPAN
        return LOF if overlaps_tss else _simple_consequence(v_start, v_end, t)
    if sv_type in ("CTX", "TRA"):
        return LOF
    if sv_type == "BND":
        cons = _simple_consequence(v_start, v_end, t)
        return BREAKEND_EXON if cons == LOF else cons
    return _simple_consequence(v_start, v_end, t)


@register_tool("SVAnnotate")
def sv_annotate(argv):
    """Annotate SV VCF records with predicted functional consequences on genes."""
    from ..funcotator.gencode import load_gtf
    from ..io import vcf as vcfio

    p = argparse.ArgumentParser(description="SVAnnotate")
    p.add_argument("-V", "--variant", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("--protein-coding-gtf", required=True)
    p.add_argument("--non-coding-bed", default=None)
    p.add_argument("--promoter-window-length", type=int, default=1000)
    args = p.parse_args(argv)

    transcripts = [t for t in load_gtf(args.protein_coding_gtf).values()
                   if t.transcript_type in ("", "protein_coding")]
    by_contig = {}
    for t in transcripts:
        by_contig.setdefault(t.contig, []).append(t)

    noncoding = {}
    if args.non_coding_bed:
        with open(args.non_coding_bed) as fh:
            for ln in fh:
                if not ln.strip() or ln.startswith("#"):
                    continue
                f = ln.rstrip("\n").split("\t")
                noncoding.setdefault(f[0], []).append(
                    (int(f[1]) + 1, int(f[2]), f[3] if len(f) > 3 else "element"))

    reader = vcfio.VcfReader(args.variant)
    keys = [LOF, INT_EXON_DUP, COPY_GAIN, DUP_PARTIAL, PARTIAL_EXON_DUP, INTRONIC,
            INV_SPAN, UTR, MSV_EXON_OVERLAP, PROMOTER, BREAKEND_EXON, TSS_DUP,
            NONCODING_SPAN, NONCODING_BREAKPOINT, NEAREST_TSS]
    header = reader.header_lines + [
        f'##INFO=<ID={k},Number=.,Type=String,Description="SVAnnotate predicted consequence">'
        for k in keys] + [
        f'##INFO=<ID={INTERGENIC},Number=0,Type=Flag,Description="SV does not overlap any protein-coding gene">']
    w = vcfio.VcfWriter(args.output, reader.samples,
                        extra_header_lines=header, write_format=bool(reader.samples))
    n = 0
    for v in reader:
        sv_type = str(v.info.get("SVTYPE", "BND"))
        start1 = v.pos + 1
        end1 = int(v.info.get("END", v.pos + len(v.ref)))
        if sv_type == "BND":
            end1 = start1  # breakend point annotation
        consequences = {}
        overlapped_genes = set()
        for t in by_contig.get(v.contig, ()):
            if t.start <= end1 and t.end >= start1:
                cons = annotate_sv_transcript(start1, end1, sv_type, t)
                consequences.setdefault(cons, set()).add(t.gene_name)
                overlapped_genes.add(t.gene_name)
        # promoters for transcripts NOT overlapped
        for t in by_contig.get(v.contig, ()):
            if t.gene_name in overlapped_genes:
                continue
            tss = _tss(t)
            if t.strand == "+":
                pw = (max(1, tss - args.promoter_window_length), tss - 1)
            else:
                pw = (tss + 1, tss + args.promoter_window_length)
            if pw[0] <= end1 and pw[1] >= start1:
                consequences.setdefault(PROMOTER, set()).add(t.gene_name)
        # noncoding elements
        for (s, e, name) in noncoding.get(v.contig, ()):
            if s <= end1 and e >= start1:
                if _spans(start1, end1, s, e):
                    consequences.setdefault(NONCODING_SPAN, set()).add(name)
                else:
                    consequences.setdefault(NONCODING_BREAKPOINT, set()).add(name)
        if not any(k not in (NONCODING_SPAN, NONCODING_BREAKPOINT, PROMOTER)
                   for k in consequences):
            # intergenic: flag + nearest TSS
            best = None
            for t in by_contig.get(v.contig, ()):
                d = min(abs(_tss(t) - start1), abs(_tss(t) - end1))
                if best is None or d < best[0]:
                    best = (d, t.gene_name)
            info = dict(v.info)
            info[INTERGENIC] = True
            if best:
                info[NEAREST_TSS] = best[1]
            v.info = info
        if consequences:
            info = dict(v.info)
            for k in sorted(consequences):
                info[k] = ",".join(sorted(consequences[k]))
            v.info = info
        w.write(v)
        n += 1
    w.close()
    print(f"annotated {n} SV records -> {args.output}")
    return 0


# ---------------------------------------------------------------------------
# SVCluster (single-linkage clustering, CanonicalSVLinkage defaults)
# ---------------------------------------------------------------------------

def _sv_overlap_ok(a, b, recip, window, sample_overlap=0.0):
    """CanonicalSVLinkage clusterTogether: same type+contig, reciprocal overlap
    and breakend window criteria."""
    if a["type"] != b["type"] or a["contig"] != b["contig"]:
        return False
    if abs(a["start"] - b["start"]) > window or abs(a["end"] - b["end"]) > window:
        return False
    lo = max(a["start"], b["start"])
    hi = min(a["end"], b["end"])
    inter = max(0, hi - lo + 1)
    if inter <= 0:
        return False
    ro = min(inter / max(a["end"] - a["start"] + 1, 1),
             inter / max(b["end"] - b["start"] + 1, 1))
    return ro >= recip


@register_tool("SVCluster")
def sv_cluster(argv):
    """Cluster structural variants across input VCFs (single linkage)."""
    from ..io import vcf as vcfio

    p = argparse.ArgumentParser(description="SVCluster")
    p.add_argument("-V", "--variant", action="append", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("--ploidy-table", default=None)
    p.add_argument("--variant-prefix", default="SV_")
    p.add_argument("--depth-interval-overlap", type=float, default=0.8)
    p.add_argument("--depth-breakend-window", type=int, default=10000000)
    p.add_argument("--pesr-interval-overlap", type=float, default=0.5)
    p.add_argument("--pesr-breakend-window", type=int, default=500)
    p.add_argument("--algorithm", default="SINGLE_LINKAGE")
    args = p.parse_args(argv)

    records = []
    samples = []
    header_lines = None
    for path in args.variant:
        reader = vcfio.VcfReader(path)
        if header_lines is None:
            header_lines = reader.header_lines
        for s in reader.samples:
            if s not in samples:
                samples.append(s)
        for v in reader:
            records.append(dict(
                contig=v.contig, start=v.pos + 1,
                end=int(v.info.get("END", v.pos + len(v.ref))),
                type=str(v.info.get("SVTYPE", "BND")),
                algorithms=str(v.info.get("ALGORITHMS", "pesr")),
                v=v, sample_gts={s: g for s, g in zip(reader.samples, v.samples)}))

    # single-linkage clustering via union-find over candidate pairs
    records.sort(key=lambda r: (r["contig"], r["start"]))
    parent = list(range(len(records)))

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    for i in range(len(records)):
        a = records[i]
        depth_a = a["algorithms"] == "depth"
        for j in range(i + 1, len(records)):
            b = records[j]
            if b["contig"] != a["contig"] or b["start"] - a["end"] > args.depth_breakend_window:
                break
            depth = depth_a and b["algorithms"] == "depth"
            recip = args.depth_interval_overlap if depth else args.pesr_interval_overlap
            window = args.depth_breakend_window if depth else args.pesr_breakend_window
            if _sv_overlap_ok(a, b, recip, window):
                parent[find(i)] = find(j)

    clusters = {}
    for i in range(len(records)):
        clusters.setdefault(find(i), []).append(records[i])

    out = []
    for idx, (key, members) in enumerate(sorted(
            clusters.items(), key=lambda kv: (kv[1][0]["contig"], min(m["start"] for m in kv[1])))):
        # representative: median breakpoints
        starts = sorted(m["start"] for m in members)
        ends = sorted(m["end"] for m in members)
        rep = dict(members[0])
        start = starts[len(starts) // 2]
        end = ends[len(ends) // 2]
        v0 = rep["v"]
        gts = {}
        for m in members:
            for s, g in m["sample_gts"].items():
                if s not in gts or g.get("GT", "./.") not in ("./.", "."):
                    gts[s] = g
        from ..io.vcf import Variant

        info = {"END": str(end), "SVTYPE": rep["type"],
                "SVLEN": str(end - start + 1 if rep["type"] != "BND" else -1),
                "ALGORITHMS": ",".join(sorted({m["algorithms"] for m in members})),
                "MEMBERS": ",".join(m["v"].id for m in members if m["v"].id != ".")}
        info = {k: v for k, v in info.items() if v}
        fmt_keys = v0.fmt_keys or ("GT",)
        out.append(Variant(
            contig=rep["contig"], pos=start - 1, ref=v0.ref or "N",
            alts=(f"<{rep['type']}>",), id=f"{args.variant_prefix}{idx}",
            qual=None, filters=(), info=info, fmt_keys=fmt_keys,
            samples=[gts.get(s, {"GT": "./."}) for s in samples]))

    extra = [
        '##INFO=<ID=SVLEN,Number=1,Type=Integer,Description="SV length">',
        '##INFO=<ID=MEMBERS,Number=.,Type=String,Description="Cluster member variant IDs">',
        '##INFO=<ID=ALGORITHMS,Number=.,Type=String,Description="Source algorithms">',
    ]
    w = vcfio.VcfWriter(args.output, samples,
                        extra_header_lines=(header_lines or []) + extra)
    for v in out:
        w.write(v)
    w.close()
    print(f"clustered {len(records)} records into {len(out)} variants -> {args.output}")
    return 0


@register_tool("CollectSVEvidence")
def collect_sv_evidence(argv):
    """Collect split-read and discordant-pair SV evidence from a BAM.

    Reference: tools/walkers/sv/CollectSVEvidence.java — soft-clipped reads
    yield SplitReadEvidence at the clip position (first-cigar-op M -> RIGHT at
    start+refLength, else LEFT at start, getSplitPosition :423-430), counted
    per (position, direction); non-properly-paired primary reads yield
    DiscordantPairEvidence (reportDiscordantReadPair :332). Encodings match
    utils/codecs/SplitReadEvidenceCodec.encode :91 and
    DiscordantPairEvidenceCodec.encode :89 (tab-separated, 0-based, bgzipped).
    """
    import argparse as _ap

    from ..io import bam as bamio, bgzf, sam as samio

    p = _ap.ArgumentParser(description="CollectSVEvidence")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("--sr-file", default=None, help="split-read evidence output (.sr.txt.gz)")
    p.add_argument("--pe-file", default=None, help="discordant-pair evidence output (.pe.txt.gz)")
    p.add_argument("--sample-name", default=None)
    args = p.parse_args(argv)

    reader = bamio.BamReader(args.input)
    sample = args.sample_name
    if sample is None:
        sample = reader.header.read_groups[0].get("SM", "SAMPLE") \
            if reader.header.read_groups else "SAMPLE"
    contigs = [s.name for s in reader.header.sequences]

    sr_counts: dict = {}   # (ref_id, pos0, direction) -> count
    pe_rows = []
    seen_pairs = set()
    for r in reader:
        if r.is_unmapped or r.is_secondary or r.is_supplementary or r.is_duplicate:
            continue
        ops = [int(o) for o in r.cigar_ops]
        lens = [int(l) for l in r.cigar_lens]
        if ops and samio.OP_S in ops:
            # getSplitPosition: leading M -> RIGHT clip at start+refLen; leading S -> LEFT
            if ops[0] == samio.OP_M:
                ref_len = sum(l for o, l in zip(ops, lens)
                              if o in (samio.OP_M, samio.OP_D, samio.OP_N, samio.OP_EQ, samio.OP_X))
                key = (r.ref_id, r.pos + ref_len, "right")
                sr_counts[key] = sr_counts.get(key, 0) + 1
            elif ops[0] == samio.OP_S:
                key = (r.ref_id, r.pos, "left")
                sr_counts[key] = sr_counts.get(key, 0) + 1
        if r.is_paired and not (r.flag & 0x2) and not (r.flag & 0x8) \
                and r.mate_ref_id >= 0:
            # report once per template, from the earlier-coordinate read
            if (r.ref_id, r.pos) < (r.mate_ref_id, r.mate_pos) or \
                    ((r.ref_id, r.pos) == (r.mate_ref_id, r.mate_pos) and r.name not in seen_pairs):
                seen_pairs.add(r.name)
                pe_rows.append((r.ref_id, r.pos,
                                "-" if r.is_reverse else "+",
                                r.mate_ref_id, r.mate_pos,
                                "-" if (r.flag & 0x20) else "+"))

    if args.sr_file:
        lines = []
        for (rid, pos, direction), count in sorted(sr_counts.items()):
            lines.append(f"{contigs[rid]}\t{pos}\t{direction}\t{count}\t{sample}")
        payload = ("\n".join(lines) + "\n").encode() if lines else b""
        with open(args.sr_file, "wb") as fh:
            fh.write(bgzf.compress_bytes(payload))
        print(f"{len(lines)} split-read evidence records -> {args.sr_file}")
    if args.pe_file:
        lines = []
        for rid, pos, strand, mrid, mpos, mstrand in sorted(pe_rows):
            lines.append(f"{contigs[rid]}\t{pos}\t{strand}\t{contigs[mrid]}\t{mpos}\t{mstrand}\t{sample}")
        payload = ("\n".join(lines) + "\n").encode() if lines else b""
        with open(args.pe_file, "wb") as fh:
            fh.write(bgzf.compress_bytes(payload))
        print(f"{len(lines)} discordant-pair evidence records -> {args.pe_file}")
    return 0


@register_tool("PrintSVEvidence")
def print_sv_evidence(argv):
    """Print (optionally subset) an SV evidence file
    (tools/sv/PrintSVEvidence.java: round-trips evidence records)."""
    import argparse as _ap
    import gzip as _gzip

    p = _ap.ArgumentParser(description="PrintSVEvidence")
    p.add_argument("--evidence-file", "-F", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("-L", "--intervals", action="append", default=None)
    args = p.parse_args(argv)

    def parse_interval(s):
        if ":" not in s:
            return s, 0, 1 << 60
        contig, _, rng = s.partition(":")
        lo, _, hi = rng.partition("-")
        return contig, int(lo) - 1, int(hi)

    targets = [parse_interval(s) for s in args.intervals] if args.intervals else None
    opener = _gzip.open if args.evidence_file.endswith(".gz") else open
    out_lines = []
    with opener(args.evidence_file, "rt") as fh:
        for line in fh:
            if not line.strip():
                continue
            parts = line.split("\t")
            contig, pos = parts[0], int(parts[1])
            if targets is not None and not any(
                    contig == c and lo <= pos < hi for c, lo, hi in targets):
                continue
            out_lines.append(line.rstrip("\n"))
    if args.output.endswith(".gz"):
        from ..io import bgzf
        with open(args.output, "wb") as fh:
            fh.write(bgzf.compress_bytes(("\n".join(out_lines) + "\n").encode() if out_lines else b""))
    else:
        with open(args.output, "w") as fh:
            for line in out_lines:
                fh.write(line + "\n")
    print(f"{len(out_lines)} evidence records -> {args.output}")
    return 0


# ---------------------------------------------------------------------------
# SVConcordance (walkers/sv/SVConcordance.java + tools/sv/concordance/)
# ---------------------------------------------------------------------------

def _sv_record(v, samples):
    return dict(
        contig=v.contig, start=v.pos + 1,
        end=int(v.info.get("END", v.pos + len(v.ref))),
        type=str(v.info.get("SVTYPE", "BND")),
        algorithms=str(v.info.get("ALGORITHMS", "pesr")),
        v=v, sample_gts={s: g for s, g in zip(samples, v.samples)})


def _gt_state(g):
    gt = (g or {}).get("GT", "./.").replace("|", "/")
    if gt in ("./.", ".", ""):
        return None
    alleles = gt.split("/")
    n_alt = sum(1 for a in alleles if a not in ("0", "."))
    if n_alt == 0:
        return "HOM_REF"
    if n_alt == len(alleles):
        return "HOM_VAR"
    return "HET"


@register_tool("SVConcordance")
def sv_concordance(argv):
    """Annotate an SV callset with its concordance against a truth callset
    (walkers/sv/SVConcordance.java: ClosestSVFinder matches each eval record to
    the closest truth record under the clustering linkage criteria;
    SVConcordanceAnnotator adds TRUTH_* and genotype-concordance INFO fields)."""
    from ..io import vcf as vcfio
    from ..io.vcf import Variant

    p = argparse.ArgumentParser(description="SVConcordance")
    p.add_argument("--eval", required=True)
    p.add_argument("--truth", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("--depth-interval-overlap", type=float, default=0.8)
    p.add_argument("--depth-breakend-window", type=int, default=10000000)
    p.add_argument("--pesr-interval-overlap", type=float, default=0.5)
    p.add_argument("--pesr-breakend-window", type=int, default=500)
    args = p.parse_args(argv)

    truth_reader = vcfio.VcfReader(args.truth)
    truth = [_sv_record(v, truth_reader.samples) for v in truth_reader]
    by_contig = {}
    for t in truth:
        by_contig.setdefault(t["contig"], []).append(t)
    for c in by_contig:
        by_contig[c].sort(key=lambda r: r["start"])

    eval_reader = vcfio.VcfReader(args.eval)
    out_records = []
    for v in eval_reader:
        e = _sv_record(v, eval_reader.samples)
        depth_e = e["algorithms"] == "depth"
        best = None
        best_dist = None
        for t in by_contig.get(e["contig"], []):
            depth = depth_e and t["algorithms"] == "depth"
            recip = args.depth_interval_overlap if depth else args.pesr_interval_overlap
            window = args.depth_breakend_window if depth else args.pesr_breakend_window
            if not _sv_overlap_ok(e, t, recip, window):
                continue
            # closest by total breakend distance (ClosestSVFinder.java)
            dist = abs(e["start"] - t["start"]) + abs(e["end"] - t["end"])
            if best is None or dist < best_dist:
                best, best_dist = t, dist
        info = dict(v.info)
        fmt_keys = v.fmt_keys
        sample_fields = [dict(s) for s in v.samples]
        if best is not None:
            tv = best["v"]
            info["TRUTH_VID"] = tv.id if tv.id != "." else f"{tv.contig}_{tv.pos + 1}"
            lo = max(e["start"], best["start"])
            hi = min(e["end"], best["end"])
            inter = max(0, hi - lo + 1)
            e_len = e["end"] - e["start"] + 1
            t_len = best["end"] - best["start"] + 1
            info["TRUTH_RECIPROCAL_OVERLAP"] = f"{min(inter / e_len, inter / t_len):.4f}"
            info["TRUTH_SIZE_SIMILARITY"] = f"{min(e_len, t_len) / max(e_len, t_len):.4f}"
            info["TRUTH_DISTANCE_START"] = str(abs(e["start"] - best["start"]))
            info["TRUTH_DISTANCE_END"] = str(abs(e["end"] - best["end"]))
            # allele counts over truth genotypes
            t_ac = t_an = 0
            for g in best["sample_gts"].values():
                gt = g.get("GT", "./.").replace("|", "/")
                for a in gt.split("/"):
                    if a == ".":
                        continue
                    t_an += 1
                    if a != "0":
                        t_ac += 1
            info["TRUTH_AC"] = str(t_ac)
            info["TRUTH_AN"] = str(t_an)
            if t_an:
                info["TRUTH_AF"] = f"{t_ac / t_an:.6f}"
            # per-sample genotype concordance over shared samples
            shared = [s for s in eval_reader.samples if s in best["sample_gts"]]
            n = n_match = nonref = nonref_match = 0
            states = {"HET": [0, 0, 0], "HOM_VAR": [0, 0, 0]}  # [tp, eval_n, truth_n]
            cn_total = cn_equal = 0
            for si, s in enumerate(eval_reader.samples):
                eg = sample_fields[si]
                tg = best["sample_gts"].get(s)
                es, ts = _gt_state(eg), _gt_state(tg)
                if es is None or ts is None:
                    continue
                n += 1
                if es == ts:
                    n_match += 1
                if ts != "HOM_REF":
                    nonref += 1
                    if es == ts:
                        nonref_match += 1
                for st in states:
                    if es == st and ts == st:
                        states[st][0] += 1
                    if es == st:
                        states[st][1] += 1
                    if ts == st:
                        states[st][2] += 1
                if "CN" in eg and tg and "CN" in tg:
                    cn_total += 1
                    equal = eg["CN"] == tg["CN"]
                    cn_equal += equal
                    eg["TRUTH_CN_EQUAL"] = "1" if equal else "0"
            if n:
                info["GENOTYPE_CONCORDANCE"] = f"{n_match / n:.6f}"
            if nonref:
                info["NON_REF_GENOTYPE_CONCORDANCE"] = f"{nonref_match / nonref:.6f}"
            for st, key in (("HET", "HET"), ("HOM_VAR", "HOMVAR")):
                tp, en, tn = states[st]
                if en:
                    info[f"{key}_PPV"] = f"{tp / en:.6f}"
                if tn:
                    info[f"{key}_SENSITIVITY"] = f"{tp / tn:.6f}"
            var_tp = sum(states[s][0] for s in states)
            var_en = sum(states[s][1] for s in states)
            var_tn = sum(states[s][2] for s in states)
            if var_en:
                info["VAR_PPV"] = f"{var_tp / var_en:.6f}"
            if var_tn:
                info["VAR_SENSITIVITY"] = f"{var_tp / var_tn:.6f}"
            if cn_total:
                info["CNV_CONCORDANCE"] = f"{cn_equal / cn_total:.6f}"
            if cn_total and "TRUTH_CN_EQUAL" not in fmt_keys and "CN" in fmt_keys:
                fmt_keys = tuple(fmt_keys) + ("TRUTH_CN_EQUAL",)
        out_records.append(Variant(
            contig=v.contig, pos=v.pos, ref=v.ref, alts=v.alts, id=v.id,
            qual=v.qual, filters=v.filters, info=info, fmt_keys=fmt_keys,
            samples=sample_fields))

    extra = [
        f'##INFO=<ID={k},Number=1,Type={t},Description="{d}">'
        for k, t, d in (
            ("TRUTH_VID", "String", "Matching truth set variant id"),
            ("TRUTH_RECIPROCAL_OVERLAP", "Float", "Reciprocal overlap with the truth variant"),
            ("TRUTH_SIZE_SIMILARITY", "Float", "Size similarity with the truth variant"),
            ("TRUTH_DISTANCE_START", "Integer", "Start distance to the truth variant"),
            ("TRUTH_DISTANCE_END", "Integer", "End distance to the truth variant"),
            ("TRUTH_AC", "Integer", "Truth alt allele count"),
            ("TRUTH_AN", "Integer", "Truth allele number"),
            ("TRUTH_AF", "Float", "Truth alt allele frequency"),
            ("GENOTYPE_CONCORDANCE", "Float", "Genotype concordance with the truth variant"),
            ("NON_REF_GENOTYPE_CONCORDANCE", "Float", "Non-ref genotype concordance"),
            ("HET_PPV", "Float", "Het positive predictive value"),
            ("HET_SENSITIVITY", "Float", "Het sensitivity"),
            ("HOMVAR_PPV", "Float", "Hom-var positive predictive value"),
            ("HOMVAR_SENSITIVITY", "Float", "Hom-var sensitivity"),
            ("VAR_PPV", "Float", "Variant positive predictive value"),
            ("VAR_SENSITIVITY", "Float", "Variant sensitivity"),
            ("CNV_CONCORDANCE", "Float", "Copy-number concordance"),
        )
    ] + ['##FORMAT=<ID=TRUTH_CN_EQUAL,Number=1,Type=Integer,Description="Truth copy number equals eval">']
    w = vcfio.VcfWriter(args.output, eval_reader.samples,
                        extra_header_lines=eval_reader.header_lines + extra)
    matched = 0
    for v in out_records:
        matched += "TRUTH_VID" in v.info
        w.write(v)
    w.close()
    print(f"annotated {len(out_records)} eval records ({matched} matched truth) -> {args.output}")
    return 0


# ---------------------------------------------------------------------------
# JointGermlineCNVSegmentation (walkers/sv/JointGermlineCNVSegmentation.java)
# ---------------------------------------------------------------------------

@register_tool("JointGermlineCNVSegmentation")
def joint_germline_cnv_segmentation(argv):
    """Combine per-sample gCNV segment VCFs (PostprocessGermlineCNVCalls output)
    into a cohort CNV callset: per-sample defragmentation (merge same-CN
    segments within the padding fraction), cross-sample single-linkage
    clustering, joint records with per-sample CN genotypes and site AC/AN
    (JointGermlineCNVSegmentation.java; CNVDefragmenter defaults: padding
    fraction 0.25, sample overlap 0.8)."""
    from ..io import vcf as vcfio
    from ..io.vcf import Variant

    p = argparse.ArgumentParser(description="JointGermlineCNVSegmentation")
    p.add_argument("-V", "--variant", action="append", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("--defragmentation-padding-fraction", type=float, default=0.25)
    p.add_argument("--min-quality", type=int, default=20,
                   help="minimum per-segment QS to include")
    p.add_argument("--clustering-interval-overlap", type=float, default=0.8)
    p.add_argument("--clustering-breakend-window", type=int, default=10000000)
    args = p.parse_args(argv)

    # 1) load per-sample non-ref segments
    per_sample: dict[str, list] = {}
    ref_ploidy: dict[str, int] = {}
    for path in args.variant:
        reader = vcfio.VcfReader(path)
        sample = reader.samples[0] if reader.samples else "SAMPLE"
        segs = per_sample.setdefault(sample, [])
        for v in reader:
            g = v.samples[0] if v.samples else {}
            cn = g.get("CN")
            gt = g.get("GT", "./.")
            qs = int(g.get("QS", 0) or 0)
            if cn is None:
                continue
            cn = int(cn)
            end = int(v.info.get("END", v.pos + len(v.ref)))
            alt_types = [a.strip("<>") for a in v.alts if a.startswith("<")]
            is_var = gt.replace("|", "/") not in ("0", "0/0", "./.", ".") and (
                "DEL" in alt_types or "DUP" in alt_types)
            if not is_var:
                ref_ploidy.setdefault(sample, cn if cn > 0 else 2)
                continue
            if qs < args.min_quality:
                continue
            svtype = "DEL" if cn < ref_ploidy.get(sample, 2) else "DUP"
            segs.append(dict(contig=v.contig, start=v.pos + 1, end=end, cn=cn,
                             qs=qs, type=svtype))

    # 2) per-sample defragmentation
    pad = args.defragmentation_padding_fraction
    for sample, segs in per_sample.items():
        segs.sort(key=lambda s: (s["contig"], s["start"]))
        merged = []
        for s in segs:
            if merged:
                m = merged[-1]
                gap_ok = s["start"] - m["end"] - 1 <= pad * (
                    (m["end"] - m["start"] + 1) + (s["end"] - s["start"] + 1))
                if (m["contig"] == s["contig"] and m["cn"] == s["cn"] and gap_ok):
                    m["end"] = max(m["end"], s["end"])
                    m["qs"] = max(m["qs"], s["qs"])
                    continue
            merged.append(dict(s))
        per_sample[sample] = merged

    samples = sorted(per_sample)
    # 3) cross-sample single-linkage clustering
    flat = [dict(s, sample=sample) for sample in samples for s in per_sample[sample]]
    flat.sort(key=lambda s: (s["contig"], s["start"]))
    parent = list(range(len(flat)))

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    for i in range(len(flat)):
        a = flat[i]
        for j in range(i + 1, len(flat)):
            b = flat[j]
            if b["contig"] != a["contig"] or \
                    b["start"] - a["end"] > args.clustering_breakend_window:
                break
            if _sv_overlap_ok(a, b, args.clustering_interval_overlap,
                              args.clustering_breakend_window):
                parent[find(i)] = find(j)

    clusters: dict = {}
    for i in range(len(flat)):
        clusters.setdefault(find(i), []).append(flat[i])

    out = []
    for members in sorted(clusters.values(),
                          key=lambda ms: (ms[0]["contig"], min(m["start"] for m in ms))):
        starts = sorted(m["start"] for m in members)
        ends = sorted(m["end"] for m in members)
        start = starts[len(starts) // 2]
        end = ends[len(ends) // 2]
        svtype = members[0]["type"]
        by_sample = {}
        for m in members:
            cur = by_sample.get(m["sample"])
            if cur is None or m["qs"] > cur["qs"]:
                by_sample[m["sample"]] = m
        ac = len(by_sample)
        an = len(samples)
        gts = []
        for s in samples:
            m = by_sample.get(s)
            if m is None:
                gts.append({"GT": "0", "CN": str(ref_ploidy.get(s, 2))})
            else:
                gts.append({"GT": "1", "CN": str(m["cn"]), "QS": str(m["qs"])})
        out.append(Variant(
            contig=members[0]["contig"], pos=start - 1, ref="N",
            alts=(f"<{svtype}>",), id=f"CNV_{members[0]['contig']}_{start}_{end}",
            qual=None, filters=(),
            info={"END": str(end), "SVLEN": str(end - start + 1),
                  "SVTYPE": svtype, "AC": str(ac), "AN": str(an)},
            fmt_keys=("GT", "CN", "QS"), samples=gts))

    extra = [
        '##INFO=<ID=END,Number=1,Type=Integer,Description="End position">',
        '##INFO=<ID=SVLEN,Number=1,Type=Integer,Description="SV length">',
        '##INFO=<ID=SVTYPE,Number=1,Type=String,Description="SV type">',
        '##INFO=<ID=AC,Number=A,Type=Integer,Description="Allele count">',
        '##INFO=<ID=AN,Number=1,Type=Integer,Description="Allele number">',
        '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
        '##FORMAT=<ID=CN,Number=1,Type=Integer,Description="Copy number">',
        '##FORMAT=<ID=QS,Number=1,Type=Integer,Description="Segment quality">',
        '##ALT=<ID=DEL,Description="Deletion">',
        '##ALT=<ID=DUP,Description="Duplication">',
    ]
    w = vcfio.VcfWriter(args.output, samples, extra_header_lines=extra)
    for v in out:
        w.write(v)
    w.close()
    print(f"combined {len(flat)} segments from {len(samples)} samples into "
          f"{len(out)} CNV records -> {args.output}")
    return 0


@register_tool("SiteDepthtoBAF")
def site_depth_to_baf(argv):
    """Convert SiteDepth counts at biallelic SNP sites into BafEvidence:
    chi-square goodness-of-fit to the biallelic het model, then
    alt/(ref+alt) fraction (sv/SiteDepthtoBAF.java:171-190 calcBAF, exact
    chi-square on ref/alt depths with min-total-depth 10 and
    min-het-probability 0.5 defaults)."""
    import argparse as _ap
    import gzip as _gz
    import math as _math

    from ..io import vcf as vcfio

    p = _ap.ArgumentParser(description="SiteDepthtoBAF")
    p.add_argument("--site-depth", "-F", action="append", required=True,
                   help="SiteDepth tsv(.gz): contig pos sample dA dC dG dT")
    p.add_argument("--baf-sites-vcf", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("--min-total-depth", type=int, default=10)
    p.add_argument("--min-het-probability", type=float, default=0.5)
    args = p.parse_args(argv)
    base_idx = {b: i for i, b in enumerate("ACGT")}
    sites = {}
    for v in vcfio.VcfReader(args.baf_sites_vcf):
        if len(v.alts) == 1 and len(v.ref) == 1 and len(v.alts[0]) == 1:
            sites[(v.contig, v.pos + 1)] = (base_idx.get(v.ref.upper()),
                                            base_idx.get(v.alts[0].upper()))
    rows = []
    for path in args.site_depth:
        op = _gz.open if path.endswith(".gz") else open
        with op(path, "rt") as fh:
            for line in fh:
                if line.startswith("#"):
                    continue
                f = line.split()
                contig, pos, sample = f[0], int(f[1]), f[2]
                depths = [int(x) for x in f[3:7]]
                idx = sites.get((contig, pos))
                if idx is None or idx[0] is None or idx[1] is None:
                    continue
                ri, ai = idx
                total = sum(depths)
                if total < args.min_total_depth:
                    continue
                expect = total / 2.0
                chi_sq = ((depths[ri] - expect) ** 2 + (depths[ai] - expect) ** 2) / expect
                fit_prob = _math.erfc(_math.sqrt(chi_sq / 2.0))
                if fit_prob < args.min_het_probability:
                    continue
                rows.append((contig, pos, sample, depths[ai] / total))
    rows.sort()
    op = _gz.open if args.output.endswith(".gz") else open
    with op(args.output, "wt") as fh:
        for contig, pos, sample, baf in rows:
            fh.write(f"{contig}\t{pos - 1}\t{sample}\t{baf:.6g}\n")
    print(f"wrote {len(rows)} BAF records")
    return 0


@register_tool("CondenseDepthEvidence")
def condense_depth_evidence(argv):
    """Merge adjacent DepthEvidence bins into intervals up to
    --max-interval-size, summing per-sample counts
    (sv/CondenseDepthEvidence.java)."""
    import argparse as _ap
    import gzip as _gz

    p = _ap.ArgumentParser(description="CondenseDepthEvidence")
    p.add_argument("-F", "--depth-evidence", required=True,
                   help="rd.txt(.gz): contig start end counts...")
    p.add_argument("-O", "--output", required=True)
    p.add_argument("--max-interval-size", type=int, default=1000)
    p.add_argument("--min-interval-size", type=int, default=0)
    args = p.parse_args(argv)
    if args.min_interval_size > args.max_interval_size:
        raise UserError("Minimum interval length exceeds maximum interval length.")
    op = _gz.open if args.depth_evidence.endswith(".gz") else open
    header_lines = []
    acc = None
    out_rows = []

    def flush():
        nonlocal acc
        if acc is not None and acc[2] - acc[1] >= args.min_interval_size:
            out_rows.append(acc)
        acc = None

    with op(args.depth_evidence, "rt") as fh:
        for line in fh:
            if line.startswith("#"):
                header_lines.append(line)
                continue
            f = line.split()
            contig, start, end = f[0], int(f[1]), int(f[2])
            counts = [int(x) for x in f[3:]]
            if acc is not None and acc[0] == contig and acc[2] == start \
                    and (end - acc[1]) <= args.max_interval_size \
                    and len(counts) == len(acc[3]):
                acc = (contig, acc[1], end,
                       [a + b for a, b in zip(acc[3], counts)])
            else:
                flush()
                acc = (contig, start, end, counts)
    flush()
    opw = _gz.open if args.output.endswith(".gz") else open
    with opw(args.output, "wt") as fh:
        for h in header_lines:
            fh.write(h)
        for contig, start, end, counts in out_rows:
            fh.write("\t".join([contig, str(start), str(end)] +
                               [str(c) for c in counts]) + "\n")
    print(f"condensed to {len(out_rows)} intervals")
    return 0


def _load_strata(config_path, tracks):
    """Parse the stratification config TSV: NAME SVTYPE MIN_SIZE MAX_SIZE
    TRACKS (sv/stratify/SVStratificationEngine.java:140-155). tracks: dict
    name -> list[(contig, start, end)]."""
    strata = []
    with open(config_path) as fh:
        header = None
        for line in fh:
            f = line.rstrip("\n").split("\t")
            if header is None:
                header = [c.upper() for c in f]
                continue
            if not line.strip():
                continue
            row = dict(zip(header, f))
            min_size = row.get("MIN_SIZE", "")
            max_size = row.get("MAX_SIZE", "")
            track_names = [t for t in row.get("TRACKS", "").split(",") if t and t != "NULL"]
            for t in track_names:
                if t not in tracks:
                    from ..cli import UserError

                    raise UserError(f"stratification track {t} not provided")
            strata.append(dict(
                name=row["NAME"],
                svtype=row.get("SVTYPE") or None,
                min_size=int(min_size) if min_size not in ("", "-1", "NULL") else None,
                max_size=int(max_size) if max_size not in ("", "-1", "NULL") else None,
                tracks=track_names))
    return strata


def _stratum_matches(stratum, contig, start, end, svtype, tracks,
                     overlap_fraction=0.0):
    """Stratum.matches (SVStratificationEngine.java:116-125): type, size range
    [min, max), and minimum overlap fraction with every named track."""
    if stratum["svtype"] is not None and svtype != stratum["svtype"]:
        return False
    size = max(0, end - start)
    if stratum["min_size"] is not None and size < stratum["min_size"]:
        return False
    if stratum["max_size"] is not None and size >= stratum["max_size"]:
        return False
    for t in stratum["tracks"]:
        spans = [s for s in tracks[t] if s[0] == contig]
        cov = sum(max(0, min(end, e) - max(start, s)) for _c, s, e in spans)
        denom = max(1, size)
        if cov / denom < max(overlap_fraction, 1e-9):
            return False
    return True


@register_tool("SVStratify")
def sv_stratify(argv):
    """Annotate SV records with stratification-group names (STRAT INFO key)
    from a NAME/SVTYPE/MIN_SIZE/MAX_SIZE/TRACKS config, optionally splitting
    one VCF per group (walkers/sv/SVStratify.java)."""
    from ..cli import UserError
    from ..engine import intervals as iv
    from ..io import vcf as vcfio

    p = argparse.ArgumentParser(description="SVStratify")
    p.add_argument("-V", "--variant", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("--stratify-config", required=True)
    p.add_argument("--track-name", action="append", default=[])
    p.add_argument("--track-intervals", action="append", default=[])
    p.add_argument("--stratify-overlap-fraction", type=float, default=0.0)
    p.add_argument("--split-output", action="store_true")
    p.add_argument("--output-prefix", default="stratified")
    args = p.parse_args(argv)
    if len(args.track_name) != len(args.track_intervals):
        raise UserError("--track-name and --track-intervals must pair up")
    tracks = {}
    for name, path in zip(args.track_name, args.track_intervals):
        tracks[name] = [(t.contig, t.start, t.end)
                        for t in iv.load_interval_file(path)]
    strata = _load_strata(args.stratify_config, tracks)
    reader = vcfio.VcfReader(args.variant)
    headers = list(reader.header_lines) + [
        '##INFO=<ID=STRAT,Number=.,Type=String,Description="Stratification groups">']
    writers = {}
    if args.split_output:
        import os

        os.makedirs(args.output, exist_ok=True)
        for st in strata + [dict(name="default")]:
            writers[st["name"]] = vcfio.VcfWriter(
                f"{args.output}/{args.output_prefix}.{st['name']}.vcf",
                reader.samples, extra_header_lines=headers)
    else:
        writers[None] = vcfio.VcfWriter(args.output, reader.samples,
                                        extra_header_lines=headers)
    n = 0
    for v in reader:
        svtype = str(v.info.get("SVTYPE", "BND"))
        end = int(v.info.get("END", v.pos + len(v.ref)))
        groups = [st["name"] for st in strata
                  if _stratum_matches(st, v.contig, v.pos, end, svtype, tracks,
                                      args.stratify_overlap_fraction)]
        if not groups:
            groups = ["default"]
        info = dict(v.info)
        info["STRAT"] = ",".join(groups)
        v.info = info
        if args.split_output:
            for g in groups:
                writers[g].write(v)
        else:
            writers[None].write(v)
        n += 1
    for w in writers.values():
        w.close()
    print(f"stratified {n} records into {len(strata)} groups (+default)")
    return 0


@register_tool("GroupedSVCluster")
def grouped_sv_cluster(argv):
    """Cluster SVs separately within each stratification group
    (walkers/sv/GroupedSVCluster.java): records are stratified as in
    SVStratify, then each group is clustered with SVCluster and the results
    merged in coordinate order."""
    import os
    import tempfile

    from ..cli import TOOL_REGISTRY
    from ..engine import intervals as iv
    from ..io import vcf as vcfio

    p = argparse.ArgumentParser(description="GroupedSVCluster")
    p.add_argument("-V", "--variant", action="append", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("--stratify-config", required=True)
    p.add_argument("--track-name", action="append", default=[])
    p.add_argument("--track-intervals", action="append", default=[])
    p.add_argument("--depth-interval-overlap", type=float, default=0.8)
    p.add_argument("--pesr-interval-overlap", type=float, default=0.5)
    p.add_argument("--pesr-breakend-window", type=int, default=500)
    args = p.parse_args(argv)
    tracks = {}
    for name, path in zip(args.track_name, args.track_intervals):
        tracks[name] = [(t.contig, t.start, t.end)
                        for t in iv.load_interval_file(path)]
    strata = _load_strata(args.stratify_config, tracks)
    # bucket records per group
    groups: dict = {st["name"]: [] for st in strata}
    groups["default"] = []
    samples = None
    headers = None
    for path in args.variant:
        reader = vcfio.VcfReader(path)
        samples = samples or reader.samples
        headers = headers or reader.header_lines
        for v in reader:
            svtype = str(v.info.get("SVTYPE", "BND"))
            end = int(v.info.get("END", v.pos + len(v.ref)))
            matched = [st["name"] for st in strata
                       if _stratum_matches(st, v.contig, v.pos, end, svtype, tracks)]
            groups[matched[0] if matched else "default"].append(v)
    out_records = []
    with tempfile.TemporaryDirectory() as td:
        for gname, records in groups.items():
            if not records:
                continue
            gin = os.path.join(td, f"{gname}.vcf")
            gout = os.path.join(td, f"{gname}.out.vcf")
            w = vcfio.VcfWriter(gin, samples, extra_header_lines=headers)
            for v in records:
                w.write(v)
            w.close()
            TOOL_REGISTRY["SVCluster"]([
                "-V", gin, "-O", gout,
                "--depth-interval-overlap", str(args.depth_interval_overlap),
                "--pesr-interval-overlap", str(args.pesr_interval_overlap),
                "--pesr-breakend-window", str(args.pesr_breakend_window),
                "--variant-prefix", f"SV_{gname}_"])
            out_records.extend(vcfio.VcfReader(gout))
    out_records.sort(key=lambda v: (v.contig, v.pos))
    w = vcfio.VcfWriter(args.output, samples or [], extra_header_lines=headers or [])
    for v in out_records:
        w.write(v)
    w.close()
    print(f"clustered {sum(len(g) for g in groups.values())} records "
          f"-> {len(out_records)} across {len(groups)} strata")
    return 0
