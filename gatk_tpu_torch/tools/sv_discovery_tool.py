# Copied verbatim from gatk_tpu/tools/sv_discovery_tool.py; only import lines may differ.
"""Structural-variant discovery from assembled-contig alignments.

Reference behavior: tools/StructuralVariantDiscoverer.java (+ the
spark/sv/discovery chimeric-alignment machinery it drives): take
queryname-grouped alignments of locally-assembled contigs, find contigs whose
split alignments (or large CIGAR gaps) indicate a novel adjacency, classify the
adjacency into simple SV types, and emit VCF records:

  same-strand split, reference gap >> contig gap          -> DEL
  same-strand split, contig gap >> reference gap          -> INS
  same-strand split, reference overlap (ref walk-back)    -> tandem DUP
  strand flip within a contig                             -> INV (both BPs)
  different chromosomes                                   -> BND mates

Novel adjacencies seen in multiple contigs are merged (evidence count in the
CTGS info field), mirroring simpleEvidenceForNovelAdjacencyMap de-duplication.
"""
from __future__ import annotations

import argparse
from dataclasses import dataclass

import numpy as np

from ..cli import UserError, register_tool
from ..io import sam, vcf

MIN_SV_SIZE = 50  # StructuralVariationDiscoveryArgumentCollection default
MIN_ALIGNMENT_LENGTH = 50


@dataclass
class ContigAlignment:
    """One alignment of an assembled contig (AlignmentInterval equivalent)."""
    ref_id: int
    contig: str
    ref_start: int  # 0-based
    ref_end: int
    is_reverse: bool
    read_start: int  # contig coordinates (forward-strand contig space)
    read_end: int
    mapq: int


def _contig_interval(read, header):
    """Contig-space [start, end) of the aligned bases, on the contig's forward
    strand (AlignmentInterval.startInAssembledContig semantics)."""
    lead = trail = 0
    ops, lens = read.cigar_ops, read.cigar_lens
    n = len(ops)
    if n and ops[0] in (sam.OP_S, sam.OP_H):
        lead = int(lens[0])
    if n > 1 and ops[n - 1] in (sam.OP_S, sam.OP_H):
        trail = int(lens[n - 1])
    aligned = sum(int(l) for o, l in zip(ops, lens)
                  if sam.CONSUMES_READ[o] and o not in (sam.OP_S, sam.OP_H))
    total = lead + aligned + trail
    if read.is_reverse:
        start = trail  # clips are in read orientation; flip to contig forward
    else:
        start = lead
    return start, start + aligned, total


def _collect_alignments(reads, header):
    out = []
    for r in reads:
        if r.is_unmapped or (r.flag & 0x100):
            continue
        cs, ce, _total = _contig_interval(r, header)
        if ce - cs < MIN_ALIGNMENT_LENGTH:
            continue
        out.append(ContigAlignment(
            ref_id=r.ref_id, contig=header.sequences[r.ref_id].name,
            ref_start=int(r.pos), ref_end=int(r.end), is_reverse=r.is_reverse,
            read_start=cs, read_end=ce, mapq=int(r.mapq)))
    out.sort(key=lambda a: a.read_start)
    return out


def _classify_pair(a1, a2, min_size):
    """Novel-adjacency classification for two contig-adjacent alignments
    (BreakpointsInference + SimpleChimera.inferType equivalents). Returns
    (svtype, contig, pos, end, svlen) or None."""
    read_gap = a2.read_start - a1.read_end
    # redundant/overlapping alignments of the same contig stretch are not a
    # chimera (filterSecondaryConfigurations): skip pairs whose contig
    # intervals overlap by more than half of the shorter one
    overlap = min(a1.read_end, a2.read_end) - max(a1.read_start, a2.read_start)
    shorter = min(a1.read_end - a1.read_start, a2.read_end - a2.read_start)
    if overlap > 0.5 * shorter:
        return None
    if a1.contig != a2.contig:
        # inter-chromosomal adjacency -> BND pair
        bp1 = a1.ref_start if a1.is_reverse else a1.ref_end - 1
        bp2 = a2.ref_end - 1 if a2.is_reverse else a2.ref_start
        return ("BND", a1.contig, bp1, (a2.contig, bp2), 0)
    if a1.is_reverse != a2.is_reverse:
        # intra-chromosomal strand flip -> inversion breakpoint
        lo = min(a1.ref_start, a2.ref_start)
        hi = max(a1.ref_end, a2.ref_end)
        if hi - lo < min_size:
            return None
        return ("INV", a1.contig, lo, hi, hi - lo)
    # same strand: orient ref coordinates along the contig walk
    if not a1.is_reverse:
        ref_gap = a2.ref_start - a1.ref_end
        left_end = a1.ref_end
    else:
        ref_gap = a1.ref_start - a2.ref_end
        left_end = a2.ref_end
    delta = ref_gap - read_gap
    if delta >= min_size and ref_gap > 0:
        # reference skips ahead -> deletion of `delta` bases (negative
        # read_gap = junction micro-homology, folded into delta)
        pos = left_end - 1
        return ("DEL", a1.contig, pos, pos + delta, -delta)
    if -delta >= min_size and read_gap > 0:
        # contig has extra sequence -> insertion at the junction
        pos = left_end - 1
        return ("INS", a1.contig, pos, pos + 1, -delta)
    if ref_gap < 0 and -ref_gap >= min_size:
        # reference walks backwards -> tandem duplication of the overlap
        dup_lo = (a2.ref_start if not a1.is_reverse else a1.ref_start)
        dup_hi = (a1.ref_end if not a1.is_reverse else a2.ref_end)
        return ("DUP", a1.contig, dup_lo, dup_hi, dup_hi - dup_lo)
    return None


@register_tool("StructuralVariantDiscoverer")
def structural_variant_discoverer(argv):
    """Call SVs/breakpoints from split alignments of assembled contigs
    (tools/StructuralVariantDiscoverer.java)."""
    p = argparse.ArgumentParser(description="StructuralVariantDiscoverer")
    p.add_argument("-I", "--input", required=True,
                   help="queryname-sorted/grouped contig alignments (BAM)")
    p.add_argument("-R", "--reference", default=None)
    p.add_argument("--outputVCFName", "-O", dest="output", required=True)
    p.add_argument("--min-svsize", type=int, default=MIN_SV_SIZE)
    p.add_argument("--min-mapq", type=int, default=20)
    args = p.parse_args(argv)

    from ..io import fasta
    from ..io.cram import open_reads

    ref = fasta.FastaReference(args.reference) if args.reference else None
    rd = open_reads(args.input, reference=ref)
    header = rd.header
    sample = header.read_groups[0].get("SM", "SAMPLE") if header.read_groups else "SAMPLE"

    # queryname grouping (the tool requires queryname-sorted input)
    adjacencies = {}  # key -> dict(record fields, ctgs)
    cur_name, cur_reads = None, []

    def process(name, reads):
        alns = _collect_alignments(reads, header)
        alns = [a for a in alns if a.mapq >= args.min_mapq]
        for a1, a2 in zip(alns, alns[1:]):
            res = _classify_pair(a1, a2, args.min_svsize)
            if res is None:
                continue
            svtype, contig, pos, end, svlen = res
            key = (svtype, contig, pos, end if not isinstance(end, tuple) else end)
            rec = adjacencies.setdefault(
                key, dict(svtype=svtype, contig=contig, pos=pos, end=end,
                          svlen=svlen, ctgs=set()))
            rec["ctgs"].add(name)

    seen_names = set()
    for r in rd:
        if r.name != cur_name:
            if cur_reads:
                process(cur_name, cur_reads)
            if r.name in seen_names:
                raise UserError("input is not queryname-grouped "
                                "(contig name seen twice non-adjacently)")
            seen_names.add(r.name)
            cur_name, cur_reads = r.name, []
        cur_reads.append(r)
    if cur_reads:
        process(cur_name, cur_reads)

    headers = [
        '##INFO=<ID=SVTYPE,Number=1,Type=String,Description="Type of structural variant">',
        '##INFO=<ID=SVLEN,Number=1,Type=Integer,Description="SV length">',
        '##INFO=<ID=END,Number=1,Type=Integer,Description="End position">',
        '##INFO=<ID=CTGS,Number=.,Type=String,Description="Evidence contig names">',
        '##INFO=<ID=MATEID,Number=1,Type=String,Description="Mate breakend">',
        '##ALT=<ID=DEL,Description="Deletion">',
        '##ALT=<ID=INS,Description="Insertion">',
        '##ALT=<ID=DUP,Description="Tandem duplication">',
        '##ALT=<ID=INV,Description="Inversion">',
    ]
    contigs = [(s.name, s.length) for s in header.sequences]
    w = vcf.VcfWriter(args.output, [sample], contigs=contigs,
                      extra_header_lines=headers)
    records = []
    for key, rec in adjacencies.items():
        contig, pos = rec["contig"], rec["pos"]
        ref_base = "N"
        if ref is not None:
            ref_base = chr(ref.fetch(contig, pos, pos + 1)[0]).upper()
        info = {"SVTYPE": rec["svtype"], "CTGS": ",".join(sorted(rec["ctgs"]))}
        if rec["svtype"] == "BND":
            mate_contig, mate_pos = rec["end"]
            alt = f"{ref_base}]{mate_contig}:{mate_pos + 1}]"
            vid = f"BND_{contig}_{pos + 1}"
            info["MATEID"] = f"BND_{mate_contig}_{mate_pos + 1}"
            records.append(vcf.Variant(contig, pos, ref_base, (alt,), id=vid,
                                       qual=None, info=info,
                                       samples=[{"GT": "./."}], fmt_keys=("GT",)))
            continue
        info["END"] = str(rec["end"])
        info["SVLEN"] = str(rec["svlen"])
        vid = f"{rec['svtype']}_{contig}_{pos + 1}_{rec['end']}"
        records.append(vcf.Variant(contig, pos, ref_base,
                                   (f"<{rec['svtype']}>",), id=vid, qual=None,
                                   info=info, samples=[{"GT": "./."}],
                                   fmt_keys=("GT",)))
    order = {name: i for i, (name, _) in enumerate(contigs)}
    records.sort(key=lambda v: (order.get(v.contig, 1 << 30), v.pos))
    for v in records:
        w.write(v)
    w.close()
    print(f"StructuralVariantDiscoverer: {len(records)} SV records "
          f"from {len(seen_names)} contigs -> {args.output}")
    return 0


# ---------------------------------------------------------------------------
# Full SV discovery pipeline from a BAM (the legacy Spark pipeline's
# evidence -> local assembly -> contig alignment -> breakpoint chain)
# ---------------------------------------------------------------------------

MIN_SOFTCLIP_EVIDENCE = 30  # FindBreakpointEvidenceSpark min clipped length
EVIDENCE_CLUSTER_WINDOW = 500
MIN_EVIDENCE_COUNT = 2
ASSEMBLY_FLANK = 600


def _evidence_sites(rd, min_mapq):
    """Split-read / discordant-pair evidence loci
    (FindBreakpointEvidenceSpark's BreakpointEvidence classes, reduced to
    softclip boundaries, SA-tagged splits, and distant/interchromosomal
    mates). Returns {contig: sorted [positions]}."""
    from ..io import sam as sam_mod

    sites = {}
    for r in rd:
        if r.is_unmapped or r.is_duplicate or r.is_secondary or r.mapq < min_mapq:
            continue
        contig = rd.header.sequences[r.ref_id].name
        ops, lens = r.cigar_ops, r.cigar_lens
        n = len(ops)
        if n and ops[0] == sam_mod.OP_S and int(lens[0]) >= MIN_SOFTCLIP_EVIDENCE:
            sites.setdefault(contig, []).append(int(r.pos))
        if n and ops[n - 1] == sam_mod.OP_S and int(lens[n - 1]) >= MIN_SOFTCLIP_EVIDENCE:
            sites.setdefault(contig, []).append(int(r.end))
        if (getattr(r, "tags", None) or {}).get("SA"):
            sites.setdefault(contig, []).append(int(r.pos))
        if (r.is_paired and not r.mate_is_unmapped
                and (r.mate_ref_id != r.ref_id or abs(r.tlen) > 10000)):
            sites.setdefault(contig, []).append(int(r.end))
    return {c: sorted(v) for c, v in sites.items()}


def _merge_external_evidence(sites, path, weight):
    """BreakpointEvidence.ExternalEvidence integration
    (FindBreakpointEvidenceSpark.readExternalEvidence:413): externally-supplied
    intervals enter the evidence stream with the configured weight, so
    clusters form at those loci even when internal read evidence alone is
    below threshold. Accepts BED (0-based) or 'contig:start-end' lines."""
    with open(path) as fh:
        for ln in fh:
            ln = ln.split("#", 1)[0].strip()
            if not ln:
                continue
            if ":" in ln and "\t" not in ln and " " not in ln:
                contig, span = ln.split(":", 1)
                s, e = span.split("-")
                lo, hi = int(s) - 1, int(e)
            else:
                f = ln.split()
                contig, lo, hi = f[0], int(f[1]), int(f[2])
            mid = (lo + hi) // 2
            sites.setdefault(contig, []).extend([mid] * weight)
    for c in sites:
        sites[c].sort()


def _cluster_sites(positions, window, min_count):
    """Greedy 1-D clustering of evidence positions."""
    clusters = []
    cur = []
    for p in positions:
        if cur and p - cur[-1] > window:
            if len(cur) >= min_count:
                clusters.append((cur[0], cur[-1]))
            cur = []
        cur.append(p)
    if len(cur) >= min_count:
        clusters.append((cur[0], cur[-1]))
    return clusters


def _alignment_blocks(aln, ref_bases_full, contig_bases):
    """Cigar blocks annotated with identity: [op, ln, identity, ref_i, q_i]."""
    blocks = []
    qi = 0
    ri = aln.pos
    ops = [(int(o), int(l)) for o, l in zip(aln.cigar_ops, aln.cigar_lens)]
    if ops and ops[0][0] == sam.OP_S:
        qi = ops[0][1]
        ops = ops[1:]
    if ops and ops[-1][0] == sam.OP_S:
        ops = ops[:-1]
    for op, ln in ops:
        if op in (sam.OP_M, sam.OP_EQ, sam.OP_X):
            a = ref_bases_full[ri : ri + ln]
            b = contig_bases[qi : qi + ln]
            n = min(len(a), len(b))
            ident = float(np.mean(np.asarray(a[:n]) == np.asarray(b[:n]))) if n else 0.0
            blocks.append([op, ln, ident, ri, qi])
            ri += ln
            qi += ln
        elif op == sam.OP_I:
            blocks.append([op, ln, 0.0, ri, qi])
            qi += ln
        elif op == sam.OP_D:
            blocks.append([op, ln, 0.0, ri, qi])
            ri += ln
    return blocks


def _gap_adjacencies(aln, ref_bases_full, contig_bases, min_size, min_block=30):
    """Large in-alignment gaps as novel adjacencies (the 'large gaps
    indicating breakpoints' half of StructuralVariantDiscoverer): coalesce
    consecutive low-identity/indel blocks between two high-identity anchors
    (>= min_block M at >= 0.9 identity) and classify the net ref-vs-contig
    span difference. Returns [(svtype, pos, end, svlen)]."""
    blocks = _alignment_blocks(aln, ref_bases_full, contig_bases)

    def is_anchor(b):
        return b[0] == sam.OP_M and b[1] >= min_block and b[2] >= 0.9

    out = []
    anchors = [i for i, b in enumerate(blocks) if is_anchor(b)]
    for i0, i1 in zip(anchors, anchors[1:]):
        if i1 == i0 + 1:
            continue
        seg = blocks[i0 + 1 : i1]
        ref_span = blocks[i1][3] - (blocks[i0][3] + blocks[i0][1])
        q_span = blocks[i1][4] - (blocks[i0][4] + blocks[i0][1])
        delta = ref_span - q_span
        pos = blocks[i0][3] + blocks[i0][1] - 1
        if delta >= min_size:
            out.append(("DEL", pos, pos + delta, -delta))
        elif -delta >= min_size:
            out.append(("INS", pos, pos + 1, -delta))
    return out


def _trim_noisy_ends(aln, ref_bases_full, contig_bases, min_block=30):
    """Trim low-identity end blocks off a banded-SW contig alignment: the SW
    can chain weak positive-scoring noise past a breakpoint junction; real
    split alignments have near-perfect cores (anchored at >= min_block M
    blocks of >= 0.9 identity). Returns
    (lead_clip, aligned_len, ref_start, ref_end) in contig/ref coords."""
    blocks = _alignment_blocks(aln, ref_bases_full, contig_bases)

    def is_anchor(b):
        return b[0] == sam.OP_M and b[1] >= min_block and b[2] >= 0.9

    while blocks and not is_anchor(blocks[-1]):
        blocks.pop()
    while blocks and not is_anchor(blocks[0]):
        blocks.pop(0)
    if not blocks:
        return None
    first, last = blocks[0], blocks[-1]
    ref_start = first[3]
    ref_end = last[3] + last[1]
    q_start = first[4]
    q_end = last[4] + last[1]
    return q_start, q_end - q_start, ref_start, ref_end


@register_tool("StructuralVariationDiscoveryPipelineSpark")
def structural_variation_discovery_pipeline(argv):
    """End-to-end SV discovery from a BAM
    (tools/spark/sv/StructuralVariationDiscoveryPipelineSpark.java, re-designed
    single-binary): split-read/discordant-pair evidence scan -> evidence
    clustering -> local re-assembly of each breakpoint neighborhood
    (ReadThreadingAssembler standing in for fermi-lite) -> assembled-contig
    realignment over the whole reference (seed-extend aligner standing in for
    bwa-mem) -> novel-adjacency classification (the StructuralVariantDiscoverer
    machinery above) -> VCF."""
    p = argparse.ArgumentParser(description="StructuralVariationDiscoveryPipelineSpark")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-R", "--reference", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("--min-svsize", type=int, default=MIN_SV_SIZE)
    p.add_argument("--min-mapq", type=int, default=20)
    p.add_argument("--min-evidence-count", type=int, default=MIN_EVIDENCE_COUNT)
    # accepted-and-ignored Spark runner flags (single-binary SPMD runtime)
    p.add_argument("--spark-master", default=None)
    p.add_argument("--aligner-index-image", default=None)
    args, _unknown = p.parse_known_args(argv)

    from ..align.seed_extend import SeedExtendAligner
    from ..assembly import assembler as asm_mod
    from ..io import fasta
    from ..io.cram import open_reads

    ref = fasta.FastaReference(args.reference)
    rd = open_reads(args.input, reference=ref)
    header = rd.header
    sample = header.read_groups[0].get("SM", "SAMPLE") if header.read_groups else "SAMPLE"
    sites = _evidence_sites(rd, args.min_mapq)
    aligner = SeedExtendAligner(
        [(name, ref.fetch(name, 0, ref.contig_length(name)))
         for name in ref.contigs()])
    contig_index = {name: i for i, name in enumerate(ref.contigs())}

    adjacencies = {}
    n_clusters = n_contigs = 0
    for contig, positions in sites.items():
        contig_len = ref.contig_length(contig)
        for lo, hi in _cluster_sites(positions, EVIDENCE_CLUSTER_WINDOW,
                                     args.min_evidence_count):
            n_clusters += 1
            w_lo = max(0, lo - ASSEMBLY_FLANK)
            w_hi = min(contig_len, hi + ASSEMBLY_FLANK)
            reads = [r for r in rd.query(contig, w_lo, w_hi)
                     if not r.is_unmapped and not r.is_duplicate
                     and not r.is_secondary]
            if not reads:
                continue
            ref_bases = ref.fetch(contig, w_lo, w_hi)
            result = asm_mod.assemble(reads, ref_bases, w_lo)
            # realign every non-ref assembled contig over the whole reference
            for hap in result.haplotypes[1:]:
                n_contigs += 1
                # low min_score_frac: a split contig's PARTIAL alignments are
                # the signal (each side scores ~its fraction of the contig)
                alns = aligner.align_all(
                    np.frombuffer(bytes(hap.bases), np.uint8),
                    min_score_frac=0.15)
                cas = []
                hap_arr = np.frombuffer(bytes(hap.bases), np.uint8)
                for a in alns:
                    aln_contig = ref.contigs()[a.contig_index]
                    ref_full = ref.fetch(aln_contig, 0,
                                         ref.contig_length(aln_contig))
                    q = hap_arr[::-1] if a.is_reverse else hap_arr
                    # seed-extend revcomp: complement too
                    if a.is_reverse:
                        from ..align.seed_extend import revcomp
                        q = revcomp(hap_arr)
                    # large in-alignment gaps are adjacencies in their own
                    # right (the banded SW folds mid-size SVs into one
                    # alignment's cigar)
                    name = f"asm_{contig}_{lo}_{n_contigs}"
                    for svtype, pos, end, svlen in _gap_adjacencies(
                            a, ref_full, q, args.min_svsize):
                        key = (svtype, aln_contig, pos, end)
                        rec = adjacencies.setdefault(
                            key, dict(svtype=svtype, contig=aln_contig,
                                      pos=pos, end=end, svlen=svlen,
                                      ctgs=set()))
                        rec["ctgs"].add(name)
                    trimmed = _trim_noisy_ends(a, ref_full, q)
                    if trimmed is None:
                        continue
                    q_start, aligned, ref_start, ref_end = trimmed
                    if aligned < MIN_ALIGNMENT_LENGTH:
                        continue
                    # contig-forward coords (flip for reverse alignments)
                    cs = (len(hap_arr) - (q_start + aligned)) if a.is_reverse \
                        else q_start
                    cas.append(ContigAlignment(
                        ref_id=a.contig_index, contig=aln_contig,
                        ref_start=ref_start, ref_end=ref_end,
                        is_reverse=a.is_reverse,
                        read_start=cs, read_end=cs + aligned, mapq=60))
                cas.sort(key=lambda x: x.read_start)
                name = f"asm_{contig}_{lo}_{n_contigs}"
                for a1, a2 in zip(cas, cas[1:]):
                    res = _classify_pair(a1, a2, args.min_svsize)
                    if res is None:
                        continue
                    svtype, vcontig, pos, end, svlen = res
                    key = (svtype, vcontig, pos,
                           end if not isinstance(end, tuple) else end)
                    rec = adjacencies.setdefault(
                        key, dict(svtype=svtype, contig=vcontig, pos=pos,
                                  end=end, svlen=svlen, ctgs=set()))
                    rec["ctgs"].add(name)

    # read-pair-only imprecise deletions for links no assembled contig explains
    precise_spans = [(contig_index.get(rec["contig"], -1), rec["pos"],
                      rec["end"] if not isinstance(rec["end"], tuple)
                      else rec["pos"] + 1)
                     for rec in adjacencies.values()]
    imprecise = _imprecise_deletions(rd, args.min_mapq, precise_spans)
    _write_sv_vcf(args.output, adjacencies, ref, sample, imprecise=imprecise)
    print(f"SV pipeline: {n_clusters} evidence clusters, {n_contigs} assembled "
          f"contigs, {len(adjacencies)} SV records + {len(imprecise)} "
          f"imprecise deletions -> {args.output}")
    return 0


IMPRECISE_EVIDENCE_THRESHOLD = 7      # DEFAULT_IMPRECISE_VARIANT_EVIDENCE_THRESHOLD
MAX_IMPRECISE_DELETION_SIZE = 15000   # DEFAULT_MAX_CALLABLE_IMPRECISE_DELETION_SIZE


def _imprecise_deletions(rd, min_mapq, precise_spans,
                         evidence_threshold=IMPRECISE_EVIDENCE_THRESHOLD,
                         max_size=MAX_IMPRECISE_DELETION_SIZE):
    """Imprecise deletions from read-pair-only evidence
    (discovery/inference/ImpreciseVariantDetector.java:20-49 +
    EvidenceTargetLink.isImpreciseDeletion:111): cluster outward-facing
    long-fragment FR pairs into left(+)/right(-) stranded interval links; a
    link with > threshold supporting pairs, inner distance < max_size, and no
    overlapping assembly-based call becomes an IMPRECISE <DEL> with CIPOS /
    CIEND from the cluster interval spreads."""
    # library fragment-size stats (ReadMetadata's per-library zscore, reduced
    # to a median + MAD cutoff over sampled proper pairs)
    tlens = []
    pairs = []
    for r in rd:
        if (r.is_unmapped or r.is_duplicate or r.is_secondary
                or r.is_supplementary or r.mapq < min_mapq or not r.is_paired
                or r.mate_is_unmapped or r.mate_ref_id != r.ref_id):
            continue
        if r.is_reverse or not (r.flag & 0x20):  # keep FR-forward anchor only
            continue
        if r.tlen <= 0:
            continue
        if len(tlens) < 100000:
            tlens.append(r.tlen)
        pairs.append((r.ref_id, int(r.pos), int(r.end), int(r.mate_pos),
                      len(r.bases)))
    if not tlens:
        return []
    arr = np.asarray(tlens, np.float64)
    med = float(np.median(arr))
    mad = float(np.median(np.abs(arr - med))) or 1.0
    cutoff = med + 3 * 1.4826 * mad
    # discordant long-fragment FR pairs: deletion-spanning candidates
    cands = [(rid, s, e, mp, rl) for rid, s, e, mp, rl in pairs
             if (mp + rl) - s > cutoff]
    cands.sort()
    out = []
    cluster = []

    def flush(cluster):
        if len(cluster) <= evidence_threshold:
            return
        rid = cluster[0][0]
        l_lo = min(c[1] for c in cluster)
        l_hi = max(c[2] for c in cluster)
        r_lo = min(c[3] for c in cluster)
        r_hi = max(c[3] + c[4] for c in cluster)
        if r_lo - l_hi <= 0 or r_hi - l_lo > max_size + (l_hi - l_lo) + (r_hi - r_lo):
            return
        pos = (l_lo + l_hi) // 2
        end = (r_lo + r_hi) // 2
        if end - pos <= 0 or end - pos >= max_size:
            return
        for pc_rid, pc_lo, pc_hi in precise_spans:
            if pc_rid == rid and pc_lo <= end and pc_hi >= pos:
                return  # an assembly-based call already explains this link
        out.append(dict(ref_id=rid, pos=pos, end=end,
                        svlen=-(end - pos), n_pairs=len(cluster),
                        cipos=(l_lo - pos, l_hi - pos),
                        ciend=(r_lo - end, r_hi - end)))

    for c in cands:
        if cluster and (c[0] != cluster[-1][0]
                        or c[1] > cluster[-1][2]  # left intervals must overlap
                        or abs(c[3] - cluster[-1][3]) > 1000):
            flush(cluster)
            cluster = []
        cluster.append(c)
    flush(cluster)
    return out


def _write_sv_vcf(output, adjacencies, ref, sample, imprecise=()):
    """Shared SV VCF writer (StructuralVariantDiscoverer output path)."""
    headers = [
        '##INFO=<ID=SVTYPE,Number=1,Type=String,Description="Type of structural variant">',
        '##INFO=<ID=SVLEN,Number=1,Type=Integer,Description="SV length">',
        '##INFO=<ID=END,Number=1,Type=Integer,Description="End position">',
        '##INFO=<ID=CTGS,Number=.,Type=String,Description="Evidence contig names">',
        '##INFO=<ID=MATEID,Number=1,Type=String,Description="Mate breakend">',
        '##INFO=<ID=IMPRECISE,Number=0,Type=Flag,Description="Imprecise structural variation">',
        '##INFO=<ID=CIPOS,Number=2,Type=Integer,Description="Confidence interval around POS">',
        '##INFO=<ID=CIEND,Number=2,Type=Integer,Description="Confidence interval around END">',
        '##INFO=<ID=READ_PAIR_SUPPORT,Number=1,Type=Integer,Description="Supporting discordant read pairs">',
        '##ALT=<ID=DEL,Description="Deletion">',
        '##ALT=<ID=INS,Description="Insertion">',
        '##ALT=<ID=DUP,Description="Tandem duplication">',
        '##ALT=<ID=INV,Description="Inversion">',
    ]
    contigs = [(name, ref.contig_length(name)) for name in ref.contigs()]
    w = vcf.VcfWriter(output, [sample], contigs=contigs,
                      extra_header_lines=headers)
    records = []
    for key, rec in adjacencies.items():
        contig, pos = rec["contig"], rec["pos"]
        ref_base = chr(ref.fetch(contig, pos, pos + 1)[0]).upper()
        info = {"SVTYPE": rec["svtype"], "CTGS": ",".join(sorted(rec["ctgs"]))}
        if rec["svtype"] == "BND":
            mate_contig, mate_pos = rec["end"]
            info["MATEID"] = f"BND_{mate_contig}_{mate_pos + 1}"
            records.append(vcf.Variant(
                contig, pos, ref_base,
                (f"{ref_base}]{mate_contig}:{mate_pos + 1}]",),
                id=f"BND_{contig}_{pos + 1}", qual=None, info=info,
                samples=[{"GT": "./."}], fmt_keys=("GT",)))
            continue
        info["END"] = str(rec["end"])
        info["SVLEN"] = str(rec["svlen"])
        records.append(vcf.Variant(
            contig, pos, ref_base, (f"<{rec['svtype']}>",),
            id=f"{rec['svtype']}_{contig}_{pos + 1}_{rec['end']}", qual=None,
            info=info, samples=[{"GT": "./."}], fmt_keys=("GT",)))
    names = [name for name, _ in contigs]
    for rec in imprecise:
        contig = names[rec["ref_id"]]
        pos = rec["pos"]
        ref_base = chr(ref.fetch(contig, pos, pos + 1)[0]).upper()
        info = {"SVTYPE": "DEL", "IMPRECISE": True, "END": str(rec["end"]),
                "SVLEN": str(rec["svlen"]),
                "CIPOS": f"{rec['cipos'][0]},{rec['cipos'][1]}",
                "CIEND": f"{rec['ciend'][0]},{rec['ciend'][1]}",
                "READ_PAIR_SUPPORT": str(rec["n_pairs"])}
        records.append(vcf.Variant(
            contig, pos, ref_base, ("<DEL>",),
            id=f"DEL_IMPRECISE_{contig}_{pos + 1}_{rec['end']}", qual=None,
            info=info, samples=[{"GT": "./."}], fmt_keys=("GT",)))
    order = {name: i for i, (name, _) in enumerate(contigs)}
    records.sort(key=lambda v: (order.get(v.contig, 1 << 30), v.pos))
    for v in records:
        w.write(v)
    w.close()


@register_tool("FindBreakpointEvidenceSpark")
def find_breakpoint_evidence(argv):
    """Evidence scan + breakpoint-neighborhood assembly
    (tools/spark/sv/evidence/FindBreakpointEvidenceSpark.java, single-binary):
    find split-read/discordant-pair evidence clusters, locally re-assemble each
    neighborhood, realign the contigs, and write a queryname-grouped contig
    alignment BAM (the input StructuralVariantDiscoverer consumes) plus an
    evidence-interval TSV."""
    p = argparse.ArgumentParser(description="FindBreakpointEvidenceSpark")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-R", "--reference", required=True)
    p.add_argument("-O", "--output", required=True,
                   help="output contig-alignments BAM")
    p.add_argument("--target-link-file", default=None,
                   help="evidence-interval TSV")
    p.add_argument("--min-evidence-count", type=int, default=MIN_EVIDENCE_COUNT)
    p.add_argument("--min-mapq", type=int, default=20)
    p.add_argument("--external-evidence", default=None,
                   help="BED/intervals of externally-supplied breakpoint "
                        "evidence (FindBreakpointEvidenceSpark "
                        "externalEvidenceFile)")
    p.add_argument("--external-evidence-weight", type=int, default=10)
    p.add_argument("--aligner-index-image", default=None)  # accepted, unused
    p.add_argument("--spark-master", default=None)
    args, _unknown = p.parse_known_args(argv)

    from ..align.seed_extend import SeedExtendAligner
    from ..assembly import assembler as asm_mod
    from ..io import bam as bamio, fasta
    from ..io.cram import open_reads
    from ..io.reads import Read

    ref = fasta.FastaReference(args.reference)
    rd = open_reads(args.input, reference=ref)
    sites = _evidence_sites(rd, args.min_mapq)
    if args.external_evidence:
        _merge_external_evidence(sites, args.external_evidence,
                                 args.external_evidence_weight)
    aligner = SeedExtendAligner(
        [(name, ref.fetch(name, 0, ref.contig_length(name)))
         for name in ref.contigs()])
    w = bamio.BamWriter(args.output, rd.header)
    tsv = open(args.target_link_file, "w") if args.target_link_file else None
    n_contigs = n_clusters = 0
    for contig, positions in sites.items():
        contig_len = ref.contig_length(contig)
        for lo, hi in _cluster_sites(positions, EVIDENCE_CLUSTER_WINDOW,
                                     args.min_evidence_count):
            n_clusters += 1
            if tsv:
                tsv.write(f"{contig}\t{lo + 1}\t{hi + 1}\tevidence_cluster\n")
            w_lo = max(0, lo - ASSEMBLY_FLANK)
            w_hi = min(contig_len, hi + ASSEMBLY_FLANK)
            reads = [r for r in rd.query(contig, w_lo, w_hi)
                     if not r.is_unmapped and not r.is_duplicate
                     and not r.is_secondary]
            if not reads:
                continue
            result = asm_mod.assemble(reads, ref.fetch(contig, w_lo, w_hi), w_lo)
            for hap in result.haplotypes[1:]:
                n_contigs += 1
                name = f"asm{n_clusters:06d}:tig{n_contigs:05d}"
                hap_arr = np.frombuffer(bytes(hap.bases), np.uint8)
                for k, a in enumerate(aligner.align_all(hap_arr,
                                                        min_score_frac=0.15)):
                    flag = (0x10 if a.is_reverse else 0) | (0x800 if k else 0)
                    w.write(Read(name=name, flag=flag, ref_id=a.contig_index,
                                 pos=int(a.pos), mapq=60,
                                 cigar_ops=a.cigar_ops, cigar_lens=a.cigar_lens,
                                 bases=hap_arr.copy(),
                                 quals=np.full(len(hap_arr), 40, np.uint8)))
    w.close()
    if tsv:
        tsv.close()
    print(f"FindBreakpointEvidenceSpark: {n_clusters} evidence clusters, "
          f"{n_contigs} assembled contigs -> {args.output}")
    return 0


@register_tool("ExtractSVEvidenceSpark")
def extract_sv_evidence(argv):
    """Extract breakpoint-evidence records to a text file
    (tools/spark/sv/evidence/ExtractSVEvidenceSpark.java): one typed record per
    split-read boundary, SA-tagged split, or distant/interchromosomal mate."""
    p = argparse.ArgumentParser(description="ExtractSVEvidenceSpark")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-R", "--reference", default=None)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("--min-mapq", type=int, default=20)
    p.add_argument("--min-evidence-mapq", type=int, default=None)
    args, _unknown = p.parse_known_args(argv)
    min_mapq = args.min_evidence_mapq or args.min_mapq

    from ..io import fasta, sam as sam_mod
    from ..io.cram import open_reads

    ref = fasta.FastaReference(args.reference) if args.reference else None
    rd = open_reads(args.input, reference=ref)
    n = 0
    with open(args.output, "w") as fh:
        fh.write("#EVIDENCE_TYPE\tCONTIG\tPOSITION\tREAD\tDETAIL\n")
        for r in rd:
            if r.is_unmapped or r.is_duplicate or r.is_secondary or r.mapq < min_mapq:
                continue
            contig = rd.header.sequences[r.ref_id].name
            ops, lens = r.cigar_ops, r.cigar_lens
            m = len(ops)
            if m and ops[0] == sam_mod.OP_S and int(lens[0]) >= MIN_SOFTCLIP_EVIDENCE:
                fh.write(f"SplitRead\t{contig}\t{int(r.pos) + 1}\t{r.name}\t"
                         f"leftClip={int(lens[0])}\n")
                n += 1
            if m and ops[m - 1] == sam_mod.OP_S and int(lens[m - 1]) >= MIN_SOFTCLIP_EVIDENCE:
                fh.write(f"SplitRead\t{contig}\t{int(r.end)}\t{r.name}\t"
                         f"rightClip={int(lens[m - 1])}\n")
                n += 1
            sa = (getattr(r, "tags", None) or {}).get("SA")
            if sa:
                fh.write(f"SplitAlignment\t{contig}\t{int(r.pos) + 1}\t{r.name}\t"
                         f"SA={sa}\n")
                n += 1
            if (r.is_paired and not r.mate_is_unmapped
                    and (r.mate_ref_id != r.ref_id or abs(r.tlen) > 10000)):
                mate_contig = (rd.header.sequences[r.mate_ref_id].name
                               if 0 <= r.mate_ref_id < len(rd.header.sequences)
                               else "?")
                fh.write(f"DiscordantPair\t{contig}\t{int(r.end)}\t{r.name}\t"
                         f"mate={mate_contig}:{r.mate_pos + 1}\n")
                n += 1
    print(f"extracted {n} evidence records to {args.output}")
    return 0


@register_tool("ExtractOriginalAlignmentRecordsByNameSpark")
def extract_original_alignment_records_by_name(argv):
    """Pull all alignment records for the given read names
    (tools/spark/sv/utils/ExtractOriginalAlignmentRecordsByNameSpark.java)."""
    p = argparse.ArgumentParser(
        description="ExtractOriginalAlignmentRecordsByNameSpark")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("--read-name-file", required=True)
    p.add_argument("--invert-match", action="store_true")
    args, _unknown = p.parse_known_args(argv)

    from ..io import bam as bamio

    names = {l.strip() for l in open(args.read_name_file) if l.strip()}
    rd = bamio.BamReader(args.input)
    w = bamio.BamWriter(args.output, rd.header)
    n = 0
    for r in rd:
        if (r.name in names) != args.invert_match:
            w.write(r)
            n += 1
    w.close()
    print(f"extracted {n} records for {len(names)} names")
    return 0


@register_tool("FindBadGenomicKmersSpark")
def find_bad_genomic_kmers(argv):
    """High-copy-number reference kmers (tools/spark/sv/evidence/
    FindBadGenomicKmersSpark.java: kmers occurring > max-kmer-freq times are
    'bad' — assembly poisoners — written one canonical kmer per line)."""
    p = argparse.ArgumentParser(description="FindBadGenomicKmersSpark")
    p.add_argument("-R", "--reference", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("--kmer-size", type=int, default=51)
    p.add_argument("--max-kmer-freq", type=int, default=3)
    args, _unknown = p.parse_known_args(argv)

    from collections import Counter

    from ..align.seed_extend import revcomp
    from ..io import fasta

    ref = fasta.FastaReference(args.reference)
    k = args.kmer_size
    counts = Counter()
    for name in ref.contigs():
        seq = bytes(ref.fetch(name, 0, ref.contig_length(name))).upper()
        rc = bytes(revcomp(np.frombuffer(seq, np.uint8)))
        for s in (seq,):
            for i in range(len(s) - k + 1):
                km = s[i : i + k]
                if b"N" in km:
                    continue
                kr = rc[len(s) - i - k : len(s) - i]
                counts[min(km, kr)] += 1  # canonical form
    bad = [km for km, c in counts.items() if c > args.max_kmer_freq]
    with open(args.output, "w") as fh:
        for km in sorted(bad):
            fh.write(km.decode() + "\n")
    print(f"found {len(bad)} bad kmers (k={k}, freq>{args.max_kmer_freq}) "
          f"of {len(counts)} distinct")
    return 0


@register_tool("CalcMetadataSpark")
def calc_metadata(argv):
    """Library read metadata for SV evidence calling (tools/spark/sv/evidence/
    CalcMetadataSpark.java: read counts, coverage, template-length
    distribution per read group, serialized as text)."""
    p = argparse.ArgumentParser(description="CalcMetadataSpark")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-O", "--output", required=True)
    args, _unknown = p.parse_known_args(argv)

    from ..io import bam as bamio

    rd = bamio.BamReader(args.input)
    n_reads = n_pairs = total_bases = 0
    read_lens = []
    tlens = []
    for r in rd:
        if r.is_unmapped or r.is_secondary or r.is_supplementary:
            continue
        n_reads += 1
        total_bases += len(r.bases)
        read_lens.append(len(r.bases))
        if r.is_paired and r.tlen > 0:
            n_pairs += 1
            if r.tlen < 10000:
                tlens.append(r.tlen)
    genome = sum(s.length for s in rd.header.sequences) or 1
    tl = np.asarray(tlens) if tlens else np.zeros(1)
    with open(args.output, "w") as fh:
        fh.write(f"nReads\t{n_reads}\n")
        fh.write(f"nPairs\t{n_pairs}\n")
        fh.write(f"maxReadLength\t{max(read_lens) if read_lens else 0}\n")
        fh.write(f"meanBaseQuality\tNA\n")
        fh.write(f"coverage\t{total_bases / genome:.4f}\n")
        fh.write(f"medianFragmentSize\t{int(np.median(tl))}\n")
        fh.write(f"fragmentSizeMAD\t{int(np.median(np.abs(tl - np.median(tl))))}\n")
    print(f"metadata: {n_reads} reads, coverage {total_bases / genome:.2f}x")
    return 0
