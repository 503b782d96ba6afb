# Copied verbatim from gatk_tpu/tools/realignment_tools.py; only import lines may differ.
"""Realignment-based artifact filtering.

Reference behavior: tools/walkers/realignmentfilter/FilterAlignmentArtifacts.java
(+ RealignmentEngine.java, RealignmentArgumentCollection.java): for each
unfiltered variant, build unitigs (pileup consensus contigs) from the reads that
support the variant, realign the unitigs against the whole reference with an
all-hits aligner (bwa-mem MEM_F_ALL in the reference; the from-scratch
seed-extend aligner here), and flag the variant `alignment_artifact` when the
unitigs' best joint alignment lands on another contig or multimaps (score /
mismatch separation below per-base thresholds).
"""
from __future__ import annotations

import argparse

import numpy as np

from ..cli import register_tool
from ..io import sam, vcf

# RealignmentArgumentCollection.java defaults
DEFAULT_INDEL_START_TOLERANCE = 5
DEFAULT_MAX_REASONABLE_FRAGMENT_LENGTH = 100_000
DEFAULT_MIN_ALIGNER_SCORE_DIFFERENCE_PER_BASE = 0.2
DEFAULT_MIN_MISMATCH_DIFFERENCE_PER_BASE = 0.02
MIN_UNITIG_LENGTH = 30  # FilterAlignmentArtifacts.java:53
ALIGNMENT_ARTIFACT_FILTER_NAME = "alignment_artifact"


def supports_variant(read, variant, indel_start_tolerance=DEFAULT_INDEL_START_TOLERANCE):
    """RealignmentEngine.supportsVariant: SNP/MNP -> read bases match an alt;
    indel -> a D/S (deletion) or I/S (insertion) cigar element within
    indel_start_tolerance of the variant position."""
    from ..calling.annotations import read_offset_at

    off = read_offset_at(read, variant.pos)
    ref_len = len(variant.ref)
    is_snp = all(len(a) == ref_len for a in variant.alts)
    if off is None:
        if is_snp:
            return False
        off = 0  # deletion-overlapping reads may still support an indel
    for alt in variant.alts:
        if len(alt) == ref_len:
            seg = bytes(read.bases[off : off + len(alt)]).upper()
            if seg == alt.upper().encode():
                return True
        else:
            is_del = len(alt) < ref_len
            read_pos = 0
            for op, ln in zip(read.cigar_ops, read.cigar_lens):
                if abs(read_pos - off) <= indel_start_tolerance:
                    if is_del and op in (sam.OP_D, sam.OP_S):
                        return True
                    if not is_del and op in (sam.OP_I, sam.OP_S):
                        return True
                if sam.CONSUMES_READ[op]:
                    read_pos += int(ln)
    return False


def build_unitigs(reads):
    """Pileup-consensus unitigs over the reads' covered span
    (FilterAlignmentArtifacts.getUnitigs): one unitig per contiguous covered
    stretch; per column, skip if the majority of overlapping reads show a
    deletion, else emit the consensus base plus the majority immediately
    following insertion (if more than half the reads carry one)."""
    if not reads:
        return []
    # expand every read into per-column (ref_pos, base) plus following-insertion
    columns = {}  # pos -> [bases]
    dels = {}  # pos -> count of deletion observations
    ins = {}  # pos -> [inserted strings]
    for r in reads:
        rp = int(r.pos)
        ro = 0
        n_ops = len(r.cigar_ops)
        for i in range(n_ops):
            op, ln = int(r.cigar_ops[i]), int(r.cigar_lens[i])
            if op in (sam.OP_M, sam.OP_EQ, sam.OP_X):
                for j in range(ln):
                    columns.setdefault(rp + j, []).append(int(r.bases[ro + j]))
                # immediately-following insertion attaches to the last M base
                if i + 1 < n_ops and int(r.cigar_ops[i + 1]) == sam.OP_I:
                    ins.setdefault(rp + ln - 1, []).append(
                        bytes(r.bases[ro + ln : ro + ln + int(r.cigar_lens[i + 1])]))
                rp += ln
                ro += ln
            elif op == sam.OP_D:
                for j in range(ln):
                    dels[rp + j] = dels.get(rp + j, 0) + 1
                    columns.setdefault(rp + j, [])
                rp += ln
            elif op in (sam.OP_I, sam.OP_S):
                ro += ln
            elif op == sam.OP_N:
                rp += ln
    unitigs = []
    cur = bytearray()
    last = None
    for pos in sorted(columns):
        if last is not None and pos != last + 1 and cur:
            unitigs.append(bytes(cur))
            cur = bytearray()
        last = pos
        bases = columns[pos]
        n_del = dels.get(pos, 0)
        total = len(bases) + n_del
        if total == 0 or n_del >= total / 2:
            continue  # deletion consensus: emit nothing for this column
        vals, counts = np.unique(np.asarray(bases, np.uint8), return_counts=True)
        cur.append(int(vals[np.argmax(counts)]))
        following = ins.get(pos, [])
        if len(following) > total / 2:
            best = max(set(following), key=following.count)
            cur.extend(best)
    if cur:
        unitigs.append(bytes(cur))
    return [u for u in unitigs if len(u) > MIN_UNITIG_LENGTH]


def find_joint_alignments(per_unitig, max_fragment):
    """RealignmentEngine.findJointAlignments: groups of same-strand alignments
    (one per unitig) within max_fragment of each other."""
    per_unitig = [u for u in per_unitig if u]
    if not per_unitig:
        return []
    if len(per_unitig) == 1:
        return [[a] for a in per_unitig[0]]
    per_unitig = sorted(per_unitig, key=len)
    joint = []
    for a in per_unitig[0]:
        group = [a]
        ok = True
        for others in per_unitig[1:]:
            near = [b for b in others
                    if b.contig_index == a.contig_index
                    and b.is_reverse == a.is_reverse
                    and abs(b.pos - a.pos) <= max_fragment // 2]
            if not near:
                ok = False
                break
            group.append(max(near, key=lambda b: b.score))
        if ok:
            joint.append(group)
    return joint


@register_tool("FilterAlignmentArtifacts")
def filter_alignment_artifacts(argv):
    """Realignment-based variant filter
    (realignmentfilter/FilterAlignmentArtifacts.java)."""
    p = argparse.ArgumentParser(description="FilterAlignmentArtifacts")
    p.add_argument("-V", "--variant", required=True)
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-R", "--reference", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("--indel-start-tolerance", type=int,
                   default=DEFAULT_INDEL_START_TOLERANCE)
    p.add_argument("--dont-skip-filtered-variants", action="store_true")
    p.add_argument("--max-reasonable-fragment-length", type=int,
                   default=DEFAULT_MAX_REASONABLE_FRAGMENT_LENGTH)
    p.add_argument("--min-aligner-score-difference-per-base", type=float,
                   default=DEFAULT_MIN_ALIGNER_SCORE_DIFFERENCE_PER_BASE)
    p.add_argument("--min-mismatch-difference-per-base", type=float,
                   default=DEFAULT_MIN_MISMATCH_DIFFERENCE_PER_BASE)
    args = p.parse_args(argv)

    from ..align.seed_extend import SeedExtendAligner
    from ..io import fasta
    from ..io.cram import open_reads

    ref = fasta.FastaReference(args.reference)
    contigs = [(name, ref.fetch(name, 0, ref.contig_length(name)))
               for name in ref.contigs()]
    aligner = SeedExtendAligner(contigs)
    contig_index = {name: i for i, (name, _) in enumerate(contigs)}
    reads_src = open_reads(args.input, reference=ref)

    reader = vcf.VcfReader(args.variant)
    headers = list(reader.header_lines)
    headers.append(f'##FILTER=<ID={ALIGNMENT_ARTIFACT_FILTER_NAME},'
                   f'Description="Variant is likely an alignment artifact">')
    headers.append('##INFO=<ID=UNITIGS,Number=.,Type=Integer,'
                   'Description="Sizes of reassembled unitigs">')
    headers.append('##INFO=<ID=ALIGN_DIFF,Number=1,Type=Integer,'
                   'Description="Difference in alignment score between best '
                   'and next-best alignment">')
    headers.append('##INFO=<ID=JOINT_ALIGNMENTS,Number=1,Type=Integer,'
                   'Description="Number of joint alignments">')
    w = vcf.VcfWriter(args.output, reader.samples, extra_header_lines=headers)
    n_filtered = n_total = 0
    for v in reader:
        n_total += 1
        already_filtered = v.filters and set(v.filters) - {"PASS"}
        if already_filtered and not args.dont_skip_filtered_variants:
            w.write(v)
            continue
        window = (max(0, v.pos - 500), v.end + 500)
        reads = [r for r in reads_src.query(v.contig, *window)
                 if not r.is_unmapped and not r.is_duplicate and r.mapq > 0]
        supporting = [r for r in reads
                      if supports_variant(r, v, args.indel_start_tolerance)]
        unitigs = build_unitigs(supporting)
        info = dict(v.info)
        filters = list(v.filters)
        if unitigs:
            info["UNITIGS"] = ",".join(str(len(u)) for u in unitigs)
            per_unitig = [aligner.align_all(np.frombuffer(u, np.uint8))
                          for u in unitigs]
            joint = find_joint_alignments(per_unitig,
                                          args.max_reasonable_fragment_length)
            info["JOINT_ALIGNMENTS"] = str(len(joint))
            joint.sort(key=lambda g: -sum(a.score for a in g))
            if joint and joint[0][0].contig_index != contig_index.get(v.contig):
                filters = [ALIGNMENT_ARTIFACT_FILTER_NAME]
            elif len(joint) > 1:
                total_bases = sum(len(u) for u in unitigs)
                score_diff = (sum(a.score for a in joint[0])
                              - sum(a.score for a in joint[1]))
                mismatch_diff = (sum(a.nm for a in joint[1])
                                 - sum(a.nm for a in joint[0]))
                info["ALIGN_DIFF"] = str(score_diff)
                if (score_diff / total_bases < args.min_aligner_score_difference_per_base
                        and mismatch_diff / total_bases < args.min_mismatch_difference_per_base):
                    filters = [ALIGNMENT_ARTIFACT_FILTER_NAME]
        v.info = info
        v.filters = tuple(filters)
        if ALIGNMENT_ARTIFACT_FILTER_NAME in filters:
            n_filtered += 1
        w.write(v)
    w.close()
    print(f"FilterAlignmentArtifacts: {n_filtered}/{n_total} variants filtered "
          f"as alignment artifacts")
    return 0
