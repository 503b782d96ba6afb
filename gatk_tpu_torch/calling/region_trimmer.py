# Copied verbatim from gatk_tpu/calling/region_trimmer.py; only import lines may differ.
"""Assembly-region trim-to-variation.

Reference behavior: haplotypecaller/AssemblyRegionTrimmer.java (:168-205) +
AssemblyRegion.trim (:255-270) + Haplotype.trim — after assembly, shrink the
genotyping region to the span of discovered variation plus per-event padding
(SNP 20bp, indel 75bp; AssemblyRegionArgumentCollection:101-109), and clip
haplotypes/reads to the padded variant span. Cuts the PairHMM matrix size at
flat regions with a single variant cluster.
"""
from __future__ import annotations

import numpy as np

from ..engine.intervals import Interval
from ..io import sam

SNP_PADDING_FOR_GENOTYPING = 20
INDEL_PADDING_FOR_GENOTYPING = 75


def compute_trim_spans(events, span: Interval, padded: Interval):
    """(variant_span, padded_variant_span) or None when no event overlaps the
    active span (AssemblyRegionTrimmer.trim :168-205)."""
    in_region = [e for e in events if e.start < span.end and e.end > span.start]
    if not in_region:
        return None
    min_start = min(e.start for e in in_region)
    max_end = max(e.end for e in in_region)
    variant_span = Interval(span.contig, max(min_start, span.start),
                            min(max_end, span.end))
    lo, hi = min_start, max_end
    for e in in_region:
        pad = INDEL_PADDING_FOR_GENOTYPING if e.is_indel() else SNP_PADDING_FOR_GENOTYPING
        lo = min(lo, max(e.start - pad, 0))
        hi = max(hi, e.end + pad)
    padded_variant_span = Interval(span.contig, max(lo, padded.start),
                                   min(hi, padded.end))
    return variant_span, padded_variant_span


def trim_haplotype(hap, ref_start: int, lo: int, hi: int):
    """Clip a haplotype (bases + cigar vs the padded reference) to genomic
    window [lo, hi) (Haplotype.trim): boundary insertions are excluded, leading/
    trailing deletions dropped. Returns (bases, cigar_ops, cigar_lens,
    new_alignment_start) or None if the haplotype doesn't span the window."""
    if hap.cigar_ops is None:
        return None
    ref_i = hap.alignment_start
    read_i = 0
    out_ops: list[int] = []
    out_lens: list[int] = []
    out_lo = None
    keep_start = keep_end = None
    for op, ln in zip(hap.cigar_ops, hap.cigar_lens):
        op, ln = int(op), int(ln)
        consumes_ref = op in (sam.OP_M, sam.OP_EQ, sam.OP_X, sam.OP_D, sam.OP_N)
        consumes_read = op in (sam.OP_M, sam.OP_EQ, sam.OP_X, sam.OP_I, sam.OP_S)
        if consumes_ref:
            seg_lo = max(ref_i, lo)
            seg_hi = min(ref_i + ln, hi)
            if seg_lo < seg_hi:
                take = seg_hi - seg_lo
                off = seg_lo - ref_i
                if op != sam.OP_D and op != sam.OP_N:
                    if keep_start is None:
                        keep_start = read_i + off
                        out_lo = seg_lo
                    keep_end = read_i + off + take
                elif keep_start is None:
                    out_lo = seg_hi  # leading deletion: drop, start after it
                    ref_i += ln
                    if consumes_read:
                        read_i += ln
                    continue
                if out_ops and out_ops[-1] == op:
                    out_lens[-1] += take
                elif op in (sam.OP_D, sam.OP_N) and not out_ops:
                    pass  # never lead with a deletion
                else:
                    out_ops.append(op)
                    out_lens.append(take)
        elif consumes_read:
            # insertion/softclip: keep only when strictly inside the window
            if keep_start is not None and lo < ref_i < hi:
                if out_ops and out_ops[-1] == op:
                    out_lens[-1] += ln
                else:
                    out_ops.append(op)
                    out_lens.append(ln)
                keep_end = read_i + ln
        if consumes_ref:
            ref_i += ln
        if consumes_read:
            read_i += ln
    if keep_start is None or keep_end is None or keep_end <= keep_start:
        return None
    while out_ops and out_ops[-1] in (sam.OP_D, sam.OP_N):
        out_ops.pop()
        out_lens.pop()
    bases = hap.bases[keep_start:keep_end]
    return (bases, np.asarray(out_ops, np.uint8), np.asarray(out_lens, np.int32),
            out_lo)


def trim_assembly(haplotypes, ref_bases, ref_start: int, span: Interval,
                  padded: Interval):
    """Trim the assembly to the variation span. Returns
    (trimmed_haplotypes, variant_span, padded_variant_span, trimmed_ref,
    new_ref_start) or None when trimming is not applicable (no events, or a
    haplotype can't be trimmed — caller keeps the untrimmed region)."""
    from ..assembly.haplotype import Haplotype, build_event_map

    events = sorted({e for h in haplotypes for e in h.events},
                    key=lambda e: (e.start, e.ref, e.alt))
    spans = compute_trim_spans(events, span, padded)
    if spans is None:
        return None
    variant_span, pv = spans
    if pv.start <= padded.start and pv.end >= padded.end:
        return None  # nothing to trim
    out = []
    seen = set()
    for h in haplotypes:
        t = trim_haplotype(h, ref_start, pv.start, pv.end)
        if t is None:
            return None
        bases, ops, lens, lo = t
        if bases in seen:
            continue
        seen.add(bases)
        nh = Haplotype(bases, is_ref=h.is_ref, score=h.score,
                       kmer_size=h.kmer_size, weakness=h.weakness,
                       cigar_ops=ops, cigar_lens=lens, alignment_start=lo)
        out.append(nh)
    new_ref = ref_bases[pv.start - ref_start: pv.end - ref_start]
    for nh in out:
        build_event_map(nh, new_ref, pv.start)
    if not any(nh.events for nh in out):
        return None
    return out, variant_span, pv, new_ref, pv.start
