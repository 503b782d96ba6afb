# Copied verbatim from gatk_tpu/calling/bamout.py; only import lines may differ.
"""bamout: realigned reads + called haplotypes as a BAM.

Reference: utils/haplotype/HaplotypeBAMWriter.java (haplotypes written as
synthetic reads in read group "ArtificialHaplotypeRG" with the HC tag) and
AssemblyBasedCallerUtils.realignReadsToTheirBestHaplotype /
AlignmentUtils.createReadAlignedToRef:50-130 (read SW-aligned to its best
haplotype, then the read→haplotype cigar composed with the haplotype→reference
cigar to produce the read→reference alignment).

Simplifications vs the reference (noted for parity review): indels are not
re-left-aligned after composition, and reads whose SW alignment fails keep
their original alignment — both match the reference's fallback behavior in
the common case.
"""
from __future__ import annotations

from dataclasses import replace

import numpy as np

from ..io.reads import Read
from ..ops import smith_waterman as sw

HAPLOTYPE_TAG = "HC"
ARTIFICIAL_HAPLOTYPE_RG = "ArtificialHaplotypeRG"
DEFAULT_HAPLOTYPE_READ_GROUP_ID = ARTIFICIAL_HAPLOTYPE_RG
INFORMATIVE_LOG10_THRESHOLD = 0.2

OP_M, OP_I, OP_D, OP_N, OP_S = 0, 1, 2, 3, 4


def _cigar_pairs(ops, lens):
    return [(int(o), int(l)) for o, l in zip(ops, lens)]


def _trim_hap_cigar(hap_pairs, hap_offset):
    """Consume hap_offset haplotype(query) bases from the hap→ref cigar;
    return (ref bases consumed before the offset, remaining cigar)."""
    ref_before = 0
    remaining = []
    togo = hap_offset
    for op, ln in hap_pairs:
        consumes_hap = op in (OP_M, OP_I, OP_S)
        consumes_ref = op in (OP_M, OP_D, OP_N)
        if togo == 0:
            remaining.append((op, ln))
            continue
        if consumes_hap:
            take = min(togo, ln)
            togo -= take
            if consumes_ref:
                ref_before += take
            if ln - take > 0:
                remaining.append((op, ln - take))
        elif consumes_ref:
            ref_before += ln
    return ref_before, remaining


def _apply_cigar_to_cigar(read_to_hap, hap_to_ref):
    """AlignmentUtils.applyCigarToCigar: compose read→hap with hap→ref."""
    out = []

    def emit(op, ln):
        if ln <= 0:
            return
        if out and out[-1][0] == op:
            out[-1][1] += ln
        else:
            out.append([op, ln])

    h2r = list(hap_to_ref)
    hi = 0
    h_left = h2r[hi][1] if h2r else 0
    for op, ln in read_to_hap:
        if op in (OP_I, OP_S):
            emit(op, ln)
            continue
        togo = ln
        while togo > 0:
            if hi >= len(h2r):
                # ran past the hap→ref cigar; treat as match (padded region)
                emit(op, togo)
                break
            hop = h2r[hi][0]
            if hop in (OP_D, OP_N):
                if op != OP_D:
                    emit(OP_D, h_left)
                hi += 1
                h_left = h2r[hi][1] if hi < len(h2r) else 0
                continue
            take = min(togo, h_left)
            if op == OP_M:
                emit(OP_M if hop in (OP_M,) else OP_I if hop in (OP_I, OP_S) else OP_M, take)
            elif op == OP_D:
                if hop == OP_M:
                    emit(OP_D, take)
                # hop I/S: hap base deleted from read and not in ref → vanishes
            togo -= take
            h_left -= take
            if h_left == 0:
                hi += 1
                h_left = h2r[hi][1] if hi < len(h2r) else 0
    return out


def realign_read_to_haplotype(read, haplotype, contig_id: int):
    """Return a realigned copy of the read against the reference through its
    best haplotype, or None when SW fails (keep the original)."""
    aln = sw.align(haplotype.bases, read.bases.tobytes(),
                   sw.ALIGNMENT_TO_BEST_HAPLOTYPE, sw.SOFTCLIP)
    if aln.offset < 0:
        return None
    hap_pairs = _cigar_pairs(haplotype.cigar_ops, haplotype.cigar_lens)
    ref_before, hap_rest = _trim_hap_cigar(hap_pairs, aln.offset)
    read_pairs = _cigar_pairs(aln.cigar_ops, aln.cigar_lens)
    composed = _apply_cigar_to_cigar(read_pairs, hap_rest)
    if not composed:
        return None
    new_pos = haplotype.alignment_start + ref_before
    # leading soft clips shift nothing; leading deletions are dropped
    while composed and composed[0][0] == OP_D:
        new_pos += composed[0][1]
        composed.pop(0)
    while composed and composed[-1][0] == OP_D:
        composed.pop()
    if not composed:
        return None
    ops = np.array([p[0] for p in composed], np.uint8)
    lens = np.array([p[1] for p in composed], np.int32)
    # read-length invariant check (AlignmentUtils.createReadAlignedToRef:127)
    qlen = int(lens[(ops == OP_M) | (ops == OP_I) | (ops == OP_S)].sum())
    if qlen != len(read.bases):
        return None
    return replace(read, ref_id=contig_id, pos=new_pos, cigar_ops=ops, cigar_lens=lens)


class BamoutCollector:
    """Accumulates haplotype records and realigned reads across regions
    (HaplotypeBAMWriter.CalledHaplotypes semantics: every assembled haplotype
    plus realigned region reads)."""

    def __init__(self, contig_ids: dict):
        self.contig_ids = contig_ids  # contig name -> ref_id
        self.records: list[Read] = []
        self._hap_counter = 0

    def add_region(self, contig: str, haplotypes, lik):
        cid = self.contig_ids.get(contig, 0)
        for h in haplotypes:
            self._hap_counter += 1
            hc_tag = hash(h.bases) & 0x7FFFFFFF
            self.records.append(Read(
                name=f"HC{self._hap_counter}", flag=0, ref_id=cid,
                pos=h.alignment_start, mapq=60,
                cigar_ops=np.asarray(h.cigar_ops, np.uint8),
                cigar_lens=np.asarray(h.cigar_lens, np.int32),
                bases=np.frombuffer(h.bases, np.uint8).copy(),
                quals=np.full(len(h.bases), 60, np.uint8),
                tags={"RG": ARTIFICIAL_HAPLOTYPE_RG, HAPLOTYPE_TAG: hc_tag},
            ))
        if lik is None or lik.n_reads == 0:
            return
        best_idx, _best, conf = lik.best_alleles()
        ref_i = lik.ref_index()
        for r in range(lik.n_reads):
            read = lik.reads[r]
            hap = lik.alleles[int(best_idx[r])]
            informative = conf[r] > INFORMATIVE_LOG10_THRESHOLD
            realigned = realign_read_to_haplotype(read, hap, cid)
            rec = realigned if realigned is not None else read
            if informative and realigned is not None:
                rec.tags = dict(rec.tags)
                rec.tags[HAPLOTYPE_TAG] = hash(hap.bases) & 0x7FFFFFFF
            self.records.append(rec)

    def write(self, path: str, header):
        """Write a coordinate-sorted bamout with the artificial haplotype RG."""
        from ..io import bam as bamio
        from ..io import sam as samio

        rgs = list(header.read_groups) + [
            {"ID": ARTIFICIAL_HAPLOTYPE_RG, "SM": ARTIFICIAL_HAPLOTYPE_RG}]
        out_header = samio.SamHeader(
            text="", sequences=header.sequences, read_groups=rgs)
        w = bamio.BamWriter(path, out_header)
        for rec in sorted(self.records, key=lambda x: (x.ref_id, x.pos)):
            w.write(rec)
        w.close()
