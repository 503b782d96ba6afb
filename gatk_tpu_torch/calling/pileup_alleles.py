# Copied verbatim from gatk_tpu/calling/pileup_alleles.py; only import lines may differ.
"""Pileup-based allele detection (DRAGEN ColumnwiseDetection equivalent).

Reference behavior: utils/pileup/PileupBasedAlleles.java — scan the active
region's per-column pileups for SNP/indel candidates that assembly may have
dropped, classify each candidate "good" (fraction of supporting reads above
snp/indel thresholds, enough absolute depth, supporting reads not dominated by
"bad" reads) or "bad" (supporting reads dominated by high-edit-distance reads;
used to *remove* assembled events), per goodAndBadPileupEvents (:52-143),
passesPileupFilters (:151-155), isBadPileupRead (:176-206).

The per-read mismatch fraction (the MZ transient tag, :226-244) is computed from
the NM tag when present, else directly against the reference.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..assembly.haplotype import Event
from ..io import sam


@dataclass
class PileupDetectionArgs:
    """PileupDetectionArgumentCollection defaults (:55-165)."""

    use_pileup_detection: bool = False
    detect_indels: bool = False
    generate_pd_haplotypes: bool = False  # --use-pdhmm
    snp_threshold: float = 0.1
    indel_threshold: float = 0.1
    absolute_depth: float = 0.0
    snp_adjacent_to_assembly_indel: int = 5
    qual_for_snps: int = 12
    bad_read_threshold: float = 0.0
    bad_read_proper_pair: bool = True
    bad_read_edit_distance: float = 0.08
    bad_read_secondary_or_supplementary: bool = True
    assembly_bad_read_threshold: float = 0.0
    assembly_bad_read_edit_distance: float = 0.12
    active_region_phred_threshold: float = 0.0

    @classmethod
    def dragen_378(cls):
        """The --dragen-mode (3.7.8 concordance) pileup bundle
        (HaplotypeCallerArgumentCollection.getDragenVersion378NameValuePairs
        :310-317)."""
        return cls(use_pileup_detection=True, detect_indels=True,
                   generate_pd_haplotypes=True, bad_read_threshold=0.40,
                   assembly_bad_read_threshold=0.4,
                   active_region_phred_threshold=3.0)


def _mismatch_fraction(read, ref_bases, ref_start) -> float:
    """Per-aligned-base mismatch rate: (NM - indel bases) / aligned length
    (PileupBasedAlleles.addMismatchPercentageToRead :226-244)."""
    aligned = 0
    indel_bases = 0
    nm = read.tags.get("NM") if read.tags else None
    mismatches = 0
    read_i = 0
    ref_i = read.pos - ref_start
    for op, ln in zip(read.cigar_ops, read.cigar_lens):
        op, ln = int(op), int(ln)
        if op in (sam.OP_M, sam.OP_EQ, sam.OP_X):
            if nm is None and 0 <= ref_i and ref_i + ln <= len(ref_bases):
                mismatches += int(np.count_nonzero(
                    read.bases[read_i : read_i + ln] != ref_bases[ref_i : ref_i + ln]))
            aligned += ln
            read_i += ln
            ref_i += ln
        elif op == sam.OP_I:
            indel_bases += ln
            read_i += ln
        elif op == sam.OP_D:
            indel_bases += ln
            ref_i += ln
        elif op == sam.OP_S:
            read_i += ln
        elif op == sam.OP_N:
            ref_i += ln
    if aligned == 0:
        return 0.0
    score = (int(nm) - indel_bases) if nm is not None else mismatches
    # stored as an int permille in the reference (x1000 MZ tag)
    return int(1000.0 * score / aligned) / 1000.0


def _is_bad_pileup_read(read, mz: float, args: PileupDetectionArgs) -> bool:
    if args.bad_read_threshold <= 0.0:
        return False
    if args.bad_read_proper_pair and not read.flag & 0x2:
        return True
    if args.bad_read_secondary_or_supplementary and (
            read.flag & 0x100 or (read.tags and "SA" in read.tags)):
        return True
    return mz > args.bad_read_edit_distance


def _is_bad_assembly_read(mz: float, args: PileupDetectionArgs) -> bool:
    return args.assembly_bad_read_threshold > 0.0 and mz > args.assembly_bad_read_edit_distance


def good_and_bad_pileup_events(reads, ref_bases, ref_start: int,
                               args: PileupDetectionArgs,
                               min_base_quality: int = 10,
                               activity_phred=None):
    """Scan per-column pileups of the region reads for candidate events.

    ref_bases: uint8 reference bases starting at genomic position ref_start.
    activity_phred: optional per-position phred-scaled activity scores (same
    origin as ref_bases); columns below active_region_phred_threshold are
    skipped except for deletion tracking one base upstream (:64-73).
    Returns (good_events, bad_events) as sets of Event."""
    if not args.use_pileup_detection:
        return set(), set()
    ref_bases = np.asarray(ref_bases, np.uint8)
    n = len(ref_bases)
    depth = np.zeros(n, np.int32)

    # per-position candidate accumulators: pos -> {key: [count, bad, asm_bad]}
    snp_counts: dict = {}
    ins_counts: dict = {}
    del_counts: dict = {}

    def bump(table, pos, key, bad, asm_bad):
        rec = table.setdefault(pos, {}).setdefault(key, [0, 0, 0])
        rec[0] += 1
        rec[1] += bad
        rec[2] += asm_bad

    for read in reads:
        mz = _mismatch_fraction(read, ref_bases, ref_start)
        bad = _is_bad_pileup_read(read, mz, args)
        asm_bad = _is_bad_assembly_read(mz, args)
        read_i = 0
        ref_i = read.pos - ref_start
        ops, lens = read.cigar_ops, read.cigar_lens
        n_ops = len(ops)
        for k in range(n_ops):
            op, ln = int(ops[k]), int(lens[k])
            if op in (sam.OP_M, sam.OP_EQ, sam.OP_X):
                lo = max(ref_i, 0)
                hi = min(ref_i + ln, n)
                if lo < hi:
                    depth[lo:hi] += 1
                    # low-qual bases are subtracted from the usable depth (:93-96)
                    q = read.quals[read_i + (lo - ref_i) : read_i + (hi - ref_i)]
                    lowq = q < min_base_quality
                    if lowq.any():
                        np.subtract.at(depth, np.nonzero(lowq)[0] + lo, 1)
                    mism = np.nonzero(
                        (read.bases[read_i + (lo - ref_i) : read_i + (hi - ref_i)]
                         != ref_bases[lo:hi])
                        & (q > args.qual_for_snps))[0]
                    for off in mism:
                        p = lo + int(off)
                        bump(snp_counts, p, int(read.bases[read_i + (p - ref_i)]),
                             bad, asm_bad)
                read_i += ln
                ref_i += ln
                # indel immediately following this block anchors on its last base
                if k + 1 < n_ops and args.detect_indels:
                    nop, nln = int(ops[k + 1]), int(lens[k + 1])
                    anchor = ref_i - 1
                    if 0 <= anchor < n:
                        if nop == sam.OP_I:
                            inserted = read.bases[read_i : read_i + nln].tobytes()
                            bump(ins_counts, anchor, inserted, bad, asm_bad)
                        elif nop == sam.OP_D:
                            bump(del_counts, anchor, nln, bad, asm_bad)
            elif op in (sam.OP_D, sam.OP_N):
                ref_i += ln
            elif op in (sam.OP_I, sam.OP_S):
                read_i += ln

    good: set = set()
    bad_events: set = set()
    thr = args.active_region_phred_threshold
    for table, kind in ((snp_counts, "snp"), (ins_counts, "ins"), (del_counts, "del")):
        for pos, by_key in table.items():
            if activity_phred is not None and thr > 0.0:
                active = activity_phred[pos] > thr if pos < len(activity_phred) else False
                # deletions are also tracked one base upstream of active columns
                next_active = (kind == "del" and pos + 1 < len(activity_phred)
                               and activity_phred[pos + 1] > thr)
                if not active and not next_active:
                    continue
            ref_b = chr(ref_bases[pos])
            d = int(depth[pos])
            if d <= 0:
                continue
            for key, (count, n_bad, n_asm_bad) in by_key.items():
                if kind == "snp":
                    ev = Event(ref_start + pos, ref_b, chr(key))
                elif kind == "ins":
                    ev = Event(ref_start + pos, ref_b, ref_b + key.decode())
                else:
                    deleted = ref_bases[pos : pos + 1 + key].tobytes().decode()
                    if len(deleted) != key + 1:
                        continue
                    ev = Event(ref_start + pos, deleted, ref_b)
                frac_thr = args.indel_threshold if ev.is_indel() else args.snp_threshold
                if (count / d > frac_thr and d >= args.absolute_depth
                        and (args.bad_read_threshold <= 0.0
                             or n_bad / count <= args.bad_read_threshold)):
                    good.add(ev)
                if (args.assembly_bad_read_threshold > 0.0
                        and n_asm_bad / count >= args.assembly_bad_read_threshold):
                    bad_events.add(ev)
    return good, bad_events
