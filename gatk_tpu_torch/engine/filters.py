# Copied verbatim from gatk_tpu/engine/filters.py; only import lines may differ.
"""Read filters (engine/filters/ReadFilterLibrary + WellformedReadFilter equivalents).

Reference behavior: engine/filters/*.java; the HaplotypeCaller default stack is
HaplotypeCallerEngine.makeStandardHCReadFilters (MappingQualityReadFilter(20),
MappingQualityAvailable, Mapped, NotSecondaryAlignment, NotDuplicate,
PassesVendorQualityCheck, NonZeroReferenceLengthAlignment, GoodCigar, Wellformed).
"""
from __future__ import annotations

import numpy as np

from ..io import sam
from ..io.reads import Read


def mapped(r: Read) -> bool:
    return not r.is_unmapped and r.pos >= 0


def mapping_quality_available(r: Read) -> bool:
    return r.mapq != 255


def mapping_quality_at_least(r: Read, min_mq: int) -> bool:
    return r.mapq >= min_mq


def not_secondary(r: Read) -> bool:
    return not r.is_secondary


def not_supplementary(r: Read) -> bool:
    return not r.is_supplementary


def not_duplicate(r: Read) -> bool:
    return not r.is_duplicate


def passes_vendor_quality(r: Read) -> bool:
    return not r.fails_vendor_quality


def non_zero_reference_length(r: Read) -> bool:
    return sam.cigar_ref_length(r.cigar_ops, r.cigar_lens) > 0


def good_cigar(r: Read) -> bool:
    """GoodCigarReadFilter: no I/S at both ends of the cigar adjacent weirdness —
    specifically CigarUtils.isGood: no consecutive indels, does not start/end with
    deletion (after clips), no N... simplified to htsjdk validity + no leading/trailing
    deletion and no consecutive I/D pairs."""
    ops = [int(o) for o in r.cigar_ops]
    if not ops:
        return True
    core = [o for o in ops if o not in (sam.OP_S, sam.OP_H)]
    if core and (core[0] == sam.OP_D or core[-1] == sam.OP_D):
        return False
    for a, b in zip(core, core[1:]):
        if a in (sam.OP_I, sam.OP_D) and b in (sam.OP_I, sam.OP_D) and a != b:
            return False
    return True


def wellformed(r: Read, contig_length: int | None = None) -> bool:
    """WellformedReadFilter: aligned within contig, consistent cigar/seq lengths,
    has bases, non-empty cigar for mapped reads."""
    if r.is_unmapped:
        return False
    if r.pos < 0:
        return False
    if contig_length is not None and r.end > contig_length:
        return False
    if len(r.bases) == 0 or len(r.bases) != len(r.quals):
        return False
    if len(r.cigar_ops) == 0:
        return False
    if sam.cigar_read_length(r.cigar_ops, r.cigar_lens) != len(r.bases):
        return False
    return True


def hc_read_filter(r: Read, min_mapping_quality: int = 20, contig_length: int | None = None) -> bool:
    """The HaplotypeCaller default read-filter stack."""
    return (
        mapped(r)
        and mapping_quality_available(r)
        and mapping_quality_at_least(r, min_mapping_quality)
        and not_secondary(r)
        and not_duplicate(r)
        and passes_vendor_quality(r)
        and non_zero_reference_length(r)
        and good_cigar(r)
        and wellformed(r, contig_length)
    )


def mutect2_read_filter(r: Read, min_mapping_quality: int = 20, contig_length: int | None = None) -> bool:
    """Mutect2 default stack (adds NotSupplementary... shares most of HC's)."""
    return hc_read_filter(r, min_mapping_quality, contig_length) and not_supplementary(r)


# ----------------------------------------------------------------------------
# ReadFilterLibrary: the user-togglable filter registry
# (engine/filters/ReadFilterLibrary.java + GATKReadFilterPluginDescriptor.java:
# tools accept --read-filter / --disable-read-filter by name)
# ----------------------------------------------------------------------------

def valid_alignment_start(r: Read) -> bool:
    return r.is_unmapped or r.pos >= 0


def valid_alignment_end(r: Read) -> bool:
    return r.is_unmapped or r.end > r.pos


def cigar_contains_no_n_operator(r: Read) -> bool:
    return sam.OP_N not in set(int(o) for o in r.cigar_ops)


def first_of_pair(r: Read) -> bool:
    return r.is_paired and bool(r.flag & 0x40)


def second_of_pair(r: Read) -> bool:
    return r.is_paired and bool(r.flag & 0x80)


def paired(r: Read) -> bool:
    return r.is_paired


def properly_paired(r: Read) -> bool:
    return r.is_paired and bool(r.flag & 0x2)


def mate_on_same_contig_or_no_mapped_mate(r: Read) -> bool:
    if not r.is_paired:
        return True
    if r.flag & 0x8:  # mate unmapped
        return True
    return r.mate_ref_id == r.ref_id


def mate_different_strand(r: Read) -> bool:
    return (r.is_paired and not r.is_unmapped and not (r.flag & 0x8)
            and bool(r.flag & 0x10) != bool(r.flag & 0x20))


def mapping_quality_not_zero(r: Read) -> bool:
    return r.mapq != 0


def non_zero_fragment_length(r: Read) -> bool:
    return r.tlen != 0


def matching_bases_and_quals(r: Read) -> bool:
    return len(r.bases) == len(r.quals)


def seq_is_stored(r: Read) -> bool:
    return len(r.bases) > 0


def read_length_equals_cigar_length(r: Read) -> bool:
    if r.is_unmapped and len(r.cigar_ops) == 0:
        return True
    return sam.cigar_read_length(r.cigar_ops, r.cigar_lens) == len(r.bases)


def has_read_group(r: Read) -> bool:
    return "RG" in r.tags


def primary_line(r: Read) -> bool:
    return not r.is_secondary and not r.is_supplementary


def not_optical_duplicate(r: Read) -> bool:
    # optical-duplicate flag lives in the DT tag (DT:Z:SQ = optical/sequencing)
    return r.tags.get("DT") != "SQ"


def non_chimeric_original_alignment(r: Read) -> bool:
    sa = r.tags.get("SA")
    return sa is None or sa == ""


class AmbiguousBaseReadFilter:
    """Max fraction of N bases (AmbiguousBaseReadFilter.java, default 0.05)."""

    def __init__(self, max_ambiguous_base_fraction: float = 0.05):
        self.max_frac = max_ambiguous_base_fraction

    def __call__(self, r: Read) -> bool:
        if len(r.bases) == 0:
            return True
        n = int(np.count_nonzero(r.bases == ord("N")))
        return n <= self.max_frac * len(r.bases)


class ReadLengthReadFilter:
    def __init__(self, min_read_length: int = 1, max_read_length: int = 2147483647):
        self.min = min_read_length
        self.max = max_read_length

    def __call__(self, r: Read) -> bool:
        return self.min <= len(r.bases) <= self.max


class FragmentLengthReadFilter:
    def __init__(self, max_fragment_length: int = 1000000, min_fragment_length: int = 0):
        self.max = max_fragment_length
        self.min = min_fragment_length

    def __call__(self, r: Read) -> bool:
        return self.min <= abs(r.tlen) <= self.max


class OverclippedReadFilter:
    """Rejects reads whose unclipped core is too short
    (OverclippedReadFilter.java, default 30 aligned bases)."""

    def __init__(self, filter_too_short: int = 30, do_not_require_softclips_both_ends=False):
        self.min_aligned = filter_too_short
        self.both_ends = not do_not_require_softclips_both_ends

    def __call__(self, r: Read) -> bool:
        ops = [int(o) for o in r.cigar_ops]
        lens = [int(l) for l in r.cigar_lens]
        n_soft = sum(1 for o in ops if o == sam.OP_S)
        if self.both_ends and n_soft < 2:
            return True
        if n_soft == 0:
            return True
        aligned = sum(l for o, l in zip(ops, lens) if o != sam.OP_S and o != sam.OP_H
                      and o in (sam.OP_M, sam.OP_EQ, sam.OP_X, sam.OP_I))
        return aligned >= self.min_aligned


class ReadStrandFilter:
    def __init__(self, keep_reverse: bool = False):
        self.keep_reverse = keep_reverse

    def __call__(self, r: Read) -> bool:
        return r.is_reverse == self.keep_reverse


class SampleReadFilter:
    def __init__(self, samples, read_groups_by_id=None):
        self.samples = set(samples)
        self.rg_to_sample = read_groups_by_id or {}

    def __call__(self, r: Read) -> bool:
        rg = r.tags.get("RG")
        return self.rg_to_sample.get(rg, rg) in self.samples


class ReadNameReadFilter:
    def __init__(self, read_names):
        self.names = set(read_names)

    def __call__(self, r: Read) -> bool:
        return r.name in self.names


class PlatformReadFilter:
    def __init__(self, platforms, read_groups=None):
        self.platforms = {p.upper() for p in platforms}
        self.rg_platform = {rg.get("ID"): rg.get("PL", "").upper()
                            for rg in (read_groups or [])}

    def __call__(self, r: Read) -> bool:
        return self.rg_platform.get(r.tags.get("RG"), "") in self.platforms


class LibraryReadFilter:
    def __init__(self, libraries, read_groups=None):
        self.libraries = set(libraries)
        self.rg_library = {rg.get("ID"): rg.get("LB") for rg in (read_groups or [])}

    def __call__(self, r: Read) -> bool:
        return self.rg_library.get(r.tags.get("RG")) in self.libraries


class SoftClippedReadFilter:
    """Max fraction of soft-clipped bases (SoftClippedReadFilter.java inverted
    semantics: keeps reads under the clipping ratio)."""

    def __init__(self, max_clipped_fraction: float = 1.0):
        self.max_frac = max_clipped_fraction

    def __call__(self, r: Read) -> bool:
        if len(r.bases) == 0:
            return True
        clipped = sum(int(l) for o, l in zip(r.cigar_ops, r.cigar_lens)
                      if int(o) == sam.OP_S)
        return clipped <= self.max_frac * len(r.bases)


# name -> zero-arg filter (parameterless library filters, toggled by name)
READ_FILTER_LIBRARY = {
    "MappedReadFilter": mapped,
    "MappingQualityAvailableReadFilter": mapping_quality_available,
    "MappingQualityNotZeroReadFilter": mapping_quality_not_zero,
    "NotSecondaryAlignmentReadFilter": not_secondary,
    "NotSupplementaryAlignmentReadFilter": not_supplementary,
    "NotDuplicateReadFilter": not_duplicate,
    "NotOpticalDuplicateReadFilter": not_optical_duplicate,
    "PassesVendorQualityCheckReadFilter": passes_vendor_quality,
    "NonZeroReferenceLengthAlignmentReadFilter": non_zero_reference_length,
    "NonZeroFragmentLengthReadFilter": non_zero_fragment_length,
    "GoodCigarReadFilter": good_cigar,
    "WellformedReadFilter": wellformed,
    "ValidAlignmentStartReadFilter": valid_alignment_start,
    "ValidAlignmentEndReadFilter": valid_alignment_end,
    "CigarContainsNoNOperator": cigar_contains_no_n_operator,
    "FirstOfPairReadFilter": first_of_pair,
    "SecondOfPairReadFilter": second_of_pair,
    "PairedReadFilter": paired,
    "ProperlyPairedReadFilter": properly_paired,
    "MateOnSameContigOrNoMappedMateReadFilter": mate_on_same_contig_or_no_mapped_mate,
    "MateDifferentStrandReadFilter": mate_different_strand,
    "MatchingBasesAndQualsReadFilter": matching_bases_and_quals,
    "SeqIsStoredReadFilter": seq_is_stored,
    "ReadLengthEqualsCigarLengthReadFilter": read_length_equals_cigar_length,
    "HasReadGroupReadFilter": has_read_group,
    "PrimaryLineReadFilter": primary_line,
    "NonChimericOriginalAlignmentReadFilter": non_chimeric_original_alignment,
    "AmbiguousBaseReadFilter": AmbiguousBaseReadFilter(),
    "OverclippedReadFilter": OverclippedReadFilter(),
}


class CountingReadFilter:
    """CountingReadFilter.java: wraps a filter stack, tallying per-filter
    rejections for the end-of-run summary lines."""

    def __init__(self, named_filters):
        self.filters = list(named_filters)  # [(name, fn)]
        self.counts = {name: 0 for name, _ in self.filters}
        self.n_total = 0
        self.n_passed = 0

    def __call__(self, r: Read) -> bool:
        self.n_total += 1
        for name, fn in self.filters:
            if not fn(r):
                self.counts[name] += 1
                return False
        self.n_passed += 1
        return True

    def summary_lines(self):
        out = [f"{self.n_passed} total reads passed filters out of {self.n_total}"]
        for name, _ in self.filters:
            if self.counts[name]:
                out.append(f"  {self.counts[name]} read(s) filtered by: {name}")
        return out


def build_filter_stack(default_names, enable=(), disable=(), min_mapping_quality=None):
    """Resolve a tool's default filter names plus user --read-filter /
    --disable-read-filter toggles into a CountingReadFilter."""
    names = [n for n in default_names if n not in set(disable)]
    names += [n for n in enable if n not in names]
    stack = []
    for n in names:
        if n == "MappingQualityReadFilter":
            mq = 20 if min_mapping_quality is None else min_mapping_quality
            stack.append((n, lambda r, _mq=mq: mapping_quality_at_least(r, _mq)))
        elif n in READ_FILTER_LIBRARY:
            stack.append((n, READ_FILTER_LIBRARY[n]))
        else:
            raise KeyError(f"unknown read filter: {n}")
    return CountingReadFilter(stack)


HC_DEFAULT_FILTER_NAMES = [
    "MappedReadFilter", "MappingQualityAvailableReadFilter",
    "MappingQualityReadFilter", "NotSecondaryAlignmentReadFilter",
    "NotDuplicateReadFilter", "PassesVendorQualityCheckReadFilter",
    "NonZeroReferenceLengthAlignmentReadFilter", "GoodCigarReadFilter",
    "WellformedReadFilter",
]
