# Copied verbatim from gatk_tpu/assembly/haplotype.py; only import lines may differ.
"""Haplotype + EventMap (utils/haplotype/Haplotype.java + EventMap.java equivalents).

A haplotype is a candidate sequence over the padded region, with a cigar vs the
padded reference from SW alignment (NEW_SW_PARAMETERS, SOFTCLIP overhang). The
EventMap decomposes that cigar into Events (SNPs/indels vs ref), the atoms of
genotyping.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..io import sam


@dataclass(frozen=True)
class Event:
    """A variant event: contig-less (position relative to reference contig), with
    VCF-style ref/alt strings (indels left-anchored with one shared base)."""

    start: int  # 0-based genomic position of the first ref base (anchor for indels)
    ref: str
    alt: str

    @property
    def end(self) -> int:
        return self.start + len(self.ref)

    def is_snp(self):
        return len(self.ref) == 1 and len(self.alt) == 1

    def is_indel(self):
        return len(self.ref) != len(self.alt)

    def __repr__(self):
        return f"Event({self.start + 1}:{self.ref}>{self.alt})"


@dataclass
class Haplotype:
    bases: bytes
    is_ref: bool = False
    score: float = 0.0
    kmer_size: int = 0
    # min branch-edge multiplicity along the k-best path (KBestHaplotype.weakness;
    # feeds physical phasing's PMW / phase-read counts)
    weakness: int = 1 << 30
    # alignment vs the padded reference
    cigar_ops: np.ndarray | None = None
    cigar_lens: np.ndarray | None = None
    alignment_start: int = 0  # genomic position where the haplotype alignment begins
    events: list = field(default_factory=list)

    def __hash__(self):
        return hash(self.bases)

    def __len__(self):
        return len(self.bases)

    @property
    def cigar(self):
        return sam.cigar_to_string(self.cigar_ops, self.cigar_lens)


MIN_QUAL_DIFF = 10  # not used yet; placeholder for qual-aware event merging


def build_event_map(hap: Haplotype, ref_bases: np.ndarray, ref_start: int, max_mnp_distance: int = 0):
    """Decompose a haplotype's cigar vs the reference into events
    (EventMap.processCigarForInitialEvents behavior, maxMnpDistance=0 => SNPs only).

    ref_bases: padded reference bases (uint8), starting at genomic pos ref_start.
    hap.alignment_start: genomic position of hap base 0's alignment.
    """
    events = []
    if hap.cigar_ops is None:
        hap.events = []
        return []
    ref_i = hap.alignment_start - ref_start  # index into ref_bases
    hap_i = 0
    hb = np.frombuffer(hap.bases, dtype=np.uint8)
    ops, lens = hap.cigar_ops, hap.cigar_lens
    n_ops = len(ops)
    for k in range(n_ops):
        op = int(ops[k])
        ln = int(lens[k])
        if op in (sam.OP_M, sam.OP_EQ, sam.OP_X):
            mismatches = np.nonzero(hb[hap_i : hap_i + ln] != ref_bases[ref_i : ref_i + ln])[0]
            for off in mismatches:
                r = chr(ref_bases[ref_i + off])
                a = chr(hb[hap_i + off])
                if r in "ACGT" and a in "ACGT":
                    events.append(Event(ref_start + ref_i + int(off), r, a))
            ref_i += ln
            hap_i += ln
        elif op == sam.OP_I:
            if ref_i > 0 and hap_i > 0 and k != 0 and k != n_ops - 1:
                anchor_ref = chr(ref_bases[ref_i - 1])
                inserted = hb[hap_i : hap_i + ln].tobytes().decode()
                if anchor_ref in "ACGT" and set(inserted) <= set("ACGT"):
                    events.append(
                        Event(ref_start + ref_i - 1, anchor_ref, anchor_ref + inserted)
                    )
            hap_i += ln
        elif op == sam.OP_D:
            if ref_i > 0 and k != 0 and k != n_ops - 1:
                anchor_ref = chr(ref_bases[ref_i - 1])
                deleted = ref_bases[ref_i : ref_i + ln].tobytes().decode()
                if anchor_ref in "ACGT" and set(deleted) <= set("ACGT"):
                    events.append(
                        Event(ref_start + ref_i - 1, anchor_ref + deleted, anchor_ref)
                    )
            ref_i += ln
        elif op == sam.OP_S:
            hap_i += ln
    hap.events = events
    return events
