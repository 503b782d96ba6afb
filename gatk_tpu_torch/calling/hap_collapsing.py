# Copied verbatim from gatk_tpu/calling/hap_collapsing.py; only import lines may differ.
"""Long-homopolymer haplotype (un)collapsing for flow-based data.

Reference behavior: haplotypecaller/LongHomopolymerHaplotypeCollapsingEngine.java
— flow sequencers cap homopolymer run lengths (e.g. at 12), so assembled
haplotypes carry collapsed hmers; this engine re-expands ("uncollapses") them
against the reference: SW-align the haplotype to the uncollapsed reference
(INDEL overhang), and fill deletion gaps that sit on >= threshold reference
homopolymers with the homopolymer base (:315-418). needsCollapsing (:102-140)
gates the whole machinery; collapseBases (:264-298) re-caps long hmers.
"""
from __future__ import annotations

import numpy as np

DEFAULT_HMER_SIZE_THRESHOLD = 12

_COMP = np.arange(256, dtype=np.uint8)
for _a, _b in zip(b"ACGTacgt", b"TGCAtgca"):
    _COMP[_a] = _b


def _revcomp(b: bytes) -> bytes:
    return _COMP[np.frombuffer(b, np.uint8)[::-1]].tobytes()


def needs_collapsing(bases: bytes, hmer_size_threshold: int) -> bool:
    """At least one homopolymer run longer than the threshold (:102-140)."""
    last = -1
    same = 0
    for b in bases:
        if b == last:
            same += 1
            if same >= hmer_size_threshold:
                return True
        else:
            last = b
            same = 0
    return False


def collapse_bases(bases: bytes, hmer_size_threshold: int) -> bytes:
    """Cap every homopolymer (except the leading one) at the threshold
    (:264-298)."""
    out = bytearray()
    last = 0
    same = 0
    first_hmer = True
    for b in bases:
        if b == last:
            same += 1
            if not first_hmer and same >= hmer_size_threshold:
                continue
            out.append(b)
        else:
            if last != 0:
                first_hmer = False
            last = b
            same = 0
            out.append(b)
    return bytes(out)


def _on_homopolymer(bases: bytes, ofs: int, base: int, threshold: int) -> bool:
    for tick in range(threshold):
        o = ofs + tick
        if o < 0 or o + threshold > len(bases):
            continue
        if all(bases[o + i] == base for i in range(threshold)):
            return True
    return False


def uncollapse_by_ref(bases: bytes, ref: bytes, hmer_size_threshold: int,
                      partial_mode: bool = False, rev: bool = False):
    """(uncollapsed bases, alignment offset, collapsed?) per uncollapseByRef
    (:315-418)."""
    from ..ops import smith_waterman as sw

    if rev:
        bases = _revcomp(bases)
        ref = _revcomp(ref)
    aln = sw.align(np.frombuffer(ref, np.uint8), np.frombuffer(bases, np.uint8),
                   sw.NEW_SW_PARAMETERS, sw.INDEL)
    out = bytearray()
    bases_ofs = aln.offset
    ref_ofs = 0
    collapsed = False
    for op, ln in zip(aln.cigar_ops, aln.cigar_lens):
        op, ln = int(op), int(ln)
        if op != 2:  # not D
            if op in (0, 1, 4, 7, 8):  # consumes read
                out += bases[bases_ofs: bases_ofs + ln]
                bases_ofs += ln
        else:
            fwd = bases[bases_ofs: bases_ofs + hmer_size_threshold]
            bck = bases[max(0, bases_ofs - hmer_size_threshold): bases_ofs]
            if needs_collapsing(fwd, hmer_size_threshold - 1) or \
                    needs_collapsing(bck, hmer_size_threshold - 1):
                if _on_homopolymer(ref, ref_ofs - hmer_size_threshold,
                                   ref[ref_ofs], hmer_size_threshold):
                    base = ref[ref_ofs]
                    for size in range(ln):
                        if partial_mode and ref[ref_ofs + size] != base:
                            break
                        out.append(base)
                    collapsed = True
                elif ref_ofs + ln <= len(ref) and _on_homopolymer(
                        ref, ref_ofs + ln, ref[ref_ofs + ln - 1],
                        hmer_size_threshold):
                    base = ref[ref_ofs + ln - 1]
                    for size in range(ln):
                        if partial_mode and ref[ref_ofs + ln - 1 - size] != base:
                            break
                        out.append(base)
                    collapsed = True
        if op in (0, 2, 3, 7, 8):  # consumes ref
            ref_ofs += ln
    result = bytes(out)
    if rev:
        result = _revcomp(result)
    return result, aln.offset, collapsed


def uncollapse_haplotypes(haplotypes, ref_bases, ref_start: int,
                          hmer_size_threshold: int = DEFAULT_HMER_SIZE_THRESHOLD,
                          limit_to_threshold: bool = False):
    """uncollapseHmersInHaplotypes (:184-263): per non-ref haplotype, take the
    longer of the forward/reverse-complement uncollapse results, dedup by
    sequence, and re-align each to the reference for a fresh cigar/event map."""
    from ..assembly.haplotype import Haplotype, build_event_map
    from ..ops import smith_waterman as sw

    ref_bytes = (ref_bases.tobytes() if isinstance(ref_bases, np.ndarray)
                 else bytes(ref_bases))
    out = []
    seen = set()
    for h in haplotypes:
        if h.is_ref:
            if h.bases not in seen:
                seen.add(h.bases)
                out.append(h)
            continue
        f = uncollapse_by_ref(h.bases, ref_bytes, hmer_size_threshold, rev=False)
        r = uncollapse_by_ref(h.bases, ref_bytes, hmer_size_threshold, rev=True)
        bases, offset, _coll = r if len(r[0]) > len(f[0]) else f
        if limit_to_threshold:
            bases = collapse_bases(bases, hmer_size_threshold)
        if not bases or bases in seen:
            continue
        seen.add(bases)
        aln = sw.align(np.frombuffer(ref_bytes, np.uint8),
                       np.frombuffer(bases, np.uint8),
                       sw.NEW_SW_PARAMETERS, sw.INDEL)
        nh = Haplotype(bases, is_ref=False, score=h.score, kmer_size=h.kmer_size,
                       weakness=h.weakness, cigar_ops=aln.cigar_ops,
                       cigar_lens=aln.cigar_lens,
                       alignment_start=ref_start + aln.offset)
        build_event_map(nh, np.frombuffer(ref_bytes, np.uint8), ref_start)
        out.append(nh)
    return out
