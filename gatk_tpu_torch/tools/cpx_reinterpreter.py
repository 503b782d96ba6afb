# Copied verbatim from gatk_tpu/tools/cpx_reinterpreter.py; only import lines may differ.
"""Complex-SV re-interpretation: extract simple variants from GATK-SV CPX calls.

Reference behavior: tools/spark/sv/discovery/inference/
SegmentedCpxVariantSimpleVariantExtractor.java — the segment-rule extraction
(ZeroAndOneSegmentCpxVariantExtractor :525-650, MultiSegmentsCpxVariantExtractor
:656-860, getInsFromOneEnd/getInsLen/getMissingAndPresentAndInvertedSegments
:865-940, makeDeletion/makeInsertion/makeInversion builders :945-1003) and
CpxVariantReInterpreterSpark.java:101-105 (the two `<prefix>_{1,multi}_seg.vcf`
outputs). The alignment-pair-iteration cross-check
(reInterpretMultiSegmentComplexVarThroughAlignmentPairIteration) — which
re-runs the contig-chimera interpreter over the original assembly BAM — is not
replicated; the rule-based extraction ("sourceWithLessAnnotations") is.
"""
from __future__ import annotations

import argparse

from ..cli import register_tool
from ..io import fasta, vcf

EVENT_SIZE_THRESHOLD = 49  # STRUCTURAL_VARIANT_SIZE_LOWER_BOUND - 1
UINS = "UINS"

# INFO keys (GATKSVVCFConstants)
SEGMENTS = "SEGMENTS"
ALT_ARRANGEMENT = "ALT_ARRANGEMENT"
SEQ_ALT_HAPLOTYPE = "SEQ_ALT_HAPLOTYPE"
CTG_NAMES = "CTG_NAMES"
MAPPING_QUALITIES = "MAPPING_QUALITIES"
MAX_ALIGN_LENGTH = "MAX_ALIGN_LENGTH"
CPX_EVENT = "CPX_EVENT"


class Interval1:
    """1-based closed interval (htsjdk SimpleInterval semantics)."""

    def __init__(self, spec_or_contig, start=None, end=None):
        if start is None:
            contig, rng = spec_or_contig.split(":")
            a, b = rng.split("-")
            self.contig, self.start, self.end = contig, int(a), int(b)
        else:
            self.contig, self.start, self.end = spec_or_contig, start, end

    @property
    def size(self):
        return self.end - self.start + 1

    def __repr__(self):
        return f"{self.contig}:{self.start}-{self.end}"


def _attr_list(v, key):
    raw = v.info.get(key, "")
    if raw in ("", None):
        return []
    return [s for s in str(raw).split(",") if s]


def _is_number(s: str) -> bool:
    try:
        float(s)
        return True
    except ValueError:
        return False


def _make_id(svtype, contig, start, end):
    return f"{svtype}_{contig}_{start}_{end}"


def make_deletion(rng: Interval1, ref_allele: str):
    return vcf.Variant(
        contig=rng.contig, pos=rng.start - 1, ref=ref_allele, alts=("<DEL>",),
        qual=None, filters=(), id=_make_id("DEL", rng.contig, rng.start, rng.end),
        info={"END": str(rng.end), "SVLEN": str(-rng.size + 1), "SVTYPE": "DEL"},
        fmt_keys=(), samples=[])


def make_insertion(contig, pos, end, sv_len, ref_allele: str):
    return vcf.Variant(
        contig=contig, pos=pos - 1, ref=ref_allele, alts=("<INS>",),
        qual=None, filters=(), id=_make_id("INS", contig, pos, end),
        info={"END": str(end), "SVLEN": str(sv_len), "SVTYPE": "INS"},
        fmt_keys=(), samples=[])


def make_inversion(inverted: Interval1, ref_allele: str):
    return vcf.Variant(
        contig=inverted.contig, pos=inverted.start - 2, ref=ref_allele,
        alts=("<INV>",), qual=None, filters=(),
        id=_make_id("INV", inverted.contig, inverted.start - 1, inverted.end),
        info={"END": str(inverted.end), "SVLEN": "0", "SVTYPE": "INV"},
        fmt_keys=(), samples=[])


def _anchor(ref_fetch, contig, pos1):
    """One reference base at 1-based pos1."""
    return ref_fetch(contig, pos1)


def get_ins_len(description: str, seg_lengths):
    """getInsLen: UINS-<n> -> n; segment index -> its length; interval -> size."""
    if description.startswith(UINS):
        return int(description[len(UINS) + 1:])
    if _is_number(description):
        off = 1 if description.startswith("-") else 0
        return seg_lengths[int(description[off:]) - 1]
    off = 1 if description.startswith("-") else 0
    return Interval1(description[off:]).size


def get_ins_from_one_end(from_front, idx_first_match, ins_pos: Interval1,
                         anchor_allele, seg_lengths, alt_arrangement,
                         inc_by_one=True):
    """getInsFromOneEnd: sum inserted material on one side of the matched
    segment; an insertion record when it clears the size threshold."""
    ins_len = 0
    if from_front:
        for i in range(idx_first_match):
            ins_len += get_ins_len(alt_arrangement[i], seg_lengths)
    else:
        for i in range(idx_first_match + 1, len(alt_arrangement)):
            ins_len += get_ins_len(alt_arrangement[i], seg_lengths)
    if inc_by_one:
        ins_len += 1
    if ins_len > EVENT_SIZE_THRESHOLD:
        return make_insertion(ins_pos.contig, ins_pos.start, ins_pos.end,
                              ins_len, anchor_allele)
    return None


def _with_evidence(records, src):
    out = []
    for r in records:
        if r is None:
            continue
        r.info = dict(r.info)
        r.info[CPX_EVENT] = src.id
        for key in (CTG_NAMES, MAPPING_QUALITIES, MAX_ALIGN_LENGTH):
            if key in src.info:
                r.info[key] = src.info[key]
        out.append(r)
    return out


# ---------------------------------------------------------------------------
# zero / one segment
# ---------------------------------------------------------------------------

def extract_zero_one_segment(v, ref_fetch):
    """ZeroAndOneSegmentCpxVariantExtractor.extract."""
    segments = _attr_list(v, SEGMENTS)
    if not segments:
        # zero segments -> pure insertion at the variant start
        anchor = _anchor(ref_fetch, v.contig, v.pos + 1)
        alt_len = len(str(v.info.get(SEQ_ALT_HAPLOTYPE, ""))) - 2
        ins = make_insertion(v.contig, v.pos + 1, v.pos + 1, alt_len, anchor)
        return _with_evidence([ins], v)
    seg = Interval1(segments[0])
    arrangement = _attr_list(v, ALT_ARRANGEMENT)
    alt_len = len(str(v.info.get(SEQ_ALT_HAPLOTYPE, "")))
    result = []
    as_is = arrangement.index("1") if "1" in arrangement else -1
    inverted = arrangement.index("-1") if "-1" in arrangement else -1
    if inverted != -1 and seg.size > EVENT_SIZE_THRESHOLD:
        # inversion call + flanking insertions
        result.append(make_inversion(seg, _anchor(ref_fetch, seg.contig, seg.start)))
        front_anchor = _anchor(ref_fetch, seg.contig, seg.start - 1)
        rear_anchor = _anchor(ref_fetch, seg.contig, seg.end)
        result.append(get_ins_from_one_end(
            True, inverted, Interval1(seg.contig, seg.start - 1, seg.start - 1),
            front_anchor, [seg.size], arrangement))
        result.append(get_ins_from_one_end(
            False, inverted, Interval1(seg.contig, seg.end, seg.end),
            rear_anchor, [seg.size], arrangement))
    elif as_is != -1:
        # segment survives as-is: no deletion; insertions if net gain is big
        if alt_len - seg.size > EVENT_SIZE_THRESHOLD:
            front_anchor = _anchor(ref_fetch, seg.contig, seg.start - 1)
            rear_anchor = _anchor(ref_fetch, seg.contig, seg.end)
            if arrangement[-1] == "1":  # {....., "1"} -> front insertion
                result.append(make_insertion(
                    seg.contig, seg.start - 1, seg.start - 1,
                    alt_len - seg.size, front_anchor))
            elif arrangement[0] == "1":  # {"1", ....} -> rear insertion
                result.append(make_insertion(
                    seg.contig, seg.end, seg.end, alt_len - seg.size,
                    front_anchor))
            else:  # {....., "1", ....}
                result.append(get_ins_from_one_end(
                    True, as_is,
                    Interval1(seg.contig, seg.start - 1, seg.start - 1),
                    front_anchor, [seg.size], arrangement))
                result.append(get_ins_from_one_end(
                    False, as_is, Interval1(seg.contig, seg.end, seg.end),
                    rear_anchor, [seg.size], arrangement))
    else:
        # segment gone (or inverted but too small)
        if seg.size > EVENT_SIZE_THRESHOLD:
            front_anchor = _anchor(ref_fetch, seg.contig, seg.start)
            result.append(make_deletion(
                Interval1(seg.contig, seg.start, seg.end - 1), front_anchor))
            if alt_len - 2 > EVENT_SIZE_THRESHOLD:
                result.append(make_insertion(seg.contig, seg.start, seg.start,
                                             alt_len, front_anchor))
        elif alt_len - 2 > EVENT_SIZE_THRESHOLD:
            fat_ref = "".join(_anchor(ref_fetch, seg.contig, p)
                              for p in range(seg.start, seg.end))
            result.append(make_insertion(seg.contig, seg.start, seg.end - 1,
                                         alt_len - seg.size, fat_ref))
    return _with_evidence(result, v)


# ---------------------------------------------------------------------------
# multi segment
# ---------------------------------------------------------------------------

def find_all_segments(arrangement, segment_count):
    """MultiSegmentsCpxVariantExtractor.findAllSegments: index where the full
    as-is run 1..N starts, or -1 (scanned right-to-left, left-justified)."""
    idx = -1
    looking = segment_count
    for i in range(len(arrangement) - 1, -1, -1):
        d = arrangement[i]
        if d == str(looking):
            if looking == 1:
                return i
            looking -= 1
        else:
            looking = segment_count - 1 if d == str(segment_count) else segment_count
            idx = -1
    return idx


def missing_present_inverted(segments, arrangement):
    inverted = []
    present = set()
    for s in arrangement:
        if s.startswith("-") and ":" not in s:
            inverted.append(int(s[1:]))
        if ":" not in s and not s.startswith(UINS) and not s.startswith("-"):
            present.add(int(s))
    missing = [segments[i - 1] for i in range(1, len(segments) + 1)
               if i not in present and i not in inverted]
    return missing, present, inverted


def compactify_missing(missing):
    """compactifyMissingSegments: merge adjacent/1bp-overlapping gone segments."""
    if len(missing) <= 1:
        return list(missing)
    missing = sorted(missing, key=lambda s: s.start)
    out = []
    cur = missing[0]
    for nxt in missing[1:]:
        if nxt.start <= cur.end + 1:
            cur = Interval1(cur.contig, cur.start, nxt.end)
        else:
            out.append(cur)
            cur = nxt
    out.append(cur)
    return out


def _description_is_insertion(d: str) -> bool:
    if d.startswith(UINS):
        return True
    return not _is_number(d)


def extract_multi_segment(v, ref_fetch):
    """MultiSegmentsCpxVariantExtractor.extract."""
    segments = [Interval1(s) for s in _attr_list(v, SEGMENTS)]
    arrangement = _attr_list(v, ALT_ARRANGEMENT)
    missing, present, inverted = missing_present_inverted(segments, arrangement)
    seg_lengths = [s.size for s in segments]
    result = []
    idx = find_all_segments(arrangement, len(segments))
    if idx >= 0:
        # all segments appear in order as-is: only flanking insertions possible
        if idx != 0:
            pos = v.pos  # complexVC.getStart() - 1, 1-based
            result.append(get_ins_from_one_end(
                True, idx, Interval1(v.contig, pos, pos),
                _anchor(ref_fetch, v.contig, pos), seg_lengths, arrangement))
        if idx + len(segments) - 1 < len(arrangement) - 1:
            end1 = v.end  # complexVC.getEnd(): END attribute, 1-based
            result.append(get_ins_from_one_end(
                False, idx + len(segments) - 1, Interval1(v.contig, end1, end1),
                _anchor(ref_fetch, v.contig, end1), seg_lengths, arrangement))
    else:
        for i in inverted:
            seg = segments[i - 1]
            if seg.size > EVENT_SIZE_THRESHOLD and i not in present:
                result.append(make_inversion(
                    seg, _anchor(ref_fetch, seg.contig, seg.start)))
        for gone in compactify_missing(missing):
            if gone.size > EVENT_SIZE_THRESHOLD:
                result.append(make_deletion(
                    Interval1(gone.contig, gone.start, gone.end - 1),
                    _anchor(ref_fetch, gone.contig, gone.start)))
        # front / rear insertions
        first = 0
        for d in arrangement:
            if _description_is_insertion(d):
                first += 1
            else:
                break
        if first > 0:
            start1 = v.pos + 1
            result.append(get_ins_from_one_end(
                True, first, Interval1(v.contig, start1, start1),
                _anchor(ref_fetch, v.contig, start1), seg_lengths, arrangement))
        last = len(arrangement) - 1
        for i in range(len(arrangement) - 1, -1, -1):
            if _description_is_insertion(arrangement[i]):
                last -= 1
            else:
                break
        if last != len(arrangement) - 1:
            end1 = v.end
            result.append(get_ins_from_one_end(
                False, last, Interval1(v.contig, end1, end1),
                _anchor(ref_fetch, v.contig, end1), seg_lengths, arrangement))
    return _with_evidence(result, v)


@register_tool("CpxVariantReInterpreterSpark")
def cpx_variant_reinterpreter(argv):
    """Extract simple variants from GATK-SV CPX calls
    (CpxVariantReInterpreterSpark.java: `<prefix>_1_seg.vcf` for zero/one
    SEGMENT records, `<prefix>_multi_seg.vcf` for multi-SEGMENT records)."""
    p = argparse.ArgumentParser(description="CpxVariantReInterpreterSpark")
    p.add_argument("--cpx-vcf", required=True)
    p.add_argument("-R", "--reference", required=True)
    p.add_argument("--prefix-out-vcf", required=True)
    p.add_argument("--non-canonical-contig-names-file", default=None)
    p.add_argument("-I", "--input", default=None,
                   help="assembly alignments (the pair-iteration cross-check "
                        "path is not replicated; accepted for CLI compat)")
    args = p.parse_args(argv)
    ref = fasta.FastaReference(args.reference)

    def ref_fetch(contig, pos1):
        return ref.fetch(contig, pos1 - 1, pos1).tobytes().decode().upper()

    reader = vcf.VcfReader(args.cpx_vcf)
    one_seg, multi_seg = [], []
    for v in reader:
        segs = _attr_list(v, SEGMENTS)
        if len(segs) <= 1:
            one_seg.extend(extract_zero_one_segment(v, ref_fetch))
        else:
            multi_seg.extend(extract_multi_segment(v, ref_fetch))
    hdr = [
        '##ALT=<ID=DEL,Description="Deletion">',
        '##ALT=<ID=INS,Description="Insertion">',
        '##ALT=<ID=INV,Description="Inversion">',
        '##INFO=<ID=END,Number=1,Type=Integer,Description="End position">',
        '##INFO=<ID=SVLEN,Number=.,Type=Integer,Description="SV length">',
        '##INFO=<ID=SVTYPE,Number=1,Type=String,Description="SV type">',
        '##INFO=<ID=CPX_EVENT,Number=.,Type=String,Description="source complex event">',
    ]
    for records, suffix in ((one_seg, "_1_seg.vcf"), (multi_seg, "_multi_seg.vcf")):
        records.sort(key=lambda r: (r.contig, r.pos))
        w = vcf.VcfWriter(args.prefix_out_vcf + suffix, [],
                          extra_header_lines=hdr, write_format=False)
        for r in records:
            w.write(r)
        w.close()
    print(f"re-interpreted: {len(one_seg)} zero/one-segment and "
          f"{len(multi_seg)} multi-segment simple variants")
    return 0
