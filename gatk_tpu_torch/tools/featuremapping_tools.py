# Copied verbatim from gatk_tpu/tools/featuremapping_tools.py; only import lines may differ.
"""Flow feature mapping tools.

Reference behavior: tools/walkers/featuremapping/FlowFeatureMapper.java +
SNVMapper.java — emit one VCF record per read-level SNV feature ("X_" INFO
fields carrying the read evidence), where a feature is a read/ref mismatch in
an M cigar block surrounded by >= snv-identical-bases matching bases. The
feature score is the flow-space likelihood difference between the read
haplotype and the reference haplotype (scoreFeature); for non-flow reads
(no tp tag) the phred base quality / 10 stands in.
"""
from __future__ import annotations

import argparse

import numpy as np

from ..cli import register_tool
from ..engine import walkers
from ..io import sam


def _snv_features(read, ref_window, ref_start, surround_before, surround_after):
    """SNVMapper.forEachOnRead: mismatches in M blocks with identical-base
    surround; yields (genomic pos, read offset, ref base, alt base)."""
    bases = read.bases
    read_ofs = 0
    ref_ofs = read.pos - ref_start
    for op, ln in zip(read.cigar_ops, read.cigar_lens):
        op, ln = int(op), int(ln)
        if op in (sam.OP_M, sam.OP_EQ, sam.OP_X):
            if ln >= surround_before + 1 + surround_after:
                lo = read_ofs + surround_before
                hi = read_ofs + ln - surround_after
                for ro in range(lo, hi):
                    fo = ref_ofs + (ro - read_ofs)
                    if fo < 0 or fo >= len(ref_window):
                        continue
                    rb = ref_window[fo]
                    if rb == ord("N") or bases[ro] == rb:
                        continue
                    # surround must match the reference exactly
                    ok = True
                    for d in range(1, surround_before + 1):
                        if bases[ro - d] != ref_window[fo - d]:
                            ok = False
                            break
                    if ok:
                        for d in range(1, surround_after + 1):
                            if fo + d >= len(ref_window) or \
                                    bases[ro + d] != ref_window[fo + d]:
                                ok = False
                                break
                    if ok:
                        yield (ref_start + fo, ro, rb, int(bases[ro]))
            read_ofs += ln
            ref_ofs += ln
        elif op in (sam.OP_D, sam.OP_N):
            ref_ofs += ln
        elif op in (sam.OP_I, sam.OP_S):
            read_ofs += ln


def _edit_distance_and_mismatches(read, ref_window, ref_start):
    """(per-M-block mismatch count, aligned length) for X_EDIST/X_FC1."""
    mism = 0
    read_ofs = 0
    ref_ofs = read.pos - ref_start
    for op, ln in zip(read.cigar_ops, read.cigar_lens):
        op, ln = int(op), int(ln)
        if op in (sam.OP_M, sam.OP_EQ, sam.OP_X):
            seg_r = ref_window[max(ref_ofs, 0): ref_ofs + ln]
            seg_b = read.bases[read_ofs: read_ofs + len(seg_r)]
            mism += int(np.count_nonzero((seg_r != seg_b) & (seg_r != ord("N"))))
            read_ofs += ln
            ref_ofs += ln
        elif op in (sam.OP_D, sam.OP_N):
            mism += ln
            ref_ofs += ln
        elif op == sam.OP_I:
            mism += ln
            read_ofs += ln
        elif op == sam.OP_S:
            read_ofs += ln
    return mism


def _flow_score(read, ref_window, ref_start, pos, alt_base, flow_order):
    """scoreFeature: log10 lik(read | read-haplotype) - log10 lik(read | ref
    haplotype) in flow space; phred/10 fallback for non-flow reads."""
    if not read.tags or "tp" not in read.tags:
        off = pos - read.pos
        quals = read.quals
        i = min(max(off, 0), len(quals) - 1)
        return float(quals[i]) / 10.0
    from ..ops import flow, flow_pairhmm

    lo = max(pos - ref_start - 40, 0)
    hi = min(pos - ref_start + 41, len(ref_window))
    ref_hap = bytes(ref_window[lo:hi])
    alt = bytearray(ref_hap)
    alt[pos - ref_start - lo] = alt_base
    try:
        fread = flow.flow_read_from_sam(read, flow_order)
        h_read = flow.FlowBasedHaplotype(bytes(alt), flow_order)
        h_ref = flow.FlowBasedHaplotype(ref_hap, flow_order)
        return (flow_pairhmm.flow_pairhmm_log10(h_read, fread)
                - flow_pairhmm.flow_pairhmm_log10(h_ref, fread))
    except Exception:
        return -1.0


@register_tool("FlowFeatureMapper")
def flow_feature_mapper(argv):
    """Map per-read SNV features to a VCF (FlowFeatureMapper.java)."""
    p = argparse.ArgumentParser(description="FlowFeatureMapper")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-R", "--reference", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("-L", "--intervals", action="append", default=None)
    p.add_argument("--snv-identical-bases", type=int, default=1)
    p.add_argument("--snv-identical-bases-after", type=int, default=0)
    p.add_argument("--min-score", type=float, default=0.0)
    p.add_argument("--max-score", type=float, default=float("inf"))
    p.add_argument("--flow-order", default="TGCA")
    p.add_argument("--include-qc-failed-reads", action="store_true")
    args = p.parse_args(argv)
    w = _FlowFeatureMapperWalker(reads_path=args.input,
                                 reference_path=args.reference,
                                 intervals=args.intervals)
    w.args = args
    w.run()
    return 0


class _FlowFeatureMapperWalker(walkers.ReadWalker):
    """FlowFeatureMapper as a ReadWalker (tools/walkers/featuremapping/
    FlowFeatureMapper.java extends ReadWalker)."""

    tool_name = "FlowFeatureMapper"
    requires_reference = True
    default_read_filters = ()

    def on_traversal_start(self):
        self.records = []
        self.n_reads = 0
        self.n_filtered = 0
        self._ref_cache = {}
        self.lengths = {s.name: s.length for s in self.reads.header.sequences}
        args = self.args
        self.before = args.snv_identical_bases
        self.after = args.snv_identical_bases_after or self.before

    def _ref_window(self, contig):
        if contig not in self._ref_cache:
            self._ref_cache[contig] = self.reference.fetch(
                contig, 0, self.lengths[contig])
        return self._ref_cache[contig]

    def apply(self, read, ref_context):
        args = self.args
        if read.is_unmapped or read.is_secondary or read.is_supplementary:
            return
        if read.is_duplicate or (read.flag & 0x200 and not args.include_qc_failed_reads):
            self.n_filtered += 1
            return
        self.n_reads += 1
        from ..io.vcf import Variant

        t = ref_context.target if hasattr(ref_context, "target") else None
        contig = ref_context.contig
        ref_window = self._ref_window(contig)
        edist = _edit_distance_and_mismatches(read, ref_window, 0)
        tgt = next((x for x in self.targets if x.contig == contig), None)
        for pos, ro, rb, ab in _snv_features(read, ref_window, 0, self.before,
                                             self.after):
            if tgt is not None and not (tgt.start <= pos < tgt.end):
                continue
            score = _flow_score(read, ref_window, 0, pos, ab, args.flow_order)
            if not (args.min_score <= score <= args.max_score):
                continue
            self.records.append(Variant(
                contig=contig, pos=pos, ref=chr(rb), alts=(chr(ab),),
                qual=round(score, 4), filters=(),
                info={
                    "X_CIGAR": sam.cigar_to_string(read.cigar_ops, read.cigar_lens), "X_EDIST": str(edist),
                    "X_FC1": str(edist), "X_FLAGS": str(read.flag),
                    "X_INDEX": str(ro), "X_LENGTH": str(len(read.bases)),
                    "X_MAPQ": str(read.mapq), "X_RN": read.name,
                    "X_SCORE": f"{score:.4f}",
                }))

    def on_traversal_success(self):
        from ..io import vcf as vcfio

        args = self.args
        records = sorted(self.records,
                         key=lambda v: (v.contig, v.pos, v.info["X_RN"]))
        extra = [f'##INFO=<ID={k},Number=1,Type={t_},Description="{d}">'
                 for k, t_, d in (
                     ("X_CIGAR", "String", "cigar of the read"),
                     ("X_EDIST", "Integer", "read edit distance to the reference"),
                     ("X_FC1", "Integer", "number of mismatching bases"),
                     ("X_FLAGS", "Integer", "read flags"),
                     ("X_INDEX", "Integer", "feature offset in the read"),
                     ("X_LENGTH", "Integer", "read length"),
                     ("X_MAPQ", "Integer", "read mapping quality"),
                     ("X_RN", "String", "read name"),
                     ("X_SCORE", "Float", "feature score"))]
        w = vcfio.VcfWriter(args.output, [], extra_header_lines=extra,
                            write_format=False)
        for v in records:
            w.write(v)
        w.close()
        print(f"mapped {len(records)} features from {self.n_reads} reads "
              f"({self.n_filtered} filtered) -> {args.output}")


# ---------------------------------------------------------------------------
# AddFlowSNVQuality (tools/walkers/featuremapping/AddFlowSNVQuality.java)
# ---------------------------------------------------------------------------

def _snvq_value(slice_p, p1, p2, mode):
    """getSnvq (AddFlowSNVQuality.java): combine flow/sideFlow error probs."""
    import math as _math
    if mode == "Legacy":
        return slice_p
    if mode == "Optimistic":
        return p1 * p2
    if mode == "Pessimistic":
        return 1 - (1 - p1) * (1 - p2)
    if mode == "Geometric":
        return _math.sqrt((p1 * p2) * (1 - (1 - p1) * (1 - p2)))
    raise ValueError(f"unknown snv mode {mode}")


def _sided_error_and_alt_probs(key, bands, flow, side_incr, fol, flow_order,
                               snv_mode):
    """generateSidedHmerBaseErrorProbability + per-alt-base SNVQ accumulation.
    Returns (error_prob, {alt_base_char: snvq_prob})."""
    min_index = max(flow - (fol - 1), 0)
    max_index = min(flow + (fol - 1), len(key) - 1)
    base_slice = list(key[min_index : max_index + 1])
    hmer_length = key[flow]
    from .groundtruth_tools import _slice_is_valid

    def slice_probs(s, side_flow):
        acc, p1, p2 = 1.0, 0.0, 0.0
        for i, v in enumerate(s):
            ki = min_index + i
            hm = key[ki]
            band = 0 if v == hm - 1 else (2 if v == hm + 1 else 1)
            p = bands[band, ki]
            acc *= p
            if ki == flow:
                p1 = p
            if ki == side_flow:
                p2 = p
        return acc, p1, p2

    slices = []
    incrs = (side_incr,) if hmer_length != 1 else (side_incr, -side_incr)
    for incr in incrs:
        side_flow = flow + incr
        while 0 <= side_flow < len(key):
            if side_flow < min_index or side_flow > max_index:
                break
            alt = list(base_slice)
            alt[side_flow - min_index] += 1
            alt[flow - min_index] -= 1
            if _slice_is_valid(alt, fol):
                slices.append((alt, flow_order[side_flow % fol], side_flow))
            if key[side_flow] != 0:
                break
            side_flow += incr
    key_p, _, _ = slice_probs(base_slice, flow)
    sum_p = key_p
    alt_probs = {}
    for s, alt_byte, side_flow in slices:
        acc, p1, p2 = slice_probs(s, side_flow)
        alt_probs[alt_byte] = _snvq_value(acc, p1, p2, snv_mode)
        sum_p += acc
    return 1.0 - (key_p / sum_p), alt_probs


@register_tool("AddFlowSNVQuality")
def add_flow_snv_quality(argv):
    """Per-base SNV qualities for flow reads
    (featuremapping/AddFlowSNVQuality.java): base quals replaced with
    flow-derived error probs and qa/qc/qg/qt attributes holding the probability
    that the base is actually each non-called nucleotide."""
    p = argparse.ArgumentParser(description="AddFlowSNVQuality")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("-R", "--reference", default=None)
    p.add_argument("--max-phred-score", type=float, default=60.0)
    p.add_argument("--snvq-mode", choices=["Legacy", "Optimistic", "Pessimistic",
                                           "Geometric"], default="Geometric")
    p.add_argument("--output-quality-attribute", default=None)
    p.add_argument("--flow-order", default="TGCA")
    args = p.parse_args(argv)

    import numpy as np

    from ..io import bam as bamio, fasta
    from ..io.cram import open_reads
    from ..ops import flow as flow_mod
    from .groundtruth_tools import (_calc_flow_order_length,
                                    _extract_error_prob_bands)

    min_rate = 10.0 ** (-args.max_phred_score / 10.0)
    max_q = int(args.max_phred_score)
    ref = fasta.FastaReference(args.reference) if args.reference else None
    rd = open_reads(args.input, reference=ref)
    flow_order = args.flow_order
    for rg in rd.header.read_groups:
        if "FO" in rg:
            flow_order = rg["FO"][:4] or flow_order
            break
    fol = _calc_flow_order_length(flow_order)
    w = bamio.BamWriter(args.output, rd.header)
    n = 0
    for r in rd:
        fread = flow_mod.flow_read_from_sam(r, flow_order)
        key = [int(k) for k in fread.key]
        bands = _extract_error_prob_bands(fread, min_rate)
        n_bases = int(sum(key))
        base_probs = np.zeros(n_bases)
        snvq = {c: np.zeros(n_bases) for c in flow_order}
        base = 0
        for flow in range(len(key)):
            if key[flow] == 0:
                continue
            hmer = key[flow]
            flow_char = flow_order[flow % fol]
            ep0, alts0 = _sided_error_and_alt_probs(
                key, bands, flow, -1, fol, flow_order, args.snvq_mode)
            base_probs[base] = ep0
            for i, c in enumerate(flow_order):
                if c in alts0:
                    snvq[c][base] = alts0[c]
                elif c != flow_char:
                    snvq[c][base] = min_rate
            base += 1
            if hmer > 1:
                ep1, alts1 = _sided_error_and_alt_probs(
                    key, bands, flow, 1, fol, flow_order, args.snvq_mode)
                base += hmer - 2
                base_probs[base] = ep1
                for c in flow_order:
                    if c in alts1:
                        for j in range(hmer - 1):
                            snvq[c][base - j] = alts1[c] if j == 0 else min_rate
                    elif c != flow_char:
                        for j in range(hmer - 1):
                            snvq[c][base - j] = min_rate
                base += 1
            if base == n_bases:
                base_probs[base - 1] = bands[1, flow]
        # normalize: called-base prob = 1 - sum(alt probs); bq = that sum
        bases_seq = bytes(fread.bases).decode()
        for ofs in range(min(n_bases, len(bases_seq))):
            called = bases_seq[ofs]
            alt_p = 0.0
            for c in flow_order:
                if c != called:
                    snvq[c][ofs] = max(min_rate, snvq[c][ofs])
                    alt_p += snvq[c][ofs]
            if called in snvq:
                snvq[called][ofs] = max(0.0, 1.0 - alt_p)
                base_probs[ofs] = min(1.0, alt_p)

        def to_phred(probs):
            out = np.where(probs <= 0, max_q,
                           np.minimum(max_q, np.round(
                               -10 * np.log10(np.maximum(probs, 1e-30)))))
            return out.astype(np.uint8)[: len(r.bases)]

        tags = dict(getattr(r, "tags", None) or {})
        phred = to_phred(base_probs)
        if len(phred) < len(r.bases):
            phred = np.pad(phred, (0, len(r.bases) - len(phred)),
                           constant_values=max_q)
        if args.output_quality_attribute:
            tags[args.output_quality_attribute] = "".join(chr(q + 33) for q in phred)
        else:
            r.quals = phred
        for c in flow_order:
            q = to_phred(snvq[c])
            if len(q) < len(r.bases):
                q = np.pad(q, (0, len(r.bases) - len(q)), constant_values=max_q)
            tags["q" + c.lower()] = "".join(chr(x + 33) for x in q)
        r.tags = tags
        w.write(r)
        n += 1
    w.close()
    print(f"AddFlowSNVQuality: wrote {n} reads to {args.output}")
    return 0
