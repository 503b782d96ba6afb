# Copied verbatim from gatk_tpu/tools/groundtruth_tools.py; only import lines may differ.
"""Ultima flow-space ground-truth tooling.

Reference behavior: tools/walkers/groundtruth/ — AddFlowBaseQuality.java
(flow-matrix-derived per-base qualities written to XQ or into the quals),
GroundTruthScorer.java (read-vs-truth scoring; subset here).
"""
from __future__ import annotations

import argparse

import numpy as np

from ..cli import register_tool
from ..engine import walkers

ERROR_PROB_BAND_1LESS, ERROR_PROB_BAND_KEY, ERROR_PROB_BAND_1MORE = 0, 1, 2


def _calc_flow_order_length(flow_order: str) -> int:
    i = flow_order.find(flow_order[0], 1)
    return len(flow_order) if i < 0 else i


def _extract_error_prob_bands(fread, min_value: float) -> np.ndarray:
    """3 x n_flows band matrix: P(key-1), P(key), P(key+1) per flow
    (AddFlowBaseQuality.extractErrorProbBands)."""
    key = fread.key
    n = len(key)
    bands = np.full((3, n), min_value)
    for i in range(n):
        bands[ERROR_PROB_BAND_KEY, i] = max(fread.get_prob(i, int(key[i])), min_value)
        if key[i] > 0:
            bands[ERROR_PROB_BAND_1LESS, i] = max(
                fread.get_prob(i, int(key[i]) - 1), min_value)
        if key[i] < fread.max_hmer:
            bands[ERROR_PROB_BAND_1MORE, i] = max(
                fread.get_prob(i, int(key[i]) + 1), min_value)
    return bands


def _slice_is_valid(s, flow_order_length):
    run = 0
    for k in s:
        if k != 0:
            run = 0
        else:
            run += 1
            if run >= flow_order_length - 1:
                return False
    return True


def _slice_prob(s, min_index, key, bands):
    p = 1.0
    for i, v in enumerate(s):
        ki = key[i + min_index]
        band = (ERROR_PROB_BAND_1LESS if v < ki
                else ERROR_PROB_BAND_1MORE if v > ki else ERROR_PROB_BAND_KEY)
        p *= bands[band, i + min_index]
    return p


def _sided_error_prob(key, bands, flow, side_incr, flow_order_length):
    """AddFlowBaseQuality.generateSidedHmerBaseErrorProbability: probability
    that the hmer boundary base is misplaced toward the given side."""
    min_index = max(flow - flow_order_length + 1, 0)
    max_index = min(flow + flow_order_length - 1, len(key) - 1)
    base_slice = list(key[min_index : max_index + 1])
    hmer_length = key[flow]
    slices = []
    incrs = (side_incr,) if hmer_length != 1 else (side_incr, -side_incr)
    for incr in incrs:
        side_flow = flow + incr
        while 0 <= side_flow < len(key):
            alt = list(base_slice)
            if not (min_index <= side_flow <= max_index):
                break
            alt[side_flow - min_index] += 1
            alt[flow - min_index] -= 1
            if _slice_is_valid(alt, flow_order_length):
                slices.append(alt)
            if key[side_flow] != 0:
                break
            side_flow += incr
    key_p = _slice_prob(base_slice, min_index, key, bands)
    sum_p = key_p + sum(_slice_prob(s, min_index, key, bands) for s in slices)
    return 1.0 - (key_p / sum_p)


def generate_base_error_probability(fread, flow_order_length, min_error_rate):
    """Per-base error probability from the flow matrix
    (AddFlowBaseQuality.generateBaseErrorProbability)."""
    key = [int(k) for k in fread.key]
    bands = _extract_error_prob_bands(fread, min_error_rate)
    n_bases = int(sum(key))
    result = np.zeros(n_bases)
    base = 0
    for flow in range(len(key)):
        if key[flow] == 0:
            continue
        hmer_length = key[flow]
        left = _sided_error_prob(key, bands, flow, -1, flow_order_length)
        right = (_sided_error_prob(key, bands, flow, 1, flow_order_length)
                 if hmer_length != 1 else 0.0)
        if base == 0:
            result[base] = bands[ERROR_PROB_BAND_KEY, flow]
            base += 1
        else:
            result[base] = left
            base += 1
        if hmer_length > 1:
            base += hmer_length - 2
            result[base] = right
            base += 1
        if base == n_bases:
            result[base - 1] = bands[ERROR_PROB_BAND_KEY, flow]
    return result


@register_tool("AddFlowBaseQuality")
def add_flow_base_quality(argv):
    """Add flow-matrix-derived base qualities to reads
    (groundtruth/AddFlowBaseQuality.java): per-hmer boundary error
    probabilities from the flow key neighborhood, written as the XQ attribute
    (or replacing quals, old quals to OQ)."""
    p = argparse.ArgumentParser(description="AddFlowBaseQuality")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("-R", "--reference", default=None)
    p.add_argument("--minimal-error-rate", type=float, default=1e-3)
    p.add_argument("--maximal-quality-score", type=int, default=93)
    p.add_argument("--replace-quality-mode", action="store_true")
    p.add_argument("--flow-order", default="TGCA")
    args = p.parse_args(argv)
    w = _AddFlowBaseQualityWalker(reads_path=args.input,
                                  reference_path=args.reference)
    w.args = args
    w.run()
    return 0


class _AddFlowBaseQualityWalker(walkers.ReadWalker):
    """AddFlowBaseQuality as a ReadWalker (groundtruth/AddFlowBaseQuality.java
    extends ReadWalker)."""

    tool_name = "AddFlowBaseQuality"
    default_read_filters = ()

    def on_traversal_start(self):
        from ..io import bam as bamio
        from ..ops import flow as flow_mod

        self._flow_mod = flow_mod
        args = self.args
        self.flow_order = args.flow_order
        for rg in self.reads.header.read_groups:
            if "FO" in rg:
                self.flow_order = rg["FO"][: len(args.flow_order)] or self.flow_order
                break
        self.fol = _calc_flow_order_length(self.flow_order)
        self.writer = bamio.BamWriter(args.output, self.reads.header)
        self.n = 0

    def apply(self, r, ref_context):
        args = self.args
        fread = self._flow_mod.flow_read_from_sam(r, self.flow_order)
        err = generate_base_error_probability(fread, self.fol,
                                              args.minimal_error_rate)
        phred = np.where(err <= 0, args.maximal_quality_score,
                         np.minimum(args.maximal_quality_score,
                                    (-10 * np.log10(np.maximum(err, 1e-30))).astype(int)))
        phred = phred.astype(np.uint8)[: len(r.bases)]
        if len(phred) < len(r.bases):
            phred = np.pad(phred, (0, len(r.bases) - len(phred)),
                           constant_values=args.maximal_quality_score)
        tags = dict(getattr(r, "tags", None) or {})
        if args.replace_quality_mode:
            tags["OQ"] = "".join(chr(q + 33) for q in r.quals)
            r.quals = phred
        else:
            tags["XQ"] = "".join(chr(q + 33) for q in phred)
        r.tags = tags
        self.writer.write(r)
        self.n += 1

    def close_tool(self):
        self.writer.close()
        print(f"AddFlowBaseQuality: wrote {self.n} reads to {self.args.output}")


@register_tool("GroundTruthScorer")
def ground_truth_scorer(argv):
    """Score flow-based reads against the reference ground truth
    (groundtruth/GroundTruthScorer.java, core scoring): per read, compare the
    read's flow key to the reference haplotype's flow key over the aligned
    span; emit a per-read CSV (read name, span, key length, matched flows,
    mismatched flows, score) and a report of observed-vs-declared quality
    binned by base quality."""
    p = argparse.ArgumentParser(description="GroundTruthScorer")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-R", "--reference", required=True)
    p.add_argument("--output-csv", required=True)
    p.add_argument("--report-file", default=None)
    p.add_argument("--flow-order", default="TGCA")
    p.add_argument("--normalized-score-threshold", type=float, default=-0.1)
    args = p.parse_args(argv)

    from ..io import fasta
    from ..io.cram import open_reads
    from ..ops import flow as flow_mod

    ref = fasta.FastaReference(args.reference)
    rd = open_reads(args.input, reference=ref)
    flow_order = args.flow_order
    for rg in rd.header.read_groups:
        if "FO" in rg:
            flow_order = rg["FO"][:4] or flow_order
            break
    # observed-vs-declared quality accumulators per qual bin
    qual_obs = {}  # qual -> [errors, total]
    rows = []
    for r in rd:
        if r.is_unmapped or r.ref_id < 0:
            continue
        contig = rd.header.sequences[r.ref_id].name
        gt = ref.fetch(contig, int(r.pos), int(r.end))
        seq = r.bases
        if r.is_reverse:
            from ..align.seed_extend import revcomp
            seq = revcomp(np.asarray(seq, np.uint8))
            gt = revcomp(np.asarray(gt, np.uint8))
        read_key = flow_mod.base_array_to_key(np.asarray(seq, np.uint8), flow_order)
        truth_key = flow_mod.base_array_to_key(np.asarray(gt, np.uint8), flow_order)
        n = min(len(read_key), len(truth_key))
        matched = int(np.count_nonzero(read_key[:n] == truth_key[:n]))
        mismatched = n - matched
        # normalized score: 0 for a perfect read, more negative with errors
        score = -mismatched / max(1, n)
        rows.append(f"{r.name},{contig}:{int(r.pos) + 1}-{int(r.end)},"
                    f"{len(read_key)},{matched},{mismatched},{score:.4f}")
        # per-base observed error for the quality report (base-space compare)
        m = min(len(seq), len(gt))
        errs = np.asarray(seq[:m], np.uint8) != np.asarray(gt[:m], np.uint8)
        for qv in np.unique(r.quals[:m]):
            sel = r.quals[:m] == qv
            acc = qual_obs.setdefault(int(qv), [0, 0])
            acc[0] += int(errs[sel].sum())
            acc[1] += int(sel.sum())
    with open(args.output_csv, "w") as fh:
        fh.write("ReadName,AlignedSpan,KeyLength,MatchedFlows,MismatchedFlows,"
                 "NormalizedScore\n")
        fh.write("\n".join(rows) + ("\n" if rows else ""))
    if args.report_file:
        import math
        with open(args.report_file, "w") as fh:
            fh.write("DeclaredQual\tObservedErrors\tBases\tObservedQual\n")
            for qv in sorted(qual_obs):
                e, t = qual_obs[qv]
                oq = (60 if e == 0 else
                      min(60, -10 * math.log10(e / t)))
                fh.write(f"{qv}\t{e}\t{t}\t{oq:.1f}\n")
    n_pass = sum(1 for row in rows
                 if float(row.rsplit(",", 1)[1]) >= args.normalized_score_threshold)
    print(f"GroundTruthScorer: scored {len(rows)} reads "
          f"({n_pass} above threshold) -> {args.output_csv}")
    return 0


@register_tool("GroundTruthReadsBuilder")
def ground_truth_reads_builder(argv):
    """Build a base-calling training set from reads + parental haploid
    references (groundtruth/GroundTruthReadsBuilder.java, core flow): for each
    read, extract the maternal and paternal haplotype sequences over the
    read's span (+EXTRA fill), score the read against both (PairHMM log
    likelihood per base), keep reads whose best haplotype passes the score and
    score-delta gates, subsample, and write the training CSV. The reference's
    ancestral-translator CSVs are replaced by same-coordinate parental FASTAs
    (the common same-assembly case)."""
    p = argparse.ArgumentParser(description="GroundTruthReadsBuilder")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("--maternal-ref", required=True)
    p.add_argument("--paternal-ref", required=True)
    p.add_argument("--output-csv", required=True)
    p.add_argument("--subsampling-ratio", type=float, default=1.0)
    p.add_argument("--max-output-reads", type=int, default=20_000_000)
    p.add_argument("--min-mq", type=float, default=0)
    p.add_argument("--min-haplotype-score", type=float, default=0)
    p.add_argument("--min-haplotype-score-delta", type=float, default=0)
    p.add_argument("--haplotype-output-padding-size", type=int, default=8)
    args = p.parse_args(argv)

    from ..io import fasta
    from ..io.cram import open_reads
    from ..ops import pairhmm_host
    from ..utils.javarandom import JavaRandom

    EXTRA = 50  # EXTRA_FILL_FROM_HAPLOTYPE
    mat = fasta.FastaReference(args.maternal_ref)
    pat = fasta.FastaReference(args.paternal_ref)
    rd = open_reads(args.input)
    rng = JavaRandom(42)
    rows = []
    n_out = 0
    for r in rd:
        if r.is_unmapped or r.mapq < args.min_mq or (r.flag & 0x900):
            continue
        if args.subsampling_ratio < 1.0 and rng.next_double() > args.subsampling_ratio:
            continue
        contig = rd.header.sequences[r.ref_id].name
        lo = max(0, int(r.pos))
        scores = {}
        haps = {}
        for label, ref in (("maternal", mat), ("paternal", pat)):
            if contig not in ref.contigs():
                break
            hi = min(int(r.end) + EXTRA, ref.contig_length(contig))
            hap = bytes(ref.fetch(contig, lo, hi)).upper()
            haps[label] = hap
            lik = pairhmm_host.compute_log10_likelihood(
                hap, bytes(r.bases), r.quals,
                np.full(len(r.bases), 45, np.uint8),
                np.full(len(r.bases), 45, np.uint8),
                np.full(len(r.bases), 10, np.uint8))
            scores[label] = lik / max(1, len(r.bases))  # per-base normalized
        if len(scores) != 2:
            continue
        best = max(scores, key=scores.get)
        if args.min_haplotype_score and scores[best] < -abs(args.min_haplotype_score):
            continue
        delta = abs(scores["maternal"] - scores["paternal"])
        if args.min_haplotype_score_delta and delta < args.min_haplotype_score_delta:
            continue
        pad = "N" * args.haplotype_output_padding_size
        rows.append((r.name, bytes(r.bases).decode(),
                     haps["maternal"].decode() + pad,
                     haps["paternal"].decode() + pad,
                     f"{scores['maternal']:.4f}", f"{scores['paternal']:.4f}",
                     best))
        n_out += 1
        if n_out >= args.max_output_reads:
            break
    import gzip as _gzip
    op = _gzip.open if args.output_csv.endswith(".gz") else open
    with op(args.output_csv, "wt") as fh:
        fh.write("ReadName,ReadSequence,MaternalHaplotype,PaternalHaplotype,"
                 "MaternalScore,PaternalScore,BestHaplotype\n")
        for row in rows:
            fh.write(",".join(row) + "\n")
    print(f"GroundTruthReadsBuilder: wrote {n_out} training reads to {args.output_csv}")
    return 0
