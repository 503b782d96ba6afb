# Copied from gatk_tpu/calling/hc_engine.py; only import lines, the PairHMM module name (pairhmm_tpu -> pairhmm), the tracer's decorator lines (utils/trace.py), the region front (assemble_region, shared by prepare_region and prepare_gvcf_region, which picks a region's reads with reads_overlapping, a sorted scan), call_interval_gvcf (which plans through plan_interval, hands its regions to parallel/scheduler.ShardedCaller, whose pool threads run prepare_gvcf_region while the calling thread computes reference confidence, then runs launch_gvcf_region and finish_gvcf_region in region order, and hands each run of hom-ref positions between variants to GvcfBlockWriter.add_hom_ref_run) and the removal of call_region and compute_pairhmm_likelihoods differ.
"""HaplotypeCaller engine: end-to-end single-sample germline calling.

Reference behavior: haplotypecaller/HaplotypeCallerEngine.java (isActive :663-726,
callRegion :735-1037) and engine/AssemblyRegionWalker.java traversal. Host side
orchestrates per-region work; the PairHMM runs as one batched Pallas call per
region batch (TPU) or via the host f64 reference (CPU testing).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np

from ..assembly import assembler
from ..engine import activity, clipping, filters
from ..engine.intervals import Interval
from ..io import fasta
from ..ops import pairhmm
from ..utils import trace
from ..utils.trace import STAGES
from . import genotyping_engine, read_prep
from .likelihoods import AlleleLikelihoods

DEFAULT_MAX_READS_PER_START = 50
REGION_PADDING = activity.DEFAULT_REGION_PADDING
MIN_TAIL_QUALITY = 9
GLOBAL_READ_MISMAPPING_RATE_CAP = -4.5  # phred 45 / -10
EXPECTED_ERROR_RATE_PER_BASE = 0.02
HALF_PCR_SNV_QUAL = 20


@dataclass
class HCArgs:
    min_base_quality_score: int = 10
    min_mapping_quality: int = 20
    standard_confidence: float = 30.0
    ploidy: int = 2
    max_reads_per_alignment_start: int = DEFAULT_MAX_READS_PER_START
    dont_use_soft_clipped_bases: bool = False
    # AdaptiveChainPruner instead of fixed prune factor
    # (ReadThreadingAssemblerArgumentCollection --adaptive-pruning; HC default off,
    # M2 default on). Essential on deep data.
    adaptive_pruning: bool = False
    # JunctionTreeLinkedDeBruijnGraph mode (--linked-de-bruijn-graph)
    linked_de_bruijn_graph: bool = False
    # pre-genotyping weak-allele removal (haplotypecaller/AlleleFiltering.java,
    # --filter-alleles; default off as in AssemblyBasedCallerArgumentCollection:377)
    filter_alleles: bool = False
    prefilter_qual_threshold: float = 30.0
    prefilter_sor_threshold: float = 3.0
    # AS_* allele-specific annotations (-G AS_StandardAnnotation;
    # tools/walkers/annotator/allelespecific/)
    as_annotations: bool = False
    # user --read-filter / --disable-read-filter toggles on top of the HC
    # default stack (GATKReadFilterPluginDescriptor equivalent)
    extra_read_filters: tuple = ()
    disabled_read_filters: tuple = ()
    # --likelihood-calculation-engine {PairHMM, FlowBasedHMM}
    # (AssemblyBasedCallerArgumentCollection; FlowBasedHMMEngine for Ultima
    # flow-space reads, utils/pairhmm/FlowBasedPairHMM.java)
    likelihood_engine: str = "PairHMM"
    flow_order: str = "TGCA"
    # DRAGEN pileup detection / PDHMM (--pileup-detection, --use-pdhmm,
    # --dragen-mode; PileupDetectionArgumentCollection + HaplotypeCallerEngine
    # :798-853). None = off.
    pileup_args: object = None
    # --output-mode (walkers/genotyper/OutputMode.java) and
    # --genotype-assignment-method (GenotypeAssignmentMethod.java)
    output_mode: str = "EMIT_VARIANTS_ONLY"
    genotype_assignment_method: str = "USE_PLS_TO_ASSIGN"
    # trim-to-variation after assembly (AssemblyRegionTrimmer.java;
    # HaplotypeCallerEngine.java:811 runs the trimmer on every region —
    # default ON to match GATK's default path; --dont-trim-active-regions
    # equivalent turns it off)
    assembly_region_trimming: bool = True
    # flow-mode long-homopolymer uncollapsing
    # (--flow-assembly-collapse-hmer-size;
    # LongHomopolymerHaplotypeCollapsingEngine.java). 0 = off.
    flow_assembly_collapse_hmer_size: int = 0
    # DRAGEN advanced genotyping (--apply-bqd/--apply-frd;
    # DRAGENGenotypesModel.java)
    apply_bqd: bool = False
    apply_frd: bool = False
    max_effective_depth_adjustment_for_frd: int = 0


def maybe_filter_alleles(lik, args, span_start):
    """Apply pre-genotyping allele filtering when --filter-alleles is on
    (HaplotypeCallerEngine.java:928-942); returns (likelihoods, haplotypes)."""
    if not args.filter_alleles:
        return lik, lik.alleles
    from .allele_filtering import filter_alleles as _filter
    lik = _filter(lik, span_start, args.prefilter_qual_threshold,
                  args.prefilter_sor_threshold)
    return lik, lik.alleles


@dataclass
class AssemblyRegionCall:
    span: Interval
    padded: Interval
    n_reads: int
    n_haplotypes: int
    variants: list = field(default_factory=list)


@trace.stage("downsample")
def positional_downsample(reads, max_per_start: int):
    """Keep at most max_per_start reads per alignment start via seeded reservoir
    sampling (PositionalDownsampler.java:23 + ReservoirDownsampler.java:121-126:
    slot = globalRandom.nextInt(totalSeen), replace when slot < target; the global
    generator is the java.util.Random(47382911) shared with QD jitter).
    reads must be coordinate-sorted."""
    from ..utils.javarandom import get_random_generator

    rng = get_random_generator()
    out = []
    cur_key = None
    reservoir = []
    seen = 0
    for r in reads:
        key = (r.ref_id, r.pos)
        if key != cur_key:
            out.extend(reservoir)
            reservoir = []
            seen = 0
            cur_key = key
        seen += 1
        if seen <= max_per_start:
            reservoir.append(r)
        else:
            slot = rng.next_int(seen)
            if slot < max_per_start:
                reservoir[slot] = r
    out.extend(reservoir)
    return out


def read_bounds_of(reads):
    """(starts, ends) arrays for a coordinate-sorted read list, for the
    vectorized per-region overlap scan in prepare_region."""
    n = len(reads)
    starts = np.fromiter((r.pos for r in reads), np.int64, n)
    ends = np.fromiter((r.end for r in reads), np.int64, n)
    return starts, ends


def correct_overlapping_pairs(reads):
    """Cap overlapping mate base quals (FragmentUtils.adjustQualsOfOverlappingPairedFragments,
    setConflictingToZero=True, cap=HALF_PCR_SNV_QUAL)."""
    by_name = {}
    for r in reads:
        by_name.setdefault(r.name, []).append(r)
    for group in by_name.values():
        if len(group) != 2:
            continue
        a, b = group
        first, second = (a, b) if a.pos <= b.pos else (b, a)
        if first.end <= second.pos:
            continue
        # aligned index in first read of second.pos
        off = _read_index_at(first, second.pos)
        if off is None:
            continue
        n_overlap = min(len(first.bases) - off, len(second.bases))
        f_b = first.bases[off : off + n_overlap]
        s_b = second.bases[:n_overlap]
        f_q = first.quals.copy()
        s_q = second.quals.copy()
        same = f_b == s_b
        f_q[off : off + n_overlap] = np.where(
            same, np.minimum(f_q[off : off + n_overlap], HALF_PCR_SNV_QUAL), 0
        )
        s_q[:n_overlap] = np.where(same, np.minimum(s_q[:n_overlap], HALF_PCR_SNV_QUAL), 0)
        first.quals = f_q
        second.quals = s_q
    return reads


def _read_index_at(read, ref_pos):
    from ..io import sam

    cur_ref = read.pos
    cur_read = 0
    for op, ln in zip(read.cigar_ops, read.cigar_lens):
        ln = int(ln)
        cr = sam.CONSUMES_READ[op]
        cf = sam.CONSUMES_REF[op]
        if cf and cr:
            if cur_ref <= ref_pos < cur_ref + ln:
                return cur_read + (ref_pos - cur_ref)
            cur_ref += ln
            cur_read += ln
        elif cf:
            if cur_ref <= ref_pos < cur_ref + ln:
                return None  # falls in deletion
            cur_ref += ln
        elif cr:
            cur_read += ln
    return None


def _finalize_window(r, keep_soft: bool):
    """Region-independent half of the simple-cigar finalize: for S?M?S? reads,
    the soft-clip revert/drop and low-qual end clip yield a base window
    [lo_q, hi_q) at reference offset pos0 that does not depend on the region —
    only the final clamp to the padded interval does. Cached on the read (the
    same read overlaps several assembly regions), invalidated by pos/cigar
    mutation via Read.__setattr__. Returns (pos0, lo_q, hi_q), False (complex
    cigar -> generic path), or None (fully low-qual clipped)."""
    cache = r.__dict__.get("_fin")
    if cache is not None and cache[0] is keep_soft:
        return cache[1]
    val = _finalize_window_compute(r, keep_soft)
    r.__dict__["_fin"] = (keep_soft, val)
    return val


def _finalize_window_compute(r, keep_soft: bool):
    from ..io import sam as _sam

    ops = r.cigar_ops
    n_ops = len(ops)
    lead_s = tail_s = 0
    m_len = 0
    i = 0
    if i < n_ops and ops[i] == _sam.OP_S:
        lead_s = int(r.cigar_lens[i])
        i += 1
    if i < n_ops and ops[i] == _sam.OP_M:
        m_len = int(r.cigar_lens[i])
        i += 1
    if i < n_ops and ops[i] == _sam.OP_S:
        tail_s = int(r.cigar_lens[i])
        i += 1
    if i != n_ops or m_len == 0:
        return False  # indels/other ops: take the generic clipping path
    L = len(r.bases)
    pos0 = r.pos - lead_s
    if keep_soft:
        if pos0 < 0:  # can't revert into negative coordinates; slow path
            return False
        lo, hi = 0, L  # all bases aligned after revert
    else:
        # index->ref mapping: base j sits at pos0+j for the aligned window
        # [lead_s, L-tail_s); base lead_s is at r.pos, so pos0 = r.pos - lead_s
        # (a negative intermediate pos0 is fine: emitted pos is pos0+lo >= r.pos).
        lo, hi = lead_s, L - tail_s
    q = r.quals
    # low-qual end clip within the aligned window
    while lo < hi and q[lo] <= MIN_TAIL_QUALITY:
        lo += 1
    while hi > lo and q[hi - 1] <= MIN_TAIL_QUALITY:
        hi -= 1
    if hi <= lo:
        return None
    return (pos0, lo, hi)


_SINGLE_M_OPS = np.zeros(1, np.uint8)


def _finalize_simple(r, padded: Interval, keep_soft: bool):
    """Single-pass finalize for S?M?S? cigars (the vast majority of reads):
    revert-or-drop soft clips, clip low-qual tails, clip to the padded interval
    — composed into one slice + one rebuild instead of up to three
    (AssemblyBasedCallerUtils.finalizeRegion, fused). Returns the finalized
    Read, None (fully clipped), or False (cigar too complex — slow path)."""
    win = _finalize_window(r, keep_soft)
    if win is False:
        return False
    if win is None:
        return None
    pos0, lo, hi = win
    # clip to the padded interval (read coords == ref offsets for pure M)
    if padded.start - pos0 > lo:
        lo = padded.start - pos0
    if padded.end - pos0 < hi:
        hi = padded.end - pos0
    if hi <= lo:
        return None
    from ..io.reads import Read as _Read

    # tags dict is shared with the source read (finalize never mutates tags;
    # bamout copy-on-writes before tagging)
    return _Read.make(r.name, r.flag, r.ref_id, pos0 + lo, r.mapq,
                      _SINGLE_M_OPS, np.array([hi - lo], np.int32),
                      r.bases[lo:hi], r.quals[lo:hi],
                      r.mate_ref_id, r.mate_pos, r.tlen, r.tags)


@trace.stage("finalize_reads")
def finalize_region_reads(region_reads, padded: Interval, args: HCArgs):
    """AssemblyBasedCallerUtils.finalizeRegion equivalent.

    Clip operations return new Read objects only when they change something;
    reads that pass through untouched are shallow-copied so the overlapping-mate
    qual correction (which reassigns .quals) never leaks across regions."""
    out = []
    for r in region_reads:
        keep_soft = not (args.dont_use_soft_clipped_bases or not _well_defined_fragment(r))
        rr = _finalize_simple(r, padded, keep_soft)
        if rr is None:
            continue
        if rr is False:
            rr = (clipping.revert_soft_clipped_bases(r) if keep_soft
                  else clipping.hard_clip_soft_clipped_bases(r))
            rr = clipping.hard_clip_low_qual_ends(rr, MIN_TAIL_QUALITY)
            if len(rr.bases) == 0 or rr.is_unmapped:
                continue
            rr = clipping.hard_clip_to_interval(rr, padded.start, padded.end)
        if len(rr.bases) > 0 and rr.pos < rr.end and rr.pos < padded.end and rr.end > padded.start:
            out.append(rr if rr is not r else r.copy())
    out.sort(key=lambda r: (r.pos, r.name))
    correct_overlapping_pairs(out)
    return out


def _well_defined_fragment(r):
    """ReadUtils.hasWellDefinedFragmentSize."""
    if r.tlen == 0 or not r.is_paired or r.mate_is_unmapped:
        return False
    if r.is_reverse == bool(r.flag & 0x20):  # same strand as mate
        return False
    if r.is_reverse:
        return r.end > r.mate_pos
    return r.pos <= r.mate_pos + r.tlen


class AssembledRegion(NamedTuple):
    """An active region as assemble_region hands it on."""
    padded: Interval
    region_reads: list  # before finalize_region_reads (PD's pileup reads them)
    final_reads: list
    ref_bases: np.ndarray  # over padded
    haplotypes: list


class GvcfPrep(NamedTuple):
    """An -ERC GVCF region as prepare_gvcf_region hands it on."""
    span: Interval
    region: AssembledRegion
    prepped: list  # read_prep.prepare_reads_for_pairhmm of region.final_reads
    packing: tuple  # pairhmm.pack_likelihood_matrix of prepped and the haplotypes


class HaplotypeCallerEngine:
    def __init__(self, reference: fasta.FastaReference, sample: str = "SAMPLE", args: HCArgs | None = None):
        self.ref = reference
        self.sample = sample
        self.args = args or HCArgs()
        # optional bamout collector (utils/haplotype/HaplotypeBAMWriter.java);
        # set by the CLI when -bamout is given
        self.bamout = None

    def plan_interval(self, reads, interval: Interval):
        """Phase 0 of the calling pipeline: read filtering/downsampling +
        active-region detection. Returns (usable_reads, [active region spans]).
        Shared by the single-device driver and the mesh scheduler
        (parallel/scheduler.py) so sharded and unsharded runs see identical
        region boundaries."""
        args = self.args
        contig_len = self.ref.contig_length(interval.contig)
        with STAGES.stage("read_filter"):
            if args.extra_read_filters or args.disabled_read_filters:
                stack = filters.build_filter_stack(
                    filters.HC_DEFAULT_FILTER_NAMES, enable=args.extra_read_filters,
                    disable=args.disabled_read_filters,
                    min_mapping_quality=args.min_mapping_quality)
                usable = [r for r in reads if stack(r)]
            else:
                usable = [
                    r
                    for r in reads
                    if filters.hc_read_filter(r, args.min_mapping_quality, contig_len)
                ]
            usable = positional_downsample(usable, args.max_reads_per_alignment_start)

        span_start = max(0, interval.start - REGION_PADDING)
        span_end = min(contig_len, interval.end + REGION_PADDING)
        ref_span = self.ref.fetch(interval.contig, span_start, span_end)

        with STAGES.stage("activity_profile"):
            probs, sc_mean = activity.compute_raw_activity(
                usable, span_start, span_end, ref_span,
                ploidy=args.ploidy, min_base_qual=args.min_base_quality_score,
            )
            smoothed = activity.band_pass(probs, sc_mean, (span_start, contig_len))
            raw_regions = activity.pop_regions(smoothed)

        spans = []
        for rr in raw_regions:
            if not rr.is_active:
                continue
            region_span = Interval(
                interval.contig, span_start + rr.start, span_start + rr.end
            )
            if region_span.end <= interval.start or region_span.start >= interval.end:
                continue
            spans.append(region_span)
        return usable, spans

    def call_interval(self, reads, interval: Interval):
        """Call variants on one interval; reads must be coordinate-sorted and
        overlap the interval. Returns (variants, region_summaries)."""
        usable, spans = self.plan_interval(reads, interval)

        # phase 1: host assembly + pooled PairHMM dispatch (regions' pairs are
        # aggregated into large pooled launches; the batcher auto-flushes as
        # dispatch groups fill, overlapping device compute with host assembly);
        # phase 2: fetch each region's likelihoods and genotype.
        batcher = pairhmm.PoolBatcher()
        pending = []
        summaries = []
        bounds = read_bounds_of(usable)
        for region_span in spans:
            prep = self.prepare_region(usable, region_span, batcher=batcher,
                                       read_bounds=bounds)
            if prep is not None:
                pending.append(prep)
            else:
                summaries.append(AssemblyRegionCall(region_span, region_span, 0, 0))
        batcher.flush()

        all_variants = []
        for prep in pending:
            variants, summary = self.finish_region(prep)
            all_variants.extend(variants)
            summaries.append(summary)
        all_variants = [v for v in all_variants if interval.start <= v.pos < interval.end]
        return all_variants, summaries

    def assemble_region(self, reads, span: Interval, read_bounds):
        """The front of every region's calling: its reads (reads_overlapping)
        after finalize_region_reads, its reference and its assembled
        haplotypes. None when no read is left, or the assembly finds at most
        one haplotype or none with an event.
        read_bounds: read_bounds_of(reads)."""
        args = self.args
        contig_len = self.ref.contig_length(span.contig)
        padded = span.expand(REGION_PADDING, contig_len)
        with STAGES.stage("finalize_reads"):
            region_reads = reads_overlapping(reads, read_bounds, padded.start, padded.end)
            final_reads = finalize_region_reads(region_reads, padded, args)
        if not final_reads:
            return None
        ref_bases = self.ref.fetch(span.contig, padded.start, padded.end)
        with STAGES.stage("assembly"):
            result = assembler.assemble(final_reads, ref_bases, padded.start,
                                        min_base_qual=args.min_base_quality_score,
                                        adaptive_pruning=args.adaptive_pruning,
                                        use_junction_trees=args.linked_de_bruijn_graph)
        haplotypes = result.haplotypes
        if len(haplotypes) <= 1 or not any(h.events for h in haplotypes):
            return None
        return AssembledRegion(padded, region_reads, final_reads, ref_bases, haplotypes)

    def prepare_region(self, reads, span: Interval, batcher, read_bounds):
        """Host-side assembly + non-blocking PairHMM launch for one region.

        batcher: a pairhmm.PoolBatcher aggregating many regions' pairs into
        pooled device launches (the VectorLoglessPairHMM.java:90 per-region
        marshaling, batched across regions instead).
        read_bounds: read_bounds_of(reads)."""
        region = self.assemble_region(reads, span, read_bounds)
        if region is None:
            return None
        args = self.args
        padded, region_reads, final_reads, ref_bases, haplotypes = region
        if args.flow_assembly_collapse_hmer_size > 0:
            from . import hap_collapsing

            if hap_collapsing.needs_collapsing(
                    bytes(ref_bases), args.flow_assembly_collapse_hmer_size):
                haplotypes = hap_collapsing.uncollapse_haplotypes(
                    haplotypes, ref_bases, padded.start,
                    args.flow_assembly_collapse_hmer_size)
        if args.assembly_region_trimming:
            from . import region_trimmer

            trimmed = region_trimmer.trim_assembly(
                haplotypes, ref_bases, padded.start, span, padded)
            if trimmed is not None:
                haplotypes, _vspan, pv, ref_bases, _ = trimmed
                padded = pv
                # finalize_region_reads returned private copies, so the
                # re-clip can mutate in place (no Read.make / tag-dict churn)
                final_reads = [rc for r in final_reads
                               if (rc := clipping.clip_to_interval_inplace(
                                   r, pv.start, pv.end)) is not None]
                if not final_reads:
                    return None
        if args.pileup_args is not None and args.pileup_args.generate_pd_haplotypes:
            # DRAGEN PDHMM pre-work (HaplotypeCallerEngine.java:798-853): merge
            # pileup-detected events with assembly events and rebuild the
            # haplotype set as PD haplotypes; on any heuristic abort fall back
            # to the assembled haplotypes.
            from . import pd_haplotypes, pileup_alleles

            good, bad = pileup_alleles.good_and_bad_pileup_events(
                region_reads, ref_bases, padded.start, args.pileup_args,
                min_base_quality=args.min_base_quality_score)
            pd_haps = pd_haplotypes.generate_pd_haplotypes(
                haplotypes, ref_bases, padded.start, (span.start, span.end),
                bad_pileup_events=bad, good_pileup_events=good,
                snp_adjacent_to_indel_range=args.pileup_args.snp_adjacent_to_assembly_indel)
            if pd_haps:
                with STAGES.stage("read_prep"):
                    prepped = read_prep.prepare_reads_for_pairhmm(final_reads)
                return dict(span=span, padded=padded, final_reads=final_reads,
                            prepped=prepped, haplotypes=pd_haps,
                            ref_bases=ref_bases, handle=None, pd_mode=True)
        if args.likelihood_engine == "FlowBasedHMM":
            # flow-space likelihoods are computed synchronously in finish_region
            # (FlowBasedHMMEngine path, utils/pairhmm/FlowBasedPairHMM.java)
            return dict(span=span, padded=padded, final_reads=final_reads,
                        prepped=None, haplotypes=haplotypes, ref_bases=ref_bases,
                        handle=None)
        with STAGES.stage("read_prep"):
            prepped = read_prep.prepare_reads_for_pairhmm(final_reads)
        with STAGES.stage("pack_dispatch"):
            handle = batcher.add_region(prepped, [h.bases for h in haplotypes])
        return dict(span=span, padded=padded, final_reads=final_reads, prepped=prepped,
                    haplotypes=haplotypes, ref_bases=ref_bases, handle=handle)

    def finish_region(self, prep):
        """Fetch the PairHMM result for a prepared region and genotype it."""
        args = self.args
        span, padded = prep["span"], prep["padded"]
        haplotypes = prep["haplotypes"]
        final_reads = prep["final_reads"]
        summary = AssemblyRegionCall(span, padded, len(final_reads), len(haplotypes))
        if prep.get("pd_mode"):
            # PDHMM path (PDPairHMMLikelihoodCalculationEngine.java:173-195):
            # batched host/native kernel, then the same normalize/filter flow
            from ..ops import pdhmm

            with STAGES.stage("device_wait"):
                mat = pdhmm.compute_pd_likelihood_matrix(
                    [h.bases for h in haplotypes],
                    [h.pd_bytes for h in haplotypes], prep["prepped"])
        elif prep["handle"] is None and args.likelihood_engine == "FlowBasedHMM":
            from ..ops import flow, flow_pairhmm

            fhaps = [flow.FlowBasedHaplotype(h.bases, args.flow_order)
                     for h in haplotypes]
            freads = [flow.flow_read_from_sam(r, args.flow_order)
                      for r in final_reads]
            mat = flow_pairhmm.compute_flow_likelihood_matrix(fhaps, freads)
        else:
            with STAGES.stage("device_wait"):
                mat = pairhmm.finish_likelihood_matrix(
                    prep["handle"], prep["prepped"], [h.bases for h in haplotypes])
        with STAGES.stage("genotype"):
            values = mat.T
            lik = AlleleLikelihoods(list(haplotypes), list(final_reads), values)
            lik.normalize_likelihoods(GLOBAL_READ_MISMAPPING_RATE_CAP)
            lik.filter_poorly_modeled_reads(
                lambda r: min(2.0, np.ceil(len(r.bases) * EXPECTED_ERROR_RATE_PER_BASE)) * -4.0
            )
            lik, haplotypes = maybe_filter_alleles(lik, args, span.start)
            variants = genotyping_engine.assign_genotype_likelihoods(
                haplotypes, lik, prep["ref_bases"], padded.start, span.start, span.end,
                span.contig, self.sample,
                standard_confidence=args.standard_confidence, ploidy=args.ploidy,
                as_annotations=args.as_annotations,
                output_mode=args.output_mode,
                genotype_assignment_method=args.genotype_assignment_method,
                apply_bqd=args.apply_bqd, apply_frd=args.apply_frd,
                max_effective_depth_adjustment_for_frd=args.max_effective_depth_adjustment_for_frd,
            )
        if self.bamout is not None:
            self.bamout.add_region(span.contig, haplotypes, lik)
        summary.variants = variants
        return variants, summary

    def prepare_gvcf_region(self, reads, span: Interval, read_bounds):
        """-ERC GVCF's host front of one region, for a pool thread:
        assemble_region, the reads' PairHMM tables and the packing of all
        reads x all haplotypes. A GvcfPrep, or None where assemble_region gives
        none. read_bounds: read_bounds_of(reads)."""
        region = self.assemble_region(reads, span, read_bounds)
        if region is None:
            return None
        prepped = read_prep.prepare_reads_for_pairhmm(region.final_reads)
        with STAGES.stage("matrix_pack"):
            packing = pairhmm.pack_likelihood_matrix(prepped, [h.bases for h in region.haplotypes])
        return GvcfPrep(span, region, prepped, packing)

    def launch_gvcf_region(self, prep: GvcfPrep, device=None):
        """The region's cartesian launch on `device`, without blocking: the
        handle for finish_gvcf_region."""
        with STAGES.stage("matrix_launch"):
            return pairhmm.launch_likelihood_matrix(prep.packing, device)

    def finish_gvcf_region(self, prep: GvcfPrep, handle):
        """Wait for a region's launch_gvcf_region and genotype it as -ERC GVCF
        does: every active allele with <NON_REF>, no confidence cut. The
        region's variants."""
        args = self.args
        span, region, prepped, _ = prep
        haplotypes = region.haplotypes
        mat = pairhmm.finish_likelihood_matrix(handle, prepped, [h.bases for h in haplotypes])
        with STAGES.stage("genotype"):
            lik = AlleleLikelihoods(list(haplotypes), list(region.final_reads), mat.T)
            lik.normalize_likelihoods(GLOBAL_READ_MISMAPPING_RATE_CAP)
            lik.filter_poorly_modeled_reads(
                lambda r: min(2.0, np.ceil(len(r.bases) * EXPECTED_ERROR_RATE_PER_BASE)) * -4.0
            )
            lik, haplotypes = maybe_filter_alleles(lik, args, span.start)
            return genotyping_engine.assign_genotype_likelihoods(
                haplotypes, lik, region.ref_bases, region.padded.start, span.start, span.end,
                span.contig, self.sample,
                standard_confidence=-0.0, ploidy=args.ploidy,
                emit_all_active=True, add_non_ref=True,
                as_annotations=args.as_annotations,
            )


def reads_overlapping(reads, bounds, start: int, end: int):
    """The reads of a coordinate-sorted list with pos < end and end > start, in
    list order: the list scan `[r for r in reads if r.pos < end and r.end > start]`
    as a searchsorted cut on the starts and one compare on the ends.
    bounds: read_bounds_of(reads)."""
    starts, ends = bounds
    k = int(np.searchsorted(starts, end, side="left"))
    return [reads[i] for i in np.flatnonzero(ends[:k] > start).tolist()]


@trace.span("hc.gvcf_interval")
def call_interval_gvcf(engine: "HaplotypeCallerEngine", reads, interval: Interval,
                       caller=None):
    """GVCF-mode calling: variant records carry <NON_REF>; hom-ref positions get
    banded reference-confidence blocks (HaplotypeCallerEngine.referenceModelForNoVariation
    + GVCFWriter flow). reads must be coordinate-sorted.
    caller: the parallel.scheduler.ShardedCaller over `engine` whose pool runs the
    active regions; None: one on the default device."""
    from ..devices import resolve_device
    from ..gvcf import refconf
    from ..parallel.scheduler import ShardedCaller

    args = engine.args
    if caller is None:
        caller = ShardedCaller(engine, [resolve_device()])
    usable, spans = engine.plan_interval(reads, interval)
    iv_ref_u = bytes(engine.ref.fetch(interval.contig, interval.start, interval.end)).upper()
    gls = []

    def ref_confidence():
        # reference confidence over the interval, from the usable reads alone:
        # on this thread while the pool threads assemble the regions
        gls.append(refconf.ref_vs_any_gls(
            usable, interval.start, interval.end, np.frombuffer(iv_ref_u, np.uint8),
            min_base_qual=args.min_base_quality_score, ploidy=args.ploidy,
        ))

    variants = caller.call_gvcf_regions(usable, spans, interval, meanwhile=ref_confidence)
    pls, dp = gls[0]

    variants = [v for v in variants if interval.start <= v.pos < interval.end]
    variants.sort(key=lambda v: v.pos)

    # mask positions covered by variants
    writer = refconf.GvcfBlockWriter(interval.contig, engine.sample, ploidy=args.ploidy)
    pos = interval.start

    def hom_ref_run(start, end):
        # the hom-ref positions [start, end), banded in bulk
        a, b = start - interval.start, end - interval.start
        writer.add_hom_ref_run(start, iv_ref_u[a:b], pls[a:b], dp[a:b])

    for v in variants:
        # skip variants that start before pos (overlapping deletions)
        if v.pos < pos:
            continue
        hom_ref_run(pos, v.pos)
        pos = v.pos
        g = v.samples[0]
        if set(g.get("GT", "0").replace("|", "/").split("/")) == {"0"}:
            # hom-ref call: collapse to a ref-block site using the
            # (0/0, 0/NON_REF, NON_REF/NON_REF) PL entries (GVCFBlockCombiner)
            pl_all = [int(x) for x in g["PL"].split(",")]
            n_alleles = 1 + len(v.alts)
            gts = genotyping_engine.genotyper.genotype_allele_counts(args.ploidy, n_alleles)
            nr = n_alleles - 1
            want = [tuple([0] * args.ploidy)]
            for k in range(1, args.ploidy + 1):
                want.append(tuple(sorted([0] * (args.ploidy - k) + [nr] * k)))
            idx = [gts.index(w) for w in want]
            pl3 = [pl_all[i] for i in idx]
            m = min(pl3)
            pl3 = [x - m for x in pl3]
            dp_v = int(g.get("DP", "0") or 0)
            writer.add_hom_ref(pos, v.ref[0], pl3, dp_v)
            pos += 1
            continue
        writer.add_variant(v)
        pos = max(pos + 1, v.end)
    hom_ref_run(pos, interval.end)
    writer.flush()
    return writer.records
