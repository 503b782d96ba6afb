# Copied verbatim from gatk_tpu/mutect/engine.py; only import lines, the PairHMM module name (pairhmm_tpu -> pairhmm) and the tracer's decorator lines (utils/trace.py) differ.
"""Mutect2 engine: tumor(-normal) somatic calling on assembled regions.

Reference behavior: mutect/Mutect2Engine.java (callRegion :254-330, read filters
:193-206), mutect/SomaticGenotypingEngine.java (callMutations :32-260,
somaticLogOdds :296-315, addGenotypes :317-338, diploidAltLogOdds :355+),
M2ArgumentCollection.java (defaults; mitochondria mode :169-189).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from ..assembly import assembler
from ..calling import read_prep
from ..calling.genotyping_engine import MergedAllele, event_to_merged_alt, merge_events_at_locus
from ..calling.hc_engine import HCArgs, correct_overlapping_pairs, finalize_region_reads, positional_downsample
from ..calling.likelihoods import AlleleLikelihoods
from ..engine.intervals import Interval
from ..io import fasta, sam
from ..io.vcf import Variant
from ..ops import pairhmm
from ..utils import trace
from . import activity as m2_activity
from . import somatic_likelihoods as sle

LN10 = math.log(10.0)
REGION_PADDING = 100
READ_QUALITY_FILTER_THRESHOLD = 20
MIN_READ_LENGTH = 30
GLOBAL_MISMAPPING_RATE = 45  # phredScaledGlobalReadMismappingRate
INFORMATIVE_READ_OVERLAP_MARGIN = 2  # M2ArgumentCollection default


@dataclass
class M2Args:
    emission_log10_odds: float = 3.0
    initial_log10_odds: float = 2.0
    mitochondria_mode: bool = False
    min_af: float = 0.0
    max_reads_per_alignment_start: int = 50
    min_base_quality_score: int = 10
    pcr_snv_qual: int = 40
    max_mnp_distance: int = 1
    callable_depth: int = 10
    # M2 uses adaptive pruning by default
    # (MutectReadThreadingAssemblerArgumentCollection.java)
    adaptive_pruning: bool = True
    # clip inverted-tandem-repeat palindrome artifacts (M2ArgumentCollection
    # dontClipITRArtifacts, default off = clipping on)
    dont_clip_itr_artifacts: bool = False

    def __post_init__(self):
        if self.mitochondria_mode:
            # mito mode lowers emission and initial LODs to 0 (M2ArgumentCollection:181-188)
            self.emission_log10_odds = 0.0
            self.initial_log10_odds = 0.0

    @property
    def emission_log_odds(self):
        return self.emission_log10_odds * LN10

    @property
    def initial_log_odds(self):
        return self.initial_log10_odds * LN10

    @property
    def alt_pseudocount(self):
        return 1.0 if self.min_af == 0.0 else 1.0 - math.log(2) / math.log(self.min_af)


def m2_read_filter(read, min_mapq=READ_QUALITY_FILTER_THRESHOLD):
    """makeStandardMutect2ReadFilters (Mutect2Engine.java:193-206)."""
    if read.is_unmapped or read.is_secondary or read.is_duplicate or read.fails_vendor_quality:
        return False
    if read.mapq < min_mapq or read.mapq == 255:
        return False
    if len(read.bases) < MIN_READ_LENGTH or len(read.bases) != len(read.quals):
        return False
    ops = read.cigar_ops
    if len(ops) == 0 or (ops == sam.OP_N).any():
        return False
    if sam.cigar_read_length(ops, read.cigar_lens) != len(read.bases):
        return False
    if sam.cigar_ref_length(ops, read.cigar_lens) == 0:
        return False
    return True


def _fragment_groups(reads):
    """Group read indices by name (AlleleLikelihoods.groupEvidence by GATKRead::getName)."""
    groups = {}
    for i, r in enumerate(reads):
        groups.setdefault(r.name, []).append(i)
    return list(groups.values())


@dataclass
class M2Call:
    variant: Variant
    tumor_log10_odds: tuple


class Mutect2Engine:
    def __init__(self, reference: fasta.FastaReference, tumor_sample: str = "SAMPLE",
                 normal_samples=(), args: M2Args | None = None):
        self.ref = reference
        self.args = args or M2Args()
        self.tumor_sample = tumor_sample
        self.normal_samples = set(normal_samples)
        # optional --germline-resource AF lookup:
        # fn(contig, pos0, ref, [alts]) -> [af per alt]
        # (SomaticGenotypingEngine.getGermlineAltAlleleFrequencies :439-463)
        self.germline_af = None

    def _popaf(self, contig, pos, ref_allele, alts):
        """POPAF INFO value: -log10 population AF per alt allele. Without a
        germline resource every allele gets the default
        (-log10(DEFAULT_AF_FOR_TUMOR_ONLY_CALLING 5e-8) = 7.30,
        M2ArgumentCollection.java:56)."""
        if self.germline_af is None:
            return ",".join("7.30" for _ in alts)
        import math as _math

        afs = self.germline_af(contig, pos, ref_allele, alts)
        return ",".join(f"{-_math.log10(min(max(af, 1e-10), 1.0)):.2f}" for af in afs)

    # ---------------- interval driver ----------------

    @trace.span("m2.call_interval")
    def call_interval(self, reads, interval: Interval, sample_of_read=None):
        """reads: coordinate-sorted reads overlapping the interval. sample_of_read:
        optional fn(read)->sample name for tumor/normal separation."""
        args = self.args
        contig_len = self.ref.contig_length(interval.contig)
        usable = [r for r in reads if m2_read_filter(r)]
        if not getattr(args, "dont_clip_itr_artifacts", False):
            # standard M2 post-filter transformer: clip inverted-tandem-repeat
            # palindrome artifacts against the reference
            # (Mutect2Engine.makeStandardMutect2PostFilterReadTransformer:208-210,
            # MIN_PALINDROME_SIZE=5)
            from ..engine.transformers import palindrome_artifact_clip

            clip = palindrome_artifact_clip(self.ref, min_palindrome_size=5)
            usable = [r for r in (clip(r) for r in usable)
                      if r is not None and len(r.bases) > 0]
        usable = positional_downsample(usable, args.max_reads_per_alignment_start)

        span_start = max(0, interval.start - REGION_PADDING)
        span_end = min(contig_len, interval.end + REGION_PADDING)
        ref_span = self.ref.fetch(interval.contig, span_start, span_end)

        raw_regions = m2_activity.find_active_regions(
            usable, span_start, span_end, ref_span, contig_len,
            args.initial_log_odds, args.pcr_snv_qual)

        # pooled cross-region PairHMM dispatch (same batching as the HC engine:
        # host assembly for region i overlaps device compute for regions < i)
        batcher = pairhmm.PoolBatcher()
        preps = []
        for rr in raw_regions:
            if not rr.is_active:
                continue
            region_span = Interval(interval.contig, span_start + rr.start, span_start + rr.end)
            if region_span.end <= interval.start or region_span.start >= interval.end:
                continue
            prep = self._prepare_region(usable, region_span, batcher)
            if prep is not None:
                preps.append(prep)
        batcher.flush()
        all_variants = []
        for prep in preps:
            all_variants.extend(self._finish_region(prep, sample_of_read))
        return [v for v in all_variants if interval.start <= v.pos < interval.end]

    @trace.stage("callable_sites")
    def count_callable_sites(self, reads, interval: Interval) -> int:
        """Sites in the interval with filtered depth >= callable_depth
        (Mutect2Engine pileup-visit counting; feeds the .stats 'callable' row)."""
        import numpy as np

        from ..io import sam

        depth = np.zeros(interval.end - interval.start + 1, np.int64)
        for r in reads:
            if not m2_read_filter(r):
                continue
            s = max(r.pos, interval.start)
            e = min(r.pos + sam.cigar_ref_length(r.cigar_ops, r.cigar_lens), interval.end)
            if s < e:
                depth[s - interval.start] += 1
                depth[e - interval.start] -= 1
        cov = np.cumsum(depth[:-1])
        return int((cov >= self.args.callable_depth).sum())

    # ---------------- region calling ----------------

    def call_region(self, reads, span: Interval, sample_of_read=None):
        batcher = pairhmm.PoolBatcher()
        prep = self._prepare_region(reads, span, batcher)
        if prep is None:
            return []
        batcher.flush()
        return self._finish_region(prep, sample_of_read)

    @trace.span("m2.prepare_region")
    def _prepare_region(self, reads, span: Interval, batcher):
        """Host-side finalize + assembly + pooled PairHMM dispatch."""
        args = self.args
        contig_len = self.ref.contig_length(span.contig)
        padded = span.expand(REGION_PADDING, contig_len)
        region_reads = [r for r in reads if r.pos < padded.end and r.end > padded.start]
        hc_args = HCArgs(min_base_quality_score=args.min_base_quality_score)
        final_reads = finalize_region_reads(region_reads, padded, hc_args)
        if not final_reads:
            return None

        ref_bases = self.ref.fetch(span.contig, padded.start, padded.end)
        result = assembler.assemble(final_reads, ref_bases, padded.start,
                                    min_base_qual=args.min_base_quality_score,
                                    adaptive_pruning=args.adaptive_pruning)
        haplotypes = result.haplotypes
        if len(haplotypes) <= 1 or not any(h.events for h in haplotypes):
            return None
        prepped = read_prep.prepare_reads_for_pairhmm(final_reads)
        handle = batcher.add_region(prepped, [h.bases for h in haplotypes])
        return dict(span=span, padded=padded, final_reads=final_reads,
                    prepped=prepped, haplotypes=haplotypes, handle=handle)

    @trace.span("m2.finish_region")
    def _finish_region(self, prep, sample_of_read=None):
        """Fetch the pooled likelihoods and run somatic genotyping."""
        span, padded = prep["span"], prep["padded"]
        haplotypes, final_reads = prep["haplotypes"], prep["final_reads"]
        # read x haplotype log10 likelihoods -> natural log
        mat10 = pairhmm.finish_likelihood_matrix(
            prep["handle"], prep["prepped"], [h.bases for h in haplotypes])
        lik = AlleleLikelihoods(list(haplotypes), list(final_reads), mat10.T * LN10)
        lik.normalize_likelihoods(-(GLOBAL_MISMAPPING_RATE / 10.0) * LN10, True)

        # fragment grouping: log-likelihood of a fragment = sum over its reads
        groups = _fragment_groups(final_reads)
        frag_values = np.stack([lik.values[:, idx].sum(axis=1) for idx in groups], axis=1)
        fragments = [[final_reads[i] for i in idx] for idx in groups]

        return self._call_mutations(haplotypes, fragments, frag_values, span, padded)

    @staticmethod
    def _read_offset_at(read, loc):
        """read index aligned at 0-based ref position loc, or None."""
        read_i = 0
        ref_i = read.pos
        for op, ln in zip(read.cigar_ops, read.cigar_lens):
            ln = int(ln)
            if op in (sam.OP_M, sam.OP_EQ, sam.OP_X):
                if ref_i <= loc < ref_i + ln:
                    return read_i + (loc - ref_i)
                read_i += ln
                ref_i += ln
            elif op in (sam.OP_D, sam.OP_N):
                if ref_i <= loc < ref_i + ln:
                    return None
                ref_i += ln
            elif op in (sam.OP_I, sam.OP_S):
                read_i += ln
        return None

    def _allele_annotations(self, alleles, fragments, vals, loc):
        """(MBQ, MMQ, MFRL, MPOS, SB) per-allele medians over best-assigned
        fragments (annotator/PerAlleleAnnotation semantics)."""
        n_alleles = len(alleles)
        per = {k: [[] for _ in range(n_alleles)] for k in ("bq", "mq", "frl", "pos")}
        sb = np.zeros(4, int)
        f1r2 = np.zeros(n_alleles, int)
        f2r1 = np.zeros(n_alleles, int)
        order = np.argsort(-vals, axis=0)
        best = order[0]
        second = vals[order[1], np.arange(vals.shape[1])] if n_alleles > 1 else np.full(vals.shape[1], -np.inf)
        conf = vals[best, np.arange(vals.shape[1])] - second
        for fi, frag in enumerate(fragments):
            if conf[fi] < 0.2:
                continue
            ai = int(best[fi])
            for read in frag:
                off = self._read_offset_at(read, loc)
                per["mq"][ai].append(read.mapq)
                per["frl"][ai].append(abs(read.tlen))
                if off is not None:
                    per["bq"][ai].append(int(read.quals[off]))
                    per["pos"][ai].append(min(off, len(read.bases) - 1 - off))
                if ai == 0:
                    sb[1 if read.is_reverse else 0] += 1
                else:
                    sb[3 if read.is_reverse else 2] += 1
                if read.is_paired:
                    if read.is_f1r2:
                        f1r2[ai] += 1
                    else:
                        f2r1[ai] += 1
        med = lambda v, d=0: int(np.median(v)) if v else d
        return (
            [med(per["bq"][a]) for a in range(n_alleles)],
            [med(per["mq"][a], 60) for a in range(n_alleles)],
            [med(per["frl"][a]) for a in range(n_alleles)],
            [med(per["pos"][a]) for a in range(1, n_alleles)],
            sb,
            f1r2,
            f2r1,
        )

    @trace.stage("somatic_genotype")
    def _call_mutations(self, haplotypes, fragments, frag_log_liks, span, padded):
        args = self.args
        variants = []
        start_positions = sorted(
            {e.start for h in haplotypes for e in h.events if span.start <= e.start < span.end}
        )
        prior_ref = 1.0
        prior_alt = args.alt_pseudocount

        for loc in start_positions:
            events_here, seen = [], set()
            for h in haplotypes:
                for e in h.events:
                    if e.start == loc and (e.ref, e.alt) not in seen:
                        seen.add((e.ref, e.alt))
                        events_here.append(e)
            if not events_here:
                continue
            longest_ref, alts = merge_events_at_locus(events_here)
            if not alts:
                continue
            alleles = [MergedAllele(longest_ref, longest_ref, is_ref=True)] + [
                MergedAllele(longest_ref, a) for a in alts
            ]
            allele_map = {a: [] for a in alleles}
            for h in haplotypes:
                ev = next((e for e in h.events if e.start == loc), None)
                if ev is None:
                    spanning = any(e.start < loc < e.end - 1 and e.is_indel() for e in h.events)
                    if not spanning:
                        allele_map[alleles[0]].append(h)
                    continue
                alt = event_to_merged_alt(ev, longest_ref)
                target = next((a for a in alleles[1:] if a.alt == alt), None)
                if target is not None:
                    allele_map[target].append(h)
            for a in list(allele_map.keys()):
                if not a.is_ref and not allele_map[a]:
                    del allele_map[a]
            alleles = list(allele_map.keys())
            if len(alleles) < 2:
                continue

            # marginalize fragments to alleles: max over supporting haplotypes
            hap_index = {id(h): i for i, h in enumerate(haplotypes)}
            values = np.full((len(alleles), frag_log_liks.shape[1]), -np.inf)
            for ai, a in enumerate(alleles):
                idx = [hap_index[id(h)] for h in allele_map[a]]
                if idx:
                    values[ai] = frag_log_liks[idx].max(axis=0)

            # retain fragments overlapping the variant +/- margin
            lo = loc - INFORMATIVE_READ_OVERLAP_MARGIN
            hi = loc + len(longest_ref) + INFORMATIVE_READ_OVERLAP_MARGIN
            keep = np.array([
                any(r.pos < hi and r.end > lo for r in frag) for frag in fragments
            ])
            vals = values[:, keep]
            if vals.shape[1] == 0:
                continue

            # somatic log odds per alt allele
            pseudo_all = np.array([prior_ref] + [prior_alt] * (len(alleles) - 1))
            log_ev_all = sle.log_evidence(vals, pseudo_all)
            tumor_log_odds = {}
            for ai in range(1, len(alleles)):
                sub = np.delete(vals, ai, axis=0)
                pseudo_sub = np.delete(pseudo_all, ai)
                log_ev_without = sle.log_evidence(sub, pseudo_sub)
                tumor_log_odds[ai] = log_ev_all - log_ev_without

            emitted = [ai for ai in range(1, len(alleles))
                       if tumor_log_odds[ai] > args.emission_log_odds]
            if not emitted:
                continue
            emitted.sort(key=lambda ai: -tumor_log_odds[ai])
            emit_alleles = [alleles[0]] + [alleles[ai] for ai in emitted]

            # genotype annotations over the emitted alleles
            sel = [0] + emitted
            sub_vals = vals[sel]
            counts = sle.effective_counts(sub_vals)
            flat = np.ones(len(sel))
            af_post = sle.allele_fractions_posterior(sub_vals, flat) if sub_vals.shape[1] else flat
            af_mean = af_post / af_post.sum()

            dp = int(round(counts.sum()))
            tlods = [tumor_log_odds[ai] / LN10 for ai in emitted]
            gt = "/".join(str(i) for i in range(len(emit_alleles)))

            kept_frags = [f for f, k in zip(fragments, keep) if k]
            mbq, mmq, mfrl, mpos, sb, f1r2, f2r1 = self._allele_annotations(
                emit_alleles, kept_frags, sub_vals, loc)
            # ECNTH: events in each alt's best supporting haplotype
            # (GATKVCFConstants.EVENT_COUNT_IN_HAPLOTYPE_KEY; consumed by
            # filtering/ClusteredEventsFilter.java)
            ecnth = [max((len(h.events) for h in allele_map[alleles[ai]]), default=1)
                     for ai in emitted]
            variants.append(Variant(
                contig=span.contig,
                pos=loc,
                ref=longest_ref,
                alts=tuple(a.alt for a in emit_alleles[1:]),
                qual=None,
                filters=(),
                info={
                    "DP": str(dp),
                    "ECNT": str(len(start_positions)),
                    "ECNTH": ",".join(str(x) for x in ecnth),
                    "MBQ": ",".join(str(x) for x in mbq),
                    "MFRL": ",".join(str(x) for x in mfrl),
                    "MMQ": ",".join(str(x) for x in mmq),
                    "MPOS": ",".join(str(x) for x in mpos),
                    "POPAF": self._popaf(span.contig, loc, longest_ref,
                                         [a.alt for a in emit_alleles[1:]]),
                    "TLOD": ",".join(f"{t:.2f}" for t in tlods),
                },
                fmt_keys=("GT", "AD", "AF", "DP", "F1R2", "F2R1", "SB"),
                samples=[{
                    "GT": gt,
                    "AD": ",".join(str(int(round(c))) for c in counts),
                    "AF": ",".join(f"{f:.3f}" for f in af_mean[1:]),
                    "DP": str(dp),
                    "F1R2": ",".join(str(int(x)) for x in f1r2),
                    "F2R1": ",".join(str(int(x)) for x in f2r1),
                    "SB": ",".join(str(int(x)) for x in sb),
                }],
            ))
        return variants


def _match_allele(ref_a: str, alt_a: str, ref_b: str, alt_b: str) -> bool:
    """Allele equality across parsimony representations: extend the shorter
    ref with the longer ref's tail and compare alts (e.g. ref A, alt C equals
    germline ref AT, alt CT; GATKVariantContextUtils.alleleIndices)."""
    if ref_a == ref_b:
        return alt_a == alt_b
    if len(ref_a) < len(ref_b):
        if not ref_b.startswith(ref_a):
            return False
        return alt_a + ref_b[len(ref_a):] == alt_b
    if not ref_a.startswith(ref_b):
        return False
    return alt_a == alt_b + ref_a[len(ref_b):]


def make_germline_af_lookup(path: str, default_af: float):
    """AF lookup over a germline resource VCF (gnomAD-class). Uses the .tbi
    index when present (engine/FeatureDataSource.java:68 lookahead caching via
    io/tabix.FeatureDataSource) so whole-genome resources are never fully
    decompressed; falls back to one in-memory pass otherwise.

    Returns fn(contig, pos0, ref, [alts]) -> [af per alt], with alleles not in
    the resource getting default_af (getGermlineAltAlleleFrequencies :439-463).
    """
    import os

    from ..io import vcf as vcfio

    if os.path.exists(path + ".tbi"):
        from ..io.tabix import FeatureDataSource

        src = FeatureDataSource(path)

        def overlapping(contig, pos):
            return src.query(contig, pos, pos + 1)
    else:
        by_contig: dict = {}
        for v in vcfio.VcfReader(path):
            by_contig.setdefault(v.contig, []).append(v)

        def overlapping(contig, pos):
            import bisect

            vs = by_contig.get(contig, [])
            # resource variants whose span [pos, pos+len(ref)) covers pos
            out = []
            i = bisect.bisect_right([x.pos for x in vs], pos)
            for v in vs[max(0, i - 100):i]:
                if v.pos <= pos < v.pos + len(v.ref):
                    out.append(v)
            return out

    def lookup(contig, pos, ref_allele, alts):
        afs = [default_af] * len(alts)
        for gv in overlapping(contig, pos):
            raw = gv.info.get("AF")
            if raw is None:
                continue
            g_afs = [x for x in str(raw).split(",")]
            if len(g_afs) != len(gv.alts):
                continue
            for i, alt in enumerate(alts):
                for j, galt in enumerate(gv.alts):
                    if _match_allele(ref_allele, alt, gv.ref, galt):
                        try:
                            afs[i] = float(g_afs[j])
                        except ValueError:
                            pass
                        break
        return afs

    return lookup
