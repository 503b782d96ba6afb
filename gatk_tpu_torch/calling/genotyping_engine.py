# Copied verbatim from gatk_tpu/calling/genotyping_engine.py; only import lines and the tracer's decorator lines (utils/trace.py) differ.
"""Assembly-based genotyping (HaplotypeCallerGenotypingEngine equivalent).

Reference behavior: haplotypecaller/HaplotypeCallerGenotypingEngine.java:120-292 —
per event-start locus: merge events across haplotypes into a variant context,
build the allele->haplotype map, marginalize read likelihoods, compute diploid GLs,
run the exact AF calculation, emit calls above the confidence threshold.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..assembly.haplotype import Event
from ..io import sam
from ..io.vcf import Variant
from ..utils import trace
from . import genotyper
from .likelihoods import AlleleLikelihoods

STANDARD_CONFIDENCE_FOR_CALLING = 30.0
ALLELE_EXTENSION = 2
MAX_ALT_ALLELES = 6


@dataclass(frozen=True)
class MergedAllele:
    """An allele at a merged locus: VCF-style ref/alt strings."""

    ref: str
    alt: str
    is_ref: bool = False


def merge_events_at_locus(events_here: list) -> tuple:
    """Merge events starting at one locus into common-ref representation
    (AssemblyBasedCallerUtils.makeMergedVariantContext semantics):
    ref = longest event ref; shorter events' alts get the ref suffix appended."""
    longest_ref = max((e.ref for e in events_here), key=len)
    alts = []
    for e in events_here:
        suffix = longest_ref[len(e.ref) :]
        alt = e.alt + suffix
        if alt not in alts and alt != longest_ref:
            alts.append(alt)
    return longest_ref, alts


def event_to_merged_alt(e: Event, longest_ref: str) -> str:
    return e.alt + longest_ref[len(e.ref) :]


@trace.stage("genotype")
def assign_genotype_likelihoods(
    haplotypes,
    read_likelihoods: AlleleLikelihoods,
    ref_bases: np.ndarray,
    ref_start: int,
    span_start: int,
    span_end: int,
    contig: str,
    sample: str,
    af_calc: genotyper.AlleleFrequencyCalculator | None = None,
    standard_confidence: float = STANDARD_CONFIDENCE_FOR_CALLING,
    ploidy: int = 2,
    emit_all_active: bool = False,
    add_non_ref: bool = False,
    as_annotations: bool = False,
    output_mode: str = "EMIT_VARIANTS_ONLY",
    genotype_assignment_method: str = "USE_PLS_TO_ASSIGN",
    apply_bqd: bool = False,
    apply_frd: bool = False,
    max_effective_depth_adjustment_for_frd: int = 0,
):
    """Produce Variant records for one assembled region.

    read_likelihoods: haplotype-level AlleleLikelihoods (alleles = haplotypes).
    span_start/span_end: the unpadded active region span (calls outside are dropped).
    """
    af_calc = af_calc or genotyper.AlleleFrequencyCalculator(ploidy=ploidy)
    start_positions = sorted(
        {e.start for h in haplotypes for e in h.events if span_start <= e.start < span_end}
    )
    variants = []
    call_support = {}  # id(variant) -> frozenset of supporting haplotype ids (phasing)
    for loc in start_positions:
        events_here = []
        seen = set()
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
        alts = alts[:MAX_ALT_ALLELES]
        alleles = [MergedAllele(longest_ref, longest_ref, is_ref=True)] + [
            MergedAllele(longest_ref, a) for a in alts
        ]

        # allele -> supporting haplotypes (haplotypes with no event at loc support ref)
        allele_map = {a: [] for a in alleles}
        for h in haplotypes:
            # PD haplotypes are genotyped only at their determined position
            # (AssemblyBasedCallerUtils.createAlleleMapper :662-665)
            det_pos = getattr(h, "determined_position", None)
            if det_pos is not None and det_pos != loc:
                continue
            ev = next((e for e in h.events if e.start == loc), None)
            if ev is None:
                # spanning deletion from an upstream event makes the haplotype
                # support neither ref nor alt here; GATK uses the span-del allele.
                spanning = any(e.start < loc < e.end - 1 and e.is_indel() for e in h.events)
                if not spanning:
                    allele_map[alleles[0]].append(h)
                continue
            alt = event_to_merged_alt(ev, longest_ref)
            target = next((a for a in alleles[1:] if a.alt == alt), None)
            if target is not None:
                allele_map[target].append(h)
        # drop alt alleles with no supporting haplotype
        for a in list(allele_map.keys()):
            if not a.is_ref and not allele_map[a]:
                del allele_map[a]
        alleles = list(allele_map.keys())
        if len(alleles) < 2:
            continue

        marginal = read_likelihoods.marginalize(allele_map)
        # keep reads overlapping the variant (with small extension)
        marginal.retain_reads_overlapping(loc - ALLELE_EXTENSION + 1, loc + len(longest_ref) + ALLELE_EXTENSION - 1)
        if marginal.n_reads == 0:
            continue
        if add_non_ref:
            # AlleleLikelihoods.addNonReferenceAllele: per read, the median of
            # the non-best allele likelihoods
            vals = marginal.values
            if vals.shape[0] == 1:
                nonref = vals[0].copy()
            else:
                srt = np.sort(vals, axis=0)  # ascending; drop the max (last row)
                nonref = np.median(srt[:-1], axis=0)
            alleles = alleles + [MergedAllele(longest_ref, "<NON_REF>")]
            marginal = AlleleLikelihoods(
                list(marginal.alleles) + [alleles[-1]], marginal.reads,
                np.vstack([vals, nonref[None, :]]),
            )

        gl = genotyper.compute_genotype_likelihoods(marginal.values, ploidy)
        if apply_bqd or apply_frd:
            # DRAGEN advanced genotyping: merge BQD/FRD model scores into the
            # standard likelihoods (DRAGENGenotypesModel.java:106-162)
            from . import dragen_genotypes

            gl = dragen_genotypes.apply_dragen_models(
                gl, marginal.values, [alleles[0].ref] + [a.alt for a in alleles[1:]],
                marginal.reads, loc, ref_bases, ref_start, ploidy=ploidy,
                use_bqd=apply_bqd, use_frd=apply_frd,
                max_effective_depth=max_effective_depth_adjustment_for_frd)
        pl = genotyper.gls_to_pls(gl)
        gl_quantized = genotyper.pls_to_gls(pl)

        allele_lengths = [len(longest_ref)] + [
            len(longest_ref) if a.alt == "<NON_REF>" else len(a.alt) for a in alleles[1:]
        ]
        af = af_calc.calculate(allele_lengths, len(longest_ref), [gl_quantized], ploidy)
        phred_no_variant = -10.0 * af.log10_p_no_variant
        filters = ()
        if phred_no_variant < standard_confidence and not emit_all_active:
            # GenotypingEngine.calculateGenotypes output-mode gate
            # (walkers/genotyper/OutputMode.java): CONFIDENT_SITES also emits
            # confident hom-ref calls; ACTIVE_SITES force-emits with LowQual
            if output_mode == "EMIT_VARIANTS_ONLY":
                continue
            gts_chk = genotyper.genotype_allele_counts(ploidy, len(alleles))
            best_is_ref = all(a == 0 for a in gts_chk[int(np.argmin(pl))])
            pl_srt = np.sort(pl)
            ref_conf = int(min(pl_srt[1] - pl_srt[0], 99))
            if output_mode == "EMIT_ALL_CONFIDENT_SITES":
                if not (best_is_ref and ref_conf >= standard_confidence):
                    continue
            elif output_mode == "EMIT_ALL_ACTIVE_SITES":
                filters = ("LowQual",)
            else:
                continue

        # genotype assignment (GenotypeAssignmentMethod):
        # USE_PLS_TO_ASSIGN (default) or USE_POSTERIOR_PROBABILITIES (the
        # DRAGEN-mode method: PL likelihoods weighted by the AF-calculator's
        # Dirichlet-posterior allele frequencies)
        gts = genotyper.genotype_allele_counts(ploidy, len(alleles))
        if genotype_assignment_method == "USE_POSTERIOR_PROBABILITIES":
            log10_af = np.log10(np.maximum(af.allele_posterior_frequencies, 1e-10)) \
                if hasattr(af, "allele_posterior_frequencies") else None
            if log10_af is None:
                # fall back to MLE counts as frequency estimates
                counts_mle = np.asarray([ploidy - sum(af.allele_counts_mle),
                                         *af.allele_counts_mle], float)
                freqs = np.maximum(counts_mle, 0.5) / max(counts_mle.sum(), 1.0)
                log10_af = np.log10(freqs)
            log10_prior = np.array([sum(log10_af[a] for a in gt) for gt in gts])
            log10_post = -0.1 * pl + log10_prior
            log10_post -= log10_post.max()
            best_gt_idx = int(np.argmax(log10_post))
            post_pl = np.round(-10.0 * (log10_post - log10_post.max())).astype(int)
            srt = np.sort(post_pl)
            gq = int(min(srt[1] - srt[0], 99))
        else:
            best_gt_idx = int(np.argmin(pl))
            pl_sorted = np.sort(pl)
            gq = int(min(pl_sorted[1] - pl_sorted[0], 99))
        gt_tuple = gts[best_gt_idx]

        counts = marginal.counts_by_allele()
        dp = int(counts.sum())
        qual = float(np.round(phred_no_variant, 2))

        info = _standard_annotations(
            marginal, alleles, loc, gt_tuple, counts, phred_no_variant,
            n_non_ref := sum(1 for a in gt_tuple if a != 0), af, ploidy)
        fmt_keys = ("GT", "AD", "DP", "GQ", "PL")
        sample_fmt = {
            "GT": "/".join(str(a) for a in gt_tuple),
            "AD": ",".join(str(int(c)) for c in counts),
            "DP": str(dp),
            "GQ": str(gq),
            "PL": ",".join(str(int(p)) for p in pl),
        }
        if as_annotations:
            info.update(_allele_specific_annotations(
                marginal, alleles, loc, phred_no_variant, counts,
                gvcf=add_non_ref))
            info = {k: info[k] for k in sorted(info)}
            if add_non_ref and "AS_SB_TABLE" in info:
                # per-sample SB (refFwd,refRev,altFwd,altRev summed over alts)
                rows = [s.split(",") for s in info["AS_SB_TABLE"].split("|")]
                sample_fmt["SB"] = ",".join(map(str, (
                    rows[0][0], rows[0][1],
                    sum(int(r[0]) for r in rows[1:]),
                    sum(int(r[1]) for r in rows[1:]))))
                fmt_keys = fmt_keys + ("SB",)

        v = Variant(
            contig=contig,
            pos=loc,
            ref=longest_ref,
            alts=tuple(a.alt for a in alleles[1:]),
            qual=qual,
            filters=filters,
            info=info,
            fmt_keys=fmt_keys,
            samples=[sample_fmt],
        )
        variants.append(v)
        # haplotypes supporting the first site-specific alt (phasing input;
        # constructHaplotypeMapping)
        first_alt = next((a for a in alleles[1:] if a.alt != "*" and not a.alt.startswith("<")), None)
        if first_alt is not None:
            call_support[id(v)] = frozenset(id(h) for h in allele_map.get(first_alt, ()))

    # physical phasing (AssemblyBasedCallerUtils.phaseCalls)
    if len(variants) > 1:
        from . import phasing

        hap_weakness = {id(h): (h.weakness if h.weakness < (1 << 29) else 0)
                        for h in haplotypes}
        phasing.phase_calls(variants, call_support, hap_weakness)
    return variants


def _read_offset_at(read, loc):
    """Read index aligned at 0-based ref position loc, or None (deletion/outside)."""
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


def _standard_annotations(marginal, alleles, loc, gt_tuple, counts, qual, n_non_ref, af, ploidy):
    """Standard HC INFO annotations (walkers/annotator/ standard set) computed
    from the read-vs-allele likelihoods: DP, MQ, FS, SOR, QD, rank sums,
    AC/AF/AN, MLEAC/MLEAF, ExcessHet."""
    from ..gvcf.annotations import (
        excess_het_phred,
        fisher_strand_phred,
        format_vcf_double,
        mann_whitney_z,
        rms_mapping_quality,
        strand_odds_ratio,
    )

    info = {}
    best_idx, _best, conf = marginal.best_alleles()
    reads = marginal.reads
    an = ploidy
    ac = [sum(1 for a in gt_tuple if a == i) for i in range(len(alleles))]
    info["AC"] = ",".join(str(c) for c in ac[1:] if True)
    info["AF"] = ",".join(format_vcf_double(c / an) for c in ac[1:])
    info["AN"] = str(an)

    # informative reads by best allele
    is_informative = conf > 0.2
    sb = [0, 0, 0, 0]
    ref_bq, alt_bq, ref_mq, alt_mq, ref_pos, alt_pos = [], [], [], [], [], []
    for ri, read in enumerate(reads):
        if not is_informative[ri]:
            continue
        is_alt = best_idx[ri] != 0
        if is_alt:
            sb[3 if read.is_reverse else 2] += 1
        else:
            sb[1 if read.is_reverse else 0] += 1
        (alt_mq if is_alt else ref_mq).append(read.mapq)
        off = _read_offset_at(read, loc)
        if off is not None:
            (alt_bq if is_alt else ref_bq).append(int(read.quals[off]))
            (alt_pos if is_alt else ref_pos).append(min(off, len(read.bases) - 1 - off))

    info["DP"] = str(marginal.n_reads)
    info["ExcessHet"] = f"{excess_het_phred(1 if len(set(gt_tuple)) > 1 else 0, 1 if (len(set(gt_tuple)) == 1 and gt_tuple[0] != 0) else 0, 1):.4f}"
    info["FS"] = f"{fisher_strand_phred(*sb):.3f}"
    all_mq = [r.mapq for r in reads]
    info["MLEAC"] = ",".join(str(int(c)) for c in af.allele_counts_mle)
    info["MLEAF"] = ",".join(format_vcf_double(c / an) for c in af.allele_counts_mle)
    info["MQ"] = f"{rms_mapping_quality(all_mq):.2f}"
    for key, alt_v, ref_v in (("BaseQRankSum", alt_bq, ref_bq),
                              ("MQRankSum", alt_mq, ref_mq),
                              ("ReadPosRankSum", alt_pos, ref_pos)):
        z = mann_whitney_z(alt_v, ref_v)
        if z is not None:
            info[key] = format_vcf_double(z)
    depth_for_qd = int(counts.sum()) if n_non_ref else 0
    if depth_for_qd > 0:
        qd = qual / depth_for_qd
        if qd >= 35.0:
            from ..utils.javarandom import get_random_generator

            qd = 30.0 + get_random_generator().next_gaussian() * 3.0
        info["QD"] = f"{qd:.2f}"
    info["SOR"] = f"{strand_odds_ratio(*sb):.3f}"
    return {k: info[k] for k in sorted(info)}


def _allele_specific_annotations(marginal, alleles, loc, qual, counts,
                                 gvcf: bool = False):
    """AS_* reducible annotations, raw phase (tools/walkers/annotator/
    allelespecific/AS_RankSumTest.java annotateRawData, AS_RMSMappingQuality,
    AS_StrandBiasTest AS_SB_TABLE).

    VCF mode emits per-allele integer value,count lists (CompressedDataList
    form, expected.testVCFMode.gatk4.alleleSpecific.vcf); GVCF mode emits the
    per-alt rank-sum z singleton histograms (`|z,1|NaN` form,
    expected.testGVCFMode.gatk4.alleleSpecific.g.vcf). Finalized AS_ values
    (AS_FS/AS_SOR/AS_MQ/AS_QD/AS_*RankSum) are produced downstream by
    GenotypeGVCFs / VariantAnnotator via calling/as_annotations.py."""
    from ..gvcf.annotations import (
        fisher_strand_phred,
        format_vcf_double,
        mann_whitney_z,
        rms_mapping_quality,
        strand_odds_ratio,
    )

    n_alleles = len(alleles)
    best_idx, _best, conf = marginal.best_alleles()
    reads = marginal.reads
    sb = [[0, 0] for _ in range(n_alleles)]
    mq = [[] for _ in range(n_alleles)]
    bq = [[] for _ in range(n_alleles)]
    pos = [[] for _ in range(n_alleles)]
    for ri, read in enumerate(reads):
        if conf[ri] <= 0.2:
            continue
        ai = int(best_idx[ri])
        sb[ai][1 if read.is_reverse else 0] += 1
        mq[ai].append(read.mapq)
        off = _read_offset_at(read, loc)
        if off is not None:
            bq[ai].append(int(read.quals[off]))
            pos[ai].append(min(off, len(read.bases) - 1 - off))

    from . import as_annotations as asmod

    info = {}
    info["AS_SB_TABLE"] = "|".join(f"{f},{r}" for f, r in sb)
    raw_mq = [float(sum(m * m for m in mq[ai])) for ai in range(n_alleles)]
    info["AS_RAW_MQ"] = asmod.format_raw_mq(raw_mq)
    if gvcf:
        # per-alt z-score singleton histograms (AS_RankSumTest
        # makeRawAnnotationString; '' ref section, NaN when incomputable)
        for key, vals in (("AS_RAW_BaseQRankSum", bq), ("AS_RAW_MQRankSum", mq),
                          ("AS_RAW_ReadPosRankSum", pos)):
            hists = [asmod.ZHistogram() for _ in range(n_alleles)]
            for ai in range(1, n_alleles):
                z = mann_whitney_z(vals[ai], vals[0])
                if z is not None:
                    hists[ai].add(z)
            info[key] = asmod.format_histogram_sections(hists)
    else:
        info["AS_RAW_BaseQRankSum"] = asmod.format_int_lists(bq)
        info["AS_RAW_MQRankSum"] = asmod.format_int_lists(mq)
        info["AS_RAW_ReadPosRankSum"] = asmod.format_int_lists(pos)
    return info
