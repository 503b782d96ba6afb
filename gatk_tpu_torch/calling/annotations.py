# Copied verbatim from gatk_tpu/calling/annotations.py; only import lines may differ.
"""Pluggable variant-annotation engine (VariantAnnotatorEngine equivalent).

Reference: tools/walkers/annotator/VariantAnnotatorEngine.java +
VariantAnnotator.java and the annotation classes under walkers/annotator/.
Each annotation is a small class with `keys` (INFO keys it writes) and
`annotate(ctx) -> dict`; the engine runs a configurable set over a
VariantContext-like bundle of (variant, overlapping reads, reference,
optional per-sample genotypes). Registered names match the reference class
names so `-A AnnotationName` command lines port directly.

Annotations that need read-vs-haplotype likelihoods (RankSum family, FS/SOR
from informative reads) stay inline in genotyping_engine._standard_annotations;
this engine covers the pileup/genotype-derived set and powers the
VariantAnnotator tool (re-annotation of an existing VCF against a BAM).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..gvcf.annotations import (fisher_strand_phred, format_vcf_double,
                                inbreeding_coefficient, mann_whitney_z,
                                rms_mapping_quality, strand_odds_ratio)


@dataclass
class AnnotationContext:
    """Everything an annotation may inspect (VariantContext + ReadLikelihoods
    stand-in: here reads come from a pileup over the variant site)."""
    variant: object                 # io.vcf.Variant
    reads: list = field(default_factory=list)   # overlapping, filter-passing reads
    reference: object = None        # FastaReference or None
    # per-read allele support: +1 alt, 0 ref, -1 uninformative (filled by engine)
    read_allele: np.ndarray | None = None
    # per-read best-allele index over [ref, alt1, alt2, ...] (-1 uninformative);
    # finer-grained than read_allele for multi-allelic per-allele annotations
    read_best_allele: np.ndarray | None = None
    # per-read best log10 likelihood (LikelihoodRankSumTest et al.); None when
    # no read-likelihood engine backs the context (pileup-only annotation runs)
    read_likelihood: np.ndarray | None = None
    # multi-sample genotype dicts (sample -> FORMAT map) for cohort annotations
    genotypes: dict | None = None
    # pedigree trios [(mother, father, child) sample names] for family annotations
    trios: list = field(default_factory=list)
    # assembly haplotypes (with .events) + per-haplotype best-read support counts
    haplotypes: list = field(default_factory=list)
    haplotype_support: np.ndarray | None = None
    n_filtered_haplotypes: int = 0
    flow_order: str = "TGCA"

    def alt_reads(self):
        if self.read_allele is None:
            return []
        return [r for r, a in zip(self.reads, self.read_allele) if a > 0]

    def ref_reads(self):
        if self.read_allele is None:
            return []
        return [r for r, a in zip(self.reads, self.read_allele) if a == 0]


class Annotation:
    keys: tuple = ()

    def annotate(self, ctx: AnnotationContext) -> dict:
        raise NotImplementedError


class Coverage(Annotation):
    """DP (Coverage.java)."""
    keys = ("DP",)

    def annotate(self, ctx):
        return {"DP": str(len(ctx.reads))} if ctx.reads else {}


class MappingQualityZero(Annotation):
    """MQ0 (MappingQualityZero.java)."""
    keys = ("MQ0",)

    def annotate(self, ctx):
        if not ctx.reads:
            return {}
        return {"MQ0": str(sum(1 for r in ctx.reads if r.mapq == 0))}


class RMSMappingQuality(Annotation):
    """MQ (RMSMappingQuality.java finalized form)."""
    keys = ("MQ",)

    def annotate(self, ctx):
        if not ctx.reads:
            return {}
        return {"MQ": f"{rms_mapping_quality([r.mapq for r in ctx.reads]):.2f}"}


class CountNs(Annotation):
    """NCount: reads with an N at the variant site (CountNs.java)."""
    keys = ("NCount",)

    def annotate(self, ctx):
        n = 0
        for r in ctx.reads:
            off = read_offset_at(r, ctx.variant.pos)
            if off is not None and r.bases[off] in (ord("N"), ord("n")):
                n += 1
        return {"NCount": str(n)} if n else {}


class FragmentLength(Annotation):
    """MFRL-style median fragment length per ref/alt (FragmentLength.java)."""
    keys = ("MFRL",)

    def annotate(self, ctx):
        if ctx.read_allele is None:
            return {}
        ref = [abs(r.tlen) for r in ctx.ref_reads() if r.tlen]
        alt = [abs(r.tlen) for r in ctx.alt_reads() if r.tlen]
        med = lambda v: int(np.median(v)) if v else 0  # noqa: E731
        return {"MFRL": f"{med(ref)},{med(alt)}"}


class BaseQualityAnn(Annotation):
    """MBQ: median base quality per ref/alt (BaseQuality.java)."""
    keys = ("MBQ",)

    def annotate(self, ctx):
        if ctx.read_allele is None:
            return {}
        pos = ctx.variant.pos
        vals = {0: [], 1: []}
        for r, a in zip(ctx.reads, ctx.read_allele):
            if a < 0:
                continue
            off = read_offset_at(r, pos)
            if off is not None:
                vals[1 if a > 0 else 0].append(int(r.quals[off]))
        med = lambda v: int(np.median(v)) if v else 0  # noqa: E731
        return {"MBQ": f"{med(vals[0])},{med(vals[1])}"}


class ReadPosition(Annotation):
    """MPOS: median distance from end of read, alt reads (ReadPosition.java)."""
    keys = ("MPOS",)

    def annotate(self, ctx):
        if ctx.read_allele is None:
            return {}
        d = []
        for r in ctx.alt_reads():
            off = read_offset_at(r, ctx.variant.pos)
            if off is not None:
                d.append(min(off, len(r.bases) - 1 - off))
        return {"MPOS": str(int(np.median(d)))} if d else {}


class UniqueAltReadCount(Annotation):
    """UNIQ_ALT_READ_COUNT: alt reads deduped by (start, fragment length)
    (UniqueAltReadCount.java)."""
    keys = ("UNIQ_ALT_READ_COUNT",)

    def annotate(self, ctx):
        if ctx.read_allele is None:
            return {}
        uniq = {(r.pos, r.tlen) for r in ctx.alt_reads()}
        return {"UNIQ_ALT_READ_COUNT": str(len(uniq))}


class MappingQualityRankSumTest(Annotation):
    """MQRankSum from the pileup split (MappingQualityRankSumTest.java)."""
    keys = ("MQRankSum",)

    def annotate(self, ctx):
        if ctx.read_allele is None:
            return {}
        z = mann_whitney_z([r.mapq for r in ctx.alt_reads()],
                           [r.mapq for r in ctx.ref_reads()])
        return {"MQRankSum": format_vcf_double(z)} if z is not None else {}


class BaseQualityRankSumTest(Annotation):
    """BaseQRankSum (BaseQualityRankSumTest.java)."""
    keys = ("BaseQRankSum",)

    def annotate(self, ctx):
        if ctx.read_allele is None:
            return {}
        pos = ctx.variant.pos
        alt, ref = [], []
        for r, a in zip(ctx.reads, ctx.read_allele):
            if a < 0:
                continue
            off = read_offset_at(r, pos)
            if off is not None:
                (alt if a > 0 else ref).append(int(r.quals[off]))
        z = mann_whitney_z(alt, ref)
        return {"BaseQRankSum": format_vcf_double(z)} if z is not None else {}


class ReadPosRankSumTest(Annotation):
    """ReadPosRankSum (ReadPosRankSumTest.java)."""
    keys = ("ReadPosRankSum",)

    def annotate(self, ctx):
        if ctx.read_allele is None:
            return {}
        pos = ctx.variant.pos
        alt, ref = [], []
        for r, a in zip(ctx.reads, ctx.read_allele):
            if a < 0:
                continue
            off = read_offset_at(r, pos)
            if off is not None:
                (alt if a > 0 else ref).append(min(off, len(r.bases) - 1 - off))
        z = mann_whitney_z(alt, ref)
        return {"ReadPosRankSum": format_vcf_double(z)} if z is not None else {}


class ClippingRankSumTest(Annotation):
    """ClippingRankSum: hard-clip counts alt vs ref (ClippingRankSumTest.java)."""
    keys = ("ClippingRankSum",)

    def annotate(self, ctx):
        if ctx.read_allele is None:
            return {}

        def clips(r):
            from ..io import sam

            t = 0
            for o, l in zip(r.cigar_ops, r.cigar_lens):
                if o == sam.OP_H:
                    t += int(l)
            return t

        z = mann_whitney_z([clips(r) for r in ctx.alt_reads()],
                           [clips(r) for r in ctx.ref_reads()])
        return {"ClippingRankSum": format_vcf_double(z)} if z is not None else {}


class FisherStrand(Annotation):
    """FS from the pileup strand table (FisherStrand.java)."""
    keys = ("FS",)

    def annotate(self, ctx):
        t = _strand_table(ctx)
        if t is None:
            return {}
        return {"FS": f"{fisher_strand_phred(*t):.3f}"}


class StrandOddsRatio(Annotation):
    """SOR (StrandOddsRatio.java)."""
    keys = ("SOR",)

    def annotate(self, ctx):
        t = _strand_table(ctx)
        if t is None:
            return {}
        return {"SOR": f"{strand_odds_ratio(*t):.3f}"}


class StrandBiasBySample(Annotation):
    """SB raw table (StrandBiasBySample.java, a FORMAT field; emitted as INFO
    SB_TABLE here when no per-sample split is available)."""
    keys = ("SB_TABLE",)

    def annotate(self, ctx):
        t = _strand_table(ctx)
        if t is None:
            return {}
        return {"SB_TABLE": ",".join(str(x) for x in t)}


class ChromosomeCounts(Annotation):
    """AC/AF/AN from sample genotypes (ChromosomeCounts.java)."""
    keys = ("AC", "AF", "AN")

    def annotate(self, ctx):
        v = ctx.variant
        an = 0
        ac = [0] * len(v.alts)
        for s in v.samples:
            gt = s.get("GT", "./.")
            for tok in gt.replace("|", "/").split("/"):
                if tok in (".", ""):
                    continue
                an += 1
                ai = int(tok)
                if ai > 0:
                    ac[ai - 1] += 1
        if an == 0:
            return {}
        return {"AC": ",".join(str(c) for c in ac),
                "AF": ",".join(format_vcf_double(c / an) for c in ac),
                "AN": str(an)}


class InbreedingCoeff(Annotation):
    """InbreedingCoeff from per-sample PLs (InbreedingCoeff.java; needs >=10
    founder samples in the reference — threshold enforced there, not here)."""
    keys = ("InbreedingCoeff",)

    def annotate(self, ctx):
        pls = []
        for s in ctx.variant.samples:
            pl = s.get("PL")
            if pl:
                pls.append([int(x) for x in pl.split(",")][:3])
        f = inbreeding_coefficient(pls) if len(pls) >= 2 else None
        return {"InbreedingCoeff": format_vcf_double(f)} if f is not None else {}


class GenotypeSummaries(Annotation):
    """CCC/NCC/HWP-style summaries: called/no-call counts + mean GQ/DP
    (GenotypeSummaries.java)."""
    keys = ("CCC", "NCC", "GQ_MEAN", "GQ_STDDEV")

    def annotate(self, ctx):
        v = ctx.variant
        called, nocall, gqs = 0, 0, []
        for s in v.samples:
            gt = s.get("GT", "./.")
            if "." in gt.replace("|", "/").split("/"):
                nocall += 1
            else:
                called += 1
            if s.get("GQ") not in (None, "."):
                gqs.append(int(s["GQ"]))
        out = {"CCC": str(called * 2), "NCC": str(nocall)}
        if gqs:
            out["GQ_MEAN"] = f"{np.mean(gqs):.2f}"
            if len(gqs) > 1:
                out["GQ_STDDEV"] = f"{np.std(gqs, ddof=1):.2f}"
        return out


class SampleList(Annotation):
    """Samples carrying an alt (SampleList.java)."""
    keys = ("Samples",)

    def annotate(self, ctx):
        v = ctx.variant
        names = [s.get("_name", f"S{i}") for i, s in enumerate(v.samples)
                 if any(t not in ("0", ".", "") for t in
                        s.get("GT", "./.").replace("|", "/").split("/"))]
        return {"Samples": ",".join(names)} if names else {}


class TandemRepeat(Annotation):
    """STR/RU/RPA for indels vs the reference context (TandemRepeat.java)."""
    keys = ("STR", "RU", "RPA")

    def annotate(self, ctx):
        v = ctx.variant
        if ctx.reference is None or not v.alts:
            return {}
        if all(len(a) == len(v.ref) for a in v.alts):
            return {}  # indels only
        clen = ctx.reference.contig_length(v.contig)
        window = ctx.reference.fetch_bytes(
            v.contig, min(v.pos + 1, clen), min(v.pos + 1 + 60, clen))
        ru = _repeat_unit(v.ref, v.alts, bytes(window))
        if ru is None:
            return {}
        unit, counts = ru
        return {"STR": None, "RU": unit.decode(),
                "RPA": ",".join(str(c) for c in counts)}


def _leading_reps(unit: bytes, s: bytes) -> int:
    n, ul = 0, len(unit)
    while s[n * ul:(n + 1) * ul] == unit:
        n += 1
    return n


def _smallest_repeat_unit(s: bytes) -> bytes:
    """findRepeatedSubstring: smallest prefix whose tandem repetition is s."""
    for ul in range(1, len(s) // 2 + 1):
        if len(s) % ul == 0 and s[:ul] * (len(s) // ul) == s:
            return s[:ul]
    return s


def _repeat_unit(ref: str, alts, window: bytes):
    """Exact port of GATKVariantContextUtils.getNumTandemRepeatUnits:855-914.
    window = reference bases starting at pos+1 (after the padding base), which
    overlap the ref allele span; per-allele counts subtract the repetitions
    already inside the ref allele."""
    ref_b = ref.encode()[1:]  # drop padding base
    unit = None
    lengths = []
    for alt in alts:
        alt_b = alt.encode()[1:]
        if len(alt_b) == len(ref_b):
            return None
        long_b = alt_b if len(alt_b) > len(ref_b) else ref_b
        unit = _smallest_repeat_unit(long_b)
        reps_in_ref = _leading_reps(unit, ref_b)
        c_ref = _leading_reps(unit, ref_b + window) - reps_in_ref
        c_alt = _leading_reps(unit, alt_b + window) - reps_in_ref
        if c_ref == 0 or c_alt == 0:
            return None
        if not lengths:
            lengths.append(c_ref)
        lengths.append(c_alt)
    return (unit, lengths) if unit else None


class ReferenceBases(Annotation):
    """REF_BASES: the 10-base reference context (ReferenceBases.java)."""
    keys = ("REF_BASES",)

    def annotate(self, ctx):
        if ctx.reference is None:
            return {}
        v = ctx.variant
        lo = max(0, v.pos - 5)
        b = ctx.reference.fetch_bytes(v.contig, lo, v.pos + 5)
        return {"REF_BASES": bytes(b).decode()}


def _strand_table(ctx):
    if ctx.read_allele is None:
        return None
    t = [0, 0, 0, 0]
    for r, a in zip(ctx.reads, ctx.read_allele):
        if a < 0:
            continue
        base = 2 if a > 0 else 0
        t[base + (1 if r.is_reverse else 0)] += 1
    return tuple(t)


def read_offset_at(read, ref_pos: int):
    """Read offset aligned to ref_pos, or None (deletion/outside)."""
    from ..io import sam

    rp = read.pos
    ro = 0
    for op, ln in zip(read.cigar_ops, read.cigar_lens):
        ln = int(ln)
        cr = sam.CONSUMES_READ[op]
        cf = sam.CONSUMES_REF[op]
        if cr and cf:
            if rp <= ref_pos < rp + ln:
                return ro + (ref_pos - rp)
            rp += ln
            ro += ln
        elif cr:
            ro += ln
        elif cf:
            if rp <= ref_pos < rp + ln:
                return None
            rp += ln
    return None


def _median(vals):
    return int(np.median(np.asarray(vals))) if len(vals) else None


def _mad(vals):
    """MathUtils.mad: median absolute deviation (used by ReadPositionSD)."""
    if not len(vals):
        return None
    a = np.asarray(vals, np.float64)
    med = np.median(a)
    return int(np.median(np.abs(a - med)))


def _read_distance_from_end(read, pos):
    """ReadPosRankSumTest.getReadPosition: distance of the variant start from
    the closer read end (soft clips excluded)."""
    off = read_offset_at(read, pos)
    if off is None:
        return None
    return min(off, len(read.bases) - 1 - off)


class QualByDepth(Annotation):
    """QD = QUAL / informative depth over variant genotypes (QualByDepth.java:
    depth from AD when present else DP, only het/hom-var genotypes count)."""
    keys = ("QD",)

    def annotate(self, ctx):
        v = ctx.variant
        qual = getattr(v, "qual", None)
        if qual in (None, ".", ""):
            return {}
        depth = 0
        gts = ctx.genotypes or {}
        for g in gts.values():
            gt = g.get("GT", "./.").replace("|", "/")
            if gt in ("./.", "0/0") or set(gt.split("/")) == {"0"}:
                continue
            if "AD" in g and g["AD"] not in (".", ""):
                depth += sum(int(x) for x in g["AD"].split(",") if x != ".")
            elif "DP" in g and g["DP"] not in (".", ""):
                depth += int(g["DP"])
        if depth == 0 and ctx.reads:
            depth = len(ctx.reads)
        if depth == 0:
            return {}
        qd = float(qual) / depth
        if qd > 35.0:  # QualByDepth.fixTooHighQD jitter (N(30,3)) — cap form
            qd = 30.0
        return {"QD": f"{qd:.2f}"}


class ExcessHetAnn(Annotation):
    """ExcessHet (ExcessHet.java): phred-scaled Levene-Haldane right-tail p of
    the observed het count given diploid genotype counts."""
    keys = ("ExcessHet",)

    def annotate(self, ctx):
        gts = ctx.genotypes or {}
        het = hom = ref = 0
        for g in gts.values():
            gt = sorted(g.get("GT", "./.").replace("|", "/").split("/"))
            if "." in gt or len(gt) != 2:
                continue
            if gt[0] == gt[1]:
                if gt[0] == "0":
                    ref += 1
                else:
                    hom += 1
            else:
                het += 1
        n = het + hom + ref
        if n < 1:
            return {}
        from ..gvcf.annotations import excess_het_phred

        return {"ExcessHet": f"{excess_het_phred(het, hom, n):.4f}"}


class LikelihoodRankSumTest(Annotation):
    """LikelihoodRankSum (LikelihoodRankSumTest.java): rank-sum of per-read
    best-haplotype likelihoods, ALT vs REF reads. Needs a read-likelihood-backed
    context (HC/M2 engine); silent no-op on pileup-only runs."""
    keys = ("LikelihoodRankSum",)

    def annotate(self, ctx):
        if ctx.read_likelihood is None or ctx.read_allele is None:
            return {}
        alt = [float(l) for l, a in zip(ctx.read_likelihood, ctx.read_allele) if a > 0]
        ref = [float(l) for l, a in zip(ctx.read_likelihood, ctx.read_allele) if a == 0]
        z = mann_whitney_z(alt, ref)
        return {"LikelihoodRankSum": format_vcf_double(z)} if z is not None else {}


class MappingQualityAnn(Annotation):
    """MMQ: median mapping quality of reads supporting each allele incl. ref
    (MappingQuality.java; empty allele support -> 60)."""
    keys = ("MMQ",)

    def annotate(self, ctx):
        if ctx.read_allele is None:
            return {}
        vals = []
        for want in (0, 1):
            mqs = [r.mapq for r, a in zip(ctx.reads, ctx.read_allele) if a == want]
            med = _median(mqs)
            vals.append(60 if med is None else med)
        return {"MMQ": ",".join(str(x) for x in vals)}


class ReadPositionSD(Annotation):
    """POSSD: MAD of variant distance from read ends per alt allele
    (ReadPositionSD.java; empty -> 0)."""
    keys = ("POSSD",)

    def annotate(self, ctx):
        if ctx.read_allele is None:
            return {}
        pos = ctx.variant.pos
        d = [x for r, a in zip(ctx.reads, ctx.read_allele) if a > 0
             for x in [_read_distance_from_end(r, pos)] if x is not None]
        m = _mad(d)
        return {"POSSD": str(0 if m is None else m)}


class OriginalAlignment(Annotation):
    """OCM: alt reads whose OA tag contig differs from the current contig
    (OriginalAlignment.java; requires TLOD info to pick the max-LOD alt)."""
    keys = ("OCM",)

    def annotate(self, ctx):
        v = ctx.variant
        info = getattr(v, "info", {}) or {}
        if "TLOD" not in info or ctx.read_allele is None:
            return {}
        n = 0
        for r, a in zip(ctx.reads, ctx.read_allele):
            if a <= 0:
                continue
            oa = (getattr(r, "tags", None) or {}).get("OA")
            if oa and oa.split(",")[0] != v.contig:
                n += 1
        return {"OCM": str(n)}


class BaseQualityHistogram(Annotation):
    """BQHIST: interleaved [qual, count_ref, count_alt, ...] over distinct base
    quals of informative usable reads (BaseQualityHistogram.java)."""
    keys = ("BQHIST",)

    def annotate(self, ctx):
        if ctx.read_allele is None:
            return {}
        pos = ctx.variant.pos
        by_allele = {0: {}, 1: {}}
        for r, a in zip(ctx.reads, ctx.read_allele):
            if a < 0 or r.mapq == 0 or r.mapq == 255:
                continue
            off = read_offset_at(r, pos)
            if off is None:
                continue
            q = int(r.quals[off])
            by_allele[1 if a > 0 else 0][q] = by_allele[1 if a > 0 else 0].get(q, 0) + 1
        quals = sorted(set(by_allele[0]) | set(by_allele[1]))
        if not quals:
            return {}
        out = []
        for q in quals:
            out += [q, by_allele[0].get(q, 0), by_allele[1].get(q, 0)]
        return {"BQHIST": ",".join(str(x) for x in out)}


class AssemblyComplexity(Annotation):
    """HEC / HAPCOMP / HAPDOM from haplotype best-read support and event maps
    (AssemblyComplexity.java:57-130). Needs a haplotype-backed context."""
    keys = ("HEC", "HAPCOMP", "HAPDOM")

    def annotate(self, ctx):
        haps = ctx.haplotypes
        if not haps or ctx.haplotype_support is None:
            return {}
        v = ctx.variant
        support = {h: int(c) for h, c in zip(haps, ctx.haplotype_support)}
        # group haplotypes by their event signature excluding the variant locus
        groups = {}
        for h in haps:
            sig = "".join(f"{e.start}{e.alt}" for e in sorted(
                h.events, key=lambda e: e.start) if e.start != v.pos)
            groups.setdefault(sig, []).append(h)
        hec = sorted((sum(support[h] for h in g) for g in groups.values()),
                     reverse=True)
        # germline = most-supported haplotype (+ runner-up if >= half support)
        by_support = sorted(haps, key=lambda h: (-support[h], bytes(h.bases)))
        germline = [by_support[0]]
        if len(by_support) > 1 and support[by_support[1]] >= support[by_support[0]] // 2:
            germline.append(by_support[1])

        def edit_distance(h1, h2):
            e1 = {(e.start, e.ref, e.alt) for e in h1.events if e.start != v.pos}
            e2 = {(e.start, e.ref, e.alt) for e in h2.events if e.start != v.pos}
            return len(e1 ^ e2)

        hapcomp, hapdom = [], []
        for alt in v.alts:
            with_allele = [h for h in by_support
                           if any(e.start == v.pos and e.alt == alt for e in h.events)]
            if not with_allele:
                hapcomp.append(0)
                hapdom.append(1.0 / len(by_support))
                continue
            best = with_allele[0]
            hapcomp.append(min(edit_distance(g, best) for g in germline))
            counts = [support[h] for h in with_allele]
            mx = max(counts)
            hapdom.append(mx / sum(counts) if mx > 0 else 1.0 / len(by_support))
        return {"HEC": ",".join(str(x) for x in hec),
                "HAPCOMP": ",".join(str(x) for x in hapcomp),
                "HAPDOM": ",".join(f"{x:.3f}" for x in hapdom)}


class RawGtCount(Annotation):
    """RAW_GT_COUNT: .|hets|homvars raw reducible genotype counts
    (RawGtCount.java makeRawAnnotationString: hom-ref is unknowable post-merge)."""
    keys = ("RAW_GT_COUNT",)

    def annotate(self, ctx):
        gts = ctx.genotypes or {}
        if not gts:
            return {}
        het = hom = 0
        for g in gts.values():
            gt = sorted(g.get("GT", "./.").replace("|", "/").split("/"))
            if "." in gt or len(gt) != 2 or set(gt) == {"0"}:
                continue
            if gt[0] == gt[1]:
                hom += 1
            else:
                het += 1
        return {"RAW_GT_COUNT": f".,{het},{hom}"}


def _trio_gts(ctx, trio):
    gts = ctx.genotypes or {}
    out = []
    for s in trio:
        g = gts.get(s)
        if g is None or "GT" not in g or "." in g["GT"]:
            return None
        out.append(g)
    return out


def _gq(g):
    try:
        return int(g.get("GQ", 0))
    except (TypeError, ValueError):
        return 0


def _dp(g):
    try:
        return int(g.get("DP", 0))
    except (TypeError, ValueError):
        return 0


def _gt_class(g):
    alleles = sorted(g["GT"].replace("|", "/").split("/"))
    if alleles == ["0", "0"]:
        return "ref"
    if alleles[0] == alleles[1]:
        return "hom"
    return "het"


class PossibleDeNovo(Annotation):
    """hiConfDeNovo/loConfDeNovo (PossibleDeNovo.java): trio mendelian-violation
    ref+ref -> het children, GQ-thresholded (hi 20 / lo 10)."""
    keys = ("hiConfDeNovo", "loConfDeNovo")
    HI_GQ, LO_GQ = 20, 10

    def annotate(self, ctx):
        v = ctx.variant
        if not ctx.trios or len(v.alts) != 1:
            return {}
        hi, lo = [], []
        for mother, father, child in ctx.trios:
            t = _trio_gts(ctx, (mother, father, child))
            if t is None:
                continue
            mom, dad, kid = t
            if not (_gt_class(mom) == "ref" and _gt_class(dad) == "ref"
                    and _gt_class(kid) == "het"):
                continue
            if _gq(kid) >= self.HI_GQ and _gq(mom) >= self.HI_GQ and _gq(dad) >= self.HI_GQ:
                hi.append(child)
            elif _gq(kid) >= self.LO_GQ and _gq(mom) > 0 and _gq(dad) > 0:
                lo.append(child)
        # allele-frequency cutoff: de novos must be rare in the callset
        gts = ctx.genotypes or {}
        ac = sum(g.get("GT", "").replace("|", "/").split("/").count("1")
                 for g in gts.values())
        cutoff = max(4, len(gts) * 0.001)
        out = {}
        if hi and ac < cutoff:
            out["hiConfDeNovo"] = ",".join(hi)
        if lo and ac < cutoff:
            out["loConfDeNovo"] = ",".join(lo)
        return out


class TransmittedSingleton(Annotation):
    """transmittedSingleton/nonTransmittedSingleton (TransmittedSingleton.java):
    AC==2 high-GQ het parent + het child (transmitted) or AC==1 het parent +
    hom-ref child (non-transmitted); 90% high-GQ call rate required."""
    keys = ("transmittedSingleton", "nonTransmittedSingleton")
    HI_GQ, HI_DP = 20, 20

    def annotate(self, ctx):
        v = ctx.variant
        gts = ctx.genotypes or {}
        if not ctx.trios or len(v.alts) != 1 or not gts:
            return {}
        high_q = sum(1 for g in gts.values() if _gq(g) > self.HI_GQ)
        if high_q / len(gts) < 0.90:
            return {}
        ac = sum(g.get("GT", "").replace("|", "/").split("/").count("1")
                 for g in gts.values())
        trans, nontrans = [], []
        for mother, father, child in ctx.trios:
            t = _trio_gts(ctx, (mother, father, child))
            if t is None:
                continue
            mom, dad, kid = t
            one_parent_het = {_gt_class(mom), _gt_class(dad)} == {"het", "ref"}
            parent = mother if _gt_class(mom) == "het" else father
            hi_gq = _gq(mom) >= self.HI_GQ and _gq(dad) >= self.HI_GQ
            hi_dp = _dp(kid) >= self.HI_DP
            if (hi_dp and hi_gq and one_parent_het and ac == 2
                    and _gt_class(kid) == "het" and _gq(kid) >= self.HI_GQ):
                trans.append(parent)
            if (hi_dp and hi_gq and one_parent_het and ac == 1
                    and _gt_class(kid) == "ref" and _gq(kid) >= self.HI_GQ):
                nontrans.append(parent)
        out = {}
        if trans:
            out["transmittedSingleton"] = ",".join(trans)
        if nontrans:
            out["nonTransmittedSingleton"] = ",".join(nontrans)
        return out


class DepthPerAlleleBySample(Annotation):
    """AD (DepthPerAlleleBySample.java): informative best-allele read counts
    [ref, alt...] from the read classification."""
    keys = ("AD",)
    format_key = True

    def annotate(self, ctx):
        if ctx.read_allele is None:
            return {}
        n_alts = len(ctx.variant.alts)
        counts = [0] * (1 + n_alts)
        if ctx.read_best_allele is not None:
            for b in ctx.read_best_allele:
                if 0 <= b <= n_alts:
                    counts[int(b)] += 1
        else:
            for a in ctx.read_allele:
                if a == 0:
                    counts[0] += 1
                elif a > 0:
                    counts[1] += 1
        return {"AD": ",".join(str(c) for c in counts)}


class DepthPerSampleHC(Annotation):
    """DP genotype field (DepthPerSampleHC.java): informative reads only."""
    keys = ("DP",)
    format_key = True

    def annotate(self, ctx):
        if ctx.read_allele is None:
            return {}
        return {"DP": str(int(np.sum(np.asarray(ctx.read_allele) >= 0)))}


class AlleleFraction(Annotation):
    """AF genotype field (AlleleFraction.java): AD normalized to 1, ref dropped."""
    keys = ("AF",)
    format_key = True

    def annotate(self, ctx):
        ad = DepthPerAlleleBySample().annotate(ctx).get("AD")
        if not ad:
            return {}
        counts = np.array([int(x) for x in ad.split(",")], np.float64)
        total = counts.sum()
        if total == 0:
            return {}
        frac = counts / total
        return {"AF": ",".join(f"{x:.3f}" for x in frac[1:])}


class FragmentDepthPerAlleleBySample(Annotation):
    """FAD (FragmentDepthPerAlleleBySample.java): AD at fragment granularity —
    both reads of a pair vote once (discordant pairs are uninformative)."""
    keys = ("FAD",)
    format_key = True

    def annotate(self, ctx):
        if ctx.read_allele is None:
            return {}
        frag = {}
        for r, a in zip(ctx.reads, ctx.read_allele):
            frag.setdefault(r.name, []).append(int(a))
        n_alts = len(ctx.variant.alts)
        counts = [0] * (1 + n_alts)
        for votes in frag.values():
            inf = {v for v in votes if v >= 0}
            if len(inf) != 1:
                continue
            v = inf.pop()
            counts[min(v, n_alts)] += 1
        return {"FAD": ",".join(str(c) for c in counts)}


class OrientationBiasReadCounts(Annotation):
    """F1R2/F2R1 genotype fields (OrientationBiasReadCounts.java): fragment
    orientation counts per allele, base qual >= 20, usable mapq."""
    keys = ("F1R2", "F2R1")
    format_key = True
    MIN_BQ = 20

    def annotate(self, ctx):
        if ctx.read_allele is None:
            return {}
        pos = ctx.variant.pos
        n_alts = len(ctx.variant.alts)
        f1r2 = [0] * (1 + n_alts)
        f2r1 = [0] * (1 + n_alts)
        seen = set()
        for r, a in zip(ctx.reads, ctx.read_allele):
            if a < 0 or r.mapq == 0 or r.mapq == 255 or r.name in seen:
                continue
            off = read_offset_at(r, pos)
            if off is None or int(r.quals[off]) < self.MIN_BQ:
                continue
            seen.add(r.name)
            # F2R1: read2 forward / read1 reverse (ReadUtils.isF2R1)
            is_f2r1 = r.is_reverse == bool(r.flag & 0x40)
            (f2r1 if is_f2r1 else f1r2)[min(int(a), n_alts) if a > 0 else 0] += 1
        return {"F1R2": ",".join(str(x) for x in f1r2),
                "F2R1": ",".join(str(x) for x in f2r1)}


class HaplotypeFilteringAnnotation(Annotation):
    """ASSEMBLED_HAPS/FILTERED_HAPS (HaplotypeFilteringAnnotation.java)."""
    keys = ("ASSEMBLED_HAPS", "FILTERED_HAPS")

    def annotate(self, ctx):
        if not ctx.haplotypes:
            return {}
        return {"ASSEMBLED_HAPS": str(len(ctx.haplotypes)),
                "FILTERED_HAPS": str(ctx.n_filtered_haplotypes)}


class AllelePseudoDepth(Annotation):
    """DD/DF (AllelePseudoDepth.java): Dirichlet posterior pseudo-depths and
    fractions from read-allele likelihood weights; pileup fallback uses hard
    assignments (equivalent to unit weights on informative reads)."""
    keys = ("DD", "DF")
    format_key = True
    PRIOR = 1.0

    def annotate(self, ctx):
        if ctx.read_allele is None:
            return {}
        n_alleles = 1 + len(ctx.variant.alts)
        post = np.full(n_alleles, self.PRIOR)
        if ctx.read_best_allele is not None:
            for b in ctx.read_best_allele:
                if 0 <= b < n_alleles:
                    post[int(b)] += 1
        else:
            for a in ctx.read_allele:
                if a >= 0:
                    post[min(int(a), n_alleles - 1) if a > 0 else 0] += 1
        freq = post / post.sum()
        depth = post - self.PRIOR
        return {"DD": ",".join(f"{x:.0f}" for x in depth),
                "DF": ",".join(f"{x:.3f}" for x in freq)}


class ASInbreedingCoeff(Annotation):
    """AS_InbreedingCoeff (allelespecific/AS_InbreedingCoeff.java): per-alt
    inbreeding coefficient treating each alt biallelically vs everything else."""
    keys = ("AS_InbreedingCoeff",)

    def annotate(self, ctx):
        gts = ctx.genotypes or {}
        if len(gts) < 10:  # matches InbreedingCoeff minimum founders
            return {}
        vals = []
        for alt_i in range(1, 1 + len(ctx.variant.alts)):
            het = hom = ref = 0
            for g in gts.values():
                alleles = g.get("GT", "./.").replace("|", "/").split("/")
                if "." in alleles or len(alleles) != 2:
                    continue
                n_alt = sum(1 for a in alleles if a == str(alt_i))
                if n_alt == 2:
                    hom += 1
                elif n_alt == 1:
                    het += 1
                else:
                    ref += 1
            n = het + hom + ref
            if n == 0:
                vals.append("0.0000")
                continue
            p = (2 * hom + het) / (2 * n)
            expected_het = 2 * p * (1 - p) * n
            f = 1.0 - het / expected_het if expected_het > 0 else 0.0
            vals.append(f"{f:.4f}")
        return {"AS_InbreedingCoeff": ",".join(vals)} if vals else {}


# --- finalized AS_* reducible family (tools/walkers/annotator/allelespecific/:
# AS_FisherStrand.java, AS_StrandOddsRatio.java, AS_RMSMappingQuality.java,
# AS_QualByDepth.java, AS_{BaseQuality,MappingQuality,ReadPos}RankSumTest.java;
# AS_StrandBiasMutectAnnotation.java; SecondaryDepthPerAlleleBySample.java).
# These compute the finalized per-alt values directly from the read context
# (the VariantAnnotator path); the raw->combine->finalize reduce path for the
# GVCF workflow lives in calling/as_annotations.py. ---------------------------


class _ASReadsAnnotation(Annotation):
    """Shared per-allele read partitioning by ctx.read_best_allele."""

    def _per_allele_reads(self, ctx):
        n_alleles = 1 + len(ctx.variant.alts)
        groups = [[] for _ in range(n_alleles)]
        if ctx.read_best_allele is None:
            return groups
        for r, ai in zip(ctx.reads, ctx.read_best_allele):
            if 0 <= ai < n_alleles:
                groups[int(ai)].append(r)
        return groups


class ASFisherStrand(_ASReadsAnnotation):
    """AS_FisherStrand: per-alt phred Fisher exact on ref-vs-alt strand table."""
    keys = ("AS_FS",)

    def annotate(self, ctx):
        groups = self._per_allele_reads(ctx)
        rf = sum(1 for r in groups[0] if not r.is_reverse)
        rr = len(groups[0]) - rf
        vals = []
        for g in groups[1:]:
            af = sum(1 for r in g if not r.is_reverse)
            vals.append(f"{fisher_strand_phred(rf, rr, af, len(g) - af):.3f}")
        return {"AS_FS": ",".join(vals)} if vals else {}


class ASStrandOddsRatio(_ASReadsAnnotation):
    """AS_StrandOddsRatio: per-alt symmetric odds ratio."""
    keys = ("AS_SOR",)

    def annotate(self, ctx):
        groups = self._per_allele_reads(ctx)
        rf = sum(1 for r in groups[0] if not r.is_reverse)
        rr = len(groups[0]) - rf
        vals = []
        for g in groups[1:]:
            af = sum(1 for r in g if not r.is_reverse)
            vals.append(f"{strand_odds_ratio(rf, rr, af, len(g) - af):.3f}")
        return {"AS_SOR": ",".join(vals)} if vals else {}


class ASRMSMappingQuality(_ASReadsAnnotation):
    """AS_RMSMappingQuality: per-alt RMS of supporting reads' MQ."""
    keys = ("AS_MQ",)

    def annotate(self, ctx):
        groups = self._per_allele_reads(ctx)
        vals = []
        for g in groups[1:]:
            mqs = [r.mapq for r in g]
            vals.append(f"{rms_mapping_quality(mqs):.2f}" if mqs else "NaN")
        return {"AS_MQ": ",".join(vals)} if vals else {}


class ASQualByDepth(_ASReadsAnnotation):
    """AS_QualByDepth: site QUAL over per-alt informative depth (+ ref depth,
    AS_QualByDepth.java:201)."""
    keys = ("AS_QD",)

    def annotate(self, ctx):
        if ctx.variant.qual is None:
            return {}
        groups = self._per_allele_reads(ctx)
        ref_depth = len(groups[0])
        vals = []
        for g in groups[1:]:
            d = len(g) + ref_depth
            vals.append(f"{min(ctx.variant.qual / d, 35.0):.2f}" if d > 0 else ".")
        return {"AS_QD": ",".join(vals)} if vals else {}


class _ASRankSum(_ASReadsAnnotation):
    def _value(self, read, ctx):
        raise NotImplementedError

    def annotate(self, ctx):
        groups = self._per_allele_reads(ctx)
        ref_vals = [v for v in (self._value(r, ctx) for r in groups[0]) if v is not None]
        vals = []
        for g in groups[1:]:
            alt_vals = [v for v in (self._value(r, ctx) for r in g) if v is not None]
            z = mann_whitney_z(alt_vals, ref_vals)
            vals.append(f"{z:.3f}" if z is not None else ".")
        if all(v == "." for v in vals):
            return {}
        return {self.keys[0]: ",".join(vals)}


class ASBaseQualityRankSumTest(_ASRankSum):
    """AS_BaseQRankSum: per-alt z of base quals at the site, alt vs ref reads."""
    keys = ("AS_BaseQRankSum",)

    def _value(self, read, ctx):
        off = read_offset_at(read, ctx.variant.pos)
        return int(read.quals[off]) if off is not None else None


class ASMappingQualityRankSumTest(_ASRankSum):
    """AS_MQRankSum: per-alt z of mapping quality, alt vs ref reads."""
    keys = ("AS_MQRankSum",)

    def _value(self, read, ctx):
        return int(read.mapq)


class ASReadPosRankSumTest(_ASRankSum):
    """AS_ReadPosRankSum: per-alt z of distance-from-nearer-read-end."""
    keys = ("AS_ReadPosRankSum",)

    def _value(self, read, ctx):
        off = read_offset_at(read, ctx.variant.pos)
        if off is None:
            return None
        return min(off, len(read.bases) - 1 - off)


class ASStrandBiasMutectAnnotation(_ASReadsAnnotation):
    """AS_StrandBiasMutectAnnotation: the raw AS_SB_TABLE (fwd,rev per allele
    including ref) as Mutect2 emits it."""
    keys = ("AS_SB_TABLE",)

    def annotate(self, ctx):
        groups = self._per_allele_reads(ctx)
        secs = []
        for g in groups:
            f = sum(1 for r in g if not r.is_reverse)
            secs.append(f"{f},{len(g) - f}")
        return {"AS_SB_TABLE": "|".join(secs)}


class SecondaryDepthPerAlleleBySample(_ASReadsAnnotation):
    """SecondaryDepthPerAlleleBySample: per-allele informative read counts as
    the SFAD genotype attribute (SecondaryDepthPerAlleleBySample.java:83)."""
    keys = ("SFAD",)
    genotype_level = True

    def annotate(self, ctx):
        groups = self._per_allele_reads(ctx)
        return {"SFAD": ",".join(str(len(g)) for g in groups)}


# --- flow-space annotations (tools/walkers/annotator/flow/FlowAnnotatorBase.java
# + per-class wrappers; Ultima flow-model context features) -------------------

MOTIF_SIZE = 5
GC_CONTENT_SIZE = 10


class _FlowAnnotation(Annotation):
    """Shared flow-context machinery (FlowAnnotatorBase.java)."""

    def _ref_motif(self, ctx, start, length):
        if ctx.reference is None:
            return ""
        try:
            b = ctx.reference.fetch(ctx.variant.contig, max(0, start), start + length)
        except Exception:
            return ""
        return bytes(b).decode().upper() if len(b) == length else ""

    def _indel_classify(self, v):
        out = []
        for a in v.alts:
            if len(a) == len(v.ref):
                out.append("NA")
            elif len(a) > len(v.ref):
                out.append("ins")
            else:
                out.append("del")
        return out

    def _left_motifs(self, ctx):
        v = ctx.variant
        base = self._ref_motif(ctx, v.pos - MOTIF_SIZE, MOTIF_SIZE)
        if not base:
            return None
        out = []
        for a in v.alts:
            if len(a) != len(v.ref):
                out.append(base[1:] + v.ref[0])
            else:
                out.append(base)
        return out

    def _right_motifs(self, ctx):
        v = ctx.variant
        motif = self._ref_motif(ctx, v.pos + len(v.ref), MOTIF_SIZE)
        if not motif:
            return None
        hil, hin, right = self._hmer_indel(ctx)
        out = []
        for i in range(len(v.alts)):
            r = right[i] if right and right[i] is not None else motif
            out.append(r)
        return out

    def _hmer_indel(self, ctx):
        """Per-alt (hmer_length, hmer_nuc, right_motif_for_hmer) via flow-key
        comparison of ref vs alt haplotypes (FlowAnnotatorBase.isHmerIndel)."""
        from ..ops.flow import base_array_to_key

        v = ctx.variant
        hil, hin, right = [], [], []
        for a in v.alts:
            hil.append(None)
            hin.append(None)
            right.append(None)
            before = self._ref_motif(ctx, v.pos - 1, 1)
            if not before:
                continue
            # reference hmer after the variant + MOTIF_SIZE extra bases
            tail = self._ref_motif(ctx, v.pos + len(v.ref), 1)
            if not tail:
                continue
            after = tail
            k = 1
            while True:
                nxt = self._ref_motif(ctx, v.pos + len(v.ref) + k, 1)
                if not nxt or nxt != tail[0] or len(after) > 50:
                    break
                after += nxt
                k += 1
            after += self._ref_motif(ctx, v.pos + len(v.ref) + k, MOTIF_SIZE)
            ref_hap = (before + v.ref + after).encode()
            alt_hap = (before + a + after).encode()
            rk = base_array_to_key(np.frombuffer(ref_hap, np.uint8), ctx.flow_order)
            ak = base_array_to_key(np.frombuffer(alt_hap, np.uint8), ctx.flow_order)
            if len(rk) != len(ak):
                continue
            diff = [i for i in range(len(rk)) if rk[i] != ak[i]]
            if len(diff) != 1 or max(rk[diff[0]], ak[diff[0]]) == 0:
                continue
            i = diff[0]
            hil[-1] = int(max(rk[i], ak[i]))
            hin[-1] = ctx.flow_order[i % len(ctx.flow_order)]
            if len(a) != len(v.ref):
                used = int(np.sum(rk[: i + 1]))
                right[-1] = ref_hap[used : used + MOTIF_SIZE].decode()
        return hil, hin, right


class IndelClassify(_FlowAnnotation):
    """X_IC (flow/IndelClassify.java): ins/del/NA per alt."""
    keys = ("X_IC",)

    def annotate(self, ctx):
        return {"X_IC": ",".join(self._indel_classify(ctx.variant))}


class IndelLength(_FlowAnnotation):
    """X_IL (flow/IndelLength.java): |len(alt)-len(ref)| per alt (NA for SNPs)."""
    keys = ("X_IL",)

    def annotate(self, ctx):
        v = ctx.variant
        out = [str(abs(len(a) - len(v.ref))) if len(a) != len(v.ref) else "."
               for a in v.alts]
        return {"X_IL": ",".join(out)}


class HmerIndelLength(_FlowAnnotation):
    """X_HIL (flow/HmerIndelLength.java)."""
    keys = ("X_HIL",)

    def annotate(self, ctx):
        hil, _, _ = self._hmer_indel(ctx)
        return {"X_HIL": ",".join("." if x is None else str(x) for x in hil)}


class HmerIndelNuc(_FlowAnnotation):
    """X_HIN (flow/HmerIndelNuc.java)."""
    keys = ("X_HIN",)

    def annotate(self, ctx):
        _, hin, _ = self._hmer_indel(ctx)
        return {"X_HIN": ",".join("." if x is None else x for x in hin)}


class HmerMotifs(_FlowAnnotation):
    """X_LM/X_RM (flow/HmerMotifs.java): 5bp context motifs."""
    keys = ("X_LM", "X_RM")

    def annotate(self, ctx):
        left = self._left_motifs(ctx)
        right = self._right_motifs(ctx)
        out = {}
        if left:
            out["X_LM"] = ",".join(left)
        if right:
            out["X_RM"] = ",".join(right)
        return out


class GcContent(_FlowAnnotation):
    """X_GCC (flow/GcContent.java): GC fraction of the 10bp window around."""
    keys = ("X_GCC",)

    def annotate(self, ctx):
        v = ctx.variant
        seq = self._ref_motif(ctx, v.pos - GC_CONTENT_SIZE // 2 + 1, GC_CONTENT_SIZE)
        if not seq:
            return {}
        gc = sum(1 for c in seq if c in "GC")
        return {"X_GCC": f"{gc / len(seq):.2f}"}


class CycleSkipStatus(_FlowAnnotation):
    """X_CSS (flow/CycleSkipStatus.java): cycle-skip / possible-cycle-skip /
    non-skip per alt from flow-key comparison over the motif context."""
    keys = ("X_CSS",)

    def annotate(self, ctx):
        from ..ops.flow import base_array_to_key

        v = ctx.variant
        left = self._left_motifs(ctx)
        right = self._right_motifs(ctx)
        if left is None or right is None:
            return {}
        out = []
        for i, a in enumerate(v.alts):
            if len(a) != len(v.ref):
                out.append("NA")
                continue
            rk = base_array_to_key(
                np.frombuffer((left[i] + v.ref + right[i]).encode(), np.uint8),
                ctx.flow_order)
            ak = base_array_to_key(
                np.frombuffer((left[i] + a + right[i]).encode(), np.uint8),
                ctx.flow_order)
            if len(rk) != len(ak):
                out.append("cycle-skip")
            elif any((rk[n] == 0) != (ak[n] == 0) for n in range(len(rk))):
                out.append("possible-cycle-skip")
            else:
                out.append("non-skip")
        return {"X_CSS": ",".join(out)}


class VariantType(_FlowAnnotation):
    """VARIANT_TYPE (flow/VariantType.java): snp / h-indel / non-h-indel."""
    keys = ("VARIANT_TYPE",)

    def annotate(self, ctx):
        v = ctx.variant
        classify = self._indel_classify(v)
        if all(c == "NA" for c in classify):
            return {"VARIANT_TYPE": "snp"}
        hil, _, _ = self._hmer_indel(ctx)
        if any(x for x in hil):
            return {"VARIANT_TYPE": "h-indel"}
        return {"VARIANT_TYPE": "non-h-indel"}


# name -> class; names match the reference annotation class names
ANNOTATION_REGISTRY = {
    "Coverage": Coverage,
    "MappingQualityZero": MappingQualityZero,
    "RMSMappingQuality": RMSMappingQuality,
    "CountNs": CountNs,
    "FragmentLength": FragmentLength,
    "BaseQuality": BaseQualityAnn,
    "ReadPosition": ReadPosition,
    "UniqueAltReadCount": UniqueAltReadCount,
    "MappingQualityRankSumTest": MappingQualityRankSumTest,
    "BaseQualityRankSumTest": BaseQualityRankSumTest,
    "ReadPosRankSumTest": ReadPosRankSumTest,
    "ClippingRankSumTest": ClippingRankSumTest,
    "FisherStrand": FisherStrand,
    "StrandOddsRatio": StrandOddsRatio,
    "StrandBiasBySample": StrandBiasBySample,
    "ChromosomeCounts": ChromosomeCounts,
    "InbreedingCoeff": InbreedingCoeff,
    "GenotypeSummaries": GenotypeSummaries,
    "SampleList": SampleList,
    "TandemRepeat": TandemRepeat,
    "ReferenceBases": ReferenceBases,
    "QualByDepth": QualByDepth,
    "ExcessHet": ExcessHetAnn,
    "LikelihoodRankSumTest": LikelihoodRankSumTest,
    "MappingQuality": MappingQualityAnn,
    "ReadPositionSD": ReadPositionSD,
    "OriginalAlignment": OriginalAlignment,
    "BaseQualityHistogram": BaseQualityHistogram,
    "AssemblyComplexity": AssemblyComplexity,
    "RawGtCount": RawGtCount,
    "PossibleDeNovo": PossibleDeNovo,
    "TransmittedSingleton": TransmittedSingleton,
    "DepthPerAlleleBySample": DepthPerAlleleBySample,
    "DepthPerSampleHC": DepthPerSampleHC,
    "AlleleFraction": AlleleFraction,
    "FragmentDepthPerAlleleBySample": FragmentDepthPerAlleleBySample,
    "OrientationBiasReadCounts": OrientationBiasReadCounts,
    "HaplotypeFilteringAnnotation": HaplotypeFilteringAnnotation,
    "AllelePseudoDepth": AllelePseudoDepth,
    "AS_InbreedingCoeff": ASInbreedingCoeff,
    "AS_FisherStrand": ASFisherStrand,
    "AS_StrandOddsRatio": ASStrandOddsRatio,
    "AS_RMSMappingQuality": ASRMSMappingQuality,
    "AS_QualByDepth": ASQualByDepth,
    "AS_BaseQualityRankSumTest": ASBaseQualityRankSumTest,
    "AS_MappingQualityRankSumTest": ASMappingQualityRankSumTest,
    "AS_ReadPosRankSumTest": ASReadPosRankSumTest,
    "AS_StrandBiasMutectAnnotation": ASStrandBiasMutectAnnotation,
    "SecondaryDepthPerAlleleBySample": SecondaryDepthPerAlleleBySample,
    "IndelClassify": IndelClassify,
    "IndelLength": IndelLength,
    "HmerIndelLength": HmerIndelLength,
    "HmerIndelNuc": HmerIndelNuc,
    "HmerMotifs": HmerMotifs,
    "GcContent": GcContent,
    "CycleSkipStatus": CycleSkipStatus,
    "VariantType": VariantType,
}

# reference annotation-group sets (-G): StandardAnnotation, StandardHCAnnotation,
# StandardMutectAnnotation, StandardFlowBasedAnnotation class groupings
ANNOTATION_GROUPS = {
    "StandardAnnotation": ("Coverage", "ChromosomeCounts", "RMSMappingQuality",
                           "MappingQualityRankSumTest", "BaseQualityRankSumTest",
                           "ReadPosRankSumTest", "FisherStrand", "StrandOddsRatio",
                           "QualByDepth", "InbreedingCoeff", "ExcessHet",
                           "DepthPerAlleleBySample", "DepthPerSampleHC"),
    "StandardHCAnnotation": ("Coverage", "ChromosomeCounts", "FisherStrand",
                             "StrandOddsRatio", "QualByDepth", "RMSMappingQuality",
                             "DepthPerAlleleBySample", "DepthPerSampleHC"),
    "StandardMutectAnnotation": ("Coverage", "DepthPerAlleleBySample",
                                 "TandemRepeat", "OrientationBiasReadCounts",
                                 "MappingQuality", "ReadPosition", "BaseQuality",
                                 "FragmentLength", "StrandBiasBySample",
                                 "FragmentDepthPerAlleleBySample"),
    "StandardFlowBasedAnnotation": ("IndelClassify", "IndelLength",
                                    "HmerIndelLength", "HmerIndelNuc",
                                    "HmerMotifs", "GcContent", "CycleSkipStatus",
                                    "VariantType"),
    "AS_StandardAnnotation": ("AS_FisherStrand", "AS_StrandOddsRatio",
                              "AS_RMSMappingQuality", "AS_QualByDepth",
                              "AS_BaseQualityRankSumTest",
                              "AS_MappingQualityRankSumTest",
                              "AS_ReadPosRankSumTest", "AS_InbreedingCoeff"),
}

STANDARD_SET = ("Coverage", "RMSMappingQuality", "MappingQualityRankSumTest",
                "BaseQualityRankSumTest", "ReadPosRankSumTest", "FisherStrand",
                "StrandOddsRatio", "ChromosomeCounts")


class VariantAnnotatorEngine:
    """Runs a set of annotations over an AnnotationContext
    (VariantAnnotatorEngine.java:annotateContext). Classifies each overlapping
    read as ref/alt/uninformative by comparing its bases at the site (the
    pileup stand-in for read-likelihood marginalization)."""

    def __init__(self, names=STANDARD_SET, extra=(), exclude=()):
        # expand -G group names (GATKAnnotationPluginDescriptor group resolution)
        expanded = []
        for n in list(names) + list(extra):
            expanded.extend(ANNOTATION_GROUPS.get(n, (n,)))
        seen = set()
        wanted = [n for n in expanded
                  if n not in exclude and not (n in seen or seen.add(n))]
        unknown = [n for n in wanted if n not in ANNOTATION_REGISTRY]
        if unknown:
            from ..utils.errors import UserError

            raise UserError(f"unknown annotation(s): {', '.join(unknown)}")
        self.annotations = [ANNOTATION_REGISTRY[n]() for n in wanted]

    def classify_reads(self, variant, reads) -> np.ndarray:
        """+1 alt, 0 ref, -1 uninformative per read (SNP/MNP base compare;
        indel length heuristic via cigar)."""
        out = np.full(len(reads), -1, np.int8)
        v = variant
        is_indel = any(len(a) != len(v.ref) for a in v.alts)
        for i, r in enumerate(reads):
            off = read_offset_at(r, v.pos)
            if is_indel:
                # indel support: any I/D in the read near the site
                has_indel = _has_indel_near(r, v.pos)
                if off is None and not has_indel:
                    continue
                out[i] = 1 if has_indel else 0
            else:
                if off is None or off + len(v.ref) > len(r.bases):
                    continue
                seg = bytes(r.bases[off : off + len(v.ref)]).upper()
                if seg == v.ref.upper().encode():
                    out[i] = 0
                elif any(seg == a.upper().encode() for a in v.alts
                         if len(a) == len(v.ref)):
                    out[i] = 1
        return out

    def annotate(self, variant, reads=(), reference=None, genotypes=None,
                 trios=(), flow_order="TGCA") -> dict:
        ctx = AnnotationContext(variant, list(reads), reference,
                                genotypes=genotypes, trios=list(trios),
                                flow_order=flow_order)
        if ctx.reads:
            ctx.read_allele = self.classify_reads(variant, ctx.reads)
        info = {}
        for ann in self.annotations:
            info.update(ann.annotate(ctx))
        return info

    def annotate_split(self, variant, reads=(), reference=None, genotypes=None,
                       trios=(), flow_order="TGCA"):
        """Like annotate() but returns (info_dict, format_dict): annotations
        flagged format_key=True (GenotypeAnnotation equivalents: AD/DP/AF/FAD/
        F1R2/F2R1/DD/DF) land in the per-sample FORMAT map."""
        ctx = AnnotationContext(variant, list(reads), reference,
                                genotypes=genotypes, trios=list(trios),
                                flow_order=flow_order)
        if ctx.reads:
            ctx.read_allele = self.classify_reads(variant, ctx.reads)
        info, fmt = {}, {}
        for ann in self.annotations:
            (fmt if getattr(ann, "format_key", False) else info).update(
                ann.annotate(ctx))
        return info, fmt


def _has_indel_near(read, pos: int, window: int = 10) -> bool:
    from ..io import sam

    rp = read.pos
    for op, ln in zip(read.cigar_ops, read.cigar_lens):
        ln = int(ln)
        if op in (sam.OP_I, sam.OP_D) and abs(rp - (pos + 1)) <= window:
            return True
        if sam.CONSUMES_REF[op]:
            rp += ln
    return False
