# Copied verbatim from gatk_tpu/vareval/evaluators.py; only import lines may differ.
"""VariantEval evaluation modules.

Reference behavior: tools/walkers/varianteval/evaluators/*.java — the standard
set (StandardEval marker): CountVariants, CompOverlap, TiTvVariantEvaluator,
IndelSummary, IndelLengthHistogram, MultiallelicSummary, ValidationReport.
Column names/formats follow the @DataPoint declarations so reports diff cleanly
against the reference's.
"""
from __future__ import annotations

from .framework import EvalContext, VariantEvaluator, is_transition


def _ratio(a, b, pct=False):
    if not b:
        return 0.0
    return (100.0 * a / b) if pct else a / b


class CountVariants(VariantEvaluator):
    """evaluators/CountVariants.java (@DataPoint fields :20-76)."""

    name = "CountVariants"
    columns = (
        ("nProcessedLoci", "%d"), ("nCalledLoci", "%d"), ("nRefLoci", "%d"),
        ("nVariantLoci", "%d"), ("variantRate", "%.8f"), ("variantRatePerBp", "%.8f"),
        ("nSNPs", "%d"), ("nMNPs", "%d"), ("nInsertions", "%d"), ("nDeletions", "%d"),
        ("nComplex", "%d"), ("nSymbolic", "%d"), ("nMixed", "%d"), ("nNoCalls", "%d"),
        ("nHets", "%d"), ("nHomRef", "%d"), ("nHomVar", "%d"), ("nSingletons", "%d"),
        ("nHomDerived", "%d"), ("heterozygosity", "%.2e"), ("heterozygosityPerBp", "%.2f"),
        ("hetHomRatio", "%.2f"), ("indelRate", "%.2e"), ("indelRatePerBp", "%.2f"),
        ("insertionDeletionRatio", "%.2f"),
    )

    def __init__(self):
        self.c = dict.fromkeys(
            ("nProcessedLoci", "nCalledLoci", "nRefLoci", "nVariantLoci", "nSNPs",
             "nMNPs", "nInsertions", "nDeletions", "nComplex", "nSymbolic", "nMixed",
             "nNoCalls", "nHets", "nHomRef", "nHomVar", "nSingletons", "nHomDerived"), 0)

    def update(self, ctx: EvalContext):
        c = self.c
        v = ctx.variant
        c["nProcessedLoci"] += 1
        c["nCalledLoci"] += 1
        t = ctx.vtype
        if t == "NO_VARIATION":
            c["nRefLoci"] += 1
        elif t != "SYMBOLIC":
            # SYMBOLIC increments only nSymbolic (CountVariants.java:130-132)
            c["nVariantLoci"] += 1
        if t == "SNP":
            c["nSNPs"] += 1
        elif t == "MNP":
            c["nMNPs"] += 1
        elif t == "INDEL":
            ins = del_ = 0
            for a in v.alts:
                if not a or a.startswith("<") or a == "*":
                    continue
                if len(a) > len(v.ref):
                    ins += 1
                elif len(a) < len(v.ref):
                    del_ += 1
            if ins and del_:
                c["nComplex"] += 1
            elif ins:
                c["nInsertions"] += 1
            elif del_:
                c["nDeletions"] += 1
            else:
                c["nComplex"] += 1
        elif t == "SYMBOLIC":
            c["nSymbolic"] += 1
        elif t == "MIXED":
            c["nMixed"] += 1
        c["nNoCalls"] += ctx.n_no_calls
        ac_one = 0
        for _i, alleles in ctx.genotypes:
            alt = [a for a in alleles if a > 0]
            if not alt:
                c["nHomRef"] += 1
            elif len(set(alleles)) > 1:
                c["nHets"] += 1
            else:
                c["nHomVar"] += 1
            ac_one += len(alt)
        if ac_one == 1:
            c["nSingletons"] += 1

    def set_processed_loci(self, n):
        self.c["nProcessedLoci"] = n

    def row(self):
        c = self.c
        het = c["nHets"]
        loci = c["nProcessedLoci"]
        indels = c["nInsertions"] + c["nDeletions"] + c["nComplex"]

        def per_bp(count):  # VariantEvaluator.rate-per-bp: floor(loci/count)
            return float(loci // count) if count else 0.0

        return [
            loci, c["nCalledLoci"], c["nRefLoci"], c["nVariantLoci"],
            _ratio(c["nVariantLoci"], loci), per_bp(c["nVariantLoci"]),
            c["nSNPs"], c["nMNPs"], c["nInsertions"], c["nDeletions"], c["nComplex"],
            c["nSymbolic"], c["nMixed"], c["nNoCalls"], het, c["nHomRef"],
            c["nHomVar"], c["nSingletons"], c["nHomDerived"],
            _ratio(het, loci), per_bp(het), _ratio(het, c["nHomVar"]),
            _ratio(indels, loci), per_bp(indels), _ratio(c["nInsertions"], c["nDeletions"]),
        ]


class TiTvVariantEvaluator(VariantEvaluator):
    """evaluators/TiTvVariantEvaluator.java."""

    name = "TiTvVariantEvaluator"
    columns = (("nTi", "%d"), ("nTv", "%d"), ("tiTvRatio", "%.2f"),
               ("nTiInComp", "%d"), ("nTvInComp", "%d"), ("TiTvRatioStandard", "%.2f"))

    def __init__(self):
        self.nti = self.ntv = self.nti_comp = self.ntv_comp = 0

    def update(self, ctx: EvalContext):
        v = ctx.variant
        if ctx.vtype == "SNP":
            for a in v.alts:
                if len(a) == 1 and a != "*" and not a.startswith("<"):
                    if is_transition(v.ref, a):
                        self.nti += 1
                    else:
                        self.ntv += 1
        if ctx.comp is not None:
            cv = ctx.comp
            if len(cv.ref) == 1:
                for a in cv.alts:
                    if len(a) == 1 and a != "*" and not a.startswith("<"):
                        if is_transition(cv.ref, a):
                            self.nti_comp += 1
                        else:
                            self.ntv_comp += 1

    def row(self):
        return [self.nti, self.ntv, _ratio(self.nti, self.ntv),
                self.nti_comp, self.ntv_comp, _ratio(self.nti_comp, self.ntv_comp)]


class CompOverlap(VariantEvaluator):
    """evaluators/CompOverlap.java."""

    name = "CompOverlap"
    columns = (("nEvalVariants", "%d"), ("novelSites", "%d"), ("nVariantsAtComp", "%d"),
               ("compRate", "%.2f"), ("nConcordant", "%d"), ("concordantRate", "%.2f"))

    def __init__(self):
        self.n_eval = self.n_at_comp = self.n_concordant = 0

    def update(self, ctx: EvalContext):
        self.n_eval += 1
        if ctx.comp is not None:
            self.n_at_comp += 1
            if ctx.comp_match:
                self.n_concordant += 1

    def row(self):
        return [self.n_eval, self.n_eval - self.n_at_comp, self.n_at_comp,
                _ratio(self.n_at_comp, self.n_eval, pct=True),
                self.n_concordant, _ratio(self.n_concordant, self.n_at_comp, pct=True)]


class IndelSummary(VariantEvaluator):
    """evaluators/IndelSummary.java (core columns)."""

    name = "IndelSummary"
    columns = (("n_SNPs", "%d"), ("n_singleton_SNPs", "%d"), ("n_indels", "%d"),
               ("n_singleton_indels", "%d"), ("nIndelSites", "%d"),
               ("n_multiallelic_indel_sites", "%d"),
               ("percent_of_sites_with_more_than_2_alleles", "%s"),
               ("SNP_to_indel_ratio", "%s"), ("n_novel_indels", "%d"),
               ("indel_novelty_rate", "%s"), ("n_insertions", "%d"),
               ("n_deletions", "%d"), ("insertion_to_deletion_ratio", "%s"),
               ("n_large_deletions", "%d"), ("n_large_insertions", "%d"),
               ("SNP_het_to_hom_ratio", "%s"), ("indel_het_to_hom_ratio", "%s"))

    LARGE = 10

    def __init__(self):
        self.n_snps = self.n_singleton_snps = 0
        self.n_indels = self.n_singleton_indels = self.n_indel_sites = 0
        self.n_multi_indel = self.n_novel_indels = 0
        self.n_ins = self.n_del = self.n_large_del = self.n_large_ins = 0
        self.snp_het = self.snp_hom = self.indel_het = self.indel_hom = 0

    def update(self, ctx: EvalContext):
        v = ctx.variant
        alts = [a for a in v.alts if a and a != "*" and not a.startswith("<")]
        ac = sum(1 for _i, al in ctx.genotypes for a in al if a > 0)
        is_het = any(len(set(al)) > 1 for _i, al in ctx.genotypes)
        is_hom = any(len(set(al)) == 1 and al[0] > 0 for _i, al in ctx.genotypes)
        if ctx.vtype == "SNP":
            self.n_snps += len(alts)
            if ac == 1:
                self.n_singleton_snps += 1
            self.snp_het += is_het
            self.snp_hom += is_hom
        elif ctx.vtype == "INDEL":
            self.n_indel_sites += 1
            if len(alts) > 1:
                self.n_multi_indel += 1
            self.n_indels += len(alts)
            if ac == 1:
                self.n_singleton_indels += 1
            if not ctx.is_known:
                self.n_novel_indels += len(alts)
            for a in alts:
                d = len(a) - len(v.ref)
                if d > 0:
                    self.n_ins += 1
                    if d >= self.LARGE:
                        self.n_large_ins += 1
                elif d < 0:
                    self.n_del += 1
                    if -d >= self.LARGE:
                        self.n_large_del += 1
            self.indel_het += is_het
            self.indel_hom += is_hom

    def row(self):
        def pct(a, b):
            return f"{_ratio(a, b, pct=True):.2f}" if b else "NA"

        def rat(a, b):
            return f"{_ratio(a, b):.2f}" if b else "NA"

        return [self.n_snps, self.n_singleton_snps, self.n_indels,
                self.n_singleton_indels, self.n_indel_sites, self.n_multi_indel,
                pct(self.n_multi_indel, self.n_indel_sites),
                rat(self.n_snps, self.n_indels), self.n_novel_indels,
                pct(self.n_novel_indels, self.n_indels), self.n_ins, self.n_del,
                rat(self.n_ins, self.n_del), self.n_large_del, self.n_large_ins,
                rat(self.snp_het, self.snp_hom), rat(self.indel_het, self.indel_hom)]


class IndelLengthHistogram(VariantEvaluator):
    """evaluators/IndelLengthHistogram.java: fraction of indels per length in
    [-10, 10] (excluding 0), emitted as one row per length."""

    name = "IndelLengthHistogram"
    columns = (("Length", "%d"), ("Freq", "%.8f"))
    MAX = 10

    def __init__(self):
        self.counts = {i: 0 for i in range(-self.MAX, self.MAX + 1) if i != 0}
        self.total = 0

    def update(self, ctx: EvalContext):
        v = ctx.variant
        if ctx.vtype != "INDEL" or len(v.alts) != 1:
            return  # biallelic only, as the reference does
        a = v.alts[0]
        if not a or a.startswith("<") or a == "*":
            return
        d = len(a) - len(v.ref)
        if d != 0 and -self.MAX <= d <= self.MAX:
            self.counts[d] += 1
            self.total += 1

    def row(self):
        # flattened histogram: the tool writer expands this into per-length rows
        return [0, 0.0]

    def histogram_rows(self):
        return [[l, _ratio(self.counts[l], self.total)] for l in sorted(self.counts)]


class MultiallelicSummary(VariantEvaluator):
    """evaluators/MultiallelicSummary.java (core columns)."""

    name = "MultiallelicSummary"
    columns = (("nProcessedLoci", "%d"), ("nSNPs", "%d"), ("nMultiSNPs", "%d"),
               ("processedMultiSnpRatio", "%.5f"), ("nIndels", "%d"),
               ("nMultiIndels", "%d"), ("processedMultiIndelRatio", "%.5f"),
               ("nTi", "%d"), ("nTv", "%d"), ("TiTvRatio", "%.2f"))

    def __init__(self):
        self.loci = self.n_snp = self.n_multi_snp = 0
        self.n_indel = self.n_multi_indel = 0
        self.nti = self.ntv = 0

    def update(self, ctx: EvalContext):
        self.loci += 1
        v = ctx.variant
        alts = [a for a in v.alts if a and a != "*" and not a.startswith("<")]
        if ctx.vtype == "SNP":
            self.n_snp += 1
            if len(alts) > 1:
                self.n_multi_snp += 1
                for a in alts:  # multiallelic Ti/Tv only, as the reference
                    if is_transition(v.ref, a):
                        self.nti += 1
                    else:
                        self.ntv += 1
        elif ctx.vtype == "INDEL":
            self.n_indel += 1
            if len(alts) > 1:
                self.n_multi_indel += 1

    def row(self):
        return [self.loci, self.n_snp, self.n_multi_snp,
                _ratio(self.n_multi_snp, self.loci), self.n_indel,
                self.n_multi_indel, _ratio(self.n_multi_indel, self.loci),
                self.nti, self.ntv, _ratio(self.nti, self.ntv)]


class ValidationReport(VariantEvaluator):
    """evaluators/ValidationReport.java: comp-driven SiteStatus confusion
    matrix (NO_CALL/FILTERED/MONO/POLY per side; update2 semantics — only comp
    sites count, eval may be absent)."""

    name = "ValidationReport"
    comparison_order = 2  # update runs for comp-only sites too (eval=None)
    columns = (("nComp", "%d"), ("TP", "%d"), ("FP", "%d"), ("FN", "%d"),
               ("TN", "%d"), ("sensitivity", "%.2f"), ("specificity", "%.2f"),
               ("PPV", "%.2f"), ("FDR", "%.2f"),
               ("CompMonoEvalNoCall", "%d"), ("CompMonoEvalFiltered", "%d"),
               ("CompMonoEvalMono", "%d"), ("CompMonoEvalPoly", "%d"),
               ("CompPolyEvalNoCall", "%d"), ("CompPolyEvalFiltered", "%d"),
               ("CompPolyEvalMono", "%d"), ("CompPolyEvalPoly", "%d"),
               ("CompFiltered", "%d"), ("nDifferentAlleleSites", "%d"))

    NO_CALL, FILTERED, MONO, POLY = range(4)

    def __init__(self):
        self.counts = [[0] * 4 for _ in range(4)]
        self.n_different = 0

    @classmethod
    def _status(cls, v, is_filtered=False):
        """ValidationReport.calcSiteStatus."""
        if v is None:
            return cls.NO_CALL
        if is_filtered or (v.filters and v.filters not in ((), ("PASS",), (".",))):
            return cls.FILTERED
        if v.samples and "GT" in v.fmt_keys:
            for s in v.samples:
                gt = s.get("GT", ".").replace("|", "/")
                if any(a not in (".", "0") for a in gt.split("/")):
                    return cls.POLY
            return cls.MONO
        if "AC" in v.info:
            if len(v.alts) > 1:
                return cls.POLY
            try:
                ac = int(str(v.info["AC"]).split(",")[0])
            except ValueError:
                ac = 0
            return cls.POLY if ac > 0 else cls.MONO
        return cls.POLY  # TREAT_ALL_SITES_IN_EVAL_VCF_AS_CALLED

    def update(self, ctx: EvalContext):
        if ctx.comp is None:
            return
        eval_status = self._status(ctx.variant, ctx.is_filtered)
        comp_status = self._status(ctx.comp)
        self.counts[comp_status][eval_status] += 1

    def row(self):
        c = self.counts
        comp_filtered = sum(c[self.FILTERED])
        cm_nc, cm_f = c[self.MONO][self.NO_CALL], c[self.MONO][self.FILTERED]
        cm_m, cm_p = c[self.MONO][self.MONO], c[self.MONO][self.POLY]
        cp_nc, cp_f = c[self.POLY][self.NO_CALL], c[self.POLY][self.FILTERED]
        cp_m, cp_p = c[self.POLY][self.MONO], c[self.POLY][self.POLY]
        tp = cp_p
        fn = cp_nc + cp_f + cp_m
        fp = cm_p
        tn = cm_nc + cm_f + cm_m
        ncomp = sum(sum(row) for row in c)
        return [ncomp, tp, fp, fn, tn,
                _ratio(tp, tp + fn, pct=True),
                _ratio(tn, tn + fp, pct=True) if (tn + fp) else 100.0,
                _ratio(tp, tp + fp, pct=True),
                _ratio(fp, fp + tp, pct=True),
                cm_nc, cm_f, cm_m, cm_p, cp_nc, cp_f, cp_m, cp_p,
                comp_filtered, self.n_different]


EVALUATOR_REGISTRY = {
    cls.name: cls for cls in (
        CountVariants, TiTvVariantEvaluator, CompOverlap, IndelSummary,
        IndelLengthHistogram, MultiallelicSummary, ValidationReport)
}

# the StandardEval set
STANDARD_EVALUATORS = ("CompOverlap", "CountVariants", "TiTvVariantEvaluator",
                       "IndelSummary", "IndelLengthHistogram",
                       "MultiallelicSummary", "ValidationReport")


class VariantAFEvaluator(VariantEvaluator):
    """Per-genotype variant-allele-fraction census
    (evaluators/VariantAFEvaluator.java)."""

    name = "VariantAFEvaluator"
    columns = (("avgVarAF", "%.8f"), ("totalCalledSites", "%d"),
               ("totalHetSites", "%d"), ("totalHomVarSites", "%d"),
               ("totalHomRefSites", "%d"))

    def __init__(self):
        self.sum_af = 0.0
        self.called = self.het = self.homvar = self.homref = 0

    def update(self, ctx):
        v = ctx.variant
        if not v.is_snp():
            return
        any_gt = False
        for g in (ctx.variant.samples or []):
            gt = g.get("GT", "./.").replace("|", "/")
            if "." in gt:
                continue
            any_gt = True
            alleles = gt.split("/")
            n_ref = sum(1 for a in alleles if a == "0")
            self.called += 1
            self.sum_af += (2 - n_ref) / 2.0
            self.het += n_ref == 1
            self.homvar += n_ref == 0
            self.homref += n_ref == 2
        if not any_gt and not ctx.variant.samples:
            self.called += 1
            try:
                self.sum_af += float(str(v.info.get("AF", "0")).split(",")[0])
            except ValueError:
                pass

    def row(self):
        avg = self.sum_af / self.called if self.called else 0.0
        return (f"{avg:.8f}", self.called, self.het, self.homvar, self.homref)


class ThetaVariantEvaluator(VariantEvaluator):
    """Watterson / pairwise theta estimates (evaluators/ThetaVariantEvaluator.java)."""

    name = "ThetaVariantEvaluator"
    columns = (("avgHet", "%.8f"), ("avgAvgDiffs", "%.8f"),
               ("thetaRegionNumSites", "%.8f"))

    def __init__(self):
        self.n_sites = 0
        self.total_het = 0.0
        self.total_avg_diffs = 0.0
        self.theta_num_sites = 0.0

    def update(self, ctx):
        v = ctx.variant
        if not v.is_snp() or not ctx.variant.samples:
            return
        allele_counts = {}
        n_het = n_geno = n_inds = 0
        for g in (ctx.variant.samples or []):
            n_inds += 1
            gt = g.get("GT", "./.").replace("|", "/")
            if "." in gt:
                continue
            alleles = gt.split("/")
            n_het += len(set(alleles)) > 1
            n_geno += 1
            for a in alleles:
                allele_counts[a] = allele_counts.get(a, 0) + 1
        if n_geno == 0:
            return
        self.n_sites += 1
        self.total_het += n_het / n_geno
        harmonic = sum(1.0 / i for i in range(1, n_inds + 1))
        self.theta_num_sites += 1.0 / harmonic if harmonic else 0.0
        num_pairwise = 0.0
        num_diffs = 0
        keys = list(allele_counts)
        for i, a1 in enumerate(keys):
            c1 = allele_counts[a1]
            num_pairwise += c1 * (c1 - 1) * 0.5
            for a2 in keys[i + 1:]:
                c2 = allele_counts[a2]
                num_pairwise += c1 * c2
                num_diffs += c1 * c2
        if num_pairwise > 0:
            self.total_avg_diffs += num_diffs / num_pairwise

    def row(self):
        avg_het = self.total_het / self.n_sites if self.n_sites else 0.0
        avg_diffs = self.total_avg_diffs / self.n_sites if self.n_sites else 0.0
        return (f"{avg_het:.8f}", f"{avg_diffs:.8f}", f"{self.theta_num_sites:.8f}")


class GenotypeFilterSummary(VariantEvaluator):
    """Called vs no-call/filtered genotype counts
    (evaluators/GenotypeFilterSummary.java)."""

    name = "GenotypeFilterSummary"
    columns = (("nCalledNotFiltered", "%d"), ("nNoCallOrFiltered", "%d"))

    def __init__(self):
        self.called = self.nocall = 0

    def update(self, ctx):
        for g in (ctx.variant.samples or []):
            gt = g.get("GT", "./.")
            ft = g.get("FT", "PASS")
            if "." not in gt.replace("|", "/").split("/") and ft in ("PASS", "."):
                self.called += 1
            else:
                self.nocall += 1

    def row(self):
        return (self.called, self.nocall)


class VariantSummary(VariantEvaluator):
    """Callset-level 1000G-style summary (evaluators/VariantSummary.java:
    per-type ALL + per-sample count/TiTv/DP tables, mean-per-sample rollups,
    AC0 sites skipped unless --keep-ac0)."""

    name = "VariantSummary"
    comparison_order = 2
    columns = (("nSamples", "%d"), ("nProcessedLoci", "%d"), ("nSNPs", "%d"),
               ("TiTvRatio", "%.2f"), ("SNPNoveltyRate", "%s"),
               ("nSNPsPerSample", "%d"), ("TiTvRatioPerSample", "%.2f"),
               ("SNPDPPerSample", "%.1f"), ("nIndels", "%d"),
               ("IndelNoveltyRate", "%s"), ("nIndelsPerSample", "%d"),
               ("IndelDPPerSample", "%.1f"), ("nSVs", "%d"),
               ("SVNoveltyRate", "%s"), ("nSVsPerSample", "%d"))

    MAX_INDEL_LENGTH = 150

    def __init__(self):
        self.sample_names = []
        self.loci = 0
        # per type: ALL count, known count, per-sample dicts
        self.alln = {"SNP": 0, "INDEL": 0, "CNV": 0}
        self.known = {"SNP": 0, "INDEL": 0, "CNV": 0}
        self.per_sample = {t: {} for t in ("SNP", "INDEL", "CNV")}
        self.ti = {"ALL": 0}
        self.tv = {"ALL": 0}
        self.dp = {t: {"ALL": 0} for t in ("SNP", "INDEL", "CNV")}

    def set_eval_samples(self, names):
        self.sample_names = list(names)
        for t in self.per_sample:
            for n in names:
                self.per_sample[t].setdefault(n, 0)
                self.dp[t].setdefault(n, 0)
        for n in names:
            self.ti.setdefault(n, 0)
            self.tv.setdefault(n, 0)

    def set_processed_loci(self, n):
        self.loci = n

    @staticmethod
    def _mono_in_samples(v):
        if not v.samples or "GT" not in v.fmt_keys:
            return False
        for smp in v.samples:
            gt = smp.get("GT", ".").replace("|", "/")
            if any(a not in (".", "0") for a in gt.split("/")):
                return False
        return True

    def _type(self, ctx):
        v = ctx.variant
        if ctx.vtype == "SNP":
            return "SNP"
        if ctx.vtype == "INDEL":
            for a in v.alts:
                if a and not a.startswith("<") and abs(len(a) - len(v.ref)) > self.MAX_INDEL_LENGTH:
                    return "CNV"
            return "INDEL"
        if ctx.vtype == "SYMBOLIC" or any(a.startswith("<") for a in v.alts):
            return "CNV"
        return None

    def update(self, ctx):
        v = ctx.variant
        if not self.sample_names and ctx.eval_samples:
            self.set_eval_samples(ctx.eval_samples)
        if v is None:
            return
        if not ctx.keep_ac0 and self._mono_in_samples(v):
            return
        t = self._type(ctx)
        if t is None:
            return
        if "DP" in v.info:
            self.dp[t]["ALL"] += 1
        self.alln[t] += 1
        titv = None
        if t == "SNP" and len(v.alts) == 1:
            titv = self.ti if is_transition(v.ref, v.alts[0]) else self.tv
            titv["ALL"] += 1
        if ctx.comp is not None:
            self.known[t] += 1
        names = self.sample_names
        for i, smp in enumerate(v.samples or []):
            gt = smp.get("GT", ".").replace("|", "/")
            alleles = gt.split("/")
            if "." in alleles or all(a == "0" for a in alleles):
                continue
            name = names[i] if i < len(names) else str(i)
            self.per_sample[t][name] = self.per_sample[t].get(name, 0) + 1
            if titv is not None:
                titv[name] = titv.get(name, 0) + 1
            if smp.get("DP", ".") not in (".", None):
                self.dp[t][name] = self.dp[t].get(name, 0) + 1

    @staticmethod
    def _ratio(num, denom):
        return num / max(denom, 1)

    def _mean(self, table, t):
        vals = [table[t].get(n, 0) for n in self.sample_names]
        return int(round(sum(vals) / len(vals))) if vals else 0

    def _novelty(self, t):
        n = self.alln[t]
        return "NA" if not n else f"{100.0 * (n - self.known[t]) / n:.2f}"

    def row(self):
        titv_all = self._ratio(self.ti["ALL"], self.tv["ALL"])
        names = self.sample_names
        if names:
            titv_ps = sum(self._ratio(self.ti.get(n, 0), self.tv.get(n, 0))
                          for n in names) / len(names)
        else:
            titv_ps = 0.0
        per_sample_counts = {t: self._mean(self.per_sample, t)
                             for t in ("SNP", "INDEL", "CNV")}
        dp_means = {t: float(self._mean(self.dp, t)) for t in ("SNP", "INDEL")}
        return (len(names), self.loci, self.alln["SNP"], titv_all,
                self._novelty("SNP"), per_sample_counts["SNP"], titv_ps,
                dp_means["SNP"], self.alln["INDEL"], self._novelty("INDEL"),
                per_sample_counts["INDEL"], dp_means["INDEL"],
                self.alln["CNV"], self._novelty("CNV"),
                per_sample_counts["CNV"])


def _gt_type(g):
    """htsjdk GenotypeType over a per-sample dict: NO_CALL/HOM_REF/HET/HOM_VAR
    (MIXED collapses to None — unused by the inheritance accessors)."""
    gt = g.get("GT", ".") if g else None
    if not gt or gt.startswith("."):
        return "NO_CALL"
    alleles = gt.replace("|", "/").split("/")
    if any(a == "." for a in alleles):
        return None  # MIXED
    if all(a == "0" for a in alleles):
        return "HOM_REF"
    if len(set(alleles)) == 1:
        return "HOM_VAR"
    return "HET"


def _gt_alleles(g):
    gt = g.get("GT", ".").replace("|", "/")
    return [a for a in gt.split("/") if a != "."]


def _mv_is_violation(g_mom, g_dad, g_kid):
    """MendelianViolation.isViolation(gMom, gDad, gChild) (:163-183)."""
    tm, td, tk = _gt_type(g_mom), _gt_type(g_dad), _gt_type(g_kid)
    if tk == "NO_CALL":
        return False
    if tm == "HOM_REF" and td == "HOM_REF" and tk == "HOM_REF":
        return False
    if tm == "NO_CALL":
        return (td == "HOM_REF" and tk == "HOM_VAR") or \
            (td == "HOM_VAR" and tk == "HOM_REF")
    if td == "NO_CALL":
        return (tm == "HOM_REF" and tk == "HOM_VAR") or \
            (tm == "HOM_VAR" and tk == "HOM_REF")
    am, ad, ak = _gt_alleles(g_mom), _gt_alleles(g_dad), _gt_alleles(g_kid)
    if len(ak) < 2:
        return False
    k0, k1 = ak[0], ak[1]
    return not ((k0 in am and k1 in ad) or (k1 in am and k0 in ad))


class _MendelianViolationCounter:
    """utils/samples/MendelianViolation.java with abortOnSampleNotFound=False,
    completeTriosOnly=False: per-site family census + full 3-way genotype-type
    inheritance map."""

    def __init__(self, min_gq: float):
        self.min_gq = min_gq
        self.reset()

    def reset(self):
        self.no_call = 0
        self.low_qual = 0
        self.family_called = 0
        self.var_family_called = 0
        self.violations_total = 0
        self.inh = {}

    def _get(self, m, d, k):
        return self.inh.get((m, d, k), 0)

    def count(self, genotypes_by_name, trios):
        """trios: [(family, mother_id, father_id, child_id)]; ids absent from
        genotypes_by_name (e.g. '0') make the trio a silent no-op
        (MendelianViolation.updateViolations:86-97)."""
        self.reset()
        for _fam, mom_id, dad_id, kid_id in trios:
            g_mom = genotypes_by_name.get(mom_id)
            g_dad = genotypes_by_name.get(dad_id)
            g_kid = genotypes_by_name.get(kid_id)
            if g_mom is None or g_dad is None or g_kid is None:
                continue
            tm, td, tk = _gt_type(g_mom), _gt_type(g_dad), _gt_type(g_kid)
            mom_called = tm not in ("NO_CALL", None)
            dad_called = td not in ("NO_CALL", None)
            kid_called = tk not in ("NO_CALL", None)
            if (not mom_called and not dad_called) or not kid_called:
                self.no_call += 1
            elif self.min_gq > 0 and (
                    float(g_mom.get("GQ", -1)) < self.min_gq
                    or float(g_dad.get("GQ", -1)) < self.min_gq
                    or float(g_kid.get("GQ", -1)) < self.min_gq):
                self.low_qual += 1
            else:
                self.family_called += 1
                if not (tm == "HOM_REF" and td == "HOM_REF" and tk == "HOM_REF"):
                    self.var_family_called += 1
                if _mv_is_violation(g_mom, g_dad, g_kid):
                    self.violations_total += 1
                key = (tm, td, tk)
                self.inh[key] = self.inh.get(key, 0) + 1
        return self.violations_total


class MendelianViolationEvaluator(VariantEvaluator):
    """Full trio mendelian-violation census
    (evaluators/MendelianViolationEvaluator.java: the 32 data points of the
    ExtendedMendelianViolation inheritance-map accessors). Configure via
    set_trios: [(family, mother_id, father_id, child_id)] and the qual
    threshold; genotypes are looked up by sample name in ctx.eval_samples."""

    name = "MendelianViolationEvaluator"
    columns = tuple((n, "%d") for n in (
        "nVariants", "nSkipped", "nFamCalled", "nVarFamCalled", "nLowQual",
        "nNoCall", "nLociViolations", "nViolations",
        "mvRefRef_Var", "mvRefRef_Het", "mvRefHet_Var", "mvRefVar_Var",
        "mvRefVar_Ref", "mvVarHet_Ref", "mvVarVar_Ref", "mvVarVar_Het",
        "HomRefHomRef_HomRef", "HetHet_Het", "HetHet_HomRef", "HetHet_HomVar",
        "HomVarHomVar_HomVar", "HomRefHomVAR_Het",
        "HetHet_inheritedRef", "HetHet_inheritedVar",
        "HomRefHet_inheritedRef", "HomRefHet_inheritedVar",
        "HomVarHet_inheritedRef", "HomVarHet_inheritedVar"))

    trios: list = []  # [(family, mom, dad, kid)] — set via class attribute
    min_gq: float = 50.0

    def __init__(self):
        self.c = {n: 0 for n, _ in self.columns}

    def update(self, ctx):
        v = ctx.variant
        if v is None or len(v.alleles) != 2 or not v.samples:
            return  # update1 gate: vc.isBiallelic() && vc.hasGenotypes()
        names = list(ctx.eval_samples)
        by_name = {n: v.samples[i] for i, n in enumerate(names)
                   if i < len(v.samples)}
        mv = _MendelianViolationCounter(self.min_gq)
        if mv.count(by_name, self.trios) > 0:
            c = self.c
            c["nLociViolations"] += 1
            c["nViolations"] += mv.violations_total
            g = mv._get
            c["mvRefRef_Var"] += g("HOM_REF", "HOM_REF", "HOM_VAR")
            c["mvRefRef_Het"] += g("HOM_REF", "HOM_REF", "HET")
            c["mvRefHet_Var"] += g("HOM_REF", "HET", "HOM_VAR") + g("HET", "HOM_REF", "HOM_VAR")
            c["mvRefVar_Var"] += g("HOM_REF", "HOM_VAR", "HOM_VAR") + g("HOM_VAR", "HOM_REF", "HOM_VAR")
            c["mvRefVar_Ref"] += g("HOM_REF", "HOM_VAR", "HOM_REF") + g("HOM_VAR", "HOM_REF", "HOM_REF")
            c["mvVarHet_Ref"] += g("HET", "HOM_VAR", "HOM_REF") + g("HOM_VAR", "HET", "HOM_REF")
            c["mvVarVar_Ref"] += g("HOM_VAR", "HOM_VAR", "HOM_REF")
            c["mvVarVar_Het"] += g("HOM_VAR", "HOM_VAR", "HET")
        g = mv._get
        c = self.c
        c["HomRefHomRef_HomRef"] += g("HOM_REF", "HOM_REF", "HOM_REF")
        c["HetHet_Het"] += g("HET", "HET", "HET")
        c["HetHet_HomRef"] += g("HET", "HET", "HOM_REF")
        c["HetHet_HomVar"] += g("HET", "HET", "HOM_VAR")
        c["HomVarHomVar_HomVar"] += g("HOM_VAR", "HOM_VAR", "HOM_VAR")
        c["HomRefHomVAR_Het"] += g("HOM_REF", "HOM_VAR", "HET") + g("HOM_VAR", "HOM_REF", "HET")
        c["HetHet_inheritedRef"] += g("HET", "HET", "HET") + 2 * g("HET", "HET", "HOM_REF")
        c["HetHet_inheritedVar"] += g("HET", "HET", "HET") + 2 * g("HET", "HET", "HOM_VAR")
        c["HomRefHet_inheritedRef"] += g("HOM_REF", "HET", "HOM_REF") + g("HET", "HOM_REF", "HOM_REF")
        c["HomRefHet_inheritedVar"] += g("HOM_REF", "HET", "HET") + g("HET", "HOM_REF", "HET")
        c["HomVarHet_inheritedRef"] += g("HOM_VAR", "HET", "HET") + g("HET", "HOM_VAR", "HET")
        c["HomVarHet_inheritedVar"] += g("HOM_VAR", "HET", "HOM_VAR") + g("HET", "HOM_VAR", "HOM_VAR")
        if mv.family_called > 0 or mv.low_qual > 0:
            c["nVariants"] += 1
            c["nFamCalled"] += mv.family_called
            c["nLowQual"] += mv.low_qual
            c["nNoCall"] += mv.no_call
            c["nVarFamCalled"] += mv.var_family_called
        else:
            c["nSkipped"] += 1

    def row(self):
        return tuple(self.c[n] for n, _ in self.columns)


class PrintMissingComp(VariantEvaluator):
    """Count of eval SNP sites missing from comp (evaluators/PrintMissingComp.java)."""

    name = "PrintMissingComp"
    columns = (("nMissing", "%d"),)

    def __init__(self):
        self.n_missing = 0

    def update(self, ctx):
        if ctx.variant.is_snp() and ctx.comp is None:
            self.n_missing += 1

    def row(self):
        return (self.n_missing,)


class MetricsCollection(VariantEvaluator):
    """Cross-evaluator summary metrics (evaluators/MetricsCollection.java):
    the key concordance/TiTv/indel-ratio numbers in one table."""

    name = "MetricsCollection"
    columns = (("nSNPs", "%d"), ("nIndels", "%d"), ("tiTvRatio", "%.2f"),
               ("indelRatio", "%.2f"), ("concordantRate", "%.2f"))

    def __init__(self):
        self.n_snp = self.n_indel = 0
        self.ti = self.tv = 0
        self.ins = self.dels = 0
        self.n_comp = self.n_concordant = 0

    def update(self, ctx):
        v = ctx.variant
        if ctx.vtype == "SNP":
            self.n_snp += 1
            if is_transition(v.ref, v.alts[0]):
                self.ti += 1
            else:
                self.tv += 1
        elif ctx.vtype == "INDEL":
            self.n_indel += 1
            for a in v.alts:
                if len(a) > len(v.ref):
                    self.ins += 1
                elif len(a) < len(v.ref):
                    self.dels += 1
        if ctx.comp is not None:
            self.n_comp += 1
            self.n_concordant += bool(ctx.comp_match)

    def row(self):
        titv = self.ti / self.tv if self.tv else 0.0
        ir = self.ins / self.dels if self.dels else 0.0
        conc = 100.0 * self.n_concordant / self.n_comp if self.n_comp else 0.0
        return (self.n_snp, self.n_indel, f"{titv:.2f}", f"{ir:.2f}", f"{conc:.2f}")


EVALUATOR_REGISTRY.update({
    cls.name: cls for cls in (
        VariantAFEvaluator, ThetaVariantEvaluator, GenotypeFilterSummary,
        VariantSummary, MendelianViolationEvaluator, PrintMissingComp,
        MetricsCollection)
})
