# Copied verbatim from gatk_tpu/vareval/stratifiers.py; only import lines may differ.
"""VariantEval stratification modules.

Reference behavior: tools/walkers/varianteval/stratifications/*.java — each
module declares a state vocabulary and maps a variant to the states it belongs
to ("all" plus specifics). Multi-state membership is how e.g. Novelty rolls a
variant into both the "all" and "known"/"novel" rows.
"""
from __future__ import annotations

from .framework import EvalContext, VariantStratifier, classify


class Novelty(VariantStratifier):
    """known (in dbSNP/comp) vs novel (stratifications/Novelty.java)."""

    name = "Novelty"
    all_states = ("all", "known", "novel")

    def relevant_states(self, ctx: EvalContext):
        return ("all", "known" if ctx.is_known else "novel")


class Filter(VariantStratifier):
    """called vs filtered vs raw (stratifications/Filter.java)."""

    name = "Filter"
    all_states = ("called", "filtered", "raw")

    def relevant_states(self, ctx: EvalContext):
        return ("filtered" if ctx.is_filtered else "called", "raw")


class FilterType(VariantStratifier):
    """one state per FILTER value seen (stratifications/FilterType.java)."""

    name = "FilterType"

    def relevant_states(self, ctx: EvalContext):
        f = ctx.variant.filters
        if not f or f == ("PASS",):
            return ("PASS",)
        return tuple(f)


class Contig(VariantStratifier):
    """per-contig stratification (stratifications/Contig.java)."""

    name = "Contig"

    def relevant_states(self, ctx: EvalContext):
        return ("all", ctx.variant.contig)


class VariantType(VariantStratifier):
    """SNP/MNP/INDEL/... (stratifications/VariantType.java)."""

    name = "VariantType"
    all_states = ("SNP", "MNP", "INDEL", "SYMBOLIC", "MIXED", "NO_VARIATION")

    def relevant_states(self, ctx: EvalContext):
        return (ctx.vtype,)


class Sample(VariantStratifier):
    """per-sample, by sample column name (stratifications/Sample.java)."""

    name = "Sample"

    def __init__(self, sample_names):
        self.sample_names = sample_names

    def relevant_states(self, ctx: EvalContext):
        out = ["all"]
        for i, alleles in ctx.genotypes:
            if any(a > 0 for a in alleles) and i < len(self.sample_names):
                out.append(self.sample_names[i])
        return tuple(out)


class AlleleCount(VariantStratifier):
    """stratify by alt-allele count over called genotypes
    (stratifications/AlleleCount.java: AC from genotypes or the AC INFO field)."""

    name = "AlleleCount"

    def relevant_states(self, ctx: EvalContext):
        v = ctx.variant
        ac = None
        if ctx.genotypes:
            ac = sum(1 for _i, alleles in ctx.genotypes for a in alleles if a > 0)
        elif "AC" in v.info:
            try:
                ac = sum(int(x) for x in str(v.info["AC"]).split(","))
            except ValueError:
                ac = None
        return (str(ac),) if ac is not None else ("0",)


class IndelSize(VariantStratifier):
    """net indel length in [-maxSize, maxSize] (stratifications/IndelSize.java)."""

    name = "IndelSize"

    def __init__(self, max_size: int = 10):
        self.max_size = max_size

    def relevant_states(self, ctx: EvalContext):
        if ctx.vtype != "INDEL":
            return ()
        v = ctx.variant
        out = []
        for a in v.alts:
            if a and not a.startswith("<") and a != "*" and len(a) != len(v.ref):
                size = len(a) - len(v.ref)
                out.append(str(max(-self.max_size, min(self.max_size, size))))
        return tuple(dict.fromkeys(out))


class OneBPIndel(VariantStratifier):
    """1-bp vs longer indels (stratifications/OneBPIndel.java)."""

    name = "OneBPIndel"
    all_states = ("all", "one.bp", "two.plus.bp")

    def relevant_states(self, ctx: EvalContext):
        if ctx.vtype != "INDEL":
            return ("all",)
        v = ctx.variant
        sizes = {abs(len(a) - len(v.ref)) for a in v.alts
                 if a and not a.startswith("<") and a != "*"}
        return ("all",) + tuple(
            dict.fromkeys("one.bp" if s == 1 else "two.plus.bp"
                          for s in sizes if s))


class AlleleFrequency(VariantStratifier):
    """binned AF from the INFO field (stratifications/AlleleFrequency.java:
    5% bins)."""

    name = "AlleleFrequency"

    def relevant_states(self, ctx: EvalContext):
        v = ctx.variant
        raw = v.info.get("AF")
        if raw is None:
            return ("unknown",)
        out = []
        for x in str(raw).split(","):
            try:
                af = float(x)
            except ValueError:
                continue
            out.append(f"{round(af / 0.05) * 0.05:.2f}")
        return tuple(dict.fromkeys(out)) or ("unknown",)


class CpG(VariantStratifier):
    """CpG-context SNP sites via the reference (stratifications/CpG.java:
    the base pair (ref, next) or (prev, ref) forms CG)."""

    name = "CpG"
    all_states = ("all", "CpG", "non_CpG")

    def __init__(self, ref=None):
        self.ref = ref

    def relevant_states(self, ctx: EvalContext):
        if self.ref is None:
            return ("all",)
        v = ctx.variant
        try:
            lo = max(0, v.pos - 1)
            window = self.ref.fetch(v.contig, lo, v.pos + 2).tobytes().decode()
        except (KeyError, ValueError):
            return ("all",)
        mid = v.pos - lo
        is_cpg = ("CG" in window[mid : mid + 2]) or ("CG" in window[max(0, mid - 1) : mid + 1])
        return ("all", "CpG" if is_cpg else "non_CpG")


STRATIFIER_REGISTRY = {
    "Novelty": Novelty,
    "Filter": Filter,
    "FilterType": FilterType,
    "Contig": Contig,
    "VariantType": VariantType,
    "Sample": Sample,
    "AlleleCount": AlleleCount,
    "IndelSize": IndelSize,
    "OneBPIndel": OneBPIndel,
    "AlleleFrequency": AlleleFrequency,
    "CpG": CpG,
}

# enabled by default (StandardStratification marker: Novelty; Filter is the
# most-used optional and the prior tool's behavior — kept standard here)
STANDARD_STRATIFICATIONS = ("Novelty",)


class Family(VariantStratifier):
    """Stratify by family (stratifications/Family.java). In pedigree mode
    (VariantEval -ped) the engine drives one per-family-subsetted context per
    family level and this stratifier returns that level
    (VariantEvalEngine.java:394-398); without a pedigree, membership falls
    back to set_families({name: [sample indices]})."""

    name = "Family"
    families: dict = {}
    family_levels: tuple = ()  # pedigree mode: family names + "all"

    @property
    def all_states(self):
        if self.family_levels:
            return tuple(self.family_levels)
        return ("all",) + tuple(self.families)

    def relevant_states(self, ctx):
        if getattr(ctx, "family_name", None) is not None:
            return (ctx.family_name,)
        states = ["all"]
        for fam, idxs in self.families.items():
            for i in idxs:
                if i < len(ctx.variant.samples or []):
                    gt = ctx.variant.samples[i].get("GT", "./.")
                    if any(a not in ("0", ".") for a in
                           gt.replace("|", "/").split("/")):
                        states.append(fam)
                        break
        return tuple(states)


class TandemRepeatStrat(VariantStratifier):
    """Stratify indels by tandem-repeat context (stratifications/TandemRepeat.java):
    'all', then 'is.repeat' or 'not.repeat' from STR/RU/RPA infos."""

    name = "TandemRepeat"
    all_states = ("all", "is.repeat", "not.repeat")

    def relevant_states(self, ctx):
        info = ctx.variant.info
        is_str = ("STR" in info) or ("RU" in info and "RPA" in info)
        return ("all", "is.repeat" if is_str else "not.repeat")


class IntervalStratification(VariantStratifier):
    """Stratify by overlap with supplied intervals
    (stratifications/IntervalStratification.java); set `intervals` to a list of
    engine Interval objects."""

    name = "IntervalStratification"
    all_states = ("all", "overlaps.intervals", "outside.intervals")
    intervals: list = []

    def relevant_states(self, ctx):
        v = ctx.variant
        # span overlap over [start, end] incl. symbolic END
        # (IntervalStratification.java:52 queryFeaturesIncludingOverlapping)
        v_end = v.end
        inside = any(t.contig == v.contig and t.start < v_end and v.pos < t.end
                     for t in self.intervals)
        return ("all", "overlaps.intervals" if inside else "outside.intervals")


class FunctionalClass(VariantStratifier):
    """Stratify by predicted functional class (stratifications/FunctionalClass.java,
    SnpEff/Funcotator EFF-style info): silent/missense/nonsense."""

    name = "FunctionalClass"
    all_states = ("all", "silent", "missense", "nonsense")

    def relevant_states(self, ctx):
        info = ctx.variant.info
        text = str(info.get("FUNCOTATION", "")) + str(info.get("EFF", "")) + \
            str(info.get("ANN", ""))
        text = text.upper()
        states = ["all"]
        if "SILENT" in text or "SYNONYMOUS" in text:
            states.append("silent")
        if "MISSENSE" in text:
            states.append("missense")
        if "NONSENSE" in text or "STOP_GAINED" in text:
            states.append("nonsense")
        return tuple(states)


class CompFeatureInput(VariantStratifier):
    """Stratify by comp track name (stratifications/CompFeatureInput.java);
    the engine runs one manager per comp track, so the state is fixed at
    construction."""

    name = "CompFeatureInput"
    comp_name = "none"

    @property
    def all_states(self):
        return (self.comp_name,)

    def relevant_states(self, ctx):
        return (self.comp_name,)


class EvalFeatureInput(VariantStratifier):
    """Stratify by eval track name (stratifications/EvalFeatureInput.java)."""

    name = "EvalFeatureInput"
    eval_name = "eval"

    @property
    def all_states(self):
        return (self.eval_name,)

    def relevant_states(self, ctx):
        return (self.eval_name,)


class JexlExpression(VariantStratifier):
    """Stratify by user-select JEXL expressions (stratifications/
    JexlExpression.java): 'none' plus each matching -select expression name."""

    name = "JexlExpression"
    # [(name, expression)] — set from -select/-select-name args
    expressions: list = []

    @property
    def all_states(self):
        return ("none",) + tuple(n for n, _ in self.expressions)

    def relevant_states(self, ctx):
        from .. import cli  # noqa: F401  (break the tools<->cli import cycle)
        from ..tools.select_variants import eval_jexl

        states = ["none"]
        for nm, expr in self.expressions:
            try:
                if eval_jexl(expr, ctx.variant):
                    states.append(nm)
            except Exception:
                pass
        return tuple(states)


# SnpEffUtil.EffectType child -> parent edges (varianteval/util/SnpEffUtil.java)
_SNPEFF_PARENT = {
    "UPSTREAM": "INTERGENIC", "DOWNSTREAM": "INTERGENIC",
    "INTERGENIC_CONSERVED": "INTERGENIC",
    "INTRON_CONSERVED": "INTRON", "SPLICE_SITE_ACCEPTOR": "INTRON",
    "SPLICE_SITE_DONOR": "INTRON",
    "EXON_DELETED": "CDS", "SYNONYMOUS_CODING": "CDS",
    "NON_SYNONYMOUS_CODING": "CDS",
    "SYNONYMOUS_STOP": "SYNONYMOUS_CODING", "SYNONYMOUS_START": "SYNONYMOUS_CODING",
    "START_LOST": "NON_SYNONYMOUS_CODING", "STOP_GAINED": "NON_SYNONYMOUS_CODING",
    "STOP_LOST": "NON_SYNONYMOUS_CODING", "CODON_CHANGE": "NON_SYNONYMOUS_CODING",
    "CODON_INSERTION": "NON_SYNONYMOUS_CODING",
    "CODON_DELETION": "NON_SYNONYMOUS_CODING",
    "CODON_CHANGE_PLUS_CODON_DELETION": "NON_SYNONYMOUS_CODING",
    "CODON_CHANGE_PLUS_CODON_INSERTION": "NON_SYNONYMOUS_CODING",
    "FRAME_SHIFT": "NON_SYNONYMOUS_CODING",
    "UTR_5_DELETED": "UTR_5_PRIME", "UTR_3_DELETED": "UTR_3_PRIME",
    "START_GAINED": "UTR_5_PRIME",
    "UTR_5_PRIME": "EXON", "UTR_3_PRIME": "EXON", "CDS": "EXON",
    "INTRON": "TRANSCRIPT", "EXON": "TRANSCRIPT",
    "TRANSCRIPT": "GENE", "REGULATION": "GENE",
    "GENE": "CHROMOSOME", "INTERGENIC": "CHROMOSOME",
}


def _snpeff_is_subtype(child: str, parent: str) -> bool:
    node = child
    while node is not None:
        if node == parent:
            return True
        node = _SNPEFF_PARENT.get(node)
    return False


class SnpEffPositionModifier(VariantStratifier):
    """Stratify by SnpEff position modifier (stratifications/
    SnpEffPositionModifier.java): GENE/CODING_REGION/SPLICE_SITE/STOP_GAINED/
    STOP_LOST from the SNPEFF_EFFECT info key and the SnpEffUtil hierarchy."""

    name = "SnpEffPositionModifier"
    all_states = ("GENE", "CODING_REGION", "SPLICE_SITE", "STOP_GAINED",
                  "STOP_LOST")

    def relevant_states(self, ctx):
        eff = ctx.variant.info.get("SNPEFF_EFFECT")
        if not eff:
            return ()
        eff = str(eff)
        states = []
        if _snpeff_is_subtype(eff, "EXON"):
            states.append("GENE")
        if _snpeff_is_subtype(eff, "CDS"):
            states.append("CODING_REGION")
        if _snpeff_is_subtype(eff, "STOP_GAINED"):
            states.append("STOP_GAINED")
        if _snpeff_is_subtype(eff, "STOP_LOST"):
            states.append("STOP_LOST")
        if _snpeff_is_subtype(eff, "SPLICE_SITE_ACCEPTOR") or \
                _snpeff_is_subtype(eff, "SPLICE_SITE_DONOR"):
            states.append("SPLICE_SITE")
        return tuple(states)


_AMINO_ACID_CODONS = {
    "Ile": ("ATT", "ATC", "ATA"),
    "Leu": ("CTT", "CTC", "CTA", "CTG", "TTA", "TTG"),
    "Val": ("GTT", "GTC", "GTA", "GTG"),
    "Phe": ("TTT", "TTC"),
    "Met": ("ATG",),
    "Cys": ("TGT", "TGC"),
    "Ala": ("GCT", "GCC", "GCA", "GCG"),
    "Gly": ("GGT", "GGC", "GGA", "GGG"),
    "Pro": ("CCT", "CCC", "CCA", "CCG"),
    "Thr": ("ACT", "ACC", "ACA", "ACG"),
    "Ser": ("TCT", "TCC", "TCA", "TCG", "AGT", "AGC"),
    "Tyr": ("TAT", "TAC"),
    "Trp": ("TGG",),
    "Gln": ("CAA", "CAG"),
    "Asn": ("AAT", "AAC"),
    "His": ("CAT", "CAC"),
    "Glu": ("GAA", "GAG"),
    "Asp": ("GAT", "GAC"),
    "Lys": ("AAA", "AAG"),
    "Arg": ("CGT", "CGC", "CGA", "CGG", "AGA", "AGG"),
    "Stop": ("TAA", "TAG", "TGA"),
}


def _degeneracy_table():
    """aa -> frame -> '{n}-fold' (Degeneracy.java constructor)."""
    table = {}
    for aa, codons in _AMINO_ACID_CODONS.items():
        for pos in range(3):
            alleles = {c[pos] for c in codons}
            table.setdefault(aa.lower(), {})[pos] = {
                1: "1-fold", 2: "2-fold", 3: "3-fold", 4: "4-fold",
                6: "6-fold"}.get(len(alleles), "1-fold")
    return table


class Degeneracy(VariantStratifier):
    """Stratify coding SNPs by codon-position degeneracy (stratifications/
    Degeneracy.java) from refseq.variantAA / refseq.frame annotations."""

    name = "Degeneracy"
    all_states = ("1-fold", "2-fold", "3-fold", "4-fold", "6-fold", "all")
    _table = None

    def relevant_states(self, ctx):
        if Degeneracy._table is None:
            Degeneracy._table = _degeneracy_table()
        states = ["all"]
        v = ctx.variant
        info = v.info
        aa = frame = None
        if "refseq.functionalClass" in info:
            aa = info.get("refseq.variantAA")
            frame = info.get("refseq.frame", 0)
        elif "refseq.functionalClass_1" in info:
            # pick the most deleterious annotation (silent < missense < nonsense)
            vtype = None
            i = 1
            while f"refseq.functionalClass_{i}" in info:
                newtype = info.get(f"refseq.functionalClass_{i}")
                if newtype is not None and (
                        vtype is None
                        or (vtype == "silent" and newtype != "silent")
                        or (vtype == "missense" and newtype == "nonsense")):
                    vtype = newtype
                    aa = info.get(f"refseq.variantAA_{i}")
                    frame = info.get(f"refseq.frame_{i}", frame or 0)
                i += 1
        if aa:
            key = str(aa).lower()
            deg = Degeneracy._table.get(key, {}).get(int(frame or 0))
            if deg:
                states.append(deg)
        return tuple(states)


STRATIFIER_REGISTRY.update({
    "Family": Family,
    "TandemRepeat": TandemRepeatStrat,
    "IntervalStratification": IntervalStratification,
    "FunctionalClass": FunctionalClass,
    "CompFeatureInput": CompFeatureInput,
    "EvalFeatureInput": EvalFeatureInput,
    "JexlExpression": JexlExpression,
    "SnpEffPositionModifier": SnpEffPositionModifier,
    "Degeneracy": Degeneracy,
})
