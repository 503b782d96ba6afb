# Copied verbatim from gatk_tpu/vareval/framework.py; only import lines may differ.
"""VariantEval engine core: stratification manager + evaluation contexts.

Reference behavior: tools/walkers/varianteval/VariantEvalEngine.java and
stratifications/manager/StratificationManager.java — each eval variant maps to
the cartesian product of its stratifier states; every state combination owns an
independent instance of each evaluation module; the report is one GATKReport
table per module with one row per (comp, eval, state...) combination.
"""
from __future__ import annotations

import itertools

TRANSITIONS = {("A", "G"), ("G", "A"), ("C", "T"), ("T", "C")}


def classify(v) -> str:
    """VariantContext.getType equivalent: SNP/MNP/INDEL/SYMBOLIC/MIXED/NO_VARIATION."""
    alts = [a for a in v.alts if a and a != "*"]
    if not alts:
        return "NO_VARIATION"
    if all(a.startswith("<") for a in alts):
        return "SYMBOLIC"
    kinds = set()
    for a in alts:
        if a.startswith("<"):
            kinds.add("SYMBOLIC")
        elif len(a) == len(v.ref):
            kinds.add("SNP" if len(a) == 1 else "MNP")
        else:
            kinds.add("INDEL")
    return kinds.pop() if len(kinds) == 1 else "MIXED"


def is_transition(ref: str, alt: str) -> bool:
    return (ref, alt) in TRANSITIONS


def sample_genotypes(v):
    """[(sample_index, [allele indices])] for called genotypes."""
    out = []
    if "GT" not in v.fmt_keys:
        return out
    for i, s in enumerate(v.samples):
        gt = s.get("GT", ".")
        if not gt or gt.startswith("."):
            continue
        try:
            out.append((i, [int(x) for x in gt.replace("|", "/").split("/")]))
        except ValueError:
            continue
    return out


class EvalContext:
    """What evaluators need to know about the current record
    (VariantEvalContext equivalent)."""

    __slots__ = ("variant", "vtype", "is_known", "comp", "comp_match", "is_filtered",
                 "genotypes", "ref_bases", "n_no_calls", "keep_ac0",
                 "eval_samples", "family_name")

    def __init__(self, variant, vtype, is_known, comp, comp_match, is_filtered,
                 genotypes, n_no_calls=0, keep_ac0=False, eval_samples=(),
                 family_name=None):
        self.variant = variant
        self.vtype = vtype
        self.is_known = is_known
        self.comp = comp  # matching comp Variant or None
        self.comp_match = comp_match  # alleles agree with comp
        self.is_filtered = is_filtered
        self.n_no_calls = n_no_calls
        self.keep_ac0 = keep_ac0
        self.eval_samples = eval_samples
        self.family_name = family_name
        self.genotypes = genotypes


class VariantStratifier:
    """Base stratifier (stratifications/VariantStratifier.java): fixed state
    vocabulary + per-variant relevant states."""

    name = "?"
    all_states: tuple = ()

    def relevant_states(self, ctx: EvalContext) -> tuple:
        raise NotImplementedError


class VariantEvaluator:
    """Base evaluation module (evaluators/VariantEvaluator.java): per-context
    accumulator; `row()` emits the GATKReport data points in column order."""

    name = "?"
    columns: tuple = ()  # (column name, printf format)

    def update(self, ctx: EvalContext):
        raise NotImplementedError

    def finalize_calculations(self):
        pass

    def row(self):
        raise NotImplementedError


class StratificationManager:
    """Maps a variant to all applicable stratifier-state combinations and owns
    the per-combination evaluator instances."""

    def __init__(self, stratifiers, evaluator_factories):
        self.stratifiers = stratifiers
        self.factories = evaluator_factories
        self.contexts: dict[tuple, list] = {}

    def _evaluators_for(self, key):
        evs = self.contexts.get(key)
        if evs is None:
            evs = [f() for f in self.factories]
            self.contexts[key] = evs
        return evs

    def update(self, ctx: EvalContext):
        state_lists = [s.relevant_states(ctx) for s in self.stratifiers]
        if any(not states for states in state_lists):
            return
        comp_only = ctx.variant is None
        for key in itertools.product(*state_lists):
            for ev in self._evaluators_for(key):
                if comp_only and ev.comparison_order != 2:
                    continue  # order-1 evaluators see eval records only
                ev.update(ctx)

    def set_processed_loci(self, n: int):
        """Override evaluators' nProcessedLoci with the traversal size
        (GATK: the engine counts loci over the -L intervals, not records)."""
        for evs in self.contexts.values():
            for ev in evs:
                if hasattr(ev, "set_processed_loci"):
                    ev.set_processed_loci(n)

    def tables(self, comp_name: str, eval_name: str):
        """[(evaluator name, columns, rows)] — one table per evaluator class,
        rows sorted by state key (VariantEvalReportWriter)."""
        out = []
        for fi, factory in enumerate(self.factories):
            proto = factory()
            cols = ([(proto.name, "%s"), ("CompFeatureInput", "%s"),
                     ("EvalFeatureInput", "%s")]
                    + [(s.name, "%s") for s in self.stratifiers]
                    + list(proto.columns))
            rows = []
            for key in sorted(self.contexts):
                ev = self.contexts[key][fi]
                ev.finalize_calculations()
                rows.append([proto.name, comp_name, eval_name, *key, *ev.row()])
            out.append((proto.name, cols, rows))
        return out
