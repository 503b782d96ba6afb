# Copied verbatim from gatk_tpu/tools/select_variants.py; only import lines may differ.
"""SelectVariants: subset a callset by sample/expression/type/ID/etc.

Reference behavior: tools/walkers/variantutils/SelectVariants.java (apply
:661-722, applyFirstRoundOfFiltering :735-772, subsetGenotypesBySampleNames
:1180-1220, addAnnotations :1232-1296, dropAnnotations :839-863, isDiscordant
/isConcordant :1106-1165, makeVariantFilter :894-910), with htsjdk's
re-encoding quirks (sorted INFO keys, sorted FORMAT keys with GT first / FT
last, trailing-missing trimming, GQ integer rounding, formatVCFDouble) and
GATKVariantContextUtils.trimAlleles / AlleleSubsettingUtils.subsetAlleles for
the allele-changing paths.
"""
from __future__ import annotations

import argparse
import decimal
import heapq
import itertools
import math
import os
import re

from ..cli import UserError, register_tool
from ..engine import walkers
from ..io import vcf

MISSING = "."


# ---------------------------------------------------------------------------
# genotype helpers
# ---------------------------------------------------------------------------

def gt_tokens(gt):
    return gt.replace("|", "/").split("/")


def gt_sep(gt):
    return "|" if "|" in gt else "/"


def is_no_call(gt):
    return all(t == "." for t in gt_tokens(gt))


def is_called(gt):
    return not is_no_call(gt)


def is_hom_ref(gt):
    toks = gt_tokens(gt)
    return bool(toks) and all(t == "0" for t in toks)


def is_filtered(sample):
    ft = sample.get("FT")
    return ft not in (None, ".", "PASS")


def sample_alleles(v, gt):
    return ["." if t == "." else v.alleles[int(t)] for t in gt_tokens(gt)]


def _java_fixed(d, places):
    """Java String.format %.Nf: HALF_UP on the double's exact decimal
    expansion (Python's format uses half-even)."""
    q = decimal.Decimal(1).scaleb(-places)
    return str(decimal.Decimal(d).quantize(q, rounding=decimal.ROUND_HALF_UP))


def format_vcf_double(d):
    """htsjdk VCFEncoder.formatVCFDouble."""
    if d < 1:
        if d < 0.01:
            if abs(d) >= 1e-20:
                return f"{d:.3e}"
            return "0.00"
        return _java_fixed(d, 3)
    return _java_fixed(d, 2)


def java_round(x):
    return math.floor(float(x) + 0.5)


# ---------------------------------------------------------------------------
# JEXL-subset evaluator (VariantContextUtils.match semantics: an expression
# whose evaluation hits a missing variable is treated as a mismatch)
# ---------------------------------------------------------------------------

class JexlMissing(Exception):
    pass


_CMP_RE = re.compile(r"^\s*(.+?)\s*(<=|>=|==|!=|<|>)\s*(.+?)\s*$")
_GT_CALL_RE = re.compile(
    r"^vc\.getGenotype\(\s*['\"]([^'\"]+)['\"]\s*\)\.(\w+)\((.*?)\)$")


def _jexl_operand(tok, v, g=None):
    tok = tok.strip()
    m = _GT_CALL_RE.match(tok)
    if m:
        sample, method, arg = m.groups()
        return _genotype_call(v, sample, method, arg.strip().strip("'\""))
    if re.fullmatch(r"-?\d+(\.\d+)?([eE][-+]?\d+)?", tok):
        return float(tok)
    if tok.startswith(("'", '"')):
        return tok.strip("'\"")
    if g is not None:
        # htsjdk GenotypeJEXLContext: genotype fields shadow site fields
        if tok in ("isHom", "isHomRef", "isHomVar", "isHet", "isCalled",
                   "isNoCall", "isMixed", "isAvailable"):
            gt = g.get("GT", ".")
            toks = gt_tokens(gt)
            called = [t for t in toks if t != "."]
            val = {
                "isHomRef": bool(called) and len(called) == len(toks) and
                all(t == "0" for t in called),
                "isHomVar": bool(called) and len(called) == len(toks) and
                all(t not in (".", "0") for t in toks) and
                len(set(toks)) == 1,
                "isHet": len(called) == len(toks) and len(set(toks)) > 1,
                "isCalled": bool(called),
                "isNoCall": not called,
                "isMixed": bool(called) and len(called) != len(toks),
                "isAvailable": True,
            }
            if tok == "isHom":
                val["isHom"] = val["isHomRef"] or val["isHomVar"]
            return 1.0 if val[tok] else 0.0
        if tok == "GT":
            return g.get("GT", ".")
        if tok == "GQ":
            val = g.get("GQ")
            if val in (None, "."):
                raise JexlMissing("GQ")
            return float(java_round(val))  # htsjdk stores GQ as int
        if tok == "FT":
            val = g.get("FT")
            if val in (None, "."):
                raise JexlMissing("FT")
            return val
        if tok in g and g[tok] not in (None, "."):
            try:
                return float(str(g[tok]).split(",")[0])
            except ValueError:
                return str(g[tok])
    if tok == "QUAL":
        return v.qual if v.qual is not None else -10.0
    if tok == "FILTER":
        return "PASS" if not v.filters or v.filters == ("PASS",) else \
            ";".join(v.filters)
    if tok in v.info:
        raw = v.info[tok]
        if raw is True:
            return True
        try:
            return float(str(raw).split(",")[0])
        except ValueError:
            return str(raw)
    raise JexlMissing(tok)


def _genotype_call(v, sample, method, arg):
    try:
        si = v._sv_sample_index[sample]
    except (AttributeError, KeyError):
        raise JexlMissing(sample)
    s = v.samples[si]
    gt = s.get("GT", ".")
    if method == "isHomRef":
        return is_called(gt) and is_hom_ref(gt)
    if method == "isHet":
        toks = [t for t in gt_tokens(gt) if t != "."]
        return len(toks) == len(gt_tokens(gt)) and len(set(toks)) > 1
    if method == "isHomVar":
        toks = gt_tokens(gt)
        return all(t not in (".", "0") for t in toks) and len(set(toks)) == 1
    if method == "isCalled":
        return is_called(gt)
    if method == "isNoCall":
        return is_no_call(gt)
    if method == "getGQ":
        val = s.get("GQ")
        if val in (None, "."):
            raise JexlMissing("GQ")
        return float(java_round(val))
    if method == "getDP":
        val = s.get("DP")
        if val in (None, "."):
            raise JexlMissing("DP")
        return float(val)
    if method == "getExtendedAttribute":
        val = s.get(arg)
        if val in (None, "."):
            raise JexlMissing(arg)
        try:
            return float(val)
        except ValueError:
            return val
    raise UserError(f"unsupported JEXL genotype method: {method}")


def eval_jexl(expr, v, g=None):
    """Evaluate one -select expression; raises JexlMissing on absent fields."""
    expr = expr.strip()
    for or_part in expr.split("||"):
        all_true = True
        for clause in or_part.split("&&"):
            clause = clause.strip()
            if clause.startswith("!"):
                val = not _truthy(clause[1:].strip(), v, g)
            else:
                val = _truthy(clause, v, g)
            if not val:
                all_true = False
                break
        if all_true:
            return True
    return False


def _truthy(clause, v, g=None):
    m = _CMP_RE.match(clause)
    if m and m.group(2):
        left = _jexl_operand(m.group(1), v, g)
        right = _jexl_operand(m.group(3), v, g)
        op = m.group(2)
        if isinstance(left, bool) or isinstance(right, bool):
            pass
        elif isinstance(left, str) != isinstance(right, str):
            # numeric vs string: coerce
            try:
                left, right = float(left), float(right)
            except (TypeError, ValueError):
                left, right = str(left), str(right)
        return {"<": lambda: left < right, ">": lambda: left > right,
                "<=": lambda: left <= right, ">=": lambda: left >= right,
                "==": lambda: left == right, "!=": lambda: left != right}[op]()
    val = _jexl_operand(clause, v, g)
    return bool(val)


# ---------------------------------------------------------------------------
# htsjdk-style record encoding
# ---------------------------------------------------------------------------

_INT_FORMAT_KEYS = {"GQ"}


def encode_record(v, sample_names, sample_of):
    """Serialize with htsjdk VCFEncoder conventions: sorted INFO keys, FORMAT
    keys sorted with GT first and FT last, '.'-padded genotype fields with
    trailing missing trimmed, GQ rounded to int."""
    info_parts = []
    for key in sorted(v.info):
        val = v.info[key]
        if val is True:
            info_parts.append(key)
        elif isinstance(val, list):
            info_parts.append(f"{key}={','.join(str(x) for x in val)}")
        else:
            info_parts.append(f"{key}={val}")
    cols = [v.contig, str(v.pos + 1), v.id or ".", v.ref,
            ",".join(v.alts) if v.alts else ".",
            vcf.format_qual(v.qual),
            ";".join(sorted(v.filters)) if v.filters else ".",
            ";".join(info_parts) if info_parts else "."]
    if sample_names:
        keys = set()
        gts = []
        for name in sample_names:
            s = v.samples[sample_of[name]] if name in sample_of else {}
            # htsjdk parses a GL field into integer PLs (GenotypeLikelihoods
            # .fromGLField) and writes PL
            if s.get("GL") not in (None, ".") and \
                    s.get("PL") in (None, "."):
                s = dict(s)
                gls = [float(x) for x in s.pop("GL").split(",")]
                top = max(gls)
                s["PL"] = ",".join(str(java_round(-10.0 * (g - top)))
                                   for g in gls)
            gts.append(s)
            for k, val in s.items():
                if val not in (None, "."):
                    keys.add(k)
        fmt = sorted(keys)
        if "GT" in fmt:
            fmt.remove("GT")
            fmt.insert(0, "GT")
        if not fmt:
            fmt = ["GT"]
        cols.append(":".join(fmt))
        for s in gts:
            fields = []
            for k in fmt:
                val = s.get(k, ".")
                if val in (None, "") or (val == "." and k == "FT"):
                    # htsjdk renders an unfiltered genotype's FT as PASS
                    val = "PASS" if k == "FT" else "."
                elif k in ("DP", "GQ") and str(val).startswith("-"):
                    val = "."  # htsjdk: negative DP/GQ means missing
                elif k in _INT_FORMAT_KEYS and val != ".":
                    try:
                        val = str(min(java_round(val), 99))  # htsjdk GQ cap
                    except ValueError:
                        pass
                fields.append(str(val))
            while len(fields) > 1 and fields[-1] == ".":
                fields.pop()
            cols.append(":".join(fields))
    return "\t".join(cols)


# ---------------------------------------------------------------------------
# chromosome counts / subsetting / trimming
# ---------------------------------------------------------------------------

def calculate_chromosome_counts(v, sample_names, sample_of,
                                remove_stale=False):
    """htsjdk VariantContextUtils.calculateChromosomeCounts."""
    if not sample_names:
        return
    an = 0
    ac = [0] * len(v.alts)
    for name in sample_names:
        s = v.samples[sample_of[name]] if name in sample_of else {}
        for t in gt_tokens(s.get("GT", ".")):
            if t == ".":
                continue
            an += 1
            i = int(t)
            if i > 0:
                ac[i - 1] += 1
    if an == 0 and remove_stale:
        for key in ("AC", "AF", "AN"):
            v.info.pop(key, None)
        return
    v.info["AN"] = str(an)
    if v.alts:
        v.info["AC"] = ",".join(str(c) for c in ac)
        v.info["AF"] = ",".join(
            format_vcf_double(c / an if an else 0.0) for c in ac)
    else:
        v.info.pop("AC", None)
        v.info.pop("AF", None)


def _ad_subset(val, keep_allele_idx):
    parts = val.split(",")
    try:
        return ",".join(parts[i] for i in keep_allele_idx)
    except IndexError:
        return val


def _genotype_combos(ploidy, n_alleles):
    """All genotype allele-index combinations in VCF PL (colex) order:
    diploid (0,0),(0,1),(1,1),(0,2),(1,2),(2,2)."""
    return sorted(itertools.combinations_with_replacement(range(n_alleles),
                                                          ploidy),
                  key=lambda c: tuple(reversed(c)))


def _pl_subset(val, ploidy, old_n, keep_allele_idx):
    parts = val.split(",")
    combos = _genotype_combos(ploidy, old_n)
    if len(parts) != len(combos):
        return None  # shape mismatch: drop
    keep_set = {a: i for i, a in enumerate(keep_allele_idx)}
    out = []
    for combo, p in zip(combos, parts):
        if all(a in keep_set for a in combo):
            out.append(p)
    try:
        ints = [int(x) for x in out]
        m = min(ints)
        return ",".join(str(x - m) for x in ints)
    except ValueError:
        return ",".join(out)


def _sac_subset(val, keep_allele_idx):
    parts = val.split(",")
    out = []
    for a in keep_allele_idx:
        if 2 * a + 1 < len(parts):
            out.extend(parts[2 * a:2 * a + 2])
    return ",".join(out)


def subset_alleles_in_genotypes(v, keep_allele_idx, old_n):
    """AlleleSubsettingUtils.subsetAlleles(DO_NOT_ASSIGN_GENOTYPES): remap
    GT indices, subset AD/PL/SAC, drop stale GQ with the PLs recomputed."""
    remap = {old: new for new, old in enumerate(keep_allele_idx)}
    for s in v.samples:
        gt = s.get("GT")
        # makeGenotypeCall: a hom-ref/no-call genotype with GQ==0 becomes a
        # no-call once alleles are subset; with DP==0 it is stripped bare
        if gt is not None and (is_hom_ref(gt) or is_no_call(gt)) and \
                s.get("GQ") not in (None, ".") and float(s["GQ"]) == 0:
            sep = gt_sep(gt)
            nocall = sep.join("." for _ in gt_tokens(gt))
            if s.get("DP") not in (None, ".") and float(s["DP"]) == 0:
                for k in [k for k in s if k != "GT"]:
                    s.pop(k)
            s["GT"] = gt = nocall
        if gt is not None:
            sep = gt_sep(gt)
            s["GT"] = sep.join(
                "." if t == "." else str(remap.get(int(t), 0))
                for t in gt_tokens(gt))
            ploidy = len(gt_tokens(gt))
        else:
            ploidy = 2
        if s.get("AD") not in (None, "."):
            s["AD"] = _ad_subset(s["AD"], keep_allele_idx)
        if s.get("PL") not in (None, "."):
            pl = _pl_subset(s["PL"], ploidy, old_n, keep_allele_idx)
            if pl is None:
                s.pop("PL", None)
                s.pop("GQ", None)  # gb.noPL().noGQ(): stale GQ dropped too
            else:
                s["PL"] = pl
                if "GQ" in s and len(keep_allele_idx) > 1:
                    # GQ recomputed from the subset PLs (second-smallest)
                    try:
                        ints = sorted(int(x) for x in pl.split(","))
                        if len(ints) > 1:
                            s["GQ"] = str(ints[1])
                    except ValueError:
                        pass
        if s.get("SAC") not in (None, "."):
            s["SAC"] = _sac_subset(s["SAC"], keep_allele_idx)


def trim_alleles(v):
    """GATKVariantContextUtils.trimAlleles(vc, true, true): strip shared
    trailing then leading bases (keeping at least one), shifting POS."""
    alleles = [v.ref] + [a for a in v.alts]
    concrete = [a for a in alleles if not a.startswith("<") and a != "*"
                and "[" not in a and "]" not in a]
    if len(concrete) < 2 or any(len(a) == 0 for a in concrete):
        return v
    # reverse trim
    rev = 0
    while all(len(a) - rev > 1 for a in concrete):
        last = {a[len(a) - 1 - rev] for a in concrete}
        if len(last) == 1:
            rev += 1
        else:
            break
    # forward trim
    fwd = 0
    while all(len(a) - rev - fwd > 1 for a in concrete):
        first = {a[fwd] for a in concrete}
        if len(first) == 1:
            fwd += 1
        else:
            break
    if rev == 0 and fwd == 0:
        return v
    def trim(a):
        if a.startswith("<") or a == "*" or "[" in a or "]" in a:
            return a
        return a[fwd:len(a) - rev]
    v.ref = trim(v.ref)
    v.alts = tuple(trim(a) for a in v.alts)
    v.pos += fwd
    if "END" in v.info:
        v.info["END"] = str(v.pos + len(v.ref))
    return v


# ---------------------------------------------------------------------------
# the tool
# ---------------------------------------------------------------------------

def _names_arg(values):
    """-sn/-xl-sn/-ids accept literal names or .args/.list/.txt files."""
    out = []
    for val in values:
        if os.path.isfile(val) and val.endswith((".args", ".list", ".txt",
                                                 ".intervals")):
            out.extend(l.strip() for l in open(val) if l.strip())
        else:
            out.append(val)
    return out


@register_tool("SelectVariants")
def select_variants(argv):
    p = argparse.ArgumentParser(description="SelectVariants")
    p.add_argument("-V", "--variant", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("-R", "--reference", default=None)
    p.add_argument("-L", "--intervals", action="append", default=None)
    p.add_argument("-sn", "--sample-name", action="append", default=[])
    p.add_argument("-se", "--sample-expressions", action="append", default=[])
    p.add_argument("-xl-sn", "--exclude-sample-name", action="append",
                   default=[])
    p.add_argument("-xl-se", "--exclude-sample-expressions", action="append",
                   default=[])
    p.add_argument("-select", "--selectExpressions", "--select-expressions",
                   dest="select", action="append", default=[])
    p.add_argument("-select-genotype", "--select-genotype", action="append",
                   default=[])
    p.add_argument("--invertSelect", "--invert-select", dest="invert_select",
                   action="store_true")
    p.add_argument("-exclude-filtered", "--exclude-filtered",
                   action="store_true")
    p.add_argument("--exclude-non-variants", action="store_true")
    p.add_argument("--preserve-alleles", action="store_true")
    p.add_argument("--remove-unused-alternates", action="store_true")
    p.add_argument("--restrict-alleles-to", default="ALL",
                   choices=["ALL", "BIALLELIC", "MULTIALLELIC"])
    p.add_argument("--keep-original-ac", action="store_true")
    p.add_argument("--keep-original-dp", action="store_true")
    p.add_argument("--mendelian-violation", action="store_true")
    p.add_argument("--invert-mendelian-violation", action="store_true")
    p.add_argument("--mendelian-violation-qual-threshold", type=float,
                   default=0)
    p.add_argument("-ped", "--pedigree", default=None)
    p.add_argument("--select-type-to-include", action="append", default=[])
    p.add_argument("--select-type-to-exclude", action="append", default=[])
    p.add_argument("--ignore-non-ref-in-types", action="store_true")
    p.add_argument("-ids", "--keep-ids", action="append", default=[])
    p.add_argument("-xl-ids", "--exclude-ids", action="append", default=[])
    p.add_argument("--max-indel-size", type=int, default=2 ** 31 - 1)
    p.add_argument("--min-indel-size", type=int, default=0)
    p.add_argument("--max-filtered-genotypes", type=int, default=2 ** 31 - 1)
    p.add_argument("--min-filtered-genotypes", type=int, default=0)
    p.add_argument("--max-fraction-filtered-genotypes", type=float,
                   default=1.0)
    p.add_argument("--min-fraction-filtered-genotypes", type=float,
                   default=0.0)
    p.add_argument("--max-nocall-number", type=int, default=2 ** 31 - 1)
    p.add_argument("--max-nocall-fraction", type=float, default=1.0)
    p.add_argument("--set-filtered-gt-to-nocall", action="store_true")
    p.add_argument("-DA", "--drop-info-annotation", action="append",
                   default=[])
    p.add_argument("-DGA", "--drop-genotype-annotation", action="append",
                   default=[])
    p.add_argument("--allow-nonoverlapping-command-line-samples",
                   action="store_true")
    p.add_argument("-conc", "--concordance", default=None)
    p.add_argument("-disc", "--discordance", default=None)
    p.add_argument("--apply-jexl-filters-first", action="store_true")
    p.add_argument("--suppress-reference-path", action="store_true")
    p.add_argument("--lenient", "-LE", action="store_true")
    p.add_argument("--add-output-vcf-command-line", default="true")
    p.add_argument("--fail-on-unsorted-genotype", action="store_true")
    p.add_argument("--variant-output-filtering", default=None,
                   choices=["ANYWHERE", "OVERLAPS", "STARTS_IN", "ENDS_IN",
                            "CONTAINED"],
                   help="IntervalFilteringVcfWriter mode vs -L intervals")
    args = p.parse_args(argv)

    w = _SelectVariantsWalker(variant_path=args.variant,
                              intervals=args.intervals)
    w.args = args
    w.run()
    return 0


_SELECT_TYPES = {"SNP", "INDEL", "MIXED", "MNP", "SYMBOLIC", "NO_VARIATION"}


def _variant_type(v, ignore_non_ref=False):
    alts = [a for a in v.alts if not (ignore_non_ref and
                                      a in ("<NON_REF>", "<*>"))]
    if not alts:
        return "NO_VARIATION"
    kinds = set()
    for a in alts:
        if a.startswith("<") or a == "*" or "[" in a or "]" in a:
            kinds.add("SYMBOLIC")
        elif len(a) == len(v.ref):
            kinds.add("SNP" if len(a) == 1 else "MNP")
        else:
            kinds.add("INDEL")
    return kinds.pop() if len(kinds) == 1 else "MIXED"


class _SelectVariantsWalker(walkers.VariantWalker):
    """SelectVariants as a VariantWalker."""

    tool_name = "SelectVariants"
    default_read_filters = ()

    def on_traversal_start(self):
        args = self.args
        rdr = self.variant_reader
        vcf_samples = sorted({s for s in rdr.samples if s})
        self.sample_of = {s: i for i, s in enumerate(rdr.samples)}

        include = set(_names_arg(args.sample_name))
        for expr in args.sample_expressions:
            rx = re.compile(expr)
            matched = [s for s in vcf_samples if rx.search(s)]
            include.update(matched if matched else
                           ([expr] if expr in vcf_samples else []))
        missing = include - set(vcf_samples)
        if missing and not args.allow_nonoverlapping_command_line_samples:
            raise UserError(
                f"samples not in the VCF: {sorted(missing)} (use "
                "--allow-nonoverlapping-command-line-samples to ignore)")
        samples = set(vcf_samples) if not include else \
            (include & set(vcf_samples))
        xl_names = _names_arg(args.exclude_sample_name)
        xl_matched = set()
        for expr in args.exclude_sample_expressions:
            rx = re.compile(expr)
            xl_matched.update(s for s in vcf_samples if rx.search(s))
        samples -= set(xl_names) | xl_matched
        # exclusions clear the "nothing specified" fast path (:953-955)
        self.no_samples_specified = (not include and not xl_names and
                                     not xl_matched)
        self.samples = sorted(samples)

        self.keep_ids = set(_names_arg(args.keep_ids))
        self.exclude_ids = set(_names_arg(args.exclude_ids))
        types = set(args.select_type_to_include) or set(_SELECT_TYPES)
        types -= set(args.select_type_to_exclude)
        for t in (set(args.select_type_to_include) |
                  set(args.select_type_to_exclude)):
            if t not in _SELECT_TYPES:
                raise UserError(f"unknown variant type {t}")
        self.selected_types = None if types == _SELECT_TYPES else types

        self.disc = self._load_track(args.discordance)
        self.conc = self._load_track(args.concordance)
        self.trios = self._load_pedigree(args.pedigree) \
            if args.mendelian_violation else []

        hdr = [h for h in rdr.header_lines if not h.startswith("##contig") or
               True]
        self.writer = vcf.VcfWriter(args.output, self.samples,
                                    extra_header_lines=hdr,
                                    write_format=bool(self.samples))
        self.pending = []  # heap of (contig_seq, start, seq, line)
        self._seq = 0
        self._cur_contig = None
        self.n = 0

    @staticmethod
    def _load_track(path):
        if not path:
            return None
        out = {}
        rdrx = vcf.VcfReader(path)
        sample_of = {s: i for i, s in enumerate(rdrx.samples)}
        for rec in rdrx:
            out.setdefault((rec.contig, rec.pos), []).append(
                (rec, sample_of))
        return out

    @staticmethod
    def _load_pedigree(path):
        trios = []
        if not path:
            return trios
        for line in open(path):
            f = line.split()
            if len(f) >= 4 and f[2] != "0" and f[3] != "0":
                trios.append((f[1], f[2], f[3]))  # child, dad, mom
        return trios

    # ---- predicates ----

    @staticmethod
    def _not_filtered(v):
        return not v.filters or v.filters == ("PASS",)

    def _sample(self, v, name):
        i = self.sample_of.get(name)
        return v.samples[i] if i is not None and i < len(v.samples) else {}

    def _passes_jexl(self, v):
        args = self.args
        if not args.select:
            return True
        v._sv_sample_index = self.sample_of
        for expr in args.select:
            try:
                match = eval_jexl(expr, v)
            except JexlMissing:
                match = False  # VariantContextUtils missing -> mismatch
            if match != args.invert_select:
                return True
        return False

    def _is_mendelian_violation(self, v):
        """MendelianViolation.countFamilyViolations > 0 (lowest-level check:
        child allele must be inheritable from parents, GQs above threshold)."""
        minq = self.args.mendelian_violation_qual_threshold
        for child, dad, mom in self.trios:
            gts = []
            ok = True
            for name in (mom, dad, child):
                s = self._sample(v, name)
                gt = s.get("GT", ".")
                gq = s.get("GQ")
                if not is_called(gt) or "." in gt_tokens(gt) or \
                        (gq not in (None, ".") and float(gq) < minq):
                    ok = False
                    break
                gts.append(gt_tokens(gt))
            if not ok:
                continue
            momg, dadg, childg = gts[0], gts[1], gts[2]
            violation = True
            for m_a in set(momg):
                for d_a in set(dadg):
                    if sorted([m_a, d_a]) == sorted(childg):
                        violation = False
            if violation:
                return True
        return False

    def _sample_has_variant(self, v, name):
        s = self._sample(v, name)
        gt = s.get("GT")
        if gt is None:
            return False
        return not (is_called(gt) and is_hom_ref(gt)) and (
            is_called(gt) or (is_filtered(s) and
                              not self.args.exclude_filtered))

    def _have_same_genotypes(self, v, s1, comp_v, s2):
        g1, g2 = s1.get("GT"), s2.get("GT")
        if g1 is None or g2 is None:
            return False
        if (is_called(g1) and is_filtered(s2)) or \
                (is_called(g2) and is_filtered(s1)) or \
                (is_filtered(s1) and is_filtered(s2) and
                 self.args.exclude_filtered):
            return False
        a1 = sorted(sample_alleles(v, g1))
        a2 = sorted(sample_alleles(comp_v, g2))
        return a1 == a2

    def _is_discordant(self, v, comps):
        if self.no_samples_specified:
            return not comps
        for name in self.samples:
            if self._sample_has_variant(v, name):
                if not comps:
                    return True
                found = False
                for comp_v, comp_sample_of in comps:
                    ci = comp_sample_of.get(name)
                    if ci is not None and ci < len(comp_v.samples) and \
                            self._have_same_genotypes(
                                v, self._sample(v, name), comp_v,
                                comp_v.samples[ci]):
                        found = True
                        break
                if not found:
                    return True
        return False

    def _is_concordant(self, v, comps):
        if not comps:
            return False
        if self.no_samples_specified:
            return True
        for name in self.samples:
            if name not in self.sample_of:
                continue
            found = False
            for comp_v, comp_sample_of in comps:
                ci = comp_sample_of.get(name)
                if ci is not None and ci < len(comp_v.samples) and \
                        self._have_same_genotypes(
                            v, self._sample(v, name), comp_v,
                            comp_v.samples[ci]):
                    found = True
                    break
            if not found:
                return False
        return True

    def _indel_out_of_bounds(self, v):
        lengths = [len(a) - len(v.ref) for a in v.alts
                   if not a.startswith("<") and a != "*" and
                   len(a) != len(v.ref)]
        if not lengths:
            return False
        return any(abs(l) > self.args.max_indel_size or
                   abs(l) < self.args.min_indel_size for l in lengths)

    # ---- subsetting ----

    def _subset(self, v):
        args = self.args
        if self.no_samples_specified and not args.remove_unused_alternates:
            return v, False
        orig_samples = [s for s in self.variant_reader.samples if s]
        keep_allele_idx = list(range(len(v.alleles)))
        if args.remove_unused_alternates:
            used = set()
            for name in self.samples:
                for t in gt_tokens(self._sample(v, name).get("GT", ".")):
                    if t != ".":
                        used.add(int(t))
            keep_allele_idx = [0] + [i for i in range(1, len(v.alleles))
                                     if i in used]
        if len(self.samples) == len(orig_samples) and \
                len(keep_allele_idx) == len(v.alleles):
            return v, False
        # build the subset record
        new = vcf.Variant(
            contig=v.contig, pos=v.pos, ref=v.ref,
            alts=tuple(v.alleles[i] for i in keep_allele_idx[1:]),
            id=v.id, qual=v.qual, filters=v.filters, info=dict(v.info),
            fmt_keys=v.fmt_keys,
            samples=[dict(self._sample(v, name)) for name in self.samples])
        if len(keep_allele_idx) != len(v.alleles):
            subset_alleles_in_genotypes(new, keep_allele_idx, len(v.alleles))
        new.info.pop("MLEAC", None)
        new.info.pop("MLEAF", None)
        self._add_annotations(new, v)
        if not args.preserve_alleles:
            trim_alleles(new)
        return new, True

    def _add_annotations(self, new, orig):
        args = self.args
        if args.keep_original_ac:
            # map new alts back to original alt indices
            if len(new.alts) != len(orig.alts):
                idx = [orig.alts.index(a) for a in new.alts
                       if a in orig.alts]
            else:
                idx = None
            for key, orig_key in (("AC", "AC_Orig"), ("AF", "AF_Orig")):
                if key in orig.info:
                    parts = str(orig.info[key]).split(",")
                    new.info[orig_key] = ",".join(
                        parts[i] for i in idx) if idx is not None else \
                        orig.info[key]
            if "AN" in orig.info:
                new.info["AN_Orig"] = orig.info["AN"]
        local_of = {name: i for i, name in enumerate(self.samples)}
        calculate_chromosome_counts(new, self.samples, local_of)
        if args.keep_original_dp and "DP" in orig.info:
            new.info["DP_Orig"] = orig.info["DP"]
        saw_dp, depth = False, 0
        for name in self.samples:
            s = self._sample(orig, name)
            if not is_filtered(s) and s.get("DP") not in (None, ".") and \
                    int(float(s["DP"])) >= 0:  # DP=-1 is htsjdk "missing"
                depth += int(float(s["DP"]))
                saw_dp = True
        if saw_dp:
            new.info["DP"] = str(depth)

    def _set_filtered_to_nocall(self, v):
        for s in v.samples:
            if is_filtered(s) and s.get("GT") not in (None, "."):
                gt = s["GT"]
                sep = gt_sep(gt)
                s["GT"] = sep.join("." for _ in gt_tokens(gt))

    def _drop_annotations(self, v):
        for key in self.args.drop_info_annotation:
            v.info.pop(key, None)
        if self.args.drop_genotype_annotation:
            for s in v.samples:
                for key in self.args.drop_genotype_annotation:
                    s.pop(key, None)
        return v

    def _is_polymorphic_in_samples(self, v):
        for s in v.samples:  # already subset to selected samples
            gt = s.get("GT")
            if gt is None:
                continue
            if is_filtered(s) and self.args.exclude_filtered:
                continue
            toks = gt_tokens(gt)
            if any(t not in (".", "0") for t in toks):
                return True
        return False

    def _spanning_deletion_only(self, v):
        return len(v.alts) >= 1 and all(a == "*" for a in v.alts)

    # ---- traversal ----

    def _variants(self):
        targets = self.targets if self.intervals_arg else None
        mode = self.args.variant_output_filtering

        def keep(v):
            if targets is None or mode == "ANYWHERE":
                return True
            for t in targets:
                if t.contig != v.contig:
                    continue
                if mode == "STARTS_IN":
                    if t.start <= v.pos < t.end:
                        return True
                elif mode == "ENDS_IN":
                    if t.start <= v.end - 1 < t.end:
                        return True
                elif mode == "CONTAINED":
                    if t.start <= v.pos and v.end <= t.end:
                        return True
                elif v.pos < t.end and v.end > t.start:  # OVERLAPS default
                    return True
            return False

        for v in self.variant_reader:
            if not keep(v):
                continue
            if v.filters == ("0",):  # htsjdk PASSES_FILTERS_v3
                v.filters = ("PASS",)
            yield v

    def apply(self, v):
        args = self.args
        # flush pending variants that can no longer be displaced
        while self.pending and (self._cur_contig != v.contig or
                                self.pending[0][0] <= v.pos):
            self._emit(heapq.heappop(self.pending)[2])
        if self._cur_contig != v.contig:
            while self.pending:
                self._emit(heapq.heappop(self.pending)[2])
            self._cur_contig = v.contig

        # makeVariantFilter: types and IDs
        if self.selected_types is not None and \
                _variant_type(v, args.ignore_non_ref_in_types) not in \
                self.selected_types:
            return
        if self.keep_ids and not (set(v.id.split(";")) & self.keep_ids):
            return
        if self.exclude_ids and (set(v.id.split(";")) & self.exclude_ids):
            return

        # first round of filtering
        if args.exclude_filtered and not self._not_filtered(v):
            return
        if args.mendelian_violation:
            no_violation = not self._is_mendelian_violation(v)
            if no_violation != args.invert_mendelian_violation:
                return
        if args.discordance is not None and not self._is_discordant(
                v, self.disc.get((v.contig, v.pos), [])):
            return
        if args.concordance is not None and not self._is_concordant(
                v, self.conc.get((v.contig, v.pos), [])):
            return
        if args.restrict_alleles_to == "BIALLELIC" and len(v.alts) != 1:
            return
        if args.restrict_alleles_to == "MULTIALLELIC" and len(v.alts) == 1:
            return
        if self._indel_out_of_bounds(v):
            return
        if args.apply_jexl_filters_first and not self._passes_jexl(v):
            return

        # filtered/no-call genotype count limits (over the selected samples)
        if (args.max_filtered_genotypes != 2 ** 31 - 1 or
                args.min_filtered_genotypes != 0 or
                args.max_fraction_filtered_genotypes != 1.0 or
                args.min_fraction_filtered_genotypes != 0.0):
            nf = sum(1 for name in self.samples
                     if is_filtered(self._sample(v, name)))
            # reference quirk: numFilteredSamples / samples.size() is Java
            # INT division (SelectVariants.java:683), so 1 of 2 -> 0.0
            frac = float(nf // len(self.samples)) if self.samples else 0.0
            if (nf > args.max_filtered_genotypes or
                    nf < args.min_filtered_genotypes or
                    frac > args.max_fraction_filtered_genotypes or
                    frac < args.min_fraction_filtered_genotypes):
                return
        if args.max_nocall_number != 2 ** 31 - 1 or \
                args.max_nocall_fraction != 1.0:
            nn = sum(1 for name in self.samples
                     if is_no_call(self._sample(v, name).get("GT", ".")))
            frac = nn / len(self.samples) if self.samples else 0.0
            if nn > args.max_nocall_number or \
                    frac > args.max_nocall_fraction:
                return

        # -conc quirk: isConcordant's variantSamples.retainAll(samples)
        # mutates the live htsjdk sample-name set, so the later
        # sub.getNSamples()==vc.getNSamples() check short-circuits and the
        # record is written with its ORIGINAL INFO (no AC/AF/AN recompute,
        # MLE kept) — reproduce that bug-for-bug
        if args.concordance is not None and not self.no_samples_specified:
            result, subsetted = v, False
        else:
            result, subsetted = self._subset(v)
        if not subsetted:
            # keep a private copy ordered by selected samples for encoding
            result = vcf.Variant(
                contig=v.contig, pos=v.pos, ref=v.ref, alts=v.alts, id=v.id,
                qual=v.qual, filters=v.filters, info=dict(v.info),
                fmt_keys=v.fmt_keys,
                samples=[dict(self._sample(v, name))
                         for name in self.samples])
        if args.set_filtered_gt_to_nocall:
            self._set_filtered_to_nocall(result)
            # setFilteredGenotypeToNocall recalculates chromosome counts
            # with removeStaleValues=true (keys dropped when AN becomes 0)
            local = {name: i for i, name in enumerate(self.samples)}
            calculate_chromosome_counts(result, self.samples, local,
                                        remove_stale=True)
        if args.exclude_non_variants:
            if not self._is_polymorphic_in_samples(result) or \
                    self._spanning_deletion_only(result):
                return
        if not args.apply_jexl_filters_first and \
                not self._passes_jexl(result):
            return
        self._drop_annotations(result)
        local_of = {name: i for i, name in enumerate(self.samples)}
        line = encode_record(result, self.samples, local_of)
        self._seq += 1
        heapq.heappush(self.pending, (result.pos, self._seq, line))

    def _emit(self, line):
        self.writer.write_line(line)
        self.n += 1

    def on_traversal_success(self):
        while self.pending:
            self._emit(heapq.heappop(self.pending)[2])

    def close_tool(self):
        self.writer.close()
        print(f"selected {self.n} variants")
