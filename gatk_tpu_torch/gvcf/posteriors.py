# Copied verbatim from gatk_tpu/gvcf/posteriors.py; only import lines may differ.
"""CalculateGenotypePosteriors: population + family (trio) genotype refinement.

Reference behavior: tools/walkers/variantutils/PosteriorProbabilitiesUtils.java
(Dirichlet-multinomial genotype priors from resource allele counts :154-303,
posterior = normalized PL + prior :225-260), FamilyLikelihoods.java (3x3x3 trio
configuration likelihoods with de-novo mutation prior, marginalized per-member
posteriors, JL/JP annotations), CalculateGenotypePosteriors.java:327-357 (family
priors first on biallelic sites, then population priors; chromosome counts
recalculated).
"""
from __future__ import annotations

import math

import numpy as np
from scipy.special import gammaln

from ..calling import genotyper
from ..io.vcf import Variant
from .annotations import format_vcf_double

LOG10 = math.log(10.0)
HOM_REF, HET, HOM_VAR = 0, 1, 2
LOG10_ONE_THIRD = -0.4771213


def _log10_gamma(x):
    return gammaln(x) / LOG10


def dirichlet_multinomial_log10(params: np.ndarray, counts: np.ndarray) -> float:
    """MathUtils.dirichletMultinomial (log10 space)."""
    dirichlet_sum = params.sum()
    count_sum = counts.sum()
    return float(_log10_gamma(count_sum + 1) + _log10_gamma(dirichlet_sum)
                 - _log10_gamma(dirichlet_sum + count_sum)
                 + sum(_log10_gamma(c + p) - _log10_gamma(p) - _log10_gamma(c + 1)
                       for c, p in zip(counts, params)))


def get_dirichlet_prior(known_counts: np.ndarray, flat: bool) -> np.ndarray:
    """log10 genotype priors over canonical diploid genotype order."""
    n = len(known_counts)
    gts = genotyper.genotype_allele_counts(2, n)
    priors = np.empty(len(gts))
    for i, (a1, a2) in enumerate(gts):
        if flat:
            priors[i] = 1.0
        else:
            counts = np.zeros(n, int)
            counts[a1] += 1
            counts[a2] += 1
            priors[i] = dirichlet_multinomial_log10(known_counts, counts)
    return priors


def _normalize_log10(x: np.ndarray) -> np.ndarray:
    m = x.max()
    lin = 10.0 ** (x - m)
    return x - (m + math.log10(lin.sum()))


def _as_pls(log10_likelihoods: np.ndarray) -> list:
    """GenotypeLikelihoods.fromLog10Likelihoods(x).getAsPLs() (Java half-up rounding)."""
    adj = log10_likelihoods - log10_likelihoods.max()
    return [int(math.floor(-10.0 * v + 0.5)) for v in adj]


def _pls_of(sample: dict):
    pl = sample.get("PL")
    if not pl or pl == ".":
        return None
    return [int(float(x)) for x in pl.split(",")]


def _has_real_likelihoods(sample: dict):
    pls = _pls_of(sample)
    if pls is None:
        return False
    dp = sample.get("DP", ".")
    if dp not in (".", None) and int(dp) == 0:
        return max(pls) > 0
    return True


def _likelihood_vector(sample: dict):
    """PP attribute if present, else PL, as log10 likelihoods (prob space)."""
    pp = sample.get("PP")
    if pp and pp != "." and not pp.startswith("."):
        return np.array([float(x) / -10.0 for x in pp.split(",")])
    if _has_real_likelihoods(sample):
        return np.array(_pls_of(sample), float) / -10.0
    return None


def _gt_tuple(sample: dict):
    gt = sample.get("GT", ".").replace("|", "/")
    if "." in gt:
        return None
    return tuple(sorted(int(x) for x in gt.split("/")))


def make_genotype_call(posteriors_log10: np.ndarray):
    """(gt_tuple|None, gq) via USE_PLS_TO_ASSIGN (ties -> no-call)."""
    pls = np.array(_as_pls(posteriors_log10))
    best = int(np.argmin(pls))
    if int((pls == pls[best]).sum()) > 1:
        return None, None
    gts = genotyper.genotype_allele_counts(2, _n_alleles_from_gl(len(pls)))
    srt = np.sort(pls)
    gq = int(min(srt[1] - srt[0], 99))
    return gts[best], gq


def _n_alleles_from_gl(n_gl: int) -> int:
    n = int((math.isqrt(8 * n_gl + 1) - 1) // 2)
    return n


# ---------------------------------------------------------------------------
# population priors (PosteriorProbabilitiesUtils.calculatePosteriorProbs)
# ---------------------------------------------------------------------------

def _allele_counts_from_record(v: Variant, use_mleac=True):
    """{allele_string: count} per addAlleleCounts (AC/MLEAC based, ref from AN)."""
    alts = list(v.alts)
    if use_mleac and "MLEAC" in v.info:
        ac = [int(float(x)) for x in str(v.info["MLEAC"]).split(",")]
    elif "AC" in v.info:
        ac = [int(float(x)) for x in str(v.info["AC"]).split(",")]
    else:
        # direct evaluation from genotypes
        ac = [0] * len(alts)
        for s in v.samples:
            gt = _gt_tuple(s)
            if gt:
                for a in gt:
                    if a >= 1:
                        ac[a - 1] += 1
    if "AN" in v.info:
        an = int(v.info["AN"])
    else:
        an = sum(len(_gt_tuple(s) or ()) for s in v.samples)
    out = {}
    out[v.ref] = max(an - sum(ac), 0)
    for alt, c in zip(alts, ac):
        out[alt] = out.get(alt, 0) + c
    return out


def calculate_population_posteriors(v: Variant, resources, num_ref_if_missing=0,
                                    snp_prior=1e-3, indel_prior=1e-3,
                                    use_input_samples=True, use_mleac=True,
                                    ignore_input_for_missing=False,
                                    flat_indels=False):
    """Returns an updated Variant with PP FORMAT, PG INFO, re-called GTs, and
    recomputed AC/AF/AN."""
    n_alleles = 1 + len(v.alts)
    use_discovered_for_missing = (not ignore_input_for_missing) and (
        len(v.samples) >= 10 or num_ref_if_missing != 0)

    total = {}
    for r in resources:
        if r.pos == v.pos:
            for a, c in _allele_counts_from_record(r, use_mleac).items():
                total[a] = total.get(a, 0) + c
    if (use_input_samples and resources) or (not resources and use_discovered_for_missing):
        for a, c in _allele_counts_from_record(v, use_mleac).items():
            total[a] = total.get(a, 0) + c
    ref_missing = 2 * num_ref_if_missing if not resources else 0
    total[v.ref] = total.get(v.ref, 0) + ref_missing

    alleles = [v.ref] + list(v.alts)
    resource_only = {a: c for a, c in total.items() if a not in alleles}
    counts = np.empty(n_alleles)
    for i, a in enumerate(alleles):
        if a == "<NON_REF>":
            counts[i] = max(snp_prior, indel_prior) + sum(resource_only.values())
        elif len(a) == len(v.ref) and not a.startswith("<") and a != "*":
            counts[i] = snp_prior + total.get(a, 0)
        else:
            counts[i] = indel_prior + total.get(a, 0)

    use_flat = ((not v.is_snp()) and flat_indels) or (
        not resources and not use_discovered_for_missing and num_ref_if_missing == 0)
    prior = get_dirichlet_prior(counts, use_flat)

    new_samples = []
    any_pp = False
    for s in v.samples:
        s = dict(s)
        gl = _likelihood_vector(s)
        if gl is not None and len(gl) == len(prior):
            post = _normalize_log10(gl + prior)
            gt, gq = make_genotype_call(post)
            if gt is not None:
                s["GT"] = "/".join(str(a) for a in gt)
                s["GQ"] = str(gq)
            else:
                s["GT"] = "/".join(["."] * 2)
            s["PP"] = ",".join(str(x) for x in _as_pls(post))
            any_pp = True
        new_samples.append(s)

    info = dict(v.info)
    is_hom_ref_block = len(v.alts) == 1 and v.alts[0] == "<NON_REF>"
    if not is_hom_ref_block:
        info["PG"] = ",".join(str(x) for x in _as_pls(prior))
        _chromosome_counts(new_samples, n_alleles, info)
    out = Variant(contig=v.contig, pos=v.pos, ref=v.ref, alts=v.alts, id=v.id,
                  qual=v.qual, filters=v.filters, info={k: info[k] for k in sorted(info)},
                  samples=new_samples, fmt_keys=_merge_fmt_keys(v.fmt_keys, new_samples))
    return out


def _chromosome_counts(samples, n_alleles, info):
    ac = [0] * n_alleles
    an = 0
    for s in samples:
        gt = _gt_tuple(s)
        if gt is None:
            continue
        an += len(gt)
        for a in gt:
            ac[a] += 1
    info["AC"] = ",".join(str(ac[i]) for i in range(1, n_alleles))
    info["AF"] = (",".join(format_vcf_double(ac[i] / an) for i in range(1, n_alleles))
                  if an else ".")
    info["AN"] = str(an)


def _merge_fmt_keys(fmt_keys, samples):
    keys = list(fmt_keys)
    for s in samples:
        for k in s:
            if k not in keys:
                keys.append(k)
    # GT first, rest alphabetical (htsjdk genotype field ordering)
    rest = sorted(k for k in keys if k != "GT")
    return tuple(["GT"] + rest)


# ---------------------------------------------------------------------------
# family (trio) priors (FamilyLikelihoods.java)
# ---------------------------------------------------------------------------

def _mv_count(mother, father, child):
    """Number of mendelian violations for genotype-type combo (types 0/1/2 or None)."""
    if child is None:
        return 0
    parents = [p for p in (mother, father) if p is not None]
    if not parents:
        return 0
    n_ref = sum(1 for p in parents if p in (HOM_REF, HET))
    n_alt = sum(1 for p in parents if p in (HET, HOM_VAR))
    if child == HOM_REF:
        return 0 if n_ref == len(parents) else len(parents) - n_ref
    if child == HOM_VAR:
        return 0 if n_alt == len(parents) else len(parents) - n_alt
    if child == HET and ((n_ref > 0 and n_alt > 0) or len(parents) < 2):
        return 0
    return 1


def _type_likelihoods(sample: dict):
    """Normalized log10 likelihoods over (HOM_REF, HET, HOM_VAR); PP preferred."""
    if sample is None or _gt_tuple(sample) is None:
        return np.array([LOG10_ONE_THIRD] * 3), False
    gl = _likelihood_vector(sample)
    if gl is None:
        return np.array([LOG10_ONE_THIRD] * 3), False
    if len(gl) != 3:
        raise ValueError("family priors support only biallelic diploid genotypes")
    return _normalize_log10(gl), True


def apply_family_priors(v: Variant, trios, sample_index, de_novo_prior=1e-6):
    """trios: [(child, father, mother)] sample names. Updates genotypes in place
    (PP/JL/JP + re-called GT) for biallelic sites."""
    if len(v.alts) != 1:
        return v
    samples = [dict(s) for s in v.samples]
    for child_name, father_name, mother_name in trios:
        ci = sample_index.get(child_name)
        fi = sample_index.get(father_name)
        mi = sample_index.get(mother_name)
        if ci is None:
            continue
        child = samples[ci]
        mother = samples[mi] if mi is not None else None
        father = samples[fi] if fi is not None else None

        child_gl, child_called = _type_likelihoods(child)
        mother_gl, mother_called = _type_likelihoods(mother)
        father_gl, father_called = _type_likelihoods(father)
        if not child_called or (not mother_called and not father_called):
            continue

        # 3x3x3 configuration likelihoods with mendelian-violation prior
        config = np.empty((3, 3, 3))
        no_mv_coeff = 1.0 - 10 * de_novo_prior - de_novo_prior ** 2
        for m in range(3):
            for f in range(3):
                for c in range(3):
                    mv = _mv_count(m, f, c)
                    coeff = de_novo_prior ** mv if mv > 0 else no_mv_coeff
                    config[m, f, c] = math.log10(coeff) + mother_gl[m] + father_gl[f] + child_gl[c]

        def marginal(axis):
            lin = 10.0 ** (config - config.max())
            axes = tuple(i for i in range(3) if i != axis)
            marg = np.log10(lin.sum(axis=axes)) + config.max()
            return marg - marg.max()  # scaleLogSpaceArrayForNumericalStability

        post = {"mother": marginal(0), "father": marginal(1), "child": marginal(2)}

        # joint likelihood/posterior of the best configuration
        def norm_lin(x):
            lin = 10.0 ** (x - x.max())
            return lin / lin.sum()

        raw_m = norm_lin(mother_gl)
        raw_f = norm_lin(father_gl)
        raw_c = norm_lin(child_gl)
        pm, pf, pc = (norm_lin(post["mother"]), norm_lin(post["father"]),
                      norm_lin(post["child"]))
        jl = jp = -1
        if child_called and mother_called and father_called:
            joint_l = raw_m[pm.argmax()] * raw_f[pf.argmax()] * raw_c[pc.argmax()]
            joint_p = pm.max() * pf.max() * pc.max()
            jl = _phred_joint(joint_l)
            jp = _phred_joint(joint_p)

        for s, called, key in ((mother, mother_called, "mother"),
                               (father, father_called, "father"),
                               (child, child_called, "child")):
            if s is None or _gt_tuple(s) is None:
                continue
            s["JL"] = str(jl)
            s["JP"] = str(jp)
            gt, gq = make_genotype_call(post[key])
            if gt is not None:
                s["GT"] = "/".join(str(a) for a in gt)
                s["GQ"] = str(gq)
            s["PP"] = ",".join(str(x) for x in _as_pls(post[key]))

    info = dict(v.info)
    _chromosome_counts(samples, 1 + len(v.alts), info)
    out = Variant(contig=v.contig, pos=v.pos, ref=v.ref, alts=v.alts, id=v.id,
                  qual=v.qual, filters=v.filters, info={k: info[k] for k in sorted(info)},
                  samples=samples, fmt_keys=_merge_fmt_keys(v.fmt_keys, samples))
    return out


def _phred_joint(p_joint):
    """QualityUtils.phredScaleLog10ErrorRate(log10(1 - p)) as byte-truncated int."""
    err = max(1.0 - p_joint, 1e-300)
    d = -10.0 * math.log10(err)
    return int(d) if d < 127 else 127


def read_pedigree(path: str):
    """[(child, father, mother)] trios from a .ped file."""
    trios = []
    with open(path) as fh:
        for ln in fh:
            f = ln.split()
            if len(f) < 4 or ln.startswith("#"):
                continue
            fam, child, father, mother = f[0], f[1], f[2], f[3]
            if father != "0" and mother != "0":
                trios.append((child, father, mother))
    return trios
