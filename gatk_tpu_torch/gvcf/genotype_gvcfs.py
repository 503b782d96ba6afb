# Copied verbatim from gatk_tpu/gvcf/genotype_gvcfs.py; only import lines may differ.
"""GenotypeGVCFs: re-genotype (combined) GVCF records with the exact AF model.

Reference behavior: tools/walkers/GenotypeGVCFs.java + GenotypeGVCFsEngine.java
(:124-236 calculateGenotypes -> subset alleles -> annotate), AlleleSubsettingUtils.
"""
from __future__ import annotations

import math

import numpy as np

from ..calling import genotyper
from ..io.vcf import Variant
from .annotations import (
    excess_het_phred,
    inbreeding_coefficient,
    fisher_strand_phred,
    format_vcf_double,
    strand_odds_ratio,
)

NON_REF = "<NON_REF>"
STANDARD_CONFIDENCE = 30.0

# carried INFO keys reformatted as doubles (htsjdk formatting), or ints
_DOUBLE_INFO = ("BaseQRankSum", "MQRankSum", "ReadPosRankSum", "MQ", "ClippingRankSum")
_INT_INFO = ("MQ0",)


def _pl_index_map(old_alleles, new_alleles, ploidy=2):
    """Map canonical genotype indices over new_alleles to indices over old_alleles."""
    old_index = {a: i for i, a in enumerate(old_alleles)}
    new_gts = genotyper.genotype_allele_counts(ploidy, len(new_alleles))
    old_gts = genotyper.genotype_allele_counts(ploidy, len(old_alleles))
    old_gt_index = {g: i for i, g in enumerate(old_gts)}
    out = []
    for g in new_gts:
        old_g = tuple(sorted(old_index[new_alleles[a]] for a in g))
        out.append(old_gt_index[old_g])
    return out


def homref_site_record(v, sample_order):
    """--include-non-variant-sites output for a hom-ref (<NON_REF>-only)
    record (GenotypeGVCFsEngine.cleanupGenotypeAnnotations createRefGTs=true):
    ALT '.', INFO DP, per-sample GT/AD(ref)/DP with GQ moved to RGQ; GQ==0
    keeps the fields but no-calls the GT; 0-depth samples drop GQ/DP."""
    out_samples = []
    info_dp = 0
    saw_ad = False
    for i in sample_order:
        s = v.samples[i]
        dp = s.get("DP", ".")
        min_dp = s.get("MIN_DP")
        if min_dp not in (None, "."):
            dp = min_dp
        gq = s.get("GQ")
        ploidy = max(1, len(s.get("GT", "./.").replace("|", "/").split("/")))
        depth = int(dp) if dp not in (".", None) else 0
        if depth > 0 and gq not in (None, "."):
            gt = "/".join(["0"] * ploidy) if int(gq) > 0 else \
                "/".join(["."] * ploidy)
            row = {"GT": gt, "DP": str(depth), "RGQ": str(int(gq))}
            ad = s.get("AD")
            if ad not in (None, "."):
                row["AD"] = ad.split(",")[0]  # subset to the ref allele
                saw_ad = True
            info_dp += depth
        else:
            row = {"GT": "/".join(["."] * ploidy)}
        out_samples.append(row)
    fmt = ("GT", "AD", "DP", "RGQ") if saw_ad else ("GT", "DP", "RGQ")
    return Variant(contig=v.contig, pos=v.pos, ref=v.ref, alts=(),
                   qual=None, filters=(), info={"DP": str(info_dp)},
                   fmt_keys=fmt, samples=out_samples)


def spanning_deletion_records(called_del, ref_fetch=None):
    """--include-non-variant-sites '*' rows for positions inside a called
    biallelic deletion (GenotypingEngine.java:222-241 + the
    AlleleFrequencyCalculator:213-222 span-del QUAL capping): each covered
    position gets alleles [base, '*'], QUAL = -10 * min(0, log10 sum of ALL
    genotype posteriors) — i.e. +/-0.0 whose sign drives QD's '0.00' vs
    '-0.00' — FILTER LowQual, and the deletion's genotype columns verbatim."""
    R = called_del
    if len(R.ref) <= 1:
        return []
    # the '*' stands for the longest deletion allele; other alleles are
    # dropped by the biallelic subset (AlleleSubsettingUtils pattern)
    dels = [(len(R.ref) - len(a), i) for i, a in enumerate(R.alts)
            if len(a) < len(R.ref) and not a.startswith("<")]
    if not dels:
        return []
    _, del_i = max(dels)
    full_alleles = [R.ref] + list(R.alts)
    idx_map = _pl_index_map(full_alleles, [R.ref, R.alts[del_i]], 2)
    gls = []
    sub_samples = []
    for s in R.samples:
        pl = s.get("PL", ".")
        if pl in (".", None):
            return []
        full = np.array([float(x) for x in pl.split(",")])
        pl3 = full[idx_map]
        pl3 = pl3 - pl3.min()
        gls.append(-pl3 / 10.0)
        best = int(np.argmin(pl3))
        srt = np.sort(pl3)
        gq = int(min(srt[1] - srt[0], 99))
        gt = ["0/0", "0/1", "1/1"][best]
        ad = s.get("AD", ".")
        if ad not in (".", None):
            adv = ad.split(",")
            ad = f"{adv[0]},{adv[del_i + 1]}"
        sub = {"GT": gt, "AD": ad, "DP": s.get("DP", "."), "GQ": str(gq),
               "PL": ",".join(str(int(x)) for x in pl3)}
        sub_samples.append(sub)
    R = Variant(contig=R.contig, pos=R.pos, ref=R.ref,
                alts=(R.alts[del_i],), qual=R.qual, filters=R.filters,
                info=dict(R.info), samples=sub_samples,
                fmt_keys=("GT", "AD", "DP", "GQ", "PL"))
    af_calc = genotyper.AlleleFrequencyCalculator()
    af = af_calc.calculate([1, 1], 1, gls, 2, span_del_index=1)
    qual = -10.0 * af.log10_p_no_variant  # keeps IEEE -0.0 when capped
    ac = an = het = hom_var = called = 0
    qd_depth = 0
    for s in R.samples:
        gt = s.get("GT", ".").replace("|", "/")
        if gt.startswith("."):
            continue
        alleles_gt = gt.split("/")
        an += len(alleles_gt)
        n_alt = sum(a != "0" for a in alleles_gt)
        ac += n_alt
        called += 1
        if 0 < n_alt < len(alleles_gt):
            het += 1
        elif n_alt == len(alleles_gt):
            hom_var += 1
        if n_alt and s.get("AD", ".") not in (".", None):
            qd_depth += sum(int(x) for x in s["AD"].split(","))
    info = {
        "AC": str(ac),
        "AF": format_vcf_double(ac / an) if an else ".",
        "AN": str(an),
        "DP": R.info.get("DP", "."),
        "ExcessHet": f"{excess_het_phred(het, hom_var, called):.4f}",
        "MLEAC": str(int(af.allele_counts_mle[0])),
        "MLEAF": format_vcf_double(af.allele_counts_mle[0] / an) if an else ".",
    }
    if "FS" in R.info:
        info["FS"] = R.info["FS"]
    if "SOR" in R.info:
        info["SOR"] = R.info["SOR"]
    info["QD"] = f"{(qual / qd_depth if qd_depth else qual):.2f}"
    info = {k: info[k] for k in sorted(info)}
    out = []
    for k in range(1, len(R.ref)):
        out.append(Variant(
            contig=R.contig, pos=R.pos + k, ref=R.ref[k], alts=("*",),
            qual=0.0 if qual == 0 else float(f"{qual:.2f}"),
            filters=("LowQual",), info=dict(info),
            fmt_keys=("GT", "AD", "DP", "GQ", "PL"),
            samples=[dict(s) for s in R.samples]))
    return out


def regenotype_records_at_site(records, samples, af_calc=None, ploidy=2,
                               standard_confidence=STANDARD_CONFIDENCE,
                               include_non_variants=False,
                               keep_combined_raw=False):
    """records: per-sample (variant, sample_dict) at one site with identical
    ref/alts (pre-merged); returns a re-genotyped Variant or None.

    For the single-sample GenotypeGVCFs path each record is one line of the GVCF.
    """
    v0 = records[0][0]
    alleles = [v0.ref] + [a for a in v0.alts if a != NON_REF and a != "*"]
    if len(alleles) < 2:
        return None
    # positional indices of the working alleles within v0's full allele list
    # (AS raw INFO sections are laid out in v0 allele order)
    as_allele_idx = [0] + [i + 1 for i, a in enumerate(v0.alts)
                           if a != NON_REF and a != "*"]
    af_calc = af_calc or genotyper.AlleleFrequencyCalculator(ploidy=ploidy)

    # infer ploidy from the first parseable GT (haploid GVCFs have GT "0"/"1")
    for _v, s in records:
        gt = s.get("GT", ".")
        if gt not in (".", "./.", ".|."):
            n_gt_alleles = len(gt.replace("|", "/").split("/"))
            if n_gt_alleles >= 1:
                ploidy = n_gt_alleles
                break

    idx_map = _pl_index_map(list(v0.alleles), alleles, ploidy)
    n_gt = len(idx_map)

    sample_gls = []
    sample_pls = []
    for _v, s in records:
        pl_str = s.get("PL", ".")
        if pl_str in (".", None):
            pl = np.zeros(n_gt)
        else:
            full = np.array([float(x) for x in pl_str.split(",")])
            pl = full[idx_map]
        sample_pls.append(pl)
        sample_gls.append(-pl / 10.0)

    allele_lengths = [len(a) for a in alleles]
    af = af_calc.calculate(allele_lengths, len(v0.ref), sample_gls, ploidy)
    phred_no_variant = -10.0 * af.log10_p_no_variant

    if phred_no_variant < standard_confidence and not include_non_variants:
        return None

    # per-sample genotype assignment from subset PLs
    gts = genotyper.genotype_allele_counts(ploidy, len(alleles))
    out_samples = []
    ac = np.zeros(len(alleles), int)
    an = 0
    het_count = 0
    hom_var_count = 0
    called = 0
    depth_for_qd = 0
    info_dp = 0
    sb_sum = np.zeros(4, int)
    saw_sb = False
    seen_vc = set()
    for (v, s), pl in zip(records, sample_pls):
        pl = pl - pl.min()
        best = int(np.argmin(pl))
        # ambiguous best PL (GQ would be 0) -> no-call (makeGenotypeCall)
        no_call = int((pl == pl[best]).sum()) > 1
        gt_tuple = gts[best]
        pl_sorted = np.sort(pl)
        gq = int(min(pl_sorted[1] - pl_sorted[0], 99))
        # cleanupGenotypeAnnotations: MIN_DP replaces DP
        dp = s.get("DP", ".")
        min_dp = s.get("MIN_DP")
        if min_dp not in (None, "."):
            dp = min_dp
        ad = s.get("AD", ".")
        if ad not in (".", None):
            ad_vals = [int(x) for x in ad.split(",")]
            keep_idx = [list(v.alleles).index(a) for a in alleles]
            ad_vals = [ad_vals[i] if i < len(ad_vals) else 0 for i in keep_idx]
            ad_str = ",".join(str(x) for x in ad_vals)
        elif dp not in (".", None) and int(dp) > 0:
            # propagate DP to AD (cleanupGenotypeAnnotations:474-478)
            ad_str = ",".join([str(dp)] + ["0"] * (len(alleles) - 1))
        else:
            ad_str = "."
        if not no_call:
            for a in gt_tuple:
                ac[a] += 1
            an += ploidy
            called += 1
            if len(set(gt_tuple)) > 1:
                het_count += 1
            elif gt_tuple[0] != 0:
                hom_var_count += 1
        # site-level INFO DP: input INFO DP counted once per input record
        if id(v) not in seen_vc:
            seen_vc.add(id(v))
            if "DP" in v.info:
                info_dp += int(v.info["DP"])
            elif dp not in (".", None):
                info_dp += int(dp)
        sb = s.get("SB")
        if sb and sb != ".":
            sb_sum += np.array([int(x) for x in sb.split(",")])
            saw_sb = True
        out_samples.append({
            "GT": "/".join("." if no_call else str(a) for a in gt_tuple),
            "AD": ad_str,
            "DP": dp,
            "GQ": str(gq),
            "PL": ",".join(str(int(x)) for x in pl),
        })

    if ac[1:].sum() == 0:
        if not include_non_variants:
            return None
        # variant input turned monomorphic under force-output (--all-sites):
        # GenotypeGVCFsEngine.regenotypeVC else-branch + cleanupGenotype-
        # Annotations(createRefGTs=true): ALT '.', QUAL = phred P(variant),
        # carried annotations minus the site-frequency ones, GT:DP:RGQ
        import math as _math

        log10_p_nv = af.log10_p_no_variant
        try:
            p_variant_log10 = _math.log10(-_math.expm1(
                log10_p_nv * _math.log(10.0)))
        except ValueError:
            p_variant_log10 = -0.0
        qual_mono = float(f"{-10.0 * p_variant_log10:.2f}")
        info_m = {}
        for key in _DOUBLE_INFO:
            vals = [float(v.info[key]) for v, _s in records if key in v.info]
            if vals:
                info_m[key] = format_vcf_double(float(np.median(vals)))
        for key in _INT_INFO:
            vals = [int(v.info[key]) for v, _s in records if key in v.info]
            if vals:
                info_m[key] = str(sum(vals))
        info_m["DP"] = str(info_dp)
        info_m["MLEAC"] = "."
        info_m["MLEAF"] = "."
        info_m = {k: info_m[k] for k in sorted(info_m)}
        mono_samples = []
        for s_out in out_samples:
            gq = int(s_out.get("GQ", "0"))
            gt = "/".join(["0"] * ploidy) if gq > 0 else \
                "/".join(["."] * ploidy)
            mono_samples.append({"GT": gt, "DP": s_out.get("DP", "."),
                                 "RGQ": str(gq)})
        return Variant(contig=v0.contig, pos=v0.pos, ref=v0.ref, alts=(),
                       qual=qual_mono, filters=(), info=info_m,
                       fmt_keys=("GT", "DP", "RGQ"), samples=mono_samples)

    # drop alt alleles with AC=0 (removeUnusedAlternates); re-subset GT/AD/PL
    if (ac[1:] == 0).any():
        keep = [0] + [i for i in range(1, len(alleles)) if ac[i] > 0]
        old_to_new = {o: n for n, o in enumerate(keep)}
        kept_alleles = [alleles[i] for i in keep]
        sub_map = _pl_index_map(alleles, kept_alleles, ploidy)
        sub_gts = genotyper.genotype_allele_counts(ploidy, len(kept_alleles))
        for s_out, pl in zip(out_samples, sample_pls):
            pl0 = pl - pl.min()
            sub_pl = pl0[sub_map]
            s_out["PL"] = ",".join(str(int(x)) for x in sub_pl)
            if "." not in s_out["GT"]:
                gt_old = tuple(int(x) for x in s_out["GT"].split("/"))
                s_out["GT"] = "/".join(str(old_to_new[a]) for a in gt_old)
            if s_out["AD"] != ".":
                ad_vals = s_out["AD"].split(",")
                s_out["AD"] = ",".join(ad_vals[i] for i in keep)
        ac = ac[keep]
        mle_keep = [i - 1 for i in keep[1:]]
        af.allele_counts_mle = af.allele_counts_mle[mle_keep]
        if getattr(af, "log10_p_ref_by_allele", None) is not None:
            af.log10_p_ref_by_allele = af.log10_p_ref_by_allele[mle_keep]
        as_allele_idx = [as_allele_idx[i] for i in keep]
        alleles = kept_alleles

    # QualByDepth denominator: sum of final (subset) ADs of variant genotypes
    for s_out in out_samples:
        if "." in s_out["GT"]:
            continue
        gt_tuple = tuple(int(x) for x in s_out["GT"].split("/"))
        if any(a != 0 for a in gt_tuple):
            if s_out["AD"] != ".":
                depth_for_qd += sum(int(x) for x in s_out["AD"].split(","))
            elif s_out["DP"] not in (".", None):
                depth_for_qd += int(s_out["DP"])

    # trim common suffix (keeping >=1 base), then common prefix, adjusting pos
    pos = v0.pos
    ref = alleles[0]
    alts_f = list(alleles[1:])
    if alts_f:
        while (len(ref) > 1 and all(len(a) > 1 for a in alts_f)
               and all(a[-1] == ref[-1] for a in alts_f)):
            ref = ref[:-1]
            alts_f = [a[:-1] for a in alts_f]
        while (len(ref) > 1 and all(len(a) > 1 for a in alts_f)
               and all(a[0] == ref[0] for a in alts_f)):
            ref = ref[1:]
            alts_f = [a[1:] for a in alts_f]
            pos += 1
    alleles = [ref] + alts_f

    qual = float(f"{phred_no_variant:.2f}")
    info = {}
    info["AC"] = ",".join(str(int(c)) for c in ac[1:])
    info["AF"] = ",".join(format_vcf_double(c / an) for c in ac[1:]) if an else "."
    info["AN"] = str(an)
    # carried-over annotations (median across samples; reformatted)
    for key in _DOUBLE_INFO:
        vals = [float(v.info[key]) for v, _s in records if key in v.info]
        if vals:
            info[key] = format_vcf_double(float(np.median(vals)))
    info["DP"] = str(info_dp)
    if ploidy == 2:
        info["ExcessHet"] = f"{excess_het_phred(het_count, hom_var_count, called):.4f}"
    if saw_sb:
        info["FS"] = f"{fisher_strand_phred(*sb_sum):.3f}"
        info["SOR"] = f"{strand_odds_ratio(*sb_sum):.3f}"
    if ploidy == 2 and len(alleles) == 2 and called >= 10:
        biallelic_pls = []
        for s_out in out_samples:
            if "." in s_out["GT"] and s_out["GT"] != "./.":
                continue
            try:
                biallelic_pls.append([int(x) for x in s_out["PL"].split(",")][:3])
            except ValueError:
                biallelic_pls.append(None)
        ic = inbreeding_coefficient(biallelic_pls)
        if ic is not None:
            info["InbreedingCoeff"] = f"{ic:.4f}"
    info["MLEAC"] = ",".join(str(int(c)) for c in af.allele_counts_mle)
    info["MLEAF"] = ",".join(format_vcf_double(c / an) for c in af.allele_counts_mle) if an else "."
    for key in _INT_INFO:
        vals = [int(v.info[key]) for v, _s in records if key in v.info]
        if vals:
            info[key] = str(sum(vals))
    # allele-specific finalize: raw AS_ INFO (from HC-GVCF / CombineGVCFs) ->
    # AS_FS/AS_SOR/AS_MQ/AS_QD/AS_*RankSum (ReducibleAnnotation.finalizeRawData)
    as_raw_srcs = []
    seen_as = set()
    for v, _s in records:
        if id(v) in seen_as:
            continue
        seen_as.add(id(v))
        if any(k in v.info for k in ("AS_SB_TABLE", "AS_RAW_MQ")):
            as_raw_srcs.append(v.info)
    if as_raw_srcs:
        from ..calling import as_annotations as asmod

        n_full = len(list(v0.alleles))
        # combine raws across distinct source records (same allele layout),
        # then subset sections positionally to the final allele set
        combined = asmod.combine_raw_fields(
            as_raw_srcs, [list(v0.alleles)] * len(as_raw_srcs), list(v0.alleles))
        sub = {}
        sel = as_allele_idx
        for key in asmod.RAW_RANKSUM_KEYS:
            if key in combined:
                h = asmod.parse_histogram_sections(combined[key], n_full)
                sub[key] = asmod.format_histogram_sections(
                    [h[i] for i in sel], combined=True)
        if "AS_RAW_MQ" in combined:
            vals = asmod.parse_raw_mq(combined["AS_RAW_MQ"], n_full)
            sub["AS_RAW_MQ"] = asmod.format_raw_mq([vals[i] for i in sel])
        if "AS_SB_TABLE" in combined:
            rows = asmod.parse_sb_table(combined["AS_SB_TABLE"], n_full)
            sub["AS_SB_TABLE"] = asmod.format_sb_table([rows[i] for i in sel])
        # per-final-allele AD sums (AS_MQ denominator: the allele's own depth)
        n_final = len(alleles)
        ad_sums = [0] * n_final
        # AS_QD denominator: per AS_QualByDepth.java:201,240-250 — qualifying
        # samples (variant AD depth > 1) contribute AD[i] + AD[0]
        qd_depth = [0] * n_final
        for s_out in out_samples:
            if s_out.get("AD", ".") in (".", None):
                continue
            advals = [int(x) for x in s_out["AD"].split(",")]
            advals = advals[:n_final] + [0] * max(0, n_final - len(advals))
            for i in range(n_final):
                ad_sums[i] += advals[i]
            if sum(advals) - advals[0] > 1:
                for i in range(n_final):
                    qd_depth[i] += advals[i] + (advals[0] if i > 0 else 0)
        per_allele_qual = None
        if getattr(af, "log10_p_ref_by_allele", None) is not None:
            per_allele_qual = [int(round(max(0.0, -10.0 * q)))
                               for q in af.log10_p_ref_by_allele]
        fin = asmod.finalize_all(sub, alleles, ad_sums, per_allele_qual=None)
        if keep_combined_raw:
            # -keep-combined: retain the subset raw annotations + AS_QUAL
            # (GenotypeGVCFs --keep-combined-raw-annotations)
            fin.update(sub)
            if per_allele_qual is not None:
                fin["AS_QUAL"] = ",".join(str(q) for q in per_allele_qual)
        if per_allele_qual is not None:
            qdv = []
            for ai in range(1, n_final):
                d = qd_depth[ai]
                if d > 0:
                    as_qd = per_allele_qual[ai - 1] / d
                    if as_qd >= 35.0:
                        from ..utils.javarandom import get_random_generator

                        as_qd = 30.0 + get_random_generator().next_gaussian() * 3.0
                    qdv.append(f"{as_qd:.2f}")
                else:
                    qdv.append(".")
            if any(x != "." for x in qdv):
                fin["AS_QD"] = ",".join(qdv)
        info.update(fin)

    if depth_for_qd > 0:
        qd = phred_no_variant / depth_for_qd
        if qd >= 35.0:
            # QualByDepth.fixTooHighQD: 30 + seeded-jdk-random gaussian * 3
            from ..utils.javarandom import get_random_generator

            qd = 30.0 + get_random_generator().next_gaussian() * 3.0
        info["QD"] = f"{qd:.2f}"

    info = {k: info[k] for k in sorted(info.keys())}
    return Variant(
        contig=v0.contig, pos=pos, ref=alleles[0], alts=tuple(alleles[1:]),
        qual=qual, filters=(), info=info,
        fmt_keys=("GT", "AD", "DP", "GQ", "PL"), samples=out_samples,
    )
