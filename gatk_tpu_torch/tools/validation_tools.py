# Copied verbatim from gatk_tpu/tools/validation_tools.py; only import lines may differ.
"""Somatic validation tools.

Reference behavior:
  * tools/walkers/validation/basicshortmutpileup/ValidateBasicSomaticShortMutations.java
    (+ PowerCalculationUtils.java, BasicSomaticShortMutationValidator.java,
    BetaBinomialDistribution.java): pileup-based orthogonal validation of a
    somatic callset against an independent tumor/normal pair.
  * tools/walkers/validation/MergeMutect2CallsWithMC3.java: merge M2 (eval)
    calls with an MC3-style truth VCF into one annotated callset.
"""
from __future__ import annotations

import argparse
import math

import numpy as np

from ..cli import register_tool
from ..io import vcf

MIN_BQ_CUTOFF = 20
P_VALUE_FOR_NOISE = 0.99
MINIMUM_NUM_READS_FOR_SIGNAL_COUNT = 2


def _log_beta(a, b):
    return math.lgamma(a) + math.lgamma(b) - math.lgamma(a + b)


def beta_binomial_cdf(k, alpha, beta, n):
    """P(X <= k) for X ~ BetaBinomial(alpha, beta, n)
    (basicshortmutpileup/BetaBinomialDistribution.java)."""
    if k < 0:
        return 0.0
    total = 0.0
    for x in range(0, min(k, n) + 1):
        lp = (math.lgamma(n + 1) - math.lgamma(x + 1) - math.lgamma(n - x + 1)
              + _log_beta(x + alpha, n - x + beta) - _log_beta(alpha, beta))
        total += math.exp(lp)
    return min(total, 1.0)


def binomial_inverse_cdf(n, p, target):
    """Smallest k with P(X <= k) >= target for X ~ Binomial(n, p)."""
    if n == 0:
        return 0
    cdf = 0.0
    logq = n * math.log1p(-p) if p < 1 else -math.inf
    pmf = math.exp(logq) if logq > -700 else 0.0
    for k in range(n + 1):
        if k > 0:
            pmf = pmf * (n - k + 1) / k * (p / (1 - p)) if p < 1 else 0.0
        cdf += pmf
        if cdf >= target:
            return k
    return n


def calculate_min_count_for_signal(validation_total, max_noise_ratio):
    """PowerCalculationUtils.calculateMinCountForSignal."""
    k = binomial_inverse_cdf(validation_total, max_noise_ratio, P_VALUE_FOR_NOISE)
    return max(k, MINIMUM_NUM_READS_FOR_SIGNAL_COUNT)


def calculate_power(validation_total, disc_alt, disc_total, min_count):
    """PowerCalculationUtils.calculatePower: beta-binomial with alpha=alt+1,
    beta=ref+1 over the validation depth."""
    return 1.0 - beta_binomial_cdf(min_count - 1, disc_alt + 1,
                                   disc_total - disc_alt + 1, validation_total)


def _pileup_counts(reads, variant, min_bq):
    """(ref_count, alt_count, max_alt_ratio) at the variant site from reads
    (AllelePileupCounter + PowerCalculationUtils.calculateMaxAltRatio)."""
    from ..calling.annotations import read_offset_at

    ref_n = alt_n = other_n = 0
    v = variant
    is_indel = any(len(a) != len(v.ref) for a in v.alts)
    for r in reads:
        off = read_offset_at(r, v.pos)
        if off is None:
            continue
        if int(r.quals[off]) < min_bq:
            continue
        if is_indel:
            from ..calling.annotations import _has_indel_near
            if _has_indel_near(r, v.pos):
                alt_n += 1
            else:
                ref_n += 1
            continue
        alt = v.alts[0]
        seg = bytes(r.bases[off : off + len(alt)]).upper().decode()
        refseg = bytes(r.bases[off : off + len(v.ref)]).upper().decode()
        if seg == alt.upper():
            alt_n += 1
        elif refseg == v.ref.upper():
            ref_n += 1
        else:
            other_n += 1
    total = ref_n + alt_n + other_n
    max_ratio = (alt_n + other_n) / total if total else 0.0
    return ref_n, alt_n, max_ratio


@register_tool("ValidateBasicSomaticShortMutations")
def validate_basic_somatic_short_mutations(argv):
    """Pileup validation of somatic calls vs an orthogonal tumor/normal pair
    (basicshortmutpileup/ValidateBasicSomaticShortMutations.java)."""
    p = argparse.ArgumentParser(description="ValidateBasicSomaticShortMutations")
    p.add_argument("-V", "--variant", required=True)
    p.add_argument("-I", "--input", action="append", required=True)
    p.add_argument("-R", "--reference", default=None)
    p.add_argument("-O", "--output", required=True, help="validation table (tsv)")
    p.add_argument("--discovery-sample-name", required=True)
    p.add_argument("--val-case-sample-name", required=True)
    p.add_argument("--val-control-sample-name", required=True)
    p.add_argument("--annotated-vcf", default=None)
    p.add_argument("--summary", default=None)
    p.add_argument("--min-power", type=float, default=0.9)
    p.add_argument("--max-validation-normal-count", type=int, default=1)
    p.add_argument("--min-base-quality-cutoff", type=int, default=MIN_BQ_CUTOFF)
    args = p.parse_args(argv)

    from ..io import fasta
    from ..io.cram import open_reads

    ref = fasta.FastaReference(args.reference) if args.reference else None
    readers = [open_reads(path, reference=ref) for path in args.input]
    # sample per read group (splitBySample)
    rg_sample = {}
    for rd in readers:
        for rg in rd.header.read_groups:
            rg_sample[rg.get("ID", "")] = rg.get("SM", "__UNKNOWN__")

    reader = vcf.VcfReader(args.variant)
    try:
        sample_idx = reader.samples.index(args.discovery_sample_name)
    except ValueError:
        sample_idx = 0
    aw = None
    if args.annotated_vcf:
        headers = list(reader.header_lines) + [
            '##INFO=<ID=VAL_JUDGMENT,Number=1,Type=String,Description="Validation judgment">',
            '##INFO=<ID=VAL_POWER,Number=1,Type=Float,Description="Validation power">',
            '##INFO=<ID=VAL_AD,Number=2,Type=Integer,Description="Validation allele depths">']
        aw = vcf.VcfWriter(args.annotated_vcf, reader.samples, extra_header_lines=headers)
    rows = []
    snp_tp = snp_fp = indel_tp = indel_fp = 0
    for v in reader:
        g = v.samples[sample_idx] if v.samples else {}
        ad = g.get("AD")
        judgment = "SKIPPED"
        power = 0.0
        val_ref = val_alt = 0
        usable = (len(v.alts) == 1 and ad and "," in ad
                  and not v.ref.startswith("<"))
        if usable:
            disc_ref, disc_alt = (int(x) for x in ad.split(",")[:2])
            disc_total = disc_ref + disc_alt
            reads = []
            for rd in readers:
                reads.extend(r for r in rd.query(v.contig, max(0, v.pos - 1), v.end + 1)
                             if not r.is_unmapped and not r.is_duplicate and r.mapq > 0)
            def sample_of(r):
                rg = (getattr(r, "tags", None) or {}).get("RG", "")
                return rg_sample.get(rg, "__UNKNOWN__")
            case_reads = [r for r in reads if sample_of(r) == args.val_case_sample_name]
            ctrl_reads = [r for r in reads if sample_of(r) == args.val_control_sample_name]
            if ctrl_reads and disc_total > 0:
                val_ref, val_alt, _ = _pileup_counts(case_reads, v, args.min_base_quality_cutoff)
                n_ref, n_alt, noise_ratio = _pileup_counts(
                    ctrl_reads, v, args.min_base_quality_cutoff)
                val_total = val_ref + val_alt
                min_count = calculate_min_count_for_signal(val_total, noise_ratio)
                power = calculate_power(val_total, disc_alt, disc_total, min_count)
                normal_artifact = n_alt > args.max_validation_normal_count
                out_of_noise = val_alt >= min_count and val_alt >= 2
                validated = not normal_artifact and out_of_noise
                powered = normal_artifact or power > args.min_power
                judgment = "VALIDATED" if validated else "UNVALIDATED"
                is_snp = v.is_snp()
                if validated:
                    snp_tp, indel_tp = (snp_tp + is_snp, indel_tp + (not is_snp))
                elif powered:
                    snp_fp, indel_fp = (snp_fp + is_snp, indel_fp + (not is_snp))
                rows.append((v.contig, v.pos + 1, v.pos + len(v.ref), v.ref,
                             v.alts[0], disc_alt, disc_ref, val_alt, val_ref,
                             min_count, n_alt, f"{power:.4f}", judgment,
                             ";".join(v.filters) or "PASS"))
        if aw is not None:
            info = dict(v.info)
            info["VAL_JUDGMENT"] = judgment
            info["VAL_POWER"] = f"{power:.3f}"
            info["VAL_AD"] = f"{val_ref},{val_alt}"
            v.info = info
            aw.write(v)
    if aw is not None:
        aw.close()
    with open(args.output, "w") as fh:
        fh.write("CONTIG\tSTART\tEND\tREF\tALT\tDISCOVERY_ALT_COVERAGE\t"
                 "DISCOVERY_REF_COVERAGE\tVALIDATION_ALT_COVERAGE\t"
                 "VALIDATION_REF_COVERAGE\tMIN_VAL_COUNT\tNUM_ALT_READS_IN_VAL_NORMAL\t"
                 "POWER\tJUDGMENT\tFILTERS\n")
        for row in rows:
            fh.write("\t".join(str(x) for x in row) + "\n")
    if args.summary:
        with open(args.summary, "w") as fh:
            fh.write("type\tTP\tFP\tFN\tSENSITIVITY\tPRECISION\n")
            for kind, tp, fp in (("SNP", snp_tp, snp_fp), ("INDEL", indel_tp, indel_fp)):
                prec = tp / (tp + fp) if tp + fp else 0.0
                fh.write(f"{kind}\t{tp}\t{fp}\t0\t1.000\t{prec:.3f}\n")
    print(f"validated {snp_tp + indel_tp} of {len(rows)} assessable calls")
    return 0


@register_tool("MergeMutect2CallsWithMC3")
def merge_mutect2_calls_with_mc3(argv):
    """Merge M2 calls (eval) with MC3 truth into one annotated VCF
    (validation/MergeMutect2CallsWithMC3.java)."""
    p = argparse.ArgumentParser(description="MergeMutect2CallsWithMC3")
    p.add_argument("--evaluation", "-eval", required=True, help="M2 VCF")
    p.add_argument("--truth", required=True, help="MC3 VCF")
    p.add_argument("-O", "--output", required=True)
    args = p.parse_args(argv)

    ev_reader = vcf.VcfReader(args.evaluation)
    tumor = ev_reader.samples[0] if ev_reader.samples else "TUMOR"
    ev = {}
    for v in ev_reader:
        for alt in v.alts:
            ev[(v.contig, v.pos, v.ref, alt)] = v
    tr_reader = vcf.VcfReader(args.truth)
    headers = list(tr_reader.header_lines) + [
        '##INFO=<ID=CENTERS,Number=.,Type=String,Description="Calling centers">',
        '##INFO=<ID=M2_FILTERS,Number=.,Type=String,Description="M2 filters applied to variant.">']
    w = vcf.VcfWriter(args.output, [tumor], extra_header_lines=headers)
    n = 0
    seen = set()
    records = []
    for t in tr_reader:
        key = (t.contig, t.pos, t.ref, t.alts[0] if t.alts else "")
        m2 = ev.get(key)
        info = dict(t.info)
        centers = [c for c in str(info.get("CENTERS", "")).split(",") if c and c != "True"]
        if m2 is not None:
            seen.add(key)
            filters = [f for f in m2.filters if f != "PASS"]
            if not filters:
                centers.append("M2")  # true positive: M2 agrees
            else:
                info["M2_FILTERS"] = ",".join(sorted(filters))
            ad = (m2.samples[0].get("AD") if m2.samples else None)
        else:
            ad = f'{info.get("NREF", 0)},{info.get("NALT", 0)}'
        if centers:
            info["CENTERS"] = ",".join(centers)
        records.append(vcf.Variant(t.contig, t.pos, t.ref, t.alts, id=t.id,
                                   qual=t.qual, filters=t.filters, info=info,
                                   samples=[{"GT": "./.", "AD": ad or "0,0"}],
                                   fmt_keys=("GT", "AD")))
    # M2-unique unfiltered calls enter as M2-only records
    for key, m2 in ev.items():
        if key in seen or (m2.filters and set(m2.filters) - {"PASS"}):
            continue
        info = dict(m2.info)
        info["CENTERS"] = "M2"
        records.append(vcf.Variant(m2.contig, m2.pos, m2.ref, m2.alts, id=m2.id,
                                   qual=m2.qual, filters=(), info=info,
                                   samples=[{"GT": "./.",
                                             "AD": m2.samples[0].get("AD", "0,0")
                                             if m2.samples else "0,0"}],
                                   fmt_keys=("GT", "AD")))
    for v in sorted(records, key=lambda x: (x.contig, x.pos)):
        w.write(v)
        n += 1
    w.close()
    print(f"merged {n} records to {args.output}")
    return 0
