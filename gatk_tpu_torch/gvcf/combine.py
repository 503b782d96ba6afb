# Copied verbatim from gatk_tpu/gvcf/combine.py; only import lines may differ.
"""CombineGVCFs: streaming multi-GVCF merge into a combined GVCF.

Reference behavior: tools/walkers/CombineGVCFs.java +
ReferenceConfidenceVariantContextMerger.java: slice ref blocks at every sample's
record boundaries, merge variant sites with allele-union remapping and hom-ref
PL expansion, rewrite REF anchor bases from the reference sequence.
"""
from __future__ import annotations

import numpy as np

from ..calling import genotyper
from ..io.vcf import Variant
from .annotations import format_vcf_double

NON_REF = "<NON_REF>"

_MEDIAN_INFO = ("BaseQRankSum", "MQRankSum", "ReadPosRankSum", "MQ", "ClippingRankSum")
_SUM_INFO = ("DP", "MQ0")


class _SampleCursor:
    """Walks one sample's GVCF records in order."""

    def __init__(self, variants, sample_dicts):
        self.records = list(zip(variants, sample_dicts))
        self.i = 0

    def current_at(self, pos):
        """Record covering pos, advancing past finished records."""
        while self.i < len(self.records) and self.records[self.i][0].end <= pos:
            self.i += 1
        if self.i < len(self.records):
            v, s = self.records[self.i]
            if v.pos <= pos < v.end:
                return v, s
        return None, None

    def variant_starting_at(self, pos):
        j = self.i
        while j < len(self.records) and self.records[j][0].pos <= pos:
            v, s = self.records[j]
            if v.pos == pos and any(a != NON_REF for a in v.alts):
                return v, s
            j += 1
        return None, None


def _expand_ref_block_pl(pl3, n_alleles, ploidy=2):
    """Expand a (ref, NON_REF) PL triple over n_alleles: PL(g) determined by
    the number of ref alleles in g (2 ref -> pl[0], 1 -> pl[1], 0 -> pl[2])."""
    gts = genotyper.genotype_allele_counts(ploidy, n_alleles)
    out = []
    for g in gts:
        n_ref = sum(1 for a in g if a == 0)
        out.append(pl3[min(ploidy - n_ref, len(pl3) - 1)])
    return out


def _remap_pls(pl, old_alleles, new_alleles, ploidy=2):
    """Subset/reorder PLs from old to new allele list (new must be subset-mappable)."""
    old_index = {a: i for i, a in enumerate(old_alleles)}
    new_gts = genotyper.genotype_allele_counts(ploidy, len(new_alleles))
    old_gts = genotyper.genotype_allele_counts(ploidy, len(old_alleles))
    old_gt_index = {g: i for i, g in enumerate(old_gts)}
    out = []
    for g in new_gts:
        try:
            old_g = tuple(sorted(old_index[new_alleles[a]] for a in g))
            out.append(pl[old_gt_index[old_g]])
        except KeyError:
            out.append(0)
    return out


def combine_gvcfs(per_sample_streams, sample_names, ref_fetch, contig,
                  interval=None, ploidy=2):
    """per_sample_streams: list of (variants, sample_dicts) per sample, one contig.
    ref_fetch(pos) -> uppercase reference base at 0-based pos.
    Returns list of combined Variants (GT always no-call, matching GATK output)."""
    cursors = [_SampleCursor(v, s) for v, s in per_sample_streams]

    # breakpoints: record starts, variant record ends
    points = set()
    for variants, _s in per_sample_streams:
        for v in variants:
            points.add(v.pos)
            if any(a != NON_REF for a in v.alts):
                points.add(v.pos + len(v.ref))
            points.add(v.end)  # block end (exclusive) is a potential start
    if interval is not None:
        lo, hi = interval
        points.add(lo)
        points = {p for p in points if lo <= p < hi}
    points = sorted(points)

    out = []
    for pi, pos in enumerate(points):
        next_point = points[pi + 1] if pi + 1 < len(points) else None

        # variant site?
        var_records = []
        for c in cursors:
            var_records.append(c.variant_starting_at(pos))
        if any(v is not None for v, _s in var_records):
            out.append(_merge_variant_site(var_records, cursors, pos, ref_fetch, contig, ploidy))
            continue

        # ref block segment [pos, seg_end)
        seg_end = next_point
        covering = [c.current_at(pos) for c in cursors]
        ends = [v.end for v, _s in covering if v is not None]
        if not ends:
            continue
        if seg_end is None:
            seg_end = max(ends)
        samples_out = []
        for v, s in covering:
            if v is None:
                samples_out.append({"GT": "./."})
            else:
                d = {"GT": "./."}
                for k in ("DP", "GQ", "MIN_DP", "MIN_GQ", "PL"):
                    if s.get(k) not in (None,):
                        d[k] = s[k]
                samples_out.append(d)
        info = {} if seg_end == pos + 1 else {"END": str(seg_end)}
        out.append(Variant(
            contig=contig, pos=pos, ref=chr(ref_fetch(pos)), alts=(NON_REF,),
            qual=None, filters=(), info=info,
            fmt_keys=("GT", "DP", "GQ", "MIN_DP", "MIN_GQ", "PL"),
            samples=samples_out,
        ))
    return out


def _merge_variant_site(var_records, cursors, pos, ref_fetch, contig, ploidy):
    # establish union ref (longest) with reference-corrected bases
    refs = [v.ref for v, _s in var_records if v is not None]
    longest_ref_len = max(len(r) for r in refs)
    true_ref = bytes(ref_fetch(pos + i) for i in range(longest_ref_len)).decode()

    # union of alt alleles, extended to the common ref; anchor bases corrected
    alt_union = []
    per_sample_allele_map = []  # old allele string -> new allele string per sample
    for v, _s in var_records:
        if v is None:
            per_sample_allele_map.append(None)
            continue
        mapping = {}
        suffix = true_ref[len(v.ref):]
        for a in v.alts:
            if a == NON_REF:
                mapping[a] = NON_REF
                continue
            if a == "*":
                mapping[a] = "*"
                continue
            new_alt = a[:1].replace(v.ref[:1], true_ref[:1]) + a[1:] + suffix
            # anchor correction: replace the leading base if it matched old ref
            if a[0] == v.ref[0]:
                new_alt = true_ref[0] + a[1:] + suffix
            else:
                new_alt = a + suffix
            mapping[a] = new_alt
            if new_alt not in alt_union:
                alt_union.append(new_alt)
        per_sample_allele_map.append(mapping)

    alleles = [true_ref] + alt_union + [NON_REF]
    info_vals = {}
    samples_out = []
    as_infos = []  # (remapped allele list, INFO) pairs for AS raw combining
    for si, ((v, s), c) in enumerate(zip(var_records, cursors)):
        if v is not None:
            m = per_sample_allele_map[si]
            old_alleles = [true_ref] + [m[a] for a in v.alts]
            as_infos.append((old_alleles, v.info))
            d = {"GT": "./."}
            ad = s.get("AD")
            if ad and ad != ".":
                ad_vals = [int(x) for x in ad.split(",")]
                idx = {a: i for i, a in enumerate(old_alleles)}
                new_ad = [ad_vals[idx[a]] if a in idx and idx[a] < len(ad_vals) else 0 for a in alleles]
                # AD over [ref]+alts+[NON_REF]
                d["AD"] = ",".join(str(x) for x in new_ad)
            pl = s.get("PL")
            if pl and pl != ".":
                pl_vals = [int(x) for x in pl.split(",")]
                d["PL"] = ",".join(str(x) for x in _remap_pls(pl_vals, old_alleles, alleles, ploidy))
            for k in ("DP", "GQ", "MIN_DP", "MIN_GQ", "SB"):
                if s.get(k) not in (None,):
                    d[k] = s[k]
            samples_out.append(d)
            for k in _MEDIAN_INFO:
                if k in v.info:
                    info_vals.setdefault(k, []).append(float(v.info[k]))
            for k in _SUM_INFO:
                if k in v.info:
                    info_vals.setdefault(k, []).append(float(v.info[k]))
        else:
            vb, sb_ = c.current_at(pos)
            if vb is None:
                samples_out.append({"GT": "./."})
            else:
                d = {"GT": "./."}
                pl = sb_.get("PL")
                if pl and pl != ".":
                    pl3 = [int(x) for x in pl.split(",")]
                    d["PL"] = ",".join(str(x) for x in _expand_ref_block_pl(pl3, len(alleles), ploidy))
                for k in ("DP", "GQ", "MIN_DP", "MIN_GQ"):
                    if sb_.get(k) not in (None,):
                        d[k] = sb_[k]
                samples_out.append(d)
                if "DP" in sb_ and sb_["DP"] != ".":
                    info_vals.setdefault("DP", []).append(float(sb_["DP"]))

    info = {}
    for k, vals in info_vals.items():
        if k in _SUM_INFO:
            info[k] = str(int(sum(vals)))
        else:
            info[k] = format_vcf_double(float(np.median(vals)))
    # allele-specific raw reduce: merge per-sample AS_RAW_*/AS_SB_TABLE
    # sections onto the merged allele list (AS_RankSumTest.combineRawData)
    if any("AS_SB_TABLE" in i or "AS_RAW_MQ" in i for _a, i in as_infos):
        from ..calling import as_annotations as asmod

        info.update(asmod.combine_raw_fields(
            [i for _a, i in as_infos], [a for a, _i in as_infos], alleles))
    info = {k: info[k] for k in sorted(info)}
    fmt = ("GT", "AD", "DP", "GQ", "MIN_DP", "MIN_GQ", "PL", "SB")
    used = [k for k in fmt if any(k in s for s in samples_out)]
    return Variant(
        contig=contig, pos=pos, ref=true_ref, alts=tuple(alleles[1:]),
        qual=None, filters=(), info=info, fmt_keys=tuple(used), samples=samples_out,
    )
