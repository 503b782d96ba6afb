# Copied verbatim from gatk_tpu/gvcf/reblock.py; only import lines may differ.
"""ReblockGVCF: condense hom-ref blocks in a single-sample GVCF.

Reference behavior: tools/walkers/variantutils/ReblockGVCF.java —
regenotypeVC :374-443 (ref blocks pass through to the re-banding combiner; with
--drop-low-quals variant sites are QUAL-thresholded by the exact-AF genotyping
engine), shouldBeReblocked :514-539, lowQualVariantToGQ0HomRef :542-566,
changeCallToHomRefVersusNonRef :576-633, cleanUpHighQualityVariant :635-700,
composeUpdatedAnnotations :762-790 (+QUALapprox/VarDP/RAW_GT_COUNT :852-859),
updateMQAnnotations :1000-1021 (MQ -> RAW_MQandDP), default GQ bands {20,100}
(:138-140); re-banding by utils/variant/writers/ReblockingGVCFBlockCombiner.
"""
from __future__ import annotations

import math

import numpy as np

from ..calling import genotyper
from ..io.vcf import Variant

NON_REF = "<NON_REF>"
SPAN_DEL = "*"

# GVCFWriter.GVCF_BLOCK-prefixed headers plus these INFO keys are dropped
INFO_KEYS_TO_REMOVE = ("HaplotypeScore", "InbreedingCoeff", "MLEAC", "MLEAF",
                       "ExcessHet", "AS_InbreedingCoeff", "DS", "MQ0")

# default annotation key set retained when no -A restriction is given
_DEFAULT_KEEP = ("DP", "MQ", "BaseQRankSum", "MQRankSum", "ReadPosRankSum",
                 "FS", "SOR", "QD", "AS_QUALapprox", "AS_VarDP")


def _pls(sample: dict):
    pl = sample.get("PL")
    if not pl or pl == ".":
        return None
    return [int(float(x)) for x in pl.split(",")]


def _gq_from_pls(pl):
    s = sorted(pl)
    return int(min(s[1] - s[0], 99))


def _gt_tuple_for_min_pl(pl, n_alleles, ploidy=2):
    gts = genotyper.genotype_allele_counts(ploidy, n_alleles)
    return gts[int(np.argmin(pl))]


def _subset_pl_indices(old_n, keep_idx, ploidy=2):
    """Canonical genotype indices over keep_idx alleles -> indices over old alleles."""
    old_gts = genotyper.genotype_allele_counts(ploidy, old_n)
    old_index = {g: i for i, g in enumerate(old_gts)}
    new_gts = genotyper.genotype_allele_counts(ploidy, len(keep_idx))
    return [old_index[tuple(sorted(keep_idx[a] for a in g))] for g in new_gts]


class ReblockingBlockCombiner:
    """Re-bands hom-ref records into merged blocks (ReblockingGVCFBlockCombiner).

    Each input record contributes once (its genotype DP / GQ / PL); adjacent
    records in the same GQ band merge, tracking min GQ, min DP, and the PL of
    the lowest-GQ record."""

    def __init__(self, gq_bands=(20, 100), floor_blocks=False):
        self.partitions = [0] + sorted(set(gq_bands))
        self.floor_blocks = floor_blocks
        self._block = None
        self.records = []
        self.output_end = {}  # contig -> last written position (1-based-ish 0-based end)

    def _band(self, gq):
        import bisect

        return bisect.bisect_right(self.partitions, min(gq, 99)) - 1

    def add_block(self, contig, start, end, ref_base, gq, dp, pl):
        """start/end 0-based half-open."""
        band = self._band(gq)
        b = self._block
        if b is not None and b["contig"] == contig and b["band"] == band and start <= b["end"]:
            b["end"] = max(b["end"], end)
            b["dps"].append(dp)
            # HomRefBlock.add: PLs merge element-wise to the minimum
            if pl is not None:
                b["pl"] = pl if b["pl"] is None else [min(a, c) for a, c in zip(b["pl"], pl)]
        else:
            self.flush()
            self._block = dict(contig=contig, start=start, end=end, band=band,
                               ref=ref_base, dps=[dp], min_gq=gq, pl=list(pl) if pl else None)

    def add_variant(self, v: Variant):
        self.flush()
        self.records.append(v)
        self.output_end[v.contig] = max(self.output_end.get(v.contig, -1),
                                        v.pos + len(v.ref) - 1)

    def flush(self):
        b = self._block
        if b is None:
            return
        self._block = None
        # skip block portions already covered by emitted variants
        covered = self.output_end.get(b["contig"], -1)
        if b["end"] - 1 <= covered:
            return
        start = max(b["start"], covered + 1)
        dps = [d for d in b["dps"] if d is not None]
        dps_sorted = sorted(dps) or [0]
        # HomRefBlock.getMedianDP: interpolated median, rounded half-up
        median_dp = int(math.floor(float(np.median(dps_sorted)) + 0.5))
        # GQ recomputed from the element-wise-min PLs (HomRefBlock.add :121-133)
        min_gq = _gq_from_pls(b["pl"]) if b["pl"] is not None else b["min_gq"]
        gq = self.partitions[b["band"]] if self.floor_blocks else min(min_gq, 99)
        fmt = {"GT": "0/0", "DP": str(median_dp), "GQ": str(gq),
               "MIN_DP": str(min(dps_sorted))}
        keys = ("GT", "DP", "GQ", "MIN_DP", "PL")
        if self.floor_blocks or b["pl"] is None:
            keys = ("GT", "DP", "GQ", "MIN_DP")
        else:
            fmt["PL"] = ",".join(str(int(x)) for x in b["pl"])
        info = {"END": str(b["end"])}
        self.records.append(Variant(
            contig=b["contig"], pos=start, ref=b["ref"], alts=(NON_REF,),
            qual=None, filters=(), info=info, fmt_keys=keys, samples=[fmt]))
        self.output_end[b["contig"]] = max(self.output_end.get(b["contig"], -1),
                                           b["end"] - 1)


class ReblockEngine:
    def __init__(self, gq_bands=(20, 100), drop_low_quals=False, rgq_threshold=0.0,
                 do_qual_approx=False, keep_all_alts=False, floor_blocks=False,
                 annotations_to_keep=None, standard_confidence=30.0, reference=None,
                 ploidy=2):
        self.drop_low_quals = drop_low_quals
        self.rgq_threshold = rgq_threshold
        self.do_qual_approx = do_qual_approx
        self.keep_all_alts = keep_all_alts
        self.standard_confidence = standard_confidence
        self.reference = reference
        self.ploidy = ploidy
        self.keep_keys = tuple(annotations_to_keep) if annotations_to_keep else _DEFAULT_KEEP
        self.combiner = ReblockingBlockCombiner(gq_bands, floor_blocks)
        self.af_calc = genotyper.AlleleFrequencyCalculator(ploidy=ploidy)

    # ------------------------------------------------------------------
    def process(self, v: Variant):
        """Feed one input GVCF record; output accumulates in self.combiner.records."""
        if v.alts == (NON_REF,):
            self._process_ref_block(v)
        else:
            self._process_variant(v)

    def finish(self):
        self.combiner.flush()
        return self.combiner.records

    # ------------------------------------------------------------------
    def _process_ref_block(self, v):
        g = v.samples[0]
        gq = int(g["GQ"]) if g.get("GQ", ".") != "." else None
        if self.drop_low_quals and (gq is None or gq < self.rgq_threshold or gq == 0):
            return
        end = int(v.info.get("END", v.pos + 1))  # END is 1-based inclusive
        dp = int(g["DP"]) if g.get("DP", ".") != "." else None
        pl = _pls(g)
        self.combiner.add_block(v.contig, v.pos, end, v.ref[0],
                                gq if gq is not None else 0, dp, pl)

    # ------------------------------------------------------------------
    def _concrete_alts(self, v):
        return [a for a in v.alts if a != NON_REF and a != SPAN_DEL]

    def _is_monomorphic_with_alts(self, v, pl):
        g = v.samples[0]
        gt = g.get("GT", ".").replace("|", "/")
        hom_ref = gt == "/".join(["0"] * self.ploidy) or (pl and int(np.argmin(pl)) == 0)
        return bool(pl) and hom_ref and len(self._concrete_alts(v)) > 0

    def _recompute_qual(self, v, pl):
        """Exact-AF QUAL over concrete alleles (genotypingEngine.calculateGenotypes)."""
        alleles = [v.ref] + self._concrete_alts(v)
        if len(alleles) < 2 or pl is None:
            return None
        keep_idx = [0] + [i + 1 for i, a in enumerate(v.alts) if a in alleles[1:]]
        idx_map = _subset_pl_indices(len(v.alts) + 1, keep_idx, self.ploidy)
        sub = np.array([pl[i] for i in idx_map], float)
        gls = -(sub - sub.min()) / 10.0
        af = self.af_calc.calculate([len(a) for a in alleles], len(v.ref), [gls], self.ploidy)
        return -10.0 * af.log10_p_no_variant

    def _process_variant(self, v):
        g = dict(v.samples[0])
        pl = _pls(g)
        qual = v.qual

        if (self.drop_low_quals and int(v.info.get("DP", 0) or 0) > 0
                and not self._is_monomorphic_with_alts(v, pl)):
            new_qual = self._recompute_qual(v, pl)
            if new_qual is None or new_qual < self.standard_confidence:
                return  # genotyping engine emits nothing -> drop entirely
            qual = float(f"{new_qual:.2f}")

        if self._should_be_reblocked(v, pl):
            self._variant_to_hom_ref(v, pl)
            return

        self._emit_high_quality(v, g, pl, qual)

    def _should_be_reblocked(self, v, pl):
        if pl is None:
            return True
        if pl[0] < self.rgq_threshold:
            return True
        alleles = [v.ref] + list(v.alts)
        gt = _gt_tuple_for_min_pl(pl, len(alleles), self.ploidy)
        called = [alleles[i] for i in gt]
        has_concrete = any(a not in (NON_REF, SPAN_DEL) and a != v.ref for a in called)
        return (not has_concrete) or any(a == NON_REF for a in called)

    def _variant_to_hom_ref(self, v, pl):
        g = v.samples[0]
        if self.drop_low_quals and (not self._is_monomorphic_with_alts(v, pl)
                                    or "." in g.get("GT", ".")):
            return
        n2 = len(genotyper.genotype_allele_counts(self.ploidy, 2))
        if pl is None or pl[0] != 0:
            new_pl = [0] * n2
            gq = 0
            dp = int(v.info.get("DP", 0) or 0)
        else:
            # subset to ref + best alt: NON_REF gets the best alt's likelihoods
            alleles = [v.ref] + list(v.alts)
            best_alt = None
            best_val = None
            for i in range(1, len(alleles)):
                if alleles[i] == NON_REF:
                    continue
                idx_map = _subset_pl_indices(len(alleles), [0, i], self.ploidy)
                sub = [pl[j] for j in idx_map]
                if best_val is None or min(sub[1:]) > min(best_val[1:]):
                    best_val = sub
                    best_alt = i
            if best_val is None:
                best_val = [0] * n2
            mn = min(best_val)
            new_pl = [x - mn for x in best_val]
            gq = _gq_from_pls(new_pl)
            dp = int(v.info.get("DP", 0) or 0)
            if not dp and g.get("AD", ".") != ".":
                dp = sum(int(x) for x in g["AD"].split(","))
        end = v.pos + len(v.ref)
        self.combiner.add_block(v.contig, v.pos, end, v.ref[0], gq, dp, new_pl)

    # ------------------------------------------------------------------
    def _emit_high_quality(self, v, g, pl, qual):
        alleles = [v.ref] + list(v.alts)
        gt_str = g.get("GT", ".").replace("|", "/")
        if "." in gt_str:
            gt = _gt_tuple_for_min_pl(pl, len(alleles), self.ploidy)
        else:
            gt = tuple(sorted(int(x) for x in gt_str.split("/")))

        called_idx = sorted(set(gt))
        # drop concrete alts not in the called genotype
        drop = [i for i in range(1, len(alleles))
                if alleles[i] not in (NON_REF,) and i not in called_idx]
        keep_idx = [i for i in range(len(alleles)) if i not in drop]

        if drop and not self.keep_all_alts:
            idx_map = _subset_pl_indices(len(alleles), keep_idx, self.ploidy)
            sub_pl = [pl[i] for i in idx_map]
            mn = min(sub_pl)
            sub_pl = [x - mn for x in sub_pl]
            if int(np.argmin(sub_pl)) == 0:
                # subsetting made it hom-ref
                if self.drop_low_quals:
                    return
                self._variant_to_hom_ref(v, pl)
                return
            remap = {old: new for new, old in enumerate(keep_idx)}
            gt = tuple(remap[i] for i in gt)
            if g.get("AD", ".") != ".":
                ad = [int(x) for x in g["AD"].split(",")]
                g["AD"] = ",".join(str(ad[i]) if i < len(ad) else "0" for i in keep_idx)
            g["PL"] = ",".join(str(x) for x in sub_pl)
            g["GQ"] = str(_gq_from_pls(sub_pl))
            pl = sub_pl
            new_alleles = [alleles[i] for i in keep_idx]
            # trim common suffix of remaining alleles (trimAlleles reverse-only)
            ref, alts = self._trim_suffix(new_alleles[0], new_alleles[1:])
            old_end = v.pos + len(new_alleles[0])
            new_end = v.pos + len(ref)
            if new_end < old_end:
                self._add_trim_filler_block(v, pl_orig=_pls(v.samples[0]),
                                            alleles=alleles, drop=drop,
                                            start=new_end, end=old_end)
            alleles = [ref] + alts
        else:
            alleles = [alleles[i] for i in keep_idx] if not drop else alleles
            if not drop:
                alleles = [v.ref] + list(v.alts)

        # zero out NON_REF AD; subtract from DP
        if NON_REF in alleles and g.get("AD", ".") != ".":
            nr = alleles.index(NON_REF)
            ad = [int(x) for x in g["AD"].split(",")]
            if nr < len(ad) and ad[nr] > 0:
                nonref_ad = ad[nr]
                ad[nr] = 0
                g["AD"] = ",".join(str(x) for x in ad)
                if g.get("DP", ".") != ".":
                    g["DP"] = str(int(g["DP"]) - nonref_ad)

        info = self._compose_annotations(v, g, pl, gt, alleles)
        g["GT"] = "/".join(str(i) for i in gt)

        fmt_keys = tuple(k for k in v.fmt_keys if k in g and k != "MIN_DP")
        self.combiner.add_variant(Variant(
            contig=v.contig, pos=v.pos, ref=alleles[0],
            alts=tuple(alleles[1:]), qual=qual, filters=(),
            info=info, fmt_keys=fmt_keys,
            samples=[{k: g[k] for k in fmt_keys}]))

    @staticmethod
    def _trim_suffix(ref, alts):
        concrete = [a for a in alts if a != NON_REF and a != SPAN_DEL]
        while (len(ref) > 1 and concrete and all(len(a) > 1 for a in concrete)
               and all(a[-1] == ref[-1] for a in concrete)):
            ref = ref[:-1]
            alts = [a[:-1] if a not in (NON_REF, SPAN_DEL) else a for a in alts]
            concrete = [a for a in alts if a != NON_REF and a != SPAN_DEL]
        return ref, list(alts)

    def _add_trim_filler_block(self, v, pl_orig, alleles, drop, start, end):
        """Ref block covering span vacated by a trimmed deletion allele
        (addRefBlockIfNecessary :703-760)."""
        if pl_orig is None:
            return
        dropped_concrete = [i for i in drop if alleles[i] != SPAN_DEL]
        if not dropped_concrete:
            return
        shortest = min(dropped_concrete, key=lambda i: len(alleles[i]))
        idx_map = _subset_pl_indices(len(alleles), [0, shortest], self.ploidy)
        sub = [pl_orig[i] for i in idx_map]
        mn = min(sub)
        sub = [max(x - sub[0], 0) for x in sub] if sub[0] != 0 else sub
        gq = _gq_from_pls(sub)
        dp = int(v.info.get("DP", 0) or 0)
        ref_base = "N"
        if self.reference is not None:
            try:
                ref_base = self.reference.fetch_bytes(v.contig, start, start + 1).decode()
            except Exception:
                pass
        self.combiner.add_block(v.contig, start, end, ref_base, gq, dp, sub)

    def _compose_annotations(self, v, g, pl, gt, alleles):
        info = {}
        # RAW_MQandDP from MQ (updateMQAnnotations)
        if "RAW_MQandDP" in v.info:
            info["RAW_MQandDP"] = v.info["RAW_MQandDP"]
        else:
            dp = int(v.info.get("DP", 0) or 0)
            if "RAW_MQ" in v.info:
                raw = int(round(float(v.info["RAW_MQ"])))
                # preserve the deprecated keys so old GVCFs need no reprocessing
                info["RAW_MQ"] = f"{float(v.info['RAW_MQ']):.2f}"
                info["MQ_DP"] = str(dp)
            else:
                mq = float(v.info.get("MQ", 60.0))
                raw = int(round(mq * mq * dp))
            info["RAW_MQandDP"] = f"{raw},{dp}"
        for key in self.keep_keys:
            if key in INFO_KEYS_TO_REMOVE:
                continue
            if key in v.info:
                info[key] = v.info[key]
        info["RAW_GT_COUNT"] = "0,1,0" if 0 in gt else "0,0,1"
        if self.do_qual_approx and pl is not None:
            info["QUALapprox"] = str(int(pl[0]))
            # QualByDepth.getDepth: AD sum if present, else genotype DP, else INFO DP
            var_dp = 0
            if g.get("AD", ".") != ".":
                var_dp = sum(int(x) for x in g["AD"].split(","))
            if var_dp == 0 and g.get("DP", ".") != ".":
                var_dp = int(g["DP"])
            if var_dp == 0:
                var_dp = int(info.get("DP", v.info.get("DP", 1)) or 1)
            info["VarDP"] = str(var_dp)
        return {k: info[k] for k in sorted(info)}
