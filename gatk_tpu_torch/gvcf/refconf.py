# Copied verbatim from gatk_tpu/gvcf/refconf.py; only import lines may differ.
"""Reference-confidence model + GVCF hom-ref banding.

Reference behavior: haplotypecaller/ReferenceConfidenceModel.java
(calcGenotypeLikelihoodsOfRefVsAny :399-446, per-element likelihoods :483-515,
indel PL cache :355-395), utils/variant/writers/GVCFWriter.java +
HomRefBlock.java (banding; DP=median, MIN_DP=min, PL from the min-GQ site).

TPU-first shape: the per-position ref-vs-any GLs are a dense array program over
the pileup matrix (positions x reads), not a per-element object loop.
"""
from __future__ import annotations

import math

import numpy as np

from ..engine import pileup as pileup_mod
from ..io.vcf import Variant

LOG10_ONE_THIRD = -math.log10(3.0)
INDEL_QUAL = 45  # round(4.5 * 10)
MAX_N_INDEL_INFORMATIVE_READS = 40
_NO_INDEL_L = math.log10(1.0 - 10.0 ** (-INDEL_QUAL / 10.0))
_INDEL_L = -INDEL_QUAL / 10.0

# default GVCF GQ bands (HaplotypeCallerArgumentCollection.GVCFGQBands)
DEFAULT_GQ_BANDS = list(range(1, 61)) + [70, 80, 90, 99]


def indel_pls(ploidy: int, n_informative: int) -> np.ndarray:
    """PLs for the no-indel model given N informative reads (indelPLCache)."""
    n = min(n_informative, MAX_N_INDEL_INFORMATIVE_READS)
    gl = np.zeros(ploidy + 1)
    if n > 0:
        gl[0] = n * _NO_INDEL_L
        for alt_count in range(1, ploidy + 1):
            ref_acc = _NO_INDEL_L + (math.log10(ploidy - alt_count) if ploidy > alt_count else -np.inf)
            alt_acc = _INDEL_L + math.log10(alt_count)
            gl[alt_count] = n * (np.logaddexp(ref_acc * math.log(10), alt_acc * math.log(10)) / math.log(10) - math.log10(ploidy))
    pl = -10.0 * (gl - gl.max())
    return np.round(pl).astype(int)


def ref_vs_any_gls(reads, span_start: int, span_end: int, ref_span: np.ndarray,
                   min_base_qual: int = 10, ploidy: int = 2):
    """Vectorized per-position ref-vs-any genotype likelihoods.

    Returns (pls, dp, ref_depth) where pls is (n_pos, ploidy+1) int PLs
    (SNP model combined with the indel model), dp per-position depth.
    """
    n = span_end - span_start
    gl = np.zeros((n, ploidy + 1))
    dp = np.zeros(n, np.int64)
    n_informative = np.zeros(n, np.int64)
    read_count = np.zeros(n, np.int64)
    log10_ploidy = math.log10(ploidy)

    for read in reads:
        pos, base, qual, flags = pileup_mod.expand_read(read)
        keep = (pos >= span_start) & (pos < span_end)
        if not keep.any():
            continue
        pos = pos[keep] - span_start
        base = base[keep]
        qual = qual[keep].astype(np.float64)
        flags = flags[keep]
        is_del = (flags & pileup_mod.F_DELETION) > 0
        # deletion bases get a constant qual 30 (getDeletionQuality pre-assembly path)
        q = np.where(is_del, 30.0, qual)
        usable = q > min_base_qual
        if not usable.any():
            continue
        pos = pos[usable]
        base = base[usable]
        q = q[usable]
        is_del = is_del[usable]
        ref_b = ref_span[pos]
        is_alt = (base != ref_b) | is_del
        log_err = -q / 10.0
        log_ok = np.log10(-np.expm1(log_err * math.log(10.0)))
        ref_l = np.where(is_alt, log_err + LOG10_ONE_THIRD, log_ok)
        alt_l = np.where(is_alt, log_ok, log_err + LOG10_ONE_THIRD)
        np.add.at(gl[:, 0], pos, ref_l + log10_ploidy)
        np.add.at(gl[:, ploidy], pos, alt_l + log10_ploidy)
        for i in range(1, ploidy):
            j = ploidy - i
            het = np.logaddexp(
                (ref_l + math.log10(j)) * math.log(10.0),
                (alt_l + math.log10(i)) * math.log(10.0),
            ) / math.log(10.0)
            np.add.at(gl[:, i], pos, het)
        np.add.at(read_count, pos, 1)
        np.add.at(dp, pos, 1)
        # indel informativeness: reads spanning the position (simplified
        # calcNIndelInformativeReads: full model checks 10bp repeat context)
        np.add.at(n_informative, pos, (~is_del).astype(np.int64))

    gl -= (read_count * log10_ploidy)[:, None]
    # convert to PLs and combine with indel model per position
    pls = np.zeros((n, ploidy + 1), int)
    for i in range(n):
        g = gl[i]
        pl = np.round(-10.0 * (g - g.max())).astype(int)
        ipl = indel_pls(ploidy, int(n_informative[i]))
        # GATK caps the ref confidence by the indel model: take the
        # entry-wise max of PL (lower confidence wins for GQ)
        snp_gq = _gq_from_pls(pl)
        indel_gq = _gq_from_pls(ipl)
        pls[i] = pl if snp_gq <= indel_gq else ipl
    return pls, dp


def _gq_from_pls(pl) -> int:
    s = np.sort(np.asarray(pl))
    return int(min(s[1] - s[0], 99))


class GvcfBlockWriter:
    """Bands hom-ref sites into blocks, interleaving variant records
    (GVCFWriter/GVCFBlockCombiner semantics)."""

    def __init__(self, contig: str, sample: str, gq_bands=None, ploidy: int = 2):
        self.contig = contig
        self.sample = sample
        bands = sorted(set(gq_bands or DEFAULT_GQ_BANDS))
        self.partitions = [0] + bands  # band lower bounds
        self.ploidy = ploidy
        self._block = None
        self.records = []

    def _band_index(self, gq: int) -> int:
        import bisect

        return bisect.bisect_right(self.partitions, gq) - 1

    def add_hom_ref(self, pos: int, ref_base: str, pl, dp: int):
        gq = _gq_from_pls(pl)
        band = self._band_index(min(gq, 99))
        b = self._block
        if b is not None and b["band"] == band and pos == b["end"]:
            b["end"] = pos + 1
            b["dps"].append(dp)
            if gq < b["min_gq"]:
                b["min_gq"] = gq
                b["pl"] = list(pl)
        else:
            self.flush()
            self._block = dict(start=pos, end=pos + 1, band=band, ref=ref_base,
                               dps=[dp], min_gq=gq, pl=list(pl))

    def add_variant(self, variant: Variant):
        self.flush()
        self.records.append(variant)

    def flush(self):
        b = self._block
        if b is None:
            return
        self._block = None
        dps = sorted(b["dps"])
        median_dp = dps[len(dps) // 2]
        info = {} if b["end"] == b["start"] + 1 else {"END": str(b["end"])}
        self.records.append(Variant(
            contig=self.contig, pos=b["start"], ref=b["ref"], alts=("<NON_REF>",),
            qual=None, filters=(), info=info,
            fmt_keys=("GT", "DP", "GQ", "MIN_DP", "PL"),
            samples=[{
                "GT": "/".join(["0"] * self.ploidy),
                "DP": str(median_dp),
                "GQ": str(min(b["min_gq"], 99)),
                "MIN_DP": str(min(dps)),
                "PL": ",".join(str(int(x)) for x in b["pl"]),
            }],
        ))
