# Copied from gatk_tpu/gvcf/refconf.py; only import lines, the tracer's decorator lines (utils/trace.py), ref_vs_any_gls (one dense pass over the interval's pileup elements, with _ref_vs_any_luts and _gqs_from_pls) and GvcfBlockWriter's banding of a run of hom-ref positions in bulk (add_hom_ref_run, and _ref_block, which builds flush's record) differ.
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
from ..utils import trace

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


@trace.stage("refconf")
def ref_vs_any_gls(reads, span_start: int, span_end: int, ref_span: np.ndarray,
                   min_base_qual: int = 10, ploidy: int = 2):
    """Vectorized per-position ref-vs-any genotype likelihoods.

    Returns (pls, dp) where pls is (n_pos, ploidy+1) int PLs (SNP model
    combined with the indel model), dp per-position depth.

    One pass over the interval's pileup elements: each element's GL terms
    depend only on (is_alt, qual), so they are gathered from (2, 256) tables
    and summed per position with bincount, which adds in element (read)
    order as a per-read np.add.at loop does, so the sums are the same bits.
    """
    n = span_end - span_start
    log10_ploidy = math.log10(ploidy)
    el = pileup_mod.build_pileup_elements(reads, span_start, span_end)
    is_del = (el["flags"] & pileup_mod.F_DELETION) > 0
    # deletion bases get a constant qual 30 (getDeletionQuality pre-assembly path)
    q = np.where(is_del, 30, el["qual"].astype(np.int64))
    usable = q > min_base_qual
    pos = el["pos"][usable]
    q = q[usable]
    is_del = is_del[usable]
    is_alt = (el["base"][usable] != ref_span[pos]) | is_del
    key = q + 256 * is_alt

    gl = np.empty((n, ploidy + 1))
    for i, lut in enumerate(_ref_vs_any_luts(ploidy)):
        gl[:, i] = np.bincount(pos, weights=lut[key], minlength=n)
    dp = np.bincount(pos, minlength=n)
    # indel informativeness: reads spanning the position (simplified
    # calcNIndelInformativeReads: full model checks 10bp repeat context)
    n_informative = np.bincount(pos[~is_del], minlength=n)

    gl -= (dp * log10_ploidy)[:, None]
    # convert to PLs and combine with indel model per position
    pl = np.round(-10.0 * (gl - gl.max(axis=1, keepdims=True))).astype(int)
    ipl_table = np.array([indel_pls(ploidy, m)
                          for m in range(MAX_N_INDEL_INFORMATIVE_READS + 1)])
    ipl = ipl_table[np.minimum(n_informative, MAX_N_INDEL_INFORMATIVE_READS)]
    # GATK caps the ref confidence by the indel model: take the
    # entry-wise max of PL (lower confidence wins for GQ)
    snp_gq = _gqs_from_pls(pl)
    indel_gq = _gqs_from_pls(ipl)
    pls = np.where((snp_gq <= indel_gq)[:, None], pl, ipl)
    return pls, dp


def _ref_vs_any_luts(ploidy: int) -> np.ndarray:
    """(ploidy+1, 512) per-element GL terms, indexed by qual + 256 * is_alt:
    the per-element formulas of the reference-confidence model, evaluated in
    float64 once for every qual."""
    ln10 = math.log(10.0)
    q = np.arange(256, dtype=np.float64)
    log_err = -q / 10.0
    with np.errstate(divide="ignore"):  # qual 0, never usable
        log_ok = np.log10(-np.expm1(log_err * ln10))
    ref_l = np.concatenate([log_ok, log_err + LOG10_ONE_THIRD])
    alt_l = np.concatenate([log_err + LOG10_ONE_THIRD, log_ok])
    luts = np.empty((ploidy + 1, 512))
    luts[0] = ref_l + math.log10(ploidy)
    luts[ploidy] = alt_l + math.log10(ploidy)
    for i in range(1, ploidy):
        j = ploidy - i
        luts[i] = np.logaddexp((ref_l + math.log10(j)) * ln10,
                               (alt_l + math.log10(i)) * ln10) / ln10
    return luts


def _gqs_from_pls(pls: np.ndarray) -> np.ndarray:
    """_gq_from_pls of each row."""
    s = np.sort(pls, axis=1)
    return np.minimum(s[:, 1] - s[:, 0], 99)


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

    def add_hom_ref_run(self, start: int, ref_bases: bytes, pls, dps):
        """add_hom_ref at start, start + 1, ... in turn, one position for each
        entry of ref_bases, of the (n, ploidy+1) PL rows and of dps; banded in
        bulk. Leaves the records and the open block as those calls would."""
        n = len(dps)
        if n == 0:
            return
        pls, dps = np.asarray(pls), np.asarray(dps)
        gq = _gqs_from_pls(pls)
        band_of_gq = np.array([self._band_index(g) for g in range(100)])
        band = band_of_gq[gq]
        # blocks break where the band changes
        edges = np.flatnonzero(band[1:] != band[:-1]) + 1
        starts = np.concatenate(([0], edges))
        ends = np.concatenate((edges, [n]))
        seg = np.repeat(np.arange(len(starts)), ends - starts)
        # each block's first position of least GQ (add_hom_ref's strict <):
        # a stable sort by (block, gq) puts it first among the block's
        first_min = np.lexsort((gq, seg))[starts]
        sorted_dps = dps[np.lexsort((dps, seg))]
        median_dp = sorted_dps[starts + (ends - starts) // 2].tolist()
        min_dp = sorted_dps[starts].tolist()
        pl_rows = pls[first_min].tolist()
        gq, band, dps = gq.tolist(), band.tolist(), dps.tolist()
        starts, ends, first_min = starts.tolist(), ends.tolist(), first_min.tolist()

        first = 0
        b = self._block
        if b is not None and b["band"] == band[0] and b["end"] == start:
            # the run's first block continues the open one
            b["end"] = start + ends[0]
            b["dps"].extend(dps[:ends[0]])
            if gq[first_min[0]] < b["min_gq"]:
                b["min_gq"] = gq[first_min[0]]
                b["pl"] = pl_rows[0]
            first = 1
        if first == len(starts):
            return
        self.flush()
        # blocks that the run both opens and closes; the last stays open
        for k in range(first, len(starts) - 1):
            self.records.append(self._ref_block(
                start + starts[k], start + ends[k], chr(ref_bases[starts[k]]),
                median_dp[k], gq[first_min[k]], min_dp[k], pl_rows[k]))
        a, e = starts[-1], ends[-1]
        self._block = dict(start=start + a, end=start + e, band=band[a],
                           ref=chr(ref_bases[a]), dps=dps[a:e], min_gq=gq[first_min[-1]],
                           pl=pl_rows[-1])

    def add_variant(self, variant: Variant):
        self.flush()
        self.records.append(variant)

    def flush(self):
        b = self._block
        if b is None:
            return
        self._block = None
        dps = sorted(b["dps"])
        self.records.append(self._ref_block(b["start"], b["end"], b["ref"], dps[len(dps) // 2],
                                            min(b["min_gq"], 99), dps[0], b["pl"]))

    def _ref_block(self, start, end, ref, median_dp, gq, min_dp, pl) -> Variant:
        info = {} if end == start + 1 else {"END": str(end)}
        return Variant(
            contig=self.contig, pos=start, ref=ref, alts=("<NON_REF>",),
            qual=None, filters=(), info=info,
            fmt_keys=("GT", "DP", "GQ", "MIN_DP", "PL"),
            samples=[{
                "GT": "/".join(["0"] * self.ploidy),
                "DP": str(median_dp),
                "GQ": str(gq),
                "MIN_DP": str(min_dp),
                "PL": ",".join(map(str, map(int, pl))),
            }],
        )
