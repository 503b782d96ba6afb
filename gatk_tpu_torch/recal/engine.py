# Copied verbatim from gatk_tpu/recal/engine.py; only import lines may differ.
"""BaseRecalibrationEngine: pass-1 covariate/error accumulation into dense tables.

Reference behavior: utils/recalibration/BaseRecalibrationEngine.java (read
transform :292-300, isSNP/indel :393-445, known-sites skip :339-380, fractional
errors :457-500, table update :255-290), tools/walkers/bqsr/BaseRecalibrator.java
(read filters :154-181).

TPU-first design: instead of a NestedIntegerArray of RecalDatum objects, the
tables are dense (rg, qual, covariate, event) observation/error tensors; per-read
covariate keys and error fractions are computed as arrays and accumulated with a
scatter-add (np.add.at on host; the identical formulation jits to a TPU
scatter-add for large runs).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from ..engine import clipping
from ..io import sam
from . import baq as baq_mod
from . import covariates as cov
from .report import (
    EVENT_TYPES,
    MAX_SAM_QUAL_SCORE,
    QuantizationInfo,
    RecalDatum,
    ReportTable,
    render_report,
)

MIN_USABLE_QUAL = 6  # PRESERVE_QSCORES_LESS_THAN
EVENT_M, EVENT_I, EVENT_D = 0, 1, 2
DEFAULT_INDEL_QUAL = 45
DEFAULT_ADAPTOR_SIZE = 100

_IS_REGULAR_BASE = np.zeros(256, bool)
for _b in b"ACGTacgt":
    _IS_REGULAR_BASE[_b] = True


def _round_half_up(x: float, decimals: int) -> float:
    scale = 10.0 ** decimals
    return math.floor(x * scale + 0.5) / scale


@dataclass
class RecalArgs:
    mismatches_context_size: int = 2
    indels_context_size: int = 3
    low_quality_tail: int = 2
    maximum_cycle_value: int = 500
    quantizing_levels: int = 16
    enable_baq: bool = False
    compute_indel_tables: bool = True
    baq_gop: float = 40.0
    deletions_default_quality: int = 45
    insertions_default_quality: int = 45
    mismatches_default_quality: int = -1

    def report_table(self, covariate_names: str) -> ReportTable:
        t = ReportTable("Arguments", "Recalibration argument collection values used in this run",
                        [("Argument", "%s"), ("Value", "")])
        rows = {
            "covariate": covariate_names,
            "no_standard_covs": False,
            "run_without_dbsnp": False,
            "solid_recal_mode": "SET_Q_ZERO",
            "solid_nocall_strategy": "THROW_EXCEPTION",
            "mismatches_context_size": self.mismatches_context_size,
            "indels_context_size": self.indels_context_size,
            "mismatches_default_quality": self.mismatches_default_quality,
            "deletions_default_quality": self.deletions_default_quality,
            "insertions_default_quality": self.insertions_default_quality,
            "maximum_cycle_value": self.maximum_cycle_value,
            "low_quality_tail": self.low_quality_tail,
            "default_platform": None,
            "force_platform": None,
            "quantizing_levels": self.quantizing_levels,
            "recalibration_report": None,
            "binary_tag_name": None,
        }
        for k, v in rows.items():
            t.add_row(k, v)
        return t


def bqsr_read_filter(read) -> bool:
    """getStandardBQSRReadFilterList + WellformedReadFilter."""
    if read.is_unmapped or read.is_secondary or read.is_duplicate or read.fails_vendor_quality:
        return False
    if read.mapq == 0 or read.mapq == 255:
        return False
    if read.pos < 0:
        return False
    if len(read.bases) == 0 or len(read.bases) != len(read.quals):
        return False
    if read.read_group is None:
        return False
    ops = read.cigar_ops
    if sam.cigar_read_length(ops, read.cigar_lens) != len(read.bases):
        return False
    if (ops == sam.OP_N).any():
        return False
    return True


def _has_well_defined_fragment_size(read) -> bool:
    if read.tlen == 0 or not read.is_paired or read.mate_is_unmapped:
        return False
    if read.is_reverse == bool(read.flag & sam.MATE_REVERSE):
        return False
    if read.is_reverse:
        return read.end > read.mate_pos
    return read.pos <= read.mate_pos + read.tlen


def _adaptor_boundary(read) -> int | None:
    """1-based adaptor boundary (ReadUtils.getAdaptorBoundary) or None."""
    if not _has_well_defined_fragment_size(read):
        return None
    if read.is_reverse:
        return read.mate_pos  # mateStart(1b) - 1 == mate_pos(0b) as 1-based value
    return read.pos + 1 + abs(read.tlen)


def transform_read(read):
    """consolidate cigar; hard-clip adaptor; hard-clip soft clips. Returns a new
    Read (possibly empty -> None)."""
    r = clipping.consolidate_cigar(read)
    boundary = _adaptor_boundary(r)
    if boundary is not None:
        start_1b, end_1b = r.pos + 1, r.end
        if start_1b <= boundary <= end_1b:  # isInsideRead
            if r.is_reverse:
                r = clipping.hard_clip_left_tail_to_ref(r, boundary - 1)
            else:
                r = clipping.hard_clip_right_tail_from_ref(r, boundary - 1)
        if r is None or len(r.bases) == 0:
            return None
    r = clipping.hard_clip_soft_clipped_bases(r)
    if r is None or len(r.bases) == 0 or r.is_unmapped:
        return None
    return r


def calculate_is_snp_or_indel(read, ref_bases: np.ndarray, ref_start: int):
    """(isSNP, isIns, isDel, nErrors) per read offset; ref_bases[read.pos - ref_start]
    is the reference base under the first aligned read base."""
    n = len(read.bases)
    snp = np.zeros(n, np.int32)
    is_ins = np.zeros(n, np.int32)
    is_del = np.zeros(n, np.int32)
    read_pos = 0
    ref_pos = read.pos - ref_start
    neg = read.is_reverse
    for op, ln in zip(read.cigar_ops, read.cigar_lens):
        ln = int(ln)
        if op in (sam.OP_M, sam.OP_EQ, sam.OP_X):
            rb = read.bases[read_pos : read_pos + ln]
            fb = ref_bases[ref_pos : ref_pos + ln]
            idx_r = cov._BASE_INDEX[rb]
            idx_f = cov._BASE_INDEX[fb]
            snp[read_pos : read_pos + ln] = (idx_r != idx_f).astype(np.int32)
            read_pos += ln
            ref_pos += ln
        elif op == sam.OP_D:
            i = read_pos if neg else read_pos - 1
            if 0 <= i < n:
                is_del[i] = 1
            ref_pos += ln
        elif op == sam.OP_N:
            ref_pos += ln
        elif op == sam.OP_I:
            if not neg:
                if 0 <= read_pos - 1 < n:
                    is_ins[read_pos - 1] = 1
            read_pos += ln
            if neg:
                if 0 <= read_pos < n:
                    is_ins[read_pos] = 1
        elif op == sam.OP_S:
            read_pos += ln
        # H and P: nothing
    n_errors = int(snp.sum() + is_ins.sum() + is_del.sum())
    return snp, is_ins, is_del, n_errors


def read_index_for_ref_coord(read, ref_coord_1b: int):
    """(read_index, op) bracketing a 1-based ref coordinate (ReadUtils semantics;
    soft clips consume reference). Returns (None, None) if outside."""
    # soft start in 1-based
    soft_start = read.pos + 1
    for op, ln in zip(read.cigar_ops, read.cigar_lens):
        if op == sam.OP_S:
            soft_start -= int(ln)
        elif op != sam.OP_H:
            break
    if ref_coord_1b < soft_start:
        return None, None
    last_read = 0
    last_ref = soft_start
    for op, ln in zip(read.cigar_ops, read.cigar_lens):
        ln = int(ln)
        first_read, first_ref = last_read, last_ref
        consumes_read = op in (sam.OP_M, sam.OP_EQ, sam.OP_X, sam.OP_I, sam.OP_S)
        consumes_ref = op in (sam.OP_M, sam.OP_EQ, sam.OP_X, sam.OP_D, sam.OP_N, sam.OP_S)
        last_read += ln if consumes_read else 0
        last_ref += ln if consumes_ref else 0
        if first_ref <= ref_coord_1b < last_ref:
            idx = first_read + (ref_coord_1b - first_ref if consumes_read else 0)
            return idx, op
    return None, None


def calculate_known_sites_array(read, known_sites) -> np.ndarray:
    """known_sites: iterable of (start_1b, end_1b). BaseRecalibrationEngine.calculateKnownSites."""
    n = len(read.bases)
    out = np.zeros(n, bool)
    soft_start_1b = read.unclipped_start() + 1  # transformed reads have no soft clips
    soft_end_1b = read.unclipped_end()
    for s, e in known_sites:
        if e < soft_start_1b or s > soft_end_1b:
            continue
        idx, op = read_index_for_ref_coord(read, s)
        start = 0 if idx is None else idx
        if op == sam.OP_D:
            start -= 1
        idx_e, _op_e = read_index_for_ref_coord(read, e)
        end = n if idx_e is None else idx_e
        if start > n:
            start = end = n
        out[max(0, start) : min(n, end + 1)] = True
    return out


def fractional_errors(error_array: np.ndarray, baq_array: np.ndarray | None) -> np.ndarray:
    """Spread errors uniformly over BAQ-uncertainty blocks
    (BaseRecalibrationEngine.calculateFractionalErrorArray)."""
    if baq_array is None:
        return error_array.astype(np.float64)
    n = len(error_array)
    out = np.zeros(n, np.float64)
    in_block = False
    block_start = -1
    for i in range(n):
        if baq_array[i] == baq_mod.NO_BAQ_UNCERTAINTY:
            if not in_block:
                out[i] = error_array[i]
            else:
                lo = max(0, block_start - 1)
                total = error_array[lo : i + 1].sum()
                out[lo : i + 1] = total / (i - lo + 1)
                in_block = False
                block_start = -1
        else:
            in_block = True
            if block_start == -1:
                block_start = i
    if in_block:
        lo = max(0, block_start - 1)
        total = error_array[lo:n].sum()
        out[lo:n] = total / (n - lo)
    return out


class RecalibrationTables:
    """Dense (rg, qual, [covariate,] event) observation/error tensors."""

    def __init__(self, read_groups, args: RecalArgs):
        self.read_groups = list(read_groups)  # ordered identifiers (PU or ID)
        self.rg_index = {rg: i for i, rg in enumerate(self.read_groups)}
        n_rg = len(self.read_groups)
        nq = MAX_SAM_QUAL_SCORE + 1
        self.args = args
        ctx_max = cov.max_context_key(max(args.mismatches_context_size, args.indels_context_size)) + 1
        cyc_max = cov.max_cycle_key(args.maximum_cycle_value) + 1
        self.qual_obs = np.zeros((n_rg, nq, 3), np.int64)
        self.qual_err = np.zeros((n_rg, nq, 3), np.float64)
        self.ctx_obs = np.zeros((n_rg, nq, ctx_max, 3), np.int64)
        self.ctx_err = np.zeros((n_rg, nq, ctx_max, 3), np.float64)
        self.cyc_obs = np.zeros((n_rg, nq, cyc_max, 3), np.int64)
        self.cyc_err = np.zeros((n_rg, nq, cyc_max, 3), np.float64)


class BaseRecalibrationEngine:
    def __init__(self, read_groups, args: RecalArgs | None = None, rg_id_to_identifier=None):
        """read_groups: ordered covariate identifiers (PU if present, else ID);
        rg_id_to_identifier: map from the RG tag on reads to those identifiers."""
        self.args = args or RecalArgs()
        self.tables = RecalibrationTables(read_groups, self.args)
        self.rg_id_map = rg_id_to_identifier or {}
        self.n_reads_processed = 0
        self.finalized = False

    def process_read(self, read, ref_fetch, contig_len: int, known_sites):
        """read: pre-filter Read; ref_fetch(start, end)->uint8 (0-based, half-open);
        known_sites: list of (start_1b, end_1b) overlapping the read."""
        args = self.args
        r = transform_read(read)
        if r is None:
            return
        ref = ref_fetch(r.pos, r.end)
        snp, is_ins, is_del, n_errors = calculate_is_snp_or_indel(r, ref, r.pos)

        if n_errors == 0 or not args.enable_baq:
            baq_array = None  # flat, no uncertainty anywhere
        else:
            baq_quals = baq_mod.baq_read(r, ref_fetch, contig_len, gop=args.baq_gop)
            if baq_quals is None:
                self.n_reads_processed += 1
                return
            # the BQ tag encoding: rawQual - baqQual + 64; 64 == no uncertainty
            baq_array = r.quals.astype(np.int32) - baq_quals.astype(np.int32) + 64

        n = len(r.bases)
        ident = self.rg_id_map.get(r.read_group, r.read_group)
        rg_key = self.tables.rg_index.get(ident)
        if rg_key is None:
            raise KeyError(f"read group {r.read_group} not in header")

        # covariate keys
        m_ctx, i_ctx = cov.read_context_covariate_keys(
            r.bases, r.quals, r.is_reverse,
            args.mismatches_context_size, args.indels_context_size, args.low_quality_tail,
            record_indels=args.compute_indel_tables,
        )
        second = r.is_paired and bool(r.flag & sam.SECOND_OF_PAIR)
        m_cyc = cov.cycle_keys(n, r.is_reverse, second, False, args.maximum_cycle_value)
        quals_m = r.quals.astype(np.int64)
        if args.compute_indel_tables:
            i_cyc = cov.cycle_keys(n, r.is_reverse, second, True, args.maximum_cycle_value)
            bi = r.tags.get("BI")
            bd = r.tags.get("BD")
            quals_i = (np.frombuffer(bi.encode(), np.uint8) - 33 if isinstance(bi, str)
                       else np.full(n, args.insertions_default_quality)).astype(np.int64)
            quals_d = (np.frombuffer(bd.encode(), np.uint8) - 33 if isinstance(bd, str)
                       else np.full(n, args.deletions_default_quality)).astype(np.int64)

        skip = (~_IS_REGULAR_BASE[r.bases]) | (r.quals < MIN_USABLE_QUAL) | calculate_known_sites_array(r, known_sites)
        keep = ~skip
        if not keep.any():
            self.n_reads_processed += 1
            return

        snp_err = fractional_errors(snp, baq_array)
        ins_err = fractional_errors(is_ins, baq_array)
        del_err = fractional_errors(is_del, baq_array)

        t = self.tables
        events = [(EVENT_M, quals_m, snp_err, m_ctx, m_cyc)]
        if args.compute_indel_tables:
            events.append((EVENT_I, quals_i, ins_err, i_ctx, i_cyc))
            events.append((EVENT_D, quals_d, del_err, i_ctx, i_cyc))
        for ev, q, err, ctx, cyc in events:
            qk = q[keep]
            ek = err[keep]
            np.add.at(t.qual_obs, (rg_key, qk, ev), 1)
            np.add.at(t.qual_err, (rg_key, qk, ev), ek)
            ck = ctx[keep]
            cm = ck >= 0
            np.add.at(t.ctx_obs, (rg_key, qk[cm], ck[cm], ev), 1)
            np.add.at(t.ctx_err, (rg_key, qk[cm], ck[cm], ev), ek[cm])
            yk = cyc[keep]
            ym = yk >= 0
            np.add.at(t.cyc_obs, (rg_key, qk[ym], yk[ym], ev), 1)
            np.add.at(t.cyc_err, (rg_key, qk[ym], yk[ym], ev), ek[ym])
        self.n_reads_processed += 1

    # ---------------- finalization & reporting ----------------

    def finalize(self):
        """Collapse qual table into RG table from unrounded values, then round
        half-up like GATK (finalizeData -> roundTableValues)."""
        assert not self.finalized
        t = self.tables
        self.rg_datums = {}
        for rg in range(len(t.read_groups)):
            for ev in range(3):
                combined = None
                for q in range(t.qual_obs.shape[1]):
                    obs = int(t.qual_obs[rg, q, ev])
                    if obs == 0:
                        continue
                    d = RecalDatum(obs, float(t.qual_err[rg, q, ev]), float(q))
                    if combined is None:
                        combined = d
                    else:
                        combined.combine(d)
                if combined is not None:
                    combined.reported_quality = _round_half_up(combined.reported_quality, 4)
                    combined.num_mismatches = _round_half_up(combined.num_mismatches, 2)
                    self.rg_datums[(rg, ev)] = combined
        # MathUtils.roundToNDecimalPlaces is half-up (Math.round), not banker's
        for err in (t.qual_err, t.ctx_err, t.cyc_err):
            err[:] = np.floor(err * 100.0 + 0.5) / 100.0
        self.finalized = True

    def quantization_info(self) -> QuantizationInfo:
        assert self.finalized
        t = self.tables
        hist = [0] * (MAX_SAM_QUAL_SCORE + 1)
        for rg in range(len(t.read_groups)):
            for q in range(t.qual_obs.shape[1]):
                for ev in range(3):
                    obs = int(t.qual_obs[rg, q, ev])
                    if obs == 0:
                        continue
                    d = RecalDatum(obs, float(t.qual_err[rg, q, ev]), float(q))
                    hist[int(d.empirical_quality() + 0.5)] += obs
        return QuantizationInfo(hist, self.args.quantizing_levels)

    def report_tables(self):
        """[RecalTable0, RecalTable1, RecalTable2] as ReportTable objects."""
        assert self.finalized
        t = self.tables
        rt0 = ReportTable("RecalTable0", "", [
            ("ReadGroup", "%s"), ("EventType", "%s"), ("EmpiricalQuality", "%.4f"),
            ("EstimatedQReported", "%.4f"), ("Observations", "%d"), ("Errors", "%.2f")])
        for (rg, ev), d in sorted(self.rg_datums.items()):
            rt0.add_row(t.read_groups[rg], EVENT_TYPES[ev], d.empirical_quality(),
                        d.reported_quality, d.num_observations, d.num_mismatches)

        rt1 = ReportTable("RecalTable1", "", [
            ("ReadGroup", "%s"), ("QualityScore", "%d"), ("EventType", "%s"),
            ("EmpiricalQuality", "%.4f"), ("Observations", "%d"), ("Errors", "%.2f")])
        for rg in range(len(t.read_groups)):
            for q in range(t.qual_obs.shape[1]):
                for ev in range(3):
                    obs = int(t.qual_obs[rg, q, ev])
                    if obs == 0:
                        continue
                    d = RecalDatum(obs, float(t.qual_err[rg, q, ev]), float(q))
                    rt1.add_row(t.read_groups[rg], q, EVENT_TYPES[ev],
                                d.empirical_quality(), obs, d.num_mismatches)

        rt2 = ReportTable("RecalTable2", "", [
            ("ReadGroup", "%s"), ("QualityScore", "%d"), ("CovariateValue", "%s"),
            ("CovariateName", "%s"), ("EventType", "%s"), ("EmpiricalQuality", "%.4f"),
            ("Observations", "%d"), ("Errors", "%.2f")])
        for rg in range(len(t.read_groups)):
            for name, obs_t, err_t, fmt in (
                ("Context", t.ctx_obs, t.ctx_err, cov.context_from_key),
                ("Cycle", t.cyc_obs, t.cyc_err, lambda k: str(cov.cycle_from_key(k))),
            ):
                nz = np.argwhere(obs_t[rg] > 0)
                for q, key, ev in nz:
                    obs = int(obs_t[rg, q, key, ev])
                    d = RecalDatum(obs, float(err_t[rg, q, key, ev]), float(q))
                    rt2.add_row(t.read_groups[rg], int(q), fmt(int(key)), name,
                                EVENT_TYPES[ev], d.empirical_quality(), obs, d.num_mismatches)
        return [rt0, rt1, rt2]

    def write_report(self, path: str):
        qi = self.quantization_info()
        covnames = "ReadGroupCovariate,QualityScoreCovariate,ContextCovariate,CycleCovariate"
        tables = [self.args.report_table(covnames), qi.report_table()] + self.report_tables()
        with open(path, "w") as fh:
            fh.write(render_report(tables))
