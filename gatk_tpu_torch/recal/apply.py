# Copied verbatim from gatk_tpu/recal/apply.py; only import lines may differ.
"""ApplyBQSR: hierarchical Bayesian quality update from a recalibration report.

Reference behavior: transformers/BQSRReadTransformer.java (hierarchical delta
:142-210), utils/recalibration/RecalibrationReport.java (table parsing).
"""
from __future__ import annotations

import numpy as np

from ..io import sam
from . import covariates as cov
from .report import (
    MAX_RECALIBRATED_Q_SCORE,
    MAX_SAM_QUAL_SCORE,
    QuantizationInfo,
    RecalDatum,
    java_round,
    parse_report,
)

EVENT_INDEX = {"M": 0, "I": 1, "D": 2}
PRESERVE_QSCORES_LESS_THAN = 6


class RecalibrationReport:
    """Parsed recal table file (Arguments, Quantized, RecalTable0/1/2)."""

    def __init__(self, path: str):
        import gzip

        with open(path, "rb") as fh:
            raw = fh.read()
        if raw[:2] == b"\x1f\x8b":  # GATK accepts gzipped recal tables
            raw = gzip.decompress(raw)
        tables = {t[0]: t for t in parse_report(raw.decode())}
        self.args = {row[0]: (row[1] if len(row) > 1 else "") for row in tables["Arguments"][3]}
        self.mismatches_context_size = int(self.args.get("mismatches_context_size", 2))
        self.indels_context_size = int(self.args.get("indels_context_size", 3))
        self.low_quality_tail = int(self.args.get("low_quality_tail", 2))
        self.maximum_cycle_value = int(self.args.get("maximum_cycle_value", 500))

        qrows = tables["Quantized"][3]
        self.quantized_counts = [int(r[1]) for r in qrows]
        self.quantized_quals = [int(r[2]) for r in qrows]
        self.quantization_levels = len(set(self.quantized_quals))

        self.rg_table = {}  # (rg, ev) -> RecalDatum
        for rg, ev, emp, est, obs, err in tables["RecalTable0"][3]:
            # empirical quality is recomputed with the hierarchy prior at apply
            # time, NOT read from the file (RecalibrationReport.getRecalDatum:294)
            d = RecalDatum(int(float(obs)), float(err), float(est))
            self.rg_table[(rg, EVENT_INDEX[ev])] = d
        self.read_groups = sorted({k[0] for k in self.rg_table})

        self.qual_table = {}
        for rg, q, ev, emp, obs, err in tables["RecalTable1"][3]:
            d = RecalDatum(int(float(obs)), float(err), float(q))
            self.qual_table[(rg, int(q), EVENT_INDEX[ev])] = d

        self.cov_table = {}
        for rg, q, val, name, ev, emp, obs, err in tables["RecalTable2"][3]:
            key = cov.key_from_context(val) if name == "Context" else _cycle_key(int(val), self.maximum_cycle_value)
            d = RecalDatum(int(float(obs)), float(err), float(q))
            self.cov_table[(rg, int(q), name, key, EVENT_INDEX[ev])] = d


def _cycle_key(cycle: int, max_cycle: int) -> int:
    r = abs(cycle) << 1
    if cycle < 0:
        r |= 1
    return r


def hierarchical_bayesian_quality_estimate(prior_q, rg_datum, qual_datum, special_datums):
    emp_rg = prior_q if rg_datum is None else rg_datum.empirical_quality(prior_q)
    post_q = emp_rg if qual_datum is None else qual_datum.empirical_quality(emp_rg)
    delta = 0.0
    for d in special_datums:
        if d is not None:
            delta += d.empirical_quality(post_q) - post_q
    return post_q + delta


class BQSRReadTransformer:
    def __init__(self, report: RecalibrationReport, quantization_levels: int = 0,
                 global_q_score_prior: float = -1.0, preserve_q_less_than: int = PRESERVE_QSCORES_LESS_THAN,
                 allow_missing_read_groups: bool = False, rg_id_to_identifier=None):
        self.report = report
        self.rg_id_map = rg_id_to_identifier or {}
        # 0 (the GATK default) = no quantization; negative = use the report's
        # map; positive = requantize to that many levels
        if quantization_levels == 0:
            self.quantized_quals = list(range(MAX_SAM_QUAL_SCORE + 1))
        elif quantization_levels > 0 and quantization_levels != report.quantization_levels:
            qi = QuantizationInfo(report.quantized_counts, quantization_levels)
            self.quantized_quals = qi.quantized_quals
        else:
            self.quantized_quals = report.quantized_quals
        self.global_prior = global_q_score_prior
        self.preserve_q_less_than = preserve_q_less_than
        self.allow_missing_read_groups = allow_missing_read_groups
        self._cache = {}

    def apply(self, read):
        """Recalibrate base qualities in place; returns the read."""
        rep = self.report
        rg = self.rg_id_map.get(read.read_group, read.read_group)
        quals = read.quals.copy()
        n = len(quals)
        if rg not in rep.read_groups:
            if self.allow_missing_read_groups:
                read.quals = np.array([self.quantized_quals[q] for q in quals], np.uint8)
                return read
            raise KeyError(f"Read group {rg} not found in the recalibration table")
        rg_datum = rep.rg_table.get((rg, 0))
        prior = self.global_prior if self.global_prior > 0.0 else rg_datum.reported_quality

        m_ctx, _ = cov.read_context_covariate_keys(
            read.bases, read.quals, read.is_reverse,
            rep.mismatches_context_size, rep.indels_context_size, rep.low_quality_tail,
            record_indels=False,
        )
        second = read.is_paired and bool(read.flag & sam.SECOND_OF_PAIR)
        m_cyc = cov.cycle_keys(n, read.is_reverse, second, False, rep.maximum_cycle_value)

        for i in range(n):
            q = int(quals[i])
            if q < self.preserve_q_less_than:
                continue
            cache_key = (rg, q, int(m_ctx[i]), int(m_cyc[i]))
            out = self._cache.get(cache_key)
            if out is None:
                qual_datum = rep.qual_table.get((rg, q, 0))
                specials = [
                    rep.cov_table.get((rg, q, "Context", int(m_ctx[i]), 0)) if m_ctx[i] >= 0 else None,
                    rep.cov_table.get((rg, q, "Cycle", int(m_cyc[i]), 0)) if m_cyc[i] >= 0 else None,
                ]
                raw = hierarchical_bayesian_quality_estimate(prior, rg_datum, qual_datum, specials)
                out = self.quantized_quals[max(1, min(java_round(raw), MAX_RECALIBRATED_Q_SCORE))]
                self._cache[cache_key] = out
            quals[i] = out
        read.quals = quals
        # BI/BD are BQSR-internal; GATK clears them on output
        read.tags.pop("BI", None)
        read.tags.pop("BD", None)
        return read
