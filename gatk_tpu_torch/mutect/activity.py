# Copied verbatim from gatk_tpu/mutect/activity.py; only import lines and the tracer's decorator lines (utils/trace.py) differ.
"""Mutect2 active-region detection.

Reference behavior: mutect/Mutect2Engine.java isActive :465-542 (pileup qual
buffers :700-780, indel quals :600-604, soft-clip adjacency :680-686), with the
activity profile band-pass shared with HaplotypeCaller.
"""
from __future__ import annotations

import numpy as np

from ..engine import activity as hc_activity
from ..io import sam
from ..utils import trace
from .somatic_likelihoods import log_likelihood_ratio

MINIMUM_BASE_QUALITY = 6
INDEL_START_QUAL = 30
INDEL_CONTINUATION_QUAL = 10
MIN_QUESTIONABLE_INDEL_LENGTH = 70
MIN_LONG_INDEL_COUNT = 5
IDX_OTHER_SUB = 4
IDX_INDEL = 5

_BASE_IDX = np.full(256, -1, np.int32)
for _i, _b in enumerate(b"ACGT"):
    _BASE_IDX[_b] = _i
    _BASE_IDX[_b + 32] = _i


def _indel_qual(indel_length: int) -> int:
    return min(INDEL_START_QUAL + (indel_length - 1) * INDEL_CONTINUATION_QUAL, 127)


def expand_read_m2(read, span_start: int, span_end: int, pcr_snv_qual: int):
    """Per-covered-reference-position (pos, bucket, qual) triples for the M2
    pileup qual buffers. bucket: 0-3 base substitution, 4 other sub, 5 indel,
    -1 ref/uninformative. Substitution entries are emitted with base index;
    ref-matching is resolved later against the reference."""
    ops, lens = read.cigar_ops, read.cigar_lens
    n_ref = sam.cigar_ref_length(ops, lens)
    out_pos = np.empty(n_ref, np.int64)
    out_kind = np.empty(n_ref, np.int8)  # 0 sub-candidate, 1 indel, 2 deletion-continuation
    out_base = np.zeros(n_ref, np.uint8)
    out_qual = np.zeros(n_ref, np.int16)
    out_dlen = np.zeros(n_ref, np.int32)  # for deletions: element length

    mate_start = read.mate_pos if (read.is_paired and not read.mate_is_unmapped
                                   and (read.flag & 0x2)) else None

    out = 0
    read_i = 0
    ref_i = read.pos
    ncig = len(ops)
    for k in range(ncig):
        op = int(ops[k])
        ln = int(lens[k])
        if op in (sam.OP_M, sam.OP_EQ, sam.OP_X):
            next_op = int(ops[k + 1]) if k + 1 < ncig else -1
            next_len = int(lens[k + 1]) if k + 1 < ncig else 0
            prev_op = int(ops[k - 1]) if k > 0 else -1
            for j in range(ln):
                pos = ref_i + j
                if pos < span_start or pos >= span_end:
                    continue
                ri = read_i + j
                q = int(read.quals[ri])
                # indel immediately following this base?
                if j == ln - 1 and next_op in (sam.OP_I, sam.OP_D):
                    out_pos[out] = pos
                    out_kind[out] = 1
                    out_dlen[out] = next_len
                    out += 1
                    continue
                # next to a useful soft clip?
                near_sc = False
                if q > MINIMUM_BASE_QUALITY:
                    if j == ln - 1 and next_op == sam.OP_S and ri + 1 < len(read.quals) and int(read.quals[ri + 1]) > MINIMUM_BASE_QUALITY:
                        near_sc = True
                    elif j == 0 and prev_op == sam.OP_S and ri - 1 >= 0 and int(read.quals[ri - 1]) > MINIMUM_BASE_QUALITY:
                        near_sc = True
                if near_sc:
                    out_pos[out] = pos
                    out_kind[out] = 1
                    out_dlen[out] = 1
                    out += 1
                    continue
                if q > MINIMUM_BASE_QUALITY:
                    if mate_start is not None and mate_start <= pos < mate_start + len(read.bases):
                        q = min(q, pcr_snv_qual // 2)
                    out_pos[out] = pos
                    out_kind[out] = 0
                    out_base[out] = read.bases[ri]
                    out_qual[out] = q
                    out += 1
            read_i += ln
            ref_i += ln
        elif op == sam.OP_D:
            for j in range(ln):
                pos = ref_i + j
                if span_start <= pos < span_end:
                    out_pos[out] = pos
                    out_kind[out] = 2
                    out_dlen[out] = ln
                    out += 1
            ref_i += ln
        elif op == sam.OP_N:
            ref_i += ln
        elif op in (sam.OP_I, sam.OP_S):
            read_i += ln

    return out_pos[:out], out_kind[:out], out_base[:out], out_qual[:out], out_dlen[:out]


def compute_m2_activity(reads, span_start, span_end, ref_span, initial_log_odds: float,
                        pcr_snv_qual: int = 40):
    """Per-position activity probabilities (0/1) over [span_start, span_end)."""
    n = span_end - span_start
    probs = np.zeros(n)
    if not reads:
        return probs, np.zeros(n)

    # collect all pileup entries
    cols_sub = {}  # pos -> list of (base_idx/other, qual)
    cols_indel = {}
    depth = np.zeros(n, np.int64)
    for read in reads:
        p, kind, base, qual, dlen = expand_read_m2(read, span_start, span_end, pcr_snv_qual)
        for i in range(len(p)):
            pos = int(p[i]) - span_start
            depth[pos] += 1
            if kind[i] == 0:
                cols_sub.setdefault(pos, []).append((int(base[i]), int(qual[i])))
            elif kind[i] == 1:
                cols_indel.setdefault(pos, []).append(_indel_qual(int(dlen[i])))
            else:  # deletion continuation
                if dlen[i] > MIN_QUESTIONABLE_INDEL_LENGTH:
                    cols_indel.setdefault(pos, []).append(_indel_qual(2))
                else:
                    cols_indel.setdefault(pos, []).append(_indel_qual(int(dlen[i])))

    for pos in range(n):
        ref_base = int(ref_span[pos])
        buffers = [[] for _ in range(6)]
        for b, q in cols_sub.get(pos, ()):
            if b == ref_base or (b | 32) == (ref_base | 32):
                continue
            idx = int(_BASE_IDX[b])
            if idx == -1:
                buffers[IDX_OTHER_SUB].append(q)
            else:
                buffers[idx].append(q)
        buffers[IDX_INDEL] = list(cols_indel.get(pos, ()))
        sums = [sum(b) for b in buffers]
        best = int(np.argmax(sums))
        if sums[best] == 0:
            continue
        alt_quals = buffers[best]
        log_odds = log_likelihood_ratio(int(depth[pos]) - len(alt_quals), alt_quals)
        if log_odds > initial_log_odds:
            probs[pos] = 1.0
    return probs, np.zeros(n)


@trace.stage("m2_activity")
def find_active_regions(reads, span_start, span_end, ref_span, contig_len,
                        initial_log_odds: float, pcr_snv_qual: int = 40):
    """Activity -> band-pass -> region segmentation (shared HC machinery)."""
    probs, sc = compute_m2_activity(reads, span_start, span_end, ref_span,
                                    initial_log_odds, pcr_snv_qual)
    smoothed = hc_activity.band_pass(probs, sc, (span_start, contig_len))
    return hc_activity.pop_regions(smoothed)
