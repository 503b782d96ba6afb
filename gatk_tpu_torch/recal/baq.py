# Copied verbatim from gatk_tpu/recal/baq.py; only import lines may differ.
"""BAQ: per-base alignment quality via a banded glocal profile HMM.

Reference behavior: utils/baq/BAQ.java (itself synchronized with samtools;
Heng Li, PMC3072548). Forward-backward over M/I/D states in a band around the
diagonal, per-row rescaling, MAP state posteriors -> phred BAQ, then
cap-by-BAQ against the aligned reference position per cigar.

The per-read DP is small (band width 7 -> 15 diagonals); this host version is
vectorized across the band. Only reads with >=1 mismatch/indel need BAQ
(~15% of typical Illumina reads, BaseRecalibrationEngine.java:132-135).
"""
from __future__ import annotations

import math

import numpy as np

DEFAULT_GOP = 40.0
DEFAULT_BANDWIDTH = 7
EM = 1.0 / 3.0
EI = 0.25
MIN_BASE_QUAL = 4
NO_BAQ_UNCERTAINTY = 64  # '@'

_QUAL2PROB = 10.0 ** (-np.arange(256) / 10.0)

_BASE_EQ = np.zeros((256, 256), bool)
for _a in b"ACGTacgt":
    for _b in b"ACGTacgt":
        _BASE_EQ[_a, _b] = chr(_a).upper() == chr(_b).upper()
_IS_ACGT = np.zeros(256, bool)
for _a in b"ACGTacgt":
    _IS_ACGT[_a] = True


def _epsilon_matrix(ref: np.ndarray, query: np.ndarray, quals: np.ndarray) -> np.ndarray:
    """eps[k, i] = P(query base i | ref base k). 1.0 when either base is non-ACGT."""
    q = np.minimum(np.maximum(quals, MIN_BASE_QUAL), 93)
    perr = _QUAL2PROB[q]
    eq = _BASE_EQ[ref[:, None], query[None, :]]
    eps = np.where(eq, 1.0 - perr[None, :], perr[None, :] * EM)
    bad = ~_IS_ACGT[ref][:, None] | ~_IS_ACGT[query][None, :]
    return np.where(bad, 1.0, eps)


def hmm_glocal(ref: np.ndarray, query: np.ndarray, qstart: int, l_query: int,
               quals: np.ndarray, gop: float = DEFAULT_GOP, gep: float = 0.1,
               bandwidth: int = DEFAULT_BANDWIDTH):
    """Returns (state, bq) int arrays of length len(query); only
    [qstart, qstart+l_query) entries are filled.

    state[i] = (ref_pos << 2) | (1 if insertion); bq[i] = phred posterior of
    state being wrong, in [MIN_BASE_QUAL, 99].
    """
    l_ref = len(ref)
    cd = 10.0 ** (-gop / 10.0)
    ce = gep

    bw = max(l_ref, l_query)
    if bandwidth < abs(l_ref - l_query):
        bw = abs(l_ref - l_query) + 3
    if bw > bandwidth:
        bw = bandwidth
    if bw < abs(l_ref - l_query):
        bw = abs(l_ref - l_query)
    bw2 = bw * 2 + 1

    # band storage: u = set_u(bw, i, k) = (k + 1 - max(i - bw, 0)) * 3; we keep
    # per-row dense arrays over k in [0, l_ref] for simplicity (l_ref is ~200).
    # f/b[i][k][state]; rescaled per row by s[i].
    sM = sI = 1.0 / (2 * l_query + 2)
    bM = (1.0 - cd) / l_ref
    bI = cd / l_ref
    m = np.array([
        [(1 - cd - cd) * (1 - sM), cd * (1 - sM), cd * (1 - sM)],
        [(1 - ce) * (1 - sI), ce * (1 - sI), 0.0],
        [1 - ce, 0.0, ce],
    ])

    eps = _epsilon_matrix(ref, query[qstart : qstart + l_query], quals[qstart : qstart + l_query])

    f = np.zeros((l_query + 1, l_ref + 2, 3))
    b = np.zeros((l_query + 1, l_ref + 2, 3))
    s = np.zeros(l_query + 2)

    ks = np.arange(1, l_ref + 1)

    def band(i):
        lo = max(1, i - bw)
        hi = min(l_ref, i + bw)
        return lo, hi

    # forward
    f[0, 0, 0] = s[0] = 1.0
    lo, hi = 1, min(l_ref, bw + 1)
    e_row = eps[lo - 1 : hi, 0]
    f[1, lo : hi + 1, 0] = e_row * bM
    f[1, lo : hi + 1, 1] = EI * bI
    s[1] = f[1].sum()
    f[1] /= s[1]

    for i in range(2, l_query + 1):
        lo, hi = band(i)
        e_row = eps[lo - 1 : hi, i - 1]
        fprev = f[i - 1]
        mm = fprev[lo - 1 : hi, 0]
        mx = fprev[lo - 1 : hi, 1]
        my = fprev[lo - 1 : hi, 2]
        f[i, lo : hi + 1, 0] = e_row * (m[0, 0] * mm + m[1, 0] * mx + m[2, 0] * my)
        f[i, lo : hi + 1, 1] = EI * (m[0, 1] * fprev[lo : hi + 1, 0] + m[1, 1] * fprev[lo : hi + 1, 1])
        # D state depends on current row at k-1 (horizontal recurrence)
        for k in range(lo, hi + 1):
            f[i, k, 2] = m[0, 2] * f[i, k - 1, 0] + m[2, 2] * f[i, k - 1, 2]
        ssum = f[i, lo : hi + 1].sum()
        s[i] = ssum
        f[i, lo : hi + 1] /= ssum

    s[l_query + 1] = (f[l_query, 1 : l_ref + 1, 0] * sM + f[l_query, 1 : l_ref + 1, 1] * sI).sum()

    # backward
    b[l_query, 1 : l_ref + 1, 0] = sM / s[l_query] / s[l_query + 1]
    b[l_query, 1 : l_ref + 1, 1] = sI / s[l_query] / s[l_query + 1]
    for i in range(l_query - 1, 0, -1):
        lo, hi = band(i)
        y = 1.0 if i > 1 else 0.0
        bnext = b[i + 1]
        # e[k] = eps(ref[k], query[i]) * bnext[k+1, M] for k in [lo, hi]; ref index k (0-based k) valid while k < l_ref
        e_arr = np.zeros(hi - lo + 1)
        kk = np.arange(lo, hi + 1)
        valid = kk < l_ref
        e_arr[valid] = eps[kk[valid], i] * bnext[kk[valid] + 1, 0]
        b[i, lo : hi + 1, 0] = e_arr * m[0, 0] + EI * m[0, 1] * bnext[lo : hi + 1, 1]
        b[i, lo : hi + 1, 1] = e_arr * m[1, 0] + EI * m[1, 1] * bnext[lo : hi + 1, 1]
        for k in range(hi, lo - 1, -1):
            idx = k - lo
            b[i, k, 0] += m[0, 2] * b[i, k + 1, 2]
            b[i, k, 2] = (e_arr[idx] * m[2, 0] + m[2, 2] * b[i, k + 1, 2]) * y
        b[i, lo : hi + 1] /= s[i]

    # MAP per query position
    state = np.zeros(len(query), np.int64)
    bq = np.zeros(len(query), np.uint8)
    for i in range(1, l_query + 1):
        lo, hi = band(i)
        z = f[i, lo : hi + 1, :2] * b[i, lo : hi + 1, :2]
        total = z.sum()
        flat = np.argmax(z)
        k_best = lo + flat // 2
        st_best = flat % 2
        mx = z.flat[flat] / total
        state[qstart + i - 1] = ((k_best - 1) << 2) | st_best
        kq = int(-4.343 * math.log(1.0 - mx) + 0.499) if mx < 1.0 else 99
        bq[qstart + i - 1] = 99 if kq > 100 else (MIN_BASE_QUAL if kq < MIN_BASE_QUAL else kq)
    return state, bq


OP_M, OP_I, OP_D, OP_N, OP_S, OP_H, OP_P, OP_EQ, OP_X = 0, 1, 2, 3, 4, 5, 6, 7, 8


def query_range(cigar_ops, cigar_lens):
    """(query_start, query_stop) excluding soft clips; None on N-ops or fully clipped."""
    q_start = -1
    q_stop = -1
    read_i = 0
    for op, ln in zip(cigar_ops, cigar_lens):
        if op == OP_N:
            return None
        if op in (OP_H, OP_P, OP_D):
            continue
        if op in (OP_I, OP_S, OP_M, OP_EQ, OP_X):
            prev = read_i
            read_i += int(ln)
            if op != OP_S:
                if q_start == -1:
                    q_start = prev
                q_stop = read_i
    if q_stop == -1 or q_stop == q_start:
        return None
    return q_start, q_stop


def calc_baq(read, ref_bases: np.ndarray, ref_offset: int, gop: float = DEFAULT_GOP):
    """BAQ'd quality array for a read vs a reference window starting at
    read.pos - ref_offset... i.e. ref_bases[ref_offset] aligns with read.pos.
    Returns None if the read can't be BAQ'd (N cigar ops, clipped away).
    """
    qr = query_range(read.cigar_ops, read.cigar_lens)
    if qr is None:
        return None
    q_start, q_stop = qr
    state, bq_arr = hmm_glocal(ref_bases, read.bases, q_start, q_stop - q_start, read.quals, gop=gop)

    raw = read.quals
    bq = np.empty(len(raw), np.uint8)
    bq[:] = raw
    read_i = 0
    ref_i = 0
    for op, ln in zip(read.cigar_ops, read.cigar_lens):
        ln = int(ln)
        if op == OP_N:
            return None
        if op in (OP_H, OP_P):
            continue
        if op == OP_S:
            bq[read_i : read_i + ln] = raw[read_i : read_i + ln]
            ref_i += ln
            read_i += ln
        elif op == OP_I:
            bq[read_i : read_i + ln] = raw[read_i : read_i + ln]
            read_i += ln
        elif op == OP_D:
            ref_i += ln
        elif op in (OP_M, OP_EQ, OP_X):
            for i in range(read_i, read_i + ln):
                expected_pos = ref_i - ref_offset + (i - read_i)
                st = state[i]
                is_indel = (st & 3) != 0
                pos = st >> 2
                if is_indel or pos != expected_pos:
                    bq[i] = MIN_BASE_QUAL
                else:
                    bq[i] = min(bq_arr[i], raw[i])
            read_i += ln
            ref_i += ln
        else:
            raise ValueError(f"unsupported cigar op {op}")
    if read_i != len(raw):
        return raw.copy()
    return bq


def reference_window(read, bandwidth: int = DEFAULT_BANDWIDTH):
    """(start, end) 0-based half-open reference span BAQ needs for this read
    (BAQ.getReferenceWindowForRead)."""
    offset = bandwidth // 2
    # ReadUtils.getFirst/LastInsertionOffset look at the literally-first/last element
    first_ins = int(read.cigar_lens[0]) if len(read.cigar_ops) and read.cigar_ops[0] == OP_I else 0
    last_ins = int(read.cigar_lens[-1]) if len(read.cigar_ops) and read.cigar_ops[-1] == OP_I else 0
    start = max(read.pos - offset - first_ins, 0)
    end = read.end + offset + last_ins
    return start, end


def baq_read(read, ref_fetch, contig_len: int, gop: float = DEFAULT_GOP):
    """Full-read BAQ quality array, or None if excluded/uncomputable.

    ref_fetch(start, end) -> uint8 reference bases (0-based half-open).
    """
    if read.is_unmapped or read.fails_vendor_quality or read.is_duplicate:
        return None
    start, end = reference_window(read)
    if end > contig_len:
        return None
    ref = ref_fetch(start, end)
    return calc_baq(read, ref, start - read.pos, gop=gop)
