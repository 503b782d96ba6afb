"""The read side of the PairHMM's pairs, worked out again from the reads the
benchmark generated: what the plain PairHMM is given in place of the read
tables the program packed, and a count of the packed reads that differ.

Each sampled read is found among the generated reads by its first K bases
and then by all of them (the program's reads are the generated ones, clipped
to a region), the source being the one whose base qualities agree best.
Its tables are then made from the source by GATK's rules for the PairHMM's
inputs: base qualities capped at the mapping quality and those under 18 set
to 6; insertion and deletion gap-open qualities of 45 capped by the PCR
indel model (CONSERVATIVE) over the read's tandem repeats; gap continuation
10. Where the read's mate covers the same haplotype bases, GATK caps a base
quality at 20, or sets it to 0 where the mates disagree
(FragmentUtils.adjustQualsOfOverlappingPairedFragments): there, within
OVERLAP_SLACK bases of the overlap, any of those values is admitted and the
program's is taken. A read of fewer than K bases is not looked for; its
tables are taken as packed, and counted.

Frozen copy of the rules of gatk_tpu_torch/calling/read_prep.py
(pcr_error_cache, find_tandem_repeat_length; PairHMMLikelihoodCalculationEngine
.java:283-375 and findTandemRepeatUnits) as of the port's first benchmark. It
imports nothing of the program.
"""
from __future__ import annotations

import math

import numpy as np
import torch

K = 12
OVERLAP_SLACK = 4
GCP = 10
GOP = 45
BASE_QUALITY_SCORE_THRESHOLD = 18
MIN_USABLE_Q = 6
HALF_PCR_SNV_QUAL = 20
MIN_ADJUSTED_QSCORE = 10
INITIAL_QSCORE = 40.0
MAX_STR_UNIT_LENGTH = 8
MAX_REPEAT_LENGTH = 20
CONSERVATIVE_RATE_FACTOR = 3.0

_CODE = np.zeros(256, np.uint32)
_CODE[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4, dtype=np.uint32)


def pcr_error_cache(rate_factor=CONSERVATIVE_RATE_FACTOR):
    i = np.arange(MAX_REPEAT_LENGTH + 1, dtype=np.float64)
    q = np.floor(INITIAL_QSCORE - np.exp(i / (rate_factor * math.pi)) + 1.0 + 0.5)
    return np.maximum(MIN_ADJUSTED_QSCORE, q).astype(np.uint8)


def _num_repetitions(unit, s, leading):
    ul, n, count = len(unit), len(s), 0
    if leading:
        start = 0
        while start + ul <= n and s[start : start + ul] == unit:
            count += 1
            start += ul
    else:
        end = n
        while end - ul >= 0 and s[end - ul : end] == unit:
            count += 1
            end -= ul
    return count


def find_tandem_repeat_length(bases, offset):
    """The repeat length at `offset` of `bases` (findTandemRepeatUnits' maxRL)."""
    best_bw_unit = bases[offset : offset + 1]
    max_bw = 0
    for ul in range(1, MAX_STR_UNIT_LENGTH + 1):
        if offset + 1 - ul < 0:
            break
        unit = bases[offset - ul + 1 : offset + 1]
        max_bw = _num_repetitions(unit, bases[: offset + 1], leading=False)
        if max_bw > 1:
            best_bw_unit = unit
            break
    max_rl = max_bw
    if offset < len(bases) - 1:
        best_fw_unit = bases[offset + 1 : offset + 2]
        max_fw = 0
        for ul in range(1, MAX_STR_UNIT_LENGTH + 1):
            if offset + ul + 1 > len(bases):
                break
            unit = bases[offset + 1 : offset + 1 + ul]
            max_fw = _num_repetitions(unit, bases[offset + 1 :], leading=True)
            if max_fw > 1:
                best_fw_unit = unit
                break
        if best_fw_unit == best_bw_unit:
            max_rl = max_bw + max_fw
        else:
            max_rl = max_fw + _num_repetitions(best_fw_unit, bases[: offset + 1], leading=False)
    return min(max_rl, MAX_REPEAT_LENGTH)


def gap_open_quals(bases):
    """(n,) insertion (= deletion) gap-open qualities of a read: 45 capped
    by the PCR model at every base but the last, at least 6."""
    cache = pcr_error_cache()
    n = len(bases)
    caps = np.full(n, 255, np.int64)
    for i in range(n - 1):
        caps[i] = cache[find_tandem_repeat_length(bases, i)]
    return np.maximum(np.minimum(GOP, caps), MIN_USABLE_Q).astype(np.uint8)


def _threshold(q, mapq):
    q = np.minimum(q.astype(np.int64), mapq)
    return np.where(q < BASE_QUALITY_SCORE_THRESHOLD, MIN_USABLE_Q, q)


class ReadIndex:
    """Every K-mer of every generated read, sorted: (code, row, offset)."""

    def __init__(self, bases):
        n, L = bases.shape
        codes = _CODE[bases]
        width = L - K + 1
        key = np.zeros((n, width), np.uint32)
        for i in range(K):
            key = (key << np.uint32(2)) | codes[:, i : i + width]
        key = key.reshape(-1)
        order = np.argsort(key, kind="stable")
        self.key = key[order]
        self.row = (order // width).astype(np.int64)
        self.off = (order % width).astype(np.int64)

    def candidates(self, bases):
        code = np.uint32(0)
        for b in _CODE[np.frombuffer(bytes(bases[:K]), np.uint8)]:
            code = (code << np.uint32(2)) | b
        lo, hi = np.searchsorted(self.key, [code, code + np.uint32(1)])  # 2K bits: no overflow
        return self.row[lo:hi], self.off[lo:hi]


def _rebuild_one(index, reads, rb, rq, mapq):
    """(found, rq, iq, dq) of one packed read (bases rb, base qualities rq):
    found is None for a read too short to look for, False where no
    generated read holds it."""
    n = len(rb)
    if n < K:
        return None, None, None, None
    rows, offs = index.candidates(rb)
    L = reads["bases"].shape[1]
    fits = offs + n <= L
    rows, offs = rows[fits], offs[fits]
    if not len(rows):
        return False, None, None, None
    span = offs[:, None] + np.arange(n)[None, :]
    same = (reads["bases"][rows[:, None], span] == rb[None, :]).all(axis=1)
    rows, offs, span = rows[same], offs[same], span[same]
    if not len(rows):
        return False, None, None, None
    raw = reads["quals"][rows[:, None], span].astype(np.int64)
    want = _threshold(raw, mapq)
    at = reads["hap_start"][rows][:, None] + span
    m0 = reads["hap_start"][reads["mate"][rows]][:, None]
    zone = (at >= m0 - OVERLAP_SLACK) & (at < m0 + L + OVERLAP_SLACK)
    admitted = zone & ((rq == want) | (rq == MIN_USABLE_Q)
                       | (rq == _threshold(np.minimum(raw, HALF_PCR_SNV_QUAL), mapq)))
    # the source: the read that explains the most qualities, then the one
    # whose qualities agree the most
    explained = ((rq == want) | admitted).sum(axis=1)
    agree = (rq == want).sum(axis=1)
    k = int(np.lexsort((-agree, -explained))[0])
    want = np.where(admitted[k], rq, want[k])
    gop = gap_open_quals(bytes(rb))
    return True, want.astype(np.uint8), gop, gop


def rebuild(sample, pairs, mapq):
    """The sampled pairs with their read side worked out again from the
    sample's reads (all of mapping quality `mapq`), and counts: reads looked for and found (`rebuilt`), too
    short to look for (`short`), and packed reads that differ from what was
    worked out, or were not found (`mismatched`), each read counted once."""
    reads = sample.reads
    index = ReadIndex(reads["bases"])
    out = {k: v.clone() for k, v in pairs.items()}
    rlen = pairs["rlen"].numpy()
    np_ = {k: pairs[k].numpy() for k in ("rb", "rq", "iq", "dq", "gcp")}
    seen = {}
    counts = dict(rebuilt=0, short=0, mismatched=0)
    for p in range(len(rlen)):
        n = int(rlen[p])
        rb, rq = np_["rb"][p, :n], np_["rq"][p, :n]
        key = (rb.tobytes(), rq.tobytes())
        if key not in seen:
            found, want, iq, dq = _rebuild_one(index, reads, rb, rq, mapq)
            if found is None:
                counts["short"] += 1
            elif not found:
                counts["mismatched"] += 1
            else:
                counts["rebuilt"] += 1
                bad = (not np.array_equal(want, rq) or not np.array_equal(iq, np_["iq"][p, :n])
                       or not np.array_equal(dq, np_["dq"][p, :n])
                       or not (np_["gcp"][p, :n] == GCP).all())
                counts["mismatched"] += bad
            seen[key] = (found, want, iq, dq)
        found, want, iq, dq = seen[key]
        if found:
            out["rq"][p, :n] = torch.from_numpy(want)
            out["iq"][p, :n] = torch.from_numpy(iq)
            out["dq"][p, :n] = torch.from_numpy(dq)
            out["gcp"][p, :n] = GCP
    return out, counts
