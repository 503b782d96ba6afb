# Copied verbatim from gatk_tpu/engine/clipping.py; only import lines may differ.
"""Read clipping (utils/clipping/ReadClipper + ClippingOp equivalents).

Reference behavior: utils/clipping/ReadClipper.java — hard-clip both ends to a
region, revert soft clips, clip low-quality tails — as used by
AssemblyBasedCallerUtils.finalizeRegion (haplotypecaller/AssemblyBasedCallerUtils.java:124).

All operations return new Read objects; coordinates stay consistent with the cigar
(hard clips remove bases and adjust alignment start).
"""
from __future__ import annotations

import numpy as np

from ..io import sam
from ..io.reads import Read


def _rebuild(read: Read, new_ops, new_lens, new_start, new_bases, new_quals) -> Read:
    ops = np.asarray(new_ops, np.uint8)
    lens = np.asarray(new_lens, np.int32)
    keep = lens > 0
    return Read.make(
        read.name, read.flag, read.ref_id, new_start, read.mapq,
        ops[keep], lens[keep], np.asarray(new_bases, np.uint8),
        np.asarray(new_quals, np.uint8), read.mate_ref_id, read.mate_pos,
        read.tlen, dict(read.tags))


def _read_coord_of_ref(read: Read, ref_pos: int, left: bool) -> int:
    """Read-offset corresponding to a reference position.

    For clipping the left side, returns the first read index at or after ref_pos;
    for the right side, the last read index at or before ref_pos.
    """
    cur_ref = read.pos
    cur_read = 0
    result = 0 if left else len(read.bases) - 1
    for op, ln in zip(read.cigar_ops, read.cigar_lens):
        ln = int(ln)
        cr = sam.CONSUMES_READ[op]
        cf = sam.CONSUMES_REF[op]
        if cf and cr:
            if cur_ref <= ref_pos < cur_ref + ln:
                return cur_read + (ref_pos - cur_ref)
            cur_ref += ln
            cur_read += ln
        elif cf:
            if cur_ref <= ref_pos < cur_ref + ln:
                # position falls in a deletion: clip at the boundary
                return cur_read if left else cur_read - 1
            cur_ref += ln
        elif cr:
            cur_read += ln
    return len(read.bases) if left else len(read.bases) - 1


def hard_clip_by_read_coords(read: Read, start: int, stop: int) -> Read:
    """Remove read bases in [start, stop] (inclusive, read coordinates)."""
    n = len(read.bases)
    if start == 0 and stop == n - 1:
        # fully clipped: return an empty read
        return _rebuild(read, [], [], read.pos, np.empty(0, np.uint8), np.empty(0, np.uint8))
    if start == 0:
        return _clip_left(read, stop + 1)
    return _clip_right(read, start)


def _expand_cigar(read: Read):
    """Per-base cigar op array for read bases, plus ref offsets consumed before each."""
    ops = []
    for op, ln in zip(read.cigar_ops, read.cigar_lens):
        if sam.CONSUMES_READ[op]:
            ops.extend([int(op)] * int(ln))
    return np.array(ops, np.uint8)


def _collapse(ops_per_base, lead_ops=None, tail_ops=None):
    """Collapse per-base ops into (ops, lens); lead/tail_ops are (op, len) extras."""
    out_ops, out_lens = [], []
    if lead_ops:
        for o, l in lead_ops:
            if l > 0:
                out_ops.append(o)
                out_lens.append(l)
    for op in ops_per_base:
        if out_ops and out_ops[-1] == op:
            out_lens[-1] += 1
        else:
            out_ops.append(int(op))
            out_lens.append(1)
    if tail_ops:
        for o, l in tail_ops:
            if l > 0:
                out_ops.append(o)
                out_lens.append(l)
    return out_ops, out_lens


def _clip_left(read: Read, n_bases: int) -> Read:
    """Hard-clip the first n_bases read bases (adjusting start by ref consumed)."""
    ref_consumed = 0
    read_consumed = 0
    new_ops, new_lens = [], []
    started = False
    for op, ln in zip(read.cigar_ops, read.cigar_lens):
        ln = int(ln)
        op = int(op)
        if started:
            new_ops.append(op)
            new_lens.append(ln)
            continue
        cr = sam.CONSUMES_READ[op]
        cf = sam.CONSUMES_REF[op]
        if cr:
            if read_consumed + ln <= n_bases:
                read_consumed += ln
                if cf:
                    ref_consumed += ln
                continue
            take = n_bases - read_consumed
            read_consumed = n_bases
            if cf:
                ref_consumed += take
            if ln - take > 0:
                new_ops.append(op)
                new_lens.append(ln - take)
            started = True
        else:
            if read_consumed < n_bases or not started:
                # leading D/N consumed entirely while clipping; H/P dropped
                if cf:
                    ref_consumed += ln
                continue
    # drop leading deletions left at the start
    while new_ops and not sam.CONSUMES_READ[new_ops[0]]:
        if sam.CONSUMES_REF[new_ops[0]]:
            ref_consumed += new_lens[0]
        new_ops.pop(0)
        new_lens.pop(0)
    return _rebuild(
        read, new_ops, new_lens, read.pos + ref_consumed,
        read.bases[n_bases:], read.quals[n_bases:],
    )


def _clip_right(read: Read, first_clipped: int) -> Read:
    """Hard-clip read bases from index first_clipped to the end."""
    n_keep = first_clipped
    read_consumed = 0
    new_ops, new_lens = [], []
    for op, ln in zip(read.cigar_ops, read.cigar_lens):
        ln = int(ln)
        op = int(op)
        cr = sam.CONSUMES_READ[op]
        if cr:
            if read_consumed >= n_keep:
                break
            take = min(ln, n_keep - read_consumed)
            read_consumed += take
            new_ops.append(op)
            new_lens.append(take)
            if take < ln:
                break
        else:
            if read_consumed >= n_keep:
                break
            new_ops.append(op)
            new_lens.append(ln)
    # drop trailing deletions
    while new_ops and not sam.CONSUMES_READ[new_ops[-1]]:
        new_ops.pop()
        new_lens.pop()
    return _rebuild(read, new_ops, new_lens, read.pos, read.bases[:n_keep], read.quals[:n_keep])


def hard_clip_to_interval(read: Read, start: int, end: int) -> Read:
    """Hard-clip bases aligned outside [start, end) (ReadClipper.hardClipToRegion)."""
    r = read
    # fast path: single-M cigar (the common shape after finalize) — a pure slice
    if len(r.cigar_ops) == 1 and r.cigar_ops[0] == sam.OP_M:
        n = len(r.bases)
        lo = start - r.pos if r.pos < start else 0
        hi = end - r.pos if r.pos + n > end else n
        if lo <= 0 and hi >= n:
            return r
        if hi <= lo:
            return _rebuild(r, [], [], r.pos, np.empty(0, np.uint8),
                            np.empty(0, np.uint8))
        return Read.make(r.name, r.flag, r.ref_id, r.pos + lo, r.mapq,
                         np.zeros(1, np.uint8), np.array([hi - lo], np.int32),
                         r.bases[lo:hi].copy(), r.quals[lo:hi].copy(),
                         r.mate_ref_id, r.mate_pos, r.tlen, dict(r.tags))
    if r.pos < start:
        cut = _read_coord_of_ref(r, start, left=True)
        if cut > 0:
            r = _clip_left(r, cut)
    if len(r.bases) and r.end > end:
        cut = _read_coord_of_ref(r, end - 1, left=False)
        if cut < len(r.bases) - 1:
            r = _clip_right(r, cut + 1)
    return r


def clip_to_interval_inplace(read: Read, start: int, end: int) -> Read | None:
    """hard_clip_to_interval for PRIVATE reads (single-owner copies, e.g. the
    post-trim re-clip of finalized region reads): single-M reads are clipped by
    mutating pos/cigar and re-slicing bases/quals as views — no Read.make, no
    tag-dict copy. Complex cigars fall back to the immutable path. Returns None
    when fully clipped."""
    r = read
    if len(r.cigar_ops) == 1 and r.cigar_ops[0] == sam.OP_M:
        n = len(r.bases)
        lo = start - r.pos if r.pos < start else 0
        hi = end - r.pos if r.pos + n > end else n
        if lo <= 0 and hi >= n:
            return r
        if hi <= lo:
            return None
        r.bases = r.bases[lo:hi]
        r.quals = r.quals[lo:hi]
        r.cigar_lens = np.array([hi - lo], np.int32)
        r.pos = r.pos + lo
        return r
    r = hard_clip_to_interval(r, start, end)
    return r if len(r.bases) > 0 and r.pos < r.end else None


def revert_soft_clipped_bases(read: Read) -> Read:
    """Turn soft clips into aligned M bases (ReadClipper.revertSoftClippedBases).

    The alignment start moves left by the leading soft-clip length, but never
    before position 0 (htsjdk clips at contig start via extra soft clip — here we
    keep the soft clip if reverting would go negative).
    """
    n_ops = len(read.cigar_ops)
    if n_ops == 0:
        return read
    if read.cigar_ops[0] != sam.OP_S and read.cigar_ops[n_ops - 1] != sam.OP_S:
        return read  # fast path: nothing to revert
    ops = list(read.cigar_ops)
    lens = list(read.cigar_lens)
    new_start = read.pos
    if ops[0] == sam.OP_S:
        if read.pos - int(lens[0]) >= 0:
            new_start = read.pos - int(lens[0])
            ops[0] = sam.OP_M
    if ops and ops[-1] == sam.OP_S:
        ops[-1] = sam.OP_M
    # merge adjacent M
    m_ops, m_lens = [], []
    for o, l in zip(ops, lens):
        if m_ops and m_ops[-1] == o:
            m_lens[-1] += int(l)
        else:
            m_ops.append(int(o))
            m_lens.append(int(l))
    return _rebuild(read, m_ops, m_lens, new_start, read.bases, read.quals)


def hard_clip_soft_clipped_bases(read: Read) -> Read:
    """Remove soft-clipped bases entirely (ReadClipper.hardClipSoftClippedBases)."""
    r = read
    ops = r.cigar_ops
    lens = r.cigar_lens
    if len(ops) == 0:
        return r
    if ops[-1] == sam.OP_S:
        r = _clip_right(r, len(r.bases) - int(lens[-1]))
    ops = r.cigar_ops
    lens = r.cigar_lens
    if len(ops) and ops[0] == sam.OP_S:
        r = _clip_left(r, int(lens[0]))
    return r


def hard_clip_low_qual_ends(read: Read, min_qual: int) -> Read:
    """Clip trailing/leading bases with qual <= min_qual (clipLowQualEnds)."""
    q = np.asarray(read.quals)
    n = len(q)
    if n == 0:
        return read
    # vectorized end scan (the per-base python loop dominated finalizeRegion)
    if q[0] > min_qual and q[n - 1] > min_qual:
        return read
    ok = q > min_qual
    if not ok.any():
        lo, hi = 0, -1
    else:
        lo = int(np.argmax(ok))
        hi = n - 1 - int(np.argmax(ok[::-1]))
    if lo == 0 and hi == n - 1:
        return read
    if lo > hi:
        return _rebuild(read, [], [], read.pos, np.empty(0, np.uint8), np.empty(0, np.uint8))
    r = read
    if hi < n - 1:
        r = _clip_right(r, hi + 1)
    if lo > 0:
        r = _clip_left(r, lo)
    return r


def consolidate_cigar(read: Read) -> Read:
    """Collapse zero-length and repeated adjacent cigar elements (CigarBuilder.make)."""
    ops, lens = [], []
    for o, l in zip(read.cigar_ops, read.cigar_lens):
        l = int(l)
        if l == 0:
            continue
        if ops and ops[-1] == int(o):
            lens[-1] += l
        else:
            ops.append(int(o))
            lens.append(l)
    if len(ops) == len(read.cigar_ops) and all(
        int(a) == b for a, b in zip(read.cigar_ops, ops)
    ):
        return read
    return _rebuild(read, ops, lens, read.pos, read.bases, read.quals)


def hard_clip_left_tail_to_ref(read: Read, ref_stop: int) -> Read:
    """Hard-clip the left tail through 0-based reference position ref_stop
    inclusive (ReadClipper.hardClipByReferenceCoordinatesLeftTail)."""
    idx = _read_coord_of_ref(read, ref_stop, left=False)
    if idx < 0:
        return read
    return hard_clip_by_read_coords(read, 0, idx)


def hard_clip_right_tail_from_ref(read: Read, ref_start: int) -> Read:
    """Hard-clip the right tail from 0-based reference position ref_start
    inclusive (ReadClipper.hardClipByReferenceCoordinatesRightTail)."""
    idx = _read_coord_of_ref(read, ref_start, left=True)
    if idx >= len(read.bases):
        return read
    return hard_clip_by_read_coords(read, idx, len(read.bases) - 1)
