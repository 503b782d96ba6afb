# Copied verbatim from gatk_tpu/engine/pileup.py; only import lines may differ.
"""Pileup construction as dense arrays (LocusIteratorByState replacement).

Reference behavior: utils/pileup/PileupElement.java (adjacency flags),
utils/locusiterator/. Instead of streaming per-locus object pileups, each read is
expanded once into (ref_pos, base, qual, flags) element arrays; per-locus statistics
are then scatter-adds over a shard-relative coordinate — the form that maps onto TPU
histogram kernels and vectorized activity computation.
"""
from __future__ import annotations

import numpy as np

from ..io import sam
from ..io.reads import Read

# element flag bits
F_DELETION = 1
F_BEFORE_DELETION = 2
F_AFTER_DELETION = 4
F_BEFORE_INSERTION = 8
F_AFTER_INSERTION = 16
F_NEXT_TO_SOFTCLIP = 32

DELETION_BASE = ord("-")


def expand_read(read: Read):
    """Expand a read into per-reference-position pileup elements.

    Returns (ref_pos, base, qual, flags) int/uint8 arrays covering every reference
    position the alignment consumes (M/=/X bases and D positions).
    """
    n_ref = sam.cigar_ref_length(read.cigar_ops, read.cigar_lens)
    ref_pos = np.empty(n_ref, np.int64)
    base = np.empty(n_ref, np.uint8)
    qual = np.empty(n_ref, np.uint8)
    flags = np.zeros(n_ref, np.uint8)

    ops = read.cigar_ops
    lens = read.cigar_lens
    ncig = len(ops)
    out = 0
    read_i = 0
    ref_i = read.pos
    for k in range(ncig):
        op = int(ops[k])
        ln = int(lens[k])
        if op in (sam.OP_M, sam.OP_EQ, sam.OP_X):
            sl = slice(out, out + ln)
            ref_pos[sl] = np.arange(ref_i, ref_i + ln)
            base[sl] = read.bases[read_i : read_i + ln]
            qual[sl] = read.quals[read_i : read_i + ln]
            # adjacency flags on first/last base of this aligned block
            prev_op = int(ops[k - 1]) if k > 0 else -1
            next_op = int(ops[k + 1]) if k < ncig - 1 else -1
            if prev_op == sam.OP_D:
                flags[out] |= F_AFTER_DELETION
            if prev_op == sam.OP_I:
                flags[out] |= F_AFTER_INSERTION
            if prev_op == sam.OP_S:
                flags[out] |= F_NEXT_TO_SOFTCLIP
            if next_op == sam.OP_D:
                flags[out + ln - 1] |= F_BEFORE_DELETION
            if next_op == sam.OP_I:
                flags[out + ln - 1] |= F_BEFORE_INSERTION
            if next_op == sam.OP_S:
                flags[out + ln - 1] |= F_NEXT_TO_SOFTCLIP
            out += ln
            read_i += ln
            ref_i += ln
        elif op == sam.OP_D or op == sam.OP_N:
            if op == sam.OP_D:
                sl = slice(out, out + ln)
                ref_pos[sl] = np.arange(ref_i, ref_i + ln)
                base[sl] = DELETION_BASE
                qual[sl] = 0
                flags[sl] = F_DELETION
                out += ln
            ref_i += ln
        elif op in (sam.OP_I, sam.OP_S):
            read_i += ln
        # H and P consume nothing

    return ref_pos[:out], base[:out], qual[:out], flags[:out]


def count_high_quality_soft_clips(read: Read, qual_threshold: int = 28) -> int:
    """Number of soft-clipped bases with qual >= threshold (AlignmentUtils)."""
    n = 0
    read_i = 0
    for op, ln in zip(read.cigar_ops, read.cigar_lens):
        ln = int(ln)
        if sam.CONSUMES_READ[op]:
            if op == sam.OP_S:
                n += int(np.sum(read.quals[read_i : read_i + ln] >= qual_threshold))
            read_i += ln
    return n


_NATIVE = None
_NATIVE_TRIED = False


def _load_native():
    """ctypes binding to native/readprep pileup_expand (the C++ port of
    expand_read/build_pileup_elements; activity profiling's hot host loop)."""
    global _NATIVE, _NATIVE_TRIED
    if _NATIVE_TRIED:
        return _NATIVE
    _NATIVE_TRIED = True
    import ctypes
    import os

    so = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..",
                      "native", "readprep", "libreadprep_native.so")
    if not os.path.exists(so) or os.environ.get("GATK_TPU_NO_NATIVE"):
        return None
    try:
        lib = ctypes.CDLL(so)
        u8 = np.ctypeslib.ndpointer(np.uint8)
        i32 = np.ctypeslib.ndpointer(np.int32)
        i64 = np.ctypeslib.ndpointer(np.int64)
        c = ctypes
        lib.pileup_expand.restype = c.c_int64
        lib.pileup_expand.argtypes = [u8, u8, i64, u8, i32, i64, i64,
                                      c.c_int64, c.c_int64, c.c_int64,
                                      c.c_int64, i64, u8, u8, u8, i32]
    except (OSError, AttributeError):
        return None
    _NATIVE = lib
    return lib


def build_pileup_elements(reads, span_start: int, span_end: int):
    """Concatenate expanded elements of many reads, restricted to [span_start, span_end).

    Returns dict of arrays: pos (span-relative), base, qual, flags, read_idx.
    """
    lib = _load_native()
    if lib is not None and reads:
        n = len(reads)
        lens = np.fromiter((len(r.bases) for r in reads), np.int64, n)
        read_off = np.zeros(n + 1, np.int64)
        np.cumsum(lens, out=read_off[1:])
        clens = np.fromiter((len(r.cigar_ops) for r in reads), np.int64, n)
        cig_off = np.zeros(n + 1, np.int64)
        np.cumsum(clens, out=cig_off[1:])
        cat_b = np.concatenate([r.bases for r in reads])
        cat_q = np.concatenate([r.quals for r in reads])
        cat_ops = np.concatenate([r.cigar_ops for r in reads]).astype(np.uint8)
        cat_lens = np.concatenate([r.cigar_lens for r in reads]).astype(np.int32)
        pos_arr = np.fromiter((r.pos for r in reads), np.int64, n)
        # capacity: every read base + every deletion base
        cap = int(read_off[-1]) + int(cat_lens[cat_ops == 2].sum())
        out_pos = np.empty(cap, np.int64)
        out_base = np.empty(cap, np.uint8)
        out_qual = np.empty(cap, np.uint8)
        out_flags = np.empty(cap, np.uint8)
        out_rid = np.empty(cap, np.int32)
        m = lib.pileup_expand(
            np.ascontiguousarray(cat_b), np.ascontiguousarray(cat_q), read_off,
            np.ascontiguousarray(cat_ops), np.ascontiguousarray(cat_lens),
            cig_off, pos_arr, np.int64(n), np.int64(span_start),
            np.int64(span_end), np.int64(cap),
            out_pos, out_base, out_qual, out_flags, out_rid)
        if m >= 0:
            return dict(pos=out_pos[:m], base=out_base[:m], qual=out_qual[:m],
                        flags=out_flags[:m], read_idx=out_rid[:m])
    all_pos, all_base, all_qual, all_flags, all_rid = [], [], [], [], []
    for k, r in enumerate(reads):
        p, b, q, f = expand_read(r)
        keep = (p >= span_start) & (p < span_end)
        if not keep.any():
            continue
        all_pos.append(p[keep] - span_start)
        all_base.append(b[keep])
        all_qual.append(q[keep])
        all_flags.append(f[keep])
        all_rid.append(np.full(int(keep.sum()), k, np.int32))
    if not all_pos:
        z = np.empty(0, np.int64)
        return dict(pos=z, base=z.astype(np.uint8), qual=z.astype(np.uint8),
                    flags=z.astype(np.uint8), read_idx=z.astype(np.int32))
    return dict(
        pos=np.concatenate(all_pos),
        base=np.concatenate(all_base),
        qual=np.concatenate(all_qual),
        flags=np.concatenate(all_flags),
        read_idx=np.concatenate(all_rid),
    )
