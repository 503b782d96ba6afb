# Copied verbatim from gatk_tpu/ops/smith_waterman.py; only import lines may differ.
"""Affine-gap Smith-Waterman with GATK-compatible cigars.

Reference behavior: utils/smithwaterman/SmithWatermanJavaAligner.java (matrix
:109-230, cigar :261-380) and SmithWatermanAlignmentConstants.java (parameter
presets). Replaces the Intel GKL AVX aligner.

Implementation: per-row numpy vectorization. Vertical gaps are tracked with the same
running best/size arrays as the reference (elementwise over columns). Horizontal
gaps use a two-pass prefix-max: pass 1 computes gap values from diag/vertical-derived
cells (gap-from-gap is never strictly better when |open| > |extend|, which holds for
every preset), pass 2 recomputes the prefix argmax over the final row values with
earliest-index tie-breaking — reproducing the reference's sequential update
(strict-greater reset, ties keep the earlier/longer gap) exactly.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..io import sam

MATRIX_MIN_CUTOFF = int(-1.0e8)
LOW_INIT = -(2**31) // 2


@dataclass(frozen=True)
class SWParameters:
    match: int
    mismatch: int
    gap_open: int
    gap_extend: int


# presets (SmithWatermanAlignmentConstants.java)
ORIGINAL_DEFAULT = SWParameters(3, -1, -4, -3)
STANDARD_NGS = SWParameters(25, -50, -110, -6)  # dangling head/tail recovery
NEW_SW_PARAMETERS = SWParameters(200, -150, -260, -11)  # haplotype-to-reference
ALIGNMENT_TO_BEST_HAPLOTYPE = SWParameters(10, -15, -30, -5)  # read-to-haplotype

SOFTCLIP = "SOFTCLIP"
INDEL = "INDEL"
LEADING_INDEL = "LEADING_INDEL"
IGNORE = "IGNORE"


@dataclass
class SWAlignment:
    cigar_ops: np.ndarray
    cigar_lens: np.ndarray
    offset: int
    score: int

    @property
    def cigar(self) -> str:
        return sam.cigar_to_string(self.cigar_ops, self.cigar_lens)


def align(ref, alt, params: SWParameters, overhang: str = SOFTCLIP) -> SWAlignment:
    """Align alt against ref; indels are expressed w.r.t. alt (I consumes alt)."""
    ref = np.frombuffer(bytes(ref), dtype=np.uint8) if isinstance(ref, (bytes, bytearray)) else np.asarray(ref, dtype=np.uint8)
    alt = np.frombuffer(bytes(alt), dtype=np.uint8) if isinstance(alt, (bytes, bytearray)) else np.asarray(alt, dtype=np.uint8)
    n, m = len(ref), len(alt)
    if n == 0 or m == 0:
        raise ValueError("empty sequences")

    # exact-match fast path (SmithWatermanJavaAligner.align :69-77)
    if overhang == SOFTCLIP and n == m and np.array_equal(ref, alt):
        return SWAlignment(np.array([sam.OP_M], np.uint8), np.array([m], np.int32), 0,
                           m * params.match)

    lib = _load_native()
    if lib is not None:
        return _align_batch_native(lib, ref, [(0, alt)], params, overhang, [None])[0]

    w_open, w_ext = params.gap_open, params.gap_extend
    H = np.zeros((n + 1, m + 1), np.int64)
    btrack = np.zeros((n + 1, m + 1), np.int32)
    if overhang in (INDEL, LEADING_INDEL):
        H[0, 1:] = w_open + np.arange(m) * w_ext
        H[1:, 0] = w_open + np.arange(n) * w_ext

    best_v = np.full(m + 1, LOW_INIT, np.int64)
    size_v = np.zeros(m + 1, np.int64)
    jcols = np.arange(m + 1)

    for i in range(1, n + 1):
        prev = H[i - 1]
        # vertical gap tracking (elementwise, identical to the reference update rule)
        prev_gap = prev + w_open
        best_v += w_ext
        reset = prev_gap > best_v
        best_v = np.where(reset, prev_gap, best_v)
        size_v = np.where(reset, 1, size_v + 1)

        s = np.where(alt == ref[i - 1], params.match, params.mismatch)
        step_diag = prev[:-1] + s  # for j=1..m
        step_down = best_v[1:]
        h0 = np.maximum(step_diag, step_down)

        # pass 1: horizontal gap values from h0 (+ column 0)
        r = np.empty(m + 1, np.int64)
        r[0] = H[i, 0]
        r[1:] = h0
        r -= jcols * w_ext
        runmax = np.maximum.accumulate(r)
        F = runmax[:-1] + w_open + jcols[1:] * w_ext - w_ext  # F[j] for j=1..m

        h_final = np.maximum(h0, F)
        # pass 2: earliest-argmax over final values for gap sizes
        r2 = np.empty(m + 1, np.int64)
        r2[0] = H[i, 0]
        r2[1:] = h_final
        r2 -= jcols * w_ext
        runmax2 = np.maximum.accumulate(r2)
        changed = np.empty(m + 1, bool)
        changed[0] = True
        changed[1:] = r2[1:] > runmax2[:-1]
        argmax2 = np.maximum.accumulate(np.where(changed, jcols, -1))
        step_right = runmax2[:-1] + w_open + (jcols[1:] - 1) * w_ext
        ki = jcols[1:] - argmax2[:-1]

        diag_best = (step_diag >= step_down) & (step_diag >= step_right)
        right_best = ~diag_best & (step_right >= step_down)
        btrack[i, 1:] = np.where(diag_best, 0, np.where(right_best, -ki, size_v[1:]))
        H[i, 1:] = np.maximum(
            MATRIX_MIN_CUTOFF,
            np.where(diag_best, step_diag, np.where(right_best, step_right, step_down)),
        )

    return _calculate_cigar(H, btrack, overhang)


def _calculate_cigar(H, btrack, overhang) -> SWAlignment:
    n = H.shape[0] - 1
    m = H.shape[1] - 1
    segment_length = 0
    if overhang == INDEL:
        p1, p2 = n, m
        maxscore = int(H[n, m])
    else:
        # best score in rightmost column (>= keeps the last, i.e. closest-to-diagonal)
        col = H[1:, m]
        p1 = int(np.flatnonzero(col == col.max())[-1]) + 1
        p2 = m
        maxscore = int(col.max())
        if overhang != LEADING_INDEL:
            row = H[n, 1:]
            for j in range(1, m + 1):
                cur = int(row[j - 1])
                if cur > maxscore or (cur == maxscore and abs(n - j) < abs(p1 - p2)):
                    p1, p2 = n, j
                    maxscore = cur
                    segment_length = m - j

    ops, lens = [], []
    if segment_length > 0 and overhang == SOFTCLIP:
        ops.append(sam.OP_S)
        lens.append(segment_length)
        segment_length = 0

    state = sam.OP_M
    while True:
        btr = int(btrack[p1, p2])
        if btr > 0:
            new_state, step = sam.OP_D, btr
            p1 -= btr
        elif btr < 0:
            new_state, step = sam.OP_I, -btr
            p2 += btr
        else:
            new_state, step = sam.OP_M, 1
            p1 -= 1
            p2 -= 1
        if new_state == state:
            segment_length += step
        else:
            if segment_length > 0:
                ops.append(state)
                lens.append(segment_length)
            segment_length = step
            state = new_state
        if not (p1 > 0 and p2 > 0):
            break

    if overhang == SOFTCLIP:
        ops.append(state)
        lens.append(segment_length)
        if p2 > 0:
            ops.append(sam.OP_S)
            lens.append(p2)
        offset = p1
    elif overhang == IGNORE:
        ops.append(state)
        lens.append(segment_length + p2)
        offset = p1 - p2
    else:  # INDEL / LEADING_INDEL
        ops.append(state)
        lens.append(segment_length)
        if p1 > 0:
            ops.append(sam.OP_D)
            lens.append(p1)
        elif p2 > 0:
            ops.append(sam.OP_I)
            lens.append(p2)
        offset = 0

    return SWAlignment(
        np.array(ops[::-1], np.uint8), np.array(lens[::-1], np.int32), offset, maxscore
    )


_NATIVE = None
_NATIVE_TRIED = False
_OVERHANG_CODE = {SOFTCLIP: 0, INDEL: 1, LEADING_INDEL: 2, IGNORE: 3}


def _load_native():
    """ctypes binding to native/sw/libsw_native.so (OpenMP batch SW — the GKL
    SmithWatermanIntelAligner equivalent). Returns None if unavailable."""
    global _NATIVE, _NATIVE_TRIED
    if _NATIVE_TRIED:
        return _NATIVE
    _NATIVE_TRIED = True
    import ctypes
    import os

    so = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "..", "..", "native", "sw", "libsw_native.so")
    if not os.path.exists(so) or os.environ.get("GATK_TPU_NO_NATIVE_SW"):
        return None
    try:
        lib = ctypes.CDLL(so)
        lib.sw_align_batch.restype = ctypes.c_int32
        lib.sw_align_batch.argtypes = [
            np.ctypeslib.ndpointer(np.uint8), ctypes.c_int32,
            np.ctypeslib.ndpointer(np.uint8), np.ctypeslib.ndpointer(np.int64),
            np.ctypeslib.ndpointer(np.int32), ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32,
            np.ctypeslib.ndpointer(np.uint8), np.ctypeslib.ndpointer(np.int32),
            np.ctypeslib.ndpointer(np.int32), np.ctypeslib.ndpointer(np.int32),
            np.ctypeslib.ndpointer(np.int64), ctypes.c_int32, ctypes.c_int32,
        ]
        _NATIVE = lib
    except OSError:
        _NATIVE = None
    return _NATIVE


def _align_batch_native(lib, ref_arr, todo, params, overhang, results):
    alts = [a for _, a in todo]
    off = np.zeros(len(alts), np.int64)
    lens = np.fromiter((len(a) for a in alts), np.int32, len(alts))
    np.cumsum(lens[:-1], out=off[1:])
    cat = np.concatenate(alts) if alts else np.zeros(0, np.uint8)
    cat = np.ascontiguousarray(cat, np.uint8)
    ref_c = np.ascontiguousarray(ref_arr, np.uint8)
    max_cigar = 64
    while True:
        ops = np.zeros((len(alts), max_cigar), np.uint8)
        clens = np.zeros((len(alts), max_cigar), np.int32)
        ncig = np.zeros(len(alts), np.int32)
        offs = np.zeros(len(alts), np.int32)
        scores = np.zeros(len(alts), np.int64)
        rc = lib.sw_align_batch(
            ref_c, np.int32(len(ref_c)), cat, off, lens, np.int32(len(alts)),
            params.match, params.mismatch, params.gap_open, params.gap_extend,
            _OVERHANG_CODE[overhang], ops, clens, ncig, offs, scores,
            np.int32(max_cigar), np.int32(0))
        if rc == 0:
            break
        max_cigar *= 4
        if max_cigar > 1 << 20:  # pragma: no cover - pathological
            raise RuntimeError("SW cigar overflow")
    for b, (idx, _) in enumerate(todo):
        k = int(ncig[b])
        results[idx] = SWAlignment(ops[b, :k].copy(), clens[b, :k].copy(),
                                   int(offs[b]), int(scores[b]))
    return results


def align_batch(ref, alts, params: SWParameters, overhang: str = SOFTCLIP):
    """Batched SW: align many alts against one ref in a single vectorized DP.

    The per-row update is identical to align() with a leading batch dimension,
    amortizing the Python/numpy dispatch overhead across the whole haplotype
    set (the reference handles this volume with its AVX kernel; the assembler
    aligns up to 128 k-best haplotypes per kmer size against the same padded
    reference, ReadThreadingAssembler.findBestPaths :324).

    Returns a list of SWAlignment in alts order (exact-match fast path and
    per-item cigar backtrack preserved; scores identical to align()).
    """
    ref_arr = np.frombuffer(bytes(ref), dtype=np.uint8) if isinstance(ref, (bytes, bytearray)) \
        else np.asarray(ref, dtype=np.uint8)
    n = len(ref_arr)
    results: list = [None] * len(alts)
    todo = []
    for idx, alt in enumerate(alts):
        alt_arr = np.frombuffer(bytes(alt), dtype=np.uint8) if isinstance(alt, (bytes, bytearray)) \
            else np.asarray(alt, dtype=np.uint8)
        if len(alt_arr) == 0 or n == 0:
            raise ValueError("empty sequences")
        if overhang == SOFTCLIP and n == len(alt_arr) and np.array_equal(ref_arr, alt_arr):
            results[idx] = SWAlignment(np.array([sam.OP_M], np.uint8),
                                       np.array([len(alt_arr)], np.int32), 0,
                                       len(alt_arr) * params.match)
        else:
            todo.append((idx, alt_arr))
    if not todo:
        return results

    lib = _load_native()
    if lib is not None:
        return _align_batch_native(lib, ref_arr, todo, params, overhang, results)

    # bound DP-matrix memory: (chunk, n, m) int32 x2 stays < ~100MB
    max_chunk = max(1, int(100e6 / max(1, 8 * (n + 1) * (max(len(a) for _, a in todo) + 1))))
    if len(todo) > max_chunk:
        for lo in range(0, len(todo), max_chunk):
            chunk = todo[lo:lo + max_chunk]
            sub = align_batch(ref_arr, [a for _, a in chunk], params, overhang)
            for (idx, _), aln in zip(chunk, sub):
                results[idx] = aln
        return results

    B = len(todo)
    m = max(len(a) for _, a in todo)
    alt_mat = np.zeros((B, m), np.uint8)  # 0 never matches ACGT bytes
    m_lens = np.zeros(B, np.int64)
    for b, (_, a) in enumerate(todo):
        alt_mat[b, :len(a)] = a
        m_lens[b] = len(a)

    w_open, w_ext = params.gap_open, params.gap_extend
    H = np.zeros((B, n + 1, m + 1), np.int32)
    btrack = np.zeros((B, n + 1, m + 1), np.int32)
    if overhang in (INDEL, LEADING_INDEL):
        H[:, 0, 1:] = w_open + np.arange(m) * w_ext
        H[:, 1:, 0] = w_open + np.arange(n) * w_ext

    best_v = np.full((B, m + 1), LOW_INIT, np.int64)
    size_v = np.zeros((B, m + 1), np.int64)
    jcols = np.arange(m + 1)

    for i in range(1, n + 1):
        prev = H[:, i - 1].astype(np.int64)
        prev_gap = prev + w_open
        best_v += w_ext
        reset = prev_gap > best_v
        best_v = np.where(reset, prev_gap, best_v)
        size_v = np.where(reset, 1, size_v + 1)

        s = np.where(alt_mat == ref_arr[i - 1], params.match, params.mismatch)
        step_diag = prev[:, :-1] + s
        step_down = best_v[:, 1:]
        h0 = np.maximum(step_diag, step_down)

        r = np.empty((B, m + 1), np.int64)
        r[:, 0] = H[:, i, 0]
        r[:, 1:] = h0
        r -= jcols[None, :] * w_ext
        runmax = np.maximum.accumulate(r, axis=1)
        F = runmax[:, :-1] + w_open + jcols[None, 1:] * w_ext - w_ext

        h_final = np.maximum(h0, F)
        r2 = np.empty((B, m + 1), np.int64)
        r2[:, 0] = H[:, i, 0]
        r2[:, 1:] = h_final
        r2 -= jcols[None, :] * w_ext
        runmax2 = np.maximum.accumulate(r2, axis=1)
        changed = np.empty((B, m + 1), bool)
        changed[:, 0] = True
        changed[:, 1:] = r2[:, 1:] > runmax2[:, :-1]
        argmax2 = np.maximum.accumulate(np.where(changed, jcols[None, :], -1), axis=1)
        step_right = runmax2[:, :-1] + w_open + (jcols[None, 1:] - 1) * w_ext
        ki = jcols[None, 1:] - argmax2[:, :-1]

        diag_best = (step_diag >= step_down) & (step_diag >= step_right)
        right_best = ~diag_best & (step_right >= step_down)
        btrack[:, i, 1:] = np.where(diag_best, 0, np.where(right_best, -ki, size_v[:, 1:]))
        H[:, i, 1:] = np.maximum(
            MATRIX_MIN_CUTOFF,
            np.where(diag_best, step_diag, np.where(right_best, step_right, step_down)),
        )

    for b, (idx, alt_arr) in enumerate(todo):
        mi = int(m_lens[b])
        results[idx] = _calculate_cigar(
            H[b, :, :mi + 1].astype(np.int64), btrack[b, :, :mi + 1], overhang)
    return results
