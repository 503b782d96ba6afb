# Copied verbatim from gatk_tpu/calling/read_prep.py; only import lines may differ.
"""Read quality preparation for PairHMM (PairHMMLikelihoodCalculationEngine's
modifyReadQualities/applyPCRErrorModel/capMinimumReadQualities equivalents).

Reference behavior: haplotypecaller/PairHMMLikelihoodCalculationEngine.java:283-375
(PCR CONSERVATIVE rateFactor=3.0, INITIAL_QSCORE=40, MIN_ADJUSTED_QSCORE=10,
base-qual cap to MAPQ, threshold 18 -> fixed 6) and
ReadLikelihoodCalculationEngine.findTandemRepeatUnits :193-252.
"""
from __future__ import annotations

import math

import numpy as np

DEFAULT_GCP = 10
DEFAULT_INS_GOP = 45
DEFAULT_DEL_GOP = 45
BASE_QUALITY_SCORE_THRESHOLD = 18
MIN_USABLE_Q = 6
MIN_ADJUSTED_QSCORE = 10
INITIAL_QSCORE = 40.0
MAX_STR_UNIT_LENGTH = 8
MAX_REPEAT_LENGTH = 20
CONSERVATIVE_RATE_FACTOR = 3.0

_PCR_CACHE = {}
_NATIVE = None
_NATIVE_TRIED = False


def _load_native():
    """ctypes binding to native/readprep/libreadprep_native.so — the C++
    OpenMP port of the tandem-repeat scan (readprep_native.cpp)."""
    global _NATIVE, _NATIVE_TRIED
    if _NATIVE_TRIED:
        return _NATIVE
    _NATIVE_TRIED = True
    import ctypes
    import os

    so = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..",
                                      "native", "readprep", "libreadprep_native.so"))
    if not os.path.exists(so) or os.environ.get("GATK_TPU_NO_NATIVE_READPREP"):
        return None
    try:
        lib = ctypes.CDLL(so)
        lib.tandem_repeat_lengths_batch.restype = None
        lib.tandem_repeat_lengths_batch.argtypes = [
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            ctypes.c_int64, ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ]
        _NATIVE = lib
    except OSError:
        _NATIVE = None
    return _NATIVE


def pcr_error_cache(rate_factor: float = CONSERVATIVE_RATE_FACTOR) -> np.ndarray:
    key = rate_factor
    if key not in _PCR_CACHE:
        i = np.arange(MAX_REPEAT_LENGTH + 1, dtype=np.float64)
        q = np.floor(INITIAL_QSCORE - np.exp(i / (rate_factor * math.pi)) + 1.0 + 0.5)
        _PCR_CACHE[key] = np.maximum(MIN_ADJUSTED_QSCORE, q).astype(np.uint8)
    return _PCR_CACHE[key]


def _num_repetitions(unit: bytes, s: bytes, leading: bool) -> int:
    ul = len(unit)
    n = len(s)
    if n == 0:
        return 0
    count = 0
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


def find_tandem_repeat_length(bases: bytes, offset: int) -> int:
    """Repeat length at read offset (findTandemRepeatUnits, returns maxRL)."""
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
    best_unit = best_bw_unit
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
            max_bw2 = _num_repetitions(best_fw_unit, bases[: offset + 1], leading=False)
            max_rl = max_fw + max_bw2
    return min(max_rl, MAX_REPEAT_LENGTH)


def _block_match(B: np.ndarray, ul: int) -> np.ndarray:
    """bm[i, j] = True iff the ul-block ending at j equals the ul-block ending at
    j-ul (both fully inside the row). B is (N, L) uint8, 0-padded."""
    N, L = B.shape
    bm = np.zeros((N, L), bool)
    if L < 2 * ul:
        return bm
    eq = B[:, ul:] == B[:, :-ul]  # eq[:, j-ul] = (B[j] == B[j-ul]), j in [ul, L)
    # windowed AND of width ul over eq, ending at j (j >= 2*ul-1)
    c = np.cumsum(eq, axis=1, dtype=np.int32)
    win = c[:, ul - 1 :].copy()
    win[:, 1:] -= c[:, : L - 2 * ul]
    bm[:, 2 * ul - 1 :] = win == ul
    return bm


def _run_counts(bm: np.ndarray, ul: int, cap: int = MAX_REPEAT_LENGTH):
    """bw[i, j] = 1 + length of the consecutive True-run bm[j], bm[j-ul],
    bm[j-2ul], ... (the backward repetition count of the block ending at j).
    fw[i, j] = 1 + run of fm[j], fm[j+ul], ... where fm[j] = bm[j+2ul-1]
    (the forward repetition count of the block starting at j). Runs capped at
    `cap` additions."""
    N, L = bm.shape
    bw = np.ones((N, L), np.int32)
    alive = bm.copy()
    for k in range(cap - 1):
        if not alive.any():
            break
        bw += alive
        sh = (k + 1) * ul
        if sh >= L:
            break
        nxt = np.zeros_like(alive)
        nxt[:, sh:] = alive[:, sh:] & bm[:, : L - sh]
        alive = nxt
    # forward: block starting at j matches block starting at j+ul iff
    # bm[j + 2*ul - 1]; run along increasing j with stride ul.
    fm = np.zeros((N, L), bool)
    if 2 * ul - 1 < L:
        fm[:, : L - (2 * ul - 1)] = bm[:, 2 * ul - 1 :]
    fw = np.ones((N, L), np.int32)
    alive = fm.copy()
    for k in range(cap - 1):
        if not alive.any():
            break
        fw += alive
        sh = (k + 1) * ul
        if sh >= L:
            break
        nxt = np.zeros_like(alive)
        nxt[:, : L - sh] = alive[:, : L - sh] & fm[:, sh:]
        alive = nxt
    return bw, fw


def tandem_repeat_lengths_batch(B: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Vectorized findTandemRepeatUnits maxRL for every offset of every read.

    B: (N, L) uint8 base matrix, rows 0-padded past their length. Returns
    (N, L) int32 repeat lengths (capped at MAX_REPEAT_LENGTH), matching
    find_tandem_repeat_length(bases_i, j) for j < lengths[i].

    Identity used: in ReadLikelihoodCalculationEngine.findTandemRepeatUnits the
    final maxRL always equals max_fw + (#backward occurrences of the forward
    unit ending at the offset) for offsets before the last base, and max_bw at
    the last base — because when the backward and forward best units coincide
    the cross count equals max_bw.
    """
    N, L = B.shape
    lengths = np.asarray(lengths)
    lib = _load_native()
    if lib is not None:
        Bc = np.ascontiguousarray(B, np.uint8)
        out = np.zeros((N, L), np.int32)
        lib.tandem_repeat_lengths_batch(
            Bc, np.int64(N), np.int64(L),
            np.ascontiguousarray(lengths, np.int64), out)
        return out
    cols = np.arange(L)
    in_read = cols[None, :] < lengths[:, None]
    # per-unit-length block matches and run counts
    bms, bws, fws = [], [], []
    for ul in range(1, MAX_STR_UNIT_LENGTH + 1):
        # block matches must not cross the row's true end: positions j with
        # j >= lengths are padding; a block ending at j is valid iff j < len.
        bm = _block_match(B, ul) & in_read
        bw, fw = _run_counts(bm, ul)
        bms.append(bm)
        bws.append(bw)
        fws.append(fw)
    # clip runs that extend past the read end: fw run starting at j counts
    # blocks at j, j+ul, ...; a block is valid only if its last base < len.
    # _block_match already zeroes bm at padded j (via in_read), and fw uses
    # fm[j] = bm[j+2ul-1], so padded positions break runs naturally.

    # backward best: the repetition count is > 1 iff bm[ul][o]; the scalar takes
    # the SMALLEST such ul (count bw[ul][o]) and falls back to 1 when none
    # repeats. Iterating ul 8..1 and overwriting makes the smallest ul win.
    max_bw = np.ones((N, L), np.int32)
    for ul in range(MAX_STR_UNIT_LENGTH, 0, -1):
        sel = bms[ul - 1]
        max_bw = np.where(sel, bws[ul - 1], max_bw)
    # forward unit at offset o is the block starting at o+1; effective length =
    # smallest ul whose forward count fw[ul][o+1] > 1, else 1 (single base).
    max_fw = np.zeros((N, L), np.int32)
    ulf_eff = np.ones((N, L), np.int32)
    found_fw = np.zeros((N, L), bool)
    for ul in range(MAX_STR_UNIT_LENGTH, 0, -1):
        # fw count for unit starting at o+1: fw[ul][o+1]
        cnt = np.ones((N, L), np.int32)
        cnt[:, :-1] = fws[ul - 1][:, 1:]
        # unit must fit: o+1+ul <= len
        fits = cols[None, :] + 1 + ul <= lengths[:, None]
        sel = fits & (cnt > 1)
        max_fw = np.where(sel, cnt, max_fw)
        ulf_eff = np.where(sel, ul, ulf_eff)
        found_fw |= sel
    # not-found forward: unit is single base at o+1, count fw[1][o+1] (==1 since
    # not found means no ul had cnt>1, incl. ul=1)
    has_next = cols[None, :] + 1 < lengths[:, None]
    max_fw = np.where(found_fw, max_fw, np.where(has_next, 1, 0))

    # cross count: occurrences of the forward unit (length ulf_eff) ending at o
    # = bw[ulf][o] if bm[ulf][o + ulf] else 0  (block ending o+ulf IS the fw unit
    # and bm there says it equals the block ending at o)
    cross = np.zeros((N, L), np.int32)
    for ul in range(1, MAX_STR_UNIT_LENGTH + 1):
        use = ulf_eff == ul
        link = np.zeros((N, L), bool)
        if ul < L:
            link[:, :-ul] = bms[ul - 1][:, ul:]
        c = np.where(link, bws[ul - 1], 0)
        cross = np.where(use, c, cross)

    rl = max_fw + cross
    # last base of each read: rl = max_bw
    last = cols[None, :] == (lengths[:, None] - 1)
    rl = np.where(last, max_bw, rl)
    return np.minimum(rl, MAX_REPEAT_LENGTH).astype(np.int32)


def pcr_caps_batch(B: np.ndarray, lengths: np.ndarray,
                   rate_factor: float = CONSERVATIVE_RATE_FACTOR) -> np.ndarray:
    """(N, L) uint8 qual caps for positions 0..len-2 of each read (the PCR model
    caps ins/del quals at i-1 using the repeat length at offset i-1; the last
    base is never capped). Positions >= len-1 return 255 (no cap)."""
    rl = tandem_repeat_lengths_batch(B, lengths)
    cache = pcr_error_cache(rate_factor)
    caps = cache[rl]
    cols = np.arange(B.shape[1])
    no_cap = cols[None, :] >= (np.asarray(lengths)[:, None] - 1)
    return np.where(no_cap, np.uint8(255), caps)


def apply_pcr_error_model(bases: bytes, ins_quals: np.ndarray, del_quals: np.ndarray,
                          rate_factor: float = CONSERVATIVE_RATE_FACTOR):
    n = len(bases)
    if n < 2:
        return
    B = np.frombuffer(bases, np.uint8)[None, :]
    caps = pcr_caps_batch(B, np.array([n]), rate_factor)[0]
    np.minimum(ins_quals, caps, out=ins_quals, casting="unsafe")
    np.minimum(del_quals, caps, out=del_quals, casting="unsafe")


def prepare_read_for_pairhmm(read, pcr_error_model: str = "CONSERVATIVE"):
    """Return dict(bases, rq, iq, dq, gcp) ready for the PairHMM kernel."""
    return prepare_reads_for_pairhmm([read], pcr_error_model)[0]


def prepare_reads_for_pairhmm(reads, pcr_error_model: str = "CONSERVATIVE"):
    """Batch variant of prepare_read_for_pairhmm: one vectorized PCR-error-model
    pass over all reads (the per-position tandem-repeat scan is the hot loop of
    PairHMMLikelihoodCalculationEngine.applyPCRErrorModel)."""
    n_reads = len(reads)
    if n_reads == 0:
        return []
    lengths = np.fromiter((len(r.bases) for r in reads), np.int64, n_reads)
    L = int(lengths.max())
    B = np.zeros((n_reads, L), np.uint8)
    RQ = np.zeros((n_reads, L), np.int32)
    for i, r in enumerate(reads):
        n = lengths[i]
        B[i, :n] = r.bases
        RQ[i, :n] = r.quals
    if pcr_error_model in ("CONSERVATIVE", "AGGRESSIVE"):
        rate = CONSERVATIVE_RATE_FACTOR if pcr_error_model == "CONSERVATIVE" else 2.0
        caps = pcr_caps_batch(B, lengths, rate).astype(np.int32)
    else:
        caps = np.full((n_reads, L), 255, np.int32)
    # default gap-open quals capped by the PCR model; BI/BD-tagged reads get
    # their per-base quals instead (rare — patched per read below)
    IQ = np.minimum(np.int32(DEFAULT_INS_GOP), caps)
    DQ = np.minimum(np.int32(DEFAULT_DEL_GOP), caps)
    tagged = [i for i, r in enumerate(reads)
              if isinstance(r.tags.get("BI"), str) or isinstance(r.tags.get("BD"), str)]
    for i in tagged:
        r, n = reads[i], lengths[i]
        bi, bd = r.tags.get("BI"), r.tags.get("BD")
        if isinstance(bi, str):
            IQ[i, :n] = np.minimum(
                np.frombuffer(bi.encode(), np.uint8).astype(np.int32) - 33, caps[i, :n])
        if isinstance(bd, str):
            DQ[i, :n] = np.minimum(
                np.frombuffer(bd.encode(), np.uint8).astype(np.int32) - 33, caps[i, :n])
    # cap base qual by mapping quality, then threshold
    mapqs = np.fromiter((r.mapq for r in reads), np.int32, n_reads)
    np.minimum(RQ, mapqs[:, None], out=RQ)
    RQ = np.where(RQ < BASE_QUALITY_SCORE_THRESHOLD, MIN_USABLE_Q, RQ).astype(np.uint8)
    IQ = np.maximum(IQ, MIN_USABLE_Q).astype(np.uint8)
    DQ = np.maximum(DQ, MIN_USABLE_Q).astype(np.uint8)
    GCP = np.full(L, DEFAULT_GCP, np.uint8)
    out = []
    for i, read in enumerate(reads):
        n = lengths[i]
        out.append(dict(
            bases=bytes(read.bases),
            rq=RQ[i, :n],
            iq=IQ[i, :n],
            dq=DQ[i, :n],
            gcp=GCP[:n],
        ))
    return out
