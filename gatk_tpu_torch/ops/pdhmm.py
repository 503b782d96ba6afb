# Copied verbatim from gatk_tpu/ops/pdhmm.py; only import lines may differ.
"""Partially-determined PairHMM (DRAGEN-GATK PDHMM).

Reference behavior: utils/pairhmm/LoglessPDPairHMM.java:34-153 — the logless
3-state PairHMM extended with (a) PD-aware priors where an undetermined-SNP
haplotype base matches the read base if the alt bit is set (:188-214), and
(b) an undetermined-deletion jump: three "branch" shadow matrices carry the DP
state from before a DEL_START..DEL_END span so paths may skip the span, merged
back with max() at the column after DEL_END (the NORMAL/INSIDE_DEL/AFTER_DEL
column state machine, :62-141).

Production path: batched C++/OpenMP kernel (native/pdhmm/, the GKL pdhmm AVX
equivalent) via ctypes; `compute_pd_log10` is the pure-python oracle used by the
golden tests. When the pd-byte array is all zero, both reduce exactly to
LoglessPairHMM (tested against ops/pairhmm_host.py).
"""
from __future__ import annotations

import ctypes
import os

import numpy as np

from ..utils import quals as qu
from . import pairhmm_model as pm

INITIAL_CONDITION = 2.0**1020
INITIAL_CONDITION_LOG10 = np.log10(INITIAL_CONDITION)

PD_SNP = 1
PD_DEL_START = 2
PD_DEL_END = 4
_SNP_BIT = {ord("A"): 8, ord("C"): 16, ord("G"): 32, ord("T"): 64, ord("N"): 128}

NORMAL, INSIDE_DEL, AFTER_DEL = 0, 1, 2


def _pd_matches(x: int, pdb: int) -> bool:
    if not pdb & PD_SNP:
        return False
    return bool(pdb & _SNP_BIT.get(x, 0))


def compute_pd_log10(hap_bases, pd_bytes, read_bases, read_quals,
                     ins_quals, del_quals, gcps) -> float:
    """Pure-python faithful port of subComputeReadLikelihoodGivenHaplotypeLog10
    (:34-153). O(R*H) scalar — the oracle for the native kernel, not a hot path."""
    hap = np.frombuffer(bytes(hap_bases), np.uint8) if isinstance(hap_bases, (bytes, bytearray)) else np.asarray(hap_bases, np.uint8)
    pd = np.asarray(pd_bytes, np.uint8)
    read = np.frombuffer(bytes(read_bases), np.uint8) if isinstance(read_bases, (bytes, bytearray)) else np.asarray(read_bases, np.uint8)
    R, H = len(read), len(hap)
    trans = pm.qual_to_trans_probs(np.asarray(ins_quals), np.asarray(del_quals),
                                   np.asarray(gcps))
    p_match = qu.qual_to_prob(np.asarray(read_quals))
    p_mis = qu.qual_to_error_prob(np.asarray(read_quals)) / pm.TRISTATE_CORRECTION

    M = np.zeros((R + 1, H + 1))
    I = np.zeros((R + 1, H + 1))
    D = np.zeros((R + 1, H + 1))
    bM = np.zeros((R + 1, H + 1))
    bI = np.zeros((R + 1, H + 1))
    bD = np.zeros((R + 1, H + 1))
    D[0, :] = INITIAL_CONDITION / H

    n = ord("N")
    state = NORMAL  # persists across rows, faithful to the Java loop (:62)
    for i in range(1, R + 1):
        t = trans[i - 1]
        x = int(read[i - 1])
        for j in range(1, H + 1):
            y = int(hap[j - 1])
            pj = int(pd[j - 1])
            prior = (p_match[i - 1]
                     if x == y or x == n or y == n or _pd_matches(x, pj)
                     else p_mis[i - 1])
            if state == NORMAL:
                bM[i, j] = M[i, j - 1]
                bD[i, j] = D[i, j - 1]
                bI[i, j] = I[i, j - 1]
                M[i, j] = prior * (M[i - 1, j - 1] * t[pm.MATCH_TO_MATCH]
                                   + (I[i - 1, j - 1] + D[i - 1, j - 1]) * t[pm.INDEL_TO_MATCH])
                D[i, j] = M[i, j - 1] * t[pm.MATCH_TO_DELETION] + D[i, j - 1] * t[pm.DELETION_TO_DELETION]
            elif state == INSIDE_DEL:
                bM[i, j] = bM[i, j - 1]
                bD[i, j] = bD[i, j - 1]
                bI[i, j] = bI[i, j - 1]
                M[i, j] = prior * (M[i - 1, j - 1] * t[pm.MATCH_TO_MATCH]
                                   + (I[i - 1, j - 1] + D[i - 1, j - 1]) * t[pm.INDEL_TO_MATCH])
                D[i, j] = M[i, j - 1] * t[pm.MATCH_TO_DELETION] + D[i, j - 1] * t[pm.DELETION_TO_DELETION]
            else:  # AFTER_DEL
                bM[i, j] = max(bM[i, j - 1], M[i, j - 1])
                bD[i, j] = max(bD[i, j - 1], D[i, j - 1])
                bI[i, j] = max(bI[i, j - 1], I[i, j - 1])
                M[i, j] = prior * (max(bM[i - 1, j - 1], M[i - 1, j - 1]) * t[pm.MATCH_TO_MATCH]
                                   + (max(bI[i - 1, j - 1], I[i - 1, j - 1])
                                      + max(bD[i - 1, j - 1], D[i - 1, j - 1])) * t[pm.INDEL_TO_MATCH])
                D[i, j] = (max(bM[i, j - 1], M[i, j - 1]) * t[pm.MATCH_TO_DELETION]
                           + max(bD[i, j - 1], D[i, j - 1]) * t[pm.DELETION_TO_DELETION])
                state = NORMAL
            if pj & PD_DEL_END:
                I[i, j] = (max(bM[i - 1, j], M[i - 1, j]) * t[pm.MATCH_TO_INSERTION]
                           + max(bI[i - 1, j], I[i - 1, j]) * t[pm.INSERTION_TO_INSERTION])
            else:
                I[i, j] = M[i - 1, j] * t[pm.MATCH_TO_INSERTION] + I[i - 1, j] * t[pm.INSERTION_TO_INSERTION]
            if pj & PD_DEL_START:
                state = INSIDE_DEL
            if pj & PD_DEL_END:
                state = AFTER_DEL
    return float(np.log10(M[R, 1:].sum() + I[R, 1:].sum()) - INITIAL_CONDITION_LOG10)


# ---------------------------------------------------------------------------
# Batched native path
# ---------------------------------------------------------------------------

_NATIVE = None
_NATIVE_TRIED = False


def _load_native():
    global _NATIVE, _NATIVE_TRIED
    if _NATIVE_TRIED:
        return _NATIVE
    _NATIVE_TRIED = True
    so = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..",
                                      "native", "pdhmm", "libpdhmm_native.so"))
    if not os.path.exists(so) or os.environ.get("GATK_TPU_NO_NATIVE_PDHMM"):
        return None
    try:
        lib = ctypes.CDLL(so)
        u8 = np.ctypeslib.ndpointer(np.uint8)
        i32 = np.ctypeslib.ndpointer(np.int32)
        i64 = np.ctypeslib.ndpointer(np.int64)
        lib.pdhmm_compute_batch.restype = ctypes.c_int32
        lib.pdhmm_compute_batch.argtypes = [
            u8, u8, i64, i32, ctypes.c_int32,
            u8, u8, u8, u8, u8, i64, i32, ctypes.c_int32,
            i32, i32, ctypes.c_int64,
            np.ctypeslib.ndpointer(np.float64), ctypes.c_int32,
        ]
        _NATIVE = lib
    except OSError:
        _NATIVE = None
    return _NATIVE


def compute_pd_likelihood_matrix(haplotypes, pd_bytes_list, prepped_reads):
    """(n_reads, n_haps) log10 likelihood matrix for PD haplotypes.

    haplotypes: list of bytes; pd_bytes_list: matching list of uint8 arrays;
    prepped_reads: list of dicts with bases/rq/iq/dq/gcp
    (read_prep.prepare_reads_for_pairhmm output entries)."""
    n_h, n_r = len(haplotypes), len(prepped_reads)
    out = np.zeros((n_r, n_h))
    if n_h == 0 or n_r == 0:
        return out
    lib = _load_native()
    if lib is None:
        for ri, rd in enumerate(prepped_reads):
            for hi, (hb, pdb) in enumerate(zip(haplotypes, pd_bytes_list)):
                out[ri, hi] = compute_pd_log10(
                    hb, pdb, rd["bases"], rd["rq"], rd["iq"], rd["dq"], rd["gcp"])
        return out

    hap_cat = np.concatenate([np.frombuffer(bytes(h), np.uint8) for h in haplotypes])
    pd_cat = np.concatenate([np.asarray(p, np.uint8) for p in pd_bytes_list])
    hap_len = np.fromiter((len(h) for h in haplotypes), np.int32, n_h)
    hap_off = np.zeros(n_h, np.int64)
    np.cumsum(hap_len[:-1], out=hap_off[1:])

    def cat(key):
        return np.ascontiguousarray(np.concatenate(
            [np.frombuffer(bytes(r[key]), np.uint8) if isinstance(r[key], (bytes, bytearray))
             else np.asarray(r[key], np.uint8) for r in prepped_reads]))

    rb, rq = cat("bases"), cat("rq")
    riq, rdq, rgcp = cat("iq"), cat("dq"), cat("gcp")
    read_len = np.fromiter((len(r["bases"]) for r in prepped_reads), np.int32, n_r)
    read_off = np.zeros(n_r, np.int64)
    np.cumsum(read_len[:-1], out=read_off[1:])

    pair_hap = np.tile(np.arange(n_h, dtype=np.int32), n_r)
    pair_read = np.repeat(np.arange(n_r, dtype=np.int32), n_h)
    flat = np.zeros(n_r * n_h, np.float64)
    rc = lib.pdhmm_compute_batch(
        np.ascontiguousarray(hap_cat), np.ascontiguousarray(pd_cat),
        hap_off, hap_len, np.int32(n_h),
        rb, rq, riq, rdq, rgcp, read_off, read_len, np.int32(n_r),
        pair_hap, pair_read, np.int64(n_r * n_h), flat, np.int32(0))
    if rc != 0:  # pragma: no cover - native kernel never signals failure today
        raise RuntimeError(f"pdhmm native kernel failed rc={rc}")
    return flat.reshape(n_r, n_h)
