# Copied verbatim from gatk_tpu/recal/covariates.py; only import lines may differ.
"""Standard BQSR covariates as vectorized per-read key computations.

Reference behavior: utils/recalibration/covariates/{ReadGroupCovariate,
QualityScoreCovariate, ContextCovariate, CycleCovariate}.java. Keys use the
reference's exact bit encodings so recal tables are interchangeable.
"""
from __future__ import annotations

import numpy as np

LENGTH_BITS = 4
LENGTH_MASK = 15
CUSHION_FOR_INDELS = 4
DEFAULT_MAX_CYCLE = 500
DEFAULT_LOW_QUAL_TAIL = 2
DEFAULT_MISMATCHES_CONTEXT_SIZE = 2
DEFAULT_INDELS_CONTEXT_SIZE = 3

# base -> 2-bit index (A=0 C=1 G=2 T=3, everything else -1), case-insensitive
_BASE_INDEX = np.full(256, -1, np.int32)
for i, b in enumerate(b"ACGT"):
    _BASE_INDEX[b] = i
    _BASE_INDEX[b + 32] = i  # lowercase


def context_from_key(key: int) -> str:
    length = key & LENGTH_MASK
    out = []
    offset = LENGTH_BITS
    for _ in range(length):
        out.append("ACGT"[(key >> offset) & 3])
        offset += 2
    return "".join(out)


def key_from_context(dna: str) -> int:
    key = len(dna)
    offset = LENGTH_BITS
    for ch in dna.upper():
        idx = "ACGT".find(ch)
        if idx < 0:
            return -1
        key |= idx << offset
        offset += 2
    return key


def _mask(context_size: int) -> int:
    m = 0
    for _ in range(context_size):
        m = (m << 2) | 3
    return m << LENGTH_BITS


def context_keys(stranded_bases: np.ndarray, context_size: int) -> np.ndarray:
    """Per-position preceding-context keys over already-stranded bases.

    stranded_bases: uint8 array (reverse-complemented for negative strand,
    low-qual tails replaced by N). Position i's context is bases[i-ctx+1 .. i].
    Returns int32 keys (-1 where the context contains a non-ACGT base).
    """
    n = len(stranded_bases)
    idx = _BASE_INDEX[stranded_bases]
    keys = np.full(n, -1, np.int32)
    if n < context_size:
        return keys
    # windows of length context_size ending at position i (i >= context_size-1):
    # key = context_size | sum_j base[i-context_size+1+j] << (4 + 2j)
    valid = np.ones(n - context_size + 1, bool)
    acc = np.zeros(n - context_size + 1, np.int64)
    for j in range(context_size):
        b = idx[j : j + n - context_size + 1]
        valid &= b >= 0
        acc |= np.where(b >= 0, b, 0).astype(np.int64) << (LENGTH_BITS + 2 * j)
    acc |= context_size
    keys[context_size - 1 :] = np.where(valid, acc, -1).astype(np.int32)
    return keys


def cycle_keys(read_length: int, is_negative_strand: bool, is_second_of_pair: bool,
               indel: bool, max_cycle: int = DEFAULT_MAX_CYCLE) -> np.ndarray:
    """CycleCovariate.cycleKey for every base of the read (int32, -1 for indel cushion)."""
    order = -1 if is_second_of_pair else 1
    if is_negative_strand:
        cycles = read_length * order + np.arange(read_length) * (-order)
    else:
        cycles = order + np.arange(read_length) * order
    if np.abs(cycles).max(initial=0) > max_cycle:
        raise ValueError(f"cycle exceeds maximum cycle value {max_cycle}")
    keys = (np.abs(cycles) << 1) | (cycles < 0)
    if indel:
        i = np.arange(read_length)
        keys = np.where((i < CUSHION_FOR_INDELS) | (i > read_length - CUSHION_FOR_INDELS - 1), -1, keys)
    return keys.astype(np.int32)


def cycle_from_key(key: int) -> int:
    cycle = key >> 1
    return -cycle if (key & 1) else cycle


def max_cycle_key(max_cycle: int = DEFAULT_MAX_CYCLE) -> int:
    return (max_cycle << 1) + 1


def max_context_key(context_size: int) -> int:
    key = context_size
    offset = LENGTH_BITS
    for _ in range(context_size):
        key |= 3 << offset
        offset += 2
    return key


def stranded_clipped_bases(bases: np.ndarray, quals: np.ndarray, is_negative_strand: bool,
                           low_qual_tail: int = DEFAULT_LOW_QUAL_TAIL) -> np.ndarray:
    """ContextCovariate.getStrandedClippedBytes: write N over low-qual ends
    (clipLowQualEnds WRITE_NS), then reverse-complement for negative strand."""
    n = len(bases)
    out = bases.copy()
    left = 0
    while left < n and quals[left] <= low_qual_tail:
        left += 1
    right = n - 1
    while right >= 0 and quals[right] <= low_qual_tail:
        right -= 1
    if left > right:
        return np.empty(0, np.uint8)
    out[:left] = ord("N")
    out[right + 1 :] = ord("N")
    if is_negative_strand:
        return reverse_complement(out)
    return out


_COMPLEMENT = np.arange(256, dtype=np.uint8)
for _a, _b in zip(b"ACGTacgt", b"TGCATGCA"):
    _COMPLEMENT[_a] = _b


def reverse_complement(bases: np.ndarray) -> np.ndarray:
    return _COMPLEMENT[bases[::-1]]


def read_context_covariate_keys(bases, quals, is_negative_strand,
                                mismatches_context_size=DEFAULT_MISMATCHES_CONTEXT_SIZE,
                                indels_context_size=DEFAULT_INDELS_CONTEXT_SIZE,
                                low_qual_tail=DEFAULT_LOW_QUAL_TAIL,
                                record_indels=True):
    """(mismatch_keys, indel_keys) per original read offset (ContextCovariate.recordValues).

    WRITE_NS clipping preserves length, so the stranded index mapping is
    offset <-> (len-1-offset) on the negative strand.
    """
    n = len(bases)
    stranded = stranded_clipped_bases(np.asarray(bases, np.uint8), np.asarray(quals), is_negative_strand, low_qual_tail)
    m_keys = np.zeros(n, np.int32)
    i_keys = np.zeros(n, np.int32) if record_indels else None
    ns = len(stranded)
    if ns:
        mk = context_keys(stranded, mismatches_context_size)
        pos = np.arange(ns)
        offs = (ns - 1 - pos) if is_negative_strand else pos
        m_keys[offs] = mk
        if record_indels:
            ik = context_keys(stranded, indels_context_size)
            i_keys[offs] = ik
    else:
        m_keys[:] = 0
        if record_indels:
            i_keys[:] = 0
    return m_keys, i_keys
