# Copied verbatim from gatk_tpu/utils/javarandom.py; only import lines may differ.
"""java.util.Random reimplementation (LCG + Marsaglia polar nextGaussian).

Needed to reproduce GATK outputs that consume Utils.getRandomGenerator()
(seed Utils.java:52 = 47382911): QualByDepth jitter for QD>35, downsampling, etc.
"""
from __future__ import annotations

import math

GATK_RANDOM_SEED = 47382911
_MULT = 0x5DEECE66D
_ADD = 0xB
_MASK = (1 << 48) - 1


class JavaRandom:
    def __init__(self, seed: int = GATK_RANDOM_SEED):
        self.set_seed(seed)

    def set_seed(self, seed: int):
        self._seed = (seed ^ _MULT) & _MASK
        self._next_gaussian = None

    def _next(self, bits: int) -> int:
        self._seed = (self._seed * _MULT + _ADD) & _MASK
        r = self._seed >> (48 - bits)
        return r

    def next_int(self, bound: int | None = None) -> int:
        if bound is None:
            r = self._next(32)
            return r - (1 << 32) if r >= (1 << 31) else r
        if bound <= 0:
            raise ValueError("bound must be positive")
        if (bound & -bound) == bound:  # power of two
            return (bound * self._next(31)) >> 31
        while True:
            bits = self._next(31)
            val = bits % bound
            if bits - val + (bound - 1) < (1 << 31):
                return val

    def next_double(self) -> float:
        return ((self._next(26) << 27) + self._next(27)) / float(1 << 53)

    def next_gaussian(self) -> float:
        if self._next_gaussian is not None:
            g = self._next_gaussian
            self._next_gaussian = None
            return g
        while True:
            v1 = 2 * self.next_double() - 1
            v2 = 2 * self.next_double() - 1
            s = v1 * v1 + v2 * v2
            if 0 < s < 1:
                break
        multiplier = math.sqrt(-2 * math.log(s) / s)
        self._next_gaussian = v2 * multiplier
        return v1 * multiplier


_global = JavaRandom()


def get_random_generator() -> JavaRandom:
    return _global


def reset_random_generator():
    _global.set_seed(GATK_RANDOM_SEED)
