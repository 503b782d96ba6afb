# Copied verbatim from gatk_tpu/align/fmindex.py; only import lines may differ.
"""FM-index (BWT) exact-seed engine — the bwa-mem-class index behind
SeedExtendAligner.

Reference behavior: utils/bwa/BwaMemIndex.java + BwaMemAligner.java bind
bwa's FM-index (.img) over JNI; seeds are super-maximal exact matches found
by backward search. Here the index is native C++ (native/fmindex): suffix
array by prefix doubling, BWT, rank checkpoints, sampled SA; this wrapper
adds contig bookkeeping and .fmi serialization (the .img equivalent)."""
from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB = None


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    path = os.path.join(os.path.dirname(__file__), "..", "..", "native",
                        "fmindex", "libfm_native.so")
    try:
        lib = ctypes.CDLL(os.path.abspath(path))
    except OSError:
        _LIB = False
        return False
    lib.fm_build.restype = ctypes.c_void_p
    lib.fm_build.argtypes = [np.ctypeslib.ndpointer(np.uint8), ctypes.c_int64]
    lib.fm_free.argtypes = [ctypes.c_void_p]
    lib.fm_search.restype = ctypes.c_int64
    lib.fm_search.argtypes = [ctypes.c_void_p, np.ctypeslib.ndpointer(np.uint8),
                              ctypes.c_int64,
                              np.ctypeslib.ndpointer(np.int64), ctypes.c_int64]
    lib.fm_seeds.restype = ctypes.c_int64
    lib.fm_seeds.argtypes = [ctypes.c_void_p, np.ctypeslib.ndpointer(np.uint8),
                             ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                             np.ctypeslib.ndpointer(np.int64), ctypes.c_int64]
    lib.fm_save_size.restype = ctypes.c_int64
    lib.fm_save_size.argtypes = [ctypes.c_void_p]
    lib.fm_save.argtypes = [ctypes.c_void_p, np.ctypeslib.ndpointer(np.uint8)]
    lib.fm_load.restype = ctypes.c_void_p
    lib.fm_load.argtypes = [np.ctypeslib.ndpointer(np.uint8), ctypes.c_int64]
    _LIB = lib
    return lib


def available() -> bool:
    return bool(_load())


class FMIndex:
    """FM-index over concatenated contigs with global->contig mapping."""

    MAGIC = b"GTFM\x01"

    def __init__(self, handle, names, offsets, lengths):
        self._h = handle
        self.names = list(names)
        self.offsets = np.asarray(offsets, np.int64)  # start of each contig
        self.lengths = np.asarray(lengths, np.int64)

    @classmethod
    def build(cls, contigs):
        """contigs: [(name, uint8 bases)]; contigs are separated by an N so
        matches never straddle a boundary."""
        lib = _load()
        if not lib:
            raise RuntimeError("libfm_native.so unavailable")
        names, offsets, lengths, parts = [], [], [], []
        off = 0
        for name, seq in contigs:
            seq = np.asarray(seq, np.uint8)
            names.append(name)
            offsets.append(off)
            lengths.append(len(seq))
            parts.append(seq)
            parts.append(np.frombuffer(b"N", np.uint8))
            off += len(seq) + 1
        cat = np.ascontiguousarray(np.concatenate(parts))
        h = lib.fm_build(cat, np.int64(len(cat)))
        return cls(h, names, offsets, lengths)

    def __del__(self):
        lib = _LIB
        if lib and getattr(self, "_h", None):
            lib.fm_free(self._h)
            self._h = None

    def to_contig(self, gpos: int):
        """global position -> (contig_index, contig_pos) or None (separator)."""
        i = int(np.searchsorted(self.offsets, gpos, side="right")) - 1
        if i < 0:
            return None
        cp = gpos - int(self.offsets[i])
        if cp >= int(self.lengths[i]):
            return None
        return i, cp

    def search(self, pattern, max_hits: int = 64):
        """All (contig_index, pos) exact occurrences of pattern (n_total,
        [(ci, pos)...]) capped at max_hits."""
        lib = _load()
        pat = np.ascontiguousarray(np.asarray(pattern, np.uint8))
        out = np.zeros(max_hits, np.int64)
        n = int(lib.fm_search(self._h, pat, np.int64(len(pat)), out,
                              np.int64(max_hits)))
        hits = []
        for g in out[:min(n, max_hits)]:
            loc = self.to_contig(int(g))
            if loc is not None:
                hits.append(loc)
        return n, hits

    def seeds(self, query, min_len: int = 19, max_hits_per_seed: int = 8,
              max_seeds: int = 64):
        """SMEM-lite exact seeds: [(q_start, length, [(ci, pos)...])]."""
        lib = _load()
        q = np.ascontiguousarray(np.asarray(query, np.uint8))
        rec = 3 + max_hits_per_seed
        out = np.zeros(max_seeds * rec, np.int64)
        n = int(lib.fm_seeds(self._h, q, np.int64(len(q)), np.int64(min_len),
                             np.int64(max_hits_per_seed), out,
                             np.int64(len(out))))
        res = []
        for i in range(n):
            r = out[i * rec:(i + 1) * rec]
            hits = []
            for g in r[3:3 + int(r[2])]:
                loc = self.to_contig(int(g))
                if loc is not None:
                    hits.append(loc)
            res.append((int(r[0]), int(r[1]), hits))
        return res

    def save(self, path: str):
        lib = _load()
        size = int(lib.fm_save_size(self._h))
        buf = np.zeros(size, np.uint8)
        lib.fm_save(self._h, buf)
        with open(path, "wb") as fh:
            fh.write(self.MAGIC)
            meta = "\n".join(
                f"{n}\t{int(o)}\t{int(l)}" for n, o, l in
                zip(self.names, self.offsets, self.lengths)).encode()
            fh.write(len(meta).to_bytes(8, "little"))
            fh.write(meta)
            fh.write(buf.tobytes())

    @classmethod
    def load(cls, path: str):
        lib = _load()
        if not lib:
            raise RuntimeError("libfm_native.so unavailable")
        with open(path, "rb") as fh:
            magic = fh.read(5)
            if magic != cls.MAGIC:
                raise ValueError(f"{path}: not a gatk_tpu FM-index")
            mlen = int.from_bytes(fh.read(8), "little")
            meta = fh.read(mlen).decode()
            blob = np.frombuffer(fh.read(), np.uint8)
        names, offsets, lengths = [], [], []
        for ln in meta.splitlines():
            n, o, l = ln.split("\t")
            names.append(n)
            offsets.append(int(o))
            lengths.append(int(l))
        h = lib.fm_load(np.ascontiguousarray(blob), np.int64(len(blob)))
        return cls(h, names, offsets, lengths)
