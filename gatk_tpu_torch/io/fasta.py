# Copied verbatim from gatk_tpu/io/fasta.py; only import lines may differ.
"""Indexed FASTA reference reader (CachingIndexedFastaSequenceFile equivalent).

Reference behavior: utils/fasta/CachingIndexedFastaSequenceFile.java +
engine/ReferenceDataSource.java. Supports .fai-indexed plain FASTA; whole-contig
loads are cached as uint8 arrays (uppercased, IUPAC handling left to callers).
"""
from __future__ import annotations

import os

import numpy as np


class FastaReference:
    def __init__(self, path: str):
        from .gatk_path import resolve

        path = resolve(path)  # file:// and mirrored cloud URIs (GATKPath)
        self.path = path
        fai = path + ".fai"
        self.index = {}
        self.contig_order = []
        if os.path.exists(fai):
            with open(fai) as fh:
                for line in fh:
                    name, length, offset, linebases, linewidth = line.split()[:5]
                    self.index[name] = (int(length), int(offset), int(linebases), int(linewidth))
                    self.contig_order.append(name)
            self._fh = open(path, "rb")
            self._full = None
        else:
            # small unindexed FASTA: load fully
            self._fh = None
            self._full = {}
            name = None
            chunks = []
            with open(path, "rb") as fh:
                for raw in fh:
                    if raw.startswith(b">"):
                        if name is not None:
                            self._full[name] = b"".join(chunks)
                        name = raw[1:].split()[0].decode()
                        self.contig_order.append(name)
                        chunks = []
                    else:
                        chunks.append(raw.strip())
            if name is not None:
                self._full[name] = b"".join(chunks)
            for n, s in self._full.items():
                self.index[n] = (len(s), 0, 0, 0)
        self._cache_name = None
        self._cache_seq = None

    def contig_length(self, name: str) -> int:
        return self.index[name][0]

    def contigs(self):
        return list(self.contig_order)

    def _load_contig(self, name: str) -> np.ndarray:
        if self._cache_name == name:
            return self._cache_seq
        if self._full is not None:
            seq = np.frombuffer(self._full[name], dtype=np.uint8)
        else:
            length, offset, linebases, linewidth = self.index[name]
            nlines = (length + linebases - 1) // linebases
            nbytes = length + nlines * (linewidth - linebases)
            self._fh.seek(offset)
            raw = np.frombuffer(self._fh.read(nbytes), dtype=np.uint8)
            if linewidth == linebases:
                seq = raw[:length]
            else:
                mat = np.full((nlines, linewidth), ord("\n"), np.uint8)
                flat = mat.reshape(-1)
                flat[: len(raw)] = raw
                seq = mat[:, :linebases].reshape(-1)[:length]
        # uppercase in place (a..z -> A..Z)
        seq = np.where((seq >= ord("a")) & (seq <= ord("z")), seq - 32, seq).astype(np.uint8)
        self._cache_name = name
        self._cache_seq = seq
        return seq

    def fetch(self, name: str, start: int = 0, end: int | None = None) -> np.ndarray:
        """0-based half-open slice of a contig as uint8 ASCII (uppercase)."""
        seq = self._load_contig(name)
        if end is None:
            end = len(seq)
        if start < 0 or end > len(seq):
            raise ValueError(f"interval {name}:{start}-{end} out of bounds (len {len(seq)})")
        return seq[start:end]

    def fetch_bytes(self, name: str, start: int = 0, end: int | None = None) -> bytes:
        return self.fetch(name, start, end).tobytes()
