# Copied verbatim from gatk_tpu/align/seed_extend.py; only import lines may differ.
"""Seed-and-extend short-read aligner.

Reference behavior: utils/bwa/BwaMemAligner (JNI bwa-mem) as used by PathSeq's
pathogen-alignment stage (PSBwaAligner.java) and ReadsPipelineSpark. This is a
from-scratch TPU-host design, not a bwa port: exact-kmer seeds against a sorted
(hash, position) index (vectorized numpy searchsorted lookups — the same
batched-membership idiom as the PathSeq kmer filter), diagonal-histogram
chaining, and banded Smith-Waterman extension via the native batch SW kernel.
Suited to the microbe-reference scale PathSeq aligns against; not a
whole-genome BWT aligner.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..io import sam

_COMP = np.arange(256, dtype=np.uint8)
for _a, _b in zip(b"ACGTacgt", b"TGCAtgca"):
    _COMP[_a] = _b


def revcomp(bases: np.ndarray) -> np.ndarray:
    return _COMP[bases[::-1]]


def _kmer_hashes(seq: np.ndarray, k: int) -> np.ndarray:
    """Rolling polynomial hashes of every kmer (uint64)."""
    n = len(seq)
    if n < k:
        return np.zeros(0, np.uint64)
    mult = np.uint64(1099511628211)
    nk = n - k + 1
    h = np.zeros(nk, np.uint64)
    s = seq.astype(np.uint64)
    for j in range(k):
        h = h * mult + s[j : j + nk]
    return h


@dataclass
class Alignment:
    contig_index: int
    pos: int                 # 0-based on the contig
    is_reverse: bool
    cigar_ops: np.ndarray
    cigar_lens: np.ndarray
    score: int
    mapq: int
    nm: int


class SeedExtendAligner:
    """Index a reference once; align reads via seeds + banded SW extension."""

    def __init__(self, contigs, k: int = 21, seed_stride: int = 1,
                 max_hits_per_kmer: int = 64, use_fm: bool | None = None):
        """contigs: [(name, bases uint8/bytes)].

        use_fm: seed via the native BWT/FM-index (align/fmindex.py — variable-
        length super-maximal exact matches, the bwa-mem seed model) instead of
        fixed-k kmer hashing. Default: auto-on when the native library is
        present and the reference is small enough for the O(n log^2 n) build."""
        self.k = k
        self.names = [n for n, _ in contigs]
        seqs = [np.frombuffer(bytes(s), np.uint8) if isinstance(s, (bytes, bytearray))
                else np.asarray(s, np.uint8) for _, s in contigs]
        self.lengths = [len(s) for s in seqs]
        self.offsets = np.zeros(len(seqs) + 1, np.int64)
        np.cumsum(np.asarray(self.lengths, np.int64), out=self.offsets[1:])
        self.ref = np.concatenate(seqs) if seqs else np.zeros(0, np.uint8)
        hashes = _kmer_hashes(self.ref, k)
        # drop kmers spanning contig boundaries
        pos = np.arange(len(hashes), dtype=np.int64)
        contig_of = np.searchsorted(self.offsets[1:], pos, side="right")
        valid = pos + k <= self.offsets[contig_of + 1]
        hashes, pos = hashes[valid], pos[valid]
        if seed_stride > 1:
            hashes, pos = hashes[::seed_stride], pos[::seed_stride]
        order = np.argsort(hashes, kind="stable")
        self.idx_hash = hashes[order]
        self.idx_pos = pos[order]
        self.max_hits = max_hits_per_kmer
        self.fm = None
        if use_fm is None:
            from . import fmindex

            use_fm = fmindex.available() and len(self.ref) <= (16 << 20)
        if use_fm:
            from .fmindex import FMIndex

            self.fm = FMIndex.build(list(zip(self.names, seqs)))

    def _seed_positions(self, read: np.ndarray):
        """[(diagonal, ref_pos, read_ofs)] arrays for one strand."""
        if self.fm is not None:
            return self._seed_positions_fm(read)
        h = _kmer_hashes(read, self.k)
        if not len(h):
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        lo = np.searchsorted(self.idx_hash, h, side="left")
        hi = np.searchsorted(self.idx_hash, h, side="right")
        counts = np.minimum(hi - lo, self.max_hits)
        total = int(counts.sum())
        diags = np.empty(total, np.int64)
        rpos = np.empty(total, np.int64)
        o = 0
        for i in range(len(h)):
            c = counts[i]
            if c:
                p = self.idx_pos[lo[i]: lo[i] + c]
                diags[o:o + c] = p - i
                rpos[o:o + c] = p
                o += c
        return diags[:o], rpos[:o]

    def _seed_positions_fm(self, read: np.ndarray):
        """FM-index SMEM seeds -> (diagonal, ref_pos) arrays (one strand)."""
        seeds = self.fm.seeds(read, min_len=min(self.k, max(8, len(read) // 8)),
                              max_hits_per_seed=self.max_hits)
        diags, rpos = [], []
        for q_start, length, hits in seeds:
            for ci, cpos in hits:
                g = int(self.offsets[ci]) + cpos
                # weight the diagonal by matched length so _best_diagonals'
                # support ranking counts matched bases, as with fixed-k seeds
                diags.extend([g - q_start] * max(1, length // 4))
                rpos.append(g)
        return (np.asarray(diags, np.int64) if diags else np.zeros(0, np.int64),
                np.asarray(rpos, np.int64) if rpos else np.zeros(0, np.int64))

    def _best_diagonals(self, diags, top_n=4, band=8):
        """Cluster seed diagonals within +-band; return top cluster anchors by
        support."""
        if not len(diags):
            return []
        d = np.sort(diags)
        # cluster: break where gap > band
        breaks = np.nonzero(np.diff(d) > band)[0]
        starts = np.concatenate([[0], breaks + 1])
        ends = np.concatenate([breaks + 1, [len(d)]])
        support = ends - starts
        order = np.argsort(-support)[:top_n]
        return [(int(d[starts[i]]), int(support[i])) for i in order]

    def align(self, bases: np.ndarray, min_score_frac: float = 0.5):
        """Best alignment for one read (both strands) or None."""
        from ..ops import smith_waterman as sw

        bases = np.asarray(bases, np.uint8)
        n = len(bases)
        candidates = []
        for is_rev, seq in ((False, bases), (True, revcomp(bases))):
            diags, _ = self._seed_positions(seq)
            for diag, support in self._best_diagonals(diags):
                candidates.append((is_rev, seq, diag, support))
        if not candidates:
            return None
        pad = 16
        best = None
        second = 0
        for is_rev, seq, diag, _sup in candidates:
            lo = max(diag - pad, 0)
            hi = min(diag + n + pad, len(self.ref))
            if hi - lo < self.k:
                continue
            window = self.ref[lo:hi]
            aln = sw.align(window, seq, sw.NEW_SW_PARAMETERS, sw.SOFTCLIP)
            if best is None or aln.score > best[0].score:
                if best is not None:
                    second = max(second, best[0].score)
                best = (aln, is_rev, lo, seq)
            else:
                second = max(second, aln.score)
        if best is None:
            return None
        aln, is_rev, lo, seq = best
        max_score = n * sw.NEW_SW_PARAMETERS.match
        if aln.score < min_score_frac * max_score:
            return None
        gpos = lo + aln.offset
        ci = int(np.searchsorted(self.offsets[1:], gpos, side="right"))
        cpos = gpos - int(self.offsets[ci])
        # NM: count mismatches + indel bases along the alignment
        nm = 0
        ri = gpos
        qi = 0
        for op, ln in zip(aln.cigar_ops, aln.cigar_lens):
            op, ln = int(op), int(ln)
            if op in (sam.OP_M, sam.OP_EQ, sam.OP_X):
                nm += int(np.count_nonzero(self.ref[ri:ri + ln] != seq[qi:qi + ln]))
                ri += ln
                qi += ln
            elif op == sam.OP_I:
                nm += ln
                qi += ln
            elif op == sam.OP_D:
                nm += ln
                ri += ln
            elif op == sam.OP_S:
                qi += ln
        mapq = int(min(60, max(0, (aln.score - second) * 60 / max(aln.score, 1))))
        return Alignment(ci, int(cpos), is_rev, aln.cigar_ops, aln.cigar_lens,
                         int(aln.score), mapq, nm)

    def align_all(self, bases: np.ndarray, min_score_frac: float = 0.5):
        """All candidate alignments (both strands, every supported diagonal),
        score-filtered and position-deduped — the BwaMemAligner MEM_F_ALL mode
        used by the realignment filter (RealignmentEngine.realign,
        realignmentfilter/RealignmentEngine.java:106-113)."""
        from ..ops import smith_waterman as sw

        bases = np.asarray(bases, np.uint8)
        n = len(bases)
        out = []
        seen = set()
        pad = 16
        max_score = n * sw.NEW_SW_PARAMETERS.match
        for is_rev, seq in ((False, bases), (True, revcomp(bases))):
            diags, _ = self._seed_positions(seq)
            for diag, _support in self._best_diagonals(diags, top_n=8):
                lo = max(diag - pad, 0)
                hi = min(diag + n + pad, len(self.ref))
                if hi - lo < self.k:
                    continue
                aln = sw.align(self.ref[lo:hi], seq, sw.NEW_SW_PARAMETERS, sw.SOFTCLIP)
                if aln.score < min_score_frac * max_score:
                    continue
                gpos = lo + aln.offset
                ci = int(np.searchsorted(self.offsets[1:], gpos, side="right"))
                cpos = gpos - int(self.offsets[ci])
                key = (ci, cpos // 16, is_rev)
                if key in seen:
                    continue
                seen.add(key)
                nm = 0
                ri, qi = gpos, 0
                for op, ln in zip(aln.cigar_ops, aln.cigar_lens):
                    op, ln = int(op), int(ln)
                    if op in (sam.OP_M, sam.OP_EQ, sam.OP_X):
                        nm += int(np.count_nonzero(self.ref[ri:ri + ln] != seq[qi:qi + ln]))
                        ri += ln
                        qi += ln
                    elif op == sam.OP_I:
                        nm += ln
                        qi += ln
                    elif op == sam.OP_D:
                        nm += ln
                        ri += ln
                    elif op == sam.OP_S:
                        qi += ln
                out.append(Alignment(ci, int(cpos), is_rev, aln.cigar_ops,
                                     aln.cigar_lens, int(aln.score), 0, nm))
        out.sort(key=lambda a: -a.score)
        return out
