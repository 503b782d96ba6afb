# Copied verbatim from gatk_tpu/assembly/rtgraph.py; only import lines may differ.
"""Read-threading de Bruijn graph (AbstractReadThreadingGraph/ReadThreadingGraph
equivalents).

Reference behavior: readthreading/AbstractReadThreadingGraph.java (threading
:270-320, extendChainByOne :1009-1031, addRead quality runs :1040-1065),
readthreading/ReadThreadingGraph.java (non-unique kmer handling :67-141,
unique-kmer merge targets :187-193).

Vertices are integer ids; kmers are bytes. Non-unique kmers (duplicated within any
single added sequence) never become merge targets — threading through them creates
fresh vertices, preserving read-path identity like the reference.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np

DEFAULT_MIN_BASE_QUAL = 10

_NATIVE = None
_NATIVE_TRIED = False


def _load_native():
    """ctypes binding to native/rtgraph/librtgraph_native.so — the C++ port of
    the threading hot loop (exact same graph; see rtgraph_native.cpp)."""
    global _NATIVE, _NATIVE_TRIED
    if _NATIVE_TRIED:
        return _NATIVE
    _NATIVE_TRIED = True
    import ctypes
    import os

    so = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..",
                                      "native", "rtgraph", "librtgraph_native.so"))
    if not os.path.exists(so) or os.environ.get("GATK_TPU_NO_NATIVE_RTGRAPH"):
        return None
    try:
        lib = ctypes.CDLL(so)
        u8 = np.ctypeslib.ndpointer(np.uint8)
        i32 = np.ctypeslib.ndpointer(np.int32)
        i64 = np.ctypeslib.ndpointer(np.int64)
        c = ctypes
        lib.rtg_build.restype = c.c_void_p
        lib.rtg_build.argtypes = [c.c_int32, u8, i64, i64, i64, i64, u8,
                                  c.c_int64, c.POINTER(c.c_int64),
                                  c.POINTER(c.c_int64), c.POINTER(c.c_int64),
                                  c.POINTER(c.c_int64), c.POINTER(c.c_int32)]
        lib.rtg_export.restype = None
        lib.rtg_export.argtypes = [c.c_void_p, u8, i32, i32, i64, u8, i32, u8]
        lib.rtg_free.restype = None
        lib.rtg_free.argtypes = [c.c_void_p]
        f64 = np.ctypeslib.ndpointer(np.float64)
        lib.rtg_assemble.restype = c.c_void_p
        lib.rtg_assemble.argtypes = [c.c_int32, u8, i64, i64, i64, i64, u8,
                                     c.c_int64, c.c_int32, c.c_int32, c.c_int32,
                                     c.POINTER(c.c_int32), c.POINTER(c.c_int64),
                                     c.POINTER(c.c_int64)]
        lib.rtg_asm_export.restype = None
        lib.rtg_asm_export.argtypes = [c.c_void_p, u8, i64, f64, i64]
        lib.rtg_asm_free.restype = None
        lib.rtg_asm_free.argtypes = [c.c_void_p]
        _NATIVE = lib
    except OSError:
        _NATIVE = None
    return _NATIVE


@dataclass
class Edge:
    multiplicity: int = 0
    is_ref: bool = False


class ReadRuns:
    """K-independent usable-run decomposition of a read set (base != N and
    qual >= min_base_qual), computed once and shared across the kmer-size
    escalation attempts of ReadThreadingAssembler.createGraph."""

    def __init__(self, reads, min_base_qual: int):
        self.names = [r.name for r in reads]
        self.seqs = [bytes(r.bases) for r in reads]
        n_reads = len(reads)
        lens = np.fromiter((len(s) for s in self.seqs), np.int64, n_reads) \
            if n_reads else np.zeros(0, np.int64)
        total = int(lens.sum())
        if total == 0:
            self.read_idx = np.zeros(0, np.int64)
            self.starts = np.zeros(0, np.int64)
            self.ends = np.zeros(0, np.int64)
            self.cat = np.zeros(0, np.uint8)
            self.cat_offs = np.zeros(n_reads + 1, np.int64)
            return
        B = np.empty(total, np.uint8)
        Q = np.empty(total, np.uint8)
        offs = np.zeros(n_reads + 1, np.int64)
        np.cumsum(lens, out=offs[1:])
        for i, r in enumerate(reads):
            B[offs[i]:offs[i + 1]] = r.bases
            Q[offs[i]:offs[i + 1]] = r.quals
        # retained for the native assembly fast path (rtg_assemble marshals
        # run windows into this concatenated buffer without re-copying reads)
        self.cat = B
        self.cat_offs = offs
        usable = (B != ord("N")) & (Q >= min_base_qual)
        padded = np.zeros(total + n_reads + 1, np.int8)
        rid = np.repeat(np.arange(n_reads), lens)
        padded[np.arange(total) + rid + 1] = usable
        d = np.diff(padded)
        starts = np.nonzero(d == 1)[0]
        ends = np.nonzero(d == -1)[0]
        srid = np.searchsorted(offs[1:] + np.arange(n_reads), starts, side="right")
        base = offs[srid] + srid
        self.read_idx = srid
        self.starts = starts - base
        self.ends = ends - base


def assemble_attempt_native(runs: "ReadRuns", ref_bytes: bytes, k: int,
                            prune_factor: int, num_best: int,
                            recover_dangling: bool = True):
    """One full native assembly attempt at kmer size k: graph build + cycle/
    quality checks + prune + dangling recovery + SeqGraph simplify + k-best
    (rtg_assemble in native/rtgraph). Returns (status, paths) where status is
    0 ok / 3 cycles / 4 low-quality / 5 no-ref-path and paths is a list of
    (bases, score, weakness) identical to seqgraph.find_k_best_haplotypes over
    the Python-built graph. Returns None if the native library is unavailable."""
    import ctypes

    lib = _load_native()
    if lib is None:
        return None
    keep = (runs.ends - runs.starts) >= k
    ridx = runs.read_idx[keep]
    n_runs = int(keep.sum())
    n = n_runs + 1
    # one ref+reads concatenation per region, shared across the kmer ladder
    cache = getattr(runs, "_native_buf", None)
    if cache is None or cache[0] is not ref_bytes:
        ref_arr = np.frombuffer(ref_bytes, np.uint8)
        runs._native_buf = cache = (
            ref_bytes, np.ascontiguousarray(np.concatenate([ref_arr, runs.cat])))
    seq_data = cache[1]
    off = np.empty(n, np.int64)
    starts = np.empty(n, np.int64)
    stops = np.empty(n, np.int64)
    off[0] = 0
    starts[0] = 0
    stops[0] = len(ref_bytes)
    off[1:] = len(ref_bytes) + runs.cat_offs[ridx]
    starts[1:] = runs.starts[keep]
    stops[1:] = runs.ends[keep]
    counts = np.ones(n, np.int64)
    is_ref = np.zeros(n, np.uint8)
    is_ref[0] = 1
    status = ctypes.c_int32()
    n_haps = ctypes.c_int64()
    total_bases = ctypes.c_int64()
    handle = lib.rtg_assemble(
        np.int32(k), seq_data, off, starts, stops, counts,
        is_ref, np.int64(n), np.int32(prune_factor),
        np.int32(1 if recover_dangling else 0), np.int32(num_best),
        ctypes.byref(status), ctypes.byref(n_haps), ctypes.byref(total_bases))
    if not handle:
        raise MemoryError("rtg_assemble failed")
    try:
        if status.value in (1, 2):
            raise ValueError("two reference sources" if status.value == 1
                             else "unique kmer merging into reference path")
        nh = n_haps.value
        bases_buf = np.zeros(max(1, total_bases.value), np.uint8)
        hlens = np.zeros(max(1, nh), np.int64)
        scores = np.zeros(max(1, nh), np.float64)
        weakness = np.zeros(max(1, nh), np.int64)
        if nh:
            lib.rtg_asm_export(handle, bases_buf, hlens, scores, weakness)
    finally:
        lib.rtg_asm_free(handle)
    paths = []
    bb = bases_buf.tobytes()
    o = 0
    for i in range(nh):
        L = int(hlens[i])
        paths.append((bb[o:o + L], float(scores[i]), int(weakness[i])))
        o += L
    return int(status.value), paths


@dataclass
class SeqForKmers:
    name: str
    seq: bytes
    start: int
    stop: int
    count: int
    is_ref: bool


class ReadThreadingGraph:
    def __init__(self, kmer_size: int, min_base_qual: int = DEFAULT_MIN_BASE_QUAL):
        self.kmer_size = kmer_size
        self.min_base_qual = min_base_qual
        self.pending: list[SeqForKmers] = []
        self.already_built = False
        # graph storage
        self.vertex_seq: list[bytes] = []  # vertex id -> kmer bytes
        self.out_edges: list[dict] = []  # vid -> {target_vid: Edge}
        self.in_edges: list[dict] = []  # vid -> {source_vid: Edge}
        self.out_by_base: list[dict] = []  # vid -> {last base: first target vid}
        self.kmer_to_vertex: dict = {}  # unique kmer -> vid
        self.non_unique_kmers: set = set()
        self.ref_path: list[int] | None = None
        self.ref_source_vid: int | None = None

    # ---- construction ----------------------------------------------------------
    def add_sequence(self, name: str, seq: bytes, start: int, stop: int, count: int, is_ref: bool):
        assert not self.already_built
        self.pending.append(SeqForKmers(name, seq, start, stop, count, is_ref))

    def add_read(self, name: str, bases: np.ndarray, quals: np.ndarray):
        """Split the read into maximal usable runs and add those >= kmer size."""
        seq = bytes(bases)
        n = len(seq)
        if n == 0:
            return self
        b = np.frombuffer(seq, np.uint8)
        usable = (b != ord("N")) & (np.asarray(quals) >= self.min_base_qual)
        # run boundaries of the usable mask
        padded = np.empty(n + 2, np.int8)
        padded[0] = padded[-1] = 0
        padded[1:-1] = usable
        d = np.diff(padded)
        starts = np.nonzero(d == 1)[0]
        ends = np.nonzero(d == -1)[0]
        for st, en in zip(starts, ends):
            if en - st >= self.kmer_size:
                self.add_sequence(f"{name}_{st}_{en}", seq, int(st), int(en), 1, False)
        return self

    def add_reads(self, reads, runs=None):
        """Batched add_read: one vectorized usable-run pass over ALL reads
        (AbstractReadThreadingGraph.addRead quality runs :1040-1065).

        runs: a precomputed ReadRuns (k-independent run decomposition) shared
        across kmer-size escalation attempts, so the read concatenation isn't
        re-done per attempt."""
        if runs is not None:
            k = self.kmer_size
            keep = (runs.ends - runs.starts) >= k
            for st, en, i in zip(runs.starts[keep], runs.ends[keep],
                                 runs.read_idx[keep]):
                self.add_sequence(f"{runs.names[i]}_{st}_{en}", runs.seqs[i],
                                  int(st), int(en), 1, False)
            return self
        if not reads:
            return self
        lens = np.fromiter((len(r.bases) for r in reads), np.int64, len(reads))
        total = int(lens.sum())
        if total == 0:
            return self
        B = np.empty(total, np.uint8)
        Q = np.empty(total, np.uint8)
        offs = np.zeros(len(reads) + 1, np.int64)
        np.cumsum(lens, out=offs[1:])
        for i, r in enumerate(reads):
            B[offs[i]:offs[i + 1]] = r.bases
            Q[offs[i]:offs[i + 1]] = r.quals
        usable = (B != ord("N")) & (Q >= self.min_base_qual)
        # break runs at read boundaries: flags padded per read
        padded = np.zeros(total + len(reads) + 1, np.int8)
        # position of each base in the padded stream: offset + read index + 1
        rid = np.repeat(np.arange(len(reads)), lens)
        padded[np.arange(total) + rid + 1] = usable
        d = np.diff(padded)
        starts = np.nonzero(d == 1)[0]
        ends = np.nonzero(d == -1)[0]
        k = self.kmer_size
        keep = (ends - starts) >= k
        starts, ends = starts[keep], ends[keep]
        # map back to (read, in-read offsets): base j of read i sits at padded
        # position offs[i]+j+i+1, so its d-index (run boundary) is offs[i]+j+i
        srid = np.searchsorted(offs[1:] + np.arange(len(reads)),
                               starts, side="right")
        for st, en, i in zip(starts, ends, srid):
            base = offs[i] + i
            st_i = int(st - base)
            en_i = int(en - base)
            r = reads[i]
            self.add_sequence(f"{r.name}_{st_i}_{en_i}", bytes(r.bases),
                              st_i, en_i, 1, False)
        return self

    def _new_vertex(self, kmer: bytes) -> int:
        vid = len(self.vertex_seq)
        self.vertex_seq.append(kmer)
        self.out_edges.append({})
        self.in_edges.append({})
        self.out_by_base.append({})
        # track unique kmers only (ReadThreadingGraph.trackKmer)
        if kmer not in self.non_unique_kmers and kmer not in self.kmer_to_vertex:
            self.kmer_to_vertex[kmer] = vid
        return vid

    def _add_edge(self, src: int, dst: int, count: int, is_ref: bool):
        e = self.out_edges[src].get(dst)
        if e is None:
            e = Edge(0, False)
            self.out_edges[src][dst] = e
            self.in_edges[dst][src] = e
            # memo for _extend_chain: first-inserted target per final base
            # (matches the scan-in-insertion-order semantics below)
            self.out_by_base[src].setdefault(self.vertex_seq[dst][-1], dst)
        e.multiplicity += count
        e.is_ref = e.is_ref or is_ref

    def build(self):
        if self.already_built:
            return self
        lib = _load_native()
        if lib is not None:
            return self._build_native(lib)
        # non-unique kmers: duplicated within any single sequence. One
        # vectorized pass over ALL pending sequences: per-position rolling
        # hashes mixed with the sequence id, one global np.unique, then
        # byte-confirmation of hash-duplicate candidates only — exact (hash
        # collisions create false candidates, never false negatives) and ~100x
        # faster than the per-position bytes-slice scan.
        k = self.kmer_size
        segs = [np.frombuffer(s.seq, np.uint8)[s.start : s.stop] for s in self.pending]
        if segs:
            lens = np.fromiter((len(b) for b in segs), np.int64, len(segs))
            cat = np.concatenate(segs).astype(np.uint64)
            n = len(cat)
            if n >= k:
                mult = np.uint64(1099511628211)
                nk = n - k + 1
                h = np.zeros(nk, np.uint64)
                for j in range(k):
                    h = h * mult + cat[j : j + nk]
                seq_id = np.repeat(np.arange(len(segs), dtype=np.uint64), lens)
                # a kmer starting at p is valid iff it lies inside one segment
                valid = (seq_id[:nk] == seq_id[k - 1 :]) & (lens[seq_id[:nk].astype(np.int64)] >= k)
                pos = np.nonzero(valid)[0]
                hh = h[pos] * np.uint64(0x9E3779B97F4A7C15) + seq_id[pos]
                _, inv, counts = np.unique(hh, return_inverse=True, return_counts=True)
                cand = pos[counts[inv] > 1]
                if cand.size:
                    offs = np.zeros(len(segs) + 1, np.int64)
                    np.cumsum(lens, out=offs[1:])
                    seen_per_seq: dict = {}
                    for p in cand:
                        sid = int(seq_id[p])
                        s = self.pending[sid]
                        i = s.start + int(p) - int(offs[sid])
                        km = s.seq[i : i + k]
                        seen = seen_per_seq.setdefault(sid, set())
                        if km in seen:
                            self.non_unique_kmers.add(km)
                        else:
                            seen.add(km)
        for s in self.pending:
            self._thread_sequence(s)
        self.already_built = True
        # retained for junction-tree generation (JunctionTreeLinkedDeBruijnGraph
        # threads the same pending sequences a second time)
        self.retained_sequences = self.pending
        self.pending = []
        return self

    def _build_native(self, lib):
        """Native build: identical graph to the python path (same creation
        order, non-unique rule, first-match extension); python-side structures
        reconstructed from the exported arrays."""
        import ctypes

        k = self.kmer_size
        n = len(self.pending)
        seq_data = np.frombuffer(b"".join(s.seq for s in self.pending), np.uint8) \
            if n else np.zeros(0, np.uint8)
        off = np.zeros(n, np.int64)
        lens = np.fromiter((len(s.seq) for s in self.pending), np.int64, n) \
            if n else np.zeros(0, np.int64)
        if n > 1:
            np.cumsum(lens[:-1], out=off[1:])
        starts = np.fromiter((s.start for s in self.pending), np.int64, n)
        stops = np.fromiter((s.stop for s in self.pending), np.int64, n)
        counts = np.fromiter((s.count for s in self.pending), np.int64, n)
        is_ref = np.fromiter((1 if s.is_ref else 0 for s in self.pending),
                             np.uint8, n)
        nv = ctypes.c_int64()
        ne = ctypes.c_int64()
        nrp = ctypes.c_int64()
        nnu = ctypes.c_int64()
        err = ctypes.c_int32()
        handle = lib.rtg_build(
            np.int32(k), np.ascontiguousarray(seq_data), off, starts, stops,
            counts, is_ref, np.int64(n), ctypes.byref(nv), ctypes.byref(ne),
            ctypes.byref(nrp), ctypes.byref(nnu), ctypes.byref(err))
        if not handle:
            raise MemoryError("rtg_build failed")
        try:
            kmers = np.zeros(nv.value * k, np.uint8)
            esrc = np.zeros(ne.value, np.int32)
            edst = np.zeros(ne.value, np.int32)
            emult = np.zeros(ne.value, np.int64)
            eref = np.zeros(ne.value, np.uint8)
            rp = np.zeros(nrp.value, np.int32)
            nu = np.zeros(nnu.value * k, np.uint8)
            lib.rtg_export(handle, kmers, esrc, edst, emult, eref, rp, nu)
        finally:
            lib.rtg_free(handle)
        if err.value == 1:
            raise ValueError("two reference sources")
        if err.value == 2:
            raise ValueError("unique kmer merging into reference path")

        kb = kmers.tobytes()
        self.vertex_seq = [kb[i * k:(i + 1) * k] for i in range(nv.value)]
        self.out_edges = [{} for _ in range(nv.value)]
        self.in_edges = [{} for _ in range(nv.value)]
        self.out_by_base = [{} for _ in range(nv.value)]
        for i in range(ne.value):
            s, d = int(esrc[i]), int(edst[i])
            e = Edge(int(emult[i]), bool(eref[i]))
            self.out_edges[s][d] = e
            self.in_edges[d][s] = e
            self.out_by_base[s].setdefault(self.vertex_seq[d][-1], d)
        nub = nu.tobytes()
        self.non_unique_kmers = {nub[i * k:(i + 1) * k] for i in range(nnu.value)}
        self.kmer_to_vertex = {}
        for vid, km in enumerate(self.vertex_seq):
            if km not in self.non_unique_kmers and km not in self.kmer_to_vertex:
                self.kmer_to_vertex[km] = vid
        if nrp.value:
            self.ref_path = [int(x) for x in rp]
            self.ref_source_vid = self.ref_path[0]
        self.already_built = True
        self.retained_sequences = self.pending
        self.pending = []
        return self

    def _find_start(self, s: SeqForKmers) -> int:
        if s.is_ref:
            return s.start
        for i in range(s.start, s.stop - self.kmer_size):
            if s.seq[i : i + self.kmer_size] not in self.non_unique_kmers:
                return i
        return -1

    def _thread_sequence(self, s: SeqForKmers):
        start_pos = self._find_start(s)
        if start_pos == -1:
            return
        kmer0 = s.seq[start_pos : start_pos + self.kmer_size]
        vid = self.kmer_to_vertex.get(kmer0)
        if vid is None or kmer0 in self.non_unique_kmers:
            vid = self._new_vertex(kmer0)
        self._increase_counts_backwards(vid, s, start_pos)
        if s.is_ref:
            if self.ref_source_vid is not None:
                raise ValueError("two reference sources")
            self.ref_path = [vid]
            self.ref_source_vid = vid
        for i in range(start_pos + 1, s.stop - self.kmer_size + 1):
            vid = self._extend_chain(vid, s.seq, i, s.count, s.is_ref)
            if s.is_ref:
                self.ref_path.append(vid)

    def _extend_chain(self, prev: int, seq: bytes, kmer_start: int, count: int, is_ref: bool) -> int:
        next_base = seq[kmer_start + self.kmer_size - 1]
        # O(1) fast path: the memo holds the first-inserted target per final
        # base; validate against out_edges (pruning may remove edges), falling
        # back to the insertion-order scan on a stale entry.
        tgt = self.out_by_base[prev].get(next_base)
        if tgt is not None:
            e = self.out_edges[prev].get(tgt)
            if e is not None:
                e.multiplicity += count
                return tgt
        for tgt, e in self.out_edges[prev].items():
            if self.vertex_seq[tgt][-1] == next_base:
                e.multiplicity += count
                self.out_by_base[prev][next_base] = tgt
                return tgt
        kmer = seq[kmer_start : kmer_start + self.kmer_size]
        merge = None
        if kmer not in self.non_unique_kmers:
            merge = self.kmer_to_vertex.get(kmer)
            if is_ref and merge is not None:
                raise ValueError("unique kmer merging into reference path")
        nxt = self._new_vertex(kmer) if merge is None else merge
        self._add_edge(prev, nxt, count, is_ref)
        return nxt

    def _increase_counts_backwards(self, start_vid: int, s: SeqForKmers, start_pos: int):
        """Credit edges backwards from the threading start while the predecessor
        kmer matches the sequence (increaseCountsInMatchedKmers): walk back one
        vertex at a time while exactly one in-edge source equals the expected
        preceding kmer."""
        vid = start_vid
        pos = start_pos  # kmer start position of current vertex
        while pos > s.start:
            want = s.seq[pos - 1 : pos - 1 + self.kmer_size]
            matches = [
                (src, e) for src, e in self.in_edges[vid].items() if self.vertex_seq[src] == want
            ]
            if len(matches) != 1:
                break
            src, e = matches[0]
            e.multiplicity += s.count
            vid = src
            pos -= 1

    # ---- queries ---------------------------------------------------------------
    @property
    def num_vertices(self):
        return len(self.vertex_seq)

    def sources(self):
        return [v for v in range(self.num_vertices) if not self.in_edges[v]]

    def sinks(self):
        return [v for v in range(self.num_vertices) if not self.out_edges[v]]

    def ref_sink(self):
        return self.ref_path[-1] if self.ref_path else None

    def ref_source(self):
        return self.ref_path[0] if self.ref_path else None

    def has_cycles(self) -> bool:
        """DFS cycle check."""
        color = [0] * self.num_vertices
        for root in range(self.num_vertices):
            if color[root]:
                continue
            stack = [(root, iter(self.out_edges[root]))]
            color[root] = 1
            while stack:
                v, it = stack[-1]
                advanced = False
                for w in it:
                    if color[w] == 1:
                        return True
                    if color[w] == 0:
                        color[w] = 1
                        stack.append((w, iter(self.out_edges[w])))
                        advanced = True
                        break
                if not advanced:
                    color[v] = 2
                    stack.pop()
        return False

    def is_low_quality(self) -> bool:
        """>20% non-unique kmers (ReadThreadingGraph.isLowQualityGraph)."""
        return len(self.non_unique_kmers) * 4 > len(self.kmer_to_vertex)

    # ---- pruning & cleanup -----------------------------------------------------
    def _linear_chains(self):
        """Maximal linear chains of edges: paths through vertices with in==out==1."""

        def is_chain_internal(v):
            return len(self.in_edges[v]) == 1 and len(self.out_edges[v]) == 1

        chains = []
        visited_edges = set()
        for v in range(self.num_vertices):
            if is_chain_internal(v):
                continue
            for w in self.out_edges[v]:
                if (v, w) in visited_edges:
                    continue
                chain = [(v, w)]
                visited_edges.add((v, w))
                cur = w
                while is_chain_internal(cur):
                    nxt = next(iter(self.out_edges[cur]))
                    if (cur, nxt) in visited_edges:
                        break
                    chain.append((cur, nxt))
                    visited_edges.add((cur, nxt))
                    cur = nxt
                chains.append(chain)
        # cycles made purely of internal vertices are unreachable above; fine for DAG use
        return chains

    def prune_low_weight_chains(self, prune_factor: int, remove_orphans: bool = True):
        """LowWeightChainPruner: drop chains whose every edge has multiplicity <
        pruneFactor and no reference edge. remove_orphans=False keeps dangling
        chains alive for dangling-end recovery (the reference removes
        paths-not-connected-to-ref only AFTER recovery)."""
        to_remove = []
        for chain in self._linear_chains():
            if all(
                self.out_edges[a][b].multiplicity < prune_factor and not self.out_edges[a][b].is_ref
                for a, b in chain
            ):
                to_remove.extend(chain)
        for a, b in to_remove:
            self.out_edges[a].pop(b, None)
            self.in_edges[b].pop(a, None)
        if remove_orphans:
            self._remove_orphans()

    def _remove_orphans(self):
        """Remove vertices unreachable from ref source or not reaching ref sink."""
        if self.ref_path is None:
            return
        fwd = self._reachable(self.ref_source(), self.out_edges)
        bwd = self._reachable(self.ref_sink(), self.in_edges)
        keep = fwd & bwd
        for v in range(self.num_vertices):
            if v not in keep:
                for w in list(self.out_edges[v]):
                    self.in_edges[w].pop(v, None)
                self.out_edges[v] = {}
                for u in list(self.in_edges[v]):
                    self.out_edges[u].pop(v, None)
                self.in_edges[v] = {}

    def _reachable(self, start, adj):
        seen = {start}
        stack = [start]
        while stack:
            v = stack.pop()
            for w in adj[v]:
                if w not in seen:
                    seen.add(w)
                    stack.append(w)
        return seen

    # ---- dangling-end recovery ---------------------------------------------------
    # Reference behavior: AbstractReadThreadingGraph.recoverDanglingTails/Heads
    # :400-452, findPathUpwardsToLowestCommonAncestor :724-733, merge logic
    # :549-607. SW vs the reference path with STANDARD_NGS + LEADING_INDEL.

    def _suffix(self, vid: int) -> int:
        return self.vertex_seq[vid][-1]

    def _is_ref_vertex(self, vid: int) -> bool:
        return any(e.is_ref for e in self.in_edges[vid].values()) or any(
            e.is_ref for e in self.out_edges[vid].values()
        )

    def _find_path_up_to_lca(self, vertex: int, prune_factor: int):
        """Chain upwards from a dangling sink to the lowest common ancestor
        (first vertex with out-degree > 1); LCA first, sink last; None if the
        chain hits a pruned edge, a merge, or no divergence."""
        path = [vertex]
        v = vertex
        seen = {vertex}
        while len(self.in_edges[v]) == 1 and len(self.out_edges[v]) < 2:
            (u, e), = self.in_edges[v].items()
            if e.multiplicity < prune_factor and not e.is_ref:
                return None
            if u in seen:
                return None
            seen.add(u)
            path.append(u)
            v = u
        if len(self.out_edges[v]) > 1 and v != vertex:
            return path[::-1]
        return None

    def _find_path_down_to_ref(self, vertex: int, prune_factor: int):
        """Chain downwards from a dangling head to the first reference vertex;
        common descendant first, head last; None if blocked."""
        path = [vertex]
        v = vertex
        seen = {vertex}
        while not (self._is_ref_vertex(v) or len(self.out_edges[v]) != 1):
            (w, e), = self.out_edges[v].items()
            if e.multiplicity < prune_factor and not e.is_ref:
                return None
            if w in seen:
                return None
            seen.add(w)
            path.append(w)
            v = w
        if self._is_ref_vertex(v) and v != vertex:
            return path[::-1]
        return None

    def _ref_path_from(self, start: int, downwards: bool):
        path = [start]
        v = start
        while True:
            edges = self.out_edges[v] if downwards else self.in_edges[v]
            nxt = None
            for w, e in edges.items():
                if e.is_ref:
                    nxt = w
                    break
            if nxt is None or nxt in path[-2:]:
                break
            path.append(nxt)
            v = nxt
        return path

    def recover_dangling_tails(self, prune_factor: int, min_dangling_length: int = 4):
        from ..ops import smith_waterman as sw

        n = 0
        for v in range(self.num_vertices):
            if self.out_edges[v] or not self.in_edges[v]:
                continue
            if self.ref_path and v == self.ref_sink():
                continue
            alt_path = self._find_path_up_to_lca(v, prune_factor)
            if alt_path is None or len(alt_path) < max(2, min_dangling_length + 1):
                continue
            if self.ref_path and alt_path[0] == self.ref_source():
                continue
            ref_path = self._ref_path_from(alt_path[0], downwards=True)
            if len(ref_path) < 2:
                continue
            ref_str = bytes(self._suffix(x) for x in ref_path)
            alt_str = bytes(self._suffix(x) for x in alt_path)
            aln = sw.align(ref_str, alt_str, sw.STANDARD_NGS, sw.LEADING_INDEL)
            ops, lens = list(aln.cigar_ops), list(aln.cigar_lens)
            # drop trailing deletions (AlignmentUtils.removeTrailingDeletions)
            while ops and ops[-1] == 2:
                ops.pop(); lens.pop()
            if not ops or ops[-1] != 0 or len(ops) > 3:
                continue
            ref_len = sum(l for o, l in zip(ops, lens) if o in (0, 2))
            read_len = sum(l for o, l in zip(ops, lens) if o in (0, 1))
            last_ref_index = ref_len - 1
            # longest matching suffix between ref/alt strings
            m = 0
            while (m < len(alt_str) and m <= last_ref_index
                   and alt_str[len(alt_str) - 1 - m] == ref_str[last_ref_index - m]):
                m += 1
            m = min(m, int(lens[-1]))
            if m == 0:
                continue
            alt_idx = max(read_len - m - 1, 0)
            leading_del = ops[0] == 2 and lens[0] + m == last_ref_index + 1
            ref_idx = last_ref_index - m + 1 + (1 if leading_del else 0)
            if ref_idx <= 0 or ref_idx >= len(ref_path) or alt_idx >= len(alt_path):
                continue
            self._add_edge(alt_path[alt_idx], ref_path[ref_idx], 1, False)
            n += 1
        return n

    def recover_dangling_heads(self, prune_factor: int, min_dangling_length: int = 4):
        """Legacy (non-indel) head merge: compare the reversed head chain with
        the reversed upstream reference path and reattach at the match point."""
        n = 0
        heads = [v for v in range(self.num_vertices)
                 if not self.in_edges[v] and self.out_edges[v]
                 and not (self.ref_path and v == self.ref_source())]
        for v in heads:
            alt_path = self._find_path_down_to_ref(v, prune_factor)
            if alt_path is None or len(alt_path) < min_dangling_length + 1:
                continue
            ref_path = self._ref_path_from(alt_path[0], downwards=False)
            if len(ref_path) < 3:
                continue
            # reversed-orientation strings (suffix bytes walking away from ref)
            ref_str = bytes(self._suffix(x) for x in ref_path)
            alt_str = bytes(self._suffix(x) for x in alt_path)
            max_index = min(len(ref_str), len(alt_str)) - 1
            max_mismatch = max(1, max_index // self.kmer_size)
            mism = 0
            idx = 1  # position 0 is the shared descendant
            while idx < max_index:
                if ref_str[idx] != alt_str[idx]:
                    mism += 1
                    if mism > max_mismatch:
                        break
                idx += 1
            if mism > max_mismatch or idx < 2:
                continue
            merge_at = idx - 1
            if merge_at + 1 >= len(ref_path) or merge_at >= len(alt_path):
                continue
            self._add_edge(ref_path[merge_at + 1], alt_path[merge_at], 1, False)
            n += 1
        return n
