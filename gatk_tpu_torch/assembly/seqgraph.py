# Copied verbatim from gatk_tpu/assembly/seqgraph.py; only import lines may differ.
"""Sequence graph: zipped de Bruijn graph + simplification transforms.

Reference: graphs/SeqGraph.java (simplifyGraph :49-110 — zipLinearChains then
cycles of MergeDiamonds, MergeTails, SplitCommonSuffices, MergeCommonSuffices),
graphs/SharedVertexSequenceSplitter.java (common prefix/suffix splitting of a
sibling vertex set), graphs/CommonSuffixSplitter.java (suffix splitting above a
join vertex, safety rules :100-164), graphs/SharedSequenceMerger.java (merge
identical parallel predecessors), and AbstractReadThreadingGraph.toSequenceGraph
(kmer vertex -> its suffix base; sources keep the full kmer).

These transforms merge shared sequence among parallel branches so edge
multiplicities — and therefore k-best path scores — aggregate the way the
reference's haplotype enumeration sees them.
"""
from __future__ import annotations

import heapq
import math
from dataclasses import dataclass, field


@dataclass
class SeqEdge:
    multiplicity: int = 1
    is_ref: bool = False

    def copy(self):
        return SeqEdge(self.multiplicity, self.is_ref)


class SeqGraph:
    def __init__(self, kmer_size: int = 25):
        self.kmer_size = kmer_size
        self.seqs: dict[int, bytes] = {}
        self.out: dict[int, dict[int, SeqEdge]] = {}
        self.inc: dict[int, dict[int, SeqEdge]] = {}
        self._next_id = 0

    # ---- construction ----

    def add_vertex(self, seq: bytes) -> int:
        vid = self._next_id
        self._next_id += 1
        self.seqs[vid] = bytes(seq)
        self.out[vid] = {}
        self.inc[vid] = {}
        return vid

    def add_edge(self, u: int, v: int, edge: SeqEdge):
        """addOrUpdateEdge semantics: merging parallel edges sums multiplicity,
        ORs refness."""
        existing = self.out[u].get(v)
        if existing is None:
            e = edge.copy()
            self.out[u][v] = e
            self.inc[v][u] = e
        else:
            existing.multiplicity += edge.multiplicity
            existing.is_ref = existing.is_ref or edge.is_ref

    def remove_vertex(self, vid: int):
        for u in list(self.inc[vid]):
            del self.out[u][vid]
        for w in list(self.out[vid]):
            del self.inc[w][vid]
        del self.seqs[vid], self.out[vid], self.inc[vid]

    @classmethod
    def from_read_threading_graph(cls, g) -> "SeqGraph":
        """AbstractReadThreadingGraph.toSequenceGraph: suffix base per kmer
        vertex; graph sources keep their full kmer."""
        sg = cls(g.kmer_size)
        id_map = {}
        for vid in range(len(g.vertex_seq)):
            if not g.in_edges[vid] and not g.out_edges[vid]:
                continue  # orphaned (pruned) vertex
            kmer = g.vertex_seq[vid]
            seq = kmer if not g.in_edges[vid] else kmer[-1:]
            id_map[vid] = sg.add_vertex(seq)
        for u in range(len(g.vertex_seq)):
            if u not in id_map:
                continue
            for v, e in g.out_edges[u].items():
                is_ref = getattr(e, "is_ref", False) or getattr(e, "ref", False)
                sg.add_edge(id_map[u], id_map[v], SeqEdge(e.multiplicity, is_ref))
        return sg

    # ---- queries ----

    def is_ref_vertex(self, vid: int) -> bool:
        return any(e.is_ref for e in self.out[vid].values()) or \
            any(e.is_ref for e in self.inc[vid].values())

    def ref_source(self):
        for vid in self.seqs:
            if any(e.is_ref for e in self.out[vid].values()) and \
                    not any(e.is_ref for e in self.inc[vid].values()):
                return vid
        return None

    def ref_sink(self):
        for vid in self.seqs:
            if any(e.is_ref for e in self.inc[vid].values()) and \
                    not any(e.is_ref for e in self.out[vid].values()):
                return vid
        return None

    # ---- zipLinearChains (SeqGraph.java:127-210) ----

    def _is_linear_chain_start(self, v: int) -> bool:
        return len(self.out[v]) == 1 and (
            len(self.inc[v]) != 1 or
            len(self.out[next(iter(self.inc[v]))]) > 1)

    def zip_linear_chains(self) -> bool:
        starts = [v for v in self.seqs if self._is_linear_chain_start(v)]
        merged_any = False
        for start in starts:
            if start not in self.seqs:
                continue
            chain = [start]
            cur = start
            while True:
                nxts = list(self.out[cur])
                if len(nxts) != 1:
                    break
                nxt = nxts[0]
                if len(self.inc[nxt]) != 1 or nxt == start:
                    break
                chain.append(nxt)
                cur = nxt
            if len(chain) == 1:
                continue
            merged_any = True
            new_seq = b"".join(self.seqs[v] for v in chain)
            new_v = self.add_vertex(new_seq)
            for u, e in list(self.inc[chain[0]].items()):
                self.add_edge(u, new_v, e)
            for w, e in list(self.out[chain[-1]].items()):
                self.add_edge(new_v, w, e)
            for v in chain:
                self.remove_vertex(v)
        return merged_any

    # ---- SharedVertexSequenceSplitter ----

    @staticmethod
    def _common_prefix_suffix(seqs):
        min_len = min(len(s) for s in seqs)
        pre = 0
        while pre < min_len and len({s[pre] for s in seqs}) == 1:
            pre += 1
        suf = 0
        while suf < min_len - pre and len({s[len(s) - 1 - suf] for s in seqs}) == 1:
            suf += 1
        first = seqs[0]
        return first[:pre], first[len(first) - suf:] if suf else b""

    def _split_and_update(self, middles, top, bottom):
        """SharedVertexSequenceSplitter.splitAndUpdate: replace the sibling set
        with prefix -> remainder_i -> suffix, reconnecting to top/bottom."""
        seqs = [self.seqs[m] for m in middles]
        prefix, suffix = self._common_prefix_suffix(seqs)
        # collect (incoming edge, outgoing edge, remainder) per middle
        parts = []
        for m in middles:
            in_e = next(iter(self.inc[m].values())).copy() if self.inc[m] else SeqEdge(0, self.is_ref_vertex(m))
            out_e = next(iter(self.out[m].values())).copy() if self.out[m] else SeqEdge(0, self.is_ref_vertex(m))
            s = self.seqs[m]
            remaining = s[len(prefix):len(s) - len(suffix)]
            parts.append((in_e, out_e, remaining))
        for m in middles:
            self.remove_vertex(m)

        need_prefix = len(prefix) > 0 or top is None
        need_suffix = len(suffix) > 0 or bottom is None
        prefix_v = self.add_vertex(prefix) if need_prefix else top
        suffix_v = self.add_vertex(suffix) if need_suffix else bottom
        if need_prefix and top is not None:
            self.add_edge(top, prefix_v,
                          SeqEdge(1, any(p[0].is_ref for p in parts)))
        if need_suffix and bottom is not None:
            self.add_edge(suffix_v, bottom,
                          SeqEdge(1, any(p[1].is_ref for p in parts)))
        for in_e, out_e, remaining in parts:
            if remaining:
                mid_v = self.add_vertex(remaining)
                self.add_edge(prefix_v, mid_v, in_e)
                self.add_edge(mid_v, suffix_v, out_e)
            else:
                joined = SeqEdge(in_e.multiplicity + out_e.multiplicity,
                                 in_e.is_ref or out_e.is_ref)
                self.add_edge(prefix_v, suffix_v, joined)
        return True

    # ---- the four transforms ----

    def merge_diamonds_once(self) -> bool:
        did = False
        for top in list(self.seqs):
            if top not in self.seqs:
                continue
            middles = list(self.out[top])
            if len(middles) <= 1 or any(m not in self.seqs for m in middles):
                continue
            bottom = None
            ok = True
            for m in middles:
                if len(self.out[m]) < 1 or len(self.inc[m]) != 1:
                    ok = False
                    break
                for t in self.out[m]:
                    if bottom is None:
                        bottom = t
                    elif bottom != t:
                        ok = False
                        break
                if not ok:
                    break
            if not ok or bottom is None or len(self.inc[bottom]) != len(middles):
                continue
            prefix, suffix = self._common_prefix_suffix([self.seqs[m] for m in middles])
            if len(prefix) < 1 and len(suffix) < 1:
                continue
            self._split_and_update(middles, top, bottom)
            did = True
        return did

    MIN_COMMON_TAIL_TO_MERGE = 10  # MergeTails.java:MIN_COMMON_SEQUENCE...

    def merge_tails_once(self) -> bool:
        did = False
        for top in list(self.seqs):
            if top not in self.seqs:
                continue
            tails = list(self.out[top])
            if len(tails) <= 1 or any(t not in self.seqs for t in tails):
                continue
            if any(self.out[t] or len(self.inc[t]) > 1 for t in tails):
                continue
            _, suffix = self._common_prefix_suffix([self.seqs[t] for t in tails])
            if len(suffix) < self.MIN_COMMON_TAIL_TO_MERGE:
                continue
            self._split_and_update(tails, top, None)
            did = True
        return did

    def split_common_suffices_once(self, already_split: set) -> bool:
        """CommonSuffixSplitter.split over each join vertex."""
        did = False
        for bot in list(self.seqs):
            if bot not in self.seqs or bot in already_split:
                continue
            already_split.add(bot)
            to_split = list(self.inc[bot])
            if len(to_split) < 2:
                continue
            # safety (CommonSuffixSplitter.safeToSplit)
            safe = True
            for m in to_split:
                if m == bot or len(self.out[m]) != 1 or bot not in self.out[m] \
                        or m in self.out[bot]:
                    safe = False
                    break
            if not safe:
                continue
            seqs = [self.seqs[m] for m in to_split]
            _, suffix = self._common_prefix_suffix(seqs)
            if not suffix:
                continue
            # wouldEliminateRefSource / allVerticesAreTheCommonSuffix
            if any(len(self.seqs[m]) == len(suffix) and not self.inc[m] and
                   self.is_ref_vertex(m) for m in to_split):
                continue
            if all(len(self.seqs[m]) == len(suffix) for m in to_split):
                continue
            for m in to_split:
                out_e = self.out[m][bot]
                s = self.seqs[m]
                rest = s[:len(s) - len(suffix)]
                suffix_v = self.add_vertex(suffix)
                self.add_edge(suffix_v, bot, out_e.copy())
                if rest:
                    rest_v = self.add_vertex(rest)
                    self.add_edge(rest_v, suffix_v, SeqEdge(1, out_e.is_ref))
                    target = rest_v
                else:
                    target = suffix_v
                for u, in_e in list(self.inc[m].items()):
                    self.add_edge(u, target, in_e.copy())
            for m in to_split:
                self.remove_vertex(m)
            did = True
        return did

    def merge_common_suffices_once(self) -> bool:
        """SharedSequenceMerger.merge over each vertex: merge identical
        parallel predecessors into one."""
        did = False
        for v in list(self.seqs):
            if v not in self.seqs:
                continue
            prevs = list(self.inc[v])
            if not prevs or any(p not in self.seqs for p in prevs):
                continue
            first_seq = self.seqs[prevs[0]]
            ok = len(prevs) > 1
            for p in prevs:
                if self.seqs[p] != first_seq or len(self.out[p]) != 1 \
                        or v not in self.out[p] or not self.inc[p]:
                    ok = False
                    break
            if not ok:
                continue
            new_v = self.add_vertex(first_seq + self.seqs[v])
            for p in prevs:
                for u, e in list(self.inc[p].items()):
                    self.add_edge(u, new_v, e.copy())
            for w, e in list(self.out[v].items()):
                self.add_edge(new_v, w, e.copy())
            for p in prevs:
                self.remove_vertex(p)
            self.remove_vertex(v)
            did = True
        return did

    def _transform_until_complete(self, fn) -> bool:
        did = False
        while fn():
            did = True
        return did

    def simplify(self, max_cycles: int = 100):
        """SeqGraph.simplifyGraph."""
        self.zip_linear_chains()
        for _ in range(max_cycles):
            did = False
            did |= self._transform_until_complete(self.merge_diamonds_once)
            did |= self._transform_until_complete(self.merge_tails_once)
            already = set()
            did |= self._transform_until_complete(
                lambda: self.split_common_suffices_once(already))
            did |= self._transform_until_complete(self.merge_common_suffices_once)
            did |= self.zip_linear_chains()
            if not did:
                break
        return self


# ----------------------------------------------------------------------------
# k-best over the seq graph (GraphBasedKBestHaplotypeFinder.java)
# ----------------------------------------------------------------------------

@dataclass(order=True)
class _Entry:
    neg_score: float
    tiebreak: int
    vid: int = field(compare=False)
    path: tuple = field(compare=False)
    weakness: int = field(compare=False, default=1 << 30)


def find_k_best_haplotypes(graph: SeqGraph, max_paths: int = 128, max_pop: int = 100000):
    """(bases, score, weakness) per path from ref source to ref sink, best
    first; score = sum log10(edge multiplicity / total outgoing)."""
    src = graph.ref_source()
    sink = graph.ref_sink()
    if src is None or sink is None:
        return []
    results = []
    counter = 0
    heap = [_Entry(0.0, 0, src, (src,))]
    pops = 0
    while heap and len(results) < max_paths and pops < max_pop:
        e = heapq.heappop(heap)
        pops += 1
        if e.vid == sink:
            bases = b"".join(graph.seqs[v] for v in e.path)
            results.append((bases, -e.neg_score, e.weakness))
            continue
        out = graph.out[e.vid]
        if not out:
            continue
        total = sum(edge.multiplicity for edge in out.values())
        if total <= 0:
            continue
        for tgt, edge in out.items():
            if tgt in e.path:
                continue
            if edge.multiplicity <= 0:
                continue
            counter += 1
            sc = e.neg_score - (math.log10(edge.multiplicity) - math.log10(total))
            wk = e.weakness if total == edge.multiplicity else min(e.weakness, edge.multiplicity)
            heapq.heappush(heap, _Entry(sc, counter, tgt, e.path + (tgt,), wk))
    return results
