# Copied verbatim from gatk_tpu/assembly/junction_trees.py; only import lines may differ.
"""Junction trees: experimental linked de Bruijn assembly mode.

Reference: readthreading/JunctionTreeLinkedDeBruijnGraph.java (:400-470
generateJunctionTrees/pruneJunctionTrees, :713-790
JunctionTreeThreadingHelper) and graphs/JunctionTreeKBestHaplotypeFinder.java
(+JTBestHaplotype.java): junction trees record, at every branching vertex,
the subsequent path choices reads actually took — evidence that phases
variants separated by more than the kmer size and permits traversing cycles
exactly as often as reads support.

Path search consults the oldest junction trees on the current path, pooling
their outgoing-edge counts until the evidence threshold (default 3) is met,
falling back to graph edge multiplicities otherwise (--linked-de-bruijn-graph
mode; the classic mode's SeqGraph pipeline is bypassed, as in
ReadThreadingAssembler.findBestPaths's generateSeqGraph=false branch).
"""
from __future__ import annotations

import heapq
import math
from dataclasses import dataclass, field

JT_EVIDENCE_THRESHOLD = 3   # JunctionTreeKBestHaplotypeFinder.DEFAULT_OUTGOING_JT_EVIDENCE_THRESHOLD_TO_BELEIVE
JT_PRUNE_WEIGHT = 1         # DEFAULT_MINIMUM_WEIGHT_FOR_JT_BRANCH_TO_NOT_BE_PRUNED
MAX_ACTIVE_TREES = 3        # JTBestHaplotype keeps the newest few trees


class ThreadingNode:
    __slots__ = ("count", "children")

    def __init__(self):
        self.count = 0
        self.children: dict[int, ThreadingNode] = {}  # target vid -> node

    def prune(self, min_weight: int):
        self.children = {v: c for v, c in self.children.items() if c.count >= min_weight}
        for c in self.children.values():
            c.prune(min_weight)


def _vertex_warrants_tree(graph, vid: int) -> bool:
    """JunctionTreeThreadingHelper.vertexWarrantsJunctionTree: any outgoing
    edge leads to a vertex with in-degree > 1."""
    return any(len(graph.in_edges[t]) > 1 for t in graph.out_edges[vid])


def rethread_path(graph, s) -> list[int]:
    """Re-walk a built sequence through the finished graph, mirroring
    _thread_sequence's vertex resolution without mutating counts."""
    start = graph._find_start(s)
    if start == -1:
        return []
    kmer0 = s.seq[start:start + graph.kmer_size]
    vid = graph.kmer_to_vertex.get(kmer0)
    if vid is None:
        return []
    path = [vid]
    for i in range(start + 1, s.stop - graph.kmer_size + 1):
        suffix = s.seq[i + graph.kmer_size - 1]
        nxt = None
        for t in graph.out_edges[vid]:
            if graph.vertex_seq[t][-1] == suffix:
                nxt = t
                break
        if nxt is None:
            kmer = s.seq[i:i + graph.kmer_size]
            nxt = graph.kmer_to_vertex.get(kmer)
            if nxt is None:
                break  # gap: read diverged from the retained graph (pruned path)
        path.append(nxt)
        vid = nxt
    return path


def generate_junction_trees(graph, sequences) -> dict:
    """Thread each non-ref sequence, rooting/extending junction trees
    (generateJunctionTrees + threadSequenceForJunctionTree)."""
    trees: dict[int, ThreadingNode] = {}
    for s in sequences:
        if s.is_ref:
            continue
        path = rethread_path(graph, s)
        if len(path) < 2:
            continue
        tracked: list[ThreadingNode] = []
        for idx, v in enumerate(path):
            if idx > 0:
                new_tracked = []
                for node in tracked:
                    child = node.children.setdefault(v, ThreadingNode())
                    child.count += 1
                    new_tracked.append(child)
                tracked = new_tracked
            if _vertex_warrants_tree(graph, v):
                root = trees.setdefault(v, ThreadingNode())
                root.count += 1
                tracked.append(root)
    for root in trees.values():
        root.prune(JT_PRUNE_WEIGHT)
    return trees


@dataclass(order=True)
class _Entry:
    neg_score: float
    tiebreak: int
    vid: int = field(compare=False)
    bases: bytes = field(compare=False)
    active: tuple = field(compare=False)   # ThreadingNode positions, oldest first
    length: int = field(compare=False, default=0)
    weakness: int = field(compare=False, default=1 << 30)


def find_k_best_jt(graph, trees: dict, max_paths: int = 128, max_pop: int = 100000,
                   max_length: int | None = None,
                   evidence_threshold: int = JT_EVIDENCE_THRESHOLD):
    """K-best haplotypes guided by junction trees
    (JunctionTreeKBestHaplotypeFinder.findBestHaplotypes). Returns
    (bases, score, weakness) tuples; cycles are traversable while junction
    evidence supports them."""
    src = graph.ref_source()
    sink = graph.ref_sink()
    if src is None or sink is None:
        return []
    if max_length is None:
        max_length = 2 * (len(graph.ref_path or []) + graph.kmer_size) + 200

    def initial_active(v):
        return (trees[v],) if v in trees else ()

    results = []
    counter = 0
    heap = [_Entry(0.0, 0, src, bytes(graph.vertex_seq[src]), initial_active(src))]
    pops = 0
    while heap and len(results) < max_paths and pops < max_pop:
        e = heapq.heappop(heap)
        pops += 1
        if e.vid == sink:
            results.append((e.bases, -e.neg_score, e.weakness))
            continue
        if e.length >= max_length:
            continue
        out = graph.out_edges[e.vid]
        if not out:
            continue
        # pool junction-tree evidence from the oldest trees until threshold
        # (JTBestHaplotype.getApplicableNextEdgesBasedOnJunctionTrees)
        jt_counts: dict[int, int] = {}
        pooled = 0
        for node in e.active:
            for tgt, child in node.children.items():
                jt_counts[tgt] = jt_counts.get(tgt, 0) + child.count
            pooled = sum(jt_counts.values())
            if pooled >= evidence_threshold:
                break
        use_jt = pooled >= evidence_threshold
        if use_jt:
            weights = {t: jt_counts.get(t, 0) for t in out}
        else:
            weights = {t: edge.multiplicity for t, edge in out.items()}
        total = sum(weights.values())
        if total <= 0:
            weights = {t: edge.multiplicity for t, edge in out.items()}
            total = sum(weights.values())
            use_jt = False
            if total <= 0:
                continue
        for tgt, edge in out.items():
            w = weights.get(tgt, 0)
            if w <= 0:
                continue
            # cycle guard: without junction evidence, never re-enter a cycle
            if not use_jt and graph.vertex_seq[tgt][-1:] and e.length > 0 and \
                    tgt == e.vid:
                continue
            counter += 1
            sc = e.neg_score - (math.log10(w) - math.log10(total))
            wk = e.weakness if total == w else min(e.weakness, w)
            # advance active trees along this edge; add the target's tree
            new_active = tuple(n.children[tgt] for n in e.active if tgt in n.children)
            if tgt in trees:
                new_active = new_active + (trees[tgt],)
            if len(new_active) > MAX_ACTIVE_TREES:
                new_active = new_active[-MAX_ACTIVE_TREES:]
            heapq.heappush(heap, _Entry(
                sc, counter, tgt, e.bases + graph.vertex_seq[tgt][-1:],
                new_active, e.length + 1, wk))
    return results
