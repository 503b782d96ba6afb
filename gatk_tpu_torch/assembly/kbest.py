# Copied verbatim from gatk_tpu/assembly/kbest.py; only import lines may differ.
"""K-best haplotype path search (GraphBasedKBestHaplotypeFinder equivalent).

Reference behavior: graphs/GraphBasedKBestHaplotypeFinder.java + KBestHaplotype:
best-first expansion from the reference source to the reference sink, scoring each
branch log10(edge multiplicity / total outgoing multiplicity). Scores on the
unzipped kmer graph equal those on the reference's zipped SeqGraph because
out-degree-1 vertices contribute log10(1)=0.
"""
from __future__ import annotations

import heapq
import math
from dataclasses import dataclass, field

from .rtgraph import ReadThreadingGraph


@dataclass(order=True)
class _Entry:
    neg_score: float
    tiebreak: int
    vid: int = field(compare=False)
    path: tuple = field(compare=False)
    weakness: int = field(compare=False, default=1 << 30)


def find_k_best_paths(graph: ReadThreadingGraph, max_paths: int = 128, max_pop: int = 100000):
    """Return list of (path_vids, score, weakness) from ref source to ref sink,
    best first. weakness = min branch-edge multiplicity along the path
    (KBestHaplotype.java:30: only edges leaving vertices with total outgoing
    multiplicity > 1 count)."""
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
            results.append((list(e.path), -e.neg_score, e.weakness))
            continue
        out = graph.out_edges[e.vid]
        if not out:
            continue
        total = sum(edge.multiplicity for edge in out.values())
        for tgt, edge in out.items():
            if tgt in e.path and _creates_cycle(e.path, tgt):
                continue
            counter += 1
            sc = e.neg_score - (math.log10(edge.multiplicity) - math.log10(total))
            wk = e.weakness if total == 1 else min(e.weakness, edge.multiplicity)
            heapq.heappush(heap, _Entry(sc, counter, tgt, e.path + (tgt,), wk))
    return results


def _creates_cycle(path: tuple, tgt: int) -> bool:
    return tgt in path


def path_to_bases(graph: ReadThreadingGraph, path) -> bytes:
    """Haplotype bases: full kmer of the first vertex + suffix base of each next."""
    out = bytearray(graph.vertex_seq[path[0]])
    for vid in path[1:]:
        out.append(graph.vertex_seq[vid][-1])
    return bytes(out)
