# Copied verbatim from gatk_tpu/assembly/assembler.py; only import lines may differ.
"""Read-threading assembler orchestration (ReadThreadingAssembler equivalent).

Reference behavior: readthreading/ReadThreadingAssembler.java — runLocalAssembly
:138 (kmer iteration {10,25} with +10 retries to 65 on cycles/non-unique-ref),
createGraph :620, chain pruning (pruneFactor=2 default), findBestPaths :229-324
(k-best = 128, haplotype-to-ref SW with NEW_SW_PARAMETERS, SOFTCLIP).
Dangling-end recovery is TODO for exact parity on region edges.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..ops import smith_waterman as sw
from . import kbest, pruning
from .haplotype import Haplotype, build_event_map
from . import rtgraph
from .rtgraph import ReadThreadingGraph

DEFAULT_KMER_SIZES = (10, 25)
MAX_KMER_ITERATIONS = 6
KMER_SIZE_ITERATION_INCREASE = 10
MAX_ALLOWED_KMER = 65  # maxAllowedKmerSize (ReadThreadingAssembler)
DEFAULT_PRUNE_FACTOR = 2
DEFAULT_NUM_BEST_HAPLOTYPES = 128
MIN_HAPLOTYPE_REFERENCE_LENGTH = 30


@dataclass
class AssemblyResult:
    haplotypes: list  # list[Haplotype], ref haplotype first
    ref_haplotype: Haplotype = None
    failed: bool = False
    graphs: dict = field(default_factory=dict)


def assemble(
    reads,
    ref_bases: np.ndarray,
    ref_start: int,
    kmer_sizes=DEFAULT_KMER_SIZES,
    prune_factor: int = DEFAULT_PRUNE_FACTOR,
    min_base_qual: int = 10,
    num_best: int = DEFAULT_NUM_BEST_HAPLOTYPES,
    allow_non_unique_kmers_in_ref: bool = False,
    recover_dangling: bool = True,
    adaptive_pruning: bool = False,
    use_seq_graph: bool = True,
    use_junction_trees: bool = False,
) -> AssemblyResult:
    """Assemble region reads against the padded reference sequence.

    ref_bases: uint8 padded reference; ref_start: genomic position of ref_bases[0].
    Returns haplotypes with cigars/events vs the padded reference.
    """
    ref_hap = Haplotype(
        bases=ref_bases.tobytes(), is_ref=True,
        cigar_ops=np.array([0], np.uint8),
        cigar_lens=np.array([len(ref_bases)], np.int32),
        alignment_start=ref_start,
    )
    result = AssemblyResult(haplotypes=[ref_hap], ref_haplotype=ref_hap)

    if b"N" in ref_hap.bases:
        # reference with Ns cannot be threaded (ReadThreadingAssembler behavior)
        return result

    seen = {ref_hap.bases}
    runs = rtgraph.ReadRuns(reads, min_base_qual)  # shared across all attempts
    # native fast path: the full build->prune->recover->SeqGraph->k-best
    # pipeline in C++ (native/rtgraph rtg_assemble; identical outputs to the
    # Python path below, which remains the reference implementation and the
    # fallback for adaptive pruning / junction trees / raw-kmer-graph modes)
    use_native = (use_seq_graph and not use_junction_trees and not adaptive_pruning
                  and recover_dangling and not allow_non_unique_kmers_in_ref
                  and rtgraph._load_native() is not None)
    if use_native:
        for base_k in kmer_sizes:
            out = _native_kmer_ladder(runs, ref_hap.bases, base_k, prune_factor,
                                      num_best)
            if out is None:
                continue
            k_used, paths = out
            result.graphs[k_used] = "native"
            candidates = []
            for bases, score, weakness in paths:
                if bases in seen:
                    continue
                seen.add(bases)
                if len(bases) < k_used:
                    continue
                candidates.append((bases, score, weakness))
            alignments = sw.align_batch(
                ref_hap.bases, [c[0] for c in candidates], sw.NEW_SW_PARAMETERS,
                sw.SOFTCLIP)
            for (bases, score, weakness), aln in zip(candidates, alignments):
                if _too_clipped(aln):
                    continue
                result.haplotypes.append(Haplotype(
                    bases=bases, is_ref=False, score=score, kmer_size=k_used,
                    cigar_ops=aln.cigar_ops, cigar_lens=aln.cigar_lens,
                    alignment_start=ref_start + aln.offset, weakness=weakness))
        for hap in result.haplotypes:
            build_event_map(hap, ref_bases, ref_start)
        return result
    for base_k in kmer_sizes:
        graph = _try_kmer_sizes(reads, ref_hap.bases, base_k, min_base_qual,
                                allow_non_unique_kmers_in_ref,
                                allow_cycles=use_junction_trees, runs=runs)
        if graph is None:
            continue
        result.graphs[graph.kmer_size] = graph
        if adaptive_pruning:
            # AdaptiveChainPruner (graphs/AdaptiveChainPruner.java) — the default
            # for Mutect2 and deep-coverage data; learns the error rate from the
            # graph instead of a fixed multiplicity cutoff. With adaptive pruning
            # the reference sets pruneFactor=0 for downstream steps
            # (HaplotypeCallerReadThreadingAssemblerArgumentCollection.java:44).
            pruning.adaptive_prune_chains(graph)
            if not recover_dangling:
                graph._remove_orphans()
            recovery_prune_factor = 0
        else:
            graph.prune_low_weight_chains(prune_factor, remove_orphans=not recover_dangling)
            recovery_prune_factor = prune_factor
        if recover_dangling:
            graph.recover_dangling_tails(recovery_prune_factor)
            graph.recover_dangling_heads(recovery_prune_factor)
            graph._remove_orphans()
        if graph.ref_source() is None or graph.ref_sink() is None:
            continue
        if use_junction_trees:
            # --linked-de-bruijn-graph mode: k-best over the kmer graph guided
            # by junction trees (JunctionTreeLinkedDeBruijnGraph +
            # JunctionTreeKBestHaplotypeFinder); no SeqGraph zipping, matching
            # findBestPaths's generateSeqGraph=false branch
            from . import junction_trees as jt

            trees = jt.generate_junction_trees(graph, graph.retained_sequences)
            paths = [((None, bases), score, weakness) for bases, score, weakness
                     in jt.find_k_best_jt(graph, trees, num_best)]
        elif use_seq_graph:
            # default GATK path: zip to a SeqGraph, run the simplification
            # transforms, then k-best over the simplified graph
            # (ReadThreadingAssembler.findBestPaths :229-324 via
            # AssemblyResult's seq graph; graphs/SeqGraph.simplifyGraph)
            from . import seqgraph as sg

            seq_graph = sg.SeqGraph.from_read_threading_graph(graph).simplify()
            paths = [((None, bases), score, weakness) for bases, score, weakness
                     in sg.find_k_best_haplotypes(seq_graph, num_best)]
        else:
            paths = [((path, None), score, weakness) for path, score, weakness
                     in kbest.find_k_best_paths(graph, num_best)]
        # dedupe + length-filter, then SW-align every candidate in one batched
        # call (the per-haplotype AVX alignment loop of findBestPaths :324)
        candidates = []
        for (path, path_bases), score, weakness in paths:
            bases = path_bases if path_bases is not None else kbest.path_to_bases(graph, path)
            if bases in seen:
                continue
            seen.add(bases)
            if len(bases) < graph.kmer_size:
                continue
            candidates.append((bases, score, weakness))
        alignments = sw.align_batch(
            ref_hap.bases, [c[0] for c in candidates], sw.NEW_SW_PARAMETERS, sw.SOFTCLIP)
        for (bases, score, weakness), aln in zip(candidates, alignments):
            if _too_clipped(aln):
                continue
            hap = Haplotype(
                bases=bases, is_ref=False, score=score, kmer_size=graph.kmer_size,
                cigar_ops=aln.cigar_ops, cigar_lens=aln.cigar_lens,
                alignment_start=ref_start + aln.offset, weakness=weakness,
            )
            result.haplotypes.append(hap)

    for hap in result.haplotypes:
        build_event_map(hap, ref_bases, ref_start)
    return result


def _too_clipped(aln) -> bool:
    """Reject alignments that are mostly soft clip (degenerate paths)."""
    total = int(aln.cigar_lens.sum())
    clipped = int(aln.cigar_lens[aln.cigar_ops == 4].sum()) if len(aln.cigar_ops) else 0
    return total > 0 and clipped * 2 > total


def _native_kmer_ladder(runs, ref_bases: bytes, base_k: int, prune_factor: int,
                        num_best: int):
    """Native-path kmer escalation (mirrors _try_kmer_sizes + the per-graph
    pipeline): retries k+10 on non-unique ref kmers / cycles / low quality,
    skips the base size entirely when the ref path vanishes post-recovery.
    Returns (k, paths) or None."""
    k = base_k
    for _attempt in range(MAX_KMER_ITERATIONS):
        if k > MAX_ALLOWED_KMER or k >= len(ref_bases):
            return None
        # reference kmers must be unique (ReadThreadingAssembler nonUniqueKmer
        # escalation) — cheap host check, mirrors _build_graph
        seen = set()
        ok = True
        for i in range(len(ref_bases) - k + 1):
            km = ref_bases[i : i + k]
            if km in seen:
                ok = False
                break
            seen.add(km)
        if ok:
            status, paths = rtgraph.assemble_attempt_native(
                runs, ref_bases, k, prune_factor, num_best)
            if status == 0:
                return k, paths
            if status == 5:
                return None  # ref path lost post-recovery: skip this base size
        k += KMER_SIZE_ITERATION_INCREASE
    return None


def _try_kmer_sizes(reads, ref_bases: bytes, base_k: int, min_base_qual: int,
                    allow_non_unique_ref: bool, allow_cycles: bool = False,
                    runs=None):
    """Build a graph at base_k, increasing kmer size on ref-non-uniqueness/cycles
    (ReadThreadingAssembler.createGraph retry loop)."""
    k = base_k
    if runs is None:
        runs = rtgraph.ReadRuns(reads, min_base_qual)  # shared across attempts
    for attempt in range(MAX_KMER_ITERATIONS):
        if k > MAX_ALLOWED_KMER or k >= len(ref_bases):
            return None
        g = _build_graph(reads, ref_bases, k, min_base_qual, allow_non_unique_ref,
                         allow_cycles=allow_cycles, runs=runs)
        if g is not None:
            g.kmer_size = k
            return g
        k += KMER_SIZE_ITERATION_INCREASE
    return None


def _build_graph(reads, ref_bases: bytes, k: int, min_base_qual: int,
                 allow_non_unique_ref: bool, allow_cycles: bool = False,
                 runs=None):
    g = ReadThreadingGraph(k, min_base_qual)
    # reference kmers must be unique
    if not allow_non_unique_ref:
        seen = set()
        for i in range(len(ref_bases) - k + 1):
            km = ref_bases[i : i + k]
            if km in seen:
                return None
            seen.add(km)
    g.add_sequence("ref", ref_bases, 0, len(ref_bases), 1, True)
    g.add_reads(reads, runs=runs)
    g.build()
    if g.has_cycles() and not allow_cycles:
        return None
    if g.is_low_quality():
        return None
    return g
