# Copied verbatim from gatk_tpu/assembly/pruning.py; only import lines may differ.
"""Chain pruners for the read-threading graph.

Reference behavior: graphs/ChainPruner.java (findAllChains/findChain),
graphs/LowWeightChainPruner.java, and graphs/AdaptiveChainPruner.java — the
probabilistic pruner that learns the graph's error rate from the data and keeps
only chains whose multiplicity is inconsistent with sequencing error (via
Mutect2Engine.logLikelihoodRatio), seeded from high-confidence vertices and grown
as a subgraph. Essential on deep data (e.g. 2000x mitochondria), where a fixed
prune factor keeps hundreds of error chains.

Defaults per ReadThreadingAssemblerArgumentCollection.java:19-20,133,154:
initial error rate 0.001, log-odds threshold ln(10^1), seeding ln(10^4),
max unpruned variants 100.
"""
from __future__ import annotations

import heapq
import math

LOG_ODDS_THRESHOLD = math.log(10.0 ** 1.0)
SEEDING_LOG_ODDS_THRESHOLD = math.log(10.0 ** 4.0)
INITIAL_ERROR_RATE = 0.001
MAX_UNPRUNED_VARIANTS = 100


def find_all_chains(graph):
    """ChainPruner.findAllChains: linear chains as edge lists [(u, v), ...].

    Chains start at graph sources and at every vertex where a chain ended
    (branch points); a chain extends while the tip has exactly one out-edge,
    in-degree <= 1, and hasn't cycled back to the chain start.
    """
    chain_starts = list(graph.sources())
    already_seen = set(chain_starts)
    chains = []
    qi = 0
    while qi < len(chain_starts):
        start = chain_starts[qi]
        qi += 1
        for w in graph.out_edges[start]:
            chain = [(start, w)]
            last = w
            while True:
                outs = graph.out_edges[last]
                if len(outs) != 1 or len(graph.in_edges[last]) > 1 or last == start:
                    break
                nxt = next(iter(outs))
                chain.append((last, nxt))
                last = nxt
            chains.append(chain)
            if last not in already_seen:
                already_seen.add(last)
                chain_starts.append(last)
    return chains


def _chain_mult(graph, chain):
    return [graph.out_edges[a][b].multiplicity for a, b in chain]


def _chain_has_ref(graph, chain):
    return any(graph.out_edges[a][b].is_ref for a, b in chain)


def _llr(n_ref: int, n_alt: int, error_rate: float) -> float:
    """Mutect2Engine.logLikelihoodRatio(refCount, altCount, errorProbability):
    error prob -> rounded phred qual -> singleton alt qual repeated altCount."""
    from ..mutect.somatic_likelihoods import log_likelihood_ratio

    qual = int(round(-10.0 * math.log10(max(error_rate, 1e-30))))
    if n_alt == 0:
        n = n_ref
        return -math.log(n + 1)
    return log_likelihood_ratio(n_ref, [qual], repeat_factor=n_alt)


def _chain_log_odds(graph, chain, error_rate: float):
    """(left, right) log odds that the chain is real variation rather than error
    (AdaptiveChainPruner.chainLogOdds)."""
    first, _ = chain[0]
    _, last = chain[-1]
    left_total = sum(e.multiplicity for e in graph.out_edges[first].values())
    right_total = sum(e.multiplicity for e in graph.in_edges[last].values())
    left_mult = graph.out_edges[chain[0][0]][chain[0][1]].multiplicity
    right_mult = graph.out_edges[chain[-1][0]][chain[-1][1]].multiplicity
    left = 0.0 if not graph.in_edges[first] else _llr(left_total - left_mult, left_mult, error_rate)
    right = 0.0 if not graph.out_edges[last] else _llr(right_total - right_mult, right_mult, error_rate)
    return left, right


def _chain_bases(graph, chain):
    b = bytearray(graph.vertex_seq[chain[0][0]])
    for _, v in chain:
        b.append(graph.vertex_seq[v][-1])
    return bytes(b)


def _max_weight_chain(graph, chains):
    """Chain containing the greatest-weight edge; ties broken by chain length
    then first-vertex sequence (AdaptiveChainPruner.getMaxWeightChain)."""
    return max(
        chains,
        key=lambda c: (max(_chain_mult(graph, c)), len(c), graph.vertex_seq[c[0][0]]),
    )


def _likely_error_chains(graph, chains, error_rate: float,
                         log_odds_threshold: float, seeding_threshold: float,
                         max_unpruned_variants: int):
    chain_ids = {id(c): c for c in chains}
    log_odds = {id(c): _chain_log_odds(graph, c, error_rate) for c in chains}

    vertex_to_seedable = {}
    good_incoming = {}
    good_outgoing = {}
    for c in chains:
        left, right = log_odds[id(c)]
        first_edge_ref = graph.out_edges[c[0][0]][c[0][1]].is_ref
        first, _ = c[0]
        _, last = c[-1]
        if right >= log_odds_threshold or first_edge_ref:
            good_incoming.setdefault(last, []).append(c)
        if left >= log_odds_threshold or first_edge_ref:
            good_outgoing.setdefault(first, []).append(c)
        if right >= seeding_threshold and left >= seeding_threshold:
            vertex_to_seedable.setdefault(first, []).append(c)
            vertex_to_seedable.setdefault(last, []).append(c)

    heap = []
    counter = 0

    def push(chain, score):
        nonlocal counter
        heapq.heappush(
            heap,
            (-score, graph.vertex_seq[chain[0][0]], _chain_bases(graph, chain), counter, chain),
        )
        counter += 1

    push(_max_weight_chain(graph, chains), math.inf)
    processed = set()
    for vertex, seed_chains in vertex_to_seedable.items():
        if len(seed_chains) > 2:
            for c in good_outgoing.get(vertex, []):
                push(c, log_odds[id(c)][0])
            for c in good_incoming.get(vertex, []):
                push(c, log_odds[id(c)][1])
            processed.add(vertex)

    good_chains = set()
    have_outgoing_good = set()
    variant_count = 0
    while heap and variant_count <= max_unpruned_variants:
        _, _, _, _, chain = heapq.heappop(heap)
        if id(chain) in good_chains:
            continue
        good_chains.add(id(chain))
        first, _ = chain[0]
        _, last = chain[-1]
        new_variant = first in have_outgoing_good
        have_outgoing_good.add(first)
        if new_variant:
            variant_count += 1
            if variant_count > max_unpruned_variants:
                continue
        for vertex in (first, last):
            if vertex not in processed:
                for c in good_outgoing.get(vertex, []):
                    push(c, log_odds[id(c)][0])
                for c in good_incoming.get(vertex, []):
                    push(c, log_odds[id(c)][1])
                processed.add(vertex)

    return [c for c in chains if id(c) not in good_chains]


def adaptive_prune_chains(graph, initial_error_rate: float = INITIAL_ERROR_RATE,
                          log_odds_threshold: float = LOG_ODDS_THRESHOLD,
                          seeding_threshold: float = SEEDING_LOG_ODDS_THRESHOLD,
                          max_unpruned_variants: int = MAX_UNPRUNED_VARIANTS):
    """AdaptiveChainPruner.chainsToRemove + removal: learn the error rate from a
    first pass at the initial guess, re-run at the learned rate, drop non-ref
    error chains' edges."""
    chains = find_all_chains(graph)
    if not chains:
        return 0
    probable = _likely_error_chains(graph, chains, initial_error_rate,
                                    log_odds_threshold, seeding_threshold,
                                    max_unpruned_variants)
    error_count = sum(graph.out_edges[c[-1][0]][c[-1][1]].multiplicity for c in probable)
    total_bases = sum(sum(_chain_mult(graph, c)) for c in chains)
    error_rate = error_count / total_bases if total_bases else initial_error_rate
    error_rate = max(error_rate, 1e-10)
    to_remove = [
        c
        for c in _likely_error_chains(graph, chains, error_rate,
                                      log_odds_threshold, seeding_threshold,
                                      max_unpruned_variants)
        if not _chain_has_ref(graph, c)
    ]
    n = 0
    for c in to_remove:
        for a, b in c:
            if graph.out_edges[a].pop(b, None) is not None:
                graph.in_edges[b].pop(a, None)
                n += 1
    return n
