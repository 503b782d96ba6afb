# Copied verbatim from gatk_tpu/calling/allele_filtering.py; only import lines may differ.
"""Pre-genotyping allele filtering.

Reference: haplotypecaller/AlleleFiltering.java (+AlleleFilteringHC.java:30-60,
OccurrenceMatrix.java, invoked from HaplotypeCallerEngine.java:928-942 when
--filter-alleles is set). Weak alt alleles — low genotype quality or strong
strand bias (SOR) — are removed *before* genotyping by disabling every
haplotype that carries them, so sequencing-error alleles don't siphon reads
from true alleles during marginalization.

Clustering: alleles that never co-occur on a haplotype and are either within
3bp of each other or within 20bp and identical up to one homopolymer-length
change (BaseUtils.equalUpToHmerChange) compete for reads and are genotyped
together; connected components are processed independently.
"""
from __future__ import annotations

import math

import numpy as np

from .genotyper import compute_genotype_likelihoods, gls_to_pls
from .likelihoods import AlleleLikelihoods

PREFILTER_QUAL_THRESHOLD = 30.0  # AssemblyBasedCallerArgumentCollection.java:363
PREFILTER_SOR_THRESHOLD = 3.0    # :364
STRINGENT_QUAL_THRESHOLD = 1.0   # AlleleFiltering.java:184 hardcoded
SOR_PSEUDOCOUNT = 1.0


def _hmer_runs(b: bytes):
    i, n = 0, len(b)
    while i < n:
        j = i + 1
        while j < n and b[j] == b[i]:
            j += 1
        yield b[i], j - i
        i = j


def equal_up_to_hmer_change(b1: bytes, b2: bytes) -> bool:
    """BaseUtils.equalUpToHmerChange: same hmer sequence with at most one
    hmer-length difference."""
    it1, it2 = list(_hmer_runs(b1)), list(_hmer_runs(b2))
    if len(it1) != len(it2):
        return False
    diff_found = False
    for (c1, l1), (c2, l2) in zip(it1, it2):
        if c1 != c2:
            return False
        if l1 != l2:
            if diff_found:
                return False
            diff_found = True
    return True


def _insert_event_into_ref(ref_hap, event) -> bytes:
    """Haplotype.insertAllele on the reference haplotype."""
    off = event.start - ref_hap.alignment_start
    if off < 0 or off + len(event.ref) > len(ref_hap.bases):
        return ref_hap.bases
    return ref_hap.bases[:off] + event.alt.encode() + ref_hap.bases[off + len(event.ref):]


def _non_co_occurring_pairs(events, hap_events):
    """OccurrenceMatrix.nonCoOcurringColumns: pairs of events never seen on the
    same haplotype."""
    pairs = []
    key = lambda e: (e.start, e.ref, e.alt)
    sets = [set(key(e) for e in evs) for evs in hap_events]
    for i in range(len(events)):
        for j in range(i + 1, len(events)):
            ki, kj = key(events[i]), key(events[j])
            if not any(ki in s and kj in s for s in sets):
                pairs.append((events[i], events[j]))
    return pairs


def _independent_sets(events, pairs):
    """OccurrenceMatrix.getIndependentSets: connected components of the
    interaction graph."""
    key = lambda e: (e.start, e.ref, e.alt)
    parent = {key(e): key(e) for e in events}

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for a, b in pairs:
        ra, rb = find(key(a)), find(key(b))
        if ra != rb:
            parent[ra] = rb
    by_root = {}
    for e in events:
        by_root.setdefault(find(key(e)), []).append(e)
    return list(by_root.values())


def _allele_qual_pl(lik: AlleleLikelihoods, allele_hap_idx, not_allele_hap_idx) -> int:
    """AlleleFilteringHC.getAlleleLikelihoodVsInverse: marginalize haplotypes to
    {allele, notAllele}, genotype at ploidy 2, return min(PL_het-PL_ref,
    PL_hom-PL_ref) — high value = low-quality allele."""
    vals = np.full((2, lik.n_reads), -np.inf)
    if not_allele_hap_idx:
        vals[0] = lik.values[not_allele_hap_idx].max(axis=0)
    if allele_hap_idx:
        vals[1] = lik.values[allele_hap_idx].max(axis=0)
    gls = compute_genotype_likelihoods(vals, ploidy=2)  # order: 0/0, 0/1, 1/1
    pls = gls_to_pls(gls)
    return int(min(pls[1] - pls[0], pls[2] - pls[0]))


def _allele_sor(lik: AlleleLikelihoods, allele_hap_idx, not_allele_hap_idx) -> float:
    """StrandOddsRatio.calculateSOR over the {notAllele, allele} contingency
    table of best-assigned reads (AlleleFiltering.getAlleleSOR)."""
    vals = np.full((2, lik.n_reads), -np.inf)
    if not_allele_hap_idx:
        vals[0] = lik.values[not_allele_hap_idx].max(axis=0)
    if allele_hap_idx:
        vals[1] = lik.values[allele_hap_idx].max(axis=0)
    table = np.zeros((2, 2))
    for r in range(lik.n_reads):
        best = int(np.argmax(vals[:, r]))
        strand = 1 if getattr(lik.reads[r], "is_reverse", False) else 0
        table[best, strand] += 1
    t00, t01 = table[0, 0] + SOR_PSEUDOCOUNT, table[0, 1] + SOR_PSEUDOCOUNT
    t10, t11 = table[1, 0] + SOR_PSEUDOCOUNT, table[1, 1] + SOR_PSEUDOCOUNT
    ratio = (t00 / t01) * (t11 / t10) + (t01 / t00) * (t10 / t11)
    ref_ratio = min(t00, t01) / max(t00, t01)
    alt_ratio = min(t10, t11) / max(t10, t11)
    return math.log(ratio) + math.log(ref_ratio) - math.log(alt_ratio)


def _identify_bad_alleles(rpls, sors, alleles, qual_threshold, sor_threshold):
    """AlleleFiltering.identifyBadAlleles: worst-quality first, then high-SOR."""
    order = sorted(range(len(rpls)), key=lambda i: rpls[i])
    result = []
    threshold = -qual_threshold  # PLs are -10*GL; QUAL 30 appears as -30
    for i in reversed(order):
        if rpls[i] > threshold:
            result.append(alleles[i])
        else:
            break
    for i in reversed(order):
        if sors[i] > sor_threshold and alleles[i] not in result:
            result.append(alleles[i])
    return result


def filter_alleles(lik: AlleleLikelihoods, active_window_start: int = 0,
                   qual_threshold: float = PREFILTER_QUAL_THRESHOLD,
                   sor_threshold: float = PREFILTER_SOR_THRESHOLD,
                   filter_lone_alleles: bool = False,
                   suspicious_locations: set | None = None) -> AlleleLikelihoods:
    """Return a new read×haplotype AlleleLikelihoods with haplotypes carrying
    weak alleles removed (AlleleFiltering.filterAlleles)."""
    haplotypes = lik.alleles
    ref_hap = next((h for h in haplotypes if h.is_ref), None)
    key = lambda e: (e.start, e.ref, e.alt)
    all_events, seen = [], set()
    for h in haplotypes:
        for e in h.events:
            if key(e) not in seen:
                seen.add(key(e))
                all_events.append(e)
    if not all_events:
        return lik

    hap_events = [h.events for h in haplotypes]
    non_co = _non_co_occurring_pairs(all_events, hap_events)
    close = [(a, b) for a, b in non_co if abs(a.start - b.start) <= 3]
    hmer_pairs = []
    if ref_hap is not None:
        for a, b in non_co:
            if abs(a.start - b.start) <= 20 and equal_up_to_hmer_change(
                    _insert_event_into_ref(ref_hap, a), _insert_event_into_ref(ref_hap, b)):
                hmer_pairs.append((a, b))
    clusters = _independent_sets(all_events, hmer_pairs + close)

    disabled = set()  # haplotype ids
    for cluster in clusters:
        cluster_keys = {key(e) for e in cluster}
        active = {id(h) for h in haplotypes}
        while True:
            active_alleles, seen_k = [], set()
            for h in haplotypes:
                if id(h) not in active:
                    continue
                for e in h.events:
                    if key(e) in cluster_keys and key(e) not in seen_k:
                        seen_k.add(key(e))
                        active_alleles.append(e)
            if not active_alleles:
                break
            rpls, sors = [], []
            allele_haps = {}
            for al in active_alleles:
                with_idx = [i for i, h in enumerate(haplotypes)
                            if id(h) in active and any(key(e) == key(al) for e in h.events)]
                without_idx = [i for i, h in enumerate(haplotypes)
                               if id(h) in active and not any(key(e) == key(al) for e in h.events)]
                allele_haps[key(al)] = with_idx
                rpls.append(_allele_qual_pl(lik, with_idx, without_idx))
                sors.append(_allele_sor(lik, with_idx, without_idx))
            candidates = _identify_bad_alleles(rpls, sors, active_alleles,
                                               qual_threshold, sor_threshold)
            stringent = _identify_bad_alleles(rpls, sors, active_alleles,
                                              STRINGENT_QUAL_THRESHOLD, math.inf)
            if candidates and suspicious_locations is not None:
                for al in active_alleles:
                    suspicious_locations.add(al.start)
            if (candidates and len(active_alleles) > 1) or \
                    (len(active_alleles) == 1 and stringent) or \
                    (candidates and filter_lone_alleles):
                to_disable = candidates[0]
                for i in allele_haps[key(to_disable)]:
                    disabled.add(id(haplotypes[i]))
                    active.discard(id(haplotypes[i]))
            else:
                break

    if not disabled:
        return lik
    keep = [i for i, h in enumerate(haplotypes) if id(h) not in disabled]
    return AlleleLikelihoods(
        alleles=[haplotypes[i] for i in keep],
        reads=list(lik.reads),
        values=lik.values[keep],
    )
