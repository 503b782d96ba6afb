# Copied verbatim from gatk_tpu/calling/pd_haplotypes.py; only import lines may differ.
"""Partially-determined haplotype computation (DRAGEN-GATK PDHMM mode).

Reference behavior: haplotypecaller/PartiallyDeterminedHaplotypeComputationEngine.java
(generatePDHaplotypes :83-195, getEventGroupClusters :338-360, computeBranches
:372-396, EventGroup :633-776, constructHaplotypeFromEvents :464-515,
createNewPDHaplotypeFromEvents :536-629) and
utils/haplotype/PartiallyDeterminedHaplotype.java (the pd-byte bit encoding :59-66,
getPDBytesForHaplotypes :174-203).

A PD haplotype represents one *determined* allele (ref or alt) at one locus with
every other discovered event marked "undetermined" in a per-base bitset: an
undetermined SNP lets the PDHMM treat either base as a match; an undetermined
deletion keeps the reference bases but marks a DEL_START..DEL_END span the HMM may
jump over; an undetermined insertion is flipped into the haplotype and marked the
same way. This collapses the per-allele max over haplotypes that the genotyper
would otherwise marginalize into a single HMM evaluation per allele.
"""
from __future__ import annotations

import numpy as np

from ..assembly.haplotype import Event, Haplotype, build_event_map
from ..io import sam

# pd-byte bit flags (PartiallyDeterminedHaplotype.java:59-66)
SNP = 1
DEL_START = 2
DEL_END = 4
BASE_BIT = {ord("A"): 8, ord("C"): 16, ord("G"): 32, ord("T"): 64, ord("N"): 128}

MAX_PD_HAPS_TO_GENERATE = 256 * 2
MAX_BRANCH_PD_HAPS = 128
MAX_VAR_IN_EVENT_GROUP = 17


def hap_snp_first_key(e: Event):
    """HAPLOTYPE_SNP_FIRST_COMPARATOR (:52-56): start, then ref len, alt len, alt."""
    return (e.start, len(e.ref), len(e.alt), e.alt)


def is_simple_insertion(e: Event) -> bool:
    return len(e.ref) == 1 and len(e.alt) > 1


def is_simple_deletion(e: Event) -> bool:
    return len(e.alt) == 1 and len(e.ref) > 1


def _dragen_start(e: Event) -> float:
    """Modified start for overlap tests (:785-787): deletions don't overlap on the
    anchor base; insertions live between bases (+0.5)."""
    if e.is_indel():
        return e.start + (1.0 if is_simple_deletion(e) else 0.5)
    return float(e.start)


def _dragen_end(e: Event) -> float:
    end_incl = e.start + len(e.ref) - 1
    return end_incl + (0.5 if is_simple_insertion(e) else 0.0)


def events_overlap_for_pd(e1: Event, e2: Event) -> bool:
    """eventsOverlapForPDHapsCode (:405-413)."""
    return not (_dragen_start(e1) > _dragen_end(e2) or _dragen_start(e2) > _dragen_end(e1))


# ---------------------------------------------------------------------------
# Event groups: maximal clusters of mutually-incompatible events
# ---------------------------------------------------------------------------


def get_event_group_clusters(events_in_order, sw_mutexes):
    """Partition events into connected components of the incompatibility graph
    (overlap edges + Smith-Waterman-forbidden pairs/trios; :338-360). Returns a
    list of EventGroup, or None if any component exceeds MAX_VAR_IN_EVENT_GROUP."""
    all_mutexes = list(sw_mutexes)
    n = len(events_in_order)
    for i in range(n):
        e1 = events_in_order[i]
        e1_end = e1.start + len(e1.ref) - 1
        for j in range(i + 1, n):
            e2 = events_in_order[j]
            if e2.start > e1_end + 1:
                break
            if events_overlap_for_pd(e1, e2):
                all_mutexes.append([e1, e2])

    # union-find over the mutex edges
    parent = list(range(n))
    index = {e: i for i, e in enumerate(events_in_order)}

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for mutex in all_mutexes:
        ids = [index[e] for e in mutex]
        for a, b in zip(ids, ids[1:]):
            ra, rb = find(a), find(b)
            if ra != rb:
                parent[ra] = rb

    components: dict = {}
    for i, e in enumerate(events_in_order):
        components.setdefault(find(i), []).append(e)
    if any(len(c) > MAX_VAR_IN_EVENT_GROUP for c in components.values()):
        return None
    return [EventGroup(c, all_mutexes) for c in components.values()]


class EventGroup:
    """Manages one mutually-incompatible event cluster and the bitset of allowed
    subsets (EventGroup :633-776). Subset i is allowed iff it contains no
    mutex (pair/trio) as a subset."""

    def __init__(self, events, mutex_pairs_and_trios):
        assert len(events) <= MAX_VAR_IN_EVENT_GROUP
        self.events = sorted(events, key=hap_snp_first_key)
        self.index = {e: i for i, e in enumerate(self.events)}
        n = len(self.events)
        self._cached_event_sets = None
        if n < 2:
            self.allowed = None
            return
        overlapping = []
        for mutex in mutex_pairs_and_trios:
            # overlapping SNPs form event groups but are NOT forbidden combos
            # for PD haplotypes (:658-661)
            if (len(mutex) == 2 and mutex[0].start == mutex[1].start
                    and mutex[0].is_snp() and mutex[1].is_snp()):
                continue
            if any(e in self.index for e in mutex):
                assert all(e in self.index for e in mutex), \
                    "mutex group only partially overlaps event group"
                overlapping.append(mutex)
        allowed = np.ones(1 << n, bool)
        allowed[0] = False
        idx = np.arange(1 << n, dtype=np.int64)
        for mutex in overlapping:
            m = 0
            for e in mutex:
                m |= 1 << self.index[e]
            allowed[(idx & m) == m] = False
        self.allowed = allowed

    def _overlap_mask(self, events) -> int:
        m = 0
        for e in events:
            i = self.index.get(e)
            if i is not None:
                m |= 1 << i
        return m

    def event_sets_for_pd_haplotypes(self, determined_events, locus_events):
        """Maximal allowed subsets that agree with the determined events on the
        determined locus (eventSetsForPDHaplotypes :716-756)."""
        locus_mask = self._overlap_mask(locus_events)
        det_mask = self._overlap_mask(determined_events)
        n = len(self.events)
        if n == 1:
            # faithful to :720-723 including its use of the GLOBAL determined set
            if locus_mask and not determined_events:
                return [frozenset()]
            return [frozenset([self.events[0]])]
        cached_case = locus_mask == 0 and det_mask == 0
        if cached_case and self._cached_event_sets is not None:
            return self._cached_event_sets

        idx = np.arange(1 << n, dtype=np.int64)
        valid = np.nonzero(self.allowed & ((idx & locus_mask) == det_mask))[0]
        maximal: list[int] = []
        # descending index order guarantees supersets precede subsets
        for s in valid[::-1]:
            s = int(s)
            if not any((s & k) == s for k in maximal):
                maximal.append(s)
        out = [frozenset(self.events[i] for i in range(n) if (s >> i) & 1)
               for s in maximal]
        if cached_case:
            self._cached_event_sets = out
        return out


def compute_branches(event_groups, determined_events, locus_events):
    """All unions of per-group maximal allowed subsets (:372-396); None if the
    combinatorial product exceeds MAX_BRANCH_PD_HAPS."""
    branches = [set()]
    for group in event_groups:
        sets_to_add = group.event_sets_for_pd_haplotypes(determined_events, locus_events)
        extra = []
        if len(sets_to_add) >= 2:
            extra = [b | s for b in branches for s in sets_to_add[1:]]
        if sets_to_add:
            for b in branches:
                b |= sets_to_add[0]
        branches.extend(extra)
        if len(branches) > MAX_BRANCH_PD_HAPS:
            return None
    return branches


# ---------------------------------------------------------------------------
# Haplotype construction
# ---------------------------------------------------------------------------


def _actual_start(e: Event) -> int:
    """Event start excluding the initial shared indel anchor base (:517-519)."""
    return e.start + (1 if e.is_indel() else 0)


class _CigarBuilder:
    """Merge-adjacent/drop-zero cigar accumulation; strips leading/trailing
    deletions (read/CigarBuilder.java behavior)."""

    def __init__(self):
        self.ops: list[int] = []
        self.lens: list[int] = []

    def add(self, op: int, ln: int):
        if ln <= 0:
            return
        if self.ops and self.ops[-1] == op:
            self.lens[-1] += ln
        else:
            self.ops.append(op)
            self.lens.append(ln)

    def make(self):
        ops, lens = self.ops, self.lens
        while ops and ops[0] == sam.OP_D:
            ops, lens = ops[1:], lens[1:]
        while ops and ops[-1] == sam.OP_D:
            ops, lens = ops[:-1], lens[:-1]
        return np.asarray(ops, np.uint8), np.asarray(lens, np.int32)


def construct_haplotype_from_events(ref_bases, ref_start: int, events, max_mnp=0) -> Haplotype:
    """Determined haplotype from a sorted event list (:464-515). SNPs become X
    cigar elements; accepts a SNP immediately before an indel at the same anchor."""
    ref_bases = np.asarray(ref_bases, np.uint8)
    events = list(events)
    for i in range(len(events) - 1):
        if not (events[i].start + len(events[i].ref) - 1 < _actual_start(events[i + 1])):
            raise ValueError(f"PD event list out of order/overlapping: {events}")
    for e in events:
        if e.start < ref_start or e.start + len(e.ref) - 1 >= ref_start + len(ref_bases):
            raise ValueError(f"event {e} does not lie within the reference haplotype")

    cigar = _CigarBuilder()
    out = bytearray()
    last = ref_start
    for e in events:
        actual = _actual_start(e)
        cigar.add(sam.OP_M, actual - last)
        diff = len(e.alt) - len(e.ref)
        if diff == 0:
            cigar.add(sam.OP_X, len(e.ref))
        else:
            cigar.add(sam.OP_D if diff < 0 else sam.OP_I, abs(diff))
        out += ref_bases[last - ref_start : actual - ref_start].tobytes()
        out += (e.alt if diff == 0 else e.alt[1:]).encode()
        last = e.start + len(e.ref)
    out += ref_bases[last - ref_start :].tobytes()
    cigar.add(sam.OP_M, len(ref_bases) - (last - ref_start))
    ops, lens = cigar.make()
    hap = Haplotype(bytes(out), is_ref=False, cigar_ops=ops, cigar_lens=lens,
                    alignment_start=ref_start)
    build_event_map(hap, ref_bases, ref_start, max_mnp_distance=max_mnp)
    return hap


def get_pd_bytes_for_haplotypes(use_allele: str, other_allele: str) -> np.ndarray:
    """pd-byte template for one undetermined event (getPDBytesForHaplotypes
    :174-203): SNP -> [SNP|base bit of other]; indel -> DEL_START..DEL_END over
    len(use)-1 skippable bases."""
    if len(use_allele) == len(other_allele):
        return np.array([SNP + BASE_BIT[ord(other_allele[0])]], np.uint8)
    out = np.zeros(len(use_allele) - 1, np.uint8)
    out[0] += DEL_START
    out[-1] += DEL_END
    return out


class PDHaplotype(Haplotype):
    """Haplotype + per-base undetermined-event bitset
    (utils/haplotype/PartiallyDeterminedHaplotype.java)."""

    def __init__(self, bases, pd_bytes, determined_events, determined_position,
                 constituent_events, determined_extent, cigar_ops, cigar_lens,
                 alignment_start):
        super().__init__(bases=bases, is_ref=False, cigar_ops=cigar_ops,
                         cigar_lens=cigar_lens, alignment_start=alignment_start)
        self.pd_bytes = pd_bytes
        self.determined_events = frozenset(determined_events)
        self.determined_position = determined_position
        self.constituent_events = tuple(constituent_events)
        # span of ALL alleles at the determined locus (read-overlap optimization
        # safety; PartiallyDeterminedHaplotype.java:105-107)
        self.determined_extent = determined_extent
        # the genotyper must see ONLY the determined events in the event map
        self.events = sorted(determined_events, key=hap_snp_first_key)
        self.is_determined_ref = not determined_events

    def __hash__(self):
        return hash((self.bases, self.pd_bytes.tobytes(), self.determined_position))

    def __eq__(self, other):
        return (isinstance(other, PDHaplotype)
                and self.determined_position == other.determined_position
                and self.bases == other.bases
                and np.array_equal(self.pd_bytes, other.pd_bytes))


def create_pd_haplotype(ref_bases, ref_start: int, determined_events,
                        determined_locus: int, constituent_events,
                        all_events_at_locus) -> PDHaplotype:
    """createNewPDHaplotypeFromEvents (:536-629): bases carry the longest allele
    for undetermined indels (insertions flipped in), pd bytes mark undetermined
    spans, the cigar tracks the determined event only."""
    ref_bases = np.asarray(ref_bases, np.uint8)
    determined_events = set(determined_events)
    ref_is_determined = not determined_events

    out = bytearray()
    pd = bytearray()
    cigar = _CigarBuilder()
    last = ref_start
    last_was_snp = False
    for e in constituent_events:
        actual = _actual_start(e)
        before = actual - last
        if before == -1 and e.is_snp() and last_was_snp:
            # two SNPs at one position: merge into the last pd byte (:560-565)
            pd[-1] |= int(get_pd_bytes_for_haplotypes(e.ref, e.alt)[0])
            continue
        if e.start == determined_locus and ref_is_determined:
            continue  # ref determined: skip alt alleles at the locus (:566-569)
        if before < 0:
            raise ValueError(f"event {e} out of order in PD event list {constituent_events}")

        diff = len(e.alt) - len(e.ref)
        is_insertion = diff > 0
        is_event = e in determined_events
        cigar.add(sam.OP_M, before)
        if e.is_snp():
            cigar.add(sam.OP_M if (ref_is_determined or not is_event) else sam.OP_X,
                      len(e.ref))
        elif is_event:
            ln = 0 if (is_insertion and ref_is_determined) else max(len(e.ref), len(e.alt)) - 1
            cigar.add(sam.OP_I if is_insertion else (sam.OP_M if ref_is_determined else sam.OP_D), ln)
        else:
            cigar.add(sam.OP_I if is_insertion else sam.OP_M, abs(diff))

        out += ref_bases[last - ref_start : actual - ref_start].tobytes()
        pd += bytes(actual - last)
        use_is_ref = (is_event and ref_is_determined) or (not is_event and diff <= 0)
        use = e.ref if use_is_ref else e.alt
        other = e.alt if use_is_ref else e.ref
        to_add = use[1:] if e.is_indel() else use
        out += to_add.encode()
        if is_event:
            pd += bytes(len(to_add))
        else:
            pd += get_pd_bytes_for_haplotypes(use, other).tobytes()
        last = e.start + len(e.ref)
        last_was_snp = e.is_snp()

    out += ref_bases[last - ref_start :].tobytes()
    pd += bytes(len(ref_bases) - (last - ref_start))
    cigar.add(sam.OP_M, len(ref_bases) - (last - ref_start))

    lo = min((ev.start for ev in all_events_at_locus), default=determined_locus)
    hi = max((ev.start + len(ev.ref) - 1 for ev in all_events_at_locus),
             default=determined_locus)
    ops, lens = cigar.make()
    return PDHaplotype(bytes(out), np.frombuffer(bytes(pd), np.uint8).copy(),
                       determined_events, determined_locus, constituent_events,
                       (lo, hi), ops, lens, ref_start)


# ---------------------------------------------------------------------------
# Smith-Waterman equivalent-event mutex discovery
# ---------------------------------------------------------------------------


def _test_equivalent_events(ref_bases, ref_start, all_events, events_to_test, sw_params):
    """constructArtificialHaplotypeAndTestEquivalentEvents (:434-458): inject the
    candidate events into the reference, realign, and forbid the set if the
    realigned event map surfaces a DIFFERENT already-discovered event."""
    from ..ops import smith_waterman as sw

    hap = construct_haplotype_from_events(ref_bases, ref_start, events_to_test)
    if hap.bases == np.asarray(ref_bases, np.uint8).tobytes():
        return True  # events add up to the reference (:437-440)
    aln = sw.align(np.asarray(ref_bases, np.uint8),
                   np.frombuffer(hap.bases, np.uint8), sw_params, sw.INDEL)
    realigned = Haplotype(hap.bases, cigar_ops=aln.cigar_ops, cigar_lens=aln.cigar_lens,
                          alignment_start=ref_start + aln.offset)
    new_events = build_event_map(realigned, np.asarray(ref_bases, np.uint8), ref_start)
    tested = set(events_to_test)
    known = set(all_events)
    return any(ev not in tested and ev in known for ev in new_events)


def sw_disallowed_mutexes(ref_bases, ref_start, events_in_order, sw_params):
    """smithWatermanRealignPairsOfVariantsForEquivalentEvents (:247-309): all 2-
    and 3-element non-overlapping subsets containing an indel whose realignment
    reduces to other discovered events."""
    disallowed: list[list[Event]] = []
    n = len(events_in_order)
    for i in range(n):
        first = events_in_order[i]
        if not first.is_indel():
            continue
        for j in range(n):
            second = events_in_order[j]
            if j == i or events_overlap_for_pd(first, second):
                continue
            if second.is_indel() and j <= i:
                continue
            pair = sorted([first, second], key=hap_snp_first_key)
            if _test_equivalent_events(ref_bases, ref_start, events_in_order, pair, sw_params):
                disallowed.append(pair)
    for i in range(n):
        first = events_in_order[i]
        if not first.is_indel():
            continue
        for j in range(n):
            second = events_in_order[j]
            if j == i or events_overlap_for_pd(first, second):
                continue
            if second.is_indel() and j <= i:
                continue
            if any(first in p and second in p for p in disallowed):
                continue
            for k in range(j + 1, n):
                third = events_in_order[k]
                if k == i or events_overlap_for_pd(third, first) or \
                        events_overlap_for_pd(third, second):
                    continue
                if any((first in p and third in p) or (second in p and third in p)
                       for p in disallowed):
                    continue
                trio = sorted([first, second, third], key=hap_snp_first_key)
                if _test_equivalent_events(ref_bases, ref_start, events_in_order, trio, sw_params):
                    disallowed.append(trio)
    return disallowed


# ---------------------------------------------------------------------------
# Top-level driver
# ---------------------------------------------------------------------------


def generate_pd_haplotypes(haplotypes, ref_bases, ref_start: int, span,
                           bad_pileup_events=(), good_pileup_events=(),
                           snp_adjacent_to_indel_range: int = 5, sw_params=None):
    """generatePDHaplotypes (:83-195). haplotypes: assembled haplotypes with event
    maps; span: (start, end) calling span (0-based half-open). Returns the PD
    haplotype list, or None on any heuristic abort (caller falls back to the
    assembled haplotypes)."""
    from ..ops import smith_waterman as sw

    sw_params = sw_params or sw.NEW_SW_PARAMETERS
    bad = set(bad_pileup_events)
    passing = {e for h in haplotypes for e in h.events if e not in bad}
    indels = [e for e in passing if e.is_indel()]
    for e in good_pileup_events:
        if e in passing:
            continue
        if e.is_indel() or all(
                not _within_distance(e, ind, snp_adjacent_to_indel_range) for ind in indels):
            passing.add(e)
    events_in_order = sorted(passing, key=hap_snp_first_key)
    if not events_in_order:
        return None

    disallowed = sw_disallowed_mutexes(ref_bases, ref_start, events_in_order, sw_params)
    event_groups = get_event_group_clusters(events_in_order, disallowed)
    if event_groups is None:
        return None

    by_start: dict[int, list[Event]] = {}
    for e in events_in_order:
        by_start.setdefault(e.start, []).append(e)

    output: dict[PDHaplotype, None] = {}
    span_start, span_end = span
    for determined_locus in sorted(by_start):
        all_events_here = by_start[determined_locus]
        if not (span_start <= determined_locus < span_end):
            continue
        for det_idx in range(-1, len(all_events_here)):  # -1 == ref determined
            determined = set() if det_idx == -1 else {all_events_here[det_idx]}
            branches = compute_branches(event_groups, determined, all_events_here)
            if branches is None:
                return None
            for branch in branches:
                constituent = sorted(branch, key=hap_snp_first_key)
                pd_hap = create_pd_haplotype(ref_bases, ref_start, determined,
                                             determined_locus, constituent,
                                             all_events_here)
                output.setdefault(pd_hap)
                if len(output) > MAX_PD_HAPS_TO_GENERATE:
                    return None
    return sorted(output, key=lambda h: h.bases)


def _within_distance(a: Event, b: Event, dist: int) -> bool:
    return a.start <= b.start + len(b.ref) - 1 + dist and b.start <= a.start + len(a.ref) - 1 + dist
