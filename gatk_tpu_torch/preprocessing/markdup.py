# Copied verbatim from gatk_tpu/preprocessing/markdup.py; only import lines may differ.
"""Duplicate marking, matching MarkDuplicatesSpark / Picard MarkDuplicates output.

Reference behavior: tools/spark/transforms/markduplicates/MarkDuplicatesSpark.java
(:199-266 final marking), MarkDuplicatesSparkUtils.java (:102-240 record building,
:288-500 per-site resolution, :563-603 tie-break comparator),
utils/read/markduplicates/{ReadsKey,MarkDuplicatesScoringStrategy}.java,
sparkrecords/{Pair,Fragment,EmptyFragment}.java.
"""
from __future__ import annotations

import functools
from collections import defaultdict

from ..io import sam

MIN_BASE_QUAL = 15
UNKNOWN_LIBRARY = "Unknown Library"


def sum_of_base_qualities(read) -> int:
    q = read.quals
    return int(q[q >= MIN_BASE_QUAL].sum())


def score_read(read) -> int:
    s = min(sum_of_base_qualities(read), 32767 // 2)
    if read.fails_vendor_quality:
        s += -32768 // 2
    return s


def stranded_unclipped_start(read) -> int:
    return read.unclipped_end() if read.is_reverse else read.unclipped_start()


def _parse_location(name: str):
    """(tile, x, y) from the last 3 colon-separated numeric fields (htsjdk
    ReadNameParser default); (-1, -1, -1) if unparseable."""
    parts = name.split(":")
    if len(parts) >= 3:
        try:
            return int(parts[-3]), int(float(parts[-2])), int(float(parts[-1]))
        except ValueError:
            pass
    return -1, -1, -1


class _Record:
    __slots__ = ("name", "score", "r1r", "tile", "x", "y")

    def __init__(self, name, score, r1r):
        self.name = name
        self.score = score
        self.r1r = r1r
        self.tile, self.x, self.y = _parse_location(name)


def _tiebreak_cmp(a: _Record, b: _Record) -> int:
    """TransientFieldPhysicalLocationComparator (not reversed)."""
    if a.r1r != b.r1r:
        return -1 if a.r1r else 1
    if a.tile != b.tile:
        return a.tile - b.tile
    if a.x != b.x:
        return a.x - b.x
    if a.y != b.y:
        return a.y - b.y
    return (a.name > b.name) - (a.name < b.name)


def _best(records):
    """max by score; tie -> minimum under the location comparator."""
    return max(records, key=functools.cmp_to_key(
        lambda a, b: (a.score - b.score) or _tiebreak_cmp(b, a)))


def _library_of(read, rg_library: dict) -> str:
    rg = read.read_group
    return rg_library.get(rg, UNKNOWN_LIBRARY)


def _has_mapped_mate(read) -> bool:
    return read.is_paired and not read.mate_is_unmapped


def find_non_duplicate_names(reads, header):
    """Set of template names that survive duplicate marking (the 'best' of each
    duplicate set, plus passthroughs). reads: all reads (any order)."""
    rg_library = {}
    for rg in header.read_groups:
        rg_library[rg.get("ID")] = rg.get("LB") or UNKNOWN_LIBRARY

    by_name = defaultdict(list)
    for r in reads:
        if not r.is_unmapped and r.pos >= 0:
            by_name[r.name].append(r)

    frag_groups = defaultdict(list)   # fragment key -> [_Record]
    frag_empty = set()                # fragment keys with an EmptyFragment placeholder
    pair_groups = defaultdict(list)   # pair key -> [_Record]
    passthrough_names = set()

    for name, group in by_name.items():
        primaries = [r for r in group if not r.is_secondary and not r.is_supplementary]
        if not primaries:
            passthrough_names.add(name)
            continue
        if len(primaries) > 2:
            raise ValueError(f"template {name} has >2 primary reads")
        for r in primaries:
            fkey = (_library_of(r, rg_library), r.ref_id,
                    stranded_unclipped_start(r), r.is_reverse)
            if _has_mapped_mate(r):
                frag_empty.add(fkey)
            else:
                frag_groups[fkey].append(_Record(name, score_read(r), r.is_reverse))

        mapped_pair = [r for r in primaries if _has_mapped_mate(r)]
        if len(mapped_pair) == 2:
            r1, r2 = mapped_pair
            s1, s2 = stranded_unclipped_start(r1), stranded_unclipped_start(r2)
            if (r1.ref_id != r2.ref_id and r1.ref_id < r2.ref_id) or (
                r1.ref_id == r2.ref_id and s1 <= s2
            ):
                first, second = r1, r2
            else:
                first, second = r2, r1
            if (r1.ref_id == r2.ref_id and s1 == s2
                    and first.is_reverse and not second.is_reverse):
                first, second = second, first
            key = (
                _library_of(first, rg_library),
                first.ref_id, stranded_unclipped_start(first), first.is_reverse,
                second.ref_id, stranded_unclipped_start(second), second.is_reverse,
            )
            pair_groups[key].append(
                _Record(name, score_read(r1) + score_read(r2), first.is_reverse))
        elif len(mapped_pair) == 1:
            passthrough_names.add(name)

    non_dup = set(passthrough_names)
    for fkey, frags in frag_groups.items():
        if fkey in frag_empty:
            continue  # pairs at this site beat all fragments
        non_dup.add(_best(frags).name)
    for pkey, pairs in pair_groups.items():
        non_dup.add(_best(pairs).name)
    return non_dup


def mark_duplicates(reads, header, dont_mark_unmapped_mates: bool = False):
    """Set/clear the duplicate flag on every read in place
    (MarkDuplicatesSpark.mark:229-264). Returns (n_duplicates, non_dup_names)."""
    non_dup = find_non_duplicate_names(reads, header)
    n_dup = 0
    for read in reads:
        read.flag &= ~sam.DUPLICATE
        if read.name in non_dup:
            continue
        if read.is_unmapped and (not read.is_paired or read.mate_is_unmapped):
            continue  # fully unmapped templates are never duplicates
        if dont_mark_unmapped_mates and read.is_unmapped:
            continue
        read.flag |= sam.DUPLICATE
        n_dup += 1
    return n_dup, non_dup


# ---------------------------------------------------------------------------
# Optical duplicates + DuplicationMetrics
# (utils/read/markduplicates/ + picard OpticalDuplicateFinder /
#  DuplicationMetrics: tile/x/y from read names; members of a duplicate set
#  within OPTICAL_DUPLICATE_PIXEL_DISTANCE of a kept member on the same tile
#  are optical rather than library duplicates)
# ---------------------------------------------------------------------------

OPTICAL_DUPLICATE_PIXEL_DISTANCE = 100


def count_optical_duplicates(records, pixel_distance=OPTICAL_DUPLICATE_PIXEL_DISTANCE):
    """Number of optical duplicates within one duplicate set of _Records
    (OpticalDuplicateFinder.getOpticalDuplicatesFlag: greedy transitive
    proximity on the same tile; the best-scoring member is never optical)."""
    if len(records) < 2:
        return 0
    keeper = _best(records)
    others = sorted((r for r in records if r is not keeper),
                    key=lambda r: (r.tile, r.x, r.y))
    kept = [keeper]
    n_optical = 0
    for r in others:
        if r.tile < 0:
            kept.append(r)
            continue
        close = any(k.tile == r.tile and abs(k.x - r.x) <= pixel_distance
                    and abs(k.y - r.y) <= pixel_distance for k in kept)
        if close:
            n_optical += 1
        else:
            kept.append(r)
    return n_optical


def estimate_library_size(read_pairs: int, unique_read_pairs: int):
    """picard DuplicationMetrics.estimateLibrarySize (exact port): solve
    f(x) = c/x - 1 + exp(-n/x) = 0 with c=unique, n=read pairs, by bisection
    over x = m*unique."""
    import math

    dup_pairs = read_pairs - unique_read_pairs
    if read_pairs <= 0 or dup_pairs <= 0:
        return None

    def f(x, c, n):
        return c / x - 1 + math.exp(-n / x)

    m, big = 1.0, 100.0
    if unique_read_pairs >= read_pairs or f(m * unique_read_pairs,
                                            unique_read_pairs, read_pairs) < 0:
        return None
    while f(big * unique_read_pairs, unique_read_pairs, read_pairs) > 0:
        big *= 10.0
    for _ in range(40):
        r = (m + big) / 2.0
        u = f(r * unique_read_pairs, unique_read_pairs, read_pairs)
        if u == 0:
            break
        if u > 0:
            m = r
        else:
            big = r
    return int(unique_read_pairs * (m + big) / 2.0)


def collect_duplication_metrics(reads, header,
                                pixel_distance=OPTICAL_DUPLICATE_PIXEL_DISTANCE):
    """Per-library picard DuplicationMetrics rows. Re-runs the duplicate-set
    grouping to count examined/duplicate/optical reads; returns
    {library: metrics dict}."""
    rg_library = {rg.get("ID"): rg.get("LB") or UNKNOWN_LIBRARY
                  for rg in header.read_groups}
    non_dup = find_non_duplicate_names(reads, header)

    by_name = defaultdict(list)
    metrics: dict = {}

    def m_for(lib):
        return metrics.setdefault(lib, dict(
            UNPAIRED_READS_EXAMINED=0, READ_PAIRS_EXAMINED=0,
            SECONDARY_OR_SUPPLEMENTARY_RDS=0, UNMAPPED_READS=0,
            UNPAIRED_READ_DUPLICATES=0, READ_PAIR_DUPLICATES=0,
            READ_PAIR_OPTICAL_DUPLICATES=0))

    pair_groups = defaultdict(list)
    for r in reads:
        lib = _library_of(r, rg_library)
        if r.is_secondary or r.is_supplementary:
            m_for(lib)["SECONDARY_OR_SUPPLEMENTARY_RDS"] += 1
            continue
        if r.is_unmapped:
            m_for(lib)["UNMAPPED_READS"] += 1
            continue
        by_name[r.name].append(r)

    for name, group in by_name.items():
        lib = _library_of(group[0], rg_library)
        m = m_for(lib)
        mapped_pair = [r for r in group if _has_mapped_mate(r)]
        if len(mapped_pair) == 2:
            m["READ_PAIRS_EXAMINED"] += 1
            if name not in non_dup:
                m["READ_PAIR_DUPLICATES"] += 1
            r1, r2 = mapped_pair
            s1, s2 = stranded_unclipped_start(r1), stranded_unclipped_start(r2)
            first, second = ((r1, r2) if (r1.ref_id, s1) <= (r2.ref_id, s2)
                             else (r2, r1))
            key = (lib, first.ref_id, stranded_unclipped_start(first),
                   first.is_reverse, second.ref_id,
                   stranded_unclipped_start(second), second.is_reverse)
            pair_groups[key].append(_Record(name, score_read(r1) + score_read(r2),
                                            first.is_reverse))
        else:
            for r in group:
                if not _has_mapped_mate(r):
                    m["UNPAIRED_READS_EXAMINED"] += 1
                    if name not in non_dup:
                        m["UNPAIRED_READ_DUPLICATES"] += 1

    for key, records in pair_groups.items():
        if len(records) > 1:
            m_for(key[0])["READ_PAIR_OPTICAL_DUPLICATES"] += \
                count_optical_duplicates(records, pixel_distance)

    for lib, m in metrics.items():
        dup_reads = m["UNPAIRED_READ_DUPLICATES"] + 2 * m["READ_PAIR_DUPLICATES"]
        examined = m["UNPAIRED_READS_EXAMINED"] + 2 * m["READ_PAIRS_EXAMINED"]
        m["PERCENT_DUPLICATION"] = (dup_reads / examined) if examined else 0.0
        m["ESTIMATED_LIBRARY_SIZE"] = estimate_library_size(
            m["READ_PAIRS_EXAMINED"] - m["READ_PAIR_OPTICAL_DUPLICATES"],
            m["READ_PAIRS_EXAMINED"] - m["READ_PAIR_DUPLICATES"])
    return metrics
