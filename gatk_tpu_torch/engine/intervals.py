# Copied verbatim from gatk_tpu/engine/intervals.py; only import lines may differ.
"""Genomic interval machinery (SimpleInterval / IntervalUtils equivalents).

Reference behavior: utils/SimpleInterval.java, utils/IntervalUtils.java (parsing,
padding, splitting), engine/ShardBoundary.java (padded shard boundaries — the
halo-exchange analogue used for distribution).

Internally 0-based half-open; the string form "chr:start-end" is 1-based closed like
GATK's -L syntax.
"""
from __future__ import annotations

import re
from dataclasses import dataclass


@dataclass(frozen=True, order=True)
class Interval:
    contig: str
    start: int  # 0-based inclusive
    end: int  # 0-based exclusive

    def __post_init__(self):
        if self.start < 0 or self.end < self.start:
            raise ValueError(f"malformed interval {self}")

    @property
    def size(self) -> int:
        return self.end - self.start

    def __str__(self):
        return f"{self.contig}:{self.start + 1}-{self.end}"

    def overlaps(self, other: "Interval") -> bool:
        return self.contig == other.contig and self.start < other.end and other.start < self.end

    def contains(self, other: "Interval") -> bool:
        return self.contig == other.contig and self.start <= other.start and other.end <= self.end

    def intersect(self, other: "Interval") -> "Interval":
        if not self.overlaps(other):
            raise ValueError(f"{self} does not overlap {other}")
        return Interval(self.contig, max(self.start, other.start), min(self.end, other.end))

    def expand(self, padding: int, contig_length: int | None = None) -> "Interval":
        end = self.end + padding
        if contig_length is not None:
            end = min(end, contig_length)
        return Interval(self.contig, max(0, self.start - padding), end)

    def span_with(self, other: "Interval") -> "Interval":
        if self.contig != other.contig:
            raise ValueError("cannot span across contigs")
        return Interval(self.contig, min(self.start, other.start), max(self.end, other.end))


_RE_FULL = re.compile(r"^(.+):(\d[\d,]*)-(\d[\d,]*)$")
_RE_POS = re.compile(r"^(.+):(\d[\d,]*)(\+?)$")


def parse_interval(s: str, contig_lengths: dict | None = None) -> Interval:
    """Parse GATK -L syntax: 'chr', 'chr:pos', 'chr:start-end', 'chr:pos+'."""
    s = s.strip()
    m = _RE_FULL.match(s)
    if m:
        start = int(m.group(2).replace(",", ""))
        end = int(m.group(3).replace(",", ""))
        return Interval(m.group(1), start - 1, end)
    m = _RE_POS.match(s)
    if m:
        start = int(m.group(2).replace(",", ""))
        if m.group(3) == "+":
            if not contig_lengths:
                raise ValueError(f"'{s}' needs contig lengths")
            return Interval(m.group(1), start - 1, contig_lengths[m.group(1)])
        return Interval(m.group(1), start - 1, start)
    if contig_lengths is not None and s in contig_lengths:
        return Interval(s, 0, contig_lengths[s])
    if contig_lengths is None:
        raise ValueError(f"cannot parse interval '{s}' without contig lengths")
    raise ValueError(f"unknown contig '{s}'")


def merge_overlapping(intervals) -> list:
    """Sort (by contig order of appearance, then start) and merge overlapping/adjacent."""
    by_contig = {}
    order = []
    for iv in intervals:
        if iv.contig not in by_contig:
            by_contig[iv.contig] = []
            order.append(iv.contig)
        by_contig[iv.contig].append(iv)
    out = []
    for contig in order:
        ivs = sorted(by_contig[contig], key=lambda x: (x.start, x.end))
        cur = ivs[0]
        for nxt in ivs[1:]:
            if nxt.start <= cur.end:
                cur = Interval(contig, cur.start, max(cur.end, nxt.end))
            else:
                out.append(cur)
                cur = nxt
        out.append(cur)
    return out


def split_interval(iv: Interval, max_size: int) -> list:
    """Split into consecutive pieces of at most max_size."""
    out = []
    s = iv.start
    while s < iv.end:
        e = min(s + max_size, iv.end)
        out.append(Interval(iv.contig, s, e))
        s = e
    return out


@dataclass(frozen=True)
class Shard:
    """An interval shard with padded context (engine/ShardBoundary equivalent)."""

    interval: Interval
    padded: Interval

    @classmethod
    def make(cls, iv: Interval, padding: int, contig_length: int | None = None):
        return cls(iv, iv.expand(padding, contig_length))


def make_shards(intervals, shard_size: int, padding: int, contig_lengths: dict) -> list:
    """Split intervals into padded shards (AssemblyRegionWalker.makeReadShards model)."""
    shards = []
    for iv in merge_overlapping(intervals):
        for piece in split_interval(iv, shard_size):
            shards.append(Shard.make(piece, padding, contig_lengths.get(iv.contig)))
    return shards


def load_interval_file(path: str, contig_lengths: dict | None = None) -> list:
    """Intervals from a file: BED (0-based half-open), Picard .interval_list
    (@-header + 1-based inclusive columns), GATK .intervals/.list (one -L
    string per line), or VCF (record spans)
    (utils/IntervalUtils.parseIntervalArguments file dispatch)."""
    lower = path.lower()
    out = []
    if lower.endswith((".bed", ".bed.gz")):
        import gzip as _gz

        op = _gz.open if lower.endswith(".gz") else open
        with op(path, "rt") as fh:
            for line in fh:
                if not line.strip() or line.startswith(("#", "track", "browser")):
                    continue
                f = line.split("\t")
                out.append(Interval(f[0], int(f[1]), int(f[2])))
    elif lower.endswith(".interval_list"):
        with open(path) as fh:
            for line in fh:
                if line.startswith("@") or not line.strip():
                    continue
                f = line.split("\t")
                out.append(Interval(f[0], int(f[1]) - 1, int(f[2])))
    elif lower.endswith((".vcf", ".vcf.gz")):
        from ..io import vcf as _vcf

        for v in _vcf.VcfReader(path):
            out.append(Interval(v.contig, v.pos, v.pos + len(v.ref)))
    else:  # .intervals / .list: one -L string per line
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if line and not line.startswith(("#", "@")):
                    out.append(parse_interval(line, contig_lengths))
    return out


def parse_intervals_arg(values, contig_lengths: dict | None = None) -> list:
    """GATK -L semantics: each value is an interval string OR a path to an
    interval file (BED/.interval_list/.intervals/.list/VCF)."""
    import os as _os

    out = []
    for s in values:
        if _os.path.exists(s) and (
                "." in _os.path.basename(s) and not _RE_FULL.match(s)):
            out.extend(load_interval_file(s, contig_lengths))
        else:
            out.append(parse_interval(s, contig_lengths))
    return out
