"""The reads of each -ERC GVCF active region, picked by a sorted scan.

call_interval_gvcf picks each region's reads with hc_engine.reads_overlapping
(a searchsorted cut on the reads' starts and one compare on their ends) where
gatk_tpu tests every read of the shard with a list scan. These tests hold the
sorted scan to that list scan: the same reads, the same objects, in the same
order, at the scan's exact bounds (strict on both sides, unclamped at the
contig's start).
"""
import types

import numpy as np
import pytest

from gatk_tpu_torch.calling import hc_engine as port_hc
from gatk_tpu_torch.engine.intervals import Interval
from gatk_tpu_torch.io import bam as port_bam
from gatk_tpu_torch.io import fasta as port_fasta
from gatk_tpu_torch.io.reads import Read
from gatk_tpu_torch.utils import synthetic
from gatk_tpu_torch.utils.javarandom import reset_random_generator

PAD = port_hc.REGION_PADDING
M, D = 0, 2  # CIGAR operations


def _read(name, pos, cigar=((M, 100),)):
    ops = np.array([o for o, _ in cigar], np.uint8)
    lens = np.array([n for _, n in cigar], np.int32)
    n = sum(n for o, n in cigar if o != D)
    return Read.make(name, 0, 0, pos, 60, ops, lens, np.full(n, ord("A"), np.uint8),
                     np.full(n, 30, np.uint8))


def _sorted(reads):
    return sorted(reads, key=lambda r: (r.pos, r.name))


def _list_scan(reads, start, end):
    """gatk_tpu's selection in call_interval_gvcf."""
    return [r for r in reads if r.pos < end and r.end > start]


def _random_reads():
    # 3,000 reads on 400 distinct starts (many equal starts), of 1-250 bases,
    # one in ten with a 1-400 base deletion
    rng = np.random.default_rng(2024)
    reads = []
    for k in range(3000):
        pos = int(rng.integers(0, 400)) * 5
        if k % 10 == 0:
            cigar = ((M, int(rng.integers(1, 80))), (D, int(rng.integers(1, 400))),
                     (M, int(rng.integers(1, 80))))
        else:
            cigar = ((M, int(rng.integers(1, 250))),)
        reads.append(_read(f"r{k:05d}", pos, cigar))
    regions = [(0, 1)]
    for _ in range(60):
        s = int(rng.integers(-200, 2200))
        regions.append((s, s + int(rng.integers(1, 400))))
    return _sorted(reads), regions, None


def _end_at_lower_bound():
    # region [1000, 1200): lower bound 1000 - PAD; a read that ends there is out
    lo = 1000 - PAD
    reads = [_read("ends_at_bound", lo - 100), _read("ends_past_bound", lo - 99),
             _read("inside", 1050)]
    return _sorted(reads), [(1000, 1200)], ["ends_past_bound", "inside"]


def _start_at_upper_bound():
    # region [1000, 1200): upper bound 1200 + PAD; a read that starts there is out
    hi = 1200 + PAD
    reads = [_read("inside", 1100), _read("starts_before_bound", hi - 1),
             _read("starts_at_bound", hi), _read("past", hi + 5)]
    return _sorted(reads), [(1000, 1200)], ["inside", "starts_before_bound"]


def _contig_start():
    # region [10, 60): the lower bound 10 - PAD is negative; no clamp to 0
    reads = [_read("a", 0, ((M, 1),)), _read("b", 0), _read("c", 30), _read("far", 60 + PAD)]
    return _sorted(reads), [(10, 60), (0, 1)], ["a", "b", "c"]


def _long_deletion():
    # a read 10,000 bases before the region whose deletion carries its end
    # into it, between reads that end before the region
    reads = [_read("before", 0), _read("long_del", 100, ((M, 50), (D, 10_000), (M, 50))),
             _read("short", 200), _read("inside", 10_200), _read("after", 20_000)]
    return _sorted(reads), [(10_200, 10_300)], ["long_del", "inside"]


def _empty():
    return [], [(0, 100), (-PAD, 10)], []


CASES = {
    "random_equal_starts": _random_reads,
    "end_at_lower_bound_excluded": _end_at_lower_bound,
    "start_at_upper_bound_excluded": _start_at_upper_bound,
    "contig_start_negative_bound": _contig_start,
    "long_deletion": _long_deletion,
    "empty": _empty,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sorted_scan_is_the_list_scan(case):
    reads, regions, want_first = CASES[case]()
    bounds = port_hc.read_bounds_of(reads)
    for k, (start, end) in enumerate(regions):
        lo, hi = start - PAD, end + PAD
        got = port_hc.reads_overlapping(reads, bounds, lo, hi)
        want = _list_scan(reads, lo, hi)
        assert [id(r) for r in got] == [id(r) for r in want], (case, start, end)
        if k == 0 and want_first is not None:
            assert [r.name for r in got] == want_first
    if case == "random_equal_starts":
        assert len({r.pos for r in reads}) <= 400
        assert sum(bool(_list_scan(reads, s - PAD, e + PAD)) for s, e in regions) > 40


def test_call_interval_gvcf_feeds_the_list_scans_reads(tmp_path, monkeypatch):
    """Each active region's reads, as finalize_region_reads receives them, are
    the list scan's over the filtered, downsampled reads."""
    sample = synthetic.write_sample(str(tmp_path), seed=5, length=3000, n_reads=1500,
                                    n_snv=4, n_indel=2, min_gap=300)
    contig = sample["contig"]
    interval = Interval(contig, 500, 2500)
    ref = port_fasta.FastaReference(sample["fasta"])
    reads = sorted(port_bam.BamReader(sample["bam"]).query(contig, 0, sample["length"]),
                   key=lambda r: (r.pos, r.name))

    seen = {}
    downsample = port_hc.positional_downsample

    def record_usable(rs, max_per_start):
        seen["usable"] = downsample(rs, max_per_start)
        return seen["usable"]

    regions = []
    finalize = port_hc.finalize_region_reads

    def record_region(region_reads, padded, args):
        # padded lies inside the contig here, so it is the scan's unclamped bounds
        assert 0 < padded.start and padded.end < sample["length"]
        want = _list_scan(seen["usable"], padded.start, padded.end)
        regions.append((padded, [id(r) for r in region_reads], [id(r) for r in want]))
        return finalize(region_reads, padded, args)

    monkeypatch.setattr(port_hc, "positional_downsample", record_usable)
    monkeypatch.setattr(port_hc, "finalize_region_reads", record_region)
    monkeypatch.setattr(port_hc.assembler, "assemble",
                        lambda *a, **k: types.SimpleNamespace(haplotypes=[object()]))
    reset_random_generator()
    engine = port_hc.HaplotypeCallerEngine(ref, "SYN1", port_hc.HCArgs())
    records = port_hc.call_interval_gvcf(engine, reads, interval)

    assert records and len(regions) >= 4, len(regions)
    for padded, got, want in regions:
        assert want and got == want, padded
