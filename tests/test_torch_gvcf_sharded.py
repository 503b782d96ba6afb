"""HaplotypeCaller -ERC GVCF's active regions on the scheduler's pool.

call_interval_gvcf hands an interval's active regions to
parallel/scheduler.ShardedCaller.call_gvcf_regions: the pool threads run
HaplotypeCallerEngine.prepare_gvcf_region (assembly, read prep and packing)
while the calling thread computes the interval's reference confidence, then
runs launch_gvcf_region (the cartesian launch) and finish_gvcf_region (the
wait and the genotyping) in region order. On the CPU
(devices=[cpu]) the records are gatk_tpu's call_interval_gvcf's, record for
record, with 1, 2 or 6 pool threads, on intervals at both ends of the contig
and in its middle, and stay so when the first region's preparation ends last.
On a card every assembled region is one launch of the matrix kernel.

The module imports neither jax nor gatk_tpu (the CPU tests import gatk_tpu
inside), so the card's test also runs where only the port is installed:

    python -m pytest --noconftest tests/test_torch_gvcf_sharded.py -m cuda -q
"""
import threading

import pytest
import torch

from gatk_tpu_torch.calling import hc_engine as port_hc
from gatk_tpu_torch.gvcf import refconf
from gatk_tpu_torch.io import bam as port_bam
from gatk_tpu_torch.io import fasta as port_fasta
from gatk_tpu_torch.io import vcf as port_vcf
from gatk_tpu_torch.ops import pairhmm
from gatk_tpu_torch.parallel import scheduler
from gatk_tpu_torch.utils import javarandom as port_random
from gatk_tpu_torch.utils import synthetic

CPU = torch.device("cpu")
LENGTH = 1200
# (start, end): from the contig's start, across its middle, to its end; each
# cuts an active region of the sample in two (regions 269-344, 438-513, 651-737)
INTERVALS = {"contig_start": (0, 480), "middle": (300, 700), "contig_end": (480, LENGTH)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain PairHMM's torch ops on one thread: the suite runs test files
    in parallel worker processes, and each pool thread here runs its own."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sample(tmp_path_factory):
    # 200 reads of 151 bases on 1,200 bases (25x), a SNV at 306 and 475, an
    # insertion at 693
    d = tmp_path_factory.mktemp("torch_gvcf_sharded")
    return synthetic.write_sample(str(d), seed=0, length=LENGTH, n_reads=200, n_snv=2,
                                  n_indel=1, min_gap=150)


@pytest.fixture(scope="module")
def wide_sample(tmp_path_factory):
    # 500 reads on 3,000 bases (25x), 6 SNVs and 2 indels: more active regions
    d = tmp_path_factory.mktemp("torch_gvcf_sharded_wide")
    return synthetic.write_sample(str(d), seed=3, length=3000, n_reads=500, n_snv=6,
                                  n_indel=2, min_gap=200)


def _reads(bam, sample, start, end):
    return sorted(bam.BamReader(sample["bam"]).query(sample["contig"], max(0, start - 1000),
                                                     end + 1000),
                  key=lambda r: (r.pos, r.name))


@pytest.fixture(scope="module")
def jax_records(sample):
    """gatk_tpu's call_interval_gvcf records of each of INTERVALS."""
    from gatk_tpu.calling import hc_engine as jax_hc
    from gatk_tpu.io import bam as jax_bam
    from gatk_tpu.io import fasta as jax_fasta
    from gatk_tpu.io import vcf as jax_vcf
    from gatk_tpu.utils import javarandom as jax_random

    out = {}
    for where, (start, end) in INTERVALS.items():
        engine = jax_hc.HaplotypeCallerEngine(jax_fasta.FastaReference(sample["fasta"]), "SYN1",
                                              jax_hc.HCArgs())
        jax_random.reset_random_generator()
        out[where] = [jax_vcf.variant_to_line(v) for v in jax_hc.call_interval_gvcf(
            engine, _reads(jax_bam, sample, start, end),
            jax_hc.Interval(sample["contig"], start, end))]
    return out


def _port_records(sample, start, end, host_threads, devices=(CPU,)):
    """The port's records of [start, end) through a ShardedCaller of
    `host_threads` pool threads, and the caller."""
    engine = port_hc.HaplotypeCallerEngine(port_fasta.FastaReference(sample["fasta"]), "SYN1",
                                           port_hc.HCArgs())
    caller = scheduler.ShardedCaller(engine, list(devices), host_threads=host_threads)
    port_random.reset_random_generator()
    records = port_hc.call_interval_gvcf(engine, _reads(port_bam, sample, start, end),
                                         port_hc.Interval(sample["contig"], start, end), caller)
    return [port_vcf.variant_to_line(v) for v in records], caller


@pytest.mark.parametrize("host_threads", [1, 2, 6])
@pytest.mark.parametrize("where", sorted(INTERVALS))
def test_pool_records_are_gatk_tpus(sample, jax_records, where, host_threads):
    start, end = INTERVALS[where]
    got, caller = _port_records(sample, start, end, host_threads)
    assert got == jax_records[where]
    assert any(ln.split("\t")[4] != "<NON_REF>" for ln in got)
    assert any("END=" in ln for ln in got)
    assert "batchers" not in vars(caller)  # -ERC GVCF builds no PoolBatcher


def test_finishes_keep_region_order_when_the_first_prepare_ends_last(wide_sample, monkeypatch):
    """Region 0's preparation waits until every other region's has ended; the
    pool threads prepare, the calling thread computes reference confidence
    before it finishes any region and finishes every region in region order,
    and the records are those of an undelayed run."""
    start, end = 0, wide_sample["length"]
    want, _ = _port_records(wide_sample, start, end, host_threads=2)

    engine = port_hc.HaplotypeCallerEngine(port_fasta.FastaReference(wide_sample["fasta"]),
                                           "SYN1", port_hc.HCArgs())
    interval = port_hc.Interval(wide_sample["contig"], start, end)
    reads = _reads(port_bam, wide_sample, start, end)
    port_random.reset_random_generator()
    _, spans = engine.plan_interval(reads, interval)
    assert len(spans) >= 4, spans

    cls = port_hc.HaplotypeCallerEngine
    prepare, finish = cls.prepare_gvcf_region, cls.finish_gvcf_region
    lock = threading.Lock()
    ended = []  # spans whose preparation ended, in the order they ended
    others_ended = threading.Event()
    prepared_on, finished = set(), []

    def late_prepare(self, reads, span, read_bounds):
        if span == spans[0]:
            assert others_ended.wait(timeout=120), "the other regions' preparations hung"
        prep = prepare(self, reads, span, read_bounds)
        with lock:
            ended.append(span)
            prepared_on.add(threading.get_ident())
            if len(ended) == len(spans) - 1 and spans[0] not in ended:
                others_ended.set()
        return prep

    def recorded_finish(self, prep, handle):
        finished.append((prep.span, threading.get_ident()))
        return finish(self, prep, handle)

    gls = refconf.ref_vs_any_gls

    def recorded_gls(*args, **kwargs):
        finished.append(("refconf", threading.get_ident()))
        return gls(*args, **kwargs)

    monkeypatch.setattr(cls, "prepare_gvcf_region", late_prepare)
    monkeypatch.setattr(cls, "finish_gvcf_region", recorded_finish)
    monkeypatch.setattr(refconf, "ref_vs_any_gls", recorded_gls)
    got, _ = _port_records(wide_sample, start, end, host_threads=2)

    assert got == want
    assert ended[-1] == spans[0] and sorted(ended) == sorted(spans)
    main = threading.get_ident()
    assert main not in prepared_on
    assert finished[0][0] == "refconf"
    order = [span for span, _ in finished[1:]]
    assert len(order) >= 2 and order == sorted(order, key=spans.index)
    assert {tid for _, tid in finished} == {main}


@pytest.mark.cuda
def test_one_matrix_launch_a_region_on_the_card(wide_sample, monkeypatch):
    """On the card each region that assembles is one pairhmm_matrix launch of
    its reads x haplotypes, and the pooled pair kernel is never launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the matrix kernel has no CPU mode")
    cls = port_hc.HaplotypeCallerEngine
    finish = cls.finish_gvcf_region
    regions = []

    def counted(self, prep, handle):
        regions.append(len(prep.prepped) * len(prep.region.haplotypes))
        return finish(self, prep, handle)

    monkeypatch.setattr(cls, "finish_gvcf_region", counted)
    before = (pairhmm.pairhmm_matrix.launches, pairhmm.pairhmm_matrix.pairs,
              pairhmm.pairhmm_pairs.launches)
    got, _ = _port_records(wide_sample, 0, wide_sample["length"], host_threads=6,
                           devices=(torch.device("cuda", 0),))
    torch.cuda.synchronize()
    after = (pairhmm.pairhmm_matrix.launches, pairhmm.pairhmm_matrix.pairs,
             pairhmm.pairhmm_pairs.launches)
    assert len(regions) >= 4
    assert after[0] - before[0] == len(regions)
    assert after[1] - before[1] == sum(regions)
    assert after[2] == before[2]
    assert any(ln.split("\t")[4] != "<NON_REF>" for ln in got)
