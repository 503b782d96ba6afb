"""The port's host tracer (gatk_tpu_torch/utils/trace.py): stages that never
nest on one thread, spans and their self time, profiler ranges only while a
profiler records (with the shard's interval as the range's keyword input),
and the stages and spans that HaplotypeCaller (VCF and -ERC GVCF) and
Mutect2 calls leave in STAGES, on small synthetic samples on the CPU."""
import os
import sys
import threading

import pytest
import torch
from torch._C._profiler import _ExperimentalConfig
from torch.profiler import ProfilerActivity, profile

from gatk_tpu_torch import cli
from gatk_tpu_torch.assembly import assembler
from gatk_tpu_torch.mutect import engine as _m2_engine  # noqa: F401  (its spans, unwrapped below)
from gatk_tpu_torch.utils import synthetic, trace
from gatk_tpu_torch.utils.stopwatch import STAGES

# the names a call records; a span's self time is <name>.self
VCF_NAMES = {"hc.setup", "bam_read", "read_filter", "activity_profile", "prep_wait",
             "finalize_reads", "assembly", "read_prep", "pack_dispatch", "flush",
             "device_wait", "genotype"}
GVCF_NAMES = {"hc.setup", "bam_read", "hc.gvcf_interval", "read_filter", "activity_profile",
              "prep_wait", "finalize_reads", "assembly", "read_prep", "matrix_pack",
              "matrix_launch", "device_wait", "genotype", "refconf"}
M2_NAMES = {"m2.call_interval", "downsample", "m2_activity", "m2.prepare_region",
            "finalize_reads", "assembly", "read_prep", "pack_dispatch", "flush",
            "m2.finish_region", "device_wait", "somatic_genotype", "callable_sites"}
SPANS = {"hc.setup", "hc.gvcf_interval", "m2.call_interval", "m2.prepare_region",
         "m2.finish_region"}
# the stages HaplotypeCaller's VCF path recorded before the tracer's decorators
VCF_EXISTING = {"bam_read", "read_filter", "activity_profile", "finalize_reads", "assembly",
                "read_prep", "pack_dispatch", "device_wait", "genotype"}


def _recorded(names):
    return names | {n + trace.SELF for n in names & SPANS}


@pytest.fixture(autouse=True)
def _fresh_totals():
    STAGES.reset()
    yield
    STAGES.reset()


class _Clock:
    """A perf_counter that advances one second a read."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


def test_a_stage_inside_a_stage_records_only_the_outer():
    with trace.stage("outer"):
        with trace.stage("inner"):
            with trace.span("under_a_stage"):
                pass
    assert dict(STAGES.counts) == {"outer": 1}
    assert not trace._thread.in_stage and trace._thread.children == []


def test_a_decorated_function_inside_its_own_stage_counts_once():
    @trace.stage("work")
    def work():
        return 7

    with trace.stage("work"):
        assert work() == 7
    assert work() == 7
    assert dict(STAGES.counts) == {"work": 2}
    assert work.__wrapped__() == 7 and work.__traced__ == ("stage", "work")


def test_self_time_is_the_duration_less_its_children(monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(trace.time, "perf_counter", clock)
    with trace.span("call"):  # reads 1 ... 10
        with trace.stage("a"):  # 2, 3: 1 s
            pass
        with trace.span("region"):  # 4 ... 7: 3 s, of it the stage 1 s
            with trace.stage("b"):  # 5, 6
                with trace.stage("nested"):
                    pass
        with trace.stage("c"):  # 8, 9: 1 s
            pass
    assert dict(STAGES.seconds) == {"a": 1.0, "b": 1.0, "c": 1.0, "region": 3.0,
                                    "region.self": 2.0, "call": 9.0, "call.self": 4.0}
    assert dict(STAGES.counts) == dict.fromkeys(STAGES.seconds, 1)


def test_a_span_does_not_subtract_other_threads_work(monkeypatch):
    ran = threading.Event()

    def other():
        with trace.stage("other"):
            ran.set()

    with trace.span("call"):
        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=30)
    assert not t.is_alive() and ran.is_set()
    assert STAGES.seconds["call.self"] == STAGES.seconds["call"]


def test_an_exception_closes_the_stage_and_span():
    with pytest.raises(ValueError):
        with trace.span("call"):
            with trace.stage("work"):
                raise ValueError("fails")
    assert dict(STAGES.counts) == {"call": 1, "call.self": 1, "work": 1}
    assert not trace._thread.in_stage and trace._thread.children == []


def test_a_generator_function_cannot_be_decorated():
    def reads():
        yield 1

    with pytest.raises(TypeError, match="generator function"):
        trace.span("reads")(reads)


def test_threads_lose_no_update():
    """More threads than cores, each nesting spans and stages, with a short
    switch interval: every count arrives and each thread's marks are its own."""
    n_threads, rounds = 3 * (os.cpu_count() or 2), 200
    errors = []

    def worker():
        try:
            for _ in range(rounds):
                with trace.span("call"):
                    with trace.stage("work"):
                        with trace.stage("nested"):
                            pass
                    with trace.span("region"):
                        pass
            assert not trace._thread.in_stage and trace._thread.children == []
        except AssertionError as e:  # pragma: no cover - reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and errors == []
    total = n_threads * rounds
    assert dict(STAGES.counts) == {"call": total, "call.self": total, "work": total,
                                   "region": total, "region.self": total}


# --------------------------------------------------------------------------- calls


@pytest.fixture(scope="module")
def samples(tmp_path_factory):
    d = tmp_path_factory.mktemp("trace")
    germline = synthetic.write_sample(str(d / "hc"), seed=1, length=1500, n_reads=300, n_snv=2,
                                      n_indel=0, min_gap=300)
    tumor = synthetic.write_tumor_sample(str(d / "m2"), seed=1, length=1500, n_reads=800,
                                         n_germline=1, n_somatic_snv=2, n_somatic_indel=0,
                                         min_gap=300)
    return d, germline, tumor


def _hc(samples, *extra):
    d = samples[0]
    return ["HaplotypeCaller", "-I", str(d / "hc" / "sample.bam"), "-R", str(d / "hc" / "ref.fa"),
            "-O", str(d / "hc.vcf"), "-L", "chrM:1-1500", "--device", "cpu", *extra]


def _m2(samples):
    d = samples[0]
    return ["Mutect2", "-I", str(d / "m2" / "tumor.bam"), "-R", str(d / "m2" / "ref.fa"),
            "-O", str(d / "m2.vcf"), "--device", "cpu"]


class _Spy:
    """Stands in for a profiler range's constructor or entry: counts calls."""

    def __init__(self):
        self.calls = 0

    def __call__(self, *args, **kwargs):
        self.calls += 1
        raise AssertionError("a profiler range was entered with no profiler running")


def _spy_on_ranges(monkeypatch):
    spies = [_Spy(), _Spy()]
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", spies[0])
    monkeypatch.setattr(torch.autograd.profiler.record_function, "__enter__", spies[1])
    return spies


def _unwrap_tracer(monkeypatch):
    """Put every function the tracer decorates back to its undecorated self,
    wherever a loaded module of the port or one of its classes holds it."""
    undone = set()
    for name, mod in list(sys.modules.items()):
        if not name.startswith("gatk_tpu_torch") or mod is None:
            continue
        holders = [mod] + [c for c in vars(mod).values()
                           if isinstance(c, type) and c.__module__ == name]
        for holder in holders:
            for attr, obj in list(vars(holder).items()):
                if hasattr(obj, "__traced__"):
                    monkeypatch.setattr(holder, attr, obj.__wrapped__)
                    undone.add(obj.__traced__)
    return undone


def test_vcf_call_keeps_the_counts_it_had_without_the_decorators(samples, monkeypatch):
    """The VCF path's stages (hc_engine's and hc_tool's own `with` blocks) keep
    their counts: the decorated functions inside them record nothing. No
    profiler range is entered with no profiler running."""
    spies = _spy_on_ranges(monkeypatch)
    assert cli.main(_hc(samples)) == 0
    assert set(STAGES.counts) == _recorded(VCF_NAMES)
    decorated = {k: STAGES.counts[k] for k in VCF_EXISTING}
    assert [s.calls for s in spies] == [0, 0]
    STAGES.reset()
    undone = _unwrap_tracer(monkeypatch)
    assert {("stage", "assembly"), ("stage", "finalize_reads"), ("stage", "genotype"),
            ("stage", "read_prep"), ("stage", "pack_dispatch"), ("stage", "device_wait"),
            ("span", "hc.gvcf_interval"), ("span", "m2.prepare_region")} <= undone
    assert cli.main(_hc(samples)) == 0
    assert {k: STAGES.counts[k] for k in VCF_EXISTING} == decorated
    assert decorated["assembly"] >= 2 and decorated["bam_read"] == 1


def test_gvcf_call_leaves_its_stages(samples, monkeypatch):
    spies = _spy_on_ranges(monkeypatch)
    calls = []
    assemble = assembler.assemble

    def counted(*args, **kwargs):
        calls.append(1)
        return assemble(*args, **kwargs)

    monkeypatch.setattr(assembler, "assemble", counted)
    assert cli.main(_hc(samples, "-ERC", "GVCF")) == 0
    assert set(STAGES.counts) == _recorded(GVCF_NAMES)
    assert STAGES.counts["assembly"] == len(calls) >= 2
    assert STAGES.counts["hc.gvcf_interval"] == STAGES.counts["refconf"] == 1
    assert [s.calls for s in spies] == [0, 0]


def test_mutect2_call_leaves_its_stages_and_spans(samples, monkeypatch):
    spies = _spy_on_ranges(monkeypatch)
    calls = []
    assemble = assembler.assemble

    def counted(*args, **kwargs):
        calls.append(1)
        return assemble(*args, **kwargs)

    monkeypatch.setattr(assembler, "assemble", counted)
    assert cli.main(_m2(samples)) == 0
    assert set(STAGES.counts) == _recorded(M2_NAMES)
    assert STAGES.counts["assembly"] == len(calls) == STAGES.counts["m2.prepare_region"] >= 2
    s = STAGES.seconds
    assert 0 <= s["m2.call_interval.self"] < s["m2.call_interval"]
    assert s["m2.prepare_region"] >= s["assembly"]
    assert [sp.calls for sp in spies] == [0, 0]


def _ranges(prof):
    """{stage:/span: range name: [its interval keyword input, per range]}."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(("stage:", "span:")):
            out.setdefault(e.name(), []).append(e.kwinputs().get("interval"))
    return out


def test_profiler_ranges_of_every_thread(samples):
    """Under torch.profiler over every thread each stage and span that records
    is a stage:/span: range among the profiler's events, the pool threads'
    too, and no other is."""
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
        assert cli.main(_hc(samples)) == 0
    ranges = _ranges(prof)
    names = {n.split(":", 1)[1] for n in ranges}
    assert names == VCF_NAMES
    assert "span:hc.setup" in ranges and "stage:prep_wait" in ranges
    assert sum(map(len, ranges.values())) == sum(STAGES.counts[n] for n in names)


def test_profiler_ranges_carry_the_interval(samples):
    """A profiler that records shapes keeps the interval that port code which
    knows the shard gives its ranges (the target loop's BAM read, the
    scheduler's queue wait). torch's all-threads mode drops keyword inputs,
    so this profiler records the calling thread only."""
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        assert cli.main(_hc(samples)) == 0
    ranges = _ranges(prof)
    assert ranges["stage:bam_read"] == ["chrM:1-1500"]
    assert ranges["stage:prep_wait"] == ["chrM:1-1500"]
    assert set(ranges["span:hc.setup"]) == {None}
