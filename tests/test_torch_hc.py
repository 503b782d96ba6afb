"""HaplotypeCaller through the port (gatk_tpu_torch) against gatk_tpu, on the CPU.

Both packages see the same reads: the synthetic contig of
__graft_entry__._dryrun_sharded_calling through both ShardedCallers, and a small
synthetic BAM + FASTA (written here with the port's own BamWriter) through both
CLIs, with the port given --device cpu. gatk_tpu runs its compiled lax.scan
PairHMM, the port its plain PyTorch PairHMM; the outputs must be identical.
"""
import os

import numpy as np
import pytest
import torch

from gatk_tpu.calling import hc_engine as jax_hc
from gatk_tpu.cli import TOOL_REGISTRY as JAX_TOOLS
from gatk_tpu.io import reads as jax_reads
from gatk_tpu.io import vcf as jax_vcf
from gatk_tpu.parallel import scheduler as jax_scheduler
from gatk_tpu_torch import cli as port_cli
from gatk_tpu_torch.calling import hc_engine as port_hc
from gatk_tpu_torch.io import reads as port_reads
from gatk_tpu_torch.io import vcf as port_vcf
from gatk_tpu_torch.parallel import scheduler as port_scheduler
from gatk_tpu_torch.utils import synthetic
from gatk_tpu_torch.utils.errors import UserError
from tests.test_torch_pairhmm import one_torch_thread  # noqa: F401


def _dryrun_reads(read_cls):
    """The contig and reads of __graft_entry__._dryrun_sharded_calling (600 bp,
    het SNPs at 200 and 400), built with the given package's Read class."""
    rng = np.random.default_rng(7)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    L = 600
    ref_arr = bases[rng.integers(0, 4, L)]
    alt = ref_arr.copy()
    alt[200] = bases[(np.searchsorted(bases, alt[200]) + 1) % 4]
    alt[400] = bases[(np.searchsorted(bases, alt[400]) + 1) % 4]
    reads = []
    rl = 100
    for k in range(120):
        pos = int(rng.integers(0, L - rl))
        src = alt if k % 2 else ref_arr
        reads.append(read_cls(
            name=f"r{k}", flag=0 if k % 4 < 2 else 16, ref_id=0, pos=pos, mapq=60,
            cigar_ops=np.array([0], np.uint8), cigar_lens=np.array([rl], np.int32),
            bases=src[pos : pos + rl].copy(), quals=np.full(rl, 30, np.uint8),
            mate_ref_id=-1, mate_pos=-1, tlen=0, tags={}))
    reads.sort(key=lambda r: r.pos)

    class _Ref:
        def contig_length(self, c):
            return L

        def fetch(self, c, s, e):
            return ref_arr[s:e]

    return _Ref(), reads


def test_sharded_caller_matches_jax():
    import jax

    ref, reads = _dryrun_reads(jax_reads.Read)
    jcaller = jax_scheduler.ShardedCaller(jax_hc.HaplotypeCallerEngine(ref, "S", jax_hc.HCArgs()),
                                          jax.local_devices()[:1])
    want = jcaller.call_targets(lambda iv: reads, [jax_hc.Interval("syn", 0, 600)],
                                contig_order=["syn"])
    ref, reads = _dryrun_reads(port_reads.Read)
    pcaller = port_scheduler.ShardedCaller(
        port_hc.HaplotypeCallerEngine(ref, "S", port_hc.HCArgs()), [torch.device("cpu")])
    got = pcaller.call_targets(lambda iv: reads, [port_hc.Interval("syn", 0, 600)],
                               contig_order=["syn"])
    assert {200, 400} <= {v.pos for v in got}
    assert [port_vcf.variant_to_line(v) for v in got] == [jax_vcf.variant_to_line(v) for v in want]


@pytest.fixture(scope="module")
def sample(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_hc")
    return synthetic.write_sample(str(d), seed=3, length=2800, n_reads=1150, n_snv=3,
                                  n_indel=2)


def _run_both(sample, out_dir, extra):
    jax_out = os.path.join(out_dir, "jax.vcf")
    port_out = os.path.join(out_dir, "port.vcf")
    common = ["-I", sample["bam"], "-R", sample["fasta"]] + extra
    assert JAX_TOOLS["HaplotypeCaller"](common + ["-O", jax_out]) == 0
    assert port_cli.main(["HaplotypeCaller", *common, "-O", port_out, "--device", "cpu"]) == 0
    with open(jax_out, "rb") as a, open(port_out, "rb") as b:
        return a.read(), b.read()


def test_cli_vcf_identical_to_jax(sample, tmp_path):
    want, got = _run_both(sample, str(tmp_path), [])
    assert got == want
    records = [ln.split("\t") for ln in got.decode().splitlines() if not ln.startswith("#")]
    called = {(int(f[1]) - 1, f[3], f[4]) for f in records}
    for v in sample["variants"]:
        if v.is_snv:
            assert (v.pos, v.ref, v.alt) in called, v
        else:  # an indel in a repeat is reported left-aligned
            shift = len(v.ref) - len(v.alt)
            assert any(abs(p - v.pos) <= 20 and len(r) - len(a) == shift
                       for p, r, a in called), v


def test_cli_gvcf_identical_to_jax(sample, tmp_path):
    v = sample["variants"][0]
    interval = f"{sample['contig']}:{v.pos - 60}-{v.pos + 60}"
    want, got = _run_both(sample, str(tmp_path), ["-ERC", "GVCF", "-L", interval])
    assert got == want
    body = [ln for ln in got.decode().splitlines() if not ln.startswith("#")]
    assert any("<NON_REF>" in ln and ln.split("\t")[4] != "<NON_REF>" for ln in body)
    assert any("END=" in ln for ln in body)


@pytest.mark.parametrize("flags", [
    ["--distributed-coordinator", "localhost:1234", "--distributed-num-processes", "2"],
])
def test_unported_options_raise_user_error(sample, tmp_path, flags):
    argv = ["-I", sample["bam"], "-R", sample["fasta"], "-O", str(tmp_path / "x.vcf"),
            "--device", "cpu", *flags]
    with pytest.raises(UserError, match="ROADMAP"):
        port_cli.TOOL_REGISTRY["HaplotypeCaller"](argv)
    assert port_cli.main(["HaplotypeCaller", *argv]) == 2
    assert not (tmp_path / "x.vcf").exists()
