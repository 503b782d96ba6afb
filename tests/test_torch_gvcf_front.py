"""HaplotypeCaller -ERC GVCF through the engine's region front, on the CPU.

call_interval_gvcf plans an interval with HaplotypeCallerEngine.plan_interval
and assembles each active region with HaplotypeCallerEngine.assemble_region,
the phases the VCF path runs. These tests hold its records to gatk_tpu's
call_interval_gvcf, record for record, on intervals at both ends of the contig
and in its middle, where active regions straddle the interval's bounds; and pin
the one intended difference: the port's GVCF path honours --read-filter, as
its VCF path and GATK do, where gatk_tpu's ignores it.
"""
import contextlib
import io

import pytest
import torch

from gatk_tpu.calling import hc_engine as jax_hc
from gatk_tpu.cli import TOOL_REGISTRY as JAX_TOOLS
from gatk_tpu.io import bam as jax_bam
from gatk_tpu.io import fasta as jax_fasta
from gatk_tpu.io import vcf as jax_vcf
from gatk_tpu.utils import javarandom as jax_random
from gatk_tpu_torch import cli as port_cli
from gatk_tpu_torch import devices
from gatk_tpu_torch.calling import hc_engine as port_hc
from gatk_tpu_torch.io import bam as port_bam
from gatk_tpu_torch.io import fasta as port_fasta
from gatk_tpu_torch.io import vcf as port_vcf
from gatk_tpu_torch.utils import javarandom as port_random
from gatk_tpu_torch.utils import synthetic
from tests import torch_tool_cases
from tests.test_torch_pairhmm import one_torch_thread  # noqa: F401

LENGTH = 1200
# (start, end): from the contig's start, across its middle, to its end; each
# cuts an active region of the sample in two (regions 269-344, 438-513, 651-737)
INTERVALS = {"contig_start": (0, 480), "middle": (300, 700), "contig_end": (480, LENGTH)}


@pytest.fixture(scope="module")
def sample(tmp_path_factory):
    # 200 reads of 151 bases on 1,200 bases (25x), a SNV at 306 and 475, an
    # insertion at 693
    d = tmp_path_factory.mktemp("torch_gvcf_front")
    return synthetic.write_sample(str(d), seed=0, length=LENGTH, n_reads=200, n_snv=2,
                                  n_indel=1, min_gap=150)


def _records(pkg, sample, start, end):
    hc, bam, fasta, vcf, rand = ((jax_hc, jax_bam, jax_fasta, jax_vcf, jax_random)
                                 if pkg == "jax" else
                                 (port_hc, port_bam, port_fasta, port_vcf, port_random))
    contig = sample["contig"]
    reads = sorted(bam.BamReader(sample["bam"]).query(contig, max(0, start - 1000), end + 1000),
                   key=lambda r: (r.pos, r.name))
    engine = hc.HaplotypeCallerEngine(fasta.FastaReference(sample["fasta"]), "SYN1", hc.HCArgs())
    rand.reset_random_generator()
    return [vcf.variant_to_line(v)
            for v in hc.call_interval_gvcf(engine, reads, hc.Interval(contig, start, end))]


@pytest.mark.parametrize("where", sorted(INTERVALS))
def test_gvcf_records_are_gatk_tpus(sample, where, monkeypatch):
    monkeypatch.setattr(devices, "_DEFAULT_DEVICE", torch.device("cpu"))
    start, end = INTERVALS[where]
    got = _records("port", sample, start, end)
    assert got == _records("jax", sample, start, end)
    variants = [ln for ln in got if ln.split("\t")[4] != "<NON_REF>"]
    assert variants and any("END=" in ln for ln in got)


def _run(pkg, argv):
    with contextlib.redirect_stdout(io.StringIO()):
        if pkg == "jax":
            return JAX_TOOLS[argv[0]](argv[1:])
        return port_cli.main(argv + ["--device", "cpu"])


def _depths(path):
    """The DP of each reference block of a GVCF."""
    out = []
    with open(path) as fh:
        for ln in fh:
            f = ln.rstrip("\n").split("\t")
            if ln.startswith("#") or "END=" not in f[7]:
                continue
            out.append(int(dict(zip(f[8].split(":"), f[9].split(":")))["DP"]))
    return out


def test_gvcf_honours_read_filter_where_gatk_tpu_does_not(tmp_path):
    """--read-filter FirstOfPairReadFilter on a paired sample drops the second
    reads: the port's blocks lose depth, gatk_tpu's GVCF stays as it was."""
    inp = torch_tool_cases.write_inputs(tmp_path / "in")
    out = {}
    for pkg in ("jax", "port"):
        for name, extra in (("all", []), ("first", ["--read-filter", "FirstOfPairReadFilter"])):
            out[pkg, name] = str(tmp_path / f"{pkg}.{name}.g.vcf")
            assert _run(pkg, ["HaplotypeCaller", "-I", inp["paired"], "-R", inp["fasta"],
                              "-ERC", "GVCF", "-L", "chrM:1001-1400", "-O", out[pkg, name],
                              *extra]) == 0

    def read(key):
        with open(out[key], "rb") as fh:
            return fh.read()

    assert read(("port", "all")) == read(("jax", "all"))
    assert read(("jax", "first")) == read(("jax", "all"))
    all_dp, first_dp = _depths(out["port", "all"]), _depths(out["port", "first"])
    assert all_dp and first_dp
    assert max(first_dp) < max(all_dp)
    assert sum(first_dp) / len(first_dp) < 0.75 * sum(all_dp) / len(all_dp)
