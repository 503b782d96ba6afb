"""Mutect2 through the port (gatk_tpu_torch) against gatk_tpu, on the CPU.

Both CLIs read the same small synthetic tumor sample (written here with the
port's utils/synthetic.write_tumor_sample), the port given --device cpu.
gatk_tpu runs its compiled lax.scan PairHMM, the port its plain PyTorch
PairHMM; the unfiltered VCF, its .stats file and FilterMutectCalls' outputs
must be identical.
"""
import os

import pytest

from gatk_tpu.cli import TOOL_REGISTRY as JAX_TOOLS
from gatk_tpu_torch import cli as port_cli
from gatk_tpu_torch.utils import synthetic
from tests.test_torch_pairhmm import one_torch_thread  # noqa: F401

MUTECT_TOOLS = ("Mutect2", "FilterMutectCalls", "GetPileupSummaries", "CalculateContamination",
                "CollectF1R2Counts", "LearnReadOrientationModel", "MergeMutectStats",
                "CreateSomaticPanelOfNormals", "NuMTFilterTool", "MTLowHeteroplasmyFilterTool",
                "GetNormalArtifactData", "GatherNormalArtifactData")


@pytest.fixture(scope="module")
def tumor(tmp_path_factory):
    """3 kb, 2,000 reads of 151 bp (~100x), seed 0: 2 germline het SNVs, 2
    somatic SNVs and 1 somatic indel at allele fractions 0.1-0.3."""
    d = tmp_path_factory.mktemp("torch_mutect")
    return synthetic.write_tumor_sample(str(d), seed=0, length=3000, n_reads=2000, n_germline=2,
                                        n_somatic_snv=2, n_somatic_indel=1)


@pytest.fixture(scope="module")
def calls(tumor, tmp_path_factory):
    """Mutect2 then FilterMutectCalls through both CLIs: {name: bytes} per package."""
    d = str(tmp_path_factory.mktemp("torch_mutect_out"))
    common = ["-I", tumor["bam"], "-R", tumor["fasta"]]
    out = {}
    for pkg in ("jax", "port"):
        vcf = os.path.join(d, f"{pkg}.vcf")
        filtered = os.path.join(d, f"{pkg}.filtered.vcf")
        if pkg == "jax":
            assert JAX_TOOLS["Mutect2"](common + ["-O", vcf]) == 0
            assert JAX_TOOLS["FilterMutectCalls"](["-V", vcf, "-O", filtered]) == 0
        else:
            assert port_cli.main(["Mutect2", *common, "-O", vcf, "--device", "cpu"]) == 0
            assert port_cli.main(["FilterMutectCalls", "-V", vcf, "-O", filtered]) == 0
        out[pkg] = {}
        for name in (vcf, vcf + ".stats", filtered, filtered + ".filteringStats.tsv"):
            with open(name, "rb") as fh:
                out[pkg][os.path.basename(name)[len(pkg):]] = fh.read()
    return out


@pytest.mark.parametrize("output", [".vcf", ".vcf.stats", ".filtered.vcf",
                                    ".filtered.vcf.filteringStats.tsv"])
def test_output_identical_to_jax(calls, output):
    assert calls["port"][output] == calls["jax"][output]


def _records(text):
    return [ln.split("\t") for ln in text.decode().splitlines() if not ln.startswith("#")]


def test_planted_variants_are_called(tumor, calls):
    """Every planted variant is in the unfiltered VCF, the somatic ones at about
    their allele fraction, and all of them pass FilterMutectCalls."""
    records = {(int(f[1]) - 1, f[3], f[4]): f for f in _records(calls["port"][".vcf"])}
    for v in tumor["somatic"] + tumor["germline"]:
        assert (v.pos, v.ref, v.alt) in records, v
        af = float(records[(v.pos, v.ref, v.alt)][9].split(":")[2])
        assert abs(af - v.af) < 0.15, (v, af)
    passing = {(int(f[1]) - 1, f[3], f[4]) for f in _records(calls["port"][".filtered.vcf"])
               if f[6] == "PASS"}
    assert {(v.pos, v.ref, v.alt) for v in tumor["somatic"]} <= passing
    assert calls["port"][".vcf.stats"].startswith(b"statistic\tvalue\ncallable\t")


def test_somatic_reads_follow_allele_fraction(tumor):
    """The writer's contract: somatic variants at af in 0.1-0.3, germline at 0.5,
    all at least min_gap apart, one read group SM:TUMOR."""
    from gatk_tpu_torch.io import bam

    somatic, germline = tumor["somatic"], tumor["germline"]
    assert len(somatic) == 3 and len(germline) == 2
    assert sum(not v.is_snv for v in somatic) == 1
    assert all(0.1 <= v.af <= 0.3 for v in somatic) and all(v.af == 0.5 for v in germline)
    pos = sorted(v.pos for v in somatic + germline)
    assert min(b - a for a, b in zip(pos, pos[1:])) >= 400
    reader = bam.BamReader(tumor["bam"])
    assert [rg["SM"] for rg in reader.header.read_groups] == ["TUMOR"]


def test_every_mutect_tool_is_registered():
    assert set(MUTECT_TOOLS) <= set(port_cli.TOOL_REGISTRY)
    assert set(MUTECT_TOOLS) <= set(JAX_TOOLS)


def test_matched_normal_changes_no_call(tumor, calls, tmp_path):
    """gatk_tpu's fault, carried as-is: Mutect2 opens only the first -I
    (gatk_tpu/tools/mutect_tool.py:53), calls each interval with no
    sample_of_read (:88), and Mutect2Engine._finish_region never reads it
    (gatk_tpu/mutect/engine.py:227). So -I tumor -I normal --normal-sample
    NORMAL gives the tumor-only run's records, in both packages, byte for byte
    alike. No --germline-resource: its default AF is what --normal-sample
    changes (mutect_tool.py:64-69)."""
    tn = synthetic.write_tumor_sample(str(tmp_path / "tn"), seed=0, length=3000, n_reads=2000,
                                      n_germline=2, n_somatic_snv=2, n_somatic_indel=1,
                                      n_normal_reads=2000)
    with open(tn["bam"], "rb") as a, open(tumor["bam"], "rb") as b:
        assert a.read() == b.read()  # the tumor does not change with a normal
    argv = ["-I", tn["bam"], "-I", tn["normal_bam"], "--normal-sample", "NORMAL",
            "-R", tn["fasta"]]
    out = {pkg: str(tmp_path / f"{pkg}.vcf") for pkg in ("jax", "port")}
    assert JAX_TOOLS["Mutect2"](argv + ["-O", out["jax"]]) == 0
    assert port_cli.main(["Mutect2", *argv, "-O", out["port"], "--device", "cpu"]) == 0
    with open(out["port"], "rb") as a, open(out["jax"], "rb") as b:
        got = a.read()
        assert got == b.read()
    assert _records(got) == _records(calls["port"][".vcf"])
