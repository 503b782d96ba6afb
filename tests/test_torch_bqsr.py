"""MarkDuplicates, BQSR and the Picard-style metrics tools through the port
(gatk_tpu_torch) against gatk_tpu, on the CPU.

A synthetic sample with planted duplicates (utils/synthetic.write_sample:
3,000 bp, 2,000 reads of 151 bp and 40 duplicates, 6 het SNVs and 2 het
indels, sequencing errors at 0.005) goes through MarkDuplicates
(--metrics-file), BaseRecalibrator (--known-sites: the planted variants),
ApplyBQSR, GatherBQSRReports of two tables and GatherTranches of two tranche
files in both packages. All of it is host code: gatk_tpu runs BQSR without
jax. Tolerance: none; every output is byte-identical.

Then the reference-free cases of tests/test_bqsr.py that cover the new
modules (:161, :217), re-pointed at the port, and every metrics tool that runs
on an unpaired BAM. CollectHsMetrics and CollectTargetedPcrMetrics need bait
and target interval lists, CrosscheckFingerprints a haplotype map, and
GatherBamFiles scattered BAMs: they are not run here.
"""
import contextlib
import io
import math
import os

import pytest

from gatk_tpu.cli import TOOL_REGISTRY as JAX_TOOLS
from gatk_tpu_torch import cli as port_cli
from gatk_tpu_torch.io import bam as bamio
from gatk_tpu_torch.recal.report import parse_report
from gatk_tpu_torch.utils import synthetic
from tests.test_torch_pairhmm import one_torch_thread  # noqa: F401

PLANTED_ERROR_RATE = 0.005  # write_sample's err_rate


def _run(pkg, argv):
    with contextlib.redirect_stdout(io.StringIO()):
        if pkg == "jax":
            return JAX_TOOLS[argv[0]](argv[1:])
        return port_cli.main(argv)


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


@pytest.fixture(scope="module")
def sample(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_bqsr"))
    return synthetic.write_sample(d, seed=5, length=3000, n_reads=2000, n_snv=6, n_indel=2,
                                  min_gap=300, n_duplicates=40)


def _tranches(path, scale):
    from gatk_tpu_torch.vqsr.tranches import Tranche, write_tranches

    write_tranches(path, [Tranche(t, int(100 * t * scale), int(10 * t * scale), 2.1, 2.0,
                                  -1.5 * t, f"VQSRTranche{t}", "SNP", 50 * scale,
                                  int(45 * scale * t)) for t in (90.0, 99.0, 99.9)], "SNP")
    return path


@pytest.fixture(scope="module")
def outputs(sample, tmp_path_factory):
    """Each package's outputs: {pkg: {name: path}}."""
    d = str(tmp_path_factory.mktemp("torch_bqsr_runs"))
    ref = ["-R", sample["fasta"]]
    known = ["--known-sites", sample["known_sites"]]
    tranches = [_tranches(os.path.join(d, f"t{k}.tranches"), k) for k in (1, 2)]
    out = {}
    for pkg in ("jax", "port"):
        o = {n: os.path.join(d, f"{pkg}.{n}") for n in (
            "md.bam", "md.metrics", "recal.table", "bqsr.bam", "half.table", "gathered.table",
            "gathered.tranches")}
        steps = [
            ["MarkDuplicates", "-I", sample["bam"], "-O", o["md.bam"], "-M", o["md.metrics"]],
            ["BaseRecalibrator", "-I", o["md.bam"], *ref, *known, "-O", o["recal.table"]],
            ["ApplyBQSR", "-I", o["md.bam"], *ref, "--bqsr-recal-file", o["recal.table"],
             "-O", o["bqsr.bam"]],
            ["BaseRecalibrator", "-I", o["md.bam"], *ref, *known, "-L", "chrM:1-1500",
             "-O", o["half.table"]],
            ["GatherBQSRReports", "-I", o["recal.table"], "-I", o["half.table"],
             "-O", o["gathered.table"]],
            ["GatherTranches", "-I", tranches[0], "-I", tranches[1],
             "-O", o["gathered.tranches"]],
        ]
        for argv in steps:
            assert _run(pkg, argv) == 0, argv
        out[pkg] = o
    return out


@pytest.mark.parametrize("name", ["md.bam", "md.metrics", "recal.table", "bqsr.bam",
                                  "half.table", "gathered.table", "gathered.tranches"])
def test_output_identical_to_jax(outputs, name):
    assert _read(outputs["port"][name]) == _read(outputs["jax"][name])


def test_planted_duplicates_are_flagged(sample, outputs):
    """Every planted duplicate is flagged, and the flagged reads are all but
    one of each group of reads with one strand and one unclipped 5' end."""
    groups = {}
    for r in bamio.BamReader(sample["bam"]):
        key = (r.is_reverse, r.unclipped_end() if r.is_reverse else r.unclipped_start())
        groups[key] = groups.get(key, 0) + 1
    flagged = {r.name for r in bamio.BamReader(outputs["port"]["md.bam"]) if r.is_duplicate}
    assert set(sample["duplicates"]) <= flagged and len(sample["duplicates"]) == 40
    assert len(flagged) == sum(n - 1 for n in groups.values())


def test_empirical_quality_is_the_planted_error_rate(outputs):
    """The read group's empirical mismatch quality is within 1 of the planted
    error rate's phred (23.0)."""
    tables = {t[0]: t for t in parse_report(open(outputs["port"]["recal.table"]).read())}
    cols = [c for c, _ in tables["RecalTable0"][2]]
    rows = [dict(zip(cols, r)) for r in tables["RecalTable0"][3]]
    (m,) = [r for r in rows if r["EventType"] == "M"]
    assert abs(float(m["EmpiricalQuality"]) + 10 * math.log10(PLANTED_ERROR_RATE)) <= 1.0


METRICS = {  # tool -> extra arguments (beside -I and -O)
    "QualityScoreDistribution": [],
    "MeanQualityByCycle": [],
    "CollectAlignmentSummaryMetrics": [],
    "CollectQualityYieldMetrics": [],
    "CollectBaseDistributionByCycle": [],
    "CollectGcBiasMetrics": ["-R", "{fasta}", "-S", "{out}.summary"],
    "CollectOxoGMetrics": ["-R", "{fasta}"],
    "CollectSequencingArtifactMetrics": ["-R", "{fasta}"],
    "CollectInsertSizeMetrics": ["-H", "{out}.pdf"],
    "EstimateLibraryComplexity": [],
    "CollectMultipleMetrics": [],
}


@pytest.mark.parametrize("tool", sorted(METRICS) + ["ScatterIntervalsByNs"])
def test_metrics_tool_identical_to_jax(sample, tmp_path, tool):
    outs = {}
    for pkg in ("jax", "port"):
        out = str(tmp_path / pkg / "metrics")
        os.makedirs(os.path.dirname(out))
        if tool == "ScatterIntervalsByNs":
            argv = [tool, "-R", sample["fasta"], "-O", out]
        else:
            argv = [tool, "-I", sample["bam"], "-O", out] + [
                a.format(fasta=sample["fasta"], out=out) for a in METRICS[tool]]
        assert _run(pkg, argv) == 0
        outs[pkg] = sorted(os.listdir(os.path.dirname(out)))
    assert outs["port"] == outs["jax"] and outs["port"]
    for name in outs["port"]:
        assert _read(tmp_path / "port" / name) == _read(tmp_path / "jax" / name), name


# ---- tests/test_bqsr.py's reference-free cases of the new modules, on the port


def test_optical_duplicates_and_metrics():
    """tests/test_bqsr.py:161 on the port's markdup."""
    import numpy as np

    from gatk_tpu_torch.io import sam as samio
    from gatk_tpu_torch.io.reads import Read
    from gatk_tpu_torch.preprocessing import markdup

    def mk_pair(name, pos1, pos2, q=30):
        ops, lens = np.array([0], np.uint8), np.array([10], np.int32)
        bases, quals = np.frombuffer(b"ACGTACGTAC", np.uint8), np.full(10, q, np.uint8)
        r1 = Read(name=name, flag=0x1 | 0x40 | 0x20, ref_id=0, pos=pos1, mapq=60,
                  cigar_ops=ops.copy(), cigar_lens=lens.copy(), bases=bases,
                  quals=quals.copy(), mate_ref_id=0, mate_pos=pos2, tlen=pos2 - pos1 + 10,
                  tags={"RG": "rg1"})
        r2 = Read(name=name, flag=0x1 | 0x80 | 0x10, ref_id=0, pos=pos2, mapq=60,
                  cigar_ops=ops.copy(), cigar_lens=lens.copy(), bases=bases,
                  quals=quals.copy(), mate_ref_id=0, mate_pos=pos1, tlen=-(pos2 - pos1 + 10),
                  tags={"RG": "rg1"})
        return [r1, r2]

    header = samio.SamHeader.parse("@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:chr1\tLN:10000\n"
                                   "@RG\tID:rg1\tSM:S\tLB:lib1\n")
    reads = []
    reads += mk_pair("M:1:FC:1:5:1000:1000", 100, 300, q=40)
    reads += mk_pair("M:1:FC:1:5:1050:1050", 100, 300, q=30)
    reads += mk_pair("M:1:FC:1:5:5000:5000", 100, 300, q=30)
    reads += mk_pair("M:1:FC:1:7:1000:1000", 100, 300, q=30)
    reads += mk_pair("M:1:FC:1:9:2000:2000", 2000, 2400, q=30)
    n_dup, non_dup = markdup.mark_duplicates(reads, header)
    assert n_dup == 6
    assert "M:1:FC:1:5:1000:1000" in non_dup
    m = markdup.collect_duplication_metrics(reads, header)["lib1"]
    assert m["READ_PAIRS_EXAMINED"] == 5
    assert m["READ_PAIR_DUPLICATES"] == 3
    assert m["READ_PAIR_OPTICAL_DUPLICATES"] == 1
    assert abs(m["PERCENT_DUPLICATION"] - 0.6) < 1e-9
    assert m["ESTIMATED_LIBRARY_SIZE"] == markdup.estimate_library_size(4, 2)
    assert m["ESTIMATED_LIBRARY_SIZE"] is not None


def test_estimate_library_size_formula():
    """tests/test_bqsr.py:217 on the port's markdup."""
    from gatk_tpu_torch.preprocessing import markdup

    assert markdup.estimate_library_size(100, 100) is None
    x = markdup.estimate_library_size(1000, 900)
    assert abs(900 / x - 1 + math.exp(-1000 / x)) < 1e-2
    assert markdup.estimate_library_size(1000, 500) < x
