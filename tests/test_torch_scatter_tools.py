"""The port's copies of gatk_tpu's scatter-gather and Spark-named tools
(tools/variant_tools.py, tools/basic_tools.py, tools/analysis_tools.py,
tools/spark_compat.py, io/cram_writer.py) against gatk_tpu's, on the CPU.

gatk_tpu's own tests of these modules that read no reference data
(tests/test_sam_fasta_tools.py's GatherVcfs/SortVcf and LiftoverVcf,
tests/test_analysis_tools.py's cases, tests/test_new_tools_r4.py's Spark
aliases) run here on both packages, whose outputs must be byte-identical; so
must each copied tool's on a synthetic sample, the WDL scatter-gather
(SplitIntervals -> a HaplotypeCaller run a shard -> GatherVcfs) must equal one
run, and ReadsPipeline --device cpu must be gatk_tpu's ReadsPipeline.
"""
import contextlib
import io
import os

import pytest
import torch

from gatk_tpu import cli as jax_cli
from gatk_tpu.io import vcf as jax_vcf
from gatk_tpu.tools import analysis_tools as jax_analysis
from gatk_tpu.tools import variant_tools as jax_variant_tools
from gatk_tpu_torch import cli as port_cli
from gatk_tpu_torch import devices
from gatk_tpu_torch.io import vcf as port_vcf
from gatk_tpu_torch.tools import analysis_tools as port_analysis
from gatk_tpu_torch.tools import variant_tools as port_variant_tools
from gatk_tpu_torch.utils import synthetic
from gatk_tpu_torch.utils.errors import UserError
from tests.test_torch_pairhmm import one_torch_thread  # noqa: F401

PACKAGES = {"jax": (jax_cli, jax_vcf, jax_analysis, jax_variant_tools),
            "port": (port_cli, port_vcf, port_analysis, port_variant_tools)}


def _run(pkg, tool, argv):
    """A tool of one package through its registry: (return code, stdout)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = PACKAGES[pkg][0].TOOL_REGISTRY[tool](list(argv))
    return rc, out.getvalue()


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def _write_vcf(vcfmod, path, records):
    w = vcfmod.VcfWriter(path, ["S"])
    for contig, pos, ref_a, alt in records:
        w.write(vcfmod.Variant(contig=contig, pos=pos, ref=ref_a, alts=(alt,),
                               fmt_keys=("GT",), samples=[{"GT": "0/1"}]))
    w.close()


# --------------------------------------------------------------------------- gatk_tpu's tests


def _gather_and_sort(pkg, d):
    """tests/test_sam_fasta_tools.py::test_gather_vcfs_and_sort_vcf on `pkg`."""
    cli, vcfmod = PACKAGES[pkg][:2]
    a, b = str(d / "a.vcf"), str(d / "b.vcf")
    _write_vcf(vcfmod, a, [("1", 100, "A", "C"), ("1", 200, "G", "T")])
    _write_vcf(vcfmod, b, [("1", 300, "A", "G")])
    out = str(d / "g.vcf")
    assert cli.TOOL_REGISTRY["GatherVcfs"](["-I", a, "-I", b, "-O", out]) == 0
    assert [v.pos for v in vcfmod.VcfReader(out)] == [100, 200, 300]
    with pytest.raises(UserError if pkg == "port" else jax_cli.UserError):
        cli.TOOL_REGISTRY["GatherVcfs"](["-I", b, "-I", a, "-O", str(d / "x.vcf")])
    out2 = str(d / "s.vcf")
    assert cli.TOOL_REGISTRY["SortVcf"](["-I", b, "-I", a, "-O", out2]) == 0
    assert [v.pos for v in vcfmod.VcfReader(out2)] == [100, 200, 300]
    return _read(out), _read(out2)


def _liftover(pkg, d):
    """tests/test_sam_fasta_tools.py::test_liftover_vcf on `pkg`."""
    cli, vcfmod = PACKAGES[pkg][:2]
    tgt_seq = "".join("ACGT"[i % 4] for i in range(100))
    tgt = str(d / "target.fasta")
    with open(tgt, "w") as fh:
        fh.write(">c1\n" + tgt_seq + "\n")
    with open(tgt + ".fai", "w") as fh:
        fh.write("c1\t100\t4\t100\t101\n")
    chain = str(d / "lift.chain")
    with open(chain, "w") as fh:
        fh.write("chain 100 src 50 + 0 50 c1 100 + 10 60 1\n50\n\n")
    src_vcf = str(d / "in.vcf")
    _write_vcf(vcfmod, src_vcf, [("src", 5, tgt_seq[15], "A" if tgt_seq[15] != "A" else "C"),
                                 ("src", 45, "A" if tgt_seq[55] != "A" else "C", "G"),
                                 ("other", 5, "A", "C")])
    out, rej = str(d / "lifted.vcf"), str(d / "rej.vcf")
    assert cli.TOOL_REGISTRY["LiftoverVcf"](
        ["-I", src_vcf, "-O", out, "-C", chain, "-R", tgt, "--reject", rej]) == 0
    lifted = list(vcfmod.VcfReader(out))
    assert len(lifted) == 1 and lifted[0].contig == "c1" and lifted[0].pos == 15
    rejects = list(vcfmod.VcfReader(rej))
    assert {r.filters[0] for r in rejects} == {"MismatchedRefAllele", "NoTarget"}
    return _read(out), _read(rej)


def _write_rows(path, rows, samples=()):
    with open(path, "w") as fh:
        fh.write("##fileformat=VCFv4.2\n")
        cols = "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO"
        if samples:
            cols += "\tFORMAT\t" + "\t".join(samples)
        fh.write(cols + "\n")
        for r in rows:
            fh.write(r + "\n")


def _concordance(pkg, d):
    """tests/test_analysis_tools.py::test_concordance_counts on `pkg`."""
    ev, tr, out = str(d / "eval.vcf"), str(d / "truth.vcf"), str(d / "summary.tsv")
    _write_rows(ev, ["1\t100\t.\tA\tC\t50\tPASS\t.", "1\t200\t.\tG\tT\t50\tPASS\t.",
                     "1\t300\t.\tT\tTA\t50\tPASS\t."])
    _write_rows(tr, ["1\t100\t.\tA\tC\t50\tPASS\t.", "1\t400\t.\tC\tG\t50\tPASS\t."])
    PACKAGES[pkg][2].concordance(["-eval", ev, "--truth", tr, "--summary", out])
    lines = open(out).read().splitlines()
    assert lines[1].split("\t")[:4] == ["SNP", "1", "1", "1"]
    assert lines[2].split("\t")[:4] == ["INDEL", "0", "1", "0"]
    return (_read(out),)


def _left_align(pkg, d):
    """tests/test_analysis_tools.py::test_left_align_variant on `pkg`."""
    vcfmod, analysis = PACKAGES[pkg][1], PACKAGES[pkg][2]
    ref_seq = "GGGCAAAAT"

    def fetch(contig, pos):
        return ref_seq[pos]

    got = []
    for pos, ref, alt, want in [(7, "A", "AA", (3, "C", ("CA",))),
                                (6, "AA", "A", (3, "CA", ("C",))),
                                (5, "A", "T", (5, "A", ("T",)))]:
        v = vcfmod.Variant(contig="1", pos=pos, ref=ref, alts=(alt,))
        analysis.left_align_variant(v, fetch)
        assert (v.pos, v.ref, v.alts) == want
        got.append(vcfmod.variant_to_line(v).encode())
    return tuple(got)


def _variants_to_table(pkg, d):
    """tests/test_analysis_tools.py::test_variants_to_table on `pkg`."""
    vin, out = str(d / "in.vcf"), str(d / "t.tsv")
    _write_rows(vin, ["1\t100\t.\tA\tC\t50\tPASS\tDP=10\tGT:AF\t0/1:0.42"], samples=("S",))
    PACKAGES[pkg][2].variants_to_table(["-V", vin, "-F", "CHROM", "-F", "POS", "-F", "DP",
                                        "-GF", "AF", "-O", out])
    lines = open(out).read().splitlines()
    assert lines == ["CHROM\tPOS\tDP\tS.AF", "1\t100\t10\t0.42"]
    return (_read(out),)


def _filter_expression(pkg, d):
    """tests/test_analysis_tools.py::test_filter_expression_eval on `pkg`."""
    vcfmod, tools = PACKAGES[pkg][1], PACKAGES[pkg][3]
    v = vcfmod.Variant(contig="1", pos=1, ref="A", alts=("C",), info={"QD": "1.5", "FS": "80"})
    got = tuple(tools._eval_filter_expression(e, v) for e in (
        "QD < 2.0", "QD > 2.0", "QD < 2.0 && FS > 60.0", "QD > 2.0 || FS > 60.0"))
    assert got == (True, False, True, True)
    return got


def _spark_aliases(pkg, d):
    """tests/test_new_tools_r4.py::test_spark_compat_aliases on `pkg`."""
    cli = PACKAGES[pkg][0]
    assert "MarkDuplicatesSpark" in cli.TOOL_REGISTRY and "GatherVcfsCloud" in cli.TOOL_REGISTRY
    vcf_a = d / "a.vcf"
    vcf_a.write_text("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n"
                     "chr1\t100\t.\tA\tG\t50\tPASS\t.\n")
    out = str(d / "g.vcf")
    assert cli.TOOL_REGISTRY["GatherVcfsCloud"](
        ["-I", str(vcf_a), "-O", out, "--spark-master", "local[2]"]) == 0
    assert "chr1\t100" in open(out).read()
    return (_read(out),)


@pytest.mark.parametrize("case", [_gather_and_sort, _liftover, _concordance, _left_align,
                                  _variants_to_table, _filter_expression, _spark_aliases],
                         ids=lambda f: f.__name__.strip("_"))
def test_jax_tests_on_both_packages(tmp_path, case):
    outs = {}
    for pkg in PACKAGES:
        d = tmp_path / pkg
        d.mkdir()
        outs[pkg] = case(pkg, d)
    assert outs["port"] == outs["jax"]


def test_spark_aliases_resolve_to_the_ports_tools():
    """Every gatk_tpu Spark alias whose target the port has is registered, as
    an alias of that target, and the port has HaplotypeCallerSpark's,
    ReadsPipelineSpark's and BQSRPipelineSpark's targets among them."""
    want = {a: t for a, t in jax_cli.TOOL_ALIASES.items() if t in port_cli.TOOL_REGISTRY}
    assert {a: t for a, t in port_cli.TOOL_ALIASES.items() if a in want} == want
    assert set(port_cli.TOOL_ALIASES) <= set(jax_cli.TOOL_ALIASES)
    for alias in ("HaplotypeCallerSpark", "MarkDuplicatesSpark", "BaseRecalibratorSpark",
                  "ApplyBQSRSpark", "ReadsPipelineSpark", "BQSRPipelineSpark",
                  "GatherVcfsCloud"):
        assert alias in port_cli.TOOL_ALIASES
        assert port_cli.TOOL_REGISTRY[alias].__module__ == "gatk_tpu_torch.tools.spark_compat"


# --------------------------------------------------------------------------- the copied tools


@pytest.fixture(scope="module")
def sample(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_scatter")
    s = synthetic.write_sample(str(d), seed=2, length=3000, n_reads=1000, n_snv=3, n_indel=2,
                               n_duplicates=40)
    calls = str(d / "calls.vcf")
    assert port_cli.main(["HaplotypeCaller", "-I", s["bam"], "-R", s["fasta"], "-O", calls,
                          "--device", "cpu"]) == 0
    s["calls"] = calls
    # the calls split in two VCFs of one sample, the later records first
    lines = open(calls).read().splitlines(keepends=True)
    head = [ln for ln in lines if ln.startswith("#")]
    body = [ln for ln in lines if not ln.startswith("#")]
    for name, part in (("late", body[len(body) // 2:]), ("early", body[:len(body) // 2])):
        s[name] = str(d / f"{name}.vcf")
        with open(s[name], "w") as fh:
            fh.writelines(head + part)
    return s


# tool, its arguments ({bam}, {fa}, {vcf}, {calls}, {late}, {early}: the
# sample's; {o}: the output), and whether it writes {o}
TOOLS = [
    ("CountReads", ["-I", "{bam}"], False),
    ("FlagStat", ["-I", "{bam}"], False),
    ("SortSam", ["-I", "{bam}", "-O", "{o}.bam"], True),
    ("PrintReads", ["-I", "{bam}", "-O", "{o}.bam", "-L", "{contig}:500-1500"], True),
    ("PrintReads", ["-I", "{bam}", "-O", "{o}.sam"], True),
    ("Pileup", ["-I", "{bam}", "-R", "{fa}", "-O", "{o}", "-L", "{contig}:900-960"], True),
    ("DepthOfCoverage", ["-I", "{bam}", "-L", "{contig}:100-2900", "-O", "{o}"], True),
    ("CountVariants", ["-V", "{calls}"], False),
    ("PrintVariants", ["-V", "{calls}", "-O", "{o}.vcf"], True),
    ("ValidateVariants", ["-V", "{calls}", "-R", "{fa}"], False),
    ("MergeVcfs", ["-I", "{late}", "-I", "{early}", "-O", "{o}.vcf"], True),
    ("SortVcf", ["-I", "{late}", "-I", "{early}", "-O", "{o}.vcf"], True),
    ("VariantAnnotator", ["-V", "{calls}", "-I", "{bam}", "-R", "{fa}", "-O", "{o}.vcf"], True),
    ("LeftAlignAndTrimVariants", ["-V", "{calls}", "-R", "{fa}", "-O", "{o}.vcf"], True),
    ("Concordance", ["-eval", "{calls}", "--truth", "{vcf}", "--summary", "{o}"], True),
    ("VariantsToTable", ["-V", "{calls}", "-F", "POS", "-F", "QD", "-GF", "GT", "-O", "{o}"],
     True),
    ("SplitIntervals", ["-R", "{fa}", "--scatter-count", "3", "-O", "{o}"], True),
]


@pytest.mark.parametrize("tool,argv,writes", TOOLS, ids=[f"{t}-{i}" for i, (t, _, _) in
                                                         enumerate(TOOLS)])
def test_copied_tool_identical_to_jax(sample, tmp_path, tool, argv, writes):
    outs = {}
    for pkg in PACKAGES:
        o = str(tmp_path / pkg)
        args = [a.format(bam=sample["bam"], fa=sample["fasta"], vcf=sample["known_sites"],
                         calls=sample["calls"], late=sample["late"], early=sample["early"],
                         contig=sample["contig"], o=o) for a in argv]
        rc, stdout = _run(pkg, tool, args)
        assert rc in (0, None)
        written = sorted(p for p in os.listdir(tmp_path) if p.startswith(pkg))
        files = {p[len(pkg):]: (_read(tmp_path / p) if os.path.isfile(tmp_path / p) else
                                {f: _read(tmp_path / p / f) for f in os.listdir(tmp_path / p)})
                 for p in written}
        outs[pkg] = (stdout.replace(o, "<o>"), files)
    assert outs["port"] == outs["jax"]
    assert bool(outs["port"][1]) == writes and (writes or outs["port"][0])


def test_scatter_gather_equals_one_run(sample, tmp_path):
    """SplitIntervals into 2 shards, HaplotypeCaller --device cpu a shard,
    GatherVcfs (GatherVcfsCloud, its Spark-named alias): the one run's records."""
    one = sample["calls"]  # HaplotypeCaller --device cpu over the whole contig
    common = ["-I", sample["bam"], "-R", sample["fasta"], "--device", "cpu"]
    shards = str(tmp_path / "shards")
    assert port_cli.main(["SplitIntervals", "-R", sample["fasta"], "--scatter-count", "2",
                          "-O", shards]) == 0
    lists = sorted(os.listdir(shards))
    assert lists == ["0000-scattered.interval_list", "0001-scattered.interval_list"]
    parts = []
    for name in lists:
        parts.append(str(tmp_path / f"{name}.vcf"))
        assert port_cli.main(["HaplotypeCaller", *common, "-L", os.path.join(shards, name),
                              "-O", parts[-1]]) == 0
    gathered = str(tmp_path / "gathered.vcf")
    argv = ["GatherVcfsCloud"] + [a for p in parts for a in ("-I", p)] + ["-O", gathered]
    assert port_cli.main(argv) == 0
    def records(path):
        return [ln for ln in _read(path).splitlines() if not ln.startswith(b"#")]

    assert records(gathered) == records(one) and len(records(one)) >= 3
    assert all(records(p) for p in parts)


def test_reads_pipeline_identical_to_jax(sample, tmp_path):
    """MarkDuplicates -> BaseRecalibrator --known-sites -> ApplyBQSR ->
    HaplotypeCaller: the port's ReadsPipeline --device cpu writes gatk_tpu's
    ReadsPipeline VCF, and ReadsPipelineSpark (Spark flags ignored) the same."""
    want, got, spark = (str(tmp_path / f) for f in ("jax.vcf", "port.vcf", "spark.vcf"))
    common = ["-I", sample["bam"], "-R", sample["fasta"], "--known-sites",
              sample["known_sites"]]
    assert jax_cli.TOOL_REGISTRY["ReadsPipeline"](common + ["-O", want]) == 0
    assert port_cli.main(["ReadsPipeline", *common, "-O", got, "--device", "cpu"]) == 0
    assert _read(got) == _read(want)
    assert port_cli.main(["ReadsPipelineSpark", *common, "-O", spark, "--device", "cpu",
                          "--spark-master", "local[4]", "--num-executors", "2"]) == 0
    assert _read(spark) == _read(want)
    called = {int(ln.split(b"\t")[1]) - 1 for ln in _read(got).splitlines()
              if not ln.startswith(b"#")}
    assert {v.pos for v in sample["variants"] if v.is_snv} <= called


def test_reads_pipeline_on_cuda_raises_without_a_card(monkeypatch, tmp_path):
    """ReadsPipeline --device cuda (the default) refuses to start without a
    card, before it reads its inputs; --device cpu gets as far as the missing
    BAM."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(devices, "_DEFAULT_DEVICE", torch.device("cuda"))
    argv = ["ReadsPipeline", "-I", str(tmp_path / "missing.bam"), "-R",
            str(tmp_path / "missing.fa"), "-O", str(tmp_path / "out.vcf")]
    for extra in ([], ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_cli.main(argv + extra)
    assert port_cli.main(argv + ["--device", "cpu"]) == 2
    assert not (tmp_path / "out.vcf").exists()
