"""The port's copies of the rest of gatk_tpu's host tools (tools/example_tools.py,
rnaseq_tools.py, realignment_tools.py, validation_tools.py,
saturation_mutagenesis_tool.py, plotting_tools.py, hadoop_compat.py and
barclay_tools.py) against gatk_tpu's, on the CPU; and the closing checks of the
port: its tool registry and aliases equal gatk_tpu's, its CLI answers an
unknown tool name as gatk_tpu's does, and it imports without the packages that
only VETS and the plotting tools need.

Each tool runs through both packages' registries on the synthetic inputs of
tests/torch_tool_cases.py and on small files written here, and the return
code, what it prints and every file it writes must be byte-identical. Two
outputs differ by design: GenerateToolWdl's task runs `python -m
gatk_tpu_torch`, and the port's tools that run on a device have a --device
flag that gatk_tpu's lack, which GenerateToolWdl writes into its task and
GenerateShellCompletion --with-flags would list. Those are held equal once the
package's name and --device are taken out. Then the checks of gatk_tpu's tests/test_rnaseq.py,
tests/test_realignment_filter.py, tests/test_hadoop_compat.py and the parts of
tests/test_new_tools_r4.py, test_picard_tools_r5.py, test_picard_tools2.py and
test_sam_fasta_tools.py about these tools run on the port.
"""
import os
import re
import struct
import subprocess
import sys

import numpy as np
import pytest

from gatk_tpu import cli as jax_cli
from gatk_tpu_torch import cli as port_cli
from gatk_tpu_torch.cli import TOOL_REGISTRY
from gatk_tpu_torch.io import bam, bgzf, sam
from gatk_tpu_torch.io.reads import Read
from gatk_tpu_torch.io.vcf import Variant
from gatk_tpu_torch.tools import hadoop_compat
from gatk_tpu_torch.tools.realignment_tools import build_unitigs, supports_variant
from gatk_tpu_torch.tools.rnaseq_tools import (SplitNCigarEngine, cigar_str, refactor_ndn,
                                               soft_clip_by_read_coords)
from gatk_tpu_torch.tools.validation_tools import (beta_binomial_cdf, binomial_inverse_cdf,
                                                   calculate_min_count_for_signal,
                                                   calculate_power)
from tests.torch_tool_cases import assert_identical, both, write_inputs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cigar(cigar):
    parsed = [(int(n), "MIDNSHP=X".index(c)) for n, c in re.findall(r"(\d+)([MIDNSHP=X])", cigar)]
    return (np.array([o for _, o in parsed], np.uint8),
            np.array([n for n, _ in parsed], np.int32))


def _read(name, pos, bases, cigar=None, flag=0, ref_id=0, qual=30):
    b = np.frombuffer(bases.encode(), np.uint8).copy()
    ops, lens = _cigar(cigar or f"{len(b)}M")
    return Read(name=name, flag=flag, ref_id=ref_id, pos=pos, mapq=60, cigar_ops=ops,
                cigar_lens=lens, bases=b, quals=np.full(len(b), qual, np.uint8))


def _bam(path, sequences, reads, rgs=()):
    header = sam.SamHeader(sequences=[sam.SequenceRecord(n, l, i)
                                      for i, (n, l) in enumerate(sequences)],
                           read_groups=list(rgs))
    w = bam.BamWriter(str(path), header)
    for r in sorted(reads, key=lambda r: (r.ref_id, r.pos, r.name)):
        w.write(r)
    w.close()
    return str(path)


def _text(path, text):
    with open(path, "w") as fh:
        fh.write(text)
    return str(path)


def _dup_ref(d):
    """tests/test_realignment_filter.py's segmental duplication: two contigs
    sharing 300 bases but one, and reads of chr2's copy aligned to chr1."""
    rng = np.random.default_rng(7)
    seg = "".join("ACGT"[i] for i in rng.integers(0, 4, 300))
    uniq1 = "".join("ACGT"[i] for i in rng.integers(0, 4, 200))
    uniq2 = "".join("ACGT"[i] for i in rng.integers(0, 4, 200))
    seg2 = list(seg)
    seg2[150] = "G" if seg[150] != "G" else "C"
    c1, c2 = uniq1 + seg, uniq2 + "".join(seg2)
    fa = _text(d / "dup.fa", f">chr1\n{c1}\n>chr2\n{c2}\n")
    var = 350
    reads = [_read(f"r{i}", var - 60 + 6 * i, c2[var - 60 + 6 * i:var + 80]) for i in range(8)]
    path = _bam(d / "dup.bam", [("chr1", len(c1)), ("chr2", len(c2))], reads)
    vcf = _text(d / "dup.vcf", "##fileformat=VCFv4.2\n##contig=<ID=chr1>\n##contig=<ID=chr2>\n"
                "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n"
                f"chr1\t{var + 1}\t.\t{c1[var]}\t{seg2[150]}\t100\tPASS\t.\n")
    return fa, path, vcf


def _amplicon(d):
    """tests/test_new_tools_r4.py's amplicon: a 10-codon ORF at 16-45, five
    reads with codon 2 GCT>GTT and three wild type."""
    seq = "AAAAACCCCCGGGGG" + "ATGGCTGCAGCTGCAGCTGCAGCTGCATAA" + "TTTTTGGGGGAAAAA"
    fa = _text(d / "amp.fa", f">amp\n{seq}\n")
    mutant = seq[:19] + "T" + seq[20:]
    reads = [_read(f"v{i}", 0, mutant, qual=38) for i in range(5)]
    reads += [_read(f"w{i}", 0, seq, qual=38) for i in range(3)]
    return fa, _bam(d / "sm.bam", [("amp", len(seq))], reads)


def _spliced(d, fasta):
    """Reads over the sample's contig split by 150-base introns (N), some
    with an overhang into an intron."""
    ref = "".join(l.strip() for l in open(fasta) if not l.startswith(">"))
    reads = []
    for k, s in enumerate(range(100, 2500, 120)):
        bases = ref[s:s + 40] + ref[s + 190:s + 230]
        reads.append(_read(f"s{k}", s, bases, "40M150N40M"))
        reads.append(_read(f"o{k}", s + 170, ref[s + 170:s + 230]))
    return _bam(d / "spliced.bam", [("chrM", len(ref))], reads,
                rgs=[{"ID": "rg1", "SM": "SYN1"}])


@pytest.fixture(scope="module")
def inp(tmp_path_factory):
    d = tmp_path_factory.mktemp("longtail")
    inp = write_inputs(d)
    inp["ctrl"] = str(d / "ctrl.bam")
    assert TOOL_REGISTRY["AddOrReplaceReadGroups"](
        ["-I", inp["bam"], "-O", inp["ctrl"], "-ID", "rg9", "-LB", "l9", "-PL", "ILLUMINA",
         "-PU", "u9", "-SM", "CTRL"]) == 0
    inp["spliced"] = _spliced(d, inp["fasta"])
    inp["gff"] = _text(d / "genes.gff3", "##gff-version 3\n"
                       "chrM\t.\tgene\t101\t1200\t.\t+\t.\tID=gene1;Name=GENE1\n"
                       "chrM\t.\tmRNA\t101\t1200\t.\t+\t.\tID=tx1;Parent=gene1\n"
                       "chrM\t.\texon\t101\t600\t.\t+\t.\tID=ex1;Parent=tx1\n"
                       "chrM\t.\texon\t801\t1200\t.\t+\t.\tID=ex2;Parent=tx1\n"
                       "chrM\t.\tgene\t1501\t2600\t.\t-\t.\tID=gene2;Name=GENE2\n"
                       "chrM\t.\texon\t1501\t2600\t.\t-\t.\tID=ex3;Parent=gene2\n")
    inp["dup_fa"], inp["dup_bam"], inp["dup_vcf"] = _dup_ref(d)
    inp["amp_fa"], inp["amp_bam"] = _amplicon(d)
    inp["mc3"] = _text(d / "mc3.vcf", "##fileformat=VCFv4.2\n"
                       "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n"
                       "chr1\t100\t.\tA\tG\t.\tPASS\tCENTERS=MUSE;NREF=20;NALT=10\n"
                       "chr1\t200\t.\tC\tT\t.\tPASS\tNREF=30;NALT=5\n")
    inp["m2"] = _text(d / "m2.vcf", "##fileformat=VCFv4.2\n"
                      "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tTUMOR\n"
                      "chr1\t100\t.\tA\tG\t50\tPASS\t.\tGT:AD\t0/1:18,12\n"
                      "chr1\t300\t.\tG\tC\t60\tPASS\t.\tGT:AD\t0/1:25,8\n")
    inp["cr"] = _text(d / "cr.tsv", "@HD\tVN:1.6\n@SQ\tSN:c1\tLN:10000\n"
                      "CONTIG\tSTART\tEND\tLOG2_COPY_RATIO\n"
                      + "".join(f"c1\t{i * 100 + 1}\t{i * 100 + 100}\t{(i % 7 - 3) / 10}\n"
                                for i in range(50)))
    inp["seg"] = _text(d / "model.seg", "@HD\tVN:1.6\nCONTIG\tSTART\tEND\tNUM_POINTS_COPY_RATIO"
                       "\tLOG2_COPY_RATIO_POSTERIOR_10\tLOG2_COPY_RATIO_POSTERIOR_50\t"
                       "LOG2_COPY_RATIO_POSTERIOR_90\nc1\t1\t2500\t25\t-0.1\t0.0\t0.1\n"
                       "c1\t2501\t5000\t25\t0.2\t0.3\t0.4\n")
    u = bgzf.decompress_file(inp["paired"])
    inp["shard"] = str(d / "part-r-00000.bam")
    with open(inp["shard"], "wb") as fh:
        fh.write(bgzf.compress_bytes(u[hadoop_compat._bam_header_span(u):]))
    src = d / "gcs"
    src.mkdir()
    (src / "a.bin").write_bytes(np.random.default_rng(0).bytes(300_000))
    (src / "b.txt").write_text("hello")
    (src / "sub").mkdir()
    (src / "sub" / "skip.txt").write_text("skipped")
    inp["gcs"] = str(src)
    head = "##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n"
    inp["feat_a"] = _text(d / "fa.vcf", head + "chrM\t100\t.\tA\tG\t50\tPASS\t.\n")
    inp["feat_b"] = _text(d / "fb.vcf", head + "chrM\t50\t.\tC\tT\t60\tPASS\t.\n")
    return inp


CASES = [
    ("ExampleReadWalkerWithReference", ["-I", "{bam}", "-R", "{fasta}", "-L", "chrM:1-400", "-O",
                                        "{out}/o.txt"], ["o.txt"]),
    ("ExampleLocusWalker", ["-I", "{bam}", "-R", "{fasta}", "-L", "chrM:100-200", "-O",
                            "{out}/o.txt"], ["o.txt"]),
    ("ExampleIntervalWalker", ["-I", "{bam}", "-R", "{fasta}", "-L", "chrM:100-300", "-L",
                               "chrM:900-1000", "-O", "{out}/o.txt"], ["o.txt"]),
    ("ExampleVariantWalker", ["-V", "{calls}", "-O", "{out}/o.txt"], ["o.txt"]),
    ("ExampleTwoPassVariantWalker", ["-V", "{calls}", "-O", "{out}/o.txt"], ["o.txt"]),
    ("ExampleReferenceWalker", ["-R", "{fasta}", "-L", "chrM:1-120", "-O", "{out}/o.txt"],
     ["o.txt"]),
    ("ExampleFeatureWalker", ["-F", "{bed}", "-O", "{out}/o.txt"], ["o.txt"]),
    ("ExampleAssemblyRegionWalker", ["-I", "{bam}", "-R", "{fasta}", "-L", "chrM:300-1200", "-O",
                                     "{out}/o.txt"], ["o.txt"]),
    ("ExampleReadWalkerWithVariants", ["-I", "{bam}", "-V", "{calls}", "-O", "{out}/o.txt"],
     ["o.txt"]),
    ("ExamplePartialReadWalker", ["-I", "{bam}", "-O", "{out}/o.txt", "--stop-on-read-count",
                                  "3"], ["o.txt"]),
    ("ExampleMultiFeatureWalker", ["-F", "{feat_a}", "-F", "{feat_b}", "-F", "{calls}", "-O",
                                   "{out}/o.txt"], ["o.txt"]),
    ("ExamplePostTraversalPythonExecutor", ["-I", "{bam}", "-O", "{out}/j.txt", "-P",
                                            "{out}/p.txt", "-L", "chrM:1-150"],
     ["j.txt", "p.txt"]),
    ("ExampleStreamingPythonExecutor", ["-I", "{bam}", "-O", "{out}/s.txt", "-L", "chrM:1-600",
                                        "--batchSize", "50"], ["s.txt"]),
    ("ExampleReadWalkerWithReferenceSpark", ["-I", "{bam}", "-R", "{fasta}", "-L", "chrM:1-200",
                                             "-O", "{out}/o.txt"], ["o.txt"]),
    ("ExampleReadWalkerWithVariantsSpark", ["-I", "{bam}", "-V", "{calls}", "-O", "{out}/o.txt"],
     ["o.txt"]),
    ("ExampleLocusWalkerSpark", ["-I", "{bam}", "-L", "chrM:100-150", "-O", "{out}/o.txt"],
     ["o.txt"]),
    ("ExampleIntervalWalkerSpark", ["-I", "{bam}", "-L", "chrM:100-300", "-O", "{out}/o.txt"],
     ["o.txt"]),
    ("ExampleVariantWalkerSpark", ["-V", "{calls}", "-O", "{out}/o.txt"], ["o.txt"]),
    ("ExampleAssemblyRegionWalkerSpark", ["-I", "{bam}", "-R", "{fasta}", "-L", "chrM:1-1000",
                                          "-O", "{out}/o.txt"], ["o.txt"]),
    ("SplitNCigarReads", ["-I", "{spliced}", "-R", "{fasta}", "-O", "{out}/split.bam",
                          "--refactor-cigar-string"], ["split.bam"]),
    ("ASEReadCounter", ["-I", "{bam}", "-V", "{calls}", "-O", "{out}/ase.tsv"], ["ase.tsv"]),
    ("GeneExpressionEvaluation", ["-I", "{paired}", "-G", "{gff}", "-O", "{out}/expr.tsv",
                                  "--minimum-mapping-quality", "20"], ["expr.tsv"]),
    ("FilterAlignmentArtifacts", ["-V", "{dup_vcf}", "-I", "{dup_bam}", "-R", "{dup_fa}", "-O",
                                  "{out}/f.vcf"], ["f.vcf"]),
    ("ValidateBasicSomaticShortMutations", ["-V", "{calls}", "-I", "{bam}", "-I", "{ctrl}",
                                            "-R", "{fasta}", "-O", "{out}/val.tsv",
                                            "--discovery-sample-name", "SYN1",
                                            "--val-case-sample-name", "SYN1",
                                            "--val-control-sample-name", "CTRL",
                                            "--annotated-vcf", "{out}/val.vcf",
                                            "--summary", "{out}/sum.txt"],
     ["val.tsv", "val.vcf"]),
    ("MergeMutect2CallsWithMC3", ["-eval", "{m2}", "--truth", "{mc3}", "-O", "{out}/m.vcf"],
     ["m.vcf"]),
    ("AnalyzeSaturationMutagenesis", ["-I", "{amp_bam}", "-R", "{amp_fa}", "-O", "{out}/sm",
                                      "--orf", "16-45"], ["sm.variantCounts", "sm.readCounts"]),
    ("PlotDenoisedCopyRatios", ["--standardized-copy-ratios", "{cr}", "--denoised-copy-ratios",
                                "{cr}", "-O", "{out}", "--output-prefix", "t"],
     ["t.denoised.png"]),
    ("PlotModeledSegments", ["--denoised-copy-ratios", "{cr}", "--segments", "{seg}", "-O",
                             "{out}", "--output-prefix", "t"], ["t.modeled.png"]),
    ("ConvertHeaderlessHadoopBamShardToBam", ["--bam-shard", "{shard}", "--bam-with-header",
                                              "{paired}", "-O", "{out}/re.bam"], ["re.bam"]),
    ("CreateHadoopBamSplittingIndex", ["-I", "{out}/p.bam", "--splitting-index-granularity",
                                       "100", "--create-bai"], ["p.bam.sbi", "p.bam.bai"],
     {"p.bam": "{paired}"}),
    ("ParallelCopyGCSDirectoryIntoHDFSSpark", ["--input-gcs-path", "{gcs}",
                                               "--output-hdfs-directory", "{out}/dst",
                                               "--chunk-size", "65536"], ["dst/a.bin"]),
    ("GenerateShellCompletion", ["-O", "{out}/c.bash"], ["c.bash"]),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_tool_identical_to_jax(inp, tmp_path, case):
    tool, args, expect, inputs = (case + ({},))[:4]
    _, text, files = assert_identical(both(tmp_path, tool, args, inputs, **inp), expect)
    assert text or files


def _without_device(text):
    """A WDL task or a completion script with the port's --device flag taken
    out, and the port's package named as gatk_tpu."""
    text = text.replace("python -m gatk_tpu_torch ", "python -m gatk_tpu ")
    lines = [l for l in text.splitlines(keepends=True) if not re.match(r"\s*String\? device\b", l)]
    text = "".join(lines).replace(" ~{'--device ' + device}", "")
    return re.sub(r" --device(?=[ \"])", "", text)


@pytest.mark.parametrize("tool", ["HaplotypeCaller", "Mutect2", "GermlineCNVCaller",
                                  "CountBases", "SortSam", "ScoreVariantAnnotations"])
def test_generate_tool_wdl_differs_only_by_package_and_device(tmp_path, tool):
    res = both(tmp_path, "GenerateToolWdl", ["--tool", tool, "-O", "{out}/t.wdl"])
    (rc, text, files), (jrc, jtext, jfiles) = res["port"], res["jax"]
    assert rc == jrc == 0 and text == jtext
    port_wdl, jax_wdl = files["t.wdl"].decode(), jfiles["t.wdl"].decode()
    assert f"python -m gatk_tpu_torch {tool} " in port_wdl
    assert f"python -m gatk_tpu {tool} " in jax_wdl
    assert _without_device(port_wdl) == jax_wdl
    assert ("--device" in port_wdl) == (tool in ("HaplotypeCaller", "Mutect2",
                                                 "GermlineCNVCaller"))


def test_shell_completion_with_flags_fault_is_carried_as_is(tmp_path):
    """gatk_tpu's GenerateShellCompletion --with-flags exits with argparse's
    code 2: capture_tool_parser catches Exception (gatk_tpu/tools/
    barclay_tools.py:49), but a tool that parses with parse_known_args, such
    as BwaSpark, exits through SystemExit. The port's copy does the same."""
    res = both(tmp_path, "GenerateShellCompletion", ["-O", "{out}/c.bash", "--with-flags"])
    assert res["port"] == res["jax"] == (("raised", "SystemExit", "2"), "", {})


def _flags(pkg, name):
    """The flags --with-flags would list for a tool: its parser's option
    strings, or None where it has no parser to capture."""
    from gatk_tpu.tools import barclay_tools as jax_barclay
    from gatk_tpu_torch.tools import barclay_tools

    capture = (barclay_tools if pkg == "port" else jax_barclay).capture_tool_parser
    try:
        parser = capture(name)
    except SystemExit:  # parse_known_args: the fault above
        return None
    return None if parser is None else sorted({o for a in parser._actions
                                               for o in a.option_strings})


def test_every_tool_takes_gatk_tpus_flags_and_only_the_device_flag_more():
    """Each tool's flags, as --with-flags captures them, are gatk_tpu's; the
    tools that run on a device add --device."""
    with_device = []
    for name in jax_cli.TOOL_REGISTRY:
        if name in jax_cli.TOOL_ALIASES:
            continue
        port, jax = _flags("port", name), _flags("jax", name)
        if port is not None and "--device" in port:
            port.remove("--device")
            with_device.append(name)
        assert port == jax, name
    assert {"HaplotypeCaller", "Mutect2", "GermlineCNVCaller", "ModelSegments",
            "CreateReadCountPanelOfNormals"} <= set(with_device)
    assert "TrainVariantAnnotationsModel" not in with_device


# ---------------------------------------------------------------- the port's registry


def test_registry_equals_gatk_tpus():
    """The port registers gatk_tpu's 312 tool names and its 36 Spark-named
    aliases with the same targets. (The order of the names depends on which
    tool module a process imported first, in both packages.)"""
    assert set(port_cli.TOOL_REGISTRY) == set(jax_cli.TOOL_REGISTRY)
    assert len(port_cli.TOOL_REGISTRY) == 312
    assert port_cli.TOOL_ALIASES == jax_cli.TOOL_ALIASES
    assert len(port_cli.TOOL_ALIASES) == 36
    assert all(t in port_cli.TOOL_REGISTRY and t not in port_cli.TOOL_ALIASES
               for t in port_cli.TOOL_ALIASES.values())


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_list_names_every_tool(pkg, capsys):
    cli = port_cli if pkg == "port" else jax_cli
    assert cli.main(["--list"]) == 0
    out = capsys.readouterr().out
    assert all(f"  {name} " in out for name in cli.TOOL_REGISTRY)



@pytest.mark.parametrize("command", ["IndelRealigner", "CNNScoreVariants", "HaplotypeCallr",
                                     "Mutect", "markduplicates", "SortSamm", "Zzzzzzzzzzzzzzz"])
def test_unknown_tool_message_equals_gatk_tpus(command):
    assert port_cli.unknown_command_message(command) == jax_cli.unknown_command_message(command)


def test_deprecation_and_suggestions(capsys):
    """gatk_tpu's tests/test_picard_tools2.py::test_deprecation_and_suggestions,
    on the port's CLI."""
    msg = port_cli.unknown_command_message("IndelRealigner")
    assert "no longer included" in msg and "4.0.0.0" in msg
    assert "HaplotypeCaller" in port_cli.unknown_command_message("HaplotypeCallr")
    assert "Mutect2" in port_cli.unknown_command_message("Mutect")
    assert port_cli.unknown_command_message("Zzzzzzzzzzzzzzz") is None
    assert port_cli.main(["IndelRealigner"]) == 2
    assert "no longer included in GATK" in capsys.readouterr().err

def test_cli_imports_without_h5py_sklearn_matplotlib():
    """The card machine has none of h5py, scikit-learn and matplotlib: VETS
    and the plotting tools import them inside their functions, so the CLI and
    every module of the port import without them, and VETS fails only when it
    runs."""
    code = (
        "import sys\n"
        "for m in ('h5py', 'sklearn', 'sklearn.ensemble', 'sklearn.impute', 'matplotlib',\n"
        "          'matplotlib.pyplot'):\n"
        "    sys.modules[m] = None\n"
        "import gatk_tpu_torch.cli as cli\n"
        "from gatk_tpu_torch.tools import vets_tools, plotting_tools  # noqa: F401\n"
        "assert len(cli.TOOL_REGISTRY) == 312, len(cli.TOOL_REGISTRY)\n"
        "try:\n"
        "    cli.TOOL_REGISTRY['TrainVariantAnnotationsModel'](\n"
        "        ['--annotations-hdf5', 'x.hdf5', '-O', 'x'])\n"
        "except ImportError as e:\n"
        "    print('ImportError', e.name)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ImportError sklearn.ensemble"


# ----------------------------------------------- gatk_tpu's tests of these tools, on the port


def test_refactor_ndn():
    ops, lens = refactor_ndn(*_cigar("10M5N3D7N10M"))
    r = _read("r", 0, "A" * 20)
    r.cigar_ops, r.cigar_lens = ops, lens
    assert cigar_str(r) == "10M15N10M"


def test_split_docstring_example():
    eng = SplitNCigarEngine(do_not_fix_overhangs=True)
    eng.process_read(_read("r1", 100, "ACGTACGTA", "2M2D1M2N1M2I1N1M2S"), "chr")
    fam = eng.families[0]
    assert [cigar_str(r) for r in fam] == ["2M2D1M6S", "3S1M2I3S", "6S1M2S"]
    assert [r.pos for r in fam] == [100, 107, 109]


def test_soft_clip_by_read_coords():
    read = _read("r", 100, "A" * 50)
    left = soft_clip_by_read_coords(read, 0, 9)
    assert cigar_str(left) == "10S40M" and left.pos == 110
    right = soft_clip_by_read_coords(read, 40, 49)
    assert cigar_str(right) == "40M10S" and right.pos == 100


class _FakeRef:
    def __init__(self, seq):
        self.seq = np.frombuffer(seq.encode(), np.uint8)

    def fetch(self, contig, start, end):
        return self.seq[start:end]


def test_overhang_clipping():
    eng = SplitNCigarEngine(reference=_FakeRef("A" * 300), max_mismatches_in_overhang=1)
    eng.process_read(_read("r1", 50, "A" * 40, "20M100N20M"), "chr")
    eng.process_read(_read("r1", 160, "T" * 30), "chr")
    fixed = eng._fix_family(eng.families[1])
    assert cigar_str(fixed[0]) == "10S20M" and fixed[0].pos == 170
    eng.process_read(_read("r1", 160, "A" * 30), "chr")
    assert cigar_str(eng._fix_family(eng.families[2])[0]) == "30M"


def test_split_ncigar_reads_splits_every_spliced_read(inp, tmp_path):
    out = str(tmp_path / "split.bam")
    assert TOOL_REGISTRY["SplitNCigarReads"](["-I", inp["spliced"], "-R", inp["fasta"],
                                              "-O", out]) == 0
    got = list(bam.BamReader(out))
    assert not any(sam.OP_N in r.cigar_ops.tolist() for r in got)
    n_spliced = sum(1 for r in bam.BamReader(inp["spliced"]) if r.name[0] == "s")
    assert sum(1 for r in got if r.name[0] == "s") == 2 * n_spliced


def test_ase_read_counter(tmp_path):
    reads = [_read(f"r{i}", 1000, "A" * 10 + ("G" if i < 4 else "A") + "A" * 9)
             for i in range(10)]
    path = _bam(tmp_path / "ase.bam", [("20", 64444167)], reads)
    vcf_path = _text(tmp_path / "sites.vcf", "##fileformat=VCFv4.2\n"
                     '##FORMAT=<ID=GT,Number=1,Type=String,Description="gt">\n'
                     "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS\n"
                     "20\t1011\t.\tA\tG\t50\tPASS\t.\tGT\t0/1\n")
    out = str(tmp_path / "ase.tsv")
    assert TOOL_REGISTRY["ASEReadCounter"](["-I", path, "-V", vcf_path, "-O", out]) == 0
    assert open(out).read().splitlines()[1].split("\t")[:8] == \
        ["20", "1011", ".", "A", "G", "6", "4", "10"]


def test_supports_variant_snp_and_indel():
    v = Variant("chr1", 105, "A", ("G",))
    assert supports_variant(_read("r", 100, "CCCCCGCCCC"), v)
    assert not supports_variant(_read("r", 100, "CCCCCACCCC"), v)
    assert supports_variant(_read("ri", 100, "CCCCCATTCCCC", "6M2I4M"),
                            Variant("chr1", 105, "A", ("ATT",)))


def test_build_unitigs_consensus():
    rng = np.random.default_rng(1)
    seq = "".join("ACGT"[i] for i in rng.integers(0, 4, 60))
    unitigs = build_unitigs([_read(f"r{i}", 100 + 5 * i, seq[5 * i:5 * i + 40])
                             for i in range(4)])
    assert len(unitigs) == 1 and unitigs[0].decode() == seq[:55]


def test_filter_alignment_artifacts_tool(inp, tmp_path):
    out = str(tmp_path / "out.vcf")
    assert TOOL_REGISTRY["FilterAlignmentArtifacts"](["-V", inp["dup_vcf"], "-I", inp["dup_bam"],
                                                      "-R", inp["dup_fa"], "-O", out]) == 0
    recs = [l.split("\t") for l in open(out) if not l.startswith("#")]
    assert len(recs) == 1 and "alignment_artifact" in recs[0][6]
    assert "UNITIGS=" in recs[0][7] and "JOINT_ALIGNMENTS=" in recs[0][7]


def test_power_calculation_utils():
    assert 2 <= binomial_inverse_cdf(100, 0.01, 0.99) <= 5
    assert calculate_min_count_for_signal(0, 0.0) == 2
    assert beta_binomial_cdf(10, 2, 3, 10) == pytest.approx(1.0, abs=1e-9)
    assert beta_binomial_cdf(3, 2, 3, 10) < beta_binomial_cdf(6, 2, 3, 10)
    assert calculate_power(100, 30, 60, 5) > 0.95


def test_validate_basic_somatic_short_mutations(inp, tmp_path):
    """The control is the sample itself under another name, so it carries the
    alt reads of every planted het: each site is judged a normal artifact and
    none validates."""
    out = str(tmp_path / "val.tsv")
    assert TOOL_REGISTRY["ValidateBasicSomaticShortMutations"](
        ["-V", inp["calls"], "-I", inp["bam"], "-I", inp["ctrl"], "-O", out,
         "--discovery-sample-name", "SYN1", "--val-case-sample-name", "SYN1",
         "--val-control-sample-name", "CTRL"]) == 0
    rows = [l.split("\t") for l in open(out).read().splitlines()[1:]]
    assert len(rows) == len(inp["variants"])
    assert all(r[12] == "UNVALIDATED" and int(r[10]) > 1 for r in rows)


def test_merge_mutect2_calls_with_mc3(inp, tmp_path):
    out = str(tmp_path / "merged.vcf")
    assert TOOL_REGISTRY["MergeMutect2CallsWithMC3"](["-eval", inp["m2"], "--truth", inp["mc3"],
                                                      "-O", out]) == 0
    recs = {int(l.split("\t")[1]): l.split("\t") for l in open(out) if not l.startswith("#")}
    assert set(recs) == {100, 200, 300}
    assert "M2" in recs[100][7] and "MUSE" in recs[100][7]
    assert "CENTERS=M2" in recs[300][7] and "AD" in recs[100][8]


def test_gene_expression_evaluation(tmp_path):
    gff = _text(tmp_path / "genes.gff3", "##gff-version 3\n"
                "chr1\t.\tgene\t101\t500\t.\t+\t.\tID=gene1;Name=GENE1\n"
                "chr1\t.\tmRNA\t101\t500\t.\t+\t.\tID=tx1;Parent=gene1\n"
                "chr1\t.\texon\t101\t200\t.\t+\t.\tID=ex1;Parent=tx1\n"
                "chr1\t.\texon\t401\t500\t.\t+\t.\tID=ex2;Parent=tx1\n"
                "chr1\t.\tgene\t1001\t1400\t.\t-\t.\tID=gene2;Name=GENE2\n"
                "chr1\t.\texon\t1001\t1400\t.\t-\t.\tID=ex3;Parent=gene2\n")
    reads = [_read(n, p, "A" * 50, flag=0x10 if rev else 0) for n, p, rev in
             (("f1", 120, 0), ("f2", 130, 0), ("f3", 440, 0), ("a1", 150, 1), ("g1", 1100, 1),
              ("g2", 1200, 1))]
    path = _bam(tmp_path / "rna.bam", [("chr1", 5000)], reads, rgs=[{"ID": "rg1", "SM": "s1"}])
    out = str(tmp_path / "expr.tsv")
    assert TOOL_REGISTRY["GeneExpressionEvaluation"](["-I", path, "-G", gff, "-O", out]) == 0
    rows = {(f[0], f[5]): float(f[6]) for f in (l.split("\t")
                                                for l in open(out).read().splitlines()[1:])}
    assert rows[("GENE1", "sense")] == pytest.approx(3.0, abs=0.01)
    assert rows[("GENE1", "antisense")] == pytest.approx(1.0, abs=0.01)
    assert rows[("GENE2", "sense")] == pytest.approx(2.0, abs=0.01)
    assert rows[("GENE2", "antisense")] == 0.0


def test_analyze_saturation_mutagenesis(inp, tmp_path):
    prefix = str(tmp_path / "out")
    assert TOOL_REGISTRY["AnalyzeSaturationMutagenesis"](
        ["-I", inp["amp_bam"], "-R", inp["amp_fa"], "-O", prefix, "--orf", "16-45"]) == 0
    vc = open(prefix + ".variantCounts").read().strip().split("\t")
    assert vc[0] == "5" and vc[3] == "1" and "20:C>T" in vc[4]
    assert vc[5] == "1" and "2:GCT>GTT" in vc[6] and "M:A>V" in vc[7]
    rcounts = open(prefix + ".readCounts").read()
    assert "Total Reads:\t8" in rcounts and ">wild_type:\t3" in rcounts
    assert open(prefix + ".refCoverage").read().splitlines()[1] == "1\t8"
    codons = open(prefix + ".codonCounts").read().splitlines()
    assert codons[2].split("\t")[codons[0].split("\t").index("GTT")] == "5"


def test_plot_tools(inp, tmp_path):
    out = str(tmp_path / "plots")
    assert TOOL_REGISTRY["PlotDenoisedCopyRatios"](
        ["--standardized-copy-ratios", inp["cr"], "--denoised-copy-ratios", inp["cr"], "-O", out,
         "--output-prefix", "t"]) == 0
    assert os.path.getsize(os.path.join(out, "t.denoised.png")) > 1000
    assert TOOL_REGISTRY["PlotModeledSegments"](
        ["--denoised-copy-ratios", inp["cr"], "--segments", inp["seg"], "-O", out,
         "--output-prefix", "t"]) == 0
    assert os.path.getsize(os.path.join(out, "t.modeled.png")) > 1000


def test_create_splitting_index_roundtrip(inp, tmp_path):
    out = tmp_path / "p.bam.sbi"
    assert not TOOL_REGISTRY["CreateHadoopBamSplittingIndex"](
        ["-I", inp["paired"], "-O", str(out), "--splitting-index-granularity", "100"])
    blob = out.read_bytes()
    assert blob[:4] == b"SBI\x01"
    file_len, = struct.unpack_from("<q", blob, 4)
    assert file_len == os.path.getsize(inp["paired"])
    count, gran, n_off = struct.unpack_from("<qqq", blob, 44)
    assert count == sum(1 for _ in bam.BamReader(inp["paired"])) and gran == 100
    assert n_off == (count + 99) // 100 + 1
    offsets = struct.unpack_from(f"<{n_off}q", blob, 68)
    assert list(offsets) == sorted(offsets) and offsets[-1] == file_len << 16
    first = bgzf.BgzfReader(inp["paired"]).read_range(offsets[0], offsets[0] + (1 << 16))
    assert 32 < struct.unpack_from("<i", first, 0)[0] < 10000


def test_convert_headerless_shard(inp, tmp_path):
    out = tmp_path / "rejoined.bam"
    assert not TOOL_REGISTRY["ConvertHeaderlessHadoopBamShardToBam"](
        ["--bam-shard", inp["shard"], "--bam-with-header", inp["paired"], "-O", str(out)])
    key = [(r.name, r.pos, r.flag) for r in bam.BamReader(inp["paired"])]
    assert [(r.name, r.pos, r.flag) for r in bam.BamReader(str(out))] == key


def test_parallel_copy(inp, tmp_path):
    dst = tmp_path / "dst"
    assert not TOOL_REGISTRY["ParallelCopyGCSDirectoryIntoHDFSSpark"](
        ["--input-gcs-path", inp["gcs"], "--output-hdfs-directory", str(dst),
         "--chunk-size", str(64 * 1024)])
    assert (dst / "a.bin").read_bytes() == open(os.path.join(inp["gcs"], "a.bin"), "rb").read()
    assert (dst / "b.txt").read_text() == "hello" and not (dst / "sub").exists()


def test_example_walkers(inp, tmp_path):
    out = str(tmp_path / "vw.txt")
    assert TOOL_REGISTRY["ExampleVariantWalker"](["-V", inp["calls"], "-O", out]) == 0
    assert f"chrM:{inp['variants'][0].pos + 1}" in open(out).read()
    out2 = str(tmp_path / "2p.txt")
    assert TOOL_REGISTRY["ExampleTwoPassVariantWalker"](["-V", inp["calls"], "-O", out2]) == 0
    assert "z=" in open(out2).read()
    out3 = str(tmp_path / "mf.txt")
    assert TOOL_REGISTRY["ExampleMultiFeatureWalker"](["-F", inp["feat_a"], "-F", inp["feat_b"],
                                                       "-O", out3]) == 0
    lines = open(out3).read().splitlines()
    assert lines[0].startswith("chrM:50") and "2 features" in lines[-1]
    out4 = str(tmp_path / "pr.txt")
    assert TOOL_REGISTRY["ExamplePartialReadWalker"](["-I", inp["bam"], "-O", out4,
                                                      "--stop-on-read-count", "3"]) == 0
    assert "stopped after 3 reads" in open(out4).read()


def test_python_executor_examples(inp, tmp_path):
    j, p, s = (str(tmp_path / f) for f in ("j.txt", "p.txt", "s.txt"))
    assert TOOL_REGISTRY["ExamplePostTraversalPythonExecutor"](
        ["-I", inp["bam"], "-O", j, "-P", p, "-L", "chrM:1-150"]) == 0
    assert open(p).read() == open(j).read() and "Read at chrM:" in open(p).read()
    assert TOOL_REGISTRY["ExampleStreamingPythonExecutor"](
        ["-I", inp["bam"], "-O", s, "-L", "chrM:1-600", "--batchSize", "50"]) == 0
    assert sum(1 for l in open(s) if l.startswith("Read at")) > 100


def test_generate_tool_wdl(tmp_path):
    out = tmp_path / "hc.wdl"
    assert TOOL_REGISTRY["GenerateToolWdl"](["--tool", "HaplotypeCaller", "-O", str(out)]) == 0
    text = open(out).read()
    assert text.startswith("version 1.0") and "task HaplotypeCaller" in text
    assert "python -m gatk_tpu_torch HaplotypeCaller" in text
    assert ("File input" in text or "Array[File] input" in text) and "output" in text


def test_generate_shell_completion(tmp_path):
    out = tmp_path / "comp.bash"
    assert TOOL_REGISTRY["GenerateShellCompletion"](["-O", str(out)]) == 0
    text = open(out).read()
    assert "HaplotypeCaller" in text and "Mutect2" in text
    assert "complete -o default -F _gatk_tpu_complete" in text
    assert subprocess.run(["bash", "-n", str(out)], capture_output=True).returncode == 0

