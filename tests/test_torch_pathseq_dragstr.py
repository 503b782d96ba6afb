"""The port's copies of gatk_tpu's PathSeq tools (tools/pathseq_tools.py) and
DRAGstr (utils/dragstr.py, tools/dragstr_tools.py) against gatk_tpu's, on the
CPU.

Each tool runs through both packages' registries on inputs written here (a
host and a microbe genome, reads drawn from both, a taxonomy and an NCBI dump;
for DRAGstr the synthetic chrM sample of tests/torch_tool_cases.py) and the
return code, what it prints and every file it writes must be byte-identical
(an .npz or .zip member by member). Then gatk_tpu's tests/test_pathseq.py,
tests/test_dragstr.py and the PathSeq part of tests/test_new_tools_r4.py run on
the port; the default-parameters golden, which gatk_tpu reads from the
reference bundle, is held to gatk_tpu's own writer.
"""
import gzip

import numpy as np
import pytest

from gatk_tpu.utils import dragstr as jax_dragstr
from gatk_tpu_torch.align.seed_extend import SeedExtendAligner, revcomp
from gatk_tpu_torch.cli import TOOL_REGISTRY
from gatk_tpu_torch.io import bam as bamio, sam as samio
from gatk_tpu_torch.io.reads import Read
from gatk_tpu_torch.tools.pathseq_tools import _canonical_kmers, dust_mask, read_taxonomy
from gatk_tpu_torch.utils import dragstr
from tests.torch_tool_cases import assert_identical, both, write_inputs

CONTIGS = (("host", 1000), ("microbe1", 5000), ("microbe2", 800))


def _write_bam(path, reads, contigs=CONTIGS):
    header = samio.SamHeader(sequences=[samio.SequenceRecord(n, l, i)
                                        for i, (n, l) in enumerate(contigs)])
    w = bamio.BamWriter(str(path), header)
    for r in reads:
        w.write(r)
    w.close()
    return str(path)


def _read(name, bases, ref_id=-1, pos=-1, flag=4):
    arr = np.frombuffer(bases.encode(), np.uint8).copy() if isinstance(bases, str) else bases
    mapped = flag & 4 == 0
    return Read(name=name, flag=flag, ref_id=ref_id, pos=pos, mapq=60 if mapped else 0,
                cigar_ops=np.array([0] if mapped else [], np.uint8),
                cigar_lens=np.array([len(arr)] if mapped else [], np.int32),
                bases=arr, quals=np.full(len(arr), 30, np.uint8))


def _fasta(path, records):
    with open(path, "w") as fh:
        for name, seq in records:
            fh.write(f">{name}\n{seq}\n")
    off = 0
    with open(str(path) + ".fai", "w") as fh:
        for name, seq in records:
            off += len(name) + 2
            fh.write(f"{name}\t{len(seq)}\t{off}\t{len(seq)}\t{len(seq) + 1}\n")
            off += len(seq) + 1
    return str(path)


@pytest.fixture(scope="module")
def inp(tmp_path_factory):
    """tests/test_pathseq.py's host and microbe: reads of both (two pairs each,
    and a pair of 80 A's for DUST), the host kmer library, a taxonomy, reads
    aligned to the microbes, and tests/test_new_tools_r4.py's taxonomy dump."""
    d = tmp_path_factory.mktemp("pathseq")
    rng = np.random.default_rng(1)
    host = "".join("ACGT"[i] for i in rng.integers(0, 4, 500))
    microbe = "".join("ACGT"[i] for i in rng.integers(0, 4, 500))
    inp = dict(host=host, microbe=microbe)
    inp["host_fa"] = _fasta(d / "host.fasta", [("host", host)])
    inp["microbe_fa"] = _fasta(d / "microbe.fasta", [("microbe1", microbe)])
    reads = [_read(f"host{i}", host[i * 40:i * 40 + 60]) for i in range(2) for _ in range(2)]
    reads += [_read(f"mic{i}", microbe[i * 40:i * 40 + 60]) for i in range(2) for _ in range(2)]
    reads += [_read("dust", "A" * 80) for _ in range(2)]
    inp["reads"] = _write_bam(d / "in.bam", reads)
    inp["kmers"] = str(d / "host.npz")
    assert TOOL_REGISTRY["PathSeqBuildKmers"](["-R", inp["host_fa"], "-O", inp["kmers"]]) == 0
    inp["tax"] = str(d / "tax.tsv")
    with open(inp["tax"], "w") as fh:
        fh.write("1\t1\troot\troot\t0\t\n10\t1\tgenus\tExamplea\t0\t\n"
                 "101\t10\tspecies\tExamplea one\t5000\tmicrobe1\n"
                 "102\t10\tspecies\tExamplea two\t800\tmicrobe2\n")
    aligned = [_read(f"t{i}", microbe[:60], ref_id=1, pos=10, flag=0) for i in range(3)]
    aligned.append(_read("t3", microbe[:60], ref_id=2, pos=10, flag=0))
    inp["aligned"] = _write_bam(d / "aligned.bam", aligned)
    rng = np.random.default_rng(5)
    s1 = "".join("ACGT"[i] for i in rng.integers(0, 4, 800))
    s2 = "".join("ACGT"[i] for i in rng.integers(0, 4, 300))
    inp["microbes_fa"] = _fasta(d / "microbes.fa", [("NC_001.1", s1), ("NC_002.1", s2)])
    inp["catalog"] = str(d / "refseq.catalog.gz")
    with gzip.open(inp["catalog"], "wt") as fh:
        fh.write("562\tEscherichia coli\tNC_001.1\n10710\tLambda virus\tNC_002.1\n")
    dump = d / "taxdump"
    dump.mkdir()
    (dump / "nodes.dmp").write_text("1\t|\t1\t|\tno rank\t|\n2\t|\t1\t|\tsuperkingdom\t|\n"
                                    "562\t|\t2\t|\tspecies\t|\n10239\t|\t1\t|\tsuperkingdom\t|\n"
                                    "10710\t|\t10239\t|\tspecies\t|\n")
    (dump / "names.dmp").write_text("".join(
        f"{t}\t|\t{n}\t|\t\t|\tscientific name\t|\n" for t, n in
        ((1, "root"), (2, "Bacteria"), (562, "Escherichia coli"), (10239, "Viruses"),
         (10710, "Lambda virus"))))
    inp["dump"] = str(dump)
    # DRAGstr: the chrM sample and an STR table of it
    inp.update(write_inputs(d / "sample"))
    inp["str_table"] = str(d / "str.zip")
    assert TOOL_REGISTRY["ComposeSTRTableFile"](["-R", inp["fasta"], "-O", inp["str_table"]]) == 0
    return inp


CASES = [
    ("PathSeqBuildKmers", ["-R", "{host_fa}", "-O", "{out}/host.npz", "--kmer-size", "21"],
     ["host.npz"]),
    ("PathSeqFilter", ["-I", "{reads}", "--paired-output", "{out}/f.bam", "--unpaired-output",
                       "{out}/u.bam", "--kmer-file", "{kmers}"], ["f.bam"]),
    ("PathSeqScore", ["--paired-input", "{aligned}", "--taxonomy-file", "{tax}",
                      "--scores-output", "{out}/scores.tsv", "--divide-by-genome-length"],
     ["scores.tsv"]),
    ("PathSeqAlign", ["-I", "{reads}", "-O", "{out}/a.bam", "--microbe-fasta", "{microbe_fa}"],
     ["a.bam"]),
    ("PathSeqBuildReferenceTaxonomy", ["-R", "{microbes_fa}", "-O", "{out}/taxonomy.db",
                                       "--refseq-catalog", "{catalog}", "--tax-dump", "{dump}",
                                       "--min-non-virus-contig-length", "500"], ["taxonomy.db"]),
    ("PathSeqFilterSpark", ["-I", "{reads}", "--paired-output", "{out}/f.bam",
                            "--kmer-file", "{kmers}"], ["f.bam"]),
    ("PathSeqScoreSpark", ["--paired-input", "{aligned}", "--taxonomy-file", "{tax}",
                           "--scores-output", "{out}/scores.tsv"], ["scores.tsv"]),
    ("PathSeqBwaSpark", ["-I", "{reads}", "-O", "{out}/a.bam", "--microbe-fasta",
                         "{microbe_fa}"], ["a.bam"]),
    ("ComposeSTRTableFile", ["-R", "{fasta}", "-O", "{out}/str.zip", "--decimation", "NONE"],
     ["str.zip"]),
    ("CalibrateDragstrModel", ["-I", "{bam}", "-R", "{fasta}", "-str", "{str_table}", "-O",
                               "{out}/params.txt", "--force-estimation", "--minimum-depth",
                               "5"], ["params.txt"]),
    ("CalibrateDragstrModel", ["-I", "{bam}", "-R", "{fasta}", "-str", "{str_table}", "-O",
                               "{out}/params.txt"], ["params.txt"]),
]


@pytest.mark.parametrize("case", CASES, ids=[f"{c[0]}-{k}" for k, c in enumerate(CASES)])
def test_tool_identical_to_jax(inp, tmp_path, case):
    tool, args, expect = case
    _, text, files = assert_identical(both(tmp_path, tool, args, **inp), expect)
    assert text or files


# ------------------------------------------- gatk_tpu's tests/test_pathseq.py, on the port


def test_canonical_kmers_revcomp_invariant():
    seq = np.frombuffer(b"ACGTTGCAACGTACGGTCAG", np.uint8)
    k1 = set(_canonical_kmers(seq, 11).tolist())
    assert k1 == set(_canonical_kmers(revcomp(seq), 11).tolist()) and k1
    seq_n = seq.copy()
    seq_n[5] = ord("N")
    assert len(_canonical_kmers(seq_n, 11)) < len(_canonical_kmers(seq, 11))


def test_dust_mask_low_complexity():
    rng = np.random.default_rng(0)
    bases = np.concatenate([rng.choice([65, 67, 71, 84], 64).astype(np.uint8),
                            np.full(64, ord("A"), np.uint8)])
    out = dust_mask(bases, np.full(len(bases), 30, np.uint8))
    assert (out[:64] == 30).all() and (out[64:] == 2).all()


def test_pathseq_filter_and_score(inp, tmp_path):
    out_bam = tmp_path / "filtered.bam"
    assert TOOL_REGISTRY["PathSeqFilter"](["-I", inp["reads"], "--paired-output", str(out_bam),
                                           "--kmer-file", inp["kmers"]]) == 0
    assert {r.name for r in bamio.BamReader(str(out_bam))} == {"mic0", "mic1"}
    scores = tmp_path / "scores.tsv"
    assert TOOL_REGISTRY["PathSeqScore"](["--paired-input", inp["aligned"], "--taxonomy-file",
                                          inp["tax"], "--scores-output", str(scores)]) == 0
    rows = {int(r[0]): r for r in (l.split("\t") for l in scores.read_text().splitlines()[1:])}
    assert [float(rows[t][3]) for t in (101, 102, 10, 1)] == [3.0, 1.0, 4.0, 4.0]
    assert abs(float(rows[101][4]) - 75.0) < 1e-6 and int(rows[101][6]) == 3


def test_seed_extend_aligner_synthetic():
    rng = np.random.default_rng(11)
    bases4 = np.frombuffer(b"ACGT", np.uint8)
    g1, g2 = rng.choice(bases4, 5000), rng.choice(bases4, 3000)
    aligner = SeedExtendAligner([("microbe1", g1), ("microbe2", g2)])
    a = aligner.align(g1[1000:1100])
    assert (a.contig_index, a.pos, a.is_reverse, a.nm) == (0, 1000, False, 0)
    read = g2[500:600].copy()
    for i in (10, 50, 90):
        read[i] = bases4[(np.searchsorted(bases4, read[i]) + 1) % 4]
    a = aligner.align(read)
    assert (a.contig_index, a.pos, a.nm) == (1, 500, 3)
    a = aligner.align(revcomp(g1[2000:2120]))
    assert (a.contig_index, a.pos, a.is_reverse) == (0, 2000, True)
    a = aligner.align(np.concatenate([g1[3000:3050], rng.choice(bases4, 4), g1[3050:3100]]))
    assert (a.contig_index, a.pos) == (0, 3000) and 1 in a.cigar_ops.tolist()
    assert aligner.align(rng.choice(bases4, 100)) is None


def test_pathseq_align_tool(tmp_path):
    rng = np.random.default_rng(3)
    genome = rng.choice(np.frombuffer(b"ACGT", np.uint8), 4000)
    fa = _fasta(tmp_path / "microbe.fasta", [("m1", genome.tobytes().decode())])
    reads = [_read(f"m{i}", genome[s:s + 120].copy()) for i, s in enumerate((100, 700, 1500))]
    reads.append(_read("junk", rng.choice(np.frombuffer(b"ACGT", np.uint8), 120)))
    src = _write_bam(tmp_path / "filtered.bam", reads, contigs=(("u", 1),))
    out = str(tmp_path / "aligned.bam")
    assert TOOL_REGISTRY["PathSeqAlign"](["-I", src, "-O", out, "--microbe-fasta", fa]) == 0
    got = {r.name: r for r in bamio.BamReader(out)}
    assert [got[f"m{i}"].pos for i in range(3)] == [100, 700, 1500]
    assert got["m0"].tags["NM"] == 0 and got["junk"].is_unmapped


def test_pathseq_build_reference_taxonomy(inp, tmp_path):
    out = str(tmp_path / "taxonomy.db")
    assert TOOL_REGISTRY["PathSeqBuildReferenceTaxonomy"](
        ["-R", inp["microbes_fa"], "-O", out, "--refseq-catalog", inp["catalog"],
         "--tax-dump", inp["dump"], "--min-non-virus-contig-length", "500"]) == 0
    nodes, acc = read_taxonomy(out)
    assert nodes[562]["length"] == 800 and acc["NC_001.1"] == 562
    assert nodes[10710]["length"] == 300 and 2 in nodes and 1 in nodes


def test_pathseq_pipeline_fault_is_carried_as_is(inp, tmp_path):
    """gatk_tpu's PathSeqPipelineSpark hands its last stage, PathSeqScore, a
    -I flag that PathSeqScore does not take (gatk_tpu/tools/pathseq_tools.py:497),
    so it exits with argparse's code 2 after it has filtered and aligned. The
    port's copy does the same, printing the same and writing the same files."""
    res = both(tmp_path, "PathSeqPipelineSpark",
               ["-I", "{reads}", "--kmer-file", "{kmers}", "--microbe-fasta", "{microbe_fa}",
                "--taxonomy-file", "{tax}", "--scores-output", "{out}/scores.tsv", "--output",
                "{out}/a.bam"], **inp)
    assert res["port"] == res["jax"]
    rc, _, files = res["port"]
    assert rc == ("raised", "SystemExit", "2") and sorted(files) == ["a.bam"]


# -------------------------------------------- gatk_tpu's tests/test_dragstr.py, on the port


def test_default_params_equal_jax(tmp_path):
    """The defaults table as gatk_tpu writes it (its golden is GATK's
    calibrate-dragstr-model-default-output.txt)."""
    a, b = str(tmp_path / "port.txt"), str(tmp_path / "jax.txt")
    dragstr.DragstrParams().write(a, [("estimatedOrDefaults", "defaults")])
    jax_dragstr.DragstrParams().write(b, [("estimatedOrDefaults", "defaults")])
    assert open(a).read() == open(b).read()


def test_params_round_trip(tmp_path):
    out = str(tmp_path / "params.txt")
    p = dragstr.DragstrParams()
    p.write(out)
    back = dragstr.DragstrParams.read(out)
    for k in ("gop", "gcp", "api"):
        np.testing.assert_allclose(getattr(back, k), getattr(p, k))


def _b(s):
    return np.frombuffer(s.encode(), np.uint8)


def test_analyze_strs():
    periods, repeats = dragstr.analyze_strs(_b("AAAAT"))
    assert periods[0] == 1 and (repeats[0], repeats[1], repeats[3]) == (4, 3, 1)
    periods, repeats = dragstr.analyze_strs(_b("ACACACGT"))
    assert periods[0] == 2 and repeats[0] == 3
    periods, repeats = dragstr.analyze_strs(_b("AGTAGTAGTC"))
    assert periods[0] == 3 and repeats[0] == 3
    assert dragstr.analyze_strs(_b("AAAAC"))[0][0] == 1


def test_find_and_decimate_loci():
    loci = dragstr.find_str_loci(_b("GC" + "ACACACACAC" + "GT" + "TTTTT" + "C"))
    ac = [l for l in loci if l[1] == 2 and l[2] == 5]
    assert ac and ac[0][0] == 1
    tt = [l for l in loci if l[1] == 1 and l[2] == 6]
    assert tt and tt[0][0] == 13
    assert len(dragstr.decimate_loci([(i, 2, 2, i + 4) for i in range(1024)])) == 2
    assert len(dragstr.decimate_loci([(i, 1, 10, i + 10) for i in range(100)])) == 100


def test_estimation_learns_error_rates():
    rng = np.random.default_rng(0)
    cases = {(1, r): [(30, int(rng.binomial(30, 0.002 if r <= 5 else 0.2))) for _ in range(100)]
             for r in range(1, 21)}
    params = dragstr.estimate_params(cases)
    assert params.gop[0, 19] < params.gop[0, 0] - 5
    gops = params.gop[0]
    assert all(a >= b - 1e-9 for a, b in zip(gops, gops[1:]))


def _make_read(pos, cigar):
    ops, lens, num = [], [], ""
    for ch in cigar:
        if ch.isdigit():
            num += ch
        else:
            ops.append("MIDNSHP=X".index(ch))
            lens.append(int(num))
            num = ""
    n = sum(l for o, l in zip(ops, lens) if "MIDNSHP=X"[o] in "MIS=X")
    return Read("r", 0, 0, pos, 60, np.array(ops, np.uint8), np.array(lens, np.int32),
                np.full(n, ord("A"), np.uint8), np.full(n, 30, np.uint8))


def test_collect_case():
    reads = [_make_read(90, "40M"), _make_read(90, "15M2I23M"), _make_read(90, "12M3D25M"),
             _make_read(104, "30M")]
    assert dragstr.collect_case(reads, 1000, 100, 110, padding=5) == (3, 2, 60, 0)


def test_compose_str_table_and_calibrate(inp, tmp_path):
    """The table holds the decimated STR loci of the reference;
    CalibrateDragstrModel writes the defaults without enough cases and
    estimates with --force-estimation."""
    from gatk_tpu_torch.io import fasta

    loci = dragstr.read_str_table(inp["str_table"])["chrM"]
    seq = fasta.FastaReference(inp["fasta"]).fetch("chrM")
    assert loci == dragstr.decimate_loci(dragstr.find_str_loci(seq)) and loci
    out = str(tmp_path / "p.txt")
    for extra, label in (([], "defaults"), (["--force-estimation"], "estimatedByForce")):
        assert TOOL_REGISTRY["CalibrateDragstrModel"](
            ["-I", inp["bam"], "-R", inp["fasta"], "-str", inp["str_table"], "-O", out]
            + extra) == 0
        assert f"# estimatedOrDefaults = {label}\n" in open(out).read()
