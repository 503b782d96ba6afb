"""The port's copies of gatk_tpu's SAM, FASTA and utility tools
(tools/sam_tools.py, tools/util_tools.py, tools/fasta_tools.py) against
gatk_tpu's, on the CPU.

Each tool runs through both packages' registries on the synthetic inputs of
tests/torch_tool_cases.py, and the return code, what it prints and every file
it writes must be byte-identical (the aligner's .img, an .npz, member by
member). Then the
behavioural checks of gatk_tpu's tests/test_sam_fasta_tools.py and
tests/test_util_tools.py, which read the mito data of the reference bundle,
run on the port's outputs.
"""
import hashlib
import os
import re
from collections import Counter

import numpy as np
import pytest

from gatk_tpu_torch.io import bam, bgzf, fasta, sam, vcf
from tests.torch_tool_cases import assert_identical, both, write_inputs


@pytest.fixture(scope="module")
def inp(tmp_path_factory):
    d = tmp_path_factory.mktemp("samfasta")
    inp = write_inputs(d)
    inp["calls_gz"] = str(d / "calls.vcf.gz")
    with open(inp["calls_gz"], "wb") as fh:
        fh.write(bgzf.compress_bytes(open(inp["calls"], "rb").read()))
    return inp


# id, tool, its arguments ({out} the run's directory; the inputs' keys), the
# files it must write there, and the inputs copied there first
CASES = [
    ("MergeSamFiles", ["-I", "{bam}", "-I", "{paired}", "-O", "{out}/m.bam"], ["m.bam"]),
    ("RevertSam", ["-I", "{paired}", "-O", "{out}/r.bam"], ["r.bam"]),
    ("ValidateSamFile", ["-I", "{paired}", "-M", "VERBOSE"], []),
    ("BuildBamIndex", ["-I", "{out}/in.bam"], ["in.bam.bai"], {"in.bam": "{paired}"}),
    ("GetSampleName", ["-I", "{bam}", "-O", "{out}/name.txt"], ["name.txt"]),
    ("CountBases", ["-I", "{bam}"], []),
    ("DownsampleSam", ["-I", "{paired}", "-O", "{out}/d.bam", "-P", "0.5", "-R", "7"], ["d.bam"]),
    ("UnmarkDuplicates", ["-I", "{bam}", "-O", "{out}/u.bam"], ["u.bam"]),
    ("FixMateInformation", ["-I", "{paired}", "-O", "{out}/f.bam"], ["f.bam"]),
    ("SetNmMdAndUqTags", ["-I", "{bam}", "-O", "{out}/t.bam", "-R", "{fasta}"], ["t.bam"]),
    ("SplitReads", ["-I", "{paired}", "-O", "{out}", "--split-sample", "--split-library-name"],
     []),
    ("SplitSamByNumberOfReads", ["-I", "{paired}", "-O", "{out}/shards",
                                 "--split-to-n-reads", "250"], ["shards/shard_0001.bam"]),
    ("ClipReads", ["-I", "{bam}", "-O", "{out}/c.bam", "-QT", "25", "-CT", "1-5"], ["c.bam"]),
    ("BamIndexStats", ["-I", "{paired}"], []),
    ("BwaSpark", ["-I", "{unaligned}", "-R", "{fasta}", "-O", "{out}/a.bam"], ["a.bam"]),
    ("BwaAndMarkDuplicatesPipelineSpark", ["-I", "{unaligned}", "-R", "{fasta}",
                                           "-O", "{out}/am.bam"], ["am.bam", "am.bam.metrics"]),
    ("CompareDuplicatesSpark", ["-I", "{bam}", "-I2", "{bam}", "-O", "{out}/cd.txt"], ["cd.txt"]),
    ("SamToFastq", ["-I", "{paired}", "-F", "{out}/1.fq", "-F2", "{out}/2.fq"], ["1.fq", "2.fq"]),
    ("FastqToSam", ["-F1", "{fastq1}", "-F2", "{fastq2}", "-O", "{out}/u.bam", "-SM", "S2"],
     ["u.bam"]),
    ("AddOrReplaceReadGroups", ["-I", "{bam}", "-O", "{out}/rg.bam", "-ID", "rg9", "-LB", "lib9",
                                "-PL", "ILLUMINA", "-PU", "unit9", "-SM", "S9"], ["rg.bam"]),
    ("BedToIntervalList", ["-I", "{bed}", "-SD", "{dict}", "-O", "{out}/b.interval_list"],
     ["b.interval_list"]),
    ("IntervalListTools", ["-I", "{ilist}", "-SI", "{ilist2}", "--action", "SUBTRACT",
                           "-O", "{out}/s.interval_list"], ["s.interval_list"]),
    ("CollectWgsMetrics", ["-I", "{bam}", "-R", "{fasta}", "-O", "{out}/wgs.txt"], ["wgs.txt"]),
    ("UpdateVCFSequenceDictionary", ["-V", "{known_sites}", "--source-dictionary", "{dict}",
                                     "-O", "{out}/u.vcf"], ["u.vcf"]),
    ("RenameSampleInVcf", ["-I", "{calls}", "-O", "{out}/r.vcf", "--new-sample-name", "NEW"],
     ["r.vcf"]),
    ("SplitVcfs", ["-I", "{calls}", "--snp-output", "{out}/snp.vcf", "--indel-output",
                   "{out}/indel.vcf"], ["snp.vcf", "indel.vcf"]),
    ("IndexFeatureFile", ["-I", "{out}/c.vcf.gz"], ["c.vcf.gz.tbi"], {"c.vcf.gz": "{calls_gz}"}),
    ("PrintFileDiagnostics", ["-I", "{paired}", "-O", "{out}/diag.txt"], ["diag.txt"]),
    ("BwaMemIndexImageCreator", ["-I", "{fasta}", "-O", "{out}/ref.img"], ["ref.img"]),
    ("CreateSequenceDictionary", ["-R", "{fasta}", "-O", "{out}/ref.dict"], ["ref.dict"]),
    ("NormalizeFasta", ["-I", "{fasta}", "-O", "{out}/n.fa", "--line-length", "70"], ["n.fa"]),
    ("FastaReferenceMaker", ["-R", "{fasta}", "-O", "{out}/r.fa", "-L", "chrM:101-900"],
     ["r.fa"]),
    ("FastaAlternateReferenceMaker", ["-R", "{fasta}", "-O", "{out}/alt.fa", "-V", "{calls}"],
     ["alt.fa"]),
    ("ShiftFasta", ["-R", "{fasta}", "-O", "{out}/shifted.fa"], ["shifted.fa"]),
]
# the aliases of these tools run the same function
ALIASES = [("CountBasesSpark", "CountBases"), ("RevertSamSpark", "RevertSam")]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_tool_identical_to_jax(inp, tmp_path, case):
    tool, args, expect, inputs = (case + ({},))[:4]
    _, text, files = assert_identical(both(tmp_path, tool, args, inputs, **inp), expect)
    assert text or files


@pytest.mark.parametrize("alias,tool", ALIASES)
def test_spark_alias_runs_its_tool(inp, tmp_path, alias, tool):
    argv = {"CountBases": ["-I", "{bam}"],
            "RevertSam": ["-I", "{paired}", "-O", "{out}/r.bam"]}[tool]
    a = both(tmp_path / "a", alias, argv, **inp)
    b = both(tmp_path / "b", tool, argv, **inp)
    assert a["port"][0] == 0 and a["port"][2] == b["port"][2]
    assert a["port"][1].replace("/a/", "/b/") == b["port"][1]


# ----------------------------------------------- gatk_tpu's behavioural checks, on the port


def _port(tool, argv, capsys=None):
    from gatk_tpu_torch.cli import TOOL_REGISTRY

    rc = TOOL_REGISTRY[tool](argv)
    return rc, (capsys.readouterr().out if capsys else None)


def _reads(path):
    return list(bam.BamReader(path))


def test_split_and_merge_roundtrip(inp, tmp_path):
    shards = str(tmp_path / "shards")
    assert _port("SplitSamByNumberOfReads", ["-I", inp["paired"], "-O", shards,
                                             "--split-to-n-reads", "250"])[0] == 0
    names = sorted(os.listdir(shards))
    src = _reads(inp["paired"])
    assert len(names) == -(-len(src) // 250)
    merged = str(tmp_path / "merged.bam")
    argv = ["-O", merged] + [x for n in names for x in ("-I", os.path.join(shards, n))]
    assert _port("MergeSamFiles", argv)[0] == 0
    got = _reads(merged)
    assert len(got) == len(src)
    assert [r.pos for r in got] == sorted(r.pos for r in src)


def test_revert_sam(inp, tmp_path):
    out = str(tmp_path / "r.bam")
    assert _port("RevertSam", ["-I", inp["paired"], "-O", out])[0] == 0
    got = _reads(out)
    names = [r.name for r in got]
    assert len(got) == len(_reads(inp["paired"])) and names == sorted(names)
    for r in got:
        assert r.is_unmapped and r.pos == -1 and r.mapq == 0 and len(r.cigar_ops) == 0
        assert "MC" not in r.tags and "OQ" not in r.tags


def test_validate_sam_file_clean_and_dirty(inp, tmp_path, capsys):
    assert _port("ValidateSamFile", ["-I", inp["paired"]], capsys) == (0, "No errors found\n")
    reader = bam.BamReader(inp["paired"])
    bad = str(tmp_path / "bad.bam")
    w = bam.BamWriter(bad, reader.header)
    for i, r in enumerate(reader):
        if i == 10:
            r.cigar_ops = np.array([0], np.uint8)
            r.cigar_lens = np.array([len(r.bases) + 5], np.int32)
        w.write(r)
    w.close()
    rc, text = _port("ValidateSamFile", ["-I", bad], capsys)
    assert rc == 2 and "INVALID_CIGAR" in text


def test_build_bam_index_queries_match_a_scan(inp, tmp_path):
    src = str(tmp_path / "p.bam")
    with open(inp["paired"], "rb") as a, open(src, "wb") as b:
        b.write(a.read())
    assert _port("BuildBamIndex", ["-I", src])[0] == 0
    reader = bam.BamReader(src)
    assert reader.index is not None
    every = _reads(src)
    for lo, hi in ((0, 100), (400, 800), (1500, 1600), (2900, 3000)):
        got = [(r.name, r.pos) for r in reader.query("chrM", lo, hi)]
        want = [(r.name, r.pos) for r in every if r.pos < hi and r.end > lo]
        assert got == want, (lo, hi)
    assert reader.index.meta[0][1][0] == len(every)


def test_fix_mate_information(inp, tmp_path):
    reader = bam.BamReader(inp["paired"])
    scrambled = str(tmp_path / "scrambled.bam")
    w = bam.BamWriter(scrambled, reader.header)
    originals = {}
    for r in reader:
        originals.setdefault(r.name, {})[r.flag & 0x40] = (r.mate_pos, r.tlen)
        r.mate_pos, r.tlen = 0, 0
        w.write(r)
    w.close()
    out = str(tmp_path / "fixed.bam")
    assert _port("FixMateInformation", ["-I", scrambled, "-O", out])[0] == 0
    got = {}
    for r in _reads(out):
        got.setdefault(r.name, {})[r.flag & 0x40] = (r.mate_pos, r.tlen)
    assert got == originals


def test_set_nm_md_uq_tags(inp, tmp_path):
    """NM equals an independent count of the edits, and MD's matches,
    mismatches and deleted bases cover the reference span."""
    out = str(tmp_path / "tagged.bam")
    assert _port("SetNmMdAndUqTags", ["-I", inp["bam"], "-O", out, "-R", inp["fasta"]])[0] == 0
    ref = fasta.FastaReference(inp["fasta"])
    checked = 0
    for r in _reads(out):
        span = sam.cigar_ref_length(r.cigar_ops, r.cigar_lens)
        rb = ref.fetch("chrM", r.pos, r.pos + span)
        nm = ri = qi = 0
        for op, ln in zip(r.cigar_ops, r.cigar_lens):
            op, ln = int(op), int(ln)
            if op in (sam.OP_M, sam.OP_EQ, sam.OP_X):
                nm += int(np.count_nonzero(rb[ri:ri + ln] != r.bases[qi:qi + ln]))
                ri, qi = ri + ln, qi + ln
            elif op == sam.OP_I:
                nm, qi = nm + ln, qi + ln
            elif op == sam.OP_D:
                nm, ri = nm + ln, ri + ln
            elif op == sam.OP_S:
                qi += ln
        assert r.tags["NM"] == nm, r.name
        md = r.tags["MD"]
        dels = sum(len(x) - 1 for x in re.findall(r"\^[ACGTN]+", md))
        stripped = re.sub(r"\^[ACGTN]+", " ", md)
        matches = sum(int(x) for x in re.findall(r"\d+", stripped))
        assert matches + len(re.findall(r"[ACGTN]", stripped)) + dels == span
        assert "UQ" in r.tags
        checked += 1
    assert checked == 1020


def test_downsample_sam_is_deterministic_and_keeps_pairs(inp, tmp_path):
    kept = []
    for k in range(2):
        out = str(tmp_path / f"d{k}.bam")
        assert _port("DownsampleSam", ["-I", inp["paired"], "-O", out, "-P", "0.5"])[0] == 0
        kept.append([r.name for r in _reads(out)])
    assert kept[0] == kept[1]
    n = len(_reads(inp["paired"]))
    assert 0.35 * n < len(kept[0]) < 0.65 * n
    assert set(Counter(kept[0]).values()) == {2}


def test_get_sample_name_and_count_bases(inp, capsys):
    assert _port("GetSampleName", ["-I", inp["bam"]], capsys)[1].strip().endswith("SYN1")
    rc, text = _port("CountBases", ["-I", inp["bam"]], capsys)
    assert int(text.strip()) == sum(len(r.bases) for r in _reads(inp["bam"]))


def test_create_sequence_dictionary(inp, tmp_path):
    out = str(tmp_path / "r.dict")
    assert _port("CreateSequenceDictionary", ["-R", inp["fasta"], "-O", out])[0] == 0
    seq = fasta.FastaReference(inp["fasta"]).fetch("chrM").tobytes().upper()
    text = open(out).read()
    assert "SN:chrM\tLN:3000" in text and f"M5:{hashlib.md5(seq).hexdigest()}" in text


def test_shift_fasta_roundtrip(inp, tmp_path):
    out = str(tmp_path / "shifted.fa")
    assert _port("ShiftFasta", ["-R", inp["fasta"], "-O", out])[0] == 0
    o = fasta.FastaReference(inp["fasta"]).fetch("chrM")
    s = fasta.FastaReference(out).fetch("chrM")
    off = len(o) // 2
    assert np.array_equal(s, np.concatenate([o[off:], o[:off]]))
    assert open(out + ".shiftback.chain").read().startswith("chain")


def test_fasta_alternate_reference_maker_applies_the_snvs(inp, tmp_path):
    out = str(tmp_path / "alt.fa")
    assert _port("FastaAlternateReferenceMaker",
                 ["-R", inp["fasta"], "-O", out, "-V", inp["calls"]])[0] == 0
    got = fasta.FastaReference(out).fetch("chrM")
    orig = fasta.FastaReference(inp["fasta"]).fetch("chrM")
    first = min(v.pos for v in inp["variants"])
    assert np.array_equal(got[:first], orig[:first])
    shift = 0
    for v in sorted(inp["variants"], key=lambda v: v.pos):
        if v.is_snv:
            assert chr(got[v.pos + shift]) == v.alt
        shift += len(v.alt) - len(v.ref)
    assert len(got) == len(orig) + shift


def test_sam_to_fastq_and_back(inp, tmp_path):
    f1, f2 = str(tmp_path / "1.fq"), str(tmp_path / "2.fq")
    assert _port("SamToFastq", ["-I", inp["paired"], "-F", f1, "-F2", f2])[0] == 0
    lines = open(f1).read().splitlines()
    assert len(lines) == 4 * len(_reads(inp["paired"])) // 2 and lines[2] == "+"
    out = str(tmp_path / "u.bam")
    assert _port("FastqToSam", ["-F1", f1, "-F2", f2, "-O", out, "-SM", "sampleX"])[0] == 0
    reader = bam.BamReader(out)
    assert reader.header.read_groups[0]["SM"] == "sampleX"
    got = list(reader)
    assert len(got) == len(lines) // 2 and all(r.is_unmapped for r in got)
    by_name = {(r.name, bool(r.flag & 0x40)): r.bases.tobytes() for r in _reads(inp["unaligned"])}
    assert all(by_name[(r.name, bool(r.flag & 0x40))] == r.bases.tobytes() for r in got)


def test_add_or_replace_read_groups(inp, tmp_path):
    out = str(tmp_path / "rg.bam")
    assert _port("AddOrReplaceReadGroups", ["-I", inp["bam"], "-O", out, "-ID", "rg1", "-LB",
                                            "lib1", "-PL", "ILLUMINA", "-PU", "unit1", "-SM",
                                            "newsample"])[0] == 0
    reader = bam.BamReader(out)
    assert reader.header.read_groups == [{"ID": "rg1", "LB": "lib1", "PL": "ILLUMINA",
                                          "PU": "unit1", "SM": "newsample"}]
    assert all(r.tags["RG"] == "rg1" for r in reader)


def test_bed_to_interval_list_and_interval_tools(inp, tmp_path):
    il = str(tmp_path / "t.interval_list")
    assert _port("BedToIntervalList", ["-I", inp["bed"], "-SD", inp["dict"], "-O", il])[0] == 0
    body = [l.split("\t") for l in open(il) if not l.startswith("@")]
    assert [b[:3] for b in body] == [["chrM", "101", "1200"], ["chrM", "1501", "2600"]]
    got = {}
    for action in ("INTERSECT", "SUBTRACT"):
        out = str(tmp_path / f"{action}.interval_list")
        assert _port("IntervalListTools", ["-I", il, "-SI", inp["ilist2"], "--action", action,
                                           "-O", out])[0] == 0
        got[action] = [tuple(l.split("\t")[:3]) for l in open(out) if not l.startswith("@")]
    assert got["INTERSECT"] == [("chrM", "801", "1200"), ("chrM", "1501", "2000")]
    assert got["SUBTRACT"] == [("chrM", "101", "800"), ("chrM", "2001", "2600")]


def test_collect_wgs_metrics(inp, tmp_path):
    out = str(tmp_path / "wgs.txt")
    assert _port("CollectWgsMetrics", ["-I", inp["bam"], "-O", out])[0] == 0
    lines = open(out).read().splitlines()
    cols = next(l for l in lines if l.startswith("GENOME_TERRITORY")).split("\t")
    row = lines[lines.index("\t".join(cols)) + 1].split("\t")
    assert int(row[0]) == 3000
    depth = sum(len(r.bases) for r in _reads(inp["bam"])) / 3000
    assert 0 < float(row[cols.index("MEAN_COVERAGE")]) <= depth


def test_vcf_utilities(inp, tmp_path):
    renamed = str(tmp_path / "r.vcf")
    assert _port("RenameSampleInVcf", ["-I", inp["calls"], "-O", renamed,
                                       "--new-sample-name", "new_name"])[0] == 0
    assert vcf.VcfReader(renamed).samples == ["new_name"]
    snp, indel = str(tmp_path / "snp.vcf"), str(tmp_path / "indel.vcf")
    assert _port("SplitVcfs", ["-I", inp["calls"], "--snp-output", snp,
                               "--indel-output", indel])[0] == 0
    n_snv = sum(v.is_snv for v in inp["variants"])
    assert len(list(vcf.VcfReader(snp))) == n_snv
    assert len(list(vcf.VcfReader(indel))) == len(inp["variants"]) - n_snv
    upd = str(tmp_path / "u.vcf")
    assert _port("UpdateVCFSequenceDictionary", ["-V", inp["calls"], "--source-dictionary",
                                                 inp["dict"], "-O", upd])[0] == 0
    assert "##contig=<ID=chrM,length=3000>" in open(upd).read()


def test_index_feature_file_queries(inp, tmp_path):
    from gatk_tpu_torch.io import tabix

    src = str(tmp_path / "c.vcf.gz")
    with open(inp["calls_gz"], "rb") as a, open(src, "wb") as b:
        b.write(a.read())
    assert _port("IndexFeatureFile", ["-I", src])[0] == 0
    idx = tabix.TbxIndex(src + ".tbi")
    assert idx.names == ["chrM"]


def test_print_file_diagnostics_and_index_image(inp, tmp_path):
    out = str(tmp_path / "diag.txt")
    assert _port("PrintFileDiagnostics", ["-I", inp["calls"], "-O", out])[0] == 0
    text = open(out).read()
    assert "VCF file" in text and "samples: 1" in text
    img = str(tmp_path / "r.img")
    assert _port("BwaMemIndexImageCreator", ["-I", inp["fasta"], "-O", img])[0] == 0
    z = np.load(img)
    assert list(z["names"]) == ["chrM"] and int(z["k"]) == 21 and len(z["ref"]) == 3000


def test_bwa_spark_places_each_read_at_its_origin(inp, tmp_path):
    out = str(tmp_path / "a.bam")
    assert _port("BwaSpark", ["-I", inp["unaligned"], "-R", inp["fasta"], "-O", out])[0] == 0
    origin = {}
    for r in _reads(inp["paired"]):
        origin.setdefault(r.name, set()).add(r.pos)
    got = _reads(out)
    placed = [r for r in got if not r.is_unmapped]
    assert len(got) == 2 * len(origin) and len(placed) >= 0.95 * len(got)
    assert sum(r.pos in origin[r.name] for r in placed) >= 0.95 * len(placed)
    assert _port("CompareDuplicatesSpark", ["-I", out, "-I2", out])[0] == 0


def test_clip_reads_and_unmark_duplicates(inp, tmp_path):
    out = str(tmp_path / "c.bam")
    assert _port("ClipReads", ["-I", inp["bam"], "-O", out, "-QT", "2"])[0] == 0
    assert len(_reads(out)) > 0
    out2 = str(tmp_path / "u.bam")
    assert _port("UnmarkDuplicates", ["-I", inp["bam"], "-O", out2])[0] == 0
    assert not any(r.is_duplicate for r in _reads(out2))


def test_split_reads_by_sample(inp, tmp_path):
    outdir = tmp_path / "split"
    outdir.mkdir()
    assert _port("SplitReads", ["-I", inp["bam"], "-O", str(outdir), "--split-sample"])[0] == 0
    files = os.listdir(outdir)
    assert len(files) == 1 and "SYN1" in files[0]
    assert len(_reads(str(outdir / files[0]))) == len(_reads(inp["bam"]))
