"""The port's copies of gatk_tpu's Picard tools (tools/picard_tools.py,
tools/picard_tools2.py) against gatk_tpu's, on the CPU.

Each tool runs through both packages' registries on the synthetic inputs of
tests/torch_tool_cases.py (and a few small files written here: a refFlat, a
GFF, metrics files, VCF shards), and the return code, what it prints and every
file it writes must be byte-identical. Then gatk_tpu's
tests/test_picard_tools_r5.py and tests/test_picard_tools2.py, which skip
without the mito data of the reference bundle, run on the port: their
hand-built BAMs and VCFs as they are, and the synthetic sample where they read
the mito BAM.
"""
import io
import os
import struct
import subprocess
import sys

import numpy as np
import pytest

from gatk_tpu_torch.cli import TOOL_REGISTRY
from gatk_tpu_torch.io import bam, sam, vcf
from gatk_tpu_torch.io.reads import Read
from gatk_tpu_torch.tools.metrics_tools import write_metrics_file
from tests.torch_tool_cases import REGISTRIES, assert_identical, both, write_inputs


def _vcf(path, rows, samples=("S",)):
    """rows: (contig, pos, ref, alt, gt or None); pos is VCF's (1-based)."""
    w = vcf.VcfWriter(str(path), list(samples))
    for contig, pos, ref, alt, gt in rows:
        w.write(vcf.Variant(contig=contig, pos=pos - 1, ref=ref, alts=(alt,), qual=50.0,
                            filters=(), info={}, fmt_keys=("GT",) if samples else (),
                            samples=[{"GT": gt}] if samples else []))
    w.close()
    return str(path)


@pytest.fixture(scope="module")
def inp(tmp_path_factory):
    d = tmp_path_factory.mktemp("picard")
    inp = write_inputs(d)
    snvs = [v for v in inp["variants"] if v.is_snv]
    inp["truth"] = _vcf(d / "truth.vcf", [("chrM", v.pos + 1, v.ref, v.alt, gt) for v, gt in
                                          zip(snvs, ("0/1", "1/1", "0/1", "0/1"))]
                        + [("chrM", 2950, "A", "G", "0/1")], samples=("SYN1",))
    inp["bare"] = str(d / "bare.vcf")
    with open(inp["bare"], "w") as fh:
        fh.write("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS\n"
                 "chrM\t10\t.\tA\tG\t10\tweird_filter\tMYKEY=1\tGT:XX\t0/1:z\n")
    rows = [l for l in open(inp["calls"]) if not l.startswith("#")]
    head = "".join(l for l in open(inp["calls"]) if l.startswith("#"))
    for k, part in enumerate((rows[:4], rows[3:])):  # shards that share a record
        inp[f"part{k}"] = str(d / f"part{k}.g.vcf")
        open(inp[f"part{k}"], "w").write(head + "".join(part))
    inp["refflat"] = str(d / "refFlat.txt")
    with open(inp["refflat"], "w") as fh:
        fh.write("G1\tNM_1\tchrM\t+\t100\t1400\t200\t1300\t2\t100,800,\t600,1400,\n"
                 "G2\tNM_2\tchrM\t-\t1800\t2800\t1900\t2700\t1\t1800,\t2800,\n")
    inp["gff"] = str(d / "in.gff3")
    with open(inp["gff"], "w") as fh:
        fh.write("##gff-version 3\nchr2\t.\tgene\t500\t900\t.\t+\t.\tID=g2\n"
                 "chrM\t.\tgene\t300\t400\t.\t+\t.\tID=g1\n"
                 "chrM\t.\tgene\t100\t200\t.\t+\t.\tID=g0\n")
    cols = ["TOTAL_READS", "PF_READS", "TOTAL_BASES"]
    for k, row in enumerate(([10, 9, 1000], [5, 5, 500])):
        inp[f"qy{k}"] = str(d / f"qy{k}.txt")
        write_metrics_file(inp[f"qy{k}"], "x", "picard.analysis.QualityYieldMetrics", cols, [row])
    cols = ["TOTAL_SNPS", "NUM_IN_DB_SNP", "NOVEL_SNPS", "PCT_DBSNP"]
    for k, (tot, known) in enumerate(((10, 4), (30, 6))):
        inp[f"vc{k}"] = str(d / f"vc{k}")
        write_metrics_file(inp[f"vc{k}"] + ".variant_calling_summary_metrics",
                           "CollectVariantCallingMetrics",
                           "picard.vcf.CollectVariantCallingMetrics$VariantCallingSummaryMetrics",
                           cols, [[tot, known, tot - known, known / tot]])
    inp["cc"] = str(d / "cc.txt")
    with open(inp["cc"], "w") as fh:
        fh.write("LEFT_SAMPLE\tRIGHT_SAMPLE\tLOD_SCORE\ns1\ts2\t12.0\ns1\ts3\t-30.0\n"
                 "s2\ts3\t-28.0\n")
    inp["names"] = str(d / "names.txt")
    with open(inp["names"], "w") as fh:
        fh.write("p00001\np00002\np00010\n")
    inp["artifact"] = str(d / "art")
    assert TOOL_REGISTRY["CollectSequencingArtifactMetrics"](
        ["-I", inp["paired"], "-R", inp["fasta"], "-O", inp["artifact"]]) == 0
    return inp


CASES = [
    ("MakeSitesOnlyVcf", ["-I", "{calls}", "-O", "{out}/s.vcf"], ["s.vcf"]),
    ("VcfToIntervalList", ["-I", "{calls}", "-O", "{out}/v.interval_list"], ["v.interval_list"]),
    ("UpdateVcfSequenceDictionary", ["-I", "{calls}", "-O", "{out}/u.vcf", "-SD", "{paired}"],
     ["u.vcf"]),
    ("VcfFormatConverter", ["-I", "{calls}", "-O", "{out}/c.vcf.gz"], ["c.vcf.gz"]),
    ("FilterVcf", ["-I", "{calls}", "-O", "{out}/f.vcf", "--MIN_DP", "44", "--MIN_AB", "0.46"],
     ["f.vcf"]),
    ("IntervalListToBed", ["-I", "{ilist}", "-O", "{out}/i.bed"], ["i.bed"]),
    ("LiftOverIntervalList", ["-I", "{ilist}", "-O", "{out}/l.interval_list", "--CHAIN",
                              "{chain}"], ["l.interval_list"]),
    ("CleanSam", ["-I", "{paired}", "-O", "{out}/c.bam"], ["c.bam"]),
    ("ReorderSam", ["-I", "{bam}", "-O", "{out}/r.bam", "-SD", "{dict}"], ["r.bam"]),
    ("FilterSamReads", ["-I", "{paired}", "-O", "{out}/f.bam", "--FILTER", "excludeReadList",
                        "--READ_LIST_FILE", "{names}"], ["f.bam"]),
    ("SamFormatConverter", ["-I", "{paired}", "-O", "{out}/p.sam"], ["p.sam"]),
    ("SplitSamByLibrary", ["-I", "{paired}", "-O", "{out}/lib"], ["lib/lib1.bam"]),
    ("PositionBasedDownsampleSam", ["-I", "{paired}", "-O", "{out}/d.bam", "-F", "0.4"], ["d.bam"]),
    ("CalculateReadGroupChecksum", ["-I", "{paired}", "-O", "{out}/md5.txt"], ["md5.txt"]),
    ("CollectDuplicateMetrics", ["-I", "{bam}", "-M", "{out}/dup.txt"], ["dup.txt"]),
    ("AccumulateQualityYieldMetrics", ["-I", "{qy0}", "-I", "{qy1}", "-O", "{out}/q.txt"],
     ["q.txt"]),
    ("MarkDuplicatesWithMateCigar", ["-I", "{paired}", "-O", "{out}/md.bam", "-M",
                                     "{out}/md.txt"], ["md.bam", "md.txt"]),
    ("UmiAwareMarkDuplicatesWithMateCigar", ["-I", "{paired}", "-O", "{out}/umi.bam", "-M",
                                             "{out}/umi.txt"], ["umi.bam", "umi.txt"]),
    ("MarkIlluminaAdapters", ["-I", "{unaligned}", "-O", "{out}/a.bam", "-M", "{out}/a.txt"],
     ["a.bam", "a.txt"]),
    ("MergeBamAlignment", ["--ALIGNED_BAM", "{paired}", "--UNMAPPED_BAM", "{unaligned}",
                           "-O", "{out}/m.bam", "-R", "{fasta}"], ["m.bam"]),
    ("CollectRnaSeqMetrics", ["-I", "{paired}", "-O", "{out}/rna.txt", "--REF_FLAT", "{refflat}",
                              "--RIBOSOMAL_INTERVALS", "{ilist2}"], ["rna.txt"]),
    ("GenotypeConcordance", ["--CALL_VCF", "{calls}", "--TRUTH_VCF", "{truth}", "-O", "{out}/gc"],
     ["gc.genotype_concordance_summary_metrics"]),
    ("ExtractFingerprint", ["-I", "{bam}", "-O", "{out}/fp.vcf", "-H", "{hapmap}", "-R",
                            "{fasta}"], ["fp.vcf"]),
    ("CheckFingerprint", ["-I", "{bam}", "-G", "{calls}", "-H", "{hapmap}", "-O", "{out}/chk"],
     ["chk.fingerprinting_summary_metrics"]),
    ("ViewSam", ["-I", "{paired}", "--ALIGNMENT_STATUS", "Aligned"], []),
    ("CompareSAMs", ["{paired}", "{paired}", "-O", "{out}/cmp.txt"], ["cmp.txt"]),
    ("CheckTerminatorBlock", ["-I", "{paired}"], []),
    ("FixVcfHeader", ["-I", "{bare}", "-O", "{out}/fixed.vcf"], ["fixed.vcf"]),
    ("GatherGvcfs", ["-I", "{part0}", "-I", "{part1}", "-O", "{out}/g.vcf"], ["g.vcf"]),
    ("CollectVariantCallingMetrics", ["-I", "{calls}", "--DBSNP", "{known_sites}", "-O",
                                      "{out}/vc"], ["vc.variant_calling_summary_metrics"]),
    ("ExtractSequences", ["--INTERVAL_LIST", "{ilist}", "-R", "{fasta}", "-O", "{out}/x.fa"],
     ["x.fa"]),
    ("NonNFastaSize", ["-I", "{fasta}", "-O", "{out}/n.txt"], ["n.txt"]),
    ("AddCommentsToBam", ["-I", "{bam}", "-O", "{out}/co.bam", "-C", "hello world"], ["co.bam"]),
    ("ReplaceSamHeader", ["-I", "{bam}", "--HEADER", "{paired}", "-O", "{out}/rh.bam"],
     ["rh.bam"]),
    ("SetNmAndUqTags", ["-I", "{bam}", "-O", "{out}/t.bam", "-R", "{fasta}"], ["t.bam"]),
    ("AddOATag", ["-I", "{bam}", "-O", "{out}/oa.bam"], ["oa.bam"]),
    ("RevertOriginalBaseQualitiesAndAddMateCigar", ["-I", "{paired}", "-O", "{out}/rq.bam"],
     ["rq.bam"]),
    ("CollectJumpingLibraryMetrics", ["-I", "{paired}", "-O", "{out}/jump.txt"], ["jump.txt"]),
    ("CollectRawWgsMetrics", ["-I", "{bam}", "-R", "{fasta}", "-O", "{out}/raw.txt"],
     ["raw.txt"]),
    ("CollectWgsMetricsWithNonZeroCoverage", ["-I", "{paired}", "-O", "{out}/nz.txt"],
     ["nz.txt"]),
    ("SimpleMarkDuplicatesWithMateCigar", ["-I", "{paired}", "-O", "{out}/smd.bam",
                                           "--metrics-file", "{out}/smd.txt"], ["smd.bam"]),
    ("CompareMetrics", ["{qy0}", "{qy0}"], []),
    ("CrosscheckReadGroupFingerprints", ["-I", "{bam}", "-I", "{paired}", "--haplotype-map",
                                         "{known_sites}",
                                         "-O", "{out}/cc.txt"], ["cc.txt"]),
    ("ClusterCrosscheckMetrics", ["-I", "{cc}", "-O", "{out}/clusters.txt"], ["clusters.txt"]),
    ("SortGff", ["-I", "{gff}", "-O", "{out}/s.gff3", "-SD", "{dict}"], ["s.gff3"]),
    ("AccumulateVariantCallingMetrics", ["-I", "{vc0}", "-I", "{vc1}", "-O", "{out}/merged"],
     ["merged.variant_calling_summary_metrics"]),
    ("ConvertSequencingArtifactToOxoG", ["-I", "{artifact}", "-O", "{out}/oxog.txt"],
     ["oxog.txt"]),
    ("CollectSamErrorMetrics", ["-I", "{paired}", "-R", "{fasta}", "-O", "{out}/err"],
     ["err.error_summary_metrics"]),
    ("LiftOverHaplotypeMap", ["-I", "{hapmap}", "-O", "{out}/h.map", "-C", "{chain}"], ["h.map"]),
    ("BamToBfq", ["-I", "{paired}", "--ANALYSIS_DIR", "{out}/bfq", "--FLOWCELL_BARCODE", "fc",
                  "--PAIRED_RUN"], ["bfq/fc.1.1.bfq"]),
    ("CollectRrbsMetrics", ["-I", "{bam}", "-R", "{fasta}", "-O", "{out}/rrbs"],
     ["rrbs.rrbs_summary_metrics"]),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_tool_identical_to_jax(inp, tmp_path, case):
    tool, args, expect = case
    _, text, files = assert_identical(both(tmp_path, tool, args, **inp), expect)
    assert text or files


def test_fifo_buffer_identical_to_jax(monkeypatch):
    """FifoBuffer pumps stdin to stdout: 300,000 bytes through each package."""
    data = np.random.default_rng(0).bytes(300_000)
    got = {}
    for pkg in REGISTRIES:
        out = io.BytesIO()
        monkeypatch.setattr(sys, "stdin", io.TextIOWrapper(io.BytesIO(data)))
        monkeypatch.setattr(sys, "stdout", io.TextIOWrapper(out))
        rc = REGISTRIES[pkg]["FifoBuffer"](["--IO_SIZE", "4096"])
        got[pkg] = (rc, out.getvalue())
    assert got["port"] == got["jax"] == (0, data)


# ----------------------------------- gatk_tpu's tests/test_picard_tools_r5.py, on the port


def run(tool, argv):
    rc = TOOL_REGISTRY[tool](argv)
    assert not rc


def _mini_bam(tmp_path, reads, name="mini.bam", lengths=(16569,)):
    header = sam.SamHeader.parse(
        "".join(f"@SQ\tSN:c{i}\tLN:{l}\n" for i, l in enumerate(lengths))
        + "@RG\tID:rg1\tSM:s1\tLB:libA\n@RG\tID:rg2\tSM:s1\tLB:libB\n")
    path = tmp_path / name
    w = bam.BamWriter(str(path), header)
    for rd in reads:
        w.write(rd)
    w.close()
    return str(path)


def _read(name, pos, flag=0, ref_id=0, n=20, rg="rg1", mapq=60):
    return Read(name, flag, ref_id, pos, mapq, np.zeros(1, np.uint8),
                np.array([n], np.int32), np.full(n, ord("A"), np.uint8),
                np.full(n, 30, np.uint8), tags={"RG": rg})


def test_make_sites_only_vcf(inp, tmp_path):
    out = tmp_path / "sites.vcf"
    run("MakeSitesOnlyVcf", ["-I", inp["calls"], "-O", str(out)])
    recs = list(vcf.VcfReader(str(out)))
    assert recs and all(not v.samples for v in recs)
    assert len(recs) == len(list(vcf.VcfReader(inp["calls"])))


def test_vcf_to_interval_list_and_to_bed(inp, tmp_path):
    il = tmp_path / "x.interval_list"
    run("VcfToIntervalList", ["-I", inp["calls"], "-O", str(il)])
    body = [l for l in open(il) if not l.startswith("@")]
    recs = list(vcf.VcfReader(inp["calls"]))
    assert len(body) == len(recs)
    f = body[0].split("\t")
    assert f[0] == recs[0].contig and int(f[1]) == recs[0].pos + 1
    bed = tmp_path / "x.bed"
    run("IntervalListToBed", ["-I", str(il), "-O", str(bed)])
    bf = open(bed).readline().split("\t")
    assert int(bf[1]) == recs[0].pos and bf[0] == recs[0].contig


def test_update_vcf_sequence_dictionary(inp, tmp_path):
    out = tmp_path / "u.vcf"
    run("UpdateVcfSequenceDictionary", ["-I", inp["known_sites"], "-O", str(out), "-SD",
                                        inp["bam"]])
    assert any("chrM" in h for h in open(out) if h.startswith("##contig"))


def test_vcf_format_converter_roundtrip(inp, tmp_path):
    out = tmp_path / "c.vcf.gz"
    run("VcfFormatConverter", ["-I", inp["calls"], "-O", str(out)])
    assert len(list(vcf.VcfReader(str(out)))) == len(list(vcf.VcfReader(inp["calls"])))


def test_filter_vcf(tmp_path):
    src = tmp_path / "in.vcf"
    w = vcf.VcfWriter(str(src), ["S"])
    for pos, dp in ((10, 5), (20, 50)):
        w.write(vcf.Variant(contig="chrM", pos=pos, ref="A", alts=("G",), qual=50.0, filters=(),
                            info={}, fmt_keys=("GT", "DP"), samples=[{"GT": "0/1", "DP": str(dp)}]))
    w.close()
    out = tmp_path / "f.vcf"
    run("FilterVcf", ["-I", str(src), "-O", str(out), "--MIN_DP", "10"])
    recs = {v.pos: v for v in vcf.VcfReader(str(out))}
    assert "AllGtsFiltered" in recs[10].filters
    assert recs[20].filters == ("PASS",)


def test_liftover_interval_list(tmp_path):
    il = tmp_path / "in.interval_list"
    il.write_text("@SQ\tSN:chrM\tLN:16569\nchrM\t101\t200\t+\tx\n")
    chain = tmp_path / "c.chain"
    chain.write_text("chain 1 chrM 16569 + 0 16569 chrM2 20000 + 1000 17569 1\n16569\n\n")
    out = tmp_path / "out.interval_list"
    run("LiftOverIntervalList", ["-I", str(il), "-O", str(out), "--CHAIN", str(chain)])
    f = [l for l in open(out) if not l.startswith("@")][0].split("\t")
    assert f[0] == "chrM2" and int(f[1]) == 1101 and int(f[2]) == 1200


def test_clean_sam(tmp_path):
    p = _mini_bam(tmp_path, [_read("b", 5, flag=sam.UNMAPPED, mapq=37), _read("a", 16560)])
    out = tmp_path / "clean.bam"
    run("CleanSam", ["-I", p, "-O", str(out)])
    got = {rd.name: rd for rd in bam.BamReader(str(out))}
    assert got["b"].mapq == 0
    a = got["a"]
    assert a.end <= 16569 and a.cigar_ops[-1] == sam.OP_S and a.cigar_lens[-1] == 11


def test_reorder_sam(tmp_path):
    p = _mini_bam(tmp_path, [_read("a", 10, ref_id=0), _read("b", 5, ref_id=1)],
                  lengths=(1000, 2000))
    d = tmp_path / "new.dict"
    d.write_text("@SQ\tSN:c1\tLN:2000\n@SQ\tSN:c0\tLN:1000\n")
    out = tmp_path / "re.bam"
    run("ReorderSam", ["-I", p, "-O", str(out), "-SD", str(d)])
    assert [r.name for r in bam.BamReader(str(out))] == ["b", "a"]


def test_filter_sam_reads(tmp_path):
    p = _mini_bam(tmp_path, [_read("a", 10), _read("b", 50)])
    lst = tmp_path / "names.txt"
    lst.write_text("a\n")
    out = tmp_path / "f.bam"
    run("FilterSamReads", ["-I", p, "-O", str(out), "--FILTER", "includeReadList",
                           "--READ_LIST_FILE", str(lst)])
    assert [r.name for r in bam.BamReader(str(out))] == ["a"]


def test_sam_format_converter(tmp_path):
    p = _mini_bam(tmp_path, [_read("a", 10)])
    out = tmp_path / "o.sam"
    run("SamFormatConverter", ["-I", p, "-O", str(out)])
    body = [l for l in open(out).read().splitlines() if not l.startswith("@")]
    assert body[0].startswith("a\t0\tc0\t11\t60\t20M")


def test_split_sam_by_library(tmp_path):
    p = _mini_bam(tmp_path, [_read("a", 10, rg="rg1"), _read("b", 20, rg="rg2")])
    d = tmp_path / "split"
    run("SplitSamByLibrary", ["-I", p, "-O", str(d)])
    assert sorted(os.listdir(d)) == ["libA.bam", "libB.bam"]
    assert [r.name for r in bam.BamReader(str(d / "libA.bam"))] == ["a"]


def test_position_based_downsample(tmp_path):
    reads = [_read(f"M:1:1101:{i}:7", 10 + i + 20 * j) for i in range(20) for j in (0, 1)]
    p = _mini_bam(tmp_path, reads)
    out = tmp_path / "d.bam"
    run("PositionBasedDownsampleSam", ["-I", p, "-O", str(out), "-F", "0.5"])
    got = [r.name for r in bam.BamReader(str(out))]
    assert 0 < len(got) < len(reads)
    assert all(got.count(name) == 2 for name in got)


def test_calculate_read_group_checksum(tmp_path):
    p = _mini_bam(tmp_path, [_read("a", 10)])
    out = tmp_path / "md5.txt"
    run("CalculateReadGroupChecksum", ["-I", p, "-O", str(out)])
    assert len(open(out).read().strip()) == 32


def test_collect_duplicate_metrics(tmp_path):
    p = _mini_bam(tmp_path, [_read("a", 10), _read("b", 10, flag=sam.DUPLICATE)])
    out = tmp_path / "dup.txt"
    run("CollectDuplicateMetrics", ["-I", p, "-M", str(out)])
    body = open(out).read()
    assert "DuplicationMetrics" in body and "libA" in body


def test_accumulate_quality_yield(inp, tmp_path):
    out = tmp_path / "sum.txt"
    run("AccumulateQualityYieldMetrics", ["-I", inp["qy0"], "-I", inp["qy1"], "-O", str(out)])
    rows = [l for l in open(out).read().splitlines() if l and l[0].isdigit()]
    assert rows[0].split("\t") == ["15", "14", "1500"]


def test_mark_illumina_adapters(tmp_path):
    bases = b"ACGTACGTACGTACGTACGT" + b"AGATCGGAAGAGC"
    rd = Read("a", sam.UNMAPPED, -1, -1, 0, np.zeros(0, np.uint8), np.zeros(0, np.int32),
              np.frombuffer(bases, np.uint8).copy(), np.full(len(bases), 30, np.uint8),
              tags={"RG": "rg1"})
    p = _mini_bam(tmp_path, [rd, _read("b", 10, n=30)])
    out = tmp_path / "adapters.bam"
    run("MarkIlluminaAdapters", ["-I", p, "-O", str(out), "-M", str(tmp_path / "a.txt")])
    got = {r.name: r for r in bam.BamReader(str(out))}
    assert got["a"].tags.get("XT") == 21
    assert "XT" not in got["b"].tags


def test_merge_bam_alignment(tmp_path):
    un = Read("a", sam.UNMAPPED, -1, -1, 0, np.zeros(0, np.uint8), np.zeros(0, np.int32),
              np.full(20, ord("A"), np.uint8), np.full(20, 30, np.uint8),
              tags={"RG": "rg1", "RX": "ACGT"})
    un_only = Read("c", sam.UNMAPPED, -1, -1, 0, np.zeros(0, np.uint8), np.zeros(0, np.int32),
                   np.full(20, ord("C"), np.uint8), np.full(20, 30, np.uint8), tags={"RG": "rg1"})
    up = _mini_bam(tmp_path, [un, un_only], name="u.bam")
    aligned = _read("a", 100)
    aligned.tags.pop("RG", None)
    ap = _mini_bam(tmp_path, [aligned], name="al.bam")
    out = tmp_path / "m.bam"
    run("MergeBamAlignment", ["--ALIGNED_BAM", ap, "--UNMAPPED_BAM", up, "-O", str(out)])
    got = {r.name: r for r in bam.BamReader(str(out))}
    assert got["a"].tags.get("RX") == "ACGT" and got["a"].pos == 100
    assert got["c"].is_unmapped


def test_collect_rnaseq_metrics(tmp_path):
    flat = tmp_path / "refFlat.txt"
    flat.write_text("G1\tNM_1\tc0\t+\t0\t1000\t100\t900\t2\t0,600,\t500,1000,\n")
    p = _mini_bam(tmp_path, [_read("a", 150, n=50), _read("b", 520, n=50),
                             _read("c", 5000, n=50)])
    out = tmp_path / "rna.txt"
    run("CollectRnaSeqMetrics", ["-I", p, "-O", str(out), "--REF_FLAT", str(flat)])
    lines = open(out).read().splitlines()
    hdr = [l for l in lines if l.startswith("PF_BASES")][0]
    vals = dict(zip(hdr.split("\t"), lines[lines.index(hdr) + 1].split("\t")))
    assert int(vals["CODING_BASES"]) == 50
    assert int(vals["INTRONIC_BASES"]) == 50
    assert int(vals["INTERGENIC_BASES"]) == 50


def test_genotype_concordance(tmp_path):
    t = _vcf(tmp_path / "t.vcf", [("chrM", 11, "A", "G", "0/1"), ("chrM", 21, "A", "G", "1/1"),
                                  ("chrM", 31, "A", "AT", "0/1")])
    c = _vcf(tmp_path / "c.vcf", [("chrM", 11, "A", "G", "0/1"), ("chrM", 21, "A", "G", "0/1"),
                                  ("chrM", 41, "A", "G", "0/1")])
    out = tmp_path / "gc"
    run("GenotypeConcordance", ["--CALL_VCF", c, "--TRUTH_VCF", t, "-O", str(out)])
    body = open(str(out) + ".genotype_concordance_summary_metrics").read()
    lines = [l.split("\t") for l in body.splitlines() if l.startswith(("SNP", "INDEL"))]
    snp = next(l for l in lines if l[0] == "SNP")
    assert snp[3] == "1" and snp[4] == "1" and snp[6] == "1"
    assert next(l for l in lines if l[0] == "INDEL")[5] == "1"


def test_extract_and_check_fingerprint(inp, tmp_path):
    """The planted SNVs are hets of the synthetic sample: its fingerprint
    calls them 0/1, and the BAM matches its own fingerprint."""
    fp = tmp_path / "fp.vcf"
    run("ExtractFingerprint", ["-I", inp["bam"], "-O", str(fp), "-H", inp["hapmap"]])
    recs = {v.pos: v for v in vcf.VcfReader(str(fp))}
    snvs = [v for v in inp["variants"] if v.is_snv]
    assert sorted(recs) == [v.pos for v in snvs]
    assert all(recs[v.pos].samples[0]["GT"] == "0/1" for v in snvs)
    out = tmp_path / "chk"
    run("CheckFingerprint", ["-I", inp["bam"], "-G", str(fp), "-H", inp["hapmap"], "-O", str(out)])
    assert "TRUE" in open(str(out) + ".fingerprinting_summary_metrics").read()


def test_mark_duplicates_with_mate_cigar_routes(tmp_path):
    p = _mini_bam(tmp_path, [_read("a", 10), _read("b", 10)])
    out = tmp_path / "md.bam"
    run("MarkDuplicatesWithMateCigar", ["-I", p, "-O", str(out), "-M", str(tmp_path / "m.txt")])
    assert sum(r.is_duplicate for r in bam.BamReader(str(out))) == 1


def test_umi_aware_mark_duplicates(tmp_path):
    def umi_read(name, umi):
        r = _read(name, 10)
        r.tags["RX"] = umi
        return r

    p = _mini_bam(tmp_path, [umi_read("a", "AAAA"), umi_read("b", "TTTT"), umi_read("c", "AAAT")])
    out = tmp_path / "umi.bam"
    run("UmiAwareMarkDuplicatesWithMateCigar", ["-I", p, "-O", str(out), "-M",
                                                str(tmp_path / "m.txt")])
    got = {r.name: r for r in bam.BamReader(str(out))}
    assert not got["b"].is_duplicate
    assert sum(r.is_duplicate for r in got.values()) == 1


def test_view_sam(tmp_path, capsys):
    p = _mini_bam(tmp_path, [_read("a", 10), _read("b", 5, flag=sam.UNMAPPED)])
    run("ViewSam", ["-I", p, "--ALIGNMENT_STATUS", "Aligned"])
    out = capsys.readouterr().out
    assert "\na\t" in "\n" + out and "\nb\t" not in "\n" + out
    assert "@SQ\tSN:c0" in out


def test_compare_sams(tmp_path):
    p1 = _mini_bam(tmp_path, [_read("a", 10), _read("b", 50)], name="x.bam")
    p2 = _mini_bam(tmp_path, [_read("a", 10), _read("b", 50)], name="y.bam")
    assert TOOL_REGISTRY["CompareSAMs"]([p1, p2]) == 0
    p3 = _mini_bam(tmp_path, [_read("a", 10), _read("b", 60)], name="z.bam")
    assert TOOL_REGISTRY["CompareSAMs"]([p1, p3]) == 1


def test_check_terminator_block(tmp_path):
    p = _mini_bam(tmp_path, [_read("a", 10)])
    assert TOOL_REGISTRY["CheckTerminatorBlock"](["-I", p]) == 0
    trunc = tmp_path / "trunc.bam"
    trunc.write_bytes(open(p, "rb").read()[:-28])
    assert TOOL_REGISTRY["CheckTerminatorBlock"](["-I", str(trunc)]) == 100


def test_fix_vcf_header(inp, tmp_path):
    out = tmp_path / "fixed.vcf"
    run("FixVcfHeader", ["-I", inp["bare"], "-O", str(out)])
    hdr = open(out).read()
    assert "##INFO=<ID=MYKEY" in hdr and "##FORMAT=<ID=XX" in hdr
    assert "##FILTER=<ID=weird_filter" in hdr


def test_gather_gvcfs(tmp_path):
    parts = [_vcf(tmp_path / f"s{i}.vcf", [("chrM", p + 1, "A", "G", "0/1") for p in pos])
             for i, pos in enumerate(((5, 10), (10, 20)))]
    out = tmp_path / "g.vcf"
    run("GatherGvcfs", ["-I", parts[0], "-I", parts[1], "-O", str(out)])
    assert [v.pos for v in vcf.VcfReader(str(out))] == [5, 10, 20]


def test_collect_variant_calling_metrics(tmp_path):
    db = _vcf(tmp_path / "dbsnp.vcf", [("chrM", 11, "A", "G", None)], samples=())
    call = _vcf(tmp_path / "c.vcf", [("chrM", 11, "A", "G", None), ("chrM", 21, "C", "A", None),
                                     ("chrM", 31, "A", "AT", None)], samples=())
    out = tmp_path / "vc"
    run("CollectVariantCallingMetrics", ["-I", call, "--DBSNP", db, "-O", str(out)])
    body = open(str(out) + ".variant_calling_summary_metrics").read()
    row = [l for l in body.splitlines() if l and l[0].isdigit()][0].split("\t")
    assert row[0] == "2" and row[1] == "1" and row[6] == "1"


def test_extract_sequences_and_nonn(inp, tmp_path):
    il = tmp_path / "x.interval_list"
    il.write_text("chrM\t1\t10\t+\tfirst10\n")
    out = tmp_path / "sub.fasta"
    run("ExtractSequences", ["--INTERVAL_LIST", str(il), "-R", inp["fasta"], "-O", str(out)])
    lines = open(out).read().splitlines()
    assert lines[0] == ">first10" and len(lines[1]) == 10
    run("NonNFastaSize", ["-I", str(out), "-O", str(tmp_path / "n.txt")])
    assert int(open(tmp_path / "n.txt").read()) == 10


def test_add_comments_and_replace_header(tmp_path):
    p = _mini_bam(tmp_path, [_read("a", 10)])
    out = tmp_path / "co.bam"
    run("AddCommentsToBam", ["-I", p, "-O", str(out), "-C", "hello world"])
    assert "@CO\thello world" in bam.BamReader(str(out)).header.text
    out2 = tmp_path / "rh.bam"
    run("ReplaceSamHeader", ["-I", p, "--HEADER", str(out), "-O", str(out2)])
    assert "@CO\thello world" in bam.BamReader(str(out2)).header.text
    assert [r.name for r in bam.BamReader(str(out2))] == ["a"]


def test_add_oa_tag(tmp_path):
    p = _mini_bam(tmp_path, [_read("a", 10)])
    out = tmp_path / "oa.bam"
    run("AddOATag", ["-I", p, "-O", str(out)])
    assert next(iter(bam.BamReader(str(out)))).tags["OA"].startswith("c0,11,+,20M,60")


def test_revert_oq_add_mate_cigar(tmp_path):
    r1 = _read("a", 10, flag=sam.PAIRED | sam.FIRST_OF_PAIR)
    r1.tags["OQ"] = "I" * 20
    r2 = _read("a", 100, flag=sam.PAIRED | sam.SECOND_OF_PAIR, n=30)
    p = _mini_bam(tmp_path, [r1, r2])
    out = tmp_path / "rq.bam"
    run("RevertOriginalBaseQualitiesAndAddMateCigar", ["-I", p, "-O", str(out)])
    got = {(r.flag & 0xC0): r for r in bam.BamReader(str(out))}
    assert (got[0x40].quals == 40).all()
    assert got[0x40].tags["MC"] == "30M" and got[0x80].tags["MC"] == "20M"


def test_collect_jumping_library_metrics(tmp_path):
    r = _read("a", 10, flag=sam.PAIRED | sam.FIRST_OF_PAIR | sam.MATE_REVERSE)
    r.mate_ref_id, r.mate_pos = 0, 200
    p = _mini_bam(tmp_path, [r])
    out = tmp_path / "jump.txt"
    run("CollectJumpingLibraryMetrics", ["-I", p, "-O", str(out)])
    row = [l for l in open(out).read().splitlines() if l and l[0].isdigit()][0].split("\t")
    assert row[1] == "1"


def test_compare_metrics(tmp_path):
    a, b = tmp_path / "a.txt", tmp_path / "b.txt"
    a.write_text("## header A\nX\t1\n")
    b.write_text("## header B\nX\t1\n")
    assert TOOL_REGISTRY["CompareMetrics"]([str(a), str(b)]) == 0
    b.write_text("## header B\nX\t2\n")
    assert TOOL_REGISTRY["CompareMetrics"]([str(a), str(b)]) == 1


def test_cluster_crosscheck_metrics(inp, tmp_path):
    out = tmp_path / "clusters.txt"
    run("ClusterCrosscheckMetrics", ["-I", inp["cc"], "-O", str(out)])
    body = open(out).read()
    assert "s1,s2" in body and "s3" in body


def test_wgs_metrics_variants_and_markdup_routes(tmp_path):
    p = _mini_bam(tmp_path, [_read("a", 10), _read("b", 10)])
    out = tmp_path / "raw.txt"
    run("CollectRawWgsMetrics", ["-I", p, "-O", str(out)])
    assert "MEAN_COVERAGE" in open(out).read()
    md = tmp_path / "md.bam"
    run("SimpleMarkDuplicatesWithMateCigar", ["-I", p, "-O", str(md), "-M",
                                              str(tmp_path / "m.txt")])
    assert sum(r.is_duplicate for r in bam.BamReader(str(md))) == 1


# ----------------------------------- gatk_tpu's tests/test_picard_tools2.py, on the port


def test_sort_gff(tmp_path):
    gff = tmp_path / "in.gff3"
    gff.write_text("##gff-version 3\nchr2\t.\tgene\t500\t900\t.\t+\t.\tID=g2\n"
                   "chr1\t.\tgene\t300\t400\t.\t+\t.\tID=g1\n"
                   "chr1\t.\tgene\t100\t200\t.\t+\t.\tID=g0\n")
    out = tmp_path / "out.gff3"
    run("SortGff", ["-I", str(gff), "-O", str(out)])
    ids = [l.split("ID=")[1].strip() for l in open(out) if not l.startswith("#")]
    assert ids == ["g2", "g0", "g1"]
    d = tmp_path / "ref.dict"
    d.write_text("@SQ\tSN:chr1\tLN:1000\n@SQ\tSN:chr2\tLN:1000\n")
    run("SortGff", ["-I", str(gff), "-O", str(out), "-SD", str(d)])
    ids = [l.split("ID=")[1].strip() for l in open(out) if not l.startswith("#")]
    assert ids == ["g0", "g1", "g2"]


def test_fifo_buffer_through_the_port_cli():
    data = os.urandom(300000)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-m", "gatk_tpu_torch", "FifoBuffer", "--IO_SIZE", "4096"],
                       input=data, capture_output=True, cwd=root, env=env, timeout=120)
    assert r.returncode == 0 and r.stdout == data


def test_accumulate_variant_calling_metrics(inp, tmp_path):
    out = tmp_path / "merged"
    run("AccumulateVariantCallingMetrics", ["-I", inp["vc0"], "-I", inp["vc1"], "-O", str(out)])
    text = open(str(out) + ".variant_calling_summary_metrics").read()
    row = [l for l in text.splitlines() if l and l[0].isdigit()][0].split("\t")
    assert row[:3] == ["40", "10", "30"] and abs(float(row[3]) - 0.25) < 1e-9


def test_convert_sequencing_artifact_to_oxog(inp, tmp_path):
    out = tmp_path / "oxog.txt"
    run("ConvertSequencingArtifactToOxoG", ["-I", inp["artifact"], "-O", str(out)])
    text = open(out).read()
    assert "CpcgMetrics" in text and "OXIDATION_Q" in text
    assert [l for l in text.splitlines() if l and not l.startswith(("#", "CONTEXT"))]


def test_collect_sam_error_metrics(inp, tmp_path):
    """The strata by reference base partition ALL's bases, and the synthetic
    reads' 1 % error rate shows under 5 %."""
    out = tmp_path / "err"
    run("CollectSamErrorMetrics", ["-I", inp["paired"], "-R", inp["fasta"], "-O", str(out)])
    text = open(str(out) + ".error_summary_metrics").read()
    lines = {l.split("\t")[0]: l.split("\t") for l in text.splitlines()
             if l and not l.startswith(("#", "COVARIATE"))}
    n_all = int(lines["ALL"][1])
    n_ref = sum(int(lines[f"REF_BASE:{b}"][1]) for b in "ACGT" if f"REF_BASE:{b}" in lines)
    assert n_all > 0 and abs(n_all - n_ref) <= n_all * 0.01
    assert 0 < float(lines["ALL"][3]) < 0.05


def test_lift_over_haplotype_map(tmp_path):
    hm = tmp_path / "in.map"
    hm.write_text("@SQ\tSN:chrM\tLN:16569\n#CHROM\tPOS\tNAME\nchrM\t101\ts1\tA\tG\t0.3\n"
                  "chrM\t16400\ts2\tC\tT\t0.2\n")
    chain = tmp_path / "c.chain"
    chain.write_text("chain 1 chrM 16569 + 0 16000 chr1 20000 + 1000 17000 1\n16000\n\n")
    out = tmp_path / "out.map"
    run("LiftOverHaplotypeMap", ["-I", str(hm), "-O", str(out), "-C", str(chain)])
    body = [l for l in open(out) if not l.startswith(("@", "#"))]
    assert len(body) == 1
    f = body[0].split("\t")
    assert f[0] == "chr1" and int(f[1]) == 1101


def test_bam_to_bfq(inp, tmp_path):
    d = tmp_path / "bfq"
    run("BamToBfq", ["-I", inp["bam"], "--ANALYSIS_DIR", str(d), "--FLOWCELL_BARCODE", "fc",
                     "--READS_TO_ALIGN", "50"])
    with open(d / "fc.1.bfq", "rb") as fh:
        nlen = struct.unpack("<i", fh.read(4))[0]
        assert fh.read(nlen).endswith(b"\x00")
        slen = struct.unpack("<i", fh.read(4))[0]
        packed = np.frombuffer(fh.read(slen), np.uint8)
        assert len(packed) == slen
        assert (packed & 0x3F).max() <= 63 and (packed >> 6).max() <= 3


def test_collect_rrbs_metrics(inp, tmp_path):
    out = tmp_path / "rrbs"
    run("CollectRrbsMetrics", ["-I", inp["bam"], "-R", inp["fasta"], "-O", str(out)])
    text = open(str(out) + ".rrbs_summary_metrics").read()
    row = [l for l in text.splitlines() if l and l[0].isdigit()][0].split("\t")
    assert int(row[0]) > 900 and int(row[1]) > 0
    assert float(row[3]) < 0.05
