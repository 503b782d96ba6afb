"""The port's copies of gatk_tpu's structural-variant tools (tools/sv_tools.py,
tools/sv_discovery_tool.py, tools/cpx_reinterpreter.py) against gatk_tpu's, on
the CPU.

Each tool runs through both packages' registries on inputs written here (SV
VCFs, a GTF with tests/test_sv_tools.py's EMMA1 gene, evidence and depth files,
BAMs of assembled contigs, of a deletion's junction reads and of discordant
pairs) and the return code, what it prints and every file it writes must be
byte-identical. Then the checks of gatk_tpu's tests/test_sv_tools.py,
tests/test_cpx_reinterpreter.py and the SV parts of tests/test_new_tools_r4.py
and tests/test_misc_tools.py run on the port; the GTF they read from the
reference bundle is written here.
"""
import gzip
import re

import numpy as np
import pytest

from gatk_tpu.io.vcf import Variant as JaxVariant
from gatk_tpu.tools import cpx_reinterpreter as jax_cpx
from gatk_tpu_torch.cli import TOOL_REGISTRY
from gatk_tpu_torch.funcotator.gencode import load_gtf
from gatk_tpu_torch.io import bam as bamio, sam as samio, vcf as vcfio
from gatk_tpu_torch.io.reads import Read
from gatk_tpu_torch.io.vcf import Variant
from gatk_tpu_torch.tools import cpx_reinterpreter as cpx_mod, sv_tools as svt
from tests.torch_tool_cases import assert_identical, both

SV_HEADER = ("##fileformat=VCFv4.2\n"
             '##INFO=<ID=SVTYPE,Number=1,Type=String,Description="t">\n'
             '##INFO=<ID=END,Number=1,Type=Integer,Description="e">\n'
             '##INFO=<ID=ALGORITHMS,Number=.,Type=String,Description="a">\n'
             '##FORMAT=<ID=GT,Number=1,Type=String,Description="gt">\n')


def _write_sv_vcf(path, rows):
    with open(path, "w") as fh:
        fh.write(SV_HEADER + "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS1\n")
        for r in rows:
            fh.write("\t".join(str(x) for x in r) + "\n")
    return str(path)


def _write_svc_vcf(path, samples, rows):
    """rows: (contig, pos1, id, svtype, end, [{GT, CN, QS} per sample])."""
    with open(path, "w") as fh:
        fh.write("##fileformat=VCFv4.2\n"
                 '##INFO=<ID=END,Number=1,Type=Integer,Description="x">\n'
                 '##INFO=<ID=SVTYPE,Number=1,Type=String,Description="x">\n'
                 '##FORMAT=<ID=GT,Number=1,Type=String,Description="x">\n'
                 '##FORMAT=<ID=CN,Number=1,Type=Integer,Description="x">\n')
        fh.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t" + "\t".join(samples)
                 + "\n")
        for contig, pos1, vid, svtype, end, gts in rows:
            keys = [k for k in ("GT", "CN", "QS") if k in gts[0]]
            fh.write(f"{contig}\t{pos1}\t{vid}\tN\t<{svtype}>\t.\t.\tEND={end};SVTYPE={svtype}\t"
                     + ":".join(keys) + "".join("\t" + ":".join(str(g[k]) for k in keys)
                                                for g in gts) + "\n")
    return str(path)


def _write_bam(path, sequences, reads, rg=True):
    header = samio.SamHeader(sequences=[samio.SequenceRecord(n, l, i)
                                        for i, (n, l) in enumerate(sequences)],
                             read_groups=[{"ID": "rg1", "SM": "S1"}] if rg else [])
    w = bamio.BamWriter(str(path), header)
    for r in sorted(reads, key=lambda x: (x.ref_id, x.pos)):
        w.write(r)
    w.close()
    return str(path)


def _seq(rng, n):
    return "".join("ACGT"[i] for i in rng.integers(0, 4, n))


def _ref(path, seq, name="chr1"):
    with open(path, "w") as fh:
        fh.write(f">{name}\n{seq}\n")
    return str(path)


def _ctg_read(name, ref_id, pos, cigar, rev=False):
    ops = {"M": 0, "I": 1, "D": 2, "S": 4, "H": 5}
    parsed = [(int(n), ops[c]) for n, c in re.findall(r"(\d+)([MIDSH])", cigar)]
    n = sum(k for k, o in parsed if o in (0, 1, 4))
    return Read(name=name, flag=(0x10 if rev else 0) | 0x800, ref_id=ref_id, pos=pos, mapq=60,
                cigar_ops=np.array([o for _, o in parsed], np.uint8),
                cigar_lens=np.array([k for k, _ in parsed], np.int32),
                bases=np.full(n, ord("A"), np.uint8), quals=np.full(n, 30, np.uint8))


def _m(name, pos, n, bases, flag=0, cigar=None, **kw):
    ops, lens = cigar or ([0], [n])
    return Read(name=name, flag=flag, ref_id=0, pos=pos, mapq=60,
                cigar_ops=np.array(ops, np.uint8), cigar_lens=np.array(lens, np.int32),
                bases=np.frombuffer(bases.encode(), np.uint8).copy(),
                quals=np.full(len(bases), 35, np.uint8), **kw)


def _deletion_sample(d):
    """tests/test_new_tools_r4.py's deletion: ref[1500:1900] deleted, eight
    junction reads soft-clipped at the junction and twelve flanking reads."""
    rng = np.random.default_rng(37)
    ref = _seq(rng, 3000)
    alt = ref[:1500] + ref[1900:]
    reads = []
    for i in range(8):
        s = 1500 - 120 + 10 * i
        m = 1500 - s
        reads.append(_m(f"j{i}", s, 160, alt[s:s + 160], cigar=([0, 4], [m, 160 - m])))
    for i in range(12):
        s = 1500 - 400 + 30 * i
        reads.append(_m(f"f{i}", s, 120, alt[s:s + 120]))
    return _ref(d / "sv.fa", ref), _write_bam(d / "sv.bam", [("chr1", 3000)], reads)


def _imprecise_sample(d):
    """tests/test_sv_tools.py's deletion seen only by discordant FR pairs."""
    rng = np.random.default_rng(11)
    ref = _seq(rng, 12000)
    reads = []

    def pair(name, p1, p2):
        tlen = p2 + 100 - p1
        reads.append(_m(name, p1, 100, ref[p1:p1 + 100], flag=0x1 | 0x2 | 0x20 | 0x40,
                        mate_ref_id=0, mate_pos=p2, tlen=tlen))
        reads.append(_m(name, p2, 100, ref[p2:p2 + 100], flag=0x1 | 0x2 | 0x10 | 0x80,
                        mate_ref_id=0, mate_pos=p1, tlen=-tlen))

    for i in range(60):
        pair(f"bg{i}", 100 + i * 60, 100 + i * 60 + 300)
    for i in range(12):
        p = 5000 - 250 + 5 * i
        pair(f"dp{i}", p, p + 300 + 2000)
    return _ref(d / "imp.fa", ref), _write_bam(d / "imp.bam", [("chr1", 12000)], reads)


@pytest.fixture(scope="module")
def inp(tmp_path_factory):
    d = tmp_path_factory.mktemp("sv")
    inp = {}
    inp["gtf"] = str(d / "unittest.gtf")
    exons = [(100, 200), (300, 400), (500, 600), (700, 800), (900, 1000)]
    attrs = 'gene_id "G1"; transcript_id "T1"; gene_name "EMMA1"; transcript_type "protein_coding";'
    with open(inp["gtf"], "w") as fh:
        fh.write(f"chr1\tT\tgene\t100\t1000\t.\t+\t.\t{attrs}\n")
        fh.write(f"chr1\tT\ttranscript\t100\t1000\t.\t+\t.\t{attrs}\n")
        for a, b in exons:
            fh.write(f"chr1\tT\texon\t{a}\t{b}\t.\t+\t.\t{attrs}\n")
        for a, b in exons:
            fh.write(f"chr1\tT\tCDS\t{max(a, 150)}\t{min(b, 950)}\t.\t+\t0\t{attrs}\n")
    inp["sv"] = _write_sv_vcf(d / "sv.vcf", [
        ("chr1", 50, "del1", "N", "<DEL>", 99, ".", "SVTYPE=DEL;END=150", "GT", "0/1"),
        ("chr1", 290, "dup1", "N", "<DUP>", 99, ".", "SVTYPE=DUP;END=410", "GT", "0/1"),
        ("chr1", 5000, "del2", "N", "<DEL>", 99, ".", "SVTYPE=DEL;END=5100", "GT", "0/1")])
    inp["a"] = _write_sv_vcf(d / "a.vcf", [
        ("chr1", 1000, "a_del", "N", "<DEL>", 99, ".", "SVTYPE=DEL;END=5000;ALGORITHMS=pesr",
         "GT", "0/1"),
        ("chr1", 50000, "a_dup", "N", "<DUP>", 99, ".", "SVTYPE=DUP;END=60000;ALGORITHMS=pesr",
         "GT", "0/1")])
    inp["b"] = _write_sv_vcf(d / "b.vcf", [
        ("chr1", 1100, "b_del", "N", "<DEL>", 99, ".", "SVTYPE=DEL;END=5080;ALGORITHMS=pesr",
         "GT", "1/1"),
        ("chr1", 90000, "b_inv", "N", "<INV>", 99, ".", "SVTYPE=INV;END=95000;ALGORITHMS=pesr",
         "GT", "0/1")])
    inp["eval"] = _write_svc_vcf(d / "eval.vcf", ["S1", "S2"], [
        ("chr1", 10000, "E1", "DEL", 20000, [{"GT": "0/1"}, {"GT": "0/1"}]),
        ("chr1", 500000, "E2", "DEL", 501000, [{"GT": "0/1"}, {"GT": "0/0"}])])
    inp["truth"] = _write_svc_vcf(d / "truth.vcf", ["S1", "S2"], [
        ("chr1", 10050, "T1", "DEL", 20100, [{"GT": "0/1"}, {"GT": "1/1"}]),
        ("chr1", 900000, "T2", "DUP", 910000, [{"GT": "0/1"}, {"GT": "0/1"}])])
    inp["cnv_a"] = _write_svc_vcf(d / "A.vcf", ["A"], [
        ("chr1", 1, "ref", "DEL", 9999, [{"GT": "0", "CN": 2, "QS": 60}]),
        ("chr1", 10000, "s1", "DEL", 20000, [{"GT": "1", "CN": 1, "QS": 60}]),
        ("chr1", 21000, "s2", "DEL", 30000, [{"GT": "1", "CN": 1, "QS": 60}])])
    inp["cnv_b"] = _write_svc_vcf(d / "B.vcf", ["B"], [
        ("chr1", 1, "ref", "DEL", 9999, [{"GT": "0", "CN": 2, "QS": 60}]),
        ("chr1", 10500, "s1", "DEL", 29000, [{"GT": "1", "CN": 0, "QS": 80}]),
        ("chr2", 5000, "s2", "DUP", 15000, [{"GT": "1", "CN": 4, "QS": 99}])])
    # CollectSVEvidence's reads: two right clips at 150, a left clip at 200 and
    # a pair whose mate lies on chr2
    def mk(name, pos, cigar, flag, mate_ref=0, mate_pos=None):
        n = sum(k for k, o in cigar if o in (0, 1, 4))
        return Read(name=name, flag=flag, ref_id=0, pos=pos, mapq=60,
                    cigar_ops=np.array([o for _, o in cigar], np.uint8),
                    cigar_lens=np.array([k for k, _ in cigar], np.int32),
                    bases=np.full(n, ord("A"), np.uint8), quals=np.full(n, 30, np.uint8),
                    mate_ref_id=mate_ref, mate_pos=pos + 300 if mate_pos is None else mate_pos,
                    tags={"RG": "rg1"})
    inp["evidence_bam"] = _write_bam(d / "ev.bam", [("chr1", 10000), ("chr2", 10000)], [
        mk("a", 100, [(50, 0), (25, 4)], 0x3), mk("b", 100, [(50, 0), (25, 4)], 0x3),
        mk("c", 200, [(25, 4), (50, 0)], 0x3), mk("d", 300, [(75, 0)], 0x1, 1, 5000)])
    inp["sr"] = str(d / "ev.sr.txt.gz")
    assert TOOL_REGISTRY["CollectSVEvidence"](["-I", inp["evidence_bam"], "--sr-file", inp["sr"],
                                               "--pe-file", str(d / "ev.pe.txt.gz")]) == 0
    inp["site_depth"] = str(d / "sd.tsv")
    with open(inp["site_depth"], "w") as fh:
        fh.write("chr1\t100\tS1\t15\t0\t15\t0\nchr1\t200\tS1\t28\t0\t2\t0\n"
                 "chr1\t300\tS1\t3\t0\t4\t0\n")
    inp["baf_sites"] = str(d / "sites.vcf")
    with open(inp["baf_sites"], "w") as fh:
        fh.write("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n"
                 + "".join(f"chr1\t{p}\t.\tA\tG\t.\tPASS\t.\n" for p in (100, 200, 300)))
    inp["depth"] = str(d / "rd.txt")
    with open(inp["depth"], "w") as fh:
        fh.write("#Chr\tStart\tEnd\tS1\tS2\nchr1\t0\t100\t5\t7\nchr1\t100\t200\t3\t1\n"
                 "chr1\t200\t300\t2\t2\nchr1\t500\t600\t9\t9\n")
    strata = [_write_sv_vcf(d / "strat.vcf", [
        ("chr1", pos, ".", "N", f"<{t}>", ".", "PASS", f"END={end};SVTYPE={t};ALGORITHMS=pesr",
         "GT", "0/1") for pos, end, t in ((1000, 1200, "DEL"), (5000, 95000, "DEL"),
                                         (2000, 2300, "DUP"))])]
    inp["strat_vcf"] = strata[0]
    inp["strat_b"] = _write_sv_vcf(d / "strat_b.vcf", [
        ("chr1", 1050, ".", "N", "<DEL>", ".", "PASS", "END=1220;SVTYPE=DEL;ALGORITHMS=pesr",
         "GT", "0/1")])
    inp["strata"] = str(d / "strata.tsv")
    with open(inp["strata"], "w") as fh:
        fh.write("NAME\tSVTYPE\tMIN_SIZE\tMAX_SIZE\tTRACKS\nDEL_small\tDEL\t0\t1000\t\n"
                 "DEL_large\tDEL\t1000\t-1\t\n")
    inp["strata_sd"] = str(d / "strata_sd.tsv")
    with open(inp["strata_sd"], "w") as fh:
        fh.write("NAME\tSVTYPE\tMIN_SIZE\tMAX_SIZE\tTRACKS\nDEL_SD\tDEL\t-1\t-1\tSD\n")
    inp["track"] = str(d / "sd.bed")
    with open(inp["track"], "w") as fh:
        fh.write("chr1\t900\t1600\n")
    inp["contigs"] = _write_bam(d / "contigs.bam", [("chr1", 100000), ("chr2", 100000)], [
        _ctg_read("ctg_del", 0, 1000, "100M100S"), _ctg_read("ctg_del", 0, 1600, "100S100M"),
        _ctg_read("ctg_ins", 0, 2000, "100M200S"), _ctg_read("ctg_ins", 0, 2100, "200S100M"),
        _ctg_read("ctg_inv", 0, 3000, "100M100S"),
        _ctg_read("ctg_inv", 0, 3300, "100M100S", rev=True),
        _ctg_read("ctg_bnd", 0, 5000, "100M100S"), _ctg_read("ctg_bnd", 1, 7000, "100S100M")])
    inp["del_fa"], inp["del_bam"] = _deletion_sample(d)
    inp["imp_fa"], inp["imp_bam"] = _imprecise_sample(d)
    # ExtractSVEvidenceSpark's reads: a clipped read, one with an SA tag, a far mate
    rng = np.random.default_rng(41)
    unit = _seq(rng, 60)
    inp["repeat_fa"] = _ref(d / "rep.fa", _seq(rng, 200) + unit * 5 + _seq(rng, 200))
    reads = []
    for name, pos, cigar, tags in (("a", 100, [(0, 60), (4, 40)], {}),
                                   ("b", 150, [(0, 100)], {"SA": "chr1,400,+,50S50M,60,0;"}),
                                   ("c", 200, [(0, 100)], {})):
        reads.append(Read(name=name, flag=0x1 | (0x20 if name == "c" else 0), ref_id=0, pos=pos,
                          mapq=60, cigar_ops=np.array([o for o, _ in cigar], np.uint8),
                          cigar_lens=np.array([k for _, k in cigar], np.int32),
                          bases=np.full(100, ord("A"), np.uint8),
                          quals=np.full(100, 30, np.uint8), mate_ref_id=0,
                          mate_pos=50000 if name == "c" else pos + 200,
                          tlen=50000 if name == "c" else 300, tags=tags))
    inp["split_bam"] = _write_bam(d / "split.bam", [("chr1", 700)], reads, rg=False)
    inp["names"] = str(d / "names.txt")
    with open(inp["names"], "w") as fh:
        fh.write("a\nc\n")
    inp["cpx"] = str(d / "cpx.vcf")
    inp["cpx_fa"] = str(d / "cpx.fa")
    seq = "ACGT" * 500
    with open(inp["cpx_fa"], "w") as fh:
        fh.write(">chr1\n" + "\n".join(seq[i:i + 60] for i in range(0, len(seq), 60)) + "\n")
    with open(inp["cpx"], "w") as fh:
        fh.write("##fileformat=VCFv4.2\n##INFO=<ID=END,Number=1,Type=Integer,Description=\"x\">\n"
                 "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n"
                 "chr1\t100\tCPX_chr1:100-101\tN\t<CPX>\t.\t.\tEND=101;SVTYPE=CPX;"
                 f"SEQ_ALT_HAPLOTYPE={'A' * 102};ALT_ARRANGEMENT=UINS-100;CTG_NAMES=asm0:tig0\n"
                 "chr1\t200\tCPX_chr1:200-400\tN\t<CPX>\t.\t.\tEND=400;SVTYPE=CPX;"
                 f"SEQ_ALT_HAPLOTYPE={'A' * 60};SEGMENTS=chr1:200-300,chr1:300-400;"
                 "ALT_ARRANGEMENT=2;CTG_NAMES=asm0:tig0\n")
    return inp


CASES = [
    ("SVAnnotate", ["-V", "{sv}", "--protein-coding-gtf", "{gtf}", "-O", "{out}/a.vcf"],
     ["a.vcf"]),
    ("SVCluster", ["-V", "{a}", "-V", "{b}", "-O", "{out}/c.vcf"], ["c.vcf"]),
    ("CollectSVEvidence", ["-I", "{evidence_bam}", "--sr-file", "{out}/e.sr.txt.gz",
                           "--pe-file", "{out}/e.pe.txt.gz"], ["e.sr.txt.gz", "e.pe.txt.gz"]),
    ("PrintSVEvidence", ["-F", "{sr}", "-O", "{out}/s.sr.txt", "-L", "chr1:140-160"],
     ["s.sr.txt"]),
    ("SVConcordance", ["--eval", "{eval}", "--truth", "{truth}", "-O", "{out}/c.vcf"], ["c.vcf"]),
    ("JointGermlineCNVSegmentation", ["-V", "{cnv_a}", "-V", "{cnv_b}", "-O", "{out}/j.vcf"],
     ["j.vcf"]),
    ("SiteDepthtoBAF", ["-F", "{site_depth}", "--baf-sites-vcf", "{baf_sites}", "-O",
                        "{out}/baf.tsv"], ["baf.tsv"]),
    ("CondenseDepthEvidence", ["-F", "{depth}", "-O", "{out}/m.txt", "--max-interval-size",
                               "200"], ["m.txt"]),
    ("SVStratify", ["-V", "{strat_vcf}", "-O", "{out}/s.vcf", "--stratify-config", "{strata_sd}",
                    "--track-name", "SD", "--track-intervals", "{track}"], ["s.vcf"]),
    ("GroupedSVCluster", ["-V", "{strat_vcf}", "-V", "{strat_b}", "-O", "{out}/g.vcf",
                          "--stratify-config", "{strata}"], ["g.vcf"]),
    ("StructuralVariantDiscoverer", ["-I", "{contigs}", "-O", "{out}/sv.vcf"], ["sv.vcf"]),
    ("StructuralVariationDiscoveryPipelineSpark", ["-I", "{del_bam}", "-R", "{del_fa}", "-O",
                                                   "{out}/sv.vcf"], ["sv.vcf"]),
    ("FindBreakpointEvidenceSpark", ["-I", "{del_bam}", "-R", "{del_fa}", "-O", "{out}/c.bam",
                                     "--target-link-file", "{out}/ev.tsv"], ["c.bam", "ev.tsv"]),
    ("ExtractSVEvidenceSpark", ["-I", "{split_bam}", "-O", "{out}/ev.tsv"], ["ev.tsv"]),
    ("ExtractOriginalAlignmentRecordsByNameSpark", ["-I", "{split_bam}", "-O", "{out}/sub.bam",
                                                    "--read-name-file", "{names}"], ["sub.bam"]),
    ("FindBadGenomicKmersSpark", ["-R", "{repeat_fa}", "-O", "{out}/bad.txt", "--kmer-size", "31",
                                  "--max-kmer-freq", "3"], ["bad.txt"]),
    ("CalcMetadataSpark", ["-I", "{imp_bam}", "-O", "{out}/meta.txt"], ["meta.txt"]),
    ("CpxVariantReInterpreterSpark", ["--cpx-vcf", "{cpx}", "-R", "{cpx_fa}", "--prefix-out-vcf",
                                      "{out}/out"], ["out_1_seg.vcf", "out_multi_seg.vcf"]),
    # the imprecise deletion, and the Spark aliases of StructuralVariantDiscoverer
    ("StructuralVariationDiscoveryPipelineSpark", ["-I", "{imp_bam}", "-R", "{imp_fa}", "-O",
                                                   "{out}/imp.vcf"], ["imp.vcf"]),
    ("SvDiscoverFromLocalAssemblyContigAlignmentsSpark", ["-I", "{contigs}", "-O",
                                                          "{out}/sv.vcf"], ["sv.vcf"]),
    ("DiscoverVariantsFromContigAlignmentsSAMSpark", ["-I", "{contigs}", "-O", "{out}/sv.vcf"],
     ["sv.vcf"]),
]


@pytest.mark.parametrize("case", CASES, ids=[f"{c[0]}-{k}" for k, c in enumerate(CASES)])
def test_tool_identical_to_jax(inp, tmp_path, case):
    tool, args, expect = case
    _, text, files = assert_identical(both(tmp_path, tool, args, **inp), expect)
    assert text or files


# ------------------------------------------- gatk_tpu's tests/test_sv_tools.py, on the port


def _emma1(inp):
    return next(t for t in load_gtf(inp["gtf"]).values() if t.gene_name == "EMMA1")


@pytest.mark.parametrize("start,end,svtype,want", [
    (50, 150, "DEL", "LOF"), (210, 290, "DEL", "INTRONIC"),
    (50, 1100, "DUP", "COPY_GAIN"), (50, 150, "DUP", "TSS_DUP"), (950, 1100, "DUP", "DUP_PARTIAL"),
    (290, 410, "DUP", "INT_EXON_DUP"), (350, 450, "DUP", "PARTIAL_EXON_DUP"),
    (290, 410, "CNV", "MSV_EXON_OVERLAP"), (50, 1100, "INV", "INV_SPAN"),
    (350, 350, "BND", "BREAKEND_EXON"), (250, 250, "BND", "INTRONIC"), (350, 350, "CTX", "LOF")])
def test_annotate_sv_transcript(inp, start, end, svtype, want):
    assert svt.annotate_sv_transcript(start, end, svtype, _emma1(inp)) == getattr(svt, want)


def test_sv_annotate_cli(inp, tmp_path):
    out = str(tmp_path / "out.vcf")
    assert TOOL_REGISTRY["SVAnnotate"](["-V", inp["sv"], "--protein-coding-gtf", inp["gtf"],
                                        "-O", out]) == 0
    lines = [ln for ln in open(out) if not ln.startswith("#")]
    assert "PREDICTED_LOF=EMMA1" in lines[0]
    assert "PREDICTED_INTERGENIC" in lines[2] and "PREDICTED_NEAREST_TSS=" in lines[2]


def test_sv_cluster(inp, tmp_path):
    out = str(tmp_path / "clustered.vcf")
    assert TOOL_REGISTRY["SVCluster"](["-V", inp["a"], "-V", inp["b"], "-O", out]) == 0
    lines = [ln.split("\t") for ln in open(out) if not ln.startswith("#")]
    assert sorted(ln[4] for ln in lines) == ["<DEL>", "<DUP>", "<INV>"]
    del_line = next(ln for ln in lines if ln[4] == "<DEL>")
    assert "a_del" in del_line[7] and "b_del" in del_line[7]


def test_collect_and_print_sv_evidence(inp, tmp_path):
    sr, pe = tmp_path / "o.sr.txt.gz", tmp_path / "o.pe.txt.gz"
    assert TOOL_REGISTRY["CollectSVEvidence"](["-I", inp["evidence_bam"], "--sr-file", str(sr),
                                               "--pe-file", str(pe)]) == 0
    sr_rows = [l.split("\t") for l in gzip.open(sr, "rt").read().splitlines()]
    assert ["chr1", "150", "right", "2", "S1"] in sr_rows
    assert ["chr1", "200", "left", "1", "S1"] in sr_rows
    pe_rows = [l.split("\t") for l in gzip.open(pe, "rt").read().splitlines()]
    assert pe_rows == [["chr1", "300", "+", "chr2", "5000", "+", "S1"]]
    out = tmp_path / "subset.sr.txt"
    assert TOOL_REGISTRY["PrintSVEvidence"](["-F", str(sr), "-O", str(out), "-L",
                                             "chr1:140-160"]) == 0
    assert [l.split("\t") for l in out.read_text().splitlines()] == \
        [["chr1", "150", "right", "2", "S1"]]


def test_sv_concordance(inp, tmp_path):
    out = str(tmp_path / "conc.vcf")
    assert TOOL_REGISTRY["SVConcordance"](["--eval", inp["eval"], "--truth", inp["truth"],
                                           "-O", out]) == 0
    recs = {v.id: v for v in vcfio.VcfReader(out)}
    e1 = recs["E1"].info
    assert e1["TRUTH_VID"] == "T1" and float(e1["TRUTH_RECIPROCAL_OVERLAP"]) > 0.98
    assert e1["TRUTH_DISTANCE_START"] == "50"
    assert e1["TRUTH_AC"] == "3" and e1["TRUTH_AN"] == "4"
    assert e1["GENOTYPE_CONCORDANCE"] == "0.500000"
    assert e1["HET_SENSITIVITY"] == "1.000000" and e1["HET_PPV"] == "0.500000"
    assert "TRUTH_VID" not in recs["E2"].info


def test_joint_germline_cnv_segmentation(inp, tmp_path):
    out = str(tmp_path / "joint.vcf")
    assert TOOL_REGISTRY["JointGermlineCNVSegmentation"](["-V", inp["cnv_a"], "-V", inp["cnv_b"],
                                                          "-O", out]) == 0
    recs = list(vcfio.VcfReader(out))
    assert len(recs) == 2
    dele = next(r for r in recs if r.alts == ("<DEL>",))
    dup = next(r for r in recs if r.alts == ("<DUP>",))
    assert dele.info["AC"] == "2" and dele.info["AN"] == "2"
    gts = dict(zip(["A", "B"], dele.samples))
    assert gts["A"]["CN"] == "1" and gts["B"]["CN"] == "0"
    assert dup.info["AC"] == "1"
    gts = dict(zip(["A", "B"], dup.samples))
    assert gts["A"]["GT"] == "0" and gts["A"]["CN"] == "2" and gts["B"]["CN"] == "4"


def test_imprecise_deletion_from_read_pairs(inp, tmp_path):
    out = str(tmp_path / "imp.vcf")
    assert TOOL_REGISTRY["StructuralVariationDiscoveryPipelineSpark"](
        ["-I", inp["imp_bam"], "-R", inp["imp_fa"], "-O", out]) == 0
    imp = [l.split("\t") for l in open(out) if not l.startswith("#") and "IMPRECISE" in l]
    assert imp
    info = dict(kv.split("=", 1) for kv in imp[0][7].split(";") if "=" in kv)
    assert "CIPOS" in info and "CIEND" in info and int(info["READ_PAIR_SUPPORT"]) >= 8
    assert abs(int(imp[0][1]) - 5000) < 600 and abs(int(info["END"]) - 7000) < 600


def test_external_evidence_integration(tmp_path):
    rng = np.random.default_rng(4)
    ref = _seq(rng, 4000)
    fa = _ref(tmp_path / "r.fa", ref)
    bam_path = _write_bam(tmp_path / "r.bam", [("chr1", 4000)],
                          [_m(f"r{i}", 1500 + 20 * i, 120, ref[1500 + 20 * i:1620 + 20 * i])
                           for i in range(30)])
    ext = tmp_path / "ev.bed"
    ext.write_text("chr1\t1900\t1910\n")
    out, tsv = str(tmp_path / "contigs.bam"), str(tmp_path / "links.tsv")
    argv = ["-I", bam_path, "-R", fa, "-O", out, "--target-link-file", tsv]
    assert TOOL_REGISTRY["FindBreakpointEvidenceSpark"](argv) == 0
    assert "evidence_cluster" not in open(tsv).read()
    assert TOOL_REGISTRY["FindBreakpointEvidenceSpark"](argv + ["--external-evidence",
                                                                str(ext)]) == 0
    body = open(tsv).read()
    assert "evidence_cluster" in body and "chr1\t1906" in body


# ----------------------- the SV parts of tests/test_new_tools_r4.py and tests/test_misc_tools.py


def test_structural_variant_discoverer(inp, tmp_path):
    out = str(tmp_path / "sv.vcf")
    assert TOOL_REGISTRY["StructuralVariantDiscoverer"](["-I", inp["contigs"], "-O", out]) == 0
    by_type = {}
    for r in (l.split("\t") for l in open(out) if not l.startswith("#")):
        info = dict(kv.split("=", 1) for kv in r[7].split(";") if "=" in kv)
        by_type.setdefault(info["SVTYPE"], []).append((r, info))
    assert {"DEL", "INS", "INV", "BND"} <= set(by_type)
    (r, info), = by_type["DEL"]
    assert int(r[1]) == 1100 and int(info["SVLEN"]) == -500 and info["CTGS"] == "ctg_del"
    (r, info), = by_type["INS"]
    assert int(info["SVLEN"]) == 100
    (r, info), = by_type["INV"]
    assert int(info["END"]) - int(r[1]) >= 50


def test_sv_discovery_pipeline_end_to_end(inp, tmp_path):
    out = str(tmp_path / "sv.vcf")
    assert TOOL_REGISTRY["StructuralVariationDiscoveryPipelineSpark"](
        ["-I", inp["del_bam"], "-R", inp["del_fa"], "-O", out]) == 0
    dels = [l.split("\t") for l in open(out) if not l.startswith("#") and "SVTYPE=DEL" in l]
    assert dels
    info = dict(kv.split("=", 1) for kv in dels[0][7].split(";") if "=" in kv)
    assert abs(int(dels[0][1]) - 1500) <= 20 and abs(abs(int(info["SVLEN"])) - 400) <= 20


def test_find_breakpoint_evidence(inp, tmp_path):
    out_bam, tsv = str(tmp_path / "contigs.bam"), str(tmp_path / "evidence.tsv")
    assert TOOL_REGISTRY["FindBreakpointEvidenceSpark"](
        ["-I", inp["del_bam"], "-R", inp["del_fa"], "-O", out_bam,
         "--target-link-file", tsv]) == 0
    assert "evidence_cluster" in open(tsv).read()
    contigs = list(bamio.BamReader(out_bam))
    assert contigs and all(c.name.startswith("asm") for c in contigs)


def test_sv_utility_tools(inp, tmp_path):
    ev = str(tmp_path / "ev.tsv")
    assert TOOL_REGISTRY["ExtractSVEvidenceSpark"](["-I", inp["split_bam"], "-O", ev]) == 0
    text = open(ev).read()
    assert "SplitRead" in text and "SplitAlignment" in text and "DiscordantPair" in text
    out_bam = str(tmp_path / "sub.bam")
    assert TOOL_REGISTRY["ExtractOriginalAlignmentRecordsByNameSpark"](
        ["-I", inp["split_bam"], "-O", out_bam, "--read-name-file", inp["names"]]) == 0
    assert {r.name for r in bamio.BamReader(out_bam)} == {"a", "c"}
    bad = str(tmp_path / "bad.txt")
    assert TOOL_REGISTRY["FindBadGenomicKmersSpark"](
        ["-R", inp["repeat_fa"], "-O", bad, "--kmer-size", "31", "--max-kmer-freq", "3"]) == 0
    kmers = open(bad).read().split()
    assert kmers and all(len(k) == 31 for k in kmers)
    meta = str(tmp_path / "meta.txt")
    assert TOOL_REGISTRY["CalcMetadataSpark"](["-I", inp["split_bam"], "-O", meta]) == 0
    assert "coverage" in open(meta).read()


def test_site_depth_to_baf(inp, tmp_path):
    out = tmp_path / "baf.tsv"
    assert TOOL_REGISTRY["SiteDepthtoBAF"](["-F", inp["site_depth"], "--baf-sites-vcf",
                                            inp["baf_sites"], "-O", str(out)]) == 0
    rows = out.read_text().strip().splitlines()
    assert len(rows) == 1
    contig, pos, sample, baf = rows[0].split("\t")
    assert (contig, pos, sample) == ("chr1", "99", "S1") and float(baf) == 0.5


def test_condense_depth_evidence(inp, tmp_path):
    out = tmp_path / "m.txt"
    assert TOOL_REGISTRY["CondenseDepthEvidence"](["-F", inp["depth"], "-O", str(out),
                                                   "--max-interval-size", "200"]) == 0
    rows = [l for l in out.read_text().splitlines() if not l.startswith("#")]
    assert rows == ["chr1\t0\t200\t8\t8", "chr1\t200\t300\t2\t2", "chr1\t500\t600\t9\t9"]


def test_sv_stratify_and_grouped_cluster(inp, tmp_path):
    out = tmp_path / "strat.vcf"
    assert TOOL_REGISTRY["SVStratify"](["-V", inp["strat_vcf"], "-O", str(out),
                                        "--stratify-config", inp["strata"]]) == 0
    assert [r.info["STRAT"] for r in vcfio.VcfReader(str(out))] == \
        ["DEL_small", "DEL_large", "default"]
    assert TOOL_REGISTRY["SVStratify"](["-V", inp["strat_vcf"], "-O", str(out),
                                        "--stratify-config", inp["strata_sd"], "--track-name", "SD",
                                        "--track-intervals", inp["track"],
                                        "--stratify-overlap-fraction", "0.5"]) == 0
    assert [r.info["STRAT"] for r in vcfio.VcfReader(str(out))] == ["DEL_SD", "default",
                                                                      "default"]
    cl = tmp_path / "cl.vcf"
    assert TOOL_REGISTRY["GroupedSVCluster"](["-V", inp["strat_vcf"], "-V", inp["strat_b"],
                                              "-O", str(cl), "--stratify-config",
                                              inp["strata"]]) == 0
    assert len(list(vcfio.VcfReader(str(cl)))) == 3  # the two small DELs merge


# ------------------------------------ gatk_tpu's tests/test_cpx_reinterpreter.py, on both


def _cpx(variant_cls, interval_cls, interval, alt_len, segments, arrangement):
    iv = interval_cls(interval)
    info = {"END": str(iv.end), "SVTYPE": "CPX", "SEQ_ALT_HAPLOTYPE": "A" * alt_len,
            "CTG_NAMES": "asm000001:tig00001"}
    if arrangement:
        info["ALT_ARRANGEMENT"] = ",".join(arrangement)
    if segments:
        info["SEGMENTS"] = ",".join(segments)
    return variant_cls(contig=iv.contig, pos=iv.start - 1, ref="N", alts=("<CPX>",),
                       id=f"CPX_{interval}", info=info)


def _brief(records):
    return sorted((r.id, r.pos + 1, r.ref, r.alts[0], int(r.info["END"]), int(r.info["SVLEN"]),
                   r.info["SVTYPE"]) for r in records)


# the reference's SegmentedCpxVariantSimpleVariantExtractorUnitTest cases:
# extractor, interval, alt length, segments, arrangement, reference bases
# ({(contig, pos1): base}, N elsewhere), the simple variants expected
CPX_CASES = [
    ("zero_one", "chr20:51740560-51740561", 551, [], ["-chr18:11642876-11642927", "UINS-496"],
     {("chr20", 51740560): "A"},
     [("INS_chr20_51740560_51740560", 51740560, "A", "<INS>", 51740560, 549, "INS")]),
    ("zero_one", "chr21:402806-402905", 98, ["chr21:402807-402904"], ["-1"], {},
     [("INV_chr21_402806_402904", 402806, "N", "<INV>", 402904, 0, "INV")]),
    ("zero_one", "chr21:402806-402905", 149, ["chr21:402807-402904"],
     ["UINS-24", "1", "UINS-25"], {}, []),
    ("zero_one", "chr20:18675721-18675877", 565, ["chr20:18675721-18675877"],
     ["1", "UINS-28", "1", "UINS-64", "1"], {("chr20", 18675720): "A"},
     [("INS_chr20_18675720_18675720", 18675720, "A", "<INS>", 18675720, 408, "INS")]),
    ("zero_one", "chr20:64096905-64097041", 455, ["chr20:64096905-64097041"],
     ["1", "1", "UINS-166"], {("chr20", 64096904): "A", ("chr20", 64097041): "G"},
     [("INS_chr20_64097041_64097041", 64097041, "A", "<INS>", 64097041, 318, "INS")]),
    ("zero_one", "chr20:51740560-51741035", 1075, ["chr20:51740561-51741034"],
     ["-chr18:11642876-11642927", "UINS-496", "1", "UINS-49"],
     {("chr20", 51740560): "A", ("chr20", 51741034): "T"},
     [("INS_chr20_51740560_51740560", 51740560, "A", "<INS>", 51740560, 549, "INS"),
      ("INS_chr20_51741034_51741034", 51741034, "T", "<INS>", 51741034, 50, "INS")]),
    ("zero_one", "chr20:20269131-20269199", 35, ["chr20:20269131-20269199"],
     ["-chrX:137700299-137700331"], {("chr20", 20269131): "A"},
     [("DEL_chr20_20269131_20269198", 20269131, "A", "<DEL>", 20269198, -67, "DEL")]),
    ("zero_one", "chr20:54849491-54849615", 140, ["chr20:54849491-54849615"],
     ["UINS-36", "-chr14:58474127-58474172", "UINS-54"], {("chr20", 54849491): "C"},
     [("DEL_chr20_54849491_54849614", 54849491, "C", "<DEL>", 54849614, -123, "DEL"),
      ("INS_chr20_54849491_54849491", 54849491, "C", "<INS>", 54849491, 140, "INS")]),
    ("zero_one", "chr20:12558793-12558810", 151, ["chr20:12558793-12558810"],
     ["-chrX:99014092-99014129", "UINS-101"],
     {("chr20", p): "A" for p in range(12558793, 12558810)},
     [("INS_chr20_12558793_12558809", 12558793, "A" * 17, "<INS>", 12558809, 133, "INS")]),
    ("multi", "chr21:21264944-21265096", 367,
     ["chr21:21264944-21264988", "chr21:21264988-21265052", "chr21:21265052-21265096"],
     ["1", "2", "3", "2", "1", "2", "3"], {("chr21", 21264943): "G"},
     [("INS_chr21_21264943_21264943", 21264943, "G", "<INS>", 21264943, 221, "INS")]),
    ("multi", "chr20:61919906-61920109", 745,
     ["chr20:61919906-61919908", "chr20:61919908-61920054", "chr20:61920054-61920109"],
     ["1", "2", "3", "UINS-177", "1", "2", "2", "3"], {("chr20", 61920109): "G"},
     [("INS_chr20_61920109_61920109", 61920109, "G", "<INS>", 61920109, 531, "INS")]),
    ("multi", "chr20:38653054-38653283", 715,
     ["chr20:38653054-38653113", "chr20:38653113-38653145", "chr20:38653145-38653179",
      "chr20:38653179-38653273", "chr20:38653273-38653283"],
     ["1", "2", "3", "4", "3", "1", "2", "3", "4", "5", "2", "3", "4", "5"],
     {("chr20", 38653053): "A", ("chr20", 38653283): "G"},
     [("INS_chr20_38653053_38653053", 38653053, "A", "<INS>", 38653053, 259, "INS"),
      ("INS_chr20_38653283_38653283", 38653283, "G", "<INS>", 38653283, 175, "INS")]),
    ("multi", "chr20:23122561-23122996", 143,
     ["chr20:23122561-23122596", "chr20:23122596-23122666", "chr20:23122666-23122996"],
     ["1", "2", "-1"], {("chr20", 23122666): "C"},
     [("DEL_chr20_23122666_23122995", 23122666, "C", "<DEL>", 23122995, -329, "DEL")]),
    ("multi", "chr20:34732145-34733344", 61,
     ["chr20:34732145-34733303", "chr20:34733303-34733342", "chr20:34733342-34733344"],
     ["-3", "-2", "UINS-14", "3"], {("chr20", 34732145): "A"},
     [("DEL_chr20_34732145_34733302", 34732145, "A", "<DEL>", 34733302, -1157, "DEL")]),
    ("multi", "chr21:26001843-26002386", 541,
     ["chr21:26001844-26002384", "chr21:26002384-26002386"], ["-1"], {("chr21", 26001844): "T"},
     [("INV_chr21_26001843_26002384", 26001843, "T", "<INV>", 26002384, 0, "INV")]),
    ("multi", "chr21:23428920-23429023", 234,
     ["chr21:23428920-23428968", "chr21:23428968-23428998", "chr21:23428998-23429023"],
     ["UINS-84", "2", "3", "UINS-5", "2", "2", "3"], {("chr21", 23428920): "T"},
     [("INS_chr21_23428920_23428920", 23428920, "T", "<INS>", 23428920, 85, "INS")]),
    ("multi", "chr20:13062977-13063278", 373,
     ["chr20:13062977-13063037", "chr20:13063037-13063272", "chr20:13063272-13063278"],
     ["1", "-2", "-1", "UINS-14"], {("chr20", 13063037): "G"},
     [("INV_chr20_13063036_13063272", 13063036, "G", "<INV>", 13063272, 0, "INV")]),
    ("multi", "chr21:36680290-36680686", 665,
     ["chr21:36680290-36680331", "chr21:36680331-36680659", "chr21:36680659-36680686"],
     ["1", "2", "1", "UINS-249"], {("chr21", 36680686): "A"},
     [("INS_chr21_36680686_36680686", 36680686, "A", "<INS>", 36680686, 250, "INS")]),
    ("multi", "chr20:8888822-8895655", 655,
     ["chr20:8888822-8895288", "chr20:8895288-8895361", "chr20:8895361-8895655"],
     ["UINS-297", "2", "UINS-280"],
     {("chr20", 8888822): "G", ("chr20", 8895361): "T", ("chr20", 8895655): "C"},
     [("DEL_chr20_8888822_8895287", 8888822, "G", "<DEL>", 8895287, -6465, "DEL"),
      ("DEL_chr20_8895361_8895654", 8895361, "T", "<DEL>", 8895654, -293, "DEL"),
      ("INS_chr20_8888822_8888822", 8888822, "G", "<INS>", 8888822, 298, "INS"),
      ("INS_chr20_8895655_8895655", 8895655, "C", "<INS>", 8895655, 281, "INS")]),
]


@pytest.mark.parametrize("case", CPX_CASES, ids=[f"{c[0]}-{c[1]}" for c in CPX_CASES])
def test_cpx_extraction_identical_to_jax(case):
    kind, interval, alt_len, segments, arrangement, bases, want = case
    got = {}
    for name, mod, variant_cls in (("port", cpx_mod, Variant), ("jax", jax_cpx, JaxVariant)):
        v = _cpx(variant_cls, mod.Interval1, interval, alt_len, segments, arrangement)
        extract = mod.extract_zero_one_segment if kind == "zero_one" else mod.extract_multi_segment
        out = extract(v, lambda contig, pos1: bases.get((contig, pos1), "N"))
        assert all(r.info["CPX_EVENT"] == v.id for r in out)
        got[name] = _brief(out)
    assert got["port"] == got["jax"] == want


def test_cpx_helpers():
    for mod in (cpx_mod, jax_cpx):
        assert mod.get_ins_len("UINS-496", []) == 496
        assert mod.get_ins_len("2", [45, 65, 45]) == 65
        assert mod.get_ins_len("-2", [45, 65, 45]) == 65
        assert mod.get_ins_len("-chr18:11642876-11642927", []) == 52
        assert mod.find_all_segments(["1", "2", "3", "2", "1", "2", "3"], 3) == 4
        assert mod.find_all_segments(["1", "2", "3", "UINS-177", "1", "2", "2", "3"], 3) == 0
        assert mod.find_all_segments(["1", "2", "3", "4", "3", "1", "2", "3", "4", "5", "2", "3",
                                      "4", "5"], 5) == 5
        assert mod.find_all_segments(["1", "2", "-1"], 3) == -1
        assert mod.find_all_segments(["UINS-84", "2", "3", "UINS-5", "2", "2", "3"], 3) == -1
        a, b = mod.Interval1("chr20:8888822-8895288"), mod.Interval1("chr20:8895361-8895655")
        assert [repr(i) for i in mod.compactify_missing([b, a])] == [repr(a), repr(b)]
        merged = mod.compactify_missing([mod.Interval1("chr1:100-200"),
                                         mod.Interval1("chr1:200-300")])
        assert len(merged) == 1 and (merged[0].start, merged[0].end) == (100, 300)


def test_cpx_tool_end_to_end(inp, tmp_path):
    prefix = str(tmp_path / "out")
    assert not TOOL_REGISTRY["CpxVariantReInterpreterSpark"](
        ["--cpx-vcf", inp["cpx"], "-R", inp["cpx_fa"], "--prefix-out-vcf", prefix])
    one = [l for l in open(prefix + "_1_seg.vcf") if not l.startswith("#")]
    multi = [l for l in open(prefix + "_multi_seg.vcf") if not l.startswith("#")]
    assert len(one) == 1 and "SVTYPE=INS" in one[0] and one[0].split("\t")[2] == "INS_chr1_100_100"
    assert len(multi) == 1 and "SVTYPE=DEL" in multi[0]
    assert multi[0].split("\t")[2] == "DEL_chr1_200_299"
