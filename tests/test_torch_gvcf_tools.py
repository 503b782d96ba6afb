"""Joint genotyping through the port (gatk_tpu_torch) against gatk_tpu, on the CPU.

A synthetic trio over one reference (utils/synthetic.write_trio: 3,000 bp, a
mother, a father and their child at 1,000 reads of 151 bp each, 3 SNVs and 1
indel with Mendelian genotypes) goes through HaplotypeCaller -ERC GVCF in both
packages, the port given --device cpu (the plain matrix PairHMM). Then both
packages' CombineGVCFs, GenotypeGVCFs (from the combined GVCF and from a
GenomicsDBImport workspace), ReblockGVCF, CalculateGenotypePosteriors with the
trio's pedigree and GnarlyGenotyper run on the same three GVCFs. Tolerance:
none; every output is byte-identical. The depth is 1,000 reads, not 2,000:
the plain PairHMM on the CPU takes 20 s for one active region of the trio's
mother at that depth, and its time grows with the reads.

The reference-free cases of tests/test_gvcf_tools.py follow, re-pointed at the
port; its GnarlyGenotyper case reads a GVCF of the reference data, so here it
reads the trio's combined GVCF.
"""
import contextlib
import io
import os
import shutil

import numpy as np
import pytest

from gatk_tpu.cli import TOOL_REGISTRY as JAX_TOOLS
from gatk_tpu_torch import cli as port_cli
from gatk_tpu_torch.utils import synthetic
from tests.test_torch_pairhmm import one_torch_thread  # noqa: F401

SAMPLES = synthetic.TRIO_SAMPLES


def _run(pkg, argv):
    with contextlib.redirect_stdout(io.StringIO()):
        if pkg == "jax":
            return JAX_TOOLS[argv[0]](argv[1:])
        return port_cli.main(argv)


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


@pytest.fixture(scope="module")
def trio(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_trio"))
    return synthetic.write_trio(os.path.join(d, "trio"), seed=0, length=3000, n_reads=1000,
                                n_snv=3, n_indel=1)


@pytest.fixture(scope="module")
def gvcfs(trio, tmp_path_factory):
    """Each package's HaplotypeCaller -ERC GVCF of each sample: {pkg: {sample: path}}."""
    d = str(tmp_path_factory.mktemp("torch_trio_gvcf"))
    out = {}
    for pkg in ("jax", "port"):
        device = ["--device", "cpu"] if pkg == "port" else []
        out[pkg] = {}
        for sm, bam in trio["bams"].items():
            out[pkg][sm] = os.path.join(d, f"{pkg}.{sm}.g.vcf")
            assert _run(pkg, ["HaplotypeCaller", "-I", bam, "-R", trio["fasta"], "-ERC", "GVCF",
                              "-O", out[pkg][sm], *device]) == 0
    return out


@pytest.mark.parametrize("sample", SAMPLES)
def test_erc_gvcf_identical_to_jax(gvcfs, sample):
    got = _read(gvcfs["port"][sample])
    assert got == _read(gvcfs["jax"][sample])
    assert b"END=" in got and b"<NON_REF>" in got


@pytest.fixture(scope="module")
def joint(trio, gvcfs, tmp_path_factory):
    """Both packages' joint-genotyping tools on gatk_tpu's three GVCFs:
    {pkg: {output name: path}}."""
    d = str(tmp_path_factory.mktemp("torch_trio_joint"))
    vs = sum((["-V", gvcfs["jax"][sm]] for sm in SAMPLES), [])
    ref = ["-R", trio["fasta"]]
    out = {}
    for pkg in ("jax", "port"):
        o = {name: os.path.join(d, f"{pkg}.{name}") for name in (
            "combined.g.vcf", "genotyped.vcf", "gendb.vcf", "reblocked.g.vcf",
            "posteriors.vcf", "gnarly.vcf", "all_sites.vcf")}
        ws = os.path.join(d, f"{pkg}.ws")
        shutil.rmtree(ws, ignore_errors=True)
        steps = [
            ["CombineGVCFs", *vs, *ref, "-O", o["combined.g.vcf"]],
            ["GenotypeGVCFs", "-V", o["combined.g.vcf"], *ref, "-O", o["genotyped.vcf"]],
            ["GenomicsDBImport", *vs[:4], "--genomicsdb-workspace-path", ws],
            ["GenomicsDBImport", *vs[4:], "--genomicsdb-update-workspace-path", ws],
            ["GenotypeGVCFs", "-V", f"gendb://{ws}", *ref, "-O", o["gendb.vcf"]],
            ["ReblockGVCF", "-V", gvcfs["jax"]["CHILD"], *ref, "-O", o["reblocked.g.vcf"]],
            ["CalculateGenotypePosteriors", "-V", o["genotyped.vcf"], "-ped", trio["ped"],
             "-O", o["posteriors.vcf"]],
            ["GnarlyGenotyper", "-V", o["combined.g.vcf"], *ref, "-O", o["gnarly.vcf"]],
            ["GenotypeGVCFs", "-V", o["combined.g.vcf"], *ref, "--include-non-variant-sites",
             "-O", o["all_sites.vcf"]],
        ]
        for argv in steps:
            assert _run(pkg, argv) == 0, argv
        out[pkg] = o
    return out


@pytest.mark.parametrize("name", ["combined.g.vcf", "genotyped.vcf", "gendb.vcf",
                                  "reblocked.g.vcf", "posteriors.vcf", "gnarly.vcf"])
def test_joint_output_identical_to_jax(joint, name):
    got = _read(joint["port"][name])
    assert got == _read(joint["jax"][name])
    assert any(not ln.startswith(b"#") for ln in got.splitlines())


def test_gendb_path_equals_combine_path(joint):
    """GenotypeGVCFs on gendb:// (two imports, the second an update) writes
    what the CombineGVCFs path writes (tests/test_gendb.py:65 for gatk_tpu)."""
    assert _read(joint["port"]["gendb.vcf"]) == _read(joint["port"]["genotyped.vcf"])


def _genotypes(path):
    names, recs = [], []
    for line in _read(path).decode().splitlines():
        if line.startswith("#CHROM"):
            names = line.split("\t")[9:]
        elif not line.startswith("#"):
            f = line.split("\t")
            recs.append((int(f[1]) - 1, f[3], f[4],
                         dict(zip(names, (s.split(":")[0] for s in f[9:])))))
    return recs


def test_planted_genotypes_are_called(trio, joint):
    """Every planted site is a record holding each sample's planted genotype,
    and the child's genotypes follow Mendel's rules."""
    recs = _genotypes(joint["port"]["genotyped.vcf"])
    assert {g for gts in trio["genotypes"].values() for g in gts} == {"0/0", "0/1", "1/1"}
    for k, v in enumerate(trio["variants"]):
        at = [r for r in recs if abs(r[0] - v.pos) <= 20
              and len(r[1]) - len(r[2]) == len(v.ref) - len(v.alt)]
        assert len(at) == 1, v
        assert at[0][3] == {sm: trio["genotypes"][sm][k] for sm in SAMPLES}, v


def test_include_non_variant_sites_keeps_blocks_unexpanded(trio, joint):
    """gatk_tpu's fault, carried as-is (gvcf_tools.py:48): with
    --include-non-variant-sites a hom-ref block of the combined GVCF gives one
    record, not one per position; both packages write the same."""
    got = _read(joint["port"]["all_sites.vcf"])
    assert got == _read(joint["jax"]["all_sites.vcf"])
    records = [ln for ln in got.splitlines() if not ln.startswith(b"#")]
    assert len(trio["variants"]) < len(records) < trio["length"]


# ---- tests/test_gvcf_tools.py's reference-free cases, on the port


def test_format_vcf_double():
    from gatk_tpu_torch.gvcf.annotations import format_vcf_double

    assert format_vcf_double(1.169) == "1.17"
    assert format_vcf_double(0.937) == "0.937"
    assert format_vcf_double(-0.866) == "-8.660e-01"
    assert format_vcf_double(1.0) == "1.00"
    assert format_vcf_double(0.5) == "0.500"


def test_fisher_and_sor():
    from gatk_tpu_torch.gvcf.annotations import fisher_strand_phred, strand_odds_ratio

    assert fisher_strand_phred(0, 1, 46, 33) == pytest.approx(3.716, abs=2e-3)
    assert strand_odds_ratio(0, 1, 46, 33) == pytest.approx(0.771, abs=1e-3)
    assert strand_odds_ratio(0, 0, 0, 0) == pytest.approx(0.693, abs=1e-3)


def test_expand_ref_block_pl():
    from gatk_tpu_torch.gvcf.combine import _expand_ref_block_pl

    assert _expand_ref_block_pl([0, 18, 270], 3) == [0, 18, 270, 18, 270, 270]


def test_gvcf_block_writer_banding():
    from gatk_tpu_torch.gvcf.refconf import GvcfBlockWriter

    w = GvcfBlockWriter("20", "S")
    for pos, gq in [(10, 99), (11, 99), (12, 45), (13, 45), (14, 61), (15, 65)]:
        w.add_hom_ref(pos, "A", [0, gq, 2 * gq], 30)
    w.flush()
    assert len(w.records) == 3
    b1, b2, b3 = w.records
    assert (b1.pos, b1.end) == (10, 12)
    assert (b2.pos, b2.end) == (12, 14)
    assert (b3.pos, b3.end) == (14, 16)
    assert b2.samples[0]["GQ"] == "45"
    assert b3.samples[0]["GQ"] == "61"
    assert b2.samples[0]["MIN_DP"] == "30"


def test_indel_pls_monotone():
    from gatk_tpu_torch.gvcf.refconf import indel_pls

    assert list(indel_pls(2, 0)) == [0, 0, 0]
    p5, p40 = indel_pls(2, 5), indel_pls(2, 40)
    assert p5[0] == 0 and p40[1] > p5[1] > 0


def test_ref_vs_any_gls_clean_pileup():
    from gatk_tpu_torch.gvcf.refconf import ref_vs_any_gls
    from gatk_tpu_torch.io import sam
    from gatk_tpu_torch.io.reads import Read

    reads = [Read(f"r{i}", 0, 0, 0, 60, np.array([sam.OP_M], np.uint8),
                  np.array([20], np.int32), np.full(20, ord("A"), np.uint8),
                  np.full(20, 30, np.uint8)) for i in range(10)]
    pls, dp = ref_vs_any_gls(reads, 0, 20, np.full(20, ord("A"), np.uint8))
    assert (dp == 10).all()
    assert (pls[:, 0] == 0).all() and (pls[:, 1] > 0).all()


def test_gnarly_genotyper(joint):
    """GnarlyGenotyper's records carry no NON_REF, AC/AF/AN and the
    ExcessHet/FS/SOR annotations, a positive QUAL and called genotypes."""
    rows = [ln.split("\t") for ln in _read(joint["port"]["gnarly.vcf"]).decode().splitlines()
            if not ln.startswith("#")]
    assert rows
    for r in rows:
        info = dict(kv.split("=", 1) for kv in r[7].split(";") if "=" in kv)
        assert "<NON_REF>" not in r[4]
        for key in ("AC", "AF", "AN", "ExcessHet", "FS", "SOR"):
            assert key in info, (r[1], key)
        assert float(r[5]) > 0
        assert all("/" in s.split(":")[0] for s in r[9:])


def _write_gvcf(path, sample, records):
    with open(path, "w") as fh:
        fh.write("##fileformat=VCFv4.2\n##contig=<ID=chrM,length=300>\n")
        for key, num, kind in (("GT", "1", "String"), ("AD", "R", "Integer"),
                               ("DP", "1", "Integer"), ("GQ", "1", "Integer"),
                               ("PL", "G", "Integer")):
            fh.write(f'##FORMAT=<ID={key},Number={num},Type={kind},Description="{key}">\n')
        fh.write('##INFO=<ID=END,Number=1,Type=Integer,Description="end">\n'
                 '##ALT=<ID=NON_REF,Description="non-ref">\n'
                 f"#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t{sample}\n")
        for r in records:
            fh.write("\t".join(str(x) for x in r) + "\n")


def test_combine_gives_zero_pls_to_alleles_a_record_lacks(tmp_path):
    """gatk_tpu's fault, carried as-is (gvcf/combine.py:_remap_pls): where
    another sample brings an allele (T) that a sample's variant record lacks,
    the combined record gives that sample PL 0 for every genotype holding it
    (GATK takes the <NON_REF> likelihoods), and GenotypeGVCFs cannot call the
    sample: a het with PL 600,0,700 comes out ./. with GQ 0. chip_smoke.py's
    trio phase meets it where one parent's record holds a sequencing error as
    a second allele: the other parent comes out ./."""
    ref = tmp_path / "ref.fa"
    seq = "A" * 99 + "G" + "A" * 200
    ref.write_text(">chrM\n" + seq + "\n")
    (tmp_path / "ref.fa.fai").write_text("chrM\t300\t6\t300\t301\n")
    a, b = str(tmp_path / "a.g.vcf"), str(tmp_path / "b.g.vcf")
    _write_gvcf(a, "A", [
        ("chrM", 1, ".", "A", "<NON_REF>", ".", ".", "END=99", "GT:DP:GQ:PL", "0/0:30:99:0,90,1200"),
        ("chrM", 100, ".", "G", "C,<NON_REF>", 600.0, ".", ".", "GT:AD:DP:GQ:PL",
         "0/1:14,16,0:30:99:600,0,700,680,750,1400"),
        ("chrM", 101, ".", "A", "<NON_REF>", ".", ".", "END=300", "GT:DP:GQ:PL",
         "0/0:28:95:0,95,1100")])
    _write_gvcf(b, "B", [
        ("chrM", 1, ".", "A", "<NON_REF>", ".", ".", "END=99", "GT:DP:GQ:PL", "0/0:30:99:0,90,1200"),
        ("chrM", 100, ".", "G", "C,T,<NON_REF>", 500.0, ".", ".", "GT:AD:DP:GQ:PL",
         "0/1:15,14,1,0:30:99:500,0,650,560,700,1300,700,800,1400,1500"),
        ("chrM", 101, ".", "A", "<NON_REF>", ".", ".", "END=300", "GT:DP:GQ:PL",
         "0/0:28:95:0,95,1100")])
    out = {}
    for pkg in ("jax", "port"):
        comb, joint = str(tmp_path / f"{pkg}.g.vcf"), str(tmp_path / f"{pkg}.vcf")
        assert _run(pkg, ["CombineGVCFs", "-V", a, "-V", b, "-R", str(ref), "-O", comb]) == 0
        assert _run(pkg, ["GenotypeGVCFs", "-V", comb, "-R", str(ref), "-O", joint]) == 0
        out[pkg] = (_read(comb), _read(joint))
    assert out["port"] == out["jax"]
    site = [ln.split("\t") for ln in out["port"][0].decode().splitlines()
            if ln.startswith("chrM\t100\t")][0]
    assert site[4] == "C,T,<NON_REF>"
    pl_a = site[9].split(":")[-1].split(",")  # G/G G/C C/C G/T C/T T/T ...
    assert pl_a[:6] == ["600", "0", "700", "0", "0", "0"]
    (call,) = [ln.split("\t") for ln in out["port"][1].decode().splitlines()
               if ln.startswith("chrM\t100\t")]
    assert call[9].split(":")[0] == "./."


def test_ref_block_with_a_het_pl_is_called_het(tmp_path):
    """gatk_tpu's fault, carried as-is: a hom-ref call whose PL is least at
    0/NON_REF enters the GVCF block writer as a hom-ref site
    (calling/hc_engine.py, the GT 0/0 branch of the -ERC GVCF writer), its GQ
    taken as the gap between its two least PLs wherever the least is
    (gvcf/refconf.py:_gq_from_pls), and the block keeps that site's PL over
    all of its positions (GvcfBlockWriter.add_hom_ref); GenotypeGVCFs then
    calls a het anywhere in the block. chip_smoke.py's trio phase meets it:
    the child's block after a het deletion carries PL 2335,0,2186, and the
    child comes out 0/1 at a planted site where both parents are het and the
    child is hom-ref."""
    from gatk_tpu.gvcf import refconf as jax_refconf
    from gatk_tpu_torch.gvcf import refconf as port_refconf

    blocks = []
    for mod in (jax_refconf, port_refconf):
        w = mod.GvcfBlockWriter("chrM", "CHILD")
        w.add_hom_ref(100, "A", [2335, 0, 2186], 180)
        for pos in range(101, 200):
            w.add_hom_ref(pos, "A", [0, 540, 6636], 175)
        w.flush()
        blocks.append([(r.pos, r.info, r.samples[0]) for r in w.records])
    assert blocks[0] == blocks[1]
    (block,) = blocks[1]
    assert block[1] == {"END": "200"} and block[2]["GQ"] == "99"
    assert block[2]["PL"] == "2335,0,2186"

    ref = tmp_path / "ref.fa"
    ref.write_text(">chrM\n" + "A" * 300 + "\n")
    (tmp_path / "ref.fa.fai").write_text("chrM\t300\t6\t300\t301\n")
    het = ("chrM", 151, ".", "A", "C,<NON_REF>", 600.0, ".", ".", "GT:AD:DP:GQ:PL",
           "0/1:14,16,0:30:99:600,0,700,680,750,1400")
    paths = []
    for sm, records in (
            ("MOTHER", [("chrM", 1, ".", "A", "<NON_REF>", ".", ".", "END=150", "GT:DP:GQ:PL",
                         "0/0:30:99:0,90,1200"), het,
                        ("chrM", 152, ".", "A", "<NON_REF>", ".", ".", "END=300", "GT:DP:GQ:PL",
                         "0/0:30:99:0,90,1200")]),
            ("CHILD", [("chrM", 1, ".", "A", "<NON_REF>", ".", ".", "END=100", "GT:DP:GQ:PL",
                        "0/0:30:99:0,90,1200"),
                       ("chrM", 101, ".", "A", "<NON_REF>", ".", ".", "END=300", "GT:DP:GQ:PL",
                        "0/0:180:99:2335,0,2186")])):
        paths.append(str(tmp_path / f"{sm}.g.vcf"))
        _write_gvcf(paths[-1], sm, records)
    out = {}
    for pkg in ("jax", "port"):
        comb, joint = str(tmp_path / f"{pkg}.g.vcf"), str(tmp_path / f"{pkg}.vcf")
        assert _run(pkg, ["CombineGVCFs", "-V", paths[0], "-V", paths[1], "-R", str(ref),
                          "-O", comb]) == 0
        assert _run(pkg, ["GenotypeGVCFs", "-V", comb, "-R", str(ref), "-O", joint]) == 0
        out[pkg] = _read(joint)
    assert out["port"] == out["jax"]
    (call,) = _genotypes(str(tmp_path / "port.vcf"))
    assert call[3] == {"CHILD": "0/1", "MOTHER": "0/1"}
