"""The port's copies of Funcotator, FilterFuncotations and the funcotator
package (tools/funcotator_tool.py, funcotator/gencode.py,
funcotator/datasources.py) against gatk_tpu's, on the CPU.

Both packages annotate utils/synthetic.write_callset(seed=0,
length=2_000_000, n_snv=1800, n_indel=200) against the GENCODE datasource
utils/synthetic.write_gencode_datasource writes over its contig (with a
gene-keyed table beside it), as VCF and as MAF, and FilterFuncotations runs on
the VCF; every output file must be byte-identical. gatk_tpu's own
tests/test_funcotator.py cases that read no reference data run on both
packages' modules.
"""
import contextlib
import io
import sqlite3

import pytest

from gatk_tpu import cli as jax_cli
from gatk_tpu.funcotator import datasources as jax_dsrc, gencode as jax_gc
from gatk_tpu.io import vcf as jax_vcf
from gatk_tpu_torch import cli as port_cli
from gatk_tpu_torch.funcotator import datasources as port_dsrc, gencode as port_gc
from gatk_tpu_torch.io import vcf as port_vcf
from gatk_tpu_torch.utils import synthetic

REGISTRIES = {"jax": jax_cli.TOOL_REGISTRY, "port": port_cli.TOOL_REGISTRY}
PACKAGES = {"jax": (jax_dsrc, jax_gc, jax_vcf), "port": (port_dsrc, port_gc, port_vcf)}


@pytest.fixture(scope="module")
def annotated(tmp_path_factory):
    """The callset, its datasource (and a gene table), and both packages'
    Funcotator VCF and MAF and FilterFuncotations VCF: {package: {name: bytes}}."""
    d = tmp_path_factory.mktemp("funcotator")
    cs = synthetic.write_callset(str(d / "cs"), seed=0, length=2_000_000, n_snv=1800, n_indel=200)
    ds = synthetic.write_gencode_datasource(str(d / "ds"), cs["fasta"], cs["contig"], seed=0,
                                            n_genes=100)
    genes = d / "ds" / "genedb" / "hg38"
    genes.mkdir(parents=True)
    (genes / "genes.tsv").write_text("gene\tscore\n" + "".join(
        f"{g['gene']}\t{k / 100:.2f}\n" for k, g in enumerate(ds["genes"][::3])))
    (genes / "genedb.config").write_text(
        "name = GeneDB\nversion = v1\nsrc_file = genes.tsv\ntype = simpleXSV\n"
        "xsv_key = GENE_NAME\nxsv_key_column = 0\nxsv_delimiter = \\t\n"
        "xsv_permissive_cols = false\n")
    out = {}
    for pkg, registry in REGISTRIES.items():
        o = d / pkg
        o.mkdir()
        common = ["-V", cs["vcf"], "-R", cs["fasta"], "--data-sources-path", ds["dir"],
                  "--ref-version", ds["build"]]
        with contextlib.redirect_stdout(io.StringIO()):
            rcs = [registry["Funcotator"](common + ["-O", str(o / "f.vcf")]),
                   registry["Funcotator"](common + ["-O", str(o / "f.maf"),
                                                    "--output-file-format", "MAF"]),
                   registry["FilterFuncotations"](["-V", str(o / "f.vcf"),
                                                   "-O", str(o / "ff.vcf")])]
        assert rcs == [0, 0, 0]
        out[pkg] = {f: (o / f).read_bytes() for f in ("f.vcf", "f.maf", "ff.vcf")}
    return out


@pytest.mark.parametrize("name", ["f.vcf", "f.maf", "ff.vcf"])
def test_funcotator_outputs_identical_to_jax(annotated, name):
    assert annotated["port"][name] == annotated["jax"][name]


def test_funcotator_annotates_coding_and_intergenic_sites(annotated):
    """The synthetic datasource gives the callset coding, intronic and
    intergenic classifications and the gene table's fields."""
    maf = annotated["port"]["f.maf"].decode().splitlines()
    classes = {ln.split("\t")[6] for ln in maf[2:]}
    assert {"IGR", "Intron", "Missense_Mutation", "Silent"} <= classes
    assert len(maf) == 2 + 2000
    vcf = annotated["port"]["f.vcf"].decode()
    assert "GeneDB_v1_score" in vcf and "NOT_CLINSIG" in annotated["port"]["ff.vcf"].decode()


def _variant(vcfmod, contig, pos1, ref, alts):
    return vcfmod.Variant(contig=contig, pos=pos1 - 1, ref=ref, alts=tuple(alts))


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_simple_key_xsv_factory(tmp_path, pkg):
    """tests/test_funcotator.py::test_simple_key_xsv_factory on `pkg`."""
    dsrc, _, vcfmod = PACKAGES[pkg]
    src = tmp_path / "genes.tsv"
    src.write_text("gene\tscore\tfamily\nPIK3CA\t0.99\tkinase\nTP53\t0.87\ttumor_suppressor\n")
    conf = {"name": "GeneDB", "version": "v1", "src_file": "genes.tsv",
            "xsv_key": "GENE_NAME", "xsv_key_column": "0", "xsv_delimiter": "\\t",
            "xsv_permissive_cols": "false", "_dir": str(tmp_path)}
    fac = dsrc.SimpleKeyXsvFuncotationFactory(conf)
    assert fac.field_names == ["GeneDB_v1_score", "GeneDB_v1_family"]
    out = fac.annotate(_variant(vcfmod, "3", 100, "A", ["G"]), "G", "PIK3CA", None)
    assert out == {"GeneDB_v1_score": "0.99", "GeneDB_v1_family": "kinase"}
    out = fac.annotate(_variant(vcfmod, "3", 100, "A", ["G"]), "G", "NOPE", None)
    assert all(v == "" for v in out.values())


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_cosmic_factory_sqlite(tmp_path, pkg):
    """tests/test_funcotator.py::test_cosmic_factory_sqlite on `pkg`."""
    dsrc, _, vcfmod = PACKAGES[pkg]
    db = tmp_path / "cosmic.db"
    conn = sqlite3.connect(db)
    conn.execute('CREATE TABLE Cosmic ("Gene name" TEXT, "Mutation genome position" TEXT)')
    conn.executemany("INSERT INTO Cosmic VALUES (?, ?)", [
        ("PIK3CA", "3:178936082-178936082"),
        ("PIK3CA", "3:178936090-178936095"),
        ("PIK3CA", "3:178952085-178952085"),
        ("TP53", "17:7577000-7577000"),
    ])
    conn.commit()
    conn.close()
    conf = {"name": "Cosmic", "version": "v84", "src_file": "cosmic.db", "_dir": str(tmp_path)}
    fac = dsrc.CosmicFuncotationFactory(conf)
    for pos, want in ((178936090, "1"), (178936082, "1"), (178900000, "0")):
        out = fac.annotate(_variant(vcfmod, "3", pos, "A", ["G"]), "G", "PIK3CA", None)
        assert out["Cosmic_v84_overlapping_mutations"] == want


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_reference_severity_ordering(pkg):
    """tests/test_funcotator.py::test_reference_severity_ordering on `pkg`."""
    sv = PACKAGES[pkg][1]._severity
    assert sv("NONSENSE") == sv("NONSTOP") == sv("DE_NOVO_START_OUT_FRAME")
    assert sv("MISSENSE") > sv("FRAME_SHIFT_INS")
    assert sv("SPLICE_SITE") > sv("SILENT") > sv("FIVE_PRIME_UTR")
    assert sv("INTRON") > sv("FIVE_PRIME_FLANK") > sv("IGR")
    assert sv("COULD_NOT_DETERMINE") < sv("IGR")
