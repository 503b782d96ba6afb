"""The port's copies of SelectVariants, VariantFiltration, VariantEval and
AlleleFrequencyQC (tools/select_variants.py, tools/variant_filtration.py,
tools/varianteval_tool.py, vareval/*) against gatk_tpu's, on the CPU.

Both packages run the same arguments through their registries on
utils/synthetic.write_callset(seed=0, length=2_000_000, n_snv=1800,
n_indel=200) (sites only, the seven CNN annotations, a truth VCF) and on a
multi-sample VCF written here from a seed (genotypes with DP and GQ, AC, AN,
AF, DP and QD, some records filtered); every output file and what the tool
prints must be byte-identical.
"""
import contextlib
import io

import numpy as np
import pytest

from gatk_tpu import cli as jax_cli
from gatk_tpu_torch import cli as port_cli
from gatk_tpu_torch.utils import synthetic

REGISTRIES = {"jax": jax_cli.TOOL_REGISTRY, "port": port_cli.TOOL_REGISTRY}
SAMPLES = ("NA1", "NA2", "NA3")
# GATK's documented hard filters for SNVs
SNP_HARD_FILTERS = [("QD < 2.0", "QD2"), ("FS > 60.0", "FS60"), ("MQ < 40.0", "MQ40"),
                    ("SOR > 3.0", "SOR3"), ("MQRankSum < -12.5", "MQRankSum-12.5"),
                    ("ReadPosRankSum < -8.0", "ReadPosRankSum-8")]


def _multi_sample_vcf(path, seed=0, n=60, contig="20", length=2_000_000):
    """A three-sample VCF: SNVs and 1-3 bp indels with GT:DP:GQ (a few
    no-calls), INFO AC, AN, AF, DP and QD, every seventh record filtered."""
    rng = np.random.default_rng(seed)
    acgt = "ACGT"
    lines = ["##fileformat=VCFv4.2", f"##contig=<ID={contig},length={length}>",
             '##FILTER=<ID=LowQual,Description="Low quality">',
             '##INFO=<ID=AC,Number=A,Type=Integer,Description="Allele count">',
             '##INFO=<ID=AN,Number=1,Type=Integer,Description="Allele number">',
             '##INFO=<ID=AF,Number=A,Type=Float,Description="Allele frequency">',
             '##INFO=<ID=DP,Number=1,Type=Integer,Description="Depth">',
             '##INFO=<ID=QD,Number=1,Type=Float,Description="Quality by depth">',
             '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
             '##FORMAT=<ID=DP,Number=1,Type=Integer,Description="Depth">',
             '##FORMAT=<ID=GQ,Number=1,Type=Integer,Description="Genotype quality">',
             "\t".join(["#CHROM", "POS", "ID", "REF", "ALT", "QUAL", "FILTER", "INFO", "FORMAT",
                        *SAMPLES])]
    for k, pos in enumerate(np.sort(rng.choice(np.arange(100, length - 100), n, replace=False))):
        ref = acgt[rng.integers(4)]
        kind = rng.random()
        if kind < 0.7:
            alt = acgt[(acgt.index(ref) + rng.integers(1, 4)) % 4]
        elif kind < 0.85:
            alt = ref + "".join(acgt[i] for i in rng.integers(0, 4, rng.integers(1, 4)))
        else:
            ref, alt = ref + "".join(acgt[i] for i in rng.integers(0, 4, rng.integers(1, 4))), ref
        gts = [["0/0", "0/1", "1/1", "./."][i] for i in rng.choice(4, 3, p=[0.3, 0.4, 0.25, 0.05])]
        ac = sum(g.count("1") for g in gts)
        an = sum(2 for g in gts if g != "./.")
        dps = rng.integers(5, 60, 3)
        calls = [f"{g}:{d}:{rng.integers(0, 99)}" if g != "./." else "./.:0:0"
                 for g, d in zip(gts, dps)]
        info = (f"AC={ac};AN={an};AF={ac / an if an else 0:.3f};DP={int(dps.sum())};"
                f"QD={rng.normal(15, 8):.2f}")
        lines.append("\t".join([contig, str(int(pos)), f"rs{k}" if k % 3 == 0 else ".", ref, alt,
                                f"{rng.uniform(10, 500):.2f}", "LowQual" if k % 7 == 0 else "PASS",
                                info, "GT:DP:GQ", *calls]))
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("callset")
    cs = synthetic.write_callset(str(d), seed=0, length=2_000_000, n_snv=1800, n_indel=200)
    return dict(vcf=cs["vcf"], truth=cs["truth"], fasta=cs["fasta"],
                multi=_multi_sample_vcf(d / "multi.vcf"))


def _run(pkg, tool, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = REGISTRIES[pkg][tool](list(argv))
    return rc, out.getvalue()


def _both(inputs, tmp_path, tool, args, outputs):
    """`tool` on both packages, each writing into its own directory ({out} in
    `args`): {package: (rc, stdout with its directory replaced, [bytes of each
    output])}."""
    res = {}
    for pkg in REGISTRIES:
        d = tmp_path / pkg
        d.mkdir(parents=True)
        argv = [a.format(out=d, **inputs) for a in args]
        rc, text = _run(pkg, tool, argv)
        res[pkg] = (rc, text.replace(str(d), "{out}"), [(d / f).read_bytes() for f in outputs])
    return res


def _records(data):
    return [ln for ln in data.decode().splitlines() if ln and not ln.startswith("#")]


SELECT_CASES = {
    "snp": ["--select-type-to-include", "SNP"],
    "indel": ["--select-type-to-include", "INDEL"],
    "not_snp": ["--select-type-to-exclude", "SNP"],
    "jexl": ["-select", "QD > 2.0"],
    "jexl_and": ["-select", "QD > 10.0 && MQ > 50.0"],
    "jexl_inverted": ["-select", "FS > 20.0", "--invert-select"],
    "intervals": ["-L", "20:100000-900000", "-L", "20:1500001-1600000"],
    "intervals_small_indels": ["-L", "20:1-1000000", "--select-type-to-include", "INDEL",
                               "--max-indel-size", "2"],
}


@pytest.mark.parametrize("case", sorted(SELECT_CASES))
def test_select_variants_on_the_callset_identical_to_jax(inputs, tmp_path, case):
    res = _both(inputs, tmp_path, "SelectVariants",
                ["-V", "{vcf}", "-O", "{out}/s.vcf", *SELECT_CASES[case]], ["s.vcf"])
    assert res["port"] == res["jax"]
    assert res["port"][0] == 0 and 0 < len(_records(res["port"][2][0])) < 2000


MULTI_CASES = {
    "sample": ["-sn", "NA2"],
    "samples_exclude_filtered": ["-sn", "NA1", "-sn", "NA3", "--exclude-filtered"],
    "exclude_sample_non_variants": ["-xl-sn", "NA1", "--exclude-non-variants"],
    "sample_expression": ["-se", "NA[12]", "--remove-unused-alternates"],
    "genotype_select": ["-select-genotype", "isHomVar == 1"],
    "jexl_on_info": ["-select", "AF > 0.3", "-sn", "NA3", "--keep-original-ac"],
    "ids": ["-ids", "rs0", "-ids", "rs3", "-ids", "rs9"],
    "nocall": ["--max-nocall-number", "0", "--exclude-filtered"],
}


@pytest.mark.parametrize("case", sorted(MULTI_CASES))
def test_select_variants_on_samples_identical_to_jax(inputs, tmp_path, case):
    res = _both(inputs, tmp_path, "SelectVariants",
                ["-V", "{multi}", "-O", "{out}/s.vcf", *MULTI_CASES[case]], ["s.vcf"])
    assert res["port"] == res["jax"]
    assert res["port"][0] == 0 and _records(res["port"][2][0])


FILTER_CASES = {
    "snp_hard_filters": sum((["--filter-expression", e, "--filter-name", n]
                             for e, n in SNP_HARD_FILTERS), []),
    "cluster_and_missing": ["--filter-expression", "QD < 5.0", "--filter-name", "LowQD",
                            "--cluster-size", "2", "--cluster-window-size", "5000",
                            "--missing-values-evaluate-as-failing"],
    "inverted": ["--filter-expression", "FS > 30.0", "--filter-name", "HighFS",
                 "--invert-filter-expression"],
}


@pytest.mark.parametrize("case", sorted(FILTER_CASES))
def test_variant_filtration_identical_to_jax(inputs, tmp_path, case):
    res = _both(inputs, tmp_path, "VariantFiltration",
                ["-V", "{vcf}", "-O", "{out}/f.vcf", *FILTER_CASES[case]], ["f.vcf"])
    assert res["port"] == res["jax"]
    recs = _records(res["port"][2][0])
    assert res["port"][0] == 0 and len(recs) == 2000
    filtered = sum(r.split("\t")[6] not in ("PASS", ".") for r in recs)
    assert 0 < filtered < len(recs)


def test_variant_filtration_genotype_filters_identical_to_jax(inputs, tmp_path):
    res = _both(inputs, tmp_path, "VariantFiltration",
                ["-V", "{multi}", "-O", "{out}/g.vcf", "-G-filter", "GQ < 20",
                 "-G-filter-name", "LowGQ", "-G-filter", "DP < 10", "-G-filter-name", "LowDP",
                 "--filter-expression", "QD < 5.0", "--filter-name", "LowQD"], ["g.vcf"])
    assert res["port"] == res["jax"]
    data = res["port"][2][0].decode()
    assert res["port"][0] == 0 and "LowGQ" in data and "LowDP" in data


EVAL_CASES = {
    "callset_vs_truth": ["--eval", "{vcf}", "--comp", "{truth}"],
    "multi_sample": ["--eval", "{multi}", "-R", "{fasta}"],
    "modules": ["--eval", "{vcf}", "--comp", "{truth}", "-no-ev", "-EV", "CountVariants",
                "-EV", "TiTvVariantEvaluator", "-EV", "IndelSummary", "-no-st", "-ST", "Filter"],
    "select": ["--eval", "{vcf}", "-select", "QD > 10.0", "-select-name", "highQD",
               "-L", "20:1-1000000"],
}


@pytest.mark.parametrize("case", sorted(EVAL_CASES))
def test_variant_eval_identical_to_jax(inputs, tmp_path, case):
    res = _both(inputs, tmp_path, "VariantEval",
                [*EVAL_CASES[case], "-O", "{out}/e.grp"], ["e.grp"])
    assert res["port"] == res["jax"]
    assert res["port"][0] == 0 and b"CountVariants" in res["port"][2][0]


def test_allele_frequency_qc_identical_to_jax(inputs, tmp_path):
    """AlleleFrequencyQC: the multi-sample VCF against itself as the population
    (its AF) and against a shifted copy."""
    comp = tmp_path / "comp.vcf"
    lines = open(inputs["multi"]).read().splitlines()
    out = [ln if ln.startswith("#") else ln.replace("AF=0.", "AF=0.1", 1) for ln in lines]
    comp.write_text("\n".join(out) + "\n")
    for name, c in (("self", inputs["multi"]), ("shifted", str(comp))):
        res = _both(inputs, tmp_path / name, "AlleleFrequencyQC",
                    ["--eval", "{multi}", "--comp", c, "-O", "{out}/af.txt"], ["af.txt"])
        assert res["port"] == res["jax"]
        assert res["port"][2][0]
