"""HaplotypeBasedVariantRecaller through the port (gatk_tpu_torch) against
gatk_tpu, on the CPU.

Two inputs: the case of tests/test_new_tools_r4.py:300 (a 400 bp contig, a
reference and an alternate haplotype over one SNV, 4 reads of each), and a
synthetic sample (utils/synthetic.write_sample: 3,000 bp, 800 reads, 3 het
SNVs and 1 het indel) whose alleles are gatk_tpu's HaplotypeCaller VCF and
whose haplotypes BAM is that run's -bamout. The port runs with --device cpu
(the plain PairHMM, one launch a variant). Tolerance: none; the matrix CSVs
are byte-identical.
"""
import contextlib
import io
import os

import numpy as np
import pytest

from gatk_tpu.cli import TOOL_REGISTRY as JAX_TOOLS
from gatk_tpu_torch import cli as port_cli
from gatk_tpu_torch.io import bam as bamio
from gatk_tpu_torch.io import sam as samio
from gatk_tpu_torch.io.reads import Read
from gatk_tpu_torch.ops import pairhmm
from gatk_tpu_torch.utils import synthetic
from tests.test_torch_pairhmm import one_torch_thread  # noqa: F401


def _run(pkg, argv):
    with contextlib.redirect_stdout(io.StringIO()):
        if pkg == "jax":
            return JAX_TOOLS[argv[0]](argv[1:])
        return port_cli.main(argv + ["--device", "cpu"])


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def _recall(pkg, vcf, haps_bam, reads_bam, fasta, out):
    return _run(pkg, ["HaplotypeBasedVariantRecaller", "--alleles-file-vcf", vcf,
                      "--haplotypes-file-bam", haps_bam, "--matrix-file-csv", out,
                      "-I", reads_bam, "-R", fasta])


@pytest.fixture
def small_case(tmp_path):
    """tests/test_new_tools_r4.py:300's inputs, written with the port's BamWriter."""
    rng = np.random.default_rng(11)
    seq = "".join("ACGT"[i] for i in rng.integers(0, 4, 400))
    fa = tmp_path / "r.fa"
    fa.write_text(f">chr1\n{seq}\n")
    var_pos = 200
    ref_base = seq[var_pos]
    alt_base = "G" if ref_base != "G" else "C"
    header = samio.SamHeader(sequences=[samio.SequenceRecord("chr1", 400, 0)],
                             read_groups=[{"ID": "rg", "SM": "s1"}])
    hap_ref = seq[150:250]
    hap_alt = hap_ref[:50] + alt_base + hap_ref[51:]

    def write(path, reads):
        w = bamio.BamWriter(path, header)
        for name, pos, bases, q in reads:
            w.write(Read(name=name, flag=0, ref_id=0, pos=pos, mapq=60,
                         cigar_ops=np.array([0], np.uint8),
                         cigar_lens=np.array([len(bases)], np.int32),
                         bases=np.frombuffer(bases.encode(), np.uint8).copy(),
                         quals=np.full(len(bases), q, np.uint8)))
        w.close()

    hap_bam, reads_bam = str(tmp_path / "haps.bam"), str(tmp_path / "reads.bam")
    write(hap_bam, [(f"hap{i}", 150, h, 40) for i, h in enumerate((hap_ref, hap_alt))])
    write(reads_bam, [(f"r{i}", 170 + 2 * i, (hap_ref if i < 4 else hap_alt)[20 + 2 * i:60 + 2 * i],
                       35) for i in range(8)])
    vcf = tmp_path / "alleles.vcf"
    vcf.write_text("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n"
                   f"chr1\t{var_pos + 1}\t.\t{ref_base}\t{alt_base}\t.\tPASS\t.\n")
    return dict(vcf=str(vcf), haps=hap_bam, reads=reads_bam, fasta=str(fa), pos=var_pos,
                ref=ref_base, alt=alt_base)


def test_small_case_on_the_port(small_case, tmp_path):
    """tests/test_new_tools_r4.py:300 on the port: one block, ref reads favour
    the ref allele and alt reads the alt allele."""
    out = str(tmp_path / "matrix.csv")
    c = small_case
    assert _recall("port", c["vcf"], c["haps"], c["reads"], c["fasta"], out) == 0
    lines = open(out).read().splitlines()
    assert lines[0].startswith(f"#chr1:{c['pos'] + 1}")
    assert c["ref"] in lines[0].split() and c["alt"] in lines[0].split()
    data = [ln.split() for ln in lines[1:] if ln]
    assert len(data) == 8
    for row in data:
        lik_ref, lik_alt = float(row[-2]), float(row[-1])
        assert (lik_ref > lik_alt) == (int(row[0][1:]) < 4), row


def test_small_case_identical_to_jax(small_case, tmp_path):
    c = small_case
    out = {pkg: str(tmp_path / f"{pkg}.csv") for pkg in ("jax", "port")}
    for pkg in out:
        assert _recall(pkg, c["vcf"], c["haps"], c["reads"], c["fasta"], out[pkg]) == 0
    assert _read(out["port"]) == _read(out["jax"])


def test_synthetic_sample_identical_to_jax(tmp_path):
    """HaplotypeCaller's calls as the alleles and its -bamout as the
    haplotypes: one block a called variant, every row equal."""
    sample = synthetic.write_sample(str(tmp_path / "s"), seed=2, length=3000, n_reads=800,
                                    n_snv=3, n_indel=1)
    vcf, bamout = str(tmp_path / "hc.vcf"), str(tmp_path / "hc.bamout.bam")
    assert _run("jax", ["HaplotypeCaller", "-I", sample["bam"], "-R", sample["fasta"],
                        "-O", vcf, "-bamout", bamout]) == 0
    out = {pkg: str(tmp_path / f"{pkg}.csv") for pkg in ("jax", "port")}
    before = pairhmm.pairhmm_pairs.launches
    for pkg in out:
        assert _recall(pkg, vcf, bamout, sample["bam"], sample["fasta"], out[pkg]) == 0
    assert pairhmm.pairhmm_pairs.launches == before  # the plain version: not counted
    got = _read(out["port"])
    assert got == _read(out["jax"])
    n_calls = sum(1 for ln in open(vcf) if not ln.startswith("#"))
    assert got.decode().count("#") == n_calls == len(sample["variants"])
