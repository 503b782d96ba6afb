"""Shared by the tests of the port's copied host tools (tests/test_torch_{vets,
sam_fasta_util,picard,sv,pathseq_dragstr,longtail_tools}.py): the synthetic
inputs they run on, and a runner that drives one tool through both packages'
registries on the same inputs.

gatk_tpu's own tests of these tools read the mito data of the reference bundle
and skip without it. Here every input is written from a seed: the chrM sample
of utils/synthetic.write_sample (a 3 kb contig, 1,000 reads and planted
variants), a paired-end BAM over the same contig, and the small files the tools
take beside a BAM (a sequence dictionary, an interval list, a BED, a called VCF
with genotypes, FASTQs, a chain file, a haplotype map).
"""
import contextlib
import io
import os
import re
import shutil
import tempfile
import zipfile

import numpy as np

from gatk_tpu import cli as jax_cli
from gatk_tpu_torch import cli as port_cli
from gatk_tpu_torch.io import bam, sam
from gatk_tpu_torch.io.reads import Read
from gatk_tpu_torch.utils import synthetic

REGISTRIES = {"jax": jax_cli.TOOL_REGISTRY, "port": port_cli.TOOL_REGISTRY}
CONTIG = "chrM"
LENGTH = 3000
# a name that tempfile made, as a tool prints it
_TEMP_NAME = re.compile(re.escape(tempfile.gettempdir()) + r"/tmp\w+")


def run(pkg, tool, argv):
    """A tool of one package through its registry: (return code, stdout, with
    each name that tempfile made replaced by {tmp}). A tool that raises or
    exits gives ("raised", the exception's class name, its text)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        try:
            rc = REGISTRIES[pkg][tool](list(argv))
        except (Exception, SystemExit) as e:  # each package has its own UserError
            rc = ("raised", type(e).__name__, str(e))
    return rc, _TEMP_NAME.sub("{tmp}", out.getvalue())


def read_tree(d):
    """{path relative to d: bytes} of every file under d. A zip archive (an
    .npz, a .zip) is read as {member: bytes}: its entries are stamped with
    the time they were written."""
    out = {}
    for dirpath, _, files in os.walk(d):
        for f in files:
            path = os.path.join(dirpath, f)
            data = open(path, "rb").read()
            if data.startswith(b"PK\x03\x04"):
                with zipfile.ZipFile(path) as z:
                    data = {n: z.read(n) for n in z.namelist()}
            out[os.path.relpath(path, d)] = data
    return out


def both(tmp_path, tool, args, inputs=None, **keys):
    """Runs `tool` on each package in turn, in the same emptied directory
    tmp_path/run ({out} in `args`; `keys` fill the other fields), so that
    paths a tool writes into its outputs are equal. `inputs` maps a file name
    to a path copied into that directory first (for tools that write beside
    their input). Returns {package: (rc, stdout, {file: bytes} of the
    directory)}."""
    res = {}
    d = tmp_path / "run"
    for pkg in REGISTRIES:
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        for name, src in (inputs or {}).items():
            shutil.copy(src.format(**keys), d / name)
        argv = [a.format(out=d, **keys) for a in args]
        rc, text = run(pkg, tool, argv)
        res[pkg] = (rc, text, read_tree(d))
    return res


def assert_identical(res, expect=()):
    """Both packages gave the same return code, stdout and files; the tool
    succeeded and wrote each file of `expect` (not empty)."""
    assert res["port"] == res["jax"]
    rc, text, files = res["port"]
    assert rc == 0, (rc, text)
    for f in expect:
        assert files.get(f), (f, sorted(files))
    return rc, text, files


# --------------------------------------------------------------------------- inputs


def _paired_reads(rng, ref, n_pairs, read_len=100, insert=(250, 400), n_dup=10):
    """FR pairs over `ref` (a few sequencing errors each), with mate fields,
    MC tags and OQ tags, and `n_dup` duplicated pairs; coordinate-sorted."""
    reads = []
    m = np.array([0], np.uint8)
    cl = np.array([read_len], np.int32)
    starts = []
    for k in range(n_pairs):
        size = int(rng.integers(*insert))
        s = int(rng.integers(0, len(ref) - size))
        starts.append((f"p{k:05d}", s, size))
    for k in rng.choice(n_pairs, n_dup, replace=False):
        name, s, size = starts[int(k)]
        starts.append((f"q{int(k):05d}", s, size))
    for name, s, size in starts:
        e = s + size - read_len
        first_fwd = bool(rng.random() < 0.5)
        for i, pos in enumerate((s, e)):
            bases = ref[pos:pos + read_len].copy()
            err = rng.random(read_len) < 0.01
            bases[err] = synthetic._ACGT[rng.integers(0, 4, int(err.sum()))]
            quals = rng.integers(20, 41, read_len).astype(np.uint8)
            rev = (i == 0) != first_fwd
            mate_rev = not rev
            flag = 0x1 | 0x2 | (0x40 if i == 0 else 0x80) | (0x10 if rev else 0) | \
                (0x20 if mate_rev else 0)
            mate = e if i == 0 else s
            tlen = size if pos == s else -size
            oq = "".join(chr(q + 33) for q in np.minimum(quals + 2, 41))
            reads.append(Read(name=name, flag=flag, ref_id=0, pos=pos, mapq=60,
                              cigar_ops=m, cigar_lens=cl, bases=bases, quals=quals,
                              mate_ref_id=0, mate_pos=mate, tlen=tlen,
                              tags={"RG": "rg1", "MC": f"{read_len}M", "OQ": oq,
                                    "RX": "ACGT" if name[0] == "p" else "ACGA"}))
    reads.sort(key=lambda r: (r.pos, r.name, r.flag))
    return reads


def _write_bam(path, reads, header_text):
    w = bam.BamWriter(str(path), sam.SamHeader.parse(header_text))
    for r in reads:
        w.write(r)
    w.close()
    return str(path)


def _write_calls_vcf(path, contig, length, variants, sample="SYN1"):
    """The planted variants as called het genotypes (GT:AD:DP:GQ:PL)."""
    with open(path, "w") as fh:
        fh.write("##fileformat=VCFv4.2\n"
                 '##FILTER=<ID=PASS,Description="All filters passed">\n'
                 '##INFO=<ID=DP,Number=1,Type=Integer,Description="Depth">\n'
                 '##INFO=<ID=AF,Number=A,Type=Float,Description="Allele frequency">\n'
                 '##INFO=<ID=QD,Number=1,Type=Float,Description="Quality by depth">\n'
                 '##INFO=<ID=FS,Number=1,Type=Float,Description="Fisher strand">\n'
                 '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">\n'
                 '##FORMAT=<ID=AD,Number=R,Type=Integer,Description="Allelic depths">\n'
                 '##FORMAT=<ID=DP,Number=1,Type=Integer,Description="Depth">\n'
                 '##FORMAT=<ID=GQ,Number=1,Type=Integer,Description="Genotype quality">\n'
                 '##FORMAT=<ID=PL,Number=G,Type=Integer,Description="Phred likelihoods">\n'
                 f"##contig=<ID={contig},length={length}>\n"
                 f"#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t{sample}\n")
        for k, v in enumerate(variants):
            ad = (20 + k, 18 + 2 * k)
            fh.write(f"{contig}\t{v.pos + 1}\trs{k + 1}\t{v.ref}\t{v.alt}\t{300 + 10 * k}\tPASS\t"
                     f"DP={sum(ad)};AF=0.5;QD={12.5 + k};FS={1.5 * k}\tGT:AD:DP:GQ:PL\t"
                     f"0/1:{ad[0]},{ad[1]}:{sum(ad)}:99:{400 + k},0,{380 + k}\n")
    return path


def write_inputs(d, seed=3):
    """Every input of the long-tail tool tests under d; returns their paths
    (and the sample's variants) by name."""
    d = str(d)
    s = synthetic.write_sample(os.path.join(d, "s"), seed=seed, length=LENGTH, n_reads=1000,
                               n_snv=4, n_indel=2, min_gap=200, n_duplicates=20)
    ref = np.frombuffer(b"".join(l.strip() for l in open(s["fasta"], "rb")
                                 if not l.startswith(b">")), np.uint8)
    rng = np.random.default_rng(seed)
    inp = dict(fasta=s["fasta"], bam=s["bam"], known_sites=s["known_sites"],
               variants=s["variants"], contig=CONTIG, length=LENGTH)
    rg = ("@RG\tID:rg1\tSM:SYN1\tLB:lib1\tPL:ILLUMINA\tPU:unit1\n")
    sq = f"@SQ\tSN:{CONTIG}\tLN:{LENGTH}\n"
    pairs = _paired_reads(rng, ref, 300)
    inp["paired"] = _write_bam(os.path.join(d, "paired.bam"), pairs,
                               "@HD\tVN:1.6\tSO:coordinate\n" + sq + rg)
    for path in (inp["bam"], inp["paired"]):
        with contextlib.redirect_stdout(io.StringIO()):
            assert port_cli.TOOL_REGISTRY["BuildBamIndex"](["-I", path]) == 0
    # the same pairs as an unaligned, queryname-sorted BAM (MergeBamAlignment)
    unaligned = []
    for r in sorted(pairs, key=lambda r: (r.name, r.flag & 0x80)):
        bases, quals = r.bases, r.quals
        if r.is_reverse:
            bases = _revcomp(bases)
            quals = quals[::-1].copy()
        unaligned.append(Read(name=r.name, flag=(r.flag & 0xC1) | 0x4 | 0x8, ref_id=-1, pos=-1,
                              mapq=0, cigar_ops=np.zeros(0, np.uint8),
                              cigar_lens=np.zeros(0, np.int32), bases=bases, quals=quals,
                              tags={"RG": "rg1"}))
    inp["unaligned"] = _write_bam(os.path.join(d, "unaligned.bam"), unaligned,
                                  "@HD\tVN:1.6\tSO:queryname\n" + sq + rg)
    # FASTQs of the pairs' first and second reads, in name order
    for end, flag in ((1, 0x40), (2, 0x80)):
        path = os.path.join(d, f"reads_{end}.fastq")
        with open(path, "w") as fh:
            for r in unaligned:
                if r.flag & flag:
                    fh.write(f"@{r.name}/{end}\n{r.bases.tobytes().decode()}\n+\n"
                             + "".join(chr(q + 33) for q in r.quals) + "\n")
        inp[f"fastq{end}"] = path
    inp["dict"] = os.path.join(d, "ref.dict")
    with open(inp["dict"], "w") as fh:
        fh.write("@HD\tVN:1.6\n" + sq)
    inp["ilist"] = os.path.join(d, "targets.interval_list")
    with open(inp["ilist"], "w") as fh:
        fh.write("@HD\tVN:1.6\n" + sq + f"{CONTIG}\t101\t1200\t+\ttarget_1\n"
                 f"{CONTIG}\t1501\t2600\t+\ttarget_2\n")
    inp["ilist2"] = os.path.join(d, "baits.interval_list")
    with open(inp["ilist2"], "w") as fh:
        fh.write("@HD\tVN:1.6\n" + sq + f"{CONTIG}\t801\t2000\t+\tbait_1\n")
    inp["bed"] = os.path.join(d, "targets.bed")
    with open(inp["bed"], "w") as fh:
        fh.write(f"{CONTIG}\t100\t1200\tregion1\t0\t+\n{CONTIG}\t1500\t2600\n")
    inp["calls"] = _write_calls_vcf(os.path.join(d, "calls.vcf"), CONTIG, LENGTH, s["variants"])
    # an identity chain over the contig and one that shifts it by 100 bases
    inp["chain"] = os.path.join(d, "shift.chain")
    with open(inp["chain"], "w") as fh:
        fh.write(f"chain 1000 {CONTIG} {LENGTH} + 0 {LENGTH - 100} {CONTIG} {LENGTH} + 100 "
                 f"{LENGTH} 1\n{LENGTH - 100}\n\n")
    # a haplotype map of the planted SNVs (picard's HAPLOTYPE_MAP format)
    inp["hapmap"] = os.path.join(d, "hapmap.txt")
    with open(inp["hapmap"], "w") as fh:
        fh.write("@HD\tVN:1.6\n" + sq + "#CHROMOSOME\tPOSITION\tNAME\tMAJOR_ALLELE\t"
                 "MINOR_ALLELE\tMAF\tANCHOR_SNP\tPANELS\n")
        for k, v in enumerate(x for x in s["variants"] if x.is_snv):
            fh.write(f"{CONTIG}\t{v.pos + 1}\tsnp{k}\t{v.ref}\t{v.alt}\t0.4\t\t\n")
    return inp


def _revcomp(bases):
    comp = np.arange(256, dtype=np.uint8)
    for a, b in zip(b"ACGTN", b"TGCAN"):
        comp[a] = b
    return comp[bases[::-1]]
