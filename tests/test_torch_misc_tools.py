"""The port's copies of gatk_tpu's misc tools (tools/misc_tools.py) and the
htsget client (io/htsget.py) against gatk_tpu's, on the CPU.

gatk_tpu's tests/test_misc_tools.py reads the mito data of the reference
bundle and skips without it; here the same tools run on a synthetic sample
(utils/synthetic.write_sample: a 3 kb contig, 1,000 reads, its planted
variants as a VCF) and on small files written by the test, through both
packages' registries, and every output file and what the tool prints must be
byte-identical. HtsgetReader runs against a local HTTP server, as
tests/test_htsget.py does.
"""
import base64
import contextlib
import io
import json
import os
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import pytest

from gatk_tpu import cli as jax_cli
from gatk_tpu.io import bam as jax_bam, htsget as jax_htsget, sam as jax_sam
from gatk_tpu_torch import cli as port_cli
from gatk_tpu_torch.io import bam as port_bam, htsget as port_htsget, sam as port_sam
from gatk_tpu_torch.io.reads import Read
from gatk_tpu_torch.utils import synthetic
from gatk_tpu_torch.utils.errors import UserError

REGISTRIES = {"jax": jax_cli.TOOL_REGISTRY, "port": port_cli.TOOL_REGISTRY}


@pytest.fixture(scope="module")
def sample(tmp_path_factory):
    d = tmp_path_factory.mktemp("misc")
    s = synthetic.write_sample(str(d), seed=3, length=3000, n_reads=1000, n_snv=4, n_indel=2,
                               min_gap=200)
    # a second reference with one base changed, for the reference comparisons
    ref = bytearray(open(s["fasta"], "rb").read())
    i = ref.index(b"\n", 0) + 101
    ref[i] = ord("A") if ref[i] != ord("A") else ord("C")
    other = d / "other.fa"
    other.write_bytes(bytes(ref))
    s["other"] = str(other)
    (d / "sites.bed").write_text("chrM\t0\t1500\n")
    s["bed"] = str(d / "sites.bed")
    (d / "mix.tsv").write_text("SAMPLE\tMIXING_FRACTION\nS1\t0.4\nS2\t0.6\n")
    s["mix"] = str(d / "mix.tsv")
    return s


def _run(pkg, tool, argv):
    """A tool of one package through its registry: (return code, stdout)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = REGISTRIES[pkg][tool](list(argv))
    return rc, out.getvalue()


def _both(sample, tmp_path, tool, args, outputs):
    """Runs `tool` on both packages, each writing into its own directory
    ({out} in `args`), and returns each package's (rc, stdout with its
    directory replaced, [bytes of each output])."""
    res = {}
    for pkg in REGISTRIES:
        d = tmp_path / pkg
        d.mkdir()
        argv = [a.format(out=d, **sample) for a in args]
        rc, text = _run(pkg, tool, argv)
        res[pkg] = (rc, text.replace(str(d), "{out}"),
                    [(d / f).read_bytes() for f in outputs])
    return res


# tool, its arguments ({out} the package's directory; the sample's keys),
# the files it writes there
CASES = [
    ("PrintReadsHeader", ["-I", "{bam}", "-O", "{out}/h.txt"], ["h.txt"]),
    ("CountBasesInReference", ["-R", "{fasta}", "-L", "chrM:1-1000"], []),
    ("PrintBGZFBlockInformation", ["--bgzf-file", "{bam}"], []),
    ("AddOriginalAlignmentTags", ["-I", "{bam}", "-O", "{out}/oa.bam"], ["oa.bam"]),
    ("AnnotateVcfWithBamDepth", ["-V", "{known_sites}", "-I", "{bam}", "-O", "{out}/d.vcf"],
     ["d.vcf"]),
    ("RemoveNearbyIndels", ["-V", "{known_sites}", "-O", "{out}/r.vcf",
                            "--min-indel-spacing", "500"], ["r.vcf"]),
    ("CallableLoci", ["-I", "{bam}", "-R", "{fasta}", "-L", "chrM:1-2000", "-O", "{out}/c.bed",
                      "--summary", "{out}/c.txt"], ["c.bed", "c.txt"]),
    ("LocalAssembler", ["-I", "{bam}", "-R", "{fasta}", "-L", "chrM:400-900", "--fasta-file",
                        "{out}/a.fa", "--gfa-file", "{out}/a.gfa", "--assembly-name", "s"],
     ["a.fa", "a.gfa"]),
    ("ReadAnonymizer", ["-I", "{bam}", "-R", "{fasta}", "-O", "{out}/anon.bam"], ["anon.bam"]),
    ("RevertBaseQualityScores", ["-I", "{bam}", "-O", "{out}/rq.bam"], ["rq.bam"]),
    ("PrintDistantMates", ["-I", "{bam}", "-O", "{out}/dm.bam"], ["dm.bam"]),
    ("MethylationTypeCaller", ["-I", "{bam}", "-R", "{fasta}", "-O", "{out}/m.vcf", "-L",
                               "chrM:1-300"], ["m.vcf"]),
    ("CheckReferenceCompatibility", ["-refcomp", "{fasta}", "-I", "{bam}"], []),
    ("DownsampleByDuplicateSet", ["-I", "{bam}", "-O", "{out}/ds.bam", "--fraction-to-keep",
                                  "0.5"], ["ds.bam"]),
    ("PostProcessReadsForRSEM", ["-I", "{bam}", "-O", "{out}/rsem.bam"], ["rsem.bam"]),
    ("CompareBaseQualities", ["{bam}", "{bam}"], []),
    ("CompareReferences", ["-R", "{fasta}", "-refcomp", "{other}", "-O", "{out}/cr.tsv",
                           "--base-comparison", "FIND_SNPS_ONLY"], ["cr.tsv"]),
    ("CalculateMixingFractions", ["-V", "{known_sites}", "-I", "{bam}", "-O", "{out}/mf.tsv"],
     ["mf.tsv"]),
    ("AnnotateVcfWithExpectedAlleleFraction", ["-V", "{known_sites}", "-O", "{out}/af.vcf",
                                               "--mixing-fractions", "{mix}"], ["af.vcf"]),
    ("VCFComparator", ["-V", "{known_sites}", "-V", "{known_sites}"], []),
    ("EvaluateInfoFieldConcordance", ["--eval", "{known_sites}", "--truth", "{known_sites}",
                                      "--eval-info-key", "AF", "--truth-info-key", "AF",
                                      "-O", "{out}/ic.tsv"], ["ic.tsv"]),
    ("CountFalsePositives", ["-V", "{known_sites}", "-L", "{bed}", "-O", "{out}/fp.tsv"],
     ["fp.tsv"]),
]


@pytest.mark.parametrize("tool,args,outputs", CASES, ids=[c[0] for c in CASES])
def test_misc_tool_identical_to_jax(sample, tmp_path, tool, args, outputs):
    res = _both(sample, tmp_path, tool, args, outputs)
    assert res["port"] == res["jax"]
    rc, text, files = res["port"]
    assert rc == 0 and (text or any(files))


def _reads_bam(bammod, sammod, path, reads):
    header = sammod.SamHeader(sequences=[sammod.SequenceRecord("chrM", 16569, 0)])
    w = bammod.BamWriter(str(path), header)
    for r in reads:
        w.write(r)
    w.close()
    return str(path)


def _read(name, pos, quals=None, n=10, flag=0, tags=None):
    return Read(name=name, flag=flag, ref_id=0, pos=pos, mapq=60,
                cigar_ops=np.array([0], np.uint8), cigar_lens=np.array([n], np.int32),
                bases=np.full(n, ord("A"), np.uint8),
                quals=quals if quals is not None else np.full(n, 30, np.uint8),
                tags=tags or {})


def test_misencoded_quals_and_original_quals_identical_to_jax(tmp_path):
    """FixMisencodedBaseQualityReads on phred+64 qualities, CompareBaseQualities
    of the result against its input, and RevertBaseQualityScores on reads
    with OQ tags (tests/test_misc_tools.py's cases)."""
    res = {}
    for pkg, bammod, sammod in (("jax", jax_bam, jax_sam), ("port", port_bam, port_sam)):
        d = tmp_path / pkg
        d.mkdir()
        src = _reads_bam(bammod, sammod, d / "m.bam",
                         [_read("r1", 100, quals=np.full(10, 64, np.uint8)),
                          _read("r2", 150, quals=np.arange(64, 74, dtype=np.uint8))])
        oq = _reads_bam(bammod, sammod, d / "oq.bam",
                        [_read("r3", 100, tags={"OQ": "D" * 10})])
        out = []
        out.append(_run(pkg, "FixMisencodedBaseQualityReads", ["-I", src, "-O", str(d / "f.bam")]))
        err = UserError if pkg == "port" else jax_cli.UserError
        with pytest.raises(err):
            _run(pkg, "CompareBaseQualities", [src, str(d / "f.bam"), "--throw-on-diff"])
        out.append(_run(pkg, "RevertBaseQualityScores", ["-I", oq, "-O", str(d / "r.bam")]))
        res[pkg] = (out, (d / "f.bam").read_bytes(), (d / "r.bam").read_bytes())
    assert res["port"] == res["jax"]
    assert [rc for rc, _ in res["port"][0]] == [0, 0]


def test_funcotate_segments_and_gtf_to_bed_identical_to_jax(tmp_path):
    """GtfToBed and FuncotateSegments (the port's funcotator/gencode.py's GTF
    reader) on a synthetic GENCODE GTF and a segment file over its genes."""
    cs = synthetic.write_callset(str(tmp_path / "cs"), seed=1, length=200_000, n_snv=50,
                                 n_indel=10)
    ds = synthetic.write_gencode_datasource(str(tmp_path / "ds"), cs["fasta"], cs["contig"],
                                            seed=1, n_genes=10)
    gtf = os.path.join(ds["dir"], "gencode", ds["build"], "gencode.gtf")
    seg = tmp_path / "seg.tsv"
    seg.write_text("@HD\tVN:1.6\n@SQ\tSN:20\tLN:200000\nCONTIG\tSTART\tEND\tCALL\n"
                   + "".join(f"20\t{s + 1}\t{s + 50_000}\t{'+-0'[k % 3]}\n"
                             for k, s in enumerate(range(0, 200_000, 50_000))))
    res = {}
    for pkg in REGISTRIES:
        d = tmp_path / pkg
        d.mkdir()
        got = [_run(pkg, "GtfToBed", ["-G", gtf, "-O", str(d / "g.bed")]),
               _run(pkg, "FuncotateSegments", ["-S", str(seg), "--gtf", gtf,
                                               "-O", str(d / "fs.tsv")])]
        res[pkg] = ([rc for rc, _ in got], (d / "g.bed").read_bytes(),
                    (d / "fs.tsv").read_bytes())
    assert res["port"] == res["jax"]
    assert res["port"][0] == [0, 0] and res["port"][1].count(b"\n") == len(ds["genes"])
    assert b"GENE" in res["port"][2]


# --------------------------------------------------------------------------- htsget


def _bam_bytes(path, positions):
    header = port_sam.SamHeader(sequences=[port_sam.SequenceRecord("chr1", 100000, 0)])
    w = port_bam.BamWriter(str(path), header)
    for i, pos in enumerate(positions):
        w.write(Read(name=f"r{i}", flag=0, ref_id=0, pos=pos, mapq=60,
                     cigar_ops=np.array([0], np.uint8), cigar_lens=np.array([50], np.int32),
                     bases=np.full(50, ord("A"), np.uint8), quals=np.full(50, 30, np.uint8)))
    w.close()
    return path.read_bytes()


@pytest.fixture()
def htsget_server(tmp_path):
    """tests/test_htsget.py's mock server: a ticket of two data-URI blocks, the
    whole BAM or, for a referenceName query, the subset."""
    full = _bam_bytes(tmp_path / "full.bam", [100, 5000, 20000])
    subset = _bam_bytes(tmp_path / "sub.bam", [5000])

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            parsed = urlparse(self.path)
            if not parsed.path.startswith("/reads/"):
                self.send_response(404)
                self.end_headers()
                return
            payload = subset if "referenceName" in parse_qs(parsed.query) else full
            mid = len(payload) // 2
            ticket = {"htsget": {"format": "BAM", "urls": [
                {"url": "data:application/octet-stream;base64,"
                        + base64.b64encode(part).decode()}
                for part in (payload[:mid], payload[mid:])]}}
            body = json.dumps(ticket).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/vnd.ga4gh.htsget.v1.2.0+json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    server = HTTPServer(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{server.server_port}"
    server.shutdown()


def test_htsget_reader_identical_to_jax(htsget_server, tmp_path):
    """tests/test_htsget.py's queries on both packages' clients, and the
    HtsgetReader tool writing the same BAM."""
    got = {}
    for pkg, mod in (("jax", jax_htsget), ("port", port_htsget)):
        ticket = mod.fetch_reads_ticket(htsget_server, "sample1")
        reader = mod.HtsgetReader(htsget_server, "sample1")
        recs = [r.pos for r in reader]
        hits = [r.pos for r in reader.query("chr1", 4000, 6000)]
        name = reader.header.sequences[0].name
        reader.close()
        out = tmp_path / f"{pkg}.bam"
        rc, _ = _run(pkg, "HtsgetReader", ["--url", htsget_server, "--id", "sample1",
                                           "-O", str(out)])
        got[pkg] = (ticket["format"], len(ticket["urls"]), recs, hits, name, rc,
                    out.read_bytes())
    assert got["port"] == got["jax"]
    assert got["port"][:6] == ("BAM", 2, [100, 5000, 20000], [5000], "chr1", 0)
