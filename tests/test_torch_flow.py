"""FlowBasedHMM in the port (gatk_tpu_torch) against gatk_tpu, on the CPU.

The same flow-space reads and haplotypes (made from a seed with numpy, or
tests/test_flow.py's) go through gatk_tpu's batched flow PairHMM
(flow_pairhmm_batch_jax, its lax.scan on the CPU) and the port's dense plain
version flow_pairhmm_batch_plain (the CPU route), on the same packed arrays;
both are held to the host float64 DP within gatk_tpu's own 2e-3
(tests/test_flow.py). The port's plain version of csrc/flow_pairhmm.cu,
flow_pairhmm_pairs_plain, which walks the coset lattice from the packed
tables, is held to both batched versions, and the entry is shown to score a
flow order that is not 4-periodic by the dense scan, as gatk_tpu does. Then
the prior the port gathers on the device against gatk_tpu's host packing, bit
for bit; HaplotypeCaller --likelihood-calculation-engine FlowBasedHMM through
both CLIs (the port with --device cpu) on a synthetic flow sample; the flow
tools; and FlowPairHMMAlignReadsToHaplotypes in both packages.
"""
import os

import numpy as np
import pytest
import torch

from gatk_tpu.cli import TOOL_REGISTRY as JAX_TOOLS
from gatk_tpu.ops import flow as jax_flow
from gatk_tpu.ops import flow_pairhmm as jax_fp
from gatk_tpu_torch import cli as port_cli
from gatk_tpu_torch import devices
from gatk_tpu_torch.ops import flow as port_flow
from gatk_tpu_torch.ops import flow_pairhmm as port_fp
from gatk_tpu_torch.utils import synthetic
from tests.test_torch_pairhmm import one_torch_thread  # noqa: F401

BATCH_TOL = 1e-4  # |port plain - gatk_tpu batch| per pair, log10
HOST_TOL = 2e-3  # either batch against the host f64 DP (tests/test_flow.py:108-122)
PRINTED_TOL = 1e-4 + 1e-9  # one step of a 4th decimal, as the value is printed


def _objects(mod, hap_bases, read_specs):
    haps = [mod.FlowBasedHaplotype(h) for h in hap_bases]
    reads = [mod.FlowBasedRead(b, q, tp=tp) for b, q, tp in read_specs]
    return haps, reads


def _edges(packed, which):
    """gatk_tpu's packed arrays with pair 0 given no read flows ("rlen0") or
    no haplotype flows ("hlen0"), as _pack_flow_batch writes such a pair."""
    p = {k: (v.copy() if isinstance(v, np.ndarray) else v) for k, v in packed.items()}
    if "rlen0" in which:
        p["prior"][0] = 0
        p["trans"][0] = 0
        p["rlen"][0] = 0
    if "hlen0" in which:
        p["prior"][1] = 0
        p["hlen"][1] = 0
    return p


# (seed, read lengths in bases, haplotype lengths, edge pairs): ragged batches,
# one pair (B = 1), tiny reads, a read with as many flows as the batch's Rp
# (every batch has one), and W = Hp + 5 of every residue mod 4 (495, 471, 26,
# 598, 198, 9, 232)
CASES = [
    (0, (40, 7, 120, 200, 31), (60, 250, 333, 101), ()),
    (1, (200,), (300,), ()),
    (2, (1, 2, 3, 5), (1, 2, 4, 9), ("rlen0", "hlen0")),
    (3, range(20, 220, 40), (180, 240, 420), ("rlen0",)),
    (4, (90, 150), (120, 121, 122, 123), ("hlen0",)),
    (5, (60, 61), (7,), ()),
    (6, (50, 80, 120), (150,), ("rlen0",)),  # W = 232, a multiple of 4
]


@pytest.mark.parametrize("seed,read_lens,hap_lens,edges", CASES)
def test_plain_batch_matches_jax_batch_and_host(seed, read_lens, hap_lens, edges):
    hap_bases, read_specs = synthetic.flow_batch(seed, read_lens, hap_lens)
    haps, reads = _objects(jax_flow, hap_bases, read_specs)
    pairs = [(ri, hi) for ri in range(len(reads)) for hi in range(len(haps))]
    packed = _edges(jax_fp._pack_flow_batch(haps, reads, pairs), edges)
    want = np.asarray(jax_fp.flow_pairhmm_batch_jax(packed["prior"], packed["trans"],
                                                    packed["rlen"], packed["hlen"]))
    got = port_fp.flow_pairhmm_batch_plain(*(torch.from_numpy(packed[k])
                                             for k in ("prior", "trans", "rlen", "hlen"))).numpy()
    assert got.shape == want.shape == (len(pairs),)
    assert np.array_equal(np.isneginf(got), np.isneginf(want)) and np.isfinite(want).any()
    fin = np.isfinite(want)
    assert np.abs(got[fin] - want[fin]).max() <= BATCH_TOL
    for b, (ri, hi) in enumerate(pairs):
        if (b == 0 and "rlen0" in edges) or (b == 1 and "hlen0" in edges):
            assert got[b] == want[b] == -np.inf
            continue
        host = jax_fp.flow_pairhmm_log10(haps[hi], reads[ri])
        assert abs(got[b] - host) <= HOST_TOL and abs(want[b] - host) <= HOST_TOL, (b, host)


def _tables_and_packed(seed, read_lens, hap_lens, edges):
    """The port's tables (pack_flow_tables, on the CPU) and pair lists, and
    gatk_tpu's packed arrays of the same pairs, with read 0 given no flows
    ("rlen0") and haplotype 1 none ("hlen0") in both, as the packers write
    such a read or haplotype."""
    hap_bases, read_specs = synthetic.flow_batch(seed, read_lens, hap_lens)
    haps, reads = _objects(jax_flow, hap_bases, read_specs)
    pairs = [(ri, hi) for ri in range(len(reads)) for hi in range(len(haps))]
    packed = jax_fp._pack_flow_batch(haps, reads, pairs)
    tab = port_fp.pack_flow_tables(*_objects(port_flow, hap_bases, read_specs), "cpu")
    ri = torch.tensor([p[0] for p in pairs], dtype=torch.int32)
    hi = torch.tensor([p[1] for p in pairs], dtype=torch.int32)
    if "rlen0" in edges:
        for k, v in (("tables", 0), ("trans", 0), ("rlen", 0), ("rfo", port_fp.READ_PAD)):
            tab[k][0] = v
        of_read = (ri == 0).numpy()
        packed["prior"][of_read] = 0
        packed["trans"][of_read] = 0
        packed["rlen"][of_read] = 0
    if "hlen0" in edges:
        for k, v in (("hkey", 0), ("hlen", 0), ("hfo", port_fp.HAP_PAD)):
            tab[k][1] = v
        of_hap = (hi == 1).numpy()
        packed["prior"][of_hap] = 0
        packed["hlen"][of_hap] = 0
    return tab, ri, hi, packed


@pytest.mark.parametrize("seed,read_lens,hap_lens,edges", CASES)
def test_pairs_plain_matches_jax_batch(seed, read_lens, hap_lens, edges):
    """The coset lattice's plain version against gatk_tpu's dense scan, on the
    same pairs: within BATCH_TOL, the same -inf pairs. Every case has a read
    with Rp flows and pairs whose hlen is far below Hp; W = Hp + 5 takes every
    residue mod 4; rlen 0 and hlen 0 where the case asks."""
    tab, ri, hi, packed = _tables_and_packed(seed, read_lens, hap_lens, edges)
    assert int(tab["rlen"].max()) == tab["rfo"].shape[1] == packed["Rp"]
    want = np.asarray(jax_fp.flow_pairhmm_batch_jax(packed["prior"], packed["trans"],
                                                    packed["rlen"], packed["hlen"]))
    got = port_fp.flow_pairhmm_pairs_plain(tab, ri, hi).numpy()
    assert got.shape == want.shape == (len(ri),) and got.dtype == np.float32
    assert np.array_equal(np.isneginf(got), np.isneginf(want)) and np.isfinite(want).any()
    fin = np.isfinite(want)
    assert np.abs(got[fin] - want[fin]).max() <= BATCH_TOL
    if "rlen0" in edges:
        assert np.isneginf(got[(ri == 0).numpy()]).all()
    if "hlen0" in edges:
        assert np.isneginf(got[(hi == 1).numpy()]).all()


@pytest.mark.parametrize("seed,read_lens,hap_lens,edges", CASES)
def test_pairs_entry_matches_dense_plain(seed, read_lens, hap_lens, edges):
    """The entry on CPU tables (its coset rule checked, then the coset plain
    version) against the port's dense plain version on the gathered prior."""
    tab, ri, hi, _ = _tables_and_packed(seed, read_lens, hap_lens, edges)
    assert port_fp.coset_rule_breaks(tab, ri, hi).tolist() == [0, 0]
    got = port_fp.flow_pairhmm_pairs(tab, ri, hi)
    want = port_fp.flow_pairhmm_batch_plain(port_fp.flow_prior(tab, ri, hi), tab["trans"][ri],
                                            tab["rlen"][ri], tab["hlen"][hi])
    fin = torch.isfinite(want)
    assert torch.equal(fin, torch.isfinite(got)) and fin.any()
    assert (got[~fin] == -np.inf).all()
    assert (got[fin] - want[fin]).abs().max().item() <= BATCH_TOL


EIGHT = "TGCATGAC"  # an 8-letter flow order that does not repeat with period 4


def _jax_dense(haps, reads, ri, hi):
    """gatk_tpu's dense scan (flow_pairhmm_batch_jax on its host packing) of
    the pairs (reads[ri[b]], haps[hi[b]])."""
    packed = jax_fp._pack_flow_batch(haps, reads, list(zip(ri.tolist(), hi.tolist())))
    return np.asarray(jax_fp.flow_pairhmm_batch_jax(packed["prior"], packed["trans"],
                                                    packed["rlen"], packed["hlen"]))


def _close_to_jax(got, want):
    fin = np.isfinite(want)
    assert np.array_equal(fin, np.isfinite(got)) and fin.any()
    assert (got[~fin] == -np.inf).all()
    assert np.abs(got[fin] - want[fin]).max() <= BATCH_TOL


def test_entry_scores_an_order_that_is_not_4_periodic_by_the_dense_scan():
    """The coset rule (coset_rule_breaks, the plain version of the coset
    kernel's flags, and rule_broken_pairs) on CPU tables: TGCA and ACGT keep
    it, a haplotype or a read in an 8-letter order that is not 4-periodic
    breaks it. The entry on CPU tables scores the pairs that break it by the
    dense scan, as the CUDA entry does with its dense kernel, and gives
    gatk_tpu's flow_pairhmm_batch_jax result for them (and for the pairs
    that keep it); the CPU route of compute_flow_likelihood_matrix gives
    gatk_tpu's matrix for such an order."""
    hap_bases, read_specs = synthetic.flow_batch(7, (60, 90), (80, 120))
    ri, hi = torch.tensor([0, 0, 1, 1], dtype=torch.int32), torch.tensor([0, 1, 0, 1],
                                                                         dtype=torch.int32)
    for order in ("TGCA", "ACGT"):
        haps = [port_flow.FlowBasedHaplotype(h, order) for h in hap_bases]
        reads = [port_flow.FlowBasedRead(b, q, order, tp=tp) for b, q, tp in read_specs]
        tab = port_fp.pack_flow_tables(haps, reads, "cpu")
        assert port_fp.coset_rule_breaks(tab, ri, hi).tolist() == [0, 0]
        assert not port_fp.rule_broken_pairs(tab, ri, hi).any()
        assert torch.isfinite(port_fp.flow_pairhmm_pairs(tab, ri, hi)).all()
    orders = [("TGCA", EIGHT), ("TGCA", "TGCA")]
    jh = [jax_flow.FlowBasedHaplotype(h, o) for h, o in zip(hap_bases, orders[0])]
    ph = [port_flow.FlowBasedHaplotype(h, o) for h, o in zip(hap_bases, orders[0])]
    jr = [jax_flow.FlowBasedRead(b, q, tp=tp) for b, q, tp in read_specs]
    pr = [port_flow.FlowBasedRead(b, q, tp=tp) for b, q, tp in read_specs]
    tab = port_fp.pack_flow_tables(ph, pr, "cpu")
    assert port_fp.coset_rule_breaks(tab, ri, hi).tolist() == [0, 2]
    assert port_fp.coset_rule_breaks(tab, ri[hi == 0], hi[hi == 0]).tolist() == [0, 0]
    assert port_fp.rule_broken_pairs(tab, ri, hi).tolist() == (hi == 1).tolist()
    _close_to_jax(port_fp.flow_pairhmm_pairs(tab, ri, hi).numpy(), _jax_dense(jh, jr, ri, hi))
    # read 1 in the 8-letter order, against haplotype 0 alone
    jr[1] = jax_flow.FlowBasedRead(*read_specs[1][:2], EIGHT, tp=read_specs[1][2])
    pr[1] = port_flow.FlowBasedRead(*read_specs[1][:2], EIGHT, tp=read_specs[1][2])
    tab = port_fp.pack_flow_tables(ph[:1], pr, "cpu")
    r2, h2 = torch.tensor([0, 1], dtype=torch.int32), torch.zeros(2, dtype=torch.int32)
    assert port_fp.coset_rule_breaks(tab, r2, h2).tolist() == [2, 0]
    assert port_fp.rule_broken_pairs(tab, r2, h2).tolist() == [False, True]
    _close_to_jax(port_fp.flow_pairhmm_pairs(tab, r2, h2).numpy(),
                  _jax_dense(jh[:1], jr, r2, h2))
    # everything in the 8-letter order: the entry, the CPU route and gatk_tpu agree
    jh = [jax_flow.FlowBasedHaplotype(h, EIGHT) for h in hap_bases]
    jr = [jax_flow.FlowBasedRead(b, q, EIGHT, tp=tp) for b, q, tp in read_specs]
    ph = [port_flow.FlowBasedHaplotype(h, EIGHT) for h in hap_bases]
    pr = [port_flow.FlowBasedRead(b, q, EIGHT, tp=tp) for b, q, tp in read_specs]
    want = jax_fp.compute_flow_likelihood_matrix(jh, jr)
    got = port_fp.compute_flow_likelihood_matrix(ph, pr, device="cpu")
    _close_to_jax(got, want)
    tab = port_fp.pack_flow_tables(ph, pr, "cpu")
    assert port_fp.rule_broken_pairs(tab, ri, hi).all()
    _close_to_jax(port_fp.flow_pairhmm_pairs(tab, ri, hi).numpy(), want.reshape(-1))


@pytest.mark.parametrize("seed,read_lens,hap_lens", [(c[0], c[1], c[2]) for c in CASES])
def test_gathered_prior_equals_host_packing(seed, read_lens, hap_lens):
    """The prior, transitions and lengths the port gathers on the device
    (pack_flow_tables + flow_prior, run here on the CPU) equal gatk_tpu's
    _pack_flow_batch arrays bit for bit, as the port's copy of that packer's do."""
    hap_bases, read_specs = synthetic.flow_batch(seed, read_lens, hap_lens)
    jh, jr = _objects(jax_flow, hap_bases, read_specs)
    ph, pr = _objects(port_flow, hap_bases, read_specs)
    pairs = [(ri, hi) for ri in range(len(jr)) for hi in range(len(jh))]
    packed = jax_fp._pack_flow_batch(jh, jr, pairs)
    port_packed = port_fp._pack_flow_batch(ph, pr, pairs)
    for k in ("prior", "trans", "rlen", "hlen"):
        assert port_packed[k].tobytes() == packed[k].tobytes()
    tab = port_fp.pack_flow_tables(ph, pr, "cpu")
    ri = torch.tensor([p[0] for p in pairs])
    hi = torch.tensor([p[1] for p in pairs])
    prior = port_fp.flow_prior(tab, ri, hi).numpy()
    assert prior.dtype == packed["prior"].dtype and prior.shape == packed["prior"].shape
    assert prior.tobytes() == packed["prior"].tobytes()
    assert tab["trans"][ri].numpy().tobytes() == packed["trans"].tobytes()
    assert np.array_equal(tab["rlen"][ri].numpy(), packed["rlen"])
    assert np.array_equal(tab["hlen"][hi].numpy(), packed["hlen"])


def _test_flow_objects(mod):
    """tests/test_flow.py's haplotypes and reads (TestFlowPairHMM)."""
    hap = "TTGCAATGGCATTTGCAGGTTACA"

    def k(s):
        return np.frombuffer(s.encode(), dtype=np.uint8)

    def read(bases, qual=35, tp_spread=True):
        b = k(bases)
        tp = None
        if tp_spread:
            tp = np.zeros(len(b), np.int8)
            tp[::2] = -1
        return mod.FlowBasedRead(b, np.full(len(b), qual, np.uint8), tp=tp)

    haps = [mod.FlowBasedHaplotype(k(hap)),
            mod.FlowBasedHaplotype(k(hap[:4] + "T" + hap[4:])),
            mod.FlowBasedHaplotype(k(hap.replace("GG", "GC", 1)))]
    reads = [read(hap[:16]), read(hap[4:20]), read("T" + hap[2:18]),
             read(hap[:12], qual=20, tp_spread=False)]
    return haps, reads


def test_likelihood_matrix_matches_jax_on_test_flow_inputs():
    want = jax_fp.compute_flow_likelihood_matrix(*_test_flow_objects(jax_flow))
    haps, reads = _test_flow_objects(port_flow)
    got = port_fp.compute_flow_likelihood_matrix(haps, reads, device="cpu")
    assert got.shape == want.shape == (4, 3) and got.dtype == np.float64
    assert np.abs(got - want).max() <= BATCH_TOL
    for ri, r in enumerate(reads):
        for hi, h in enumerate(haps):
            assert got[ri, hi] == pytest.approx(port_fp.flow_pairhmm_log10(h, r), abs=HOST_TOL)


def test_likelihood_matrix_cut_into_launches_is_unchanged(monkeypatch):
    """A batch over MAX_PRIOR_FLOATS goes in several launches of whole pairs,
    with the same result."""
    haps, reads = _test_flow_objects(port_flow)
    whole = port_fp.compute_flow_likelihood_matrix(haps, reads, device="cpu")
    monkeypatch.setattr(port_fp, "MAX_PRIOR_FLOATS", 1)
    assert np.array_equal(port_fp.compute_flow_likelihood_matrix(haps, reads, device="cpu"),
                          whole)


def test_likelihood_matrix_on_cuda_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(devices, "_DEFAULT_DEVICE", torch.device("cuda"))
    haps, reads = _test_flow_objects(port_flow)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_fp.compute_flow_likelihood_matrix(haps, reads)


@pytest.fixture(scope="module")
def flow_sample(tmp_path_factory):
    """A 2 kb flow-space sample of 200 reads of 200 bases (20x): 3 SNVs and 2
    indels, one of them a homopolymer's length."""
    return synthetic.write_flow_sample(str(tmp_path_factory.mktemp("flow")), seed=0,
                                       length=2000, n_reads=200, n_snv=3, n_indel=2,
                                       n_hmer_indel=1, min_gap=250)


FLOW_HC = ["--likelihood-calculation-engine", "FlowBasedHMM", "--flow-order", "TGCA"]


def test_flow_haplotype_caller_identical_to_jax(flow_sample, tmp_path):
    jax_out, port_out = str(tmp_path / "jax.vcf"), str(tmp_path / "port.vcf")
    common = ["-I", flow_sample["bam"], "-R", flow_sample["fasta"], *FLOW_HC]
    assert JAX_TOOLS["HaplotypeCaller"](common + ["-O", jax_out]) == 0
    assert port_cli.main(["HaplotypeCaller", *common, "-O", port_out, "--device", "cpu"]) == 0
    with open(jax_out, "rb") as a, open(port_out, "rb") as b:
        want, got = a.read(), b.read()
    assert got == want
    records = [ln.split("\t") for ln in got.decode().splitlines() if not ln.startswith("#")]
    called = {(int(f[1]) - 1, f[3], f[4], f[9].split(":")[0]) for f in records}
    for v in flow_sample["variants"]:
        assert (v.pos, v.ref, v.alt, "0/1") in called, v
    assert flow_sample["hmer_indels"]


def test_flow_haplotype_caller_on_cuda_raises_without_a_card(flow_sample, tmp_path,
                                                             monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(devices, "_DEFAULT_DEVICE", torch.device("cuda"))
    argv = ["HaplotypeCaller", "-I", flow_sample["bam"], "-R", flow_sample["fasta"], *FLOW_HC,
            "-O", str(tmp_path / "x.vcf")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cli.main(argv)
    assert not (tmp_path / "x.vcf").exists()


@pytest.mark.parametrize("tool,args,outputs", [
    ("FlowFeatureMapper", ["-I", "{bam}", "-R", "{fasta}", "-O", "{out}/ffm.vcf"], ["ffm.vcf"]),
    ("AddFlowSNVQuality", ["-I", "{bam}", "-O", "{out}/snvq.bam"], ["snvq.bam"]),
    ("AddFlowBaseQuality", ["-I", "{bam}", "-O", "{out}/xq.bam"], ["xq.bam"]),
    ("GroundTruthScorer", ["-I", "{bam}", "-R", "{fasta}", "--output-csv", "{out}/gts.csv",
                           "--report-file", "{out}/gts.tsv"], ["gts.csv", "gts.tsv"]),
])
def test_flow_tools_identical_to_jax(flow_sample, tmp_path, tool, args, outputs):
    """The flow tools of tests/test_flow.py and tests/test_new_tools_r4.py on
    the flow sample's reads (tp and t0 tags): the port writes gatk_tpu's
    files byte for byte."""
    outs = {}
    for name, registry in (("jax", JAX_TOOLS), ("port", port_cli.TOOL_REGISTRY)):
        d = tmp_path / name
        d.mkdir()
        argv = [a.format(bam=flow_sample["bam"], fasta=flow_sample["fasta"], out=d)
                for a in args]
        assert registry[tool](argv) == 0
        outs[name] = [open(os.path.join(d, f), "rb").read() for f in outputs]
    assert outs["port"] == outs["jax"]
    assert all(len(b) > 100 for b in outs["port"])


def test_ground_truth_reads_builder_identical_to_jax(flow_sample, tmp_path):
    """GroundTruthReadsBuilder with the sample's reference as both parents'."""
    outs = []
    for registry in (JAX_TOOLS, port_cli.TOOL_REGISTRY):
        out = str(tmp_path / f"gt{len(outs)}.csv")
        assert registry["GroundTruthReadsBuilder"](
            ["-I", flow_sample["bam"], "--maternal-ref", flow_sample["fasta"],
             "--paternal-ref", flow_sample["fasta"], "--output-csv", out]) == 0
        outs.append(open(out, "rb").read())
    assert outs[0] == outs[1] and outs[0].count(b"\n") > 100


@pytest.fixture(scope="module")
def flow_haplotypes(flow_sample, tmp_path_factory):
    """The reference's and the planted allele's window around the flow
    sample's first two variants, as a haplotypes FASTA."""
    path = str(tmp_path_factory.mktemp("haps") / "haps.fa")
    synthetic.write_flow_haplotypes(path, flow_sample["fasta"], flow_sample["contig"],
                                    flow_sample["variants"], n_variants=2, seed=0)
    return path


@pytest.mark.parametrize("order", ["TGCA", EIGHT])
def test_flow_align_reads_to_haplotypes_identical_to_jax(flow_sample, flow_haplotypes, tmp_path,
                                                         order):
    """FlowPairHMMAlignReadsToHaplotypes --device cpu writes gatk_tpu's TSV, in
    HaplotypeCaller's flow order and in one that breaks the coset rule: the
    same header, reads and -inf cells, and every log10 likelihood within one
    step of its 4th decimal (the tool prints 4). Not byte for byte: the port's
    dense scan rounds its float32 sums and log10 otherwise than XLA's, so a
    value near a rounding edge prints one step apart (ROADMAP section 3)."""
    outs = []
    for registry, extra in ((JAX_TOOLS, []), (port_cli.TOOL_REGISTRY, ["--device", "cpu"])):
        out = str(tmp_path / f"m{len(outs)}.tsv")
        assert registry["FlowPairHMMAlignReadsToHaplotypes"](
            ["-I", flow_sample["bam"], "-H", flow_haplotypes, "-O", out, "--flow-order", order,
             *extra]) == 0
        outs.append([ln.split("\t") for ln in open(out).read().splitlines()])
    want, got = outs
    assert len(got) == 1 + flow_sample["n_reads"] and got[0] == want[0] and len(got[0]) == 5
    assert [r[0] for r in got] == [r[0] for r in want]
    w = np.array([r[1:] for r in want[1:]], dtype=float)
    g = np.array([r[1:] for r in got[1:]], dtype=float)
    fin = np.isfinite(w)
    assert np.array_equal(fin, np.isfinite(g)) and fin.all()
    assert np.abs(g - w).max() <= PRINTED_TOL


def test_flow_align_reads_to_haplotypes_on_cuda_raises_without_a_card(
        flow_sample, flow_haplotypes, tmp_path, monkeypatch):
    """Without --device cpu the tool asks for the card, and without one it
    raises before it reads its inputs; it does not fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(devices, "_DEFAULT_DEVICE", torch.device("cuda"))
    argv = ["FlowPairHMMAlignReadsToHaplotypes", "-I", flow_sample["bam"], "-H", flow_haplotypes,
            "-O", str(tmp_path / "m.tsv")]
    for extra in ([], ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_cli.main(argv + extra)
    assert not (tmp_path / "m.tsv").exists()
