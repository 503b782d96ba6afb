"""The port's reference-confidence model in one dense pass, against gatk_tpu's
per-read and per-position loops, on the CPU: gvcf/refconf.ref_vs_any_gls
(pileup elements, qual lookup tables, bincount) and
GvcfBlockWriter.add_hom_ref_run (hom-ref banding in bulk) must give the same
PLs, depths, records and open block, bit for bit."""
import numpy as np
import pytest

from gatk_tpu.gvcf import refconf as jax_refconf
from gatk_tpu_torch.engine import pileup
from gatk_tpu_torch.gvcf import refconf
from gatk_tpu_torch.io import sam
from gatk_tpu_torch.io.reads import Read
from gatk_tpu_torch.io.vcf import Variant

SPAN = (1_000, 1_400)
BASES = np.frombuffer(b"ACGT", np.uint8)


def _read(rng, k, pos, ref, length):
    """A read at pos whose CIGAR mixes soft clips, an insertion and a
    deletion at random; its bases follow ref (the genome from 0) with 3 %
    substitutions, its quals run 0-40 and crowd the usual minima."""
    ops, lens = [], []
    if rng.random() < 0.3:
        ops.append(sam.OP_S)
        lens.append(int(rng.integers(1, 8)))
    left = length - sum(lens)
    while left > 0:
        m = int(min(left, rng.integers(10, 60)))
        ops.append(sam.OP_M)
        lens.append(m)
        left -= m
        if left > 4 and rng.random() < 0.35:
            if rng.random() < 0.5:
                ops.append(sam.OP_D)
                lens.append(int(rng.integers(1, 4)))
            else:
                ins = int(rng.integers(1, 4))
                ops.append(sam.OP_I)
                lens.append(ins)
                left -= ins
    if ops[-1] == sam.OP_M and rng.random() < 0.3 and lens[-1] > 4:
        lens[-1] -= 3
        ops.append(sam.OP_S)
        lens.append(3)
    bases = np.empty(length, np.uint8)
    read_i, ref_i = 0, pos
    for op, ln in zip(ops, lens):
        if op == sam.OP_M:
            bases[read_i:read_i + ln] = ref[ref_i:ref_i + ln]
            read_i += ln
            ref_i += ln
        elif op == sam.OP_D:
            ref_i += ln
        else:
            bases[read_i:read_i + ln] = rng.choice(BASES, ln)
            read_i += ln
    sub = rng.random(length) < 0.03
    bases[sub] = rng.choice(BASES, int(sub.sum()))
    quals = rng.choice(np.array([0, 2, 9, 10, 11, 19, 20, 21, 25, 30, 35, 40], np.uint8), length)
    return Read(f"r{k}", 0, 0, pos, 60, np.array(ops, np.uint8), np.array(lens, np.int32),
                bases, quals)


def _pileup(kind, seed=7):
    """(reads, ref) for a pileup kind: mixed reads that also overhang both
    ends of SPAN, none at all, or deep enough that positions pass 40
    indel-informative reads."""
    rng = np.random.default_rng(seed)
    ref = rng.choice(BASES, SPAN[1] + 400)
    if kind == "empty":
        return [], ref
    n = 300 if kind == "mixed" else 700
    starts = np.sort(rng.integers(SPAN[0] - 160, SPAN[1] + 10, n))
    if kind == "deep":
        starts = np.sort(rng.integers(SPAN[0] + 100, SPAN[0] + 200, n))
    reads = [_read(rng, k, int(p), ref, 151) for k, p in enumerate(starts)]
    # one read over the whole span
    reads.insert(0, _read(rng, n, SPAN[0] - 5, ref, SPAN[1] - SPAN[0] + 30))
    return reads, ref


@pytest.mark.parametrize("kind", ["mixed", "empty", "deep", "mixed_without_native"])
@pytest.mark.parametrize("min_base_qual", [10, 20])
@pytest.mark.parametrize("ploidy", [1, 2, 3])
def test_ref_vs_any_gls_equals_the_loops(kind, min_base_qual, ploidy, monkeypatch):
    if kind.endswith("_without_native"):
        # the pileup's Python path (expand_read a read) instead of readprep
        monkeypatch.setattr(pileup, "_load_native", lambda: None)
    reads, ref = _pileup(kind.split("_")[0])
    ref_span = ref[SPAN[0]:SPAN[1]]
    want = jax_refconf.ref_vs_any_gls(reads, *SPAN, ref_span, min_base_qual=min_base_qual,
                                      ploidy=ploidy)
    got = refconf.ref_vs_any_gls(reads, *SPAN, ref_span, min_base_qual=min_base_qual,
                                 ploidy=ploidy)
    assert got[0].shape == (SPAN[1] - SPAN[0], ploidy + 1)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    assert got[0].dtype == want[0].dtype and got[1].dtype == want[1].dtype
    if kind == "deep":
        el = pileup.build_pileup_elements(reads, *SPAN)
        assert np.bincount(el["pos"], minlength=SPAN[1] - SPAN[0]).max() > 2 * 40
    if kind == "mixed":
        assert reads[0].pos < SPAN[0] and reads[0].end > SPAN[1]
        assert (want[0] != 0).any() and want[1].max() > 0


def _rows(gqs, seed):
    """PL rows whose GQ (gap of the two least) is each of gqs; the least at a
    random genotype, as a het-like site puts it."""
    rng = np.random.default_rng(seed)
    rows = []
    for gq in gqs:
        row = [0, int(gq), int(gq) + int(rng.integers(0, 400))]
        rng.shuffle(row)
        rows.append(row)
    return np.array(rows, np.int64)


def _band_runs(rng, n, values):
    """n GQs in runs of 1-9 equal ones, drawn from values."""
    out = []
    while len(out) < n:
        out += [int(rng.choice(values))] * int(rng.integers(1, 10))
    return np.array(out[:n])


CUSTOM = [5, 20, 60]
EDGES = [4, 5, 6, 19, 20, 21, 59, 60, 61, 98, 99, 100, 150]
BAND_CASES = {
    "default": (None, list(range(0, 120, 7)) + [99, 100, 200]),
    "default_edges": (None, [0, 1, 59, 60, 61, 69, 70, 71, 89, 90, 98, 99, 100, 500]),
    "custom_edges": (CUSTOM, EDGES),
    "custom_past_99": ([10, 50, 99, 100], EDGES),
}


def _write(writer, steps, one_by_one):
    """Feed each ("run", start, ref, pls, dps) to writer position by position
    or in bulk; each ("site", pos, ref, pl, dp), a hom-ref call site, and
    each ("variant", pos) as they come."""
    for kind, *item in steps:
        if kind == "variant":
            writer.add_variant(Variant("20", item[0], "A", ("C", "<NON_REF>")))
        elif kind == "site":
            writer.add_hom_ref(*item)
        elif one_by_one:
            start, ref, pls, dps = item
            for i in range(len(dps)):
                writer.add_hom_ref(start + i, chr(ref[i]), pls[i], int(dps[i]))
        else:
            writer.add_hom_ref_run(*item)


@pytest.mark.parametrize("case", sorted(BAND_CASES))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bulk_banding_equals_add_hom_ref(case, seed):
    bands, values = BAND_CASES[case]
    rng = np.random.default_rng(seed)
    steps, start = [], 100
    for k in range(6):
        n = int(rng.integers(1, 60))
        gqs = _band_runs(rng, n, values)
        ref = bytes(rng.choice(BASES, n))
        dps = rng.integers(0, 60, n)
        steps.append(("run", start, ref, _rows(gqs, seed + k), dps))
        start += n
        if k == 1:
            # a hom-ref call site, then a run that may continue its block
            steps.append(("site", start, "G", [0, int(values[-1]), 900], 33))
            start += 1
        if k == 3:
            steps.append(("variant", start))
            start += 5
    steps.append(("run", start, b"", np.empty((0, 3), np.int64), np.empty(0, np.int64)))
    a = refconf.GvcfBlockWriter("20", "S", gq_bands=bands)
    b = refconf.GvcfBlockWriter("20", "S", gq_bands=bands)
    _write(a, steps, one_by_one=True)
    _write(b, steps, one_by_one=False)
    assert b._block == a._block
    a.flush()
    b.flush()
    assert b.records == a.records
    assert len(a.records) > 10


def test_bulk_banding_upper_median_and_first_min():
    """An even-length block takes the upper median DP, the row of its first
    least GQ, and the least DP as MIN_DP."""
    w = refconf.GvcfBlockWriter("20", "S", gq_bands=[10, 50])
    pls = np.array([[0, 30, 60], [0, 20, 40], [0, 25, 50], [20, 0, 90]])  # GQs 30, 20, 25, 20
    w.add_hom_ref_run(10, b"ACGT", pls, np.array([7, 3, 9, 5]))
    w.flush()
    (r,) = w.records
    assert (r.pos, r.end, r.ref) == (10, 14, "A")
    s = r.samples[0]
    assert (s["DP"], s["MIN_DP"], s["GQ"], s["PL"]) == ("7", "3", "20", "0,20,40")


@pytest.mark.parametrize("gap", [0, 1])
@pytest.mark.parametrize("same_band", [True, False])
def test_bulk_run_continues_a_block_that_add_hom_ref_opened(same_band, gap):
    """A run continues the block a hom-ref call site opened when its first
    band is the block's and it starts where the block ends, as add_hom_ref
    would; else it flushes the block first."""
    ws = [refconf.GvcfBlockWriter("20", "S") for _ in range(2)]
    pls = _rows([45, 45, 12, 12, 12, 80], 3) if same_band else _rows([12, 45, 45, 45], 3)
    dps = np.arange(len(pls)) + 20
    ref = b"ACGTAC"[:len(pls)]
    for w in ws:
        w.add_hom_ref(99, "T", [0, 45, 90], 40)
    for i in range(len(pls)):
        ws[0].add_hom_ref(100 + gap + i, chr(ref[i]), pls[i], int(dps[i]))
    ws[1].add_hom_ref_run(100 + gap, ref, pls, dps)
    assert ws[1]._block == ws[0]._block
    for w in ws:
        w.flush()
    assert ws[1].records == ws[0].records
    assert ws[1].records[0].end == (100 + 2 if same_band and not gap else 100)
