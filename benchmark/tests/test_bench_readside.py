"""The reference's read side: the frozen PCR rule against the port's, and
the rebuild of packed reads from the generated ones, which finds a quality
that the program would have got wrong."""
import numpy as np
import torch

from yardstick import gen, readside
from test_bench_gen import HC


def test_gap_open_quals_as_the_port():
    from gatk_tpu_torch.calling import read_prep
    from gatk_tpu_torch.io.reads import Read

    rng = np.random.default_rng(4)
    units = [b"A", b"AC", b"ACG", b"AGGT", b"ACGTTGCA"]
    for k in range(40):
        parts = [bytes(gen.ACGT[rng.integers(0, 4, rng.integers(1, 12))])]
        parts += [units[k % 5] * int(rng.integers(1, 8)) for _ in range(3)]
        bases = b"".join(parts)[: int(rng.integers(2, 151))]
        n = len(bases)
        read = Read.make("r", 0, 0, 0, 60, np.array([0], np.uint8), np.array([n], np.int32),
                         np.frombuffer(bases, np.uint8), np.full(n, 30, np.uint8), -1, -1, 0,
                         {})
        want = read_prep.prepare_reads_for_pairhmm([read])[0]
        got = readside.gap_open_quals(bases)
        assert np.array_equal(got, want["iq"]) and np.array_equal(got, want["dq"]), bases


def _packed(sample, rows, offs, n):
    """Pairs of generated reads clipped to [off, off + n), with the tables the
    rules give them (no mate overlaps: rows chosen apart from their mates)."""
    rb = np.stack([sample.reads["bases"][r, o : o + n] for r, o in zip(rows, offs)])
    rq = np.stack([sample.reads["quals"][r, o : o + n] for r, o in zip(rows, offs)])
    gop = np.stack([readside.gap_open_quals(bytes(b)) for b in rb])
    T = torch.from_numpy
    P = len(rows)
    return dict(rb=T(rb), rq=T(rq.copy()), iq=T(gop.copy()), dq=T(gop.copy()),
                gcp=T(np.full((P, n), 10, np.uint8)), rlen=T(np.full(P, n, np.int32)),
                hb=T(rb.copy()), hlen=T(np.full(P, n, np.int32)))


def test_rebuild_finds_a_wrong_quality(tmp_path):
    s = gen.generate(str(tmp_path), 12, dict(HC, genome_bp=10000))
    rd = s.reads
    L = rd["bases"].shape[1]
    apart = np.abs(rd["hap_start"] - rd["hap_start"][rd["mate"]]) > L + 10
    rows = np.nonzero(apart)[0][:20]
    pairs = _packed(s, rows, [7] * len(rows), 100)
    out, counts = readside.rebuild(s, pairs, 60)
    assert counts == dict(rebuilt=20, short=0, mismatched=0)
    for k in ("rq", "iq", "dq", "gcp"):
        assert torch.equal(out[k], pairs[k])
    pairs["rq"][3, 50] = 2 + pairs["rq"][3, 50] % 20  # a quality the rules do not give
    pairs["iq"][5, 10] = 44
    pairs["rb"][9, 60] = ord("A") if pairs["rb"][9, 60] != ord("A") else ord("C")
    out, counts = readside.rebuild(s, pairs, 60)
    assert counts == dict(rebuilt=19, short=0, mismatched=3)
    assert out["rq"][3, 50] != pairs["rq"][3, 50] and out["iq"][5, 10] != 44
