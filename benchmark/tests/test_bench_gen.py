"""The vectorised generator and its BAM and BAI writer, against the port's
synthetic.py semantics and the port's BAM reader."""
import hashlib

import numpy as np
import pytest

from yardstick import gen

HC = dict(read_len=151, depth=30, insert_mean=450, insert_sd=100, insert_max=1000,
          err_rate=0.005, qual_range=(20, 40), germline_het_per_kb=1.0, hom_alt_per_kb=0.6,
          indel_share=0.125, indel_len=(1, 3), min_gap=300, edge_margin=200, genome_bp=30000,
          shard_bp=10000, sample="HG002")
M2 = dict(HC, depth=200, somatic_per_kb=1.0, somatic_af=(0.1, 0.3), indel_share=0.25,
          edge_margin=150, genome_bp=8000, shard_bp=4000, sample="TUMOR")


def _digest(sample):
    h = hashlib.sha256()
    for path in (sample.fasta, sample.fasta + ".fai", sample.bam, sample.bam + ".bai"):
        with open(path, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()


def test_same_seed_same_bytes(tmp_path):
    seed = 2**31 + 12345
    a = gen.generate(str(tmp_path / "a"), seed, HC)
    b = gen.generate(str(tmp_path / "b"), seed, HC)
    c = gen.generate(str(tmp_path / "c"), seed + 1, HC)
    assert _digest(a) == _digest(b)
    assert _digest(a) != _digest(c)
    assert a.variants == b.variants


def test_every_seed_the_same_work(tmp_path):
    a = gen.generate(str(tmp_path / "a"), 1, M2)
    b = gen.generate(str(tmp_path / "b"), 2, M2)
    # the same fragments start in each shard; the right mates that start in
    # the next shard differ by a few
    for x, y in zip(a.shards, b.shards):
        assert abs(x.reads - y.reads) <= 0.01 * x.reads
    assert len(a.reads["first"]) == len(b.reads["first"])
    def kinds(s):
        return [sorted((v.kind, v.is_snv) for v in sh.variants) for sh in s.shards]

    assert kinds(a) == kinds(b)
    assert [v.pos for v in a.variants] != [v.pos for v in b.variants]


def test_haplotype_and_cigar_as_synthetic():
    from gatk_tpu_torch.utils import synthetic

    rng = np.random.default_rng(3)
    ref = gen.ACGT[rng.integers(0, 4, 3000)]
    shards = [gen.Shard(0, 0, 3000)]
    gen.plant(rng, ref, shards, dict(HC, shard_bp=3000, germline_het_per_kb=2.0,
                                     indel_share=0.5))
    ours = gen.alt_haplotype(ref, shards[0].variants)
    theirs = synthetic._alt_haplotype(
        ref, [synthetic.Planted(v.pos, v.ref, v.alt) for v in shards[0].variants])
    assert np.array_equal(ours[0], theirs[0]) and np.array_equal(ours[1], theirs[1])
    seq, where = ours
    for s in rng.integers(0, len(seq) - 151, 200).tolist():
        w = where[s : s + 151]
        a, b = gen.cigar_of(w), synthetic._cigar(w)
        assert a[0] == b[0] and np.array_equal(a[1], b[1]) and np.array_equal(a[2], b[2])


def _aligned(read, ref):
    """(ref position, read base) of each aligned base of a read."""
    out, r, q = [], read.pos, 0
    for op, n in zip(read.cigar_ops.tolist(), read.cigar_lens.tolist()):
        if op == 0:
            out += [(r + k, read.bases[q + k]) for k in range(n)]
            r, q = r + n, q + n
        elif op in (1, 4):
            q += n
        elif op == 2:
            r += n
    return out


@pytest.mark.parametrize("params", [HC, M2], ids=["germline", "tumor"])
def test_truth_agrees_with_reads(tmp_path, params):
    from gatk_tpu_torch.io import bam, fasta

    s = gen.generate(str(tmp_path), 77, params)
    ref = fasta.FastaReference(s.fasta).fetch(s.contig, 0, s.length)
    reads = list(bam.BamReader(s.bam))
    assert len(reads) == s.n_reads
    assert [r.pos for r in reads] == sorted(r.pos for r in reads)
    per_shard = 2 * (round(params["depth"] * params["shard_bp"] / params["read_len"]) // 2)
    for sh in s.shards:  # fragments start in it; a few right mates start in the next
        assert sh.reads == sum(sh.start <= r.pos < sh.end for r in reads)
        assert abs(sh.reads - per_shard) <= 0.02 * per_shard
    assert any(v.af == 1.0 for v in s.variants) and any(v.af == 0.5 for v in s.variants)
    snvs = {v.pos: v for v in s.variants if v.is_snv}
    mismatch = bases = 0
    alt_reads = {p: [0, 0] for p in snvs}
    for r in reads:
        assert r.mapq == 60 and r.tags["RG"] == "rg1" and len(r.bases) == params["read_len"]
        assert r.quals.min() >= params["qual_range"][0] and r.quals.max() <= params["qual_range"][1]
        for pos, b in _aligned(r, ref):
            if pos in snvs:
                alt_reads[pos][0] += 1
                alt_reads[pos][1] += chr(b) == snvs[pos].alt
            elif b != ref[pos]:
                mismatch += 1
            bases += 1
    # errors at err_rate (an indel's flanks add a few), alt reads at the planted AF
    assert mismatch / bases < 2 * params["err_rate"]
    for pos, (n, alt) in alt_reads.items():
        want = snvs[pos].af
        assert abs(alt / n - want) < 4 * np.sqrt(want * (1 - want) / n) + 0.02


def test_pairs_as_sam_states_them(tmp_path):
    from gatk_tpu_torch.io import bam

    s = gen.generate(str(tmp_path), 8, HC)
    reads = list(bam.BamReader(s.bam))
    by_name = {}
    for r in reads:
        by_name.setdefault(r.name, []).append(r)
    assert all(len(v) == 2 for v in by_name.values())
    sizes, overlapping = [], 0
    for a, b in by_name.values():
        assert {a.flag, b.flag} in ({99, 147}, {83, 163})
        left, right = (a, b) if not a.is_reverse else (b, a)
        assert not left.is_reverse and right.is_reverse
        assert left.mate_pos == right.pos and right.mate_pos == left.pos
        assert left.mate_ref_id == right.mate_ref_id == 0
        assert left.tlen == -right.tlen == max(left.end, right.end) - min(left.pos, right.pos)
        sizes.append(left.tlen)
        overlapping += left.end > right.pos
    # inserts of mean 450 and sd 100; about 7 % of pairs overlap
    assert abs(np.mean(sizes) - 450) < 10 and abs(np.std(sizes) - 100) < 10
    assert 0.04 < overlapping / len(sizes) < 0.10
    # the rows kept for the reference: each read's mate, its haplotype and start
    rd = s.reads
    n = len(rd["first"])
    assert np.array_equal(rd["mate"][rd["mate"]], np.arange(2 * n))
    assert np.array_equal(rd["hap"][:n], rd["hap"][n:]) and set(rd["hap"].tolist()) <= {0, 1}


def test_index_query_equals_scan(tmp_path):
    from gatk_tpu_torch.io import bam

    s = gen.generate(str(tmp_path), 5, dict(HC, genome_bp=60000))
    reads = list(bam.BamReader(s.bam))
    for lo, hi in ((0, 500), (16000, 17000), (30000, 50000), (s.length - 300, s.length)):
        got = [r.name for r in bam.BamReader(s.bam).query(s.contig, lo, hi)]
        want = [r.name for r in reads if r.pos < hi and r.end > lo]
        assert got == want
