"""The benchmark's sample generator: one reference, one coordinate-sorted BAM
of paired reads with its .bai, and the planted truth, all drawn from a seed
with numpy.

Frozen copy, vectorised, of the semantics of gatk_tpu_torch/utils/synthetic.py
(write_sample and write_tumor_sample) as of the port's first benchmark:
uniform random reference bases; heterozygous germline SNVs and 1-3 bp indels
on one parental haplotype; somatic SNVs and indels on a somatic haplotype
whose reads are drawn with the variant's allele fraction; uniform sequencing
errors, uniform base qualities, mapping quality 60 and one read group;
inserted bases at a read's ends become soft clips. The program changes; this
copy does not, so the yardstick stays where it is. It imports nothing of the
program.

Beyond synthetic.py, as a whole-genome sample is: homozygous germline
variants, carried by both parental haplotypes (and by the somatic one), and
paired-end reads: fragments of a normal insert size (at least one read long,
so mates may overlap), one mate forward at the fragment's left end and one
reverse at its right end, both from the fragment's haplotype, with SAM's
pair flags, mate positions and template lengths.

The layout is the benchmark's own: the genome is a pool of equal shards,
each with the same number and kinds of planted variants for every seed (only
their positions, alleles and allele fractions follow the seed), and each
with the same number of fragments starting in it, so that two seeds give the
same amount of work.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from . import bamio

ACGT = np.frombuffer(b"ACGT", np.uint8)
_CODE = np.full(256, 255, np.uint8)
_CODE[ACGT] = np.arange(4, dtype=np.uint8)

OP_M, OP_I, OP_D, OP_S = 0, 1, 2, 4  # SAM CIGAR operation codes


@dataclass(frozen=True)
class Planted:
    """One planted variant, VCF style: 0-based pos, REF and ALT alleles, the
    fraction of reads over it that carry ALT, and its kind."""

    pos: int
    ref: str
    alt: str
    af: float = 0.5
    kind: str = "germline"

    @property
    def is_snv(self) -> bool:
        return len(self.ref) == 1 and len(self.alt) == 1


@dataclass
class Shard:
    """[start, end) 0-based on the contig, the reads whose alignment starts in
    it, and the variants planted in it."""

    index: int
    start: int
    end: int
    reads: int = 0
    variants: list = field(default_factory=list)


@dataclass
class Sample:
    """The files written, the planted truth of each shard, and every read as
    generated (rows in generation order, not the BAM's): bases and qualities
    (n, read_len), its mate's row, its haplotype and where on that haplotype
    it starts, for a reference that rebuilds reads from them."""

    fasta: str
    bam: str
    contig: str
    length: int
    shards: list
    n_reads: int
    variants: list
    ref: np.ndarray = None
    reads: dict = None


def _spread(total, n):
    """total split over n slots as evenly as integers allow, in slot order."""
    edges = (np.arange(n + 1) * total) // n
    return np.diff(edges).astype(int)


def _per_shard(n_shards, per_kb, shard_bp):
    """How many of one kind of variant each shard gets: the pool's total
    (per_kb over the whole pool, rounded) spread evenly over the shards."""
    total = int(round(per_kb * n_shards * shard_bp / 1000.0))
    return _spread(total, n_shards)


def _indel_flags(count, share):
    """Which of a kind's `count` variants, in pool order, are indels: a share
    `share` of them, the second and then every 1/share-th, so that a window
    over the first shards meets one early."""
    flags = np.zeros(count, bool)
    n_indel = int(round(count * share))
    if n_indel:
        at = 1 + np.floor(np.arange(n_indel) / share).astype(int)
        flags[np.minimum(at, count - 1)] = True
    return flags


def _draw_variant(rng, ref, pos, indel, indel_len, kind, af):
    r = chr(ref[pos])
    if indel:
        ln = int(rng.integers(indel_len[0], indel_len[1] + 1))
        if rng.random() < 0.5:  # deletion of ref[pos+1 : pos+1+ln]
            return Planted(pos, bytes(ref[pos : pos + 1 + ln]).decode(), r, af, kind)
        ins = bytes(ACGT[rng.integers(0, 4, ln)]).decode()
        return Planted(pos, r, r + ins, af, kind)
    alt = ACGT[(int(_CODE[ref[pos]]) + int(rng.integers(1, 4))) % 4]
    return Planted(pos, r, chr(alt), af, kind)


KINDS = (  # (rate key, Planted.kind, allele fraction or None for the somatic draw)
    ("germline_het_per_kb", "germline", 0.5),
    ("hom_alt_per_kb", "germline", 1.0),
    ("somatic_per_kb", "somatic", None),
)


def plant(rng, ref, shards, p):
    """Variants of every shard, in place: germline hets, homozygous germline
    variants and somatic variants at the per-kb rates of `p`, each group's
    indels a share `indel_share` of its count, at least p["min_gap"] bp apart
    and p["edge_margin"] bp inside the shard, so that a read (shorter than
    min_gap) covers at most one. Which shards hold which groups, and which
    variants are indels, is the same for every seed."""
    n = len(shards)
    counts = [_per_shard(n, p.get(key, 0.0), p["shard_bp"]) for key, _, _ in KINDS]
    groups_of_shard = [[g for g, c in enumerate(col) for _ in range(int(c))]
                       for col in zip(*counts)]
    indel_flags = {}  # popped from the end: reversed pool order
    for g in range(len(KINDS)):
        count = sum(k.count(g) for k in groups_of_shard)
        indel_flags[g] = list(_indel_flags(count, p.get("indel_share", 0.0))[::-1])
    margin, gap = p["edge_margin"], p["min_gap"]
    af_lo, af_hi = p.get("somatic_af", (0.1, 0.3))
    for sh, groups in zip(shards, groups_of_shard):
        if not groups:
            continue
        groups = [groups[i] for i in rng.permutation(len(groups))]
        span = (sh.end - sh.start) - 2 * margin
        step = span // len(groups)
        if step < gap:
            raise ValueError(f"{len(groups)} variants {gap} bp apart do not fit a "
                             f"{sh.end - sh.start} bp shard")
        jitter = rng.integers(0, step - gap + 1, len(groups))
        for k, g in enumerate(groups):
            pos = sh.start + margin + step * k + int(jitter[k])
            _, kind, af = KINDS[g]
            if af is None:
                af = float(rng.uniform(af_lo, af_hi))
            sh.variants.append(_draw_variant(rng, ref, pos, indel_flags[g].pop(),
                                             p.get("indel_len", (1, 3)), kind, af))


def alt_haplotype(ref, variants):
    """(alt bases, ref position of each alt base or -1 for inserted bases), as
    synthetic._alt_haplotype makes it."""
    seq, where = [], []
    cur = 0
    for v in variants:
        seq.append(ref[cur : v.pos])
        where.append(np.arange(cur, v.pos))
        alt = np.frombuffer(v.alt.encode(), np.uint8)
        seq.append(alt)
        w = np.full(len(alt), -1)
        w[0] = v.pos
        if len(alt) == len(v.ref):
            w[:] = np.arange(v.pos, v.pos + len(alt))
        where.append(w)
        cur = v.pos + len(v.ref)
    seq.append(ref[cur:])
    where.append(np.arange(cur, len(ref)))
    return np.concatenate(seq).astype(np.uint8), np.concatenate(where).astype(np.int64)


def cigar_of(where):
    """(pos, ops, lens) of a read whose bases sit at ref positions `where`
    (-1 = inserted); leading/trailing insertions become soft clips. As
    synthetic._cigar."""
    ops = []
    prev = None
    for w in where.tolist():
        if w < 0:
            op = OP_S if prev is None else OP_I
        else:
            if prev is not None and w > prev + 1:
                ops.append((OP_D, w - prev - 1))
            op = OP_M
            prev = w
        if ops and ops[-1][0] == op:
            ops[-1] = (op, ops[-1][1] + 1)
        else:
            ops.append((op, 1))
    if ops[-1][0] == OP_I:
        ops[-1] = (OP_S, ops[-1][1])
    mapped = where[where >= 0]
    return (int(mapped[0]), np.array([o for o, _ in ops], np.uint8),
            np.array([n for _, n in ops], np.int32))


def haplotypes(ref, variants):
    """The sample's haplotypes as alt_haplotype makes them: 0 carries the
    homozygous variants, 1 the hets too, and 2 (where there are somatic
    variants) the homozygous and the somatic ones."""
    hom = [v for v in variants if v.kind == "germline" and v.af == 1.0]
    het = [v for v in variants if v.kind == "germline" and v.af != 1.0]
    som = [v for v in variants if v.kind == "somatic"]
    by_pos = lambda vs: sorted(vs, key=lambda v: v.pos)  # noqa: E731
    haps = [alt_haplotype(ref, by_pos(hom)), alt_haplotype(ref, by_pos(hom + het))]
    if som:
        haps.append(alt_haplotype(ref, by_pos(hom + som)))
    return haps


def _fragments(rng, shards, p, flank):
    """(start on the reference, length in haplotype bases) of every fragment:
    the same number starting in each shard, and as dense a run in the flank
    before the first, so that it is covered like the others."""
    L = p["read_len"]
    per_shard = int(round(p["depth"] * p["shard_bp"] / L)) // 2
    most = min(p.get("insert_max", 1000), flank)
    lead = int(round(per_shard * most / p["shard_bp"]))
    starts = [rng.integers(flank - most, flank, lead)]
    starts += [rng.integers(sh.start, sh.end, per_shard) for sh in shards]
    s = np.concatenate(starts).astype(np.int64)
    size = np.rint(rng.normal(p["insert_mean"], p["insert_sd"], len(s))).astype(np.int64)
    return s, np.clip(size, L, most)


def _reads(rng, haps, shards, p, flank):
    """Every read of every fragment: rows 0..n-1 are the left mates (forward),
    rows n..2n-1 the right mates (reverse) of fragments 0..n-1. Returns a dict
    of where (2n, L) ref positions, bases, quals (2n, L), hap and hap_start
    (2n,), and first (n,): whether the left mate is the first of its pair."""
    L = p["read_len"]
    s, size = _fragments(rng, shards, p, flank)
    n = len(s)
    somatic = sorted((v for sh in shards for v in sh.variants if v.kind == "somatic"),
                     key=lambda v: v.pos)
    hap = (rng.random(n) < 0.5).astype(np.int64)  # 0 or 1: a parental haplotype
    if somatic and len(haps) > 2:
        som_pos = np.array([v.pos for v in somatic])
        som_af = np.array([v.af for v in somatic])
        k = np.searchsorted(som_pos, s)
        kk = np.minimum(k, len(som_pos) - 1)
        over = (k < len(som_pos)) & (som_pos[kk] < s + size)
        hap = np.where(over & (rng.random(n) < som_af[kk]), 2, hap)
    where = np.empty((2 * n, L), np.int64)
    bases = np.empty((2 * n, L), np.uint8)
    start = np.empty(2 * n, np.int64)
    offs = np.arange(L)
    for h, (seq, w) in enumerate(haps):
        sel = np.nonzero(hap == h)[0]
        if not len(sel):
            continue
        firsts = np.maximum.accumulate(w)
        a = np.minimum(np.searchsorted(firsts, s[sel]), len(seq) - L)
        b = np.minimum(a + size[sel] - L, len(seq) - L)
        for rows, at in ((sel, a), (sel + n, b)):
            idx = at[:, None] + offs[None, :]
            where[rows] = w[idx]
            bases[rows] = seq[idx]
            start[rows] = at
    # sequencing errors and qualities, read by read
    err = rng.random((2 * n, L)) < p["err_rate"]
    n_err = int(err.sum())
    bases[err] = ACGT[(_CODE[bases[err]].astype(np.int64) + rng.integers(1, 4, n_err)) % 4]
    lo, hi = p["qual_range"]
    quals = rng.integers(lo, hi + 1, (2 * n, L)).astype(np.uint8)
    first = rng.random(n) < 0.5
    return dict(where=where, bases=bases, quals=quals, hap=np.concatenate([hap, hap]),
                hap_start=start, first=first)


def _alignments(where, L):
    """(pos, ref end, cigars {row: (ops, lens)} of reads that are not L
    matches) of every read."""
    simple = (where[:, -1] - where[:, 0] == L - 1) & (where[:, 0] >= 0) & (where[:, -1] >= 0)
    pos = where[:, 0].copy()
    end = pos + L
    cigars = {}
    for i in np.nonzero(~simple)[0].tolist():
        pos[i], ops, lens = cigar_of(where[i])
        cigars[i] = (ops, lens)
        end[i] = pos[i] + int(lens[(ops == OP_M) | (ops == OP_D)].sum())
    return pos, end, cigars


def _pair_fields(pos, end, first, n):
    """SAM flags, mate positions and template lengths of n fragments' reads
    (rows as _reads lays them out): the left mate forward, the right
    reverse, both properly paired; the template length is positive on the
    mate that starts first (the left one where both start together)."""
    left = np.arange(2 * n) < n
    mate = np.concatenate([np.arange(n, 2 * n), np.arange(n)])
    firsts = np.concatenate([first, ~first])
    flag = (1 | 2 | np.where(left, 32, 16) | np.where(firsts, 64, 128)).astype(np.int64)
    span = np.maximum(end, end[mate]) - np.minimum(pos, pos[mate])
    leads = (pos < pos[mate]) | ((pos == pos[mate]) & left)
    return flag, pos[mate], np.where(leads, span, -span), mate


def generate(out_dir, seed, params):
    """Write <out_dir>/ref.fa (+ .fai) and <out_dir>/sample.bam (+ .bai) for
    the merged configuration and traffic `params`; return the Sample with the
    planted truth of each shard and the count of reads starting in it."""
    rng = np.random.default_rng(seed)
    p = dict(params)
    shard_bp, n_shards = p["shard_bp"], p["genome_bp"] // p["shard_bp"]
    flank = p.get("flank", 1000)
    length = n_shards * shard_bp + 2 * flank
    ref = ACGT[rng.integers(0, 4, length)]
    shards = [Shard(i, flank + i * shard_bp, flank + (i + 1) * shard_bp)
              for i in range(n_shards)]
    plant(rng, ref, shards, p)
    variants = [v for sh in shards for v in sh.variants]
    reads = _reads(rng, haplotypes(ref, variants), shards, p, flank)
    L = p["read_len"]
    n = len(reads["first"])
    pos, end, cigars = _alignments(reads["where"], L)
    flag, mate_pos, tlen, mate = _pair_fields(pos, end, reads["first"], n)
    reads["mate"] = mate
    order = np.lexsort((np.arange(len(pos)), pos))
    starts = pos[order]
    edges = np.array([sh.start for sh in shards] + [shards[-1].end])
    counts = np.diff(np.searchsorted(starts, edges))  # [start, end) each
    for sh, c in zip(shards, counts):
        sh.reads = int(c)

    os.makedirs(out_dir, exist_ok=True)
    contig = p.get("contig", "chr20")
    fasta = os.path.join(out_dir, "ref.fa")
    write_fasta(fasta, contig, ref)
    bam = os.path.join(out_dir, "sample.bam")
    inv = np.empty_like(order)
    inv[order] = np.arange(len(order))
    bamio.write_bam(bam, contig, length, p.get("sample", "SAMPLE"), starts,
                    reads["bases"][order], reads["quals"][order], flag[order],
                    {int(inv[i]): c for i, c in cigars.items()}, (order % n), mate_pos[order],
                    tlen[order], mapq=p.get("mapq", 60), level=p.get("bgzf_level", 1))
    del reads["where"]
    return Sample(fasta=fasta, bam=bam, contig=contig, length=length, shards=shards,
                  n_reads=len(pos), variants=variants, ref=ref, reads=reads)


def write_fasta(path, contig, seq, width=60):
    """`seq` (uint8) as a FASTA of one record at `path`, and its .fai."""
    head = f">{contig}\n".encode()
    n = len(seq)
    full = (n // width) * width
    body = np.empty((n // width, width + 1), np.uint8)
    body[:, :width] = seq[:full].reshape(-1, width)
    body[:, width] = ord("\n")
    tail = bytes(seq[full:]) + b"\n" if n > full else b""
    with open(path, "wb") as fh:
        fh.write(head)
        fh.write(body.tobytes())
        fh.write(tail)
    with open(path + ".fai", "w") as fai:
        fai.write(f"{contig}\t{n}\t{len(head)}\t{width}\t{width + 1}\n")
    return path
