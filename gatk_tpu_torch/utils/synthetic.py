"""Synthetic samples for end-to-end runs, written as an indexed FASTA and a
coordinate-sorted BAM with one read group; everything is made from a seed with
numpy.

write_sample: a diploid germline sample for HaplotypeCaller (one contig, a
heterozygous alternate haplotype with planted SNVs and short indels, single-end
reads drawn from both haplotypes).
write_tumor_sample: a tumor-only sample for Mutect2 (the same contig and seed
scheme, germline het SNVs plus somatic SNVs and short indels at allele
fractions 0.1-0.3)."""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from ..io import bam, sam
from ..io.reads import Read

_ACGT = np.frombuffer(b"ACGT", np.uint8)


@dataclass
class Planted:
    """One planted variant, VCF style: 0-based pos, REF and ALT alleles, and the
    fraction of reads over it that carry ALT (0.5 for a germline het)."""

    pos: int
    ref: str
    alt: str
    af: float = 0.5

    @property
    def is_snv(self) -> bool:
        return len(self.ref) == 1 and len(self.alt) == 1


def _plant(rng, ref, n_snv, n_indel, min_gap, margin):
    """Variant list (sorted) at least min_gap apart, margin bp from the ends."""
    n = n_snv + n_indel
    span = len(ref) - 2 * margin
    step = span // n
    if step < min_gap:
        raise ValueError(f"{n} variants {min_gap} bp apart do not fit in {len(ref)} bp")
    jitter = (step - min_gap) // 2  # neighbours stay >= step - 2 * jitter >= min_gap apart
    positions = margin + step * np.arange(n) + rng.integers(-jitter, jitter + 1, n)
    indel_at = set(rng.choice(n, n_indel, replace=False).tolist())
    out = []
    for k, p in enumerate(positions.tolist()):
        r = chr(ref[p])
        if k in indel_at:
            ln = int(rng.integers(1, 4))
            if rng.random() < 0.5:  # deletion of ref[p+1 : p+1+ln]
                out.append(Planted(p, bytes(ref[p : p + 1 + ln]).decode(), r))
            else:  # insertion after ref[p]
                out.append(Planted(p, r, r + bytes(_ACGT[rng.integers(0, 4, ln)]).decode()))
        else:
            alt = _ACGT[(np.searchsorted(_ACGT, ref[p]) + rng.integers(1, 4)) % 4]
            out.append(Planted(p, r, chr(alt)))
    return out


def _alt_haplotype(ref, variants):
    """(alt bases, ref position of each alt base or -1 for inserted bases)."""
    seq, where = [], []
    cur = 0
    for v in variants:
        seq.append(ref[cur : v.pos])
        where.append(np.arange(cur, v.pos))
        alt = np.frombuffer(v.alt.encode(), np.uint8)
        seq.append(alt)
        w = np.full(len(alt), -1)
        w[0] = v.pos  # the anchor / substituted base
        if len(alt) == len(v.ref):
            w[:] = np.arange(v.pos, v.pos + len(alt))
        where.append(w)
        cur = v.pos + len(v.ref)
    seq.append(ref[cur:])
    where.append(np.arange(cur, len(ref)))
    return np.concatenate(seq).astype(np.uint8), np.concatenate(where)


def _cigar(where):
    """(pos, ops, lens) of a read whose bases sit at ref positions `where`
    (-1 = inserted); leading/trailing insertions become soft clips."""
    ops = []
    prev = None
    for w in where.tolist():
        if w < 0:
            op = sam.OP_S if prev is None else sam.OP_I
        else:
            if prev is not None and w > prev + 1:
                ops.append((sam.OP_D, w - prev - 1))
            op = sam.OP_M
            prev = w
        if ops and ops[-1][0] == op:
            ops[-1] = (op, ops[-1][1] + 1)
        else:
            ops.append((op, 1))
    if ops[-1][0] == sam.OP_I:
        ops[-1] = (sam.OP_S, ops[-1][1])
    mapped = where[where >= 0]
    return (int(mapped[0]), np.array([o for o, _ in ops], np.uint8),
            np.array([n for _, n in ops], np.int32))


def _write_fasta(out_dir, contig, ref):
    fasta = os.path.join(out_dir, "ref.fa")
    width = 60
    with open(fasta, "wb") as fh:
        head = f">{contig}\n".encode()
        fh.write(head)
        for k in range(0, len(ref), width):
            fh.write(bytes(ref[k : k + width]) + b"\n")
    with open(fasta + ".fai", "w") as fh:
        fh.write(f"{contig}\t{len(ref)}\t{len(head)}\t{width}\t{width + 1}\n")
    return fasta


def _make_read(rng, k, bases, where, err_rate, qual_range):
    """Read k over `bases` (ref positions `where`): sequencing errors at
    err_rate, uniform qualities, a random strand."""
    bases = bases.copy()
    err = rng.random(len(bases)) < err_rate
    if err.any():
        idx = np.searchsorted(_ACGT, bases[err])
        bases[err] = _ACGT[(idx + rng.integers(1, 4, int(err.sum()))) % 4]
    lo, hi = qual_range
    quals = rng.integers(lo, hi + 1, len(bases)).astype(np.uint8)
    pos, ops, lens = _cigar(where)
    return Read(name=f"r{k:06d}", flag=16 if rng.random() < 0.5 else 0, ref_id=0, pos=pos,
                mapq=60, cigar_ops=ops, cigar_lens=lens, bases=bases, quals=quals,
                mate_ref_id=-1, mate_pos=-1, tlen=0, tags={"RG": "rg1"})


def _write_bam(path, contig, length, reads, sample):
    reads.sort(key=lambda r: (r.pos, r.name))
    text = (f"@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:{contig}\tLN:{length}\n"
            f"@RG\tID:rg1\tSM:{sample}\n")
    writer = bam.BamWriter(path, sam.SamHeader.parse(text))
    for r in reads:
        writer.write(r)
    writer.close()


def write_sample(out_dir, seed=0, contig="chrM", length=16569, n_reads=20000, read_len=151,
                 n_snv=24, n_indel=6, min_gap=400, err_rate=0.005, qual_range=(20, 40),
                 sample="SYN1"):
    """Write <out_dir>/ref.fa (+ .fai) and <out_dir>/sample.bam.

    Returns dict(fasta=path, bam=path, contig=contig, length=length,
    variants=[Planted], n_reads=n_reads)."""
    rng = np.random.default_rng(seed)
    ref = _ACGT[rng.integers(0, 4, length)]
    variants = _plant(rng, ref, n_snv, n_indel, min_gap, margin=300)
    alt, alt_where = _alt_haplotype(ref, variants)

    os.makedirs(out_dir, exist_ok=True)
    fasta = _write_fasta(out_dir, contig, ref)
    reads = []
    for k in range(n_reads):
        from_alt = bool(rng.random() < 0.5)
        src, where = (alt, alt_where) if from_alt else (ref, np.arange(length))
        s = int(rng.integers(0, len(src) - read_len + 1))
        reads.append(_make_read(rng, k, src[s : s + read_len], where[s : s + read_len],
                                err_rate, qual_range))
    path = os.path.join(out_dir, "sample.bam")
    _write_bam(path, contig, length, reads, sample)
    return dict(fasta=fasta, bam=path, contig=contig, length=length, variants=variants,
                n_reads=n_reads)


def write_tumor_sample(out_dir, seed=0, contig="chrM", length=16569, n_reads=20000,
                       read_len=151, n_germline=8, n_somatic_snv=12, n_somatic_indel=4,
                       af_range=(0.1, 0.3), min_gap=400, err_rate=0.005, qual_range=(20, 40),
                       sample="TUMOR"):
    """Write <out_dir>/ref.fa (+ .fai) and <out_dir>/tumor.bam: a tumor-only sample.

    Germline het SNVs sit on one parental haplotype (af 0.5); somatic SNVs and
    1-3 bp indels (af uniform in af_range) sit on a somatic haplotype. All
    variants are planted at least min_gap apart, so a read (shorter than
    min_gap) covers at most one: a read over somatic variant v comes from the
    somatic haplotype with probability v.af, and otherwise, like every other
    read, from either parent with probability 0.5.

    Returns dict(fasta=path, bam=path, contig=contig, length=length,
    germline=[Planted], somatic=[Planted], n_reads=n_reads)."""
    rng = np.random.default_rng(seed)
    ref = _ACGT[rng.integers(0, 4, length)]
    planted = _plant(rng, ref, n_germline + n_somatic_snv, n_somatic_indel, min_gap, margin=300)
    snv_at = [k for k, v in enumerate(planted) if v.is_snv]
    germ_at = set(rng.choice(snv_at, n_germline, replace=False).tolist())
    germline = [v for k, v in enumerate(planted) if k in germ_at]
    somatic = [Planted(v.pos, v.ref, v.alt, float(rng.uniform(*af_range)))
               for k, v in enumerate(planted) if k not in germ_at]
    ident = (ref, np.arange(length))
    haps = [ident, _alt_haplotype(ref, germline), _alt_haplotype(ref, somatic)]
    # first index of each haplotype at or after a ref position (inserted bases
    # carry -1 and take their left neighbour's position)
    firsts = [np.maximum.accumulate(w) for _, w in haps]
    som_pos = np.array([v.pos for v in somatic])

    os.makedirs(out_dir, exist_ok=True)
    fasta = _write_fasta(out_dir, contig, ref)
    reads = []
    for k in range(n_reads):
        s = int(rng.integers(0, length - read_len + 1))
        over = np.nonzero((som_pos >= s) & (som_pos < s + read_len))[0]
        if len(over) and rng.random() < somatic[over[0]].af:
            h = 2
        else:
            h = int(rng.random() < 0.5)
        src, where = haps[h]
        a = min(int(np.searchsorted(firsts[h], s)), len(src) - read_len)
        reads.append(_make_read(rng, k, src[a : a + read_len], where[a : a + read_len],
                                err_rate, qual_range))
    path = os.path.join(out_dir, "tumor.bam")
    _write_bam(path, contig, length, reads, sample)
    return dict(fasta=fasta, bam=path, contig=contig, length=length, germline=germline,
                somatic=somatic, n_reads=n_reads)
