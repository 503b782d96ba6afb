"""A synthetic diploid sample for end-to-end HaplotypeCaller runs: one contig, a
heterozygous alternate haplotype with planted SNVs and short indels, and
single-end reads drawn from both haplotypes, written as an indexed FASTA and a
coordinate-sorted BAM. Everything is made from a seed with numpy."""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from ..io import bam, sam
from ..io.reads import Read

_ACGT = np.frombuffer(b"ACGT", np.uint8)


@dataclass
class Planted:
    """One planted het variant, VCF style: 0-based pos, REF and ALT alleles."""

    pos: int
    ref: str
    alt: str

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
    fasta = os.path.join(out_dir, "ref.fa")
    width = 60
    with open(fasta, "wb") as fh:
        head = f">{contig}\n".encode()
        fh.write(head)
        for k in range(0, length, width):
            fh.write(bytes(ref[k : k + width]) + b"\n")
    with open(fasta + ".fai", "w") as fh:
        fh.write(f"{contig}\t{length}\t{len(head)}\t{width}\t{width + 1}\n")

    lo, hi = qual_range
    reads = []
    for k in range(n_reads):
        from_alt = bool(rng.random() < 0.5)
        src, where = (alt, alt_where) if from_alt else (ref, np.arange(length))
        s = int(rng.integers(0, len(src) - read_len + 1))
        bases = src[s : s + read_len].copy()
        err = rng.random(read_len) < err_rate
        if err.any():
            idx = np.searchsorted(_ACGT, bases[err])
            bases[err] = _ACGT[(idx + rng.integers(1, 4, int(err.sum()))) % 4]
        quals = rng.integers(lo, hi + 1, read_len).astype(np.uint8)
        pos, ops, lens = _cigar(where[s : s + read_len])
        reads.append(Read(
            name=f"r{k:06d}", flag=16 if rng.random() < 0.5 else 0, ref_id=0, pos=pos,
            mapq=60, cigar_ops=ops, cigar_lens=lens, bases=bases, quals=quals,
            mate_ref_id=-1, mate_pos=-1, tlen=0, tags={"RG": "rg1"}))
    reads.sort(key=lambda r: (r.pos, r.name))

    text = (f"@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:{contig}\tLN:{length}\n"
            f"@RG\tID:rg1\tSM:{sample}\n")
    path = os.path.join(out_dir, "sample.bam")
    writer = bam.BamWriter(path, sam.SamHeader.parse(text))
    for r in reads:
        writer.write(r)
    writer.close()
    return dict(fasta=fasta, bam=path, contig=contig, length=length, variants=variants,
                n_reads=n_reads)
