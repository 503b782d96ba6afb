"""Synthetic samples for end-to-end runs, written as an indexed FASTA and a
coordinate-sorted BAM with one read group; everything is made from a seed with
numpy.

write_sample: a diploid germline sample for HaplotypeCaller (one contig, a
heterozygous alternate haplotype with planted SNVs and short indels, single-end
reads drawn from both haplotypes), its planted variants as a known-sites VCF,
and optionally planted duplicate reads (for MarkDuplicates and BQSR).
write_trio: a mother, a father and their child over one reference, with
Mendelian genotypes at the planted sites, and a pedigree file.
write_tumor_sample: a tumor-only sample for Mutect2 (the same contig and seed
scheme, germline het SNVs plus somatic SNVs and short indels at allele
fractions 0.1-0.3), and optionally its matched normal.
write_cnv_cohort: a germline CNV cohort as read-count TSVs (CollectReadCounts'
format) and contig-ploidy priors, with XX and XY samples and planted
deletions and duplications.
write_somatic_cnv_case: a panel of normals and a tumor case as read-count TSVs,
and the case's allelic counts at het sites (CollectAllelicCounts' format), with
planted copy-ratio segments and minor-allele fractions."""
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


def _write_fasta_records(fasta, records, width=60):
    """Write the (name, bases) records as a FASTA at `fasta` and its .fai."""
    offset = 0
    with open(fasta, "wb") as fh, open(fasta + ".fai", "w") as fai:
        for name, seq in records:
            head = f">{name}\n".encode()
            fh.write(head)
            fai.write(f"{name}\t{len(seq)}\t{offset + len(head)}\t{width}\t{width + 1}\n")
            body = b"".join(bytes(seq[k : k + width]) + b"\n" for k in range(0, len(seq), width))
            fh.write(body)
            offset += len(head) + len(body)
    return fasta


def _write_fasta(out_dir, contig, ref):
    return _write_fasta_records(os.path.join(out_dir, "ref.fa"), [(contig, ref)])


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


def _write_sites_vcf(path, contig, length, variants):
    """The planted variants as a sites-only VCF (a --known-sites resource)."""
    with open(path, "w") as fh:
        fh.write(f"##fileformat=VCFv4.2\n##contig=<ID={contig},length={length}>\n"
                 "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        for v in variants:
            fh.write(f"{contig}\t{v.pos + 1}\t.\t{v.ref}\t{v.alt}\t.\tPASS\t.\n")
    return path


def _duplicate(read, name):
    """A duplicate of `read`: the same start, strand, cigar and bases, each
    base quality 5 lower (so a lower sum of qualities >= 15 than the original's)."""
    quals = np.maximum(read.quals.astype(np.int16) - 5, 2).astype(np.uint8)
    return Read(name=name, flag=read.flag, ref_id=read.ref_id, pos=read.pos, mapq=read.mapq,
                cigar_ops=read.cigar_ops.copy(), cigar_lens=read.cigar_lens.copy(),
                bases=read.bases.copy(), quals=quals, mate_ref_id=-1, mate_pos=-1, tlen=0,
                tags=dict(read.tags))


def write_sample(out_dir, seed=0, contig="chrM", length=16569, n_reads=20000, read_len=151,
                 n_snv=24, n_indel=6, min_gap=400, err_rate=0.005, qual_range=(20, 40),
                 sample="SYN1", n_duplicates=0):
    """Write <out_dir>/ref.fa (+ .fai), <out_dir>/sample.bam and
    <out_dir>/known_sites.vcf (the planted variants, sites only).

    With n_duplicates > 0, that many distinct reads are drawn after the others
    and each gets a duplicate (named d<k>) as _duplicate makes it, so
    MarkDuplicates flags every duplicate; the reads drawn before are the same
    as with n_duplicates = 0.

    Returns dict(fasta=path, bam=path, known_sites=path, contig=contig,
    length=length, variants=[Planted], n_reads=reads written,
    duplicates=[names of the planted duplicates])."""
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
    if n_duplicates:
        picked = rng.choice(n_reads, n_duplicates, replace=False)
        reads += [_duplicate(reads[int(i)], f"d{k:06d}") for k, i in enumerate(picked)]
    path = os.path.join(out_dir, "sample.bam")
    duplicates = [r.name for r in reads[n_reads:]]
    _write_bam(path, contig, length, reads, sample)
    known = _write_sites_vcf(os.path.join(out_dir, "known_sites.vcf"), contig, length, variants)
    return dict(fasta=fasta, bam=path, known_sites=known, contig=contig, length=length,
                variants=variants, n_reads=len(reads), duplicates=duplicates)


# which parental haplotypes carry the alt allele at a planted trio site:
# (mother's transmitted, mother's other, father's transmitted, father's
# other); the child carries the two transmitted ones. Every pattern has a het
# parent; the child is hom-alt, hom-ref, het, hom-ref, het, het, hom-ref, so
# any three sites in a row hold each of its genotypes.
TRIO_PATTERNS = ((1, 0, 1, 0), (0, 1, 0, 0), (1, 0, 0, 0), (0, 1, 0, 1), (1, 0, 0, 1),
                 (0, 0, 1, 0), (0, 0, 0, 1))
TRIO_SAMPLES = ("MOTHER", "FATHER", "CHILD")


def write_trio(out_dir, seed=0, contig="chrM", length=16569, n_reads=20000, read_len=151,
               n_snv=24, n_indel=6, min_gap=400, err_rate=0.005, qual_range=(20, 40)):
    """Write <out_dir>/ref.fa (+ .fai), one BAM a sample (<sample>.bam, SM
    MOTHER, FATHER and CHILD, n_reads each) and <out_dir>/trio.ped.

    The planted SNVs and indels (as write_sample plants them) sit on the
    parents' haplotypes by TRIO_PATTERNS, taken in turn;
    the child carries one haplotype of each parent, so its genotype follows
    Mendel's rules at every site, and is hom-alt at some and hom-ref at others.
    Each sample's reads come from its two haplotypes with probability 0.5.

    Returns dict(fasta=path, bams={sample: path}, ped=path, contig=contig,
    length=length, variants=[Planted], genotypes={sample: ["0/1", ...] per
    variant}, n_reads=n_reads)."""
    rng = np.random.default_rng(seed)
    ref = _ACGT[rng.integers(0, 4, length)]
    variants = _plant(rng, ref, n_snv, n_indel, min_gap, margin=300)
    carry = np.array([TRIO_PATTERNS[k % len(TRIO_PATTERNS)]
                      for k in range(len(variants))])  # (variants, 4 haplotypes)
    haps = [_alt_haplotype(ref, [v for v, c in zip(variants, carry[:, h]) if c])
            for h in range(4)]
    of_sample = {"MOTHER": (0, 1), "FATHER": (2, 3), "CHILD": (0, 2)}
    gt = {0: "0/0", 1: "0/1", 2: "1/1"}
    genotypes = {sm: [gt[int(carry[k, a] + carry[k, b])] for k in range(len(variants))]
                 for sm, (a, b) in of_sample.items()}

    os.makedirs(out_dir, exist_ok=True)
    fasta = _write_fasta(out_dir, contig, ref)
    bams = {}
    for sm in TRIO_SAMPLES:
        reads = []
        for k in range(n_reads):
            src, where = haps[of_sample[sm][int(rng.random() < 0.5)]]
            s = int(rng.integers(0, len(src) - read_len + 1))
            reads.append(_make_read(rng, k, src[s : s + read_len], where[s : s + read_len],
                                    err_rate, qual_range))
        bams[sm] = os.path.join(out_dir, f"{sm.lower()}.bam")
        _write_bam(bams[sm], contig, length, reads, sm)
    ped = os.path.join(out_dir, "trio.ped")
    with open(ped, "w") as fh:
        fh.write("FAM\tFATHER\t0\t0\t1\t0\nFAM\tMOTHER\t0\t0\t2\t0\n"
                 "FAM\tCHILD\tFATHER\tMOTHER\t1\t0\n")
    return dict(fasta=fasta, bams=bams, ped=ped, contig=contig, length=length,
                variants=variants, genotypes=genotypes, n_reads=n_reads)


def write_tumor_sample(out_dir, seed=0, contig="chrM", length=16569, n_reads=20000,
                       read_len=151, n_germline=8, n_somatic_snv=12, n_somatic_indel=4,
                       af_range=(0.1, 0.3), min_gap=400, err_rate=0.005, qual_range=(20, 40),
                       sample="TUMOR", n_normal_reads=0):
    """Write <out_dir>/ref.fa (+ .fai) and <out_dir>/tumor.bam: a tumor-only
    sample; with n_normal_reads > 0 also <out_dir>/normal.bam (SM NORMAL), a
    matched normal of that many reads drawn after the tumor's from the two
    parental haplotypes (the germline hets, no somatic variant), so the
    tumor's reads are the same as without it.

    Germline het SNVs sit on one parental haplotype (af 0.5); somatic SNVs and
    1-3 bp indels (af uniform in af_range) sit on a somatic haplotype. All
    variants are planted at least min_gap apart, so a read (shorter than
    min_gap) covers at most one: a read over somatic variant v comes from the
    somatic haplotype with probability v.af, and otherwise, like every other
    read, from either parent with probability 0.5.

    Returns dict(fasta=path, bam=path, contig=contig, length=length,
    germline=[Planted], somatic=[Planted], n_reads=n_reads), and
    normal_bam=path with a matched normal."""
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
    out = dict(fasta=fasta, bam=path, contig=contig, length=length, germline=germline,
               somatic=somatic, n_reads=n_reads)
    if n_normal_reads:
        normal = []
        for k in range(n_normal_reads):
            src, where = haps[int(rng.random() < 0.5)]
            s = int(rng.integers(0, len(src) - read_len + 1))
            normal.append(_make_read(rng, k, src[s : s + read_len], where[s : s + read_len],
                                     err_rate, qual_range))
        out["normal_bam"] = os.path.join(out_dir, "normal.bam")
        _write_bam(out["normal_bam"], contig, length, normal, "NORMAL")
    return out


# ---------------------------------------------------------------------------
# Copy-number inputs
# ---------------------------------------------------------------------------

# (contig, share of the intervals, ploidy priors over 0..3): three autosomes,
# X and Y, as in gcnvkernel's contig-ploidy prior tables
_CNV_CONTIGS = (("1", 0.35, (0.01, 0.01, 0.97, 0.01)), ("2", 0.30, (0.01, 0.01, 0.97, 0.01)),
                ("3", 0.20, (0.01, 0.01, 0.97, 0.01)), ("X", 0.10, (0.01, 0.49, 0.49, 0.01)),
                ("Y", 0.05, (0.50, 0.50, 0.0, 0.0)))
MAPPING_ERROR_RATE = 0.01  # reads a copy-number-0 interval still gets, per copy of depth
BIN = 1000  # interval length (bp) of the CNV inputs: GATK's whole-genome bin


def _contig_layout(n_intervals, contigs):
    """[(contig, first, last)] interval index ranges, and (contig, start, end)
    1-based bins of BIN bp per contig."""
    sizes = [max(1, int(round(n_intervals * share))) for _, share, _ in contigs]
    sizes[0] += n_intervals - sum(sizes)
    ranges, intervals, first = [], [], 0
    for (name, _, _), n in zip(contigs, sizes):
        ranges.append((name, first, first + n - 1))
        intervals += [(name, 1 + BIN * k, BIN * (k + 1)) for k in range(n)]
        first += n
    return ranges, intervals


def _negbin(rng, mean, alpha):
    """NegBin draws of mean `mean` and inverse dispersion alpha (Gamma-Poisson)."""
    return rng.poisson(rng.gamma(alpha, mean / alpha))


def _write_counts_tsv(path, sample, intervals, counts, sq):
    with open(path, "w") as fh:
        fh.write("".join(f"@SQ\tSN:{c}\tLN:{n}\n" for c, n in sq))
        fh.write(f"@RG\tID:GATKCopyNumber\tSM:{sample}\nCONTIG\tSTART\tEND\tCOUNT\n")
        fh.write("".join(f"{c}\t{s}\t{e}\t{n}\n" for (c, s, e), n in zip(intervals, counts)))


def _place_events(rng, n_events, n_rows, free_ranges, length_range):
    """n_events non-overlapping (row, first, last) spans, each inside one of
    free_ranges [(first, last)] of one row, lengths drawn from length_range."""
    taken = [[] for _ in range(n_rows)]
    events = []
    while len(events) < n_events:
        row = int(rng.integers(0, n_rows))
        lo, hi = free_ranges[int(rng.integers(0, len(free_ranges)))]
        ln = int(rng.integers(length_range[0], length_range[1] + 1))
        if hi - lo + 1 <= ln + 4:
            continue
        a = int(rng.integers(lo + 2, hi - ln - 1))
        b = a + ln - 1
        if any(a <= e + 2 and s <= b + 2 for s, e in taken[row]):
            continue
        taken[row].append((a, b))
        events.append((row, a, b))
    return events


def write_cnv_cohort(out_dir, seed=0, n_samples=32, n_intervals=10000, n_events=40,
                     event_len=(10, 100), factor_sd=0.3, bias_rank=5):
    """Write a germline CNV cohort: <out_dir>/SAMPLE_<k>.counts.tsv for each
    sample and <out_dir>/contig_ploidy_priors.tsv.

    Intervals are 1 kb bins over three autosomes, X and Y (35, 30, 20, 10 and
    5 % of them). Samples alternate XX and XY. A sample's count at interval t
    is NegBin(d_s * exp(b_t + z_s . W_t) * (cn + 0.01)) with inverse dispersion
    100: d_s its per-copy depth (50-150), b_t a lognormal per-interval bias (sd
    0.3), z_s . W_t a sample x interval bias of rank bias_rank (z ~ N(0, 1),
    W ~ N(0, factor_sd)) and 0.01 the mapping-error leak that a copy-number-0 interval
    keeps. Deletions to CN 0 or 1 and duplications to CN 3 or 4, event_len
    intervals long, are planted on the autosomes.

    The bias has by default the rank of the denoising model's bias factors
    (DenoisingConfig.max_bias_factors, 5): with fewer true factors than the
    model's, gatk_tpu's model spends the spare ones during its warm-up rounds
    on whole samples' events and then calls them at baseline
    (tests/test_torch_cnv.py::test_gate_with_five_bias_factors shows both).

    Returns dict(counts=[paths], ploidy_priors=path, samples, intervals,
    contig_ranges=[(contig, first, last)], ploidy={sample: {contig: ploidy}},
    cn=(S, T) planted copy numbers, baseline=(S, T) ploidies,
    events=[(sample index, first, last, cn)])."""
    rng = np.random.default_rng(seed)
    ranges, intervals = _contig_layout(n_intervals, _CNV_CONTIGS)
    samples = [f"SAMPLE_{k:03d}" for k in range(n_samples)]
    ploidy, baseline = {}, np.zeros((n_samples, n_intervals), int)
    for si, s in enumerate(samples):
        xy = si % 2 == 1
        ploidy[s] = {"1": 2, "2": 2, "3": 2, "X": 1 if xy else 2, "Y": 1 if xy else 0}
        for name, a, b in ranges:
            baseline[si, a : b + 1] = ploidy[s][name]
    cn = baseline.copy()
    autosomes = [(a, b) for name, a, b in ranges if name in ("1", "2", "3")]
    events = []
    for si, a, b in _place_events(rng, n_events, n_samples, autosomes, event_len):
        c = int(rng.choice([0, 1, 3, 4]))
        cn[si, a : b + 1] = c
        events.append((si, a, b, c))
    depth = rng.uniform(50.0, 150.0, n_samples)
    bias = (rng.normal(0.0, 0.3, n_intervals)[None, :]
            + rng.normal(0.0, 1.0, (n_samples, bias_rank))
            @ rng.normal(0.0, factor_sd, (bias_rank, n_intervals)))
    mean = depth[:, None] * np.exp(bias) * (cn + MAPPING_ERROR_RATE)
    counts = _negbin(rng, mean, 100.0)

    os.makedirs(out_dir, exist_ok=True)
    sq = [(name, BIN * (b - a + 1)) for name, a, b in ranges]
    paths = []
    for si, s in enumerate(samples):
        paths.append(os.path.join(out_dir, f"{s}.counts.tsv"))
        _write_counts_tsv(paths[-1], s, intervals, counts[si], sq)
    priors = os.path.join(out_dir, "contig_ploidy_priors.tsv")
    with open(priors, "w") as fh:
        fh.write("CONTIG_NAME\tPLOIDY_PRIOR_0\tPLOIDY_PRIOR_1\tPLOIDY_PRIOR_2\tPLOIDY_PRIOR_3\n")
        fh.write("".join(f"{name}\t" + "\t".join(str(p) for p in pr) + "\n"
                         for name, _, pr in _CNV_CONTIGS))
    return dict(counts=paths, ploidy_priors=priors, samples=samples, intervals=intervals,
                contig_ranges=ranges, ploidy=ploidy, cn=cn, baseline=baseline, events=events)


def cnv_call_concordance(cohort, called_cn):
    """Shares of the planted truth that (S, T) called copy numbers recover:
    (share of planted event intervals called at their planted CN, share of
    all other intervals called at their baseline ploidy)."""
    called_cn = np.asarray(called_cn)
    in_event = cohort["cn"] != cohort["baseline"]
    hit = called_cn == cohort["cn"]
    return float(hit[in_event].mean()), float(hit[~in_event].mean())


# log2 copy ratio and minor-allele fraction of each planted somatic state
_SOMATIC_STATES = {1: (-1.0, None), 2: (0.0, 0.5), 3: (float(np.log2(1.5)), 1.0 / 3.0),
                   4: (1.0, 0.25)}


def write_somatic_cnv_case(out_dir, seed=0, n_normals=40, n_intervals=50000, n_contigs=50,
                           n_event_contigs=7, n_hets=10000):
    """Write a panel of normals and a tumor case: <out_dir>/NORMAL_<k>.counts.tsv,
    <out_dir>/case.counts.tsv and <out_dir>/case.allelic_counts.tsv.

    The intervals are 1 kb bins over n_contigs contigs "1", "2", ... of equal
    size. Every sample's count at interval t is
    Poisson(200 * g_t * exp(u_s . F_t) * r_t) with g_t a lognormal
    per-interval bias, u_s . F_t five latent batch factors (what the panel's
    SVD has to learn) and r_t the copy ratio: 1 in the normals, in the
    case cn / 2 of its planted segment. The first n_event_contigs contigs of
    the case each hold three segments, copy-neutral (CN 2), altered (15-35 % of
    the contig, at CN 1, 3 or 4, as many contigs lost as gained) and
    copy-neutral again; the other contigs are copy-neutral, so the case's
    median stays at copy-neutral. Het sites (n_hets, one per interval at most,
    about 100 reads each) carry the minor allele on either haplotype at
    the segment's minor-allele fraction (1/2 at CN 2, 1/3 at CN 3, 1/4 at CN 4);
    a CN 1 segment has lost one haplotype, so its sites read as homozygous.

    Returns dict(normals=[paths], case=path, allelic_counts=path,
    normal_counts=(N, T), case_counts=(T,), intervals, sq=[(contig, length)],
    event_contigs=[names], segments=[(first, last, cn, log2_cr, maf or None)],
    het_index=(n_hets,))."""
    rng = np.random.default_rng(seed)
    ranges, intervals = _contig_layout(
        n_intervals, [(str(k + 1), 1.0 / n_contigs, None) for k in range(n_contigs)])
    altered = [1 if k % 2 == 0 else int(rng.choice([3, 4])) for k in range(n_event_contigs)]
    segments = []
    for k, (_, first, last) in enumerate(ranges):
        if k >= n_event_contigs:
            segments.append((first, last, 2) + _SOMATIC_STATES[2])
            continue
        n = last - first + 1
        ln = int(n * rng.uniform(0.15, 0.35))
        a = first + int(rng.integers(n // 10, n - ln - n // 10))
        for lo, hi, cn in ((first, a - 1, 2), (a, a + ln - 1, altered[k]), (a + ln, last, 2)):
            segments.append((lo, hi, cn) + _SOMATIC_STATES[cn])
    ratio = np.ones(n_intervals)
    for a, b, cn, _, _ in segments:
        ratio[a : b + 1] = cn / 2.0

    bias = np.exp(rng.normal(0.0, 0.3, n_intervals))
    factors = rng.normal(0.0, 0.15, (5, n_intervals))

    def sample_counts(r):
        return rng.poisson(200.0 * bias * np.exp(rng.normal(0.0, 1.0, 5) @ factors) * r)

    normals = np.stack([sample_counts(np.ones(n_intervals)) for _ in range(n_normals)])
    case = sample_counts(ratio)

    os.makedirs(out_dir, exist_ok=True)
    sq = [(name, BIN * (b - a + 1)) for name, a, b in ranges]
    normal_paths = []
    for k in range(n_normals):
        normal_paths.append(os.path.join(out_dir, f"NORMAL_{k:03d}.counts.tsv"))
        _write_counts_tsv(normal_paths[-1], f"NORMAL_{k:03d}", intervals, normals[k], sq)
    case_path = os.path.join(out_dir, "case.counts.tsv")
    _write_counts_tsv(case_path, "CASE", intervals, case, sq)

    het_index = np.sort(rng.choice(n_intervals, n_hets, replace=False))
    seg_of = np.searchsorted([a for a, *_ in segments], het_index, side="right") - 1
    rows = []
    for t, k in zip(het_index.tolist(), seg_of.tolist()):
        maf = segments[k][4]
        n = int(rng.poisson(100))
        if maf is None:  # one haplotype lost: every read carries the other one
            alt = n if rng.random() < 0.5 else 0
        else:
            alt = int(rng.binomial(n, maf if rng.random() < 0.5 else 1.0 - maf))
        c, s, e = intervals[t]
        ref_base, alt_base = _ACGT[rng.permutation(4)[:2]]
        rows.append(f"{c}\t{s + (e - s) // 2}\t{n - alt}\t{alt}\t"
                    f"{chr(ref_base)}\t{chr(alt_base)}\n")
    allelic = os.path.join(out_dir, "case.allelic_counts.tsv")
    with open(allelic, "w") as fh:
        fh.write("@HD\tVN:1.6\n" + "".join(f"@SQ\tSN:{c}\tLN:{n}\n" for c, n in sq))
        fh.write("@RG\tID:GATKCopyNumber\tSM:CASE\n")
        fh.write("CONTIG\tPOSITION\tREF_COUNT\tALT_COUNT\tREF_NUCLEOTIDE\tALT_NUCLEOTIDE\n")
        fh.write("".join(rows))
    return dict(normals=normal_paths, case=case_path, allelic_counts=allelic,
                normal_counts=normals, case_counts=case, intervals=intervals, sq=sq,
                event_contigs=[name for name, _, _ in ranges[:n_event_contigs]],
                segments=segments, het_index=het_index)


BREAKPOINT_TOLERANCE = 3  # intervals between a planted breakpoint and a found one
MIN_SEGMENT_POINTS = 10  # points of a kind a segment needs for its median to be scored


def score_somatic_segments(case, model_rows):
    """ModelSegments' segments (the rows of its .modelFinal.seg, as strings)
    against write_somatic_cnv_case's planted truth: the planted breakpoints
    (a segment's first interval, inside a contig) that no modelled segment
    starts within BREAKPOINT_TOLERANCE intervals of, and the largest distance
    of a posterior median (log2 copy ratio; minor-allele fraction) from the
    planted value of the segment it overlaps most, over the modelled segments
    that hold at least MIN_SEGMENT_POINTS points of that kind, with the
    segment that sets each (log2_cr_worst, maf_worst)."""
    import bisect

    starts, first = {}, {}
    for k, (c, s, _) in enumerate(case["intervals"]):
        starts.setdefault(c, []).append(s)
        first.setdefault(c, k)

    def index(contig, pos):
        return first[contig] + max(bisect.bisect_right(starts[contig], pos) - 1, 0)

    planted = case["segments"]
    contig_of = [case["intervals"][a][0] for a, *_ in planted]
    breakpoints = [a for k, (a, *_) in enumerate(planted)
                   if k and contig_of[k] == contig_of[k - 1]]
    spans = [(index(r[0], int(r[1])), index(r[0], int(r[2])), r) for r in model_rows]
    found = sorted(i0 for i0, _, _ in spans)
    missed = [b for b in breakpoints
              if not found or min(abs(f - b) for f in found) > BREAKPOINT_TOLERANCE]
    cr_err, maf_err, cr_worst, maf_worst = 0.0, 0.0, None, None
    for i0, i1, r in spans:
        overlap = [max(0, min(i1, b) - max(i0, a) + 1) for a, b, *_ in planted]
        _, _, cn, log2_cr, maf = planted[int(np.argmax(overlap))]
        where = dict(contig=r[0], start=int(r[1]), end=int(r[2]), planted_cn=cn)
        if int(r[3]) >= MIN_SEGMENT_POINTS and abs(float(r[6]) - log2_cr) > cr_err:
            cr_err = abs(float(r[6]) - log2_cr)
            cr_worst = dict(where, points=int(r[3]), median=float(r[6]), planted=log2_cr)
        if int(r[4]) >= MIN_SEGMENT_POINTS and maf is not None and abs(float(r[9]) - maf) > maf_err:
            maf_err = abs(float(r[9]) - maf)
            maf_worst = dict(where, points=int(r[4]), median=float(r[9]), planted=maf)
    return dict(breakpoints=len(breakpoints), breakpoints_missed=missed, segments=len(model_rows),
                log2_cr_max_err=cr_err, maf_max_err=maf_err, log2_cr_worst=cr_worst,
                maf_worst=maf_worst)


# ---------------------------------------------------------------------------
# Flow-space reads and a scored callset
# ---------------------------------------------------------------------------

FLOW_ORDER = "TGCA"
HMER_ERROR_PER_BASE = 0.003  # chance a homopolymer is read one base longer (or shorter), per base
HMER_ERROR_MAX = 0.05
T0_QUAL = 22  # t0 tag: a zero flow read as a 1-mer with probability 10^-2.2


def _hmer_plant(ref, p, span=60):
    """A 1-base change of the length of the first homopolymer of >= 3 bases that
    starts in ref[p : p + span] (None if there is none): the run's base deleted
    or added after the anchor base before the run."""
    for s in range(max(p, 1), min(p + span, len(ref) - 8)):
        if ref[s] != ref[s - 1] and ref[s + 1] == ref[s] and ref[s + 2] == ref[s]:
            return s
    return None


def _flow_read(rng, k, bases, where):
    """Read k over `bases` (ref positions `where`) through the hmer-error
    model: each homopolymer of length L is read one base shorter (L > 1) or
    longer, each with probability p = min(HMER_ERROR_MAX, HMER_ERROR_PER_BASE
    L). Its tags are those an Ultima read carries: tp (int8 a base) gives the
    first base of every run the hypothesis -1 and the last base of a run of
    two or more (the only base of a 1-mer) +1, each with quality
    -10 log10 p; the other bases have tp 0 and quality 40; t0 (FASTQ text)
    gives every base T0_QUAL."""
    out_b, out_w, tp, quals = [], [], [], []
    s = 0
    while s < len(bases):
        e = s + 1
        while e < len(bases) and bases[e] == bases[s]:
            e += 1
        run_w = list(where[s:e])
        p = min(HMER_ERROR_MAX, HMER_ERROR_PER_BASE * (e - s))
        u = rng.random()
        if u < p and len(run_w) > 1:
            run_w.pop()
        elif u < 2 * p:
            run_w.append(-1)
        q = int(round(-10 * np.log10(p)))
        n = len(run_w)
        r_tp = np.zeros(n, np.int8)
        r_q = np.full(n, 40, np.uint8)
        if n > 1:
            r_tp[0], r_q[0] = -1, q
        r_tp[-1], r_q[-1] = 1, q
        out_b.append(np.full(n, bases[s], np.uint8))
        out_w.append(np.array(run_w))
        tp.append(r_tp)
        quals.append(r_q)
        s = e
    bases, where = np.concatenate(out_b), np.concatenate(out_w)
    pos, ops, lens = _cigar(where)
    tags = {"RG": "rg1", "tp": np.concatenate(tp), "t0": chr(33 + T0_QUAL) * len(bases)}
    return Read(name=f"f{k:06d}", flag=16 if rng.random() < 0.5 else 0, ref_id=0, pos=pos,
                mapq=60, cigar_ops=ops, cigar_lens=lens, bases=bases,
                quals=np.concatenate(quals), mate_ref_id=-1, mate_pos=-1, tlen=0, tags=tags)


def flow_batch(seed, read_lens, hap_lens):
    """Haplotypes and flow-space reads for the flow PairHMM's tests, cut from
    one random sequence: (haplotypes [bytes], reads [(bases uint8, quals
    uint8, tp int8)]), each read through _flow_read's hmer-error model. Build
    FlowBasedHaplotype(bases) and FlowBasedRead(bases, quals, tp=tp) of either
    package from them."""
    rng = np.random.default_rng(seed)
    span = max(max(read_lens), max(hap_lens)) + 8
    master = _ACGT[rng.integers(0, 4, span)]
    haps, reads = [], []
    for n in hap_lens:
        s = int(rng.integers(0, span - n + 1))
        haps.append(bytes(master[s : s + n]))
    for k, n in enumerate(read_lens):
        s = int(rng.integers(0, span - n + 1))
        r = _flow_read(rng, k, master[s : s + n], np.arange(s, s + n))
        reads.append((r.bases, r.quals, r.tags["tp"]))
    return haps, reads


def write_flow_sample(out_dir, seed=0, contig="chrM", length=16569, n_reads=3400, read_len=200,
                      n_snv=24, n_indel=6, n_hmer_indel=3, min_gap=400, sample="FLOW1"):
    """Write <out_dir>/ref.fa (+ .fai) and <out_dir>/flow.bam: a diploid
    germline sample of flow-space (Ultima) reads for HaplotypeCaller
    --likelihood-calculation-engine FlowBasedHMM with flow order FLOW_ORDER,
    at 3,400 reads of 200 bases over 16,569 bp by default (about 41x).

    The het SNVs and indels are planted as write_sample plants them; then
    n_hmer_indel of the indels are moved to the next homopolymer of three or
    more bases and made a 1-base change of its length. Each read is drawn from
    either haplotype with probability 0.5 and read through _flow_read's
    hmer-error model, which writes its tp and t0 tags.

    Returns dict(fasta=path, bam=path, contig=contig, length=length,
    variants=[Planted], hmer_indels=[Planted], n_reads=n_reads,
    flow_order=FLOW_ORDER)."""
    rng = np.random.default_rng(seed)
    ref = _ACGT[rng.integers(0, 4, length)]
    variants = _plant(rng, ref, n_snv, n_indel, min_gap, margin=300)
    hmer = []
    for k in [k for k, v in enumerate(variants) if not v.is_snv][:n_hmer_indel]:
        s = _hmer_plant(ref, variants[k].pos)
        if s is None:
            continue
        a = s - 1
        if rng.random() < 0.5:
            variants[k] = Planted(a, bytes(ref[a : a + 2]).decode(), chr(ref[a]))
        else:
            variants[k] = Planted(a, chr(ref[a]), chr(ref[a]) + chr(ref[s]))
        hmer.append(variants[k])
    alt, alt_where = _alt_haplotype(ref, variants)

    os.makedirs(out_dir, exist_ok=True)
    fasta = _write_fasta(out_dir, contig, ref)
    reads = []
    for k in range(n_reads):
        src, where = (alt, alt_where) if rng.random() < 0.5 else (ref, np.arange(length))
        s = int(rng.integers(0, len(src) - read_len + 1))
        reads.append(_flow_read(rng, k, src[s : s + read_len], where[s : s + read_len]))
    path = os.path.join(out_dir, "flow.bam")
    _write_bam(path, contig, length, reads, sample)
    return dict(fasta=fasta, bam=path, contig=contig, length=length, variants=variants,
                hmer_indels=hmer, n_reads=n_reads, flow_order=FLOW_ORDER)


def write_flow_haplotypes(path, fasta, contig, variants, n_variants=4, seed=0,
                          window=(300, 400)):
    """Write the haplotypes FASTA (+ .fai) that FlowPairHMMAlignReadsToHaplotypes
    scores reads against: for each of the first n_variants planted variants, the
    reference allele's and the planted allele's window of `window` reference
    bases (its length and offset drawn from the seed) around it, named
    <contig>_<1-based pos>_ref and _alt. Returns the names in file order."""
    from ..io.fasta import FastaReference

    rng = np.random.default_rng(seed)
    ref = np.frombuffer(bytes(FastaReference(fasta).fetch_bytes(contig)), np.uint8)
    records = []
    for v in variants[:n_variants]:
        n = int(rng.integers(window[0], window[1] + 1))
        lo = max(0, v.pos - int(rng.integers(n // 4, 3 * n // 4)))
        hi = min(len(ref), lo + n)
        tail = ref[v.pos + len(v.ref) : hi]
        alt = np.concatenate([ref[lo : v.pos], np.frombuffer(v.alt.encode(), np.uint8), tail])
        records += [(f"{contig}_{v.pos + 1}_ref", ref[lo:hi]), (f"{contig}_{v.pos + 1}_alt", alt)]
    _write_fasta_records(path, records)
    return [name for name, _ in records]


# (mean, sd) of each annotation of cnn_score.ANNOTATIONS at true sites and at
# artifacts; FS, SOR and DP are drawn as |N(mean, sd)|
CALLSET_ANNOTATIONS = (
    ("MQ", (60.0, 1.5), (38.0, 6.0)),
    ("DP", (40.0, 6.0), (30.0, 10.0)),
    ("SOR", (0.7, 0.25), (3.0, 0.8)),
    ("FS", (2.0, 1.5), (28.0, 7.0)),
    ("QD", (20.0, 3.0), (4.0, 2.0)),
    ("MQRankSum", (0.0, 0.6), (-3.0, 1.2)),
    ("ReadPosRankSum", (0.0, 0.6), (-2.0, 1.0)),
)
_ABS_ANNOTATIONS = ("DP", "SOR", "FS")


def _cnn_1d_state_dict(rng):
    """A GATK_CNN_1D state dict (scorevariants/models/gatk_1d.py; the layer
    shapes of the shipped 1d_cnn_mix_train_full_bn.pt) with PyTorch's default
    initialisation, uniform in +-1/sqrt(fan_in), drawn with numpy, and batch
    norm statistics near CALLSET_ANNOTATIONS' true sites."""
    import torch

    def layer(shape, fan_in):
        lim = 1.0 / np.sqrt(fan_in)
        return torch.from_numpy(rng.uniform(-lim, lim, shape).astype(np.float32))

    sd = {}
    for name, (o, i) in (("conv.0", (256, 4)), ("conv.2", (256, 256)), ("conv.5", (128, 256))):
        sd[f"{name}.weight"] = layer((o, i, 12), i * 12)
        sd[f"{name}.bias"] = layer((o,), i * 12)
    true_mean = np.array([m for _, (m, _), _ in CALLSET_ANNOTATIONS], np.float32)
    true_sd = np.array([s for _, (_, s), _ in CALLSET_ANNOTATIONS], np.float32)
    sd["normalize.weight"] = torch.ones(7)
    sd["normalize.bias"] = torch.zeros(7)
    sd["normalize.running_mean"] = torch.from_numpy(true_mean)
    sd["normalize.running_var"] = torch.from_numpy(true_sd ** 2)
    sd["normalize.num_batches_tracked"] = torch.tensor(0)
    for name, (o, i) in (("dense_1.0", (40, 7)), ("dense_2.0", (40, 12200)), ("dense_3", (4, 47))):
        sd[f"{name}.weight"] = layer((o, i), i)
        sd[f"{name}.bias"] = layer((o,), i)
    return sd


def write_callset(out_dir, seed=0, contig="20", length=20_000_000, n_snv=18000, n_indel=2000,
                  true_fraction=0.8, truth_fraction=0.6):
    """Write a sites-only callset for the scoring tools: <out_dir>/callset.fa
    (+ .fai), one random contig; <out_dir>/callset.vcf, n_snv SNVs and n_indel
    1-3 bp indels, one site a kb (the density of a germline callset), each a
    true site with probability true_fraction and otherwise an artifact, with
    QUAL and the seven annotations of cnn_score.ANNOTATIONS drawn from
    CALLSET_ANNOTATIONS' two distributions; <out_dir>/truth.vcf, truth_fraction
    of the true sites; and <out_dir>/cnn_1d.pt, a GATK_CNN_1D state dict made
    from the seed (_cnn_1d_state_dict).

    Returns dict(fasta, vcf, truth, weights_1d paths, contig, length, sites:
    [(0-based pos, ref, alt, is_snp, is_true)])."""
    import torch

    rng = np.random.default_rng(seed)
    n = n_snv + n_indel
    ref = _ACGT[rng.integers(0, 4, length)]
    step = length // n
    pos = step // 2 + step * np.arange(n) + rng.integers(-step // 4, step // 4 + 1, n)
    is_indel = np.zeros(n, bool)
    is_indel[rng.choice(n, n_indel, replace=False)] = True
    is_true = rng.random(n) < true_fraction
    in_truth = is_true & (rng.random(n) < truth_fraction)
    ann = np.empty((n, len(CALLSET_ANNOTATIONS)))
    for c, (name, good, bad) in enumerate(CALLSET_ANNOTATIONS):
        ann[:, c] = np.where(is_true, rng.normal(good[0], good[1], n), rng.normal(bad[0], bad[1], n))
        if name in _ABS_ANNOTATIONS:
            ann[:, c] = np.abs(ann[:, c])
    qual = np.where(is_true, rng.normal(400, 120, n), rng.normal(80, 40, n)).clip(30, None)
    sites = []
    for k in range(n):
        p = int(pos[k])
        r = chr(ref[p])
        if not is_indel[k]:
            alt = chr(_ACGT[(np.searchsorted(_ACGT, ref[p]) + rng.integers(1, 4)) % 4])
            sites.append((p, r, alt, True, bool(is_true[k])))
        else:
            ln = int(rng.integers(1, 4))
            if rng.random() < 0.5:
                sites.append((p, bytes(ref[p : p + 1 + ln]).decode(), r, False, bool(is_true[k])))
            else:
                ins = bytes(_ACGT[rng.integers(0, 4, ln)]).decode()
                sites.append((p, r, r + ins, False, bool(is_true[k])))

    os.makedirs(out_dir, exist_ok=True)
    fasta = os.path.join(out_dir, "callset.fa")
    os.replace(_write_fasta(out_dir, contig, ref), fasta)
    os.replace(os.path.join(out_dir, "ref.fa.fai"), fasta + ".fai")
    head = ("##fileformat=VCFv4.2\n" + f"##contig=<ID={contig},length={length}>\n"
            + "".join(f'##INFO=<ID={name},Number=1,Type=Float,Description="{name}">\n'
                      for name, _, _ in CALLSET_ANNOTATIONS)
            + "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
    vcf_path, truth_path = os.path.join(out_dir, "callset.vcf"), os.path.join(out_dir, "truth.vcf")
    with open(vcf_path, "w") as fh, open(truth_path, "w") as th:
        fh.write(head)
        th.write(head)
        for k, (p, r, a, _, _) in enumerate(sites):
            info = ";".join(f"{name}={ann[k, c]:.3f}"
                            for c, (name, _, _) in enumerate(CALLSET_ANNOTATIONS))
            fh.write(f"{contig}\t{p + 1}\t.\t{r}\t{a}\t{qual[k]:.2f}\t.\t{info}\n")
            if in_truth[k]:
                th.write(f"{contig}\t{p + 1}\t.\t{r}\t{a}\t.\tPASS\t.\n")
    weights = os.path.join(out_dir, "cnn_1d.pt")
    torch.save(_cnn_1d_state_dict(rng), weights)
    return dict(fasta=fasta, vcf=vcf_path, truth=truth_path, weights_1d=weights, contig=contig,
                length=length, sites=sites)


# ---------------------------------------------------------------------------
# A GENCODE datasource for Funcotator
# ---------------------------------------------------------------------------

_STOPS = (b"TAA", b"TAG", b"TGA")
_COMPLEMENT = bytes.maketrans(b"ACGT", b"TGCA")


def _stop_free_codons(seq, x, limit):
    """How many codons from seq[x] on, up to `limit`, hold no stop codon."""
    n = 0
    while n < limit and x + 3 * n + 3 <= len(seq) and seq[x + 3 * n : x + 3 * n + 3] not in _STOPS:
        n += 1
    return n


def _gene_model(rng, seq, n_exons, min_codons=4):
    """Exons [(a, b)] (0-based, end exclusive) of a transcript on `seq`, its
    spliced sequence in transcript orientation, and its CDS (c0, c1) in
    transcript coordinates (0-based, end exclusive): a 5' UTR in the first
    exon, n_exons codon-aligned CDS pieces, each a stop-free run of at least
    min_codons codons, joined by introns of 100-1,500 bases, and a 3' UTR after
    the last codon. None where `seq` is too short for it."""
    x = int(rng.integers(20, 81))
    exons, cds = [], 0
    for k in range(n_exons):
        while x + 3 * min_codons <= len(seq) and _stop_free_codons(seq, x, min_codons) < min_codons:
            x += 1
        if x + 3 * min_codons > len(seq):
            return None
        if k == 0:
            u5 = x
        n = _stop_free_codons(seq, x, int(rng.integers(min_codons, 61)))
        exons.append([0 if k == 0 else x, x + 3 * n])
        cds += 3 * n
        x += 3 * n + int(rng.integers(100, 1501))
    exons[-1][1] = min(len(seq), exons[-1][1] + int(rng.integers(20, 201)))
    spliced = b"".join(seq[a:b] for a, b in exons)
    return [tuple(e) for e in exons], spliced, (u5, u5 + cds)


def write_gencode_datasource(out_dir, fasta, contig, seed=0, n_genes=200, build="hg38"):
    """Write a GENCODE datasource for Funcotator over `contig` of `fasta`, in
    the layout GencodeDataSource.load reads: <out_dir>/gencode/<build>/
    gencode.config (type gencode), gencode.gtf and gencode.transcripts.fa.

    n_genes protein-coding genes of one transcript each, one in each of
    n_genes equal slots of the contig at an offset drawn from the seed, on
    either strand: 4-10 exons, a 5' UTR in the first, a 3' UTR in the last,
    and a CDS of codon-aligned stop-free pieces (_gene_model), so that every
    codon of a CDS translates to an amino acid. The transcript FASTA holds each
    spliced transcript, with its UTR5/CDS/UTR3 ranges in the header as GENCODE
    writes them.

    Returns dict(dir=out_dir, build, genes=[dict(gene, transcript, strand,
    start, end, exons, cds)]) with 1-based inclusive genomic coordinates;
    exons and cds in genomic order."""
    from ..io.fasta import FastaReference

    rng = np.random.default_rng(seed)
    ref = bytes(FastaReference(fasta).fetch_bytes(contig)).upper()
    slot = len(ref) // n_genes
    base = os.path.join(out_dir, "gencode", build)
    os.makedirs(base, exist_ok=True)
    genes, gtf, fa = [], [], []
    for g in range(n_genes):
        strand = "+" if rng.random() < 0.5 else "-"
        span = min(slot, 30_000)
        g0 = g * slot + int(rng.integers(0, slot - span + 1))
        seq = ref[g0 : g0 + span]
        if strand == "-":
            seq = seq.translate(_COMPLEMENT)[::-1]
        model = _gene_model(rng, seq, int(rng.integers(4, 11)))
        if model is None:
            continue
        exons_t, spliced, (c0, c1) = model

        def genomic(a, b):  # transcript-strand [a, b) -> 1-based inclusive genomic
            return (g0 + a + 1, g0 + b) if strand == "+" else (g0 + span - b + 1, g0 + span - a)

        exons = sorted(genomic(a, b) for a, b in exons_t)
        cds_t, t = [], 0
        for a, b in exons_t:  # the CDS part of each exon, in transcript coordinates
            lo, hi = max(c0, t), min(c1, t + b - a)
            if lo < hi:
                cds_t.append((a + lo - t, a + hi - t))
            t += b - a
        cds = sorted(genomic(a, b) for a, b in cds_t)
        gid, tid, name = f"ENSG{g:011d}.1", f"ENST{g:011d}.1", f"GENE{g}"
        start, end = exons[0][0], exons[-1][1]
        attrs = (f'gene_id "{gid}"; transcript_id "{tid}"; gene_type "protein_coding"; '
                 f'gene_name "{name}"; transcript_type "protein_coding"; '
                 f'transcript_name "{name}-201"; tag "basic";')
        gtf.append(f"{contig}\tSYNTHETIC\tgene\t{start}\t{end}\t.\t{strand}\t.\t"
                   f'gene_id "{gid}"; gene_type "protein_coding"; gene_name "{name}";\n')
        gtf.append(f"{contig}\tSYNTHETIC\ttranscript\t{start}\t{end}\t.\t{strand}\t.\t{attrs}\n")
        for kind, parts in (("exon", exons), ("CDS", cds)):
            for a, b in parts:
                gtf.append(f"{contig}\tSYNTHETIC\t{kind}\t{a}\t{b}\t.\t{strand}\t.\t{attrs}\n")
        n = len(spliced)
        fa.append((f"{tid}|{gid}|-|-|{name}-201|{name}|{n}|UTR5:1-{c0}|CDS:{c0 + 1}-{c1}|"
                   f"UTR3:{c1 + 1}-{n}|", spliced))
        genes.append(dict(gene=name, transcript=tid, strand=strand, start=start, end=end,
                          exons=exons, cds=cds))
    with open(os.path.join(base, "gencode.gtf"), "w") as fh:
        fh.write("##description: synthetic GENCODE annotation\n")
        fh.writelines(gtf)
    _write_fasta_records(os.path.join(base, "gencode.transcripts.fa"), fa)
    with open(os.path.join(base, "gencode.config"), "w") as fh:
        fh.write(f"name = Gencode\nversion = 43\nsrc_file = gencode.gtf\ntype = gencode\n"
                 f"gencode_fasta_path = gencode.transcripts.fa\n")
    return dict(dir=out_dir, build=build, genes=genes)
