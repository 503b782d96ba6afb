# Copied verbatim from gatk_tpu/tools/saturation_mutagenesis_tool.py; only import lines may differ.
"""Saturation-mutagenesis readout analysis.

Reference behavior: tools/AnalyzeSaturationMutagenesis.java — process aligned
reads of a saturation-mutagenesis library against a short reference amplicon:
per read, trim to the high-quality window (min-q / min-length), extract the SNV
set (mismatches and indels vs the reference), require wild-type flanks
(min-flanking-length), count identical SNV signatures, interpret each signature
in codon space over the ORF, and write the reference's report files:

  <prefix>.variantCounts  count / spanners / meanRefCoverage / nSNVs / SNVs /
                          nCodonVariations / codon DNA changes / AA changes
  <prefix>.readCounts     report-type census
  <prefix>.refCoverage    per-base coverage
  <prefix>.codonCounts    per-codon counts of each of the 64 codon values
  <prefix>.aaCounts       per-codon counts of each amino acid

SNV string form matches the reference: `<1-based refIndex>:<ref>><alt>` with
`-` for indel sides (AnalyzeSaturationMutagenesis.SNV.toString).
"""
from __future__ import annotations

import argparse
from collections import Counter

import numpy as np

from ..cli import UserError, register_tool
from ..io import sam

CODON_TRANSLATION = "KNKNTTTTRSRSIIMIQHQHPPPPRRRRLLLLEDEDAAAAGGGGVVVVXYXYSSSSXCWCLFLF"
BASE_INDEX = {65: 0, 67: 1, 71: 2, 84: 3}  # A C G T
LABELS = ["".join((a, b, c)) for a in "ACGT" for b in "ACGT" for c in "ACGT"]


def extract_snvs(read, ref_bases, min_q):
    """Per-read SNV list [(ref_index, ref_char, alt_char, qual)] over the
    quality-trimmed alignment (ReadReport SNV extraction), plus the covered
    reference window [start, end)."""
    snvs = []
    quals = read.quals
    # high-quality trim: longest window whose bases are all >= min_q at the
    # flanks (the reference trims leading/trailing low-quality calls)
    n = len(read.bases)
    lo = 0
    while lo < n and quals[lo] < min_q:
        lo += 1
    hi = n
    while hi > lo and quals[hi - 1] < min_q:
        hi -= 1
    rp = int(read.pos)
    ro = 0
    cover_lo = cover_hi = None
    for op, ln in zip(read.cigar_ops, read.cigar_lens):
        op, ln = int(op), int(ln)
        if op in (sam.OP_M, sam.OP_EQ, sam.OP_X):
            for j in range(ln):
                if not (lo <= ro + j < hi):
                    continue
                ri = rp + j
                if not (0 <= ri < len(ref_bases)):
                    continue
                if cover_lo is None:
                    cover_lo = ri
                cover_hi = ri + 1
                rb = ref_bases[ri]
                ab = read.bases[ro + j]
                if rb != ab:
                    snvs.append((ri, chr(rb), chr(ab), int(quals[ro + j])))
            rp += ln
            ro += ln
        elif op == sam.OP_I:
            if lo <= ro < hi and 0 <= rp < len(ref_bases):
                for j in range(ln):
                    snvs.append((rp, "-", chr(read.bases[ro + j]),
                                 int(quals[ro + j])))
            ro += ln
        elif op == sam.OP_D:
            if lo <= ro < hi:
                for j in range(ln):
                    if 0 <= rp + j < len(ref_bases):
                        snvs.append((rp + j, chr(ref_bases[rp + j]), "-", 30))
            rp += ln
        elif op in (sam.OP_S,):
            ro += ln
        elif op == sam.OP_N:
            rp += ln
    return snvs, (cover_lo, cover_hi)


def codon_variations(snvs, ref_bases, orf_intervals, translation):
    """Interpret an SNV signature as codon variations over the ORF
    (CodonTracker.encodeSNVsAsCodons, reduced): returns a list of
    (codon_id, kind, ref_value, alt_value) with kind in M/I/D/FS."""
    orf_positions = []
    for s, e in orf_intervals:
        orf_positions.extend(range(s, e))
    pos_to_orf = {p: i for i, p in enumerate(orf_positions)}
    # apply SNVs to the ORF sequence
    orf_ref = [chr(ref_bases[p]) for p in orf_positions]
    variant = dict()
    indel_in_orf = 0
    for ri, r, a, _q in snvs:
        if ri not in pos_to_orf:
            continue
        oi = pos_to_orf[ri]
        if r == "-":
            indel_in_orf += 1
            variant.setdefault(oi, []).append(("ins", a))
        elif a == "-":
            indel_in_orf -= 1
            variant.setdefault(oi, []).append(("del", r))
        else:
            variant.setdefault(oi, []).append(("sub", a))
    if not variant:
        return []
    out = []
    if indel_in_orf % 3 != 0:
        first = min(variant)
        return [(first // 3, "FS", None, None)]
    # build variant ORF string and compare codon-by-codon
    var_seq = []
    for i, base in enumerate(orf_ref):
        ops = variant.get(i, [])
        subs = [a for k, a in ops if k == "sub"]
        dels = [1 for k, _ in ops if k == "del"]
        inss = [a for k, a in ops if k == "ins"]
        var_seq.extend(inss)
        if not dels:
            var_seq.append(subs[0] if subs else base)
    ref_codons = ["".join(orf_ref[i : i + 3]) for i in range(0, len(orf_ref) - 2, 3)]
    var_codons = ["".join(var_seq[i : i + 3]) for i in range(0, len(var_seq) - 2, 3)]
    for ci in range(max(len(ref_codons), len(var_codons))):
        rc = ref_codons[ci] if ci < len(ref_codons) else None
        vc = var_codons[ci] if ci < len(var_codons) else None
        if rc == vc:
            continue
        if rc is None:
            out.append((ci, "I", None, vc))
        elif vc is None:
            out.append((ci, "D", rc, None))
        else:
            out.append((ci, "M", rc, vc))
    return out


def _codon_value(codon):
    v = 0
    for c in codon:
        b = BASE_INDEX.get(ord(c))
        if b is None:
            return None
        v = v * 4 + b
    return v


@register_tool("AnalyzeSaturationMutagenesis")
def analyze_saturation_mutagenesis(argv):
    """Saturation-mutagenesis variant/codon census
    (tools/AnalyzeSaturationMutagenesis.java)."""
    p = argparse.ArgumentParser(description="AnalyzeSaturationMutagenesis")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-R", "--reference", required=True)
    p.add_argument("--output-file-prefix", "-O", dest="prefix", required=True)
    p.add_argument("--orf", required=True,
                   help="ORF interval(s), 1-based inclusive, e.g. '134-180,214-238'")
    p.add_argument("--min-q", type=int, default=30)
    p.add_argument("--min-length", type=int, default=15)
    p.add_argument("--min-flanking-length", type=int, default=2)
    p.add_argument("--min-mapq", type=int, default=4)
    p.add_argument("--min-variant-obs", type=int, default=3)
    p.add_argument("--codon-translation", default=CODON_TRANSLATION)
    args = p.parse_args(argv)

    from ..io import fasta
    from ..io.cram import open_reads

    ref = fasta.FastaReference(args.reference)
    contig = ref.contigs()[0]
    ref_bases = bytes(ref.fetch(contig, 0, ref.contig_length(contig))).upper()
    orf_intervals = []
    for part in args.orf.split(","):
        s, e = part.split("-")
        orf_intervals.append((int(s) - 1, int(e)))
    orf_len = sum(e - s for s, e in orf_intervals)
    if orf_len % 3 != 0:
        raise UserError(f"ORF length {orf_len} is not a multiple of 3")
    n_codons = orf_len // 3

    counts = Counter()  # report types
    coverage = np.zeros(len(ref_bases), np.int64)
    signature_counts = {}
    spans = []
    rd = open_reads(args.input, reference=ref)
    for r in rd:
        counts["total"] += 1
        if r.is_unmapped:
            counts["unmapped"] += 1
            continue
        if r.mapq < args.min_mapq:
            counts["low_mapq"] += 1
            continue
        snvs, (lo, hi) = extract_snvs(r, ref_bases, args.min_q)
        if lo is None or hi - lo < args.min_length:
            counts["low_quality"] += 1
            continue
        # flanking wild-type requirement around the SNV set
        if snvs:
            if (snvs[0][0] - lo < args.min_flanking_length
                    or hi - 1 - snvs[-1][0] < args.min_flanking_length):
                counts["inconsistent"] += 1
                continue
        coverage[lo:hi] += 1
        spans.append((lo, hi))
        if not snvs:
            counts["wild_type"] += 1
            continue
        counts["called_variant"] += 1
        key = tuple((ri, rc, ac) for ri, rc, ac, _q in snvs)
        rec = signature_counts.setdefault(key, [0, 0.0])
        rec[0] += 1
        rec[1] += float(coverage[lo:hi].mean())

    # per-codon census
    codon_counts = np.zeros((n_codons, 64), np.int64)
    aa_counts = {}
    tr = args.codon_translation
    variant_rows = []
    for key in sorted(signature_counts):
        count, cov_sum = signature_counts[key]
        if count < args.min_variant_obs:
            continue
        snv_strs = ", ".join(f"{ri + 1}:{rc}>{ac}" for ri, rc, ac in key)
        lo = max(0, key[0][0] - args.min_flanking_length)
        hi = min(len(ref_bases), key[-1][0] + args.min_flanking_length)
        spanners = sum(1 for s, e in spans if s <= lo and e >= hi)
        cvs = codon_variations([(ri, rc, ac, 0) for ri, rc, ac in key],
                               ref_bases, orf_intervals, tr)
        dna_col, aa_col = [], []
        for ci, kind, rc, vc in cvs:
            if kind == "FS":
                dna_col.append(f"{ci + 1}:FS")
                aa_col.append("FS")
                continue
            dna_col.append(f"{ci + 1}:{rc or '---'}>{vc or '---'}")
            rv = _codon_value(rc) if rc else None
            vv = _codon_value(vc) if vc else None
            if kind == "M" and rv is not None and vv is not None:
                faa, taa = tr[rv], tr[vv]
                label = "S" if faa == taa else ("N" if taa == "X" else "M")
                aa_col.append(f"{label}:{faa}>{taa}")
                codon_counts[ci, vv] += count
                aa_counts[(ci, taa)] = aa_counts.get((ci, taa), 0) + count
            elif kind == "I" and vv is not None:
                aa_col.append(f"I:->{tr[vv]}")
            elif kind == "D" and rv is not None:
                aa_col.append(f"D:{tr[rv]}>-")
        variant_rows.append(
            f"{count}\t{spanners}\t{cov_sum / count:.1f}\t{len(key)}\t{snv_strs}"
            f"\t{len(cvs)}\t{', '.join(dna_col)}\t{', '.join(aa_col)}")

    with open(args.prefix + ".variantCounts", "w") as fh:
        fh.write("\n".join(variant_rows) + ("\n" if variant_rows else ""))
    with open(args.prefix + ".refCoverage", "w") as fh:
        fh.write("RefPos\tCoverage\n")
        for i, c in enumerate(coverage):
            fh.write(f"{i + 1}\t{c}\n")
    with open(args.prefix + ".readCounts", "w") as fh:
        total = max(1, counts["total"])
        fh.write(f"Total Reads:\t{counts['total']}\t100.000%\n")
        for k in ("unmapped", "low_mapq", "low_quality", "inconsistent",
                  "wild_type", "called_variant"):
            fh.write(f">{k}:\t{counts[k]}\t{100.0 * counts[k] / total:.3f}%\n")
    with open(args.prefix + ".codonCounts", "w") as fh:
        fh.write("Codon\t" + "\t".join(LABELS) + "\n")
        for ci in range(n_codons):
            fh.write(f"{ci + 1}\t" + "\t".join(str(x) for x in codon_counts[ci]) + "\n")
    aas = sorted(set(tr))
    with open(args.prefix + ".aaCounts", "w") as fh:
        fh.write("Codon\t" + "\t".join(aas) + "\n")
        for ci in range(n_codons):
            fh.write(f"{ci + 1}\t" + "\t".join(
                str(aa_counts.get((ci, a), 0)) for a in aas) + "\n")
    print(f"AnalyzeSaturationMutagenesis: {len(variant_rows)} variant signatures, "
          f"{counts['total']} reads -> {args.prefix}.*")
    return 0
