# Copied verbatim from gatk_tpu/tools/variant_recalling_tool.py; only import lines and the HaplotypeBasedVariantRecaller --device flag (variant_recalling_tool.py:54) differ.
"""Haplotype-based variant recalling.

Reference behavior: tools/walkers/variantrecalling/HaplotypeBasedVariantRecaller.java
(+ HaplotypeRegionWalker, TrimmedReadsReader, VariantRecallerResultWriter): for
each allele in a VCF, take the best-centered haplotype group from a haplotypes
BAM (e.g. an HC bamout), compute the read-vs-haplotype PairHMM likelihood
matrix over the reads spanning the haplotype region, marginalize haplotypes to
the variant's alleles, and append the per-read likelihood matrix to a CSV:

  #contig:start[-end] span allele1 allele2 ...
  readname keyspace_len is_dup is_reverse mapq lik1 lik2 ...
"""
from __future__ import annotations

import argparse

import numpy as np

from ..cli import register_tool
from ..io import vcf
from .. import devices


def _haplotype_from_read(r, ref, contig):
    """Build a Haplotype (with events) from one haplotypes-BAM record."""
    from ..assembly.haplotype import Haplotype, build_event_map

    ref_bases = ref.fetch(contig, r.pos, r.end)
    h = Haplotype(bytes(r.bases), is_ref=False,
                  cigar_ops=r.cigar_ops, cigar_lens=r.cigar_lens,
                  alignment_start=int(r.pos))
    build_event_map(h, ref_bases, int(r.pos))
    return h


def _fitness(v, span):
    """HaplotypeRegionWalker.fitnessScore: closeness of the variant to the
    center of the haplotype span."""
    before = max(1, v.pos - span[0])
    after = max(1, span[1] - v.end)
    return 1.0 - 2 * abs(0.5 - before / (before + after))


@register_tool("HaplotypeBasedVariantRecaller")
def haplotype_based_variant_recaller(argv):
    """Likelihood matrix of reads vs VCF alleles constrained to given
    haplotypes (variantrecalling/HaplotypeBasedVariantRecaller.java)."""
    p = argparse.ArgumentParser(description="HaplotypeBasedVariantRecaller")
    p.add_argument("--alleles-file-vcf", required=True)
    p.add_argument("--haplotypes-file-bam", required=True)
    p.add_argument("--matrix-file-csv", required=True)
    p.add_argument("-I", "--input", action="append", required=True)
    p.add_argument("-R", "--reference", required=True)
    p.add_argument("-L", "--intervals", action="append", default=None)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the PairHMM runs: the CUDA kernel, or its plain "
                        "PyTorch version on the host")
    args = p.parse_args(argv)
    devices.set_default_device(args.device)

    from ..calling import read_prep
    from ..calling.likelihoods import AlleleLikelihoods
    from ..engine import intervals as iv
    from ..io import fasta
    from ..io.cram import open_reads
    from ..ops import pairhmm as pairhmm_tpu

    ref = fasta.FastaReference(args.reference)
    hap_reader = open_reads(args.haplotypes_file_bam, reference=ref)
    read_readers = [open_reads(path, reference=ref) for path in args.input]
    contig_lengths = {s.name: s.length for s in hap_reader.header.sequences}
    targets = (iv.parse_intervals_arg(args.intervals, contig_lengths)
               if args.intervals else
               [iv.Interval(s.name, 0, s.length) for s in hap_reader.header.sequences])

    batcher = pairhmm_tpu.PoolBatcher()
    out_lines = []
    n_variants = 0
    for target in targets:
        for v in vcf.VcfReader(args.alleles_file_vcf):
            if v.contig != target.contig or not (target.start <= v.pos < target.end):
                continue
            # haplotype groups by identical span; pick the best-centered one
            hap_reads = [h for h in hap_reader.query(v.contig, v.pos, v.end)
                         if not h.is_unmapped and len(h.bases) > 0]
            groups = {}
            for h in hap_reads:
                groups.setdefault((int(h.pos), int(h.end)), []).append(h)
            if not groups:
                continue
            span = max(groups, key=lambda s: _fitness(v, s))
            haps = [_haplotype_from_read(h, ref, v.contig) for h in groups[span]]
            # reads overlapping the haplotype span, hard-clipped to it
            from ..engine import clipping
            reads = []
            for rr in read_readers:
                for r in rr.query(v.contig, span[0], span[1]):
                    if r.is_unmapped or r.is_duplicate or r.mapq == 0:
                        continue
                    rc = clipping.hard_clip_to_interval(r, span[0], span[1])
                    if len(rc.bases) > 0:
                        reads.append(rc)
            if not reads:
                continue
            prepped = read_prep.prepare_reads_for_pairhmm(reads)
            handle = batcher.add_region(prepped, [h.bases for h in haps])
            batcher.flush()
            mat = pairhmm_tpu.finish_likelihood_matrix(
                handle, prepped, [h.bases for h in haps])  # (n_reads, n_haps)
            lik = AlleleLikelihoods(haps, reads, mat.T)
            # haplotype -> allele grouping at the variant locus
            allele_groups = {}
            ref_haps = [h for h in haps
                        if not any(e.start == v.pos for e in h.events)]
            allele_groups[v.ref] = ref_haps
            for alt in v.alts:
                allele_groups[alt] = [
                    h for h in haps
                    if any(e.start == v.pos and e.alt == alt for e in h.events)]
            marginal = lik.marginalize(allele_groups)
            loc = f"{v.contig}:{v.pos + 1}"
            if v.end != v.pos + 1:
                loc += f"-{v.end}"
            span_str = f"{v.contig}:{span[0] + 1}-{span[1]}"
            out_lines.append("#" + loc + " " + span_str + " " +
                             " ".join(allele_groups.keys()))
            for ri, r in enumerate(marginal.reads):
                vals = marginal.values[:, ri]
                if not np.isfinite(vals).any():
                    continue
                out_lines.append(
                    f"{r.name} 0 {1 if r.is_duplicate else 0} "
                    f"{1 if r.is_reverse else 0} {r.mapq} "
                    + " ".join(f"{x:.4f}" for x in vals))
            n_variants += 1
    with open(args.matrix_file_csv, "w") as fh:
        fh.write("\n".join(out_lines) + ("\n" if out_lines else ""))
    print(f"HaplotypeBasedVariantRecaller: wrote matrices for {n_variants} "
          f"variants to {args.matrix_file_csv}")
    return 0
