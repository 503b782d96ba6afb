# Copied verbatim from gatk_tpu/tools/fasta_tools.py; only import lines may differ.
"""Reference/FASTA utility tools.

Reference behavior: picard CreateSequenceDictionary/NormalizeFasta (wrapped by
GATK Main.java:109) and tools/reference/{FastaReferenceMaker,
FastaAlternateReferenceMaker,ShiftFasta}.java.
"""
from __future__ import annotations

import argparse
import hashlib
import os

import numpy as np

from ..cli import register_tool
from ..engine import walkers
from ..engine import intervals as iv
from ..io import fasta


def _write_fasta(path, records, line_length=60):
    with open(path, "w") as fh:
        for name, seq in records:
            fh.write(f">{name}\n")
            s = seq.tobytes().decode() if isinstance(seq, np.ndarray) else seq
            for i in range(0, len(s), line_length):
                fh.write(s[i : i + line_length] + "\n")


def _write_fai(path, records, line_length=60):
    """Matching .fai so the output is immediately usable as a -R argument."""
    with open(path + ".fai", "w") as fh:
        offset = 0
        for name, seq in records:
            n = len(seq)
            offset += len(name) + 2  # ">name\n"
            fh.write(f"{name}\t{n}\t{offset}\t{line_length}\t{line_length + 1}\n")
            full_lines = n // line_length
            rem = n % line_length
            offset += full_lines * (line_length + 1) + (rem + 1 if rem else 0)


@register_tool("CreateSequenceDictionary")
def create_sequence_dictionary(argv):
    """Write a .dict header for a FASTA (picard CreateSequenceDictionary:
    @SQ lines with length + normalized-sequence MD5)."""
    p = argparse.ArgumentParser(description="CreateSequenceDictionary")
    p.add_argument("-R", "--reference", required=True)
    p.add_argument("-O", "--output", default=None)
    args = p.parse_args(argv)
    out = args.output or os.path.splitext(args.reference)[0] + ".dict"
    ref = fasta.FastaReference(args.reference)
    uri = "file://" + os.path.abspath(args.reference)
    with open(out, "w") as fh:
        fh.write("@HD\tVN:1.6\n")
        for name in ref.contigs():
            seq = ref.fetch(name)
            md5 = hashlib.md5(seq.tobytes().upper()).hexdigest()
            fh.write(f"@SQ\tSN:{name}\tLN:{len(seq)}\tM5:{md5}\tUR:{uri}\n")
    print(f"wrote {out}")
    return 0


@register_tool("NormalizeFasta")
def normalize_fasta(argv):
    """Rewrap a FASTA to a uniform line length (picard NormalizeFasta)."""
    p = argparse.ArgumentParser(description="NormalizeFasta")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("--line-length", type=int, default=100)
    args = p.parse_args(argv)
    ref = fasta.FastaReference(args.input)
    records = [(name, ref.fetch(name)) for name in ref.contigs()]
    _write_fasta(args.output, records, args.line_length)
    _write_fai(args.output, records, args.line_length)
    return 0


@register_tool("FastaReferenceMaker")
def fasta_reference_maker(argv):
    """Create a new FASTA from reference intervals
    (tools/reference/FastaReferenceMaker.java: one output contig per interval,
    named by running index with the source coordinates in the description)."""
    p = argparse.ArgumentParser(description="FastaReferenceMaker")
    p.add_argument("-R", "--reference", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("-L", "--intervals", action="append", required=True)
    p.add_argument("--line-width", type=int, default=60)
    args = p.parse_args(argv)
    w = _FastaReferenceMakerWalker(reference_path=args.reference,
                                   intervals=args.intervals)
    w.args = args
    w.run()
    return 0


class _FastaReferenceMakerWalker(walkers.IntervalWalker):
    """FastaReferenceMaker as an IntervalWalker (the reference class extends
    ReferenceWalker; one output record per -L interval)."""

    tool_name = "FastaReferenceMaker"
    requires_reference = True
    default_read_filters = ()

    def on_traversal_start(self):
        self.records = []

    def apply(self, t):
        seq = self.reference.fetch(t.contig, t.start, t.end)
        self.records.append(
            (f"{len(self.records) + 1} {t.contig}:{t.start + 1}-{t.end}", seq))

    def on_traversal_success(self):
        _write_fasta(self.args.output, self.records, self.args.line_width)
        _write_fai(self.args.output, self.records, self.args.line_width)


@register_tool("FastaAlternateReferenceMaker")
def fasta_alternate_reference_maker(argv):
    """Inject VCF SNPs/indels into the reference
    (tools/reference/FastaAlternateReferenceMaker.java: replaces ref alleles by
    the first ALT; IUPAC for het SNPs is not modeled — first alt wins)."""
    from ..io import vcf as vcfio

    p = argparse.ArgumentParser(description="FastaAlternateReferenceMaker")
    p.add_argument("-R", "--reference", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("-V", "--variant", required=True)
    p.add_argument("-L", "--intervals", action="append", default=None)
    p.add_argument("--line-width", type=int, default=60)
    args = p.parse_args(argv)
    ref = fasta.FastaReference(args.reference)
    lengths = {n: ref.contig_length(n) for n in ref.contigs()}
    by_contig: dict[str, list] = {}
    for v in vcfio.VcfReader(args.variant):
        if v.alts and v.alts[0] not in ("*", "<NON_REF>"):
            by_contig.setdefault(v.contig, []).append(v)
    targets = (iv.parse_intervals_arg(args.intervals, lengths)
               if args.intervals else
               [iv.Interval(n, 0, lengths[n]) for n in ref.contigs()])
    records = []
    for i, t in enumerate(targets, start=1):
        seq = ref.fetch(t.contig, t.start, t.end).tobytes().decode()
        pieces = []
        cur = 0
        for v in sorted(by_contig.get(t.contig, []), key=lambda x: x.pos):
            off = v.pos - t.start
            if off < cur or off + len(v.ref) > len(seq):
                continue  # overlapping previous edit or outside the window
            pieces.append(seq[cur:off])
            pieces.append(v.alts[0])
            cur = off + len(v.ref)
        pieces.append(seq[cur:])
        name = (f"{i} {t.contig}:{t.start + 1}-{t.end}"
                if args.intervals else t.contig)
        records.append((name, "".join(pieces)))
    _write_fasta(args.output, records, args.line_width)
    _write_fai(args.output, records, args.line_width)
    return 0


@register_tool("ShiftFasta")
def shift_fasta(argv):
    """Create a circularly-shifted FASTA + shift-back chain for circular contigs
    (tools/reference/ShiftFasta.java — the mitochondria Best Practices pipeline
    calls the control region through a shifted reference and lifts back)."""
    p = argparse.ArgumentParser(description="ShiftFasta")
    p.add_argument("-R", "--reference", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("--shift-back-output", default=None,
                   help="chain file mapping shifted coords back (default <output>.shiftback.chain)")
    p.add_argument("--shift-offset-list", default=None,
                   help="comma-separated per-contig shift offsets (default length/2)")
    p.add_argument("--interval-file-name", default=None,
                   help="basename for the generated calling intervals")
    p.add_argument("--line-width", type=int, default=60)
    args = p.parse_args(argv)
    ref = fasta.FastaReference(args.reference)
    names = ref.contigs()
    offsets = ([int(x) for x in args.shift_offset_list.split(",")]
               if args.shift_offset_list else
               [ref.contig_length(n) // 2 for n in names])
    records = []
    chain_lines = []
    chain_id = 1
    for name, offset in zip(names, offsets):
        seq = ref.fetch(name)
        n = len(seq)
        shifted = np.concatenate([seq[offset:], seq[:offset]])
        records.append((name, shifted))
        # two chain blocks: [0, n-offset) -> [offset, n), [n-offset, n) -> [0, offset)
        chain_lines.append(f"chain 1 {name} {n} + 0 {n - offset} {name} {n} + {offset} {n} {chain_id}")
        chain_lines.append(f"{n - offset}\n")
        chain_id += 1
        chain_lines.append(f"chain 1 {name} {n} + {n - offset} {n} {name} {n} + 0 {offset} {chain_id}")
        chain_lines.append(f"{offset}\n")
        chain_id += 1
    _write_fasta(args.output, records, args.line_width)
    _write_fai(args.output, records, args.line_width)
    chain_path = args.shift_back_output or args.output + ".shiftback.chain"
    with open(chain_path, "w") as fh:
        fh.write("\n".join(chain_lines) + "\n")
    if args.interval_file_name:
        # calling intervals: the half around the origin on the shifted ref
        with open(args.interval_file_name + ".shifted.intervals", "w") as fh:
            for name, offset in zip(names, offsets):
                n = ref.contig_length(name)
                lo = n - offset - min(n // 4, n - offset)
                fh.write(f"{name}:{lo + 1}-{min(n - offset + n // 4, n)}\n")
    print(f"wrote {args.output} and {chain_path}")
    return 0
