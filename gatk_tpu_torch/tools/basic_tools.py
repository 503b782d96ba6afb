# Copied verbatim from gatk_tpu/tools/basic_tools.py; only import lines may differ.
"""Basic read/variant utility tools (CountReads, PrintReads, CountVariants,
SelectVariants-lite — engine walker tool equivalents)."""
from __future__ import annotations

from ..cli import register_tool, standard_io_parser
from ..engine import intervals as iv
from ..io import bam, vcf


class _CountReadsWalker:
    """tools/CountReads.java as a ReadWalker (WellformedReadFilter default),
    with the walker framework's filter summaries + ProgressMeter."""

    def __new__(cls, argv):
        import argparse

        from ..engine.walkers import ReadWalker

        p = argparse.ArgumentParser()
        p.add_argument("-I", "--input", action="append", required=True)
        p.add_argument("-L", "--intervals", action="append", default=None)
        p.add_argument("--read-filter", action="append", default=[])
        p.add_argument("--disable-read-filter", action="append", default=[])
        args = p.parse_args(argv)

        class W(ReadWalker):
            tool_name = "CountReads"
            default_read_filters = ["WellformedReadFilter"]

            def on_traversal_start(self):
                self.count = 0

            def apply(self, read, ctx):
                self.count += 1

            def on_traversal_success(self):
                print(self.count)
                return 0

        total = 0
        for path in args.input:
            w = W(reads_path=path, intervals=args.intervals,
                  read_filters=args.read_filter,
                  disable_read_filters=args.disable_read_filter)
            w.run()
        return 0


@register_tool("CountReads")
def count_reads(argv):
    """Count reads in a BAM/SAM file (tools/CountReads.java as a ReadWalker)."""
    return _CountReadsWalker(argv)


@register_tool("CountVariants")
def count_variants(argv):
    """Count variant records in a VCF (tools/CountVariants.java as a
    VariantWalker: per-record progress + lifecycle)."""
    import argparse

    from ..engine.walkers import VariantWalker

    p = argparse.ArgumentParser()
    p.add_argument("-V", "--variant", required=True)
    p.add_argument("-L", "--intervals", action="append", default=None)
    args = p.parse_args(argv)

    class W(VariantWalker):
        tool_name = "CountVariants"

        def on_traversal_start(self):
            self.count = 0

        def apply(self, variant):
            self.count += 1

        def on_traversal_success(self):
            print(self.count)
            return 0

    w = W(variant_path=args.variant, intervals=args.intervals)
    w.run()
    return 0


@register_tool("PrintReads")
def print_reads(argv):
    """Write reads (optionally subset by interval) to a new BAM."""
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("-I", "--input", action="append", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("-L", "--intervals", action="append", default=None)
    args = p.parse_args(argv)
    readers = [bam.BamReader(path) for path in args.input]
    from ..io.cram_writer import open_reads_writer
    w = open_reads_writer(args.output, readers[0].header)
    n = 0
    for r in readers:
        if args.intervals:
            lengths = {s.name: s.length for s in r.header.sequences}
            for s in args.intervals:
                t = iv.parse_interval(s, lengths)
                for rd in r.query(t.contig, t.start, t.end):
                    w.write(rd)
                    n += 1
        else:
            for rd in r:
                w.write(rd)
                n += 1
    w.close()
    print(f"wrote {n} reads")
    return 0


@register_tool("Pileup")
def pileup_tool(argv):
    """Print read bases per covered locus (tools/walkers/qc/Pileup.java, a
    LocusWalker on the walker framework: engine/walkers.py)."""
    import argparse

    from ..engine.walkers import LocusWalker

    p = argparse.ArgumentParser(description="Pileup")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-R", "--reference", default=None)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("-L", "--intervals", action="append", default=None)
    p.add_argument("--read-filter", action="append", default=[])
    p.add_argument("--disable-read-filter", action="append", default=[])
    args = p.parse_args(argv)

    class PileupWalker(LocusWalker):
        tool_name = "Pileup"

        def on_traversal_start(self):
            self.out = open(args.output, "w")

        def apply(self, contig, pos, bases, quals, mapqs):
            ref_base = "N"
            if self.reference is not None:
                ref_base = self.reference.fetch_bytes(contig, pos, pos + 1).decode().upper()
            base_str = "".join(chr(b) for b in bases)
            qual_str = "".join(chr(min(q, 93) + 33) for q in quals)
            self.out.write(f"{contig} {pos + 1} {ref_base} {len(bases)} {base_str} {qual_str}\n")

        def close_tool(self):
            self.out.close()

    PileupWalker(reads_path=args.input, reference_path=args.reference,
                 intervals=args.intervals, read_filters=args.read_filter,
                 disable_read_filters=args.disable_read_filter).run()
    return 0


@register_tool("PrintVariants")
def print_variants(argv):
    """Copy variants to an output VCF (tools/PrintVariantsSpark.java's
    single-node semantics: read, filter by intervals, write)."""
    import argparse

    p = argparse.ArgumentParser(description="PrintVariants")
    p.add_argument("-V", "--variant", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("-L", "--intervals", action="append", default=None)
    args = p.parse_args(argv)
    from ..engine import intervals as iv
    from ..io import vcf as vcfio

    reader = vcfio.VcfReader(args.variant)
    targets = ([iv.parse_interval(s) for s in args.intervals]
               if args.intervals else None)
    w = vcfio.VcfWriter(args.output, reader.samples,
                        extra_header_lines=reader.header_lines)
    n = 0
    for v in reader:
        if targets is not None and not any(
                v.contig == t.contig and t.start <= v.pos < t.end
                for t in targets):
            continue
        w.write(v)
        n += 1
    w.close()
    print(f"printed {n} variants to {args.output}")
    return 0
