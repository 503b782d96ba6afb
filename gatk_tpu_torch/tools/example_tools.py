# Copied verbatim from gatk_tpu/tools/example_tools.py; only import lines may differ.
"""Example walker tools.

Reference behavior: the examples/ package (ExampleReadWalkerWithReference.java,
ExampleLocusWalker.java, ExampleIntervalWalker.java, ExampleVariantWalker.java,
ExampleTwoPassVariantWalker.java, ExampleFeatureWalker.java,
ExampleReferenceWalker.java, ExampleAssemblyRegionWalker.java) — small runnable
demonstrations of each traversal type, registered as real tools. Here each one
runs on the equivalent gatk_tpu walker base (engine/walkers.py), which also
exercises the walker framework's filter/progress/interval plumbing end-to-end.
"""
from __future__ import annotations

import argparse

from ..cli import register_tool
from ..engine import walkers


def _out(args):
    import sys
    return open(args.output, "w") if args.output else sys.stdout


def _close(fh):
    import sys
    if fh is not sys.stdout:
        fh.close()


@register_tool("ExampleReadWalkerWithReference")
def example_read_walker_with_reference(argv):
    """Print each read with its reference context
    (examples/ExampleReadWalkerWithReference.java on ReadWalker)."""
    p = argparse.ArgumentParser(description="ExampleReadWalkerWithReference")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-R", "--reference", required=True)
    p.add_argument("-L", "--intervals", action="append", default=None)
    p.add_argument("-O", "--output", default=None)
    args = p.parse_args(argv)

    from ..engine.walkers import ReadWalker

    fh = _out(args)

    class W(ReadWalker):
        tool_name = "ExampleReadWalkerWithReference"
        requires_reference = True
        n = 0

        def apply(self, read, ctx):
            ref_bases = ctx.bases().decode()[:20]
            fh.write(f"Read at {ctx.contig}:{read.pos + 1}-{read.end}: "
                     f"{len(read.bases)}bp; ref begins {ref_bases}\n")
            W.n += 1

    w = W(reads_path=args.input, reference_path=args.reference,
          intervals=args.intervals)
    w.run()
    fh.write(f"Processed {W.n} reads\n")
    _close(fh)
    return 0


@register_tool("ExampleLocusWalker")
def example_locus_walker(argv):
    """Per-locus pileup printout (examples/ExampleLocusWalker.java)."""
    p = argparse.ArgumentParser(description="ExampleLocusWalker")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-R", "--reference", default=None)
    p.add_argument("-L", "--intervals", action="append", default=None)
    p.add_argument("-O", "--output", default=None)
    args = p.parse_args(argv)

    from ..engine.walkers import LocusWalker

    fh = _out(args)

    class W(LocusWalker):
        tool_name = "ExampleLocusWalker"

        def apply(self, contig, pos, bases, quals, mapqs):
            fh.write(f"{contig}:{pos + 1} depth={len(bases)} "
                     f"bases={bytes(bases).decode()}\n")

    w = W(reads_path=args.input, reference_path=args.reference,
          intervals=args.intervals)
    w.run()
    _close(fh)
    return 0


@register_tool("ExampleIntervalWalker")
def example_interval_walker(argv):
    """Per-interval printout (examples/ExampleIntervalWalker.java)."""
    p = argparse.ArgumentParser(description="ExampleIntervalWalker")
    p.add_argument("-I", "--input", default=None)
    p.add_argument("-R", "--reference", default=None)
    p.add_argument("-L", "--intervals", action="append", required=True)
    p.add_argument("-O", "--output", default=None)
    args = p.parse_args(argv)

    from ..engine.walkers import IntervalWalker

    fh = _out(args)

    class W(IntervalWalker):
        tool_name = "ExampleIntervalWalker"

        def apply(self, interval):
            fh.write(f"interval {interval.contig}:{interval.start + 1}-"
                     f"{interval.end}\n")

    w = W(reads_path=args.input, reference_path=args.reference,
          intervals=args.intervals)
    w.run()
    _close(fh)
    return 0


@register_tool("ExampleVariantWalker")
def example_variant_walker(argv):
    """Per-variant printout (examples/ExampleVariantWalker.java)."""
    p = argparse.ArgumentParser(description="ExampleVariantWalker")
    p.add_argument("-V", "--variant", required=True)
    p.add_argument("-L", "--intervals", action="append", default=None)
    p.add_argument("-O", "--output", default=None)
    args = p.parse_args(argv)

    from ..engine.walkers import VariantWalker

    fh = _out(args)

    class W(VariantWalker):
        tool_name = "ExampleVariantWalker"

        def apply(self, variant):
            fh.write(f"variant {variant.contig}:{variant.pos + 1} "
                     f"{variant.ref}->{','.join(variant.alts)}\n")

    w = W(variant_path=args.variant, intervals=args.intervals)
    w.run()
    _close(fh)
    return 0


@register_tool("ExampleTwoPassVariantWalker")
def example_two_pass_variant_walker(argv):
    """Two-pass variant traversal: collect QUAL stats on pass 1, annotate
    z-scores on pass 2 (examples/ExampleTwoPassVariantWalker.java)."""
    p = argparse.ArgumentParser(description="ExampleTwoPassVariantWalker")
    p.add_argument("-V", "--variant", required=True)
    p.add_argument("-O", "--output", required=True)
    args = p.parse_args(argv)

    import math

    from ..engine.walkers import TwoPassVariantWalker

    quals = []
    lines = []

    class W(TwoPassVariantWalker):
        tool_name = "ExampleTwoPassVariantWalker"

        def first_pass_apply(self, variant):
            if variant.qual is not None:
                quals.append(float(variant.qual))

        def second_pass_apply(self, variant):
            if not quals or variant.qual is None:
                return
            mean = sum(quals) / len(quals)
            sd = math.sqrt(sum((q - mean) ** 2 for q in quals)
                           / max(1, len(quals) - 1)) or 1.0
            z = (float(variant.qual) - mean) / sd
            lines.append(f"{variant.contig}:{variant.pos + 1}\t"
                         f"QUAL={variant.qual}\tz={z:.3f}")

    w = W(variant_path=args.variant)
    w.run()
    with open(args.output, "w") as fh:
        fh.write("\n".join(lines) + ("\n" if lines else ""))
    return 0


@register_tool("ExampleReferenceWalker")
def example_reference_walker(argv):
    """Walk reference windows counting GC (examples/ExampleReferenceWalker.java)."""
    p = argparse.ArgumentParser(description="ExampleReferenceWalker")
    p.add_argument("-R", "--reference", required=True)
    p.add_argument("-L", "--intervals", action="append", required=True)
    p.add_argument("-O", "--output", default=None)
    args = p.parse_args(argv)

    from ..engine.walkers import ReferenceWalker

    fh = _out(args)

    class W(ReferenceWalker):
        tool_name = "ExampleReferenceWalker"

        def apply(self, ctx):
            bases = ctx.bases()
            gc = sum(1 for b in bases if b in b"GCgc")
            fh.write(f"{ctx.contig}:{ctx.start + 1}-{ctx.end} "
                     f"GC={gc}/{len(bases)}\n")

    w = W(reference_path=args.reference, intervals=args.intervals)
    w.run()
    _close(fh)
    return 0


@register_tool("ExampleFeatureWalker")
def example_feature_walker(argv):
    """Walk features from a feature file (examples/ExampleMultiFeatureWalker
    family on FeatureWalker)."""
    p = argparse.ArgumentParser(description="ExampleFeatureWalker")
    p.add_argument("-F", "--feature", required=True, help="BED or VCF")
    p.add_argument("-O", "--output", default=None)
    args = p.parse_args(argv)

    from ..engine.walkers import FeatureWalker

    fh = _out(args)

    class W(FeatureWalker):
        tool_name = "ExampleFeatureWalker"

        def apply(self, feature):
            fh.write(f"feature {feature}\n")

    w = W(feature_path=args.feature)
    w.run()
    _close(fh)
    return 0


@register_tool("ExampleAssemblyRegionWalker")
def example_assembly_region_walker(argv):
    """Print the active-region decomposition of the input
    (examples/ExampleAssemblyRegionWalker.java): per assembly region, its span
    and read count, using the HC engine's activity profile."""
    p = argparse.ArgumentParser(description="ExampleAssemblyRegionWalker")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-R", "--reference", required=True)
    p.add_argument("-L", "--intervals", action="append", required=True)
    p.add_argument("-O", "--output", default=None)
    args = p.parse_args(argv)

    from ..calling import hc_engine
    from ..engine import intervals as iv
    from ..io import fasta
    from ..io.cram import open_reads

    fh = _out(args)
    ref = fasta.FastaReference(args.reference)
    rd = open_reads(args.input, reference=ref)
    lengths = {s.name: s.length for s in rd.header.sequences}
    engine = hc_engine.HaplotypeCallerEngine(ref)
    n = 0
    for t in iv.parse_intervals_arg(args.intervals, lengths):
        reads = list(rd.query(t.contig, max(0, t.start - 1000), t.end + 1000))
        reads.sort(key=lambda r: (r.pos, r.name))
        usable, spans = engine.plan_interval(reads, t)
        for span in spans:
            in_region = sum(1 for r in usable
                            if r.pos < span.end and r.end > span.start)
            fh.write(f"ACTIVE region {span.contig}:{span.start + 1}-{span.end} "
                     f"reads={in_region}\n")
            n += 1
    fh.write(f"{n} active regions\n")
    _close(fh)
    return 0


@register_tool("ExampleReadWalkerWithVariants")
def example_read_walker_with_variants(argv):
    """Print reads with the variants they overlap
    (examples/ExampleReadWalkerWithVariants.java)."""
    p = argparse.ArgumentParser(description="ExampleReadWalkerWithVariants")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-V", "--variant", required=True)
    p.add_argument("-R", "--reference", default=None)
    p.add_argument("-L", "--intervals", action="append", default=None)
    p.add_argument("-O", "--output", default=None)
    args = p.parse_args(argv)

    from ..engine.walkers import ReadWalker
    from ..io import vcf as vcfio

    fh = _out(args)
    variants = list(vcfio.VcfReader(args.variant))

    class W(ReadWalker):
        tool_name = "ExampleReadWalkerWithVariants"

        def apply(self, read, ctx):
            overlapping = [v for v in variants
                           if v.contig == ctx.contig
                           and read.pos <= v.pos < read.end]
            if overlapping:
                locs = ", ".join(f"{v.contig}:{v.pos + 1}" for v in overlapping)
                fh.write(f"read {read.name} overlaps variants: {locs}\n")

    w = W(reads_path=args.input, reference_path=args.reference,
          intervals=args.intervals)
    w.run()
    _close(fh)
    return 0


@register_tool("ExamplePartialReadWalker")
def example_partial_read_walker(argv):
    """Stop the read traversal after N reads
    (examples/ExamplePartialReadWalker.java on PartialReadWalker)."""
    p = argparse.ArgumentParser(description="ExamplePartialReadWalker")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-O", "--output", default=None)
    p.add_argument("--stop-on-read-count", type=int, default=10)
    args = p.parse_args(argv)

    from ..io import bam as bamio

    fh = _out(args)
    n = 0
    for r in bamio.BamReader(args.input):
        fh.write(f"read {r.name} at {r.pos + 1}\n")
        n += 1
        if n >= args.stop_on_read_count:
            break
    fh.write(f"stopped after {n} reads\n")
    _close(fh)
    return 0


@register_tool("ExampleMultiFeatureWalker")
def example_multi_feature_walker(argv):
    """Merge-walk several feature files in coordinate order
    (examples/ExampleMultiFeatureWalker.java on MultiFeatureWalker)."""
    p = argparse.ArgumentParser(description="ExampleMultiFeatureWalker")
    p.add_argument("-F", "--feature", action="append", required=True)
    p.add_argument("-O", "--output", default=None)
    args = p.parse_args(argv)

    import heapq

    from ..io import vcf as vcfio

    fh = _out(args)
    streams = []
    for i, path in enumerate(args.feature):
        feats = list(vcfio.VcfReader(path))
        streams.append([( (f.contig, f.pos), i, f) for f in feats])
    n = 0
    for (contig_pos, src, f) in heapq.merge(*streams):
        fh.write(f"{contig_pos[0]}:{contig_pos[1] + 1} from input {src}: "
                 f"{f.ref}->{','.join(f.alts)}\n")
        n += 1
    fh.write(f"{n} features from {len(args.feature)} inputs\n")
    _close(fh)
    return 0


@register_tool("ExamplePostTraversalPythonExecutor")
def example_post_traversal_python_executor(argv):
    """Example: walker output post-processed by a spawned python script
    (tools/examples/ExamplePostTraversalPythonExecutor.java — the
    PythonScriptExecutor batch-subprocess boundary, utils/python/
    PythonScriptExecutor.java)."""
    import argparse
    import subprocess
    import sys
    import tempfile

    p = argparse.ArgumentParser(description="ExamplePostTraversalPythonExecutor")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("-P", "--pythonOutputFile", required=True)
    p.add_argument("-L", "--intervals", action="append", default=None)
    args = p.parse_args(argv)

    class _W(walkers.ReadWalker):
        tool_name = "ExamplePostTraversalPythonExecutor"
        default_read_filters = ()

        def on_traversal_start(self):
            self.fh = open(args.output, "w")
            self.contig_of = {s.index: s.name
                              for s in self.reads.header.sequences}

        def apply(self, read, ref_context):
            self.fh.write(
                f"Read at {self.contig_of.get(read.ref_id, '*')}:"
                f"{read.pos + 1}-{read.end}:\n"
                f"{read.bases.tobytes().decode()}\n\n")

        def on_traversal_success(self):
            self.fh.close()
            # the reference ships copyInputFileToOutputFile.py as a resource
            # and execs it via PythonScriptExecutor; same subprocess boundary
            with tempfile.NamedTemporaryFile("w", suffix=".py",
                                             delete=False) as script:
                script.write(
                    "import sys\n"
                    "with open(sys.argv[1]) as src, open(sys.argv[2], 'w') as dst:\n"
                    "    dst.write(src.read())\n")
                path = script.name
            rc = subprocess.run(
                [sys.executable, path, args.output, args.pythonOutputFile]
            ).returncode
            if rc:
                raise RuntimeError(f"python post-processing failed ({rc})")

    _W(reads_path=args.input, intervals=args.intervals).run()
    return 0


@register_tool("ExampleStreamingPythonExecutor")
def example_streaming_python_executor(argv):
    """Example: reads streamed in batches to a persistent python subprocess
    over a FIFO with per-batch acknowledgement (tools/examples/
    ExampleStreamingPythonExecutor.java; utils/python/
    StreamingPythonScriptExecutor.java:46,152-156 data FIFO + ack protocol)."""
    import argparse
    import os as _os
    import subprocess
    import sys
    import tempfile

    p = argparse.ArgumentParser(description="ExampleStreamingPythonExecutor")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("--batchSize", type=int, default=1000)
    p.add_argument("-L", "--intervals", action="append", default=None)
    args = p.parse_args(argv)

    tmpdir = tempfile.mkdtemp(prefix="gatk_tpu_fifo_")
    data_fifo = _os.path.join(tmpdir, "data.fifo")
    ack_fifo = _os.path.join(tmpdir, "ack.fifo")
    _os.mkfifo(data_fifo)
    _os.mkfifo(ack_fifo)
    # persistent consumer: reads length-prefixed batches from the data FIFO,
    # appends to the output, writes one ack byte per batch
    consumer_src = f"""
import sys
out = open({args.output!r}, 'w')
data = open({data_fifo!r}, 'rb')
ack = open({ack_fifo!r}, 'wb')
while True:
    hdr = data.readline()
    if not hdr:
        break
    n = int(hdr)
    if n < 0:
        break
    out.write(data.read(n).decode())
    out.flush()
    ack.write(b'A')
    ack.flush()
out.close()
"""
    proc = subprocess.Popen([sys.executable, "-c", consumer_src])
    data = open(data_fifo, "wb")
    ack = open(ack_fifo, "rb")

    class _W(walkers.ReadWalker):
        tool_name = "ExampleStreamingPythonExecutor"
        default_read_filters = ()

        def on_traversal_start(self):
            self.batch = []
            self.contig_of = {s.index: s.name
                              for s in self.reads.header.sequences}

        def _flush(self):
            if not self.batch:
                return
            payload = "".join(self.batch).encode()
            data.write(str(len(payload)).encode() + b"\n" + payload)
            data.flush()
            assert ack.read(1) == b"A", "python consumer did not acknowledge"
            self.batch = []

        def apply(self, read, ref_context):
            self.batch.append(
                f"Read at {self.contig_of.get(read.ref_id, '*')}:"
                f"{read.pos + 1}-{read.end}:\n"
                f"{read.bases.tobytes().decode()}\n")
            if len(self.batch) >= args.batchSize:
                self._flush()

        def on_traversal_success(self):
            self._flush()
            data.write(b"-1\n")
            data.close()
            ack.close()
            proc.wait(timeout=30)

    _W(reads_path=args.input, intervals=args.intervals).run()
    import shutil

    shutil.rmtree(tmpdir, ignore_errors=True)
    return 0
