# Copied verbatim from gatk_tpu/engine/walkers.py; only import lines may differ.
"""Walker traversal framework.

Reference: engine/GATKTool.java:726-1125 (lifecycle onStartup →
onTraversalStart → traverse → onTraversalSuccess → closeTool, data-source
initialization order reference → reads → features → intervals) and the
traversal base classes ReadWalker / LocusWalker (via LocusIteratorByState) /
IntervalWalker / VariantWalker (engine/*.java).

Tools subclass a walker, implement apply(), and get for free: reads/reference/
feature wiring, interval handling, the default read-filter stack with
per-filter rejection counts (CountingReadFilter summaries), and ProgressMeter
throughput lines.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..io import vcf as vcfio
from . import filters as filterlib
from .intervals import Interval, parse_interval
from .progress import ProgressMeter


@dataclass
class ReferenceContext:
    """Windowed reference access around the current datum
    (engine/ReferenceContext.java)."""
    reference: object
    contig: str
    start: int
    end: int

    def bases(self, lead: int = 0, trail: int = 0) -> bytes:
        if self.reference is None:
            return b""
        lo = max(0, self.start - lead)
        return self.reference.fetch_bytes(self.contig, lo, self.end + trail)


class GATKTool:
    """Lifecycle template (CommandLineProgram.runTool + GATKTool)."""

    tool_name = "GATKTool"
    requires_reference = False
    default_read_filters = list(filterlib.HC_DEFAULT_FILTER_NAMES)
    progress_unit = "reads"

    def __init__(self, reads_path=None, reference_path=None, intervals=None,
                 variant_path=None, read_filters=(), disable_read_filters=(),
                 min_mapping_quality=None, read_transformers=()):
        self.reads_path = reads_path
        self.reference_path = reference_path
        self.variant_path = variant_path
        self.intervals_arg = intervals
        self.reference = None
        self.reads = None
        self.targets = None
        self.filter_stack = filterlib.build_filter_stack(
            self.default_read_filters, enable=read_filters,
            disable=disable_read_filters, min_mapping_quality=min_mapping_quality)
        # --read-transformer NAME plugins applied before the filter stack
        # (GATKTool.makePreReadFilterTransformer + the transformer registry)
        if read_transformers:
            from . import transformers as trlib

            self.transformer = trlib.compose(
                *[trlib.TRANSFORMER_REGISTRY[n]() if n in trlib.TRANSFORMER_REGISTRY
                  else _unknown_transformer(n) for n in read_transformers])
        else:
            self.transformer = None
        self.progress = ProgressMeter(self.tool_name, unit=self.progress_unit)

    # ---- data-source init (GATKTool.onStartup order :726-751) ----

    def on_startup(self):
        if self.reference_path:
            from ..io import fasta

            self.reference = fasta.FastaReference(self.reference_path)
        elif self.requires_reference:
            raise ValueError(f"{self.tool_name} requires a reference (-R)")
        if self.reads_path:
            from ..io.cram import open_reads

            self.reads = open_reads(self.reads_path, reference=self.reference)
        self._init_intervals()

    def _init_intervals(self):
        if self.reads is not None:
            lengths = {s.name: s.length for s in self.reads.header.sequences}
        elif self.reference is not None:
            lengths = {name: self.reference.contig_length(name)
                       for name in self.reference.index}
        else:
            lengths = {}
        if self.intervals_arg:
            from .intervals import parse_intervals_arg

            self.targets = parse_intervals_arg(self.intervals_arg, lengths)
        else:
            self.targets = [Interval(n, 0, l) for n, l in lengths.items()]

    # ---- template methods ----

    def on_traversal_start(self):
        pass

    def traverse(self):
        raise NotImplementedError

    def on_traversal_success(self):
        pass

    def close_tool(self):
        pass

    def run(self):
        self.on_startup()
        self.on_traversal_start()
        self.progress.start()
        self.traverse()
        self.progress.stop()
        if self.reads is not None:  # CountingReadFilter summary (reads tools)
            for line in self.filter_stack.summary_lines():
                print(line)
        result = self.on_traversal_success()
        self.close_tool()
        return result

    def _reads_over_targets(self):
        if not self.intervals_arg:
            # no -L: stream the whole file incl. the unmapped tail, like
            # GATK's ReadWalker traversal over an unrestricted reads source
            contig_of = {s.index: s.name for s in self.reads.header.sequences}
            for read in self.reads:
                if self.transformer is not None:
                    read = self.transformer(read)
                    if read is None:
                        continue
                if self.filter_stack(read):
                    yield Interval(contig_of.get(read.ref_id, "*"),
                                   max(read.pos, 0), max(read.end, 1)), read
            return
        for target in self.targets:
            for read in self.reads.query(target.contig, target.start, target.end):
                if self.transformer is not None:
                    read = self.transformer(read)
                    if read is None:
                        continue
                if self.filter_stack(read):
                    yield target, read


def _unknown_transformer(name):
    from ..utils.errors import UserError

    raise UserError(f"unknown read transformer: {name}")


class ReadWalker(GATKTool):
    """apply(read, reference_context) per passing read (engine/ReadWalker.java)."""

    def apply(self, read, ref_context: ReferenceContext):
        raise NotImplementedError

    def traverse(self):
        for target, read in self._reads_over_targets():
            ctx = ReferenceContext(self.reference, target.contig, read.pos, read.end)
            self.apply(read, ctx)
            self.progress.update(f"{target.contig}:{read.pos + 1}")


class IntervalWalker(GATKTool):
    """apply(interval) per -L interval (engine/IntervalWalker.java)."""

    progress_unit = "intervals"

    def apply(self, interval: Interval):
        raise NotImplementedError

    def traverse(self):
        for target in self.targets:
            self.apply(target)
            self.progress.update(f"{target.contig}:{target.end}")


class LocusWalker(GATKTool):
    """apply(contig, pos, pileup columns) per covered locus — the
    LocusIteratorByState equivalent built from expanded read matrices
    (engine/LocusWalker.java)."""

    progress_unit = "loci"

    def apply(self, contig: str, pos: int, bases: np.ndarray, quals: np.ndarray,
              mapqs: np.ndarray):
        raise NotImplementedError

    def traverse(self):
        from . import pileup as pileup_mod

        for target in self.targets:
            span = target.end - target.start
            depth_bases: dict[int, list] = {}
            for read in self.reads.query(target.contig, target.start, target.end):
                if not self.filter_stack(read):
                    continue
                pos, base, qual, _flags = pileup_mod.expand_read(read)
                sel = (pos >= target.start) & (pos < target.end)
                for p, b, q in zip(pos[sel], base[sel], qual[sel]):
                    depth_bases.setdefault(int(p), []).append((int(b), int(q), read.mapq))
            for p in sorted(depth_bases):
                rows = depth_bases[p]
                self.apply(target.contig, p,
                           np.array([r[0] for r in rows], np.uint8),
                           np.array([r[1] for r in rows], np.uint8),
                           np.array([r[2] for r in rows], np.int32))
                self.progress.update(f"{target.contig}:{p + 1}")


class VariantWalker(GATKTool):
    """apply(variant) per record of the driving VCF (engine/VariantWalkerBase.java)."""

    progress_unit = "variants"

    def on_startup(self):
        super().on_startup()
        self.variant_reader = vcfio.VcfReader(self.variant_path)
        if not self.targets and not self.intervals_arg:
            self.targets = None

    def apply(self, variant):
        raise NotImplementedError

    def _variants(self):
        targets = self.targets if self.intervals_arg else None
        for v in self.variant_reader:
            if targets is not None and not any(
                    v.contig == t.contig and t.start <= v.pos < t.end for t in targets):
                continue
            yield v

    def traverse(self):
        for v in self._variants():
            self.apply(v)
            self.progress.update(f"{v.contig}:{v.pos + 1}")


class TwoPassVariantWalker(VariantWalker):
    """Two full traversals of the driving VCF: first_pass_apply over every
    record, after_first_pass, then second_pass_apply
    (engine/TwoPassVariantWalker.java — the CNNScoreVariants /
    FilterVariantTranches traversal shape)."""

    def first_pass_apply(self, variant):
        raise NotImplementedError

    def after_first_pass(self):
        pass

    def second_pass_apply(self, variant):
        raise NotImplementedError

    def traverse(self):
        records = []
        for v in self._variants():
            self.first_pass_apply(v)
            records.append(v)
            self.progress.update(f"{v.contig}:{v.pos + 1}")
        self.after_first_pass()
        for v in records:
            self.second_pass_apply(v)
            self.progress.update(f"{v.contig}:{v.pos + 1}")

    def apply(self, variant):  # not used by two-pass traversal
        raise NotImplementedError


class MultiVariantWalker(GATKTool):
    """apply(variant) over the position-sorted union of several VCFs
    (engine/MultiVariantWalker.java — CombineGVCFs/VariantEval shape).
    variant_path may be a list of paths."""

    progress_unit = "variants"

    def on_startup(self):
        super().on_startup()
        paths = (self.variant_path if isinstance(self.variant_path, (list, tuple))
                 else [self.variant_path])
        self.variant_readers = [vcfio.VcfReader(p) for p in paths]

    def apply(self, variant, source_index: int):
        raise NotImplementedError

    def traverse(self):
        import heapq

        targets = self.targets if self.intervals_arg else None
        streams = [iter(r) for r in self.variant_readers]
        heap = []
        for si, s in enumerate(streams):
            v = next(s, None)
            if v is not None:
                heapq.heappush(heap, (v.contig, v.pos, si, id(v), v))
        while heap:
            _, _, si, _, v = heapq.heappop(heap)
            if targets is None or any(
                    v.contig == t.contig and t.start <= v.pos < t.end for t in targets):
                self.apply(v, si)
                self.progress.update(f"{v.contig}:{v.pos + 1}")
            nxt = next(streams[si], None)
            if nxt is not None:
                heapq.heappush(heap, (nxt.contig, nxt.pos, si, id(nxt), nxt))


class FeatureWalker(GATKTool):
    """apply(feature) per record of a driving feature file — VCF or
    BED/interval_list (engine/FeatureWalker.java). The feature source is
    resolved by extension through the tabix/BED feature layer."""

    progress_unit = "features"

    def __init__(self, feature_path=None, **kw):
        super().__init__(**kw)
        self.feature_path = feature_path

    def apply(self, feature):
        raise NotImplementedError

    def _features(self):
        path = self.feature_path
        lower = str(path).lower()
        if lower.endswith((".bed", ".bed.gz", ".interval_list")):
            from .intervals import load_interval_file

            yield from load_interval_file(path)
        else:
            yield from vcfio.VcfReader(path)

    def traverse(self):
        targets = self.targets if self.intervals_arg else None
        for f in self._features():
            contig = getattr(f, "contig", None)
            pos = getattr(f, "pos", getattr(f, "start", 0))
            if targets is not None and not any(
                    contig == t.contig and t.start <= pos < t.end for t in targets):
                continue
            self.apply(f)
            self.progress.update(f"{contig}:{pos + 1}")


class ReferenceWalker(GATKTool):
    """apply(ReferenceContext window) over fixed-size windows of the reference
    (engine/ReferenceWalker.java)."""

    progress_unit = "bases"
    requires_reference = True
    window_size = 10000

    def apply(self, ctx: ReferenceContext):
        raise NotImplementedError

    def traverse(self):
        for target in self.targets:
            for w0 in range(target.start, target.end, self.window_size):
                w1 = min(w0 + self.window_size, target.end)
                self.apply(ReferenceContext(self.reference, target.contig, w0, w1))
                self.progress.update(f"{target.contig}:{w1}")


class PairWalker(ReadWalker):
    """apply(read, mate) per primary read pair (walkers/PairWalker.java:33-137).

    Intervals are padded by --pair-padding (default 1000bp) for the traversal
    so near-boundary mates are picked up, but a pair is only emitted when at
    least one of its reads overlaps an ORIGINAL interval. Unpaired reads,
    secondary/supplementary lines, and end-of-traversal orphans (in-interval
    only) flow through apply_unpaired. Pairs are NOT in strict coordinate
    order (the mate arrives second)."""

    pair_padding = 1000
    default_read_filters = ("WellformedReadFilter", "PrimaryLineReadFilter",
                            "NotDuplicateReadFilter")

    def __init__(self, *args, pair_padding=None, **kwargs):
        super().__init__(*args, **kwargs)
        if pair_padding is not None:
            self.pair_padding = pair_padding
        self._pair_buffer = {}  # name -> (read, in_interval)
        self._unpadded = None

    def _init_intervals(self):
        super()._init_intervals()
        if self.intervals_arg:
            self._unpadded = list(self.targets)
            lengths = ({s.name: s.length for s in self.reads.header.sequences}
                       if self.reads is not None else {})
            # pad within contig, then merge contiguous (transformTraversalIntervals)
            padded = []
            for t in sorted(self.targets, key=lambda t: (t.contig, t.start)):
                start = max(0, t.start - self.pair_padding)
                end = min(lengths.get(t.contig, t.end + self.pair_padding),
                          t.end + self.pair_padding)
                if padded and padded[-1].contig == t.contig and \
                        start <= padded[-1].end + 1:
                    padded[-1] = Interval(t.contig, padded[-1].start,
                                          max(padded[-1].end, end))
                else:
                    padded.append(Interval(t.contig, start, end))
            self.targets = padded

    def _in_interval(self, read):
        if self._unpadded is None:
            return True
        contig_of = {s.index: s.name for s in self.reads.header.sequences}
        contig = contig_of.get(read.ref_id)
        return any(t.contig == contig and read.pos < t.end and read.end > t.start
                   for t in self._unpadded)

    def apply(self, read, ref_context):
        if not read.is_paired or read.is_secondary or read.is_supplementary:
            self.apply_unpaired(read)
            return
        mate = self._pair_buffer.pop(read.name, None)
        if mate is None:
            self._pair_buffer[read.name] = (read, self._in_interval(read))
        elif mate[1] or self._in_interval(read):
            self.apply_pair(mate[0], read)

    def on_traversal_success(self):
        n_unpaired = 0
        for read, in_interval in self._pair_buffer.values():
            if in_interval:
                self.apply_unpaired(read)
                n_unpaired += 1
        if n_unpaired:
            print(f"There were {n_unpaired} incomplete pairs.")
        self._pair_buffer.clear()

    def apply_pair(self, read, mate):
        raise NotImplementedError

    def apply_unpaired(self, read):
        pass
