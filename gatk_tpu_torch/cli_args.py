# Copied verbatim from gatk_tpu/cli_args.py; only import lines may differ.
"""Standard argument collections (cmdline/argumentcollections/ equivalents).

Reference behavior: Barclay @ArgumentCollection classes — Required/Optional
ReadInput, ReferenceInput, Interval, Output, Dbsnp — are composed into tools
instead of each tool re-declaring the shared flags. Here each collection is a
function that installs its flags on an argparse parser, plus resolvers that
apply the shared semantics (interval padding / exclusion / set rules:
IntervalArgumentCollection.java)."""
from __future__ import annotations

from .engine.intervals import Interval, parse_intervals_arg


def add_read_input_args(p, required=True):
    """ReadInputArgumentCollection: -I plus read-level knobs."""
    p.add_argument("-I", "--input", action="append", required=required,
                   help="BAM/CRAM/SAM input(s)")
    p.add_argument("--read-index", action="append", default=None,
                   help="explicit index path(s) for the inputs")
    p.add_argument("--read-validation-stringency", default="SILENT",
                   choices=["STRICT", "LENIENT", "SILENT"])
    return p


def add_reference_args(p, required=True):
    """ReferenceInputArgumentCollection: -R."""
    p.add_argument("-R", "--reference", required=required,
                   help="reference FASTA")
    return p


def add_output_args(p, required=True):
    p.add_argument("-O", "--output", required=required, help="output path")
    return p


def add_interval_args(p):
    """IntervalArgumentCollection: -L/-XL with padding and set rules."""
    p.add_argument("-L", "--intervals", action="append", default=None,
                   help="intervals or interval files")
    p.add_argument("-XL", "--exclude-intervals", action="append", default=None,
                   help="intervals to exclude")
    p.add_argument("-ip", "--interval-padding", type=int, default=0)
    p.add_argument("-ixp", "--interval-exclusion-padding", type=int, default=0)
    p.add_argument("-isr", "--interval-set-rule", default="UNION",
                   choices=["UNION", "INTERSECTION"])
    p.add_argument("-imr", "--interval-merging-rule", default="ALL",
                   choices=["ALL", "OVERLAPPING_ONLY"])
    return p


def add_dbsnp_arg(p):
    """DbsnpArgumentCollection: -D/--dbsnp."""
    p.add_argument("-D", "--dbsnp", default=None, help="dbSNP VCF")
    return p


def _merge(intervals, merge_abutting=True):
    out = []
    for iv in sorted(intervals, key=lambda x: (x.contig, x.start, x.end)):
        if out and out[-1].contig == iv.contig and (
                iv.start < out[-1].end or
                (merge_abutting and iv.start == out[-1].end)):
            if iv.end > out[-1].end:
                out[-1] = Interval(iv.contig, out[-1].start, iv.end)
        else:
            out.append(iv)
    return out


def _subtract(intervals, excludes):
    by_contig = {}
    for e in excludes:
        by_contig.setdefault(e.contig, []).append(e)
    out = []
    for iv in intervals:
        pieces = [iv]
        for e in by_contig.get(iv.contig, ()):
            nxt = []
            for piv in pieces:
                if e.end <= piv.start or e.start >= piv.end:
                    nxt.append(piv)
                    continue
                if piv.start < e.start:
                    nxt.append(Interval(piv.contig, piv.start, e.start))
                if e.end < piv.end:
                    nxt.append(Interval(piv.contig, e.end, piv.end))
            pieces = nxt
        out.extend(pieces)
    return out


def resolve_intervals(args, contig_lengths: dict | None = None):
    """IntervalArgumentCollection.getIntervals semantics: parse each -L value
    (UNION merges overlapping/abutting, INTERSECTION intersects across the -L
    values), pad by -ip, then subtract the -ixp-padded -XL set. Returns None
    when no -L was given (whole input)."""
    if not getattr(args, "intervals", None):
        base = None
    else:
        pad = getattr(args, "interval_padding", 0) or 0
        rule = getattr(args, "interval_set_rule", "UNION")
        merge_abutting = getattr(args, "interval_merging_rule", "ALL") == "ALL"
        groups = []
        for value in args.intervals:
            ivs = parse_intervals_arg([value], contig_lengths)
            if pad:
                ivs = [iv.expand(pad, (contig_lengths or {}).get(iv.contig))
                       for iv in ivs]
            groups.append(_merge(ivs, merge_abutting))
        if rule == "INTERSECTION" and len(groups) > 1:
            base = groups[0]
            for g in groups[1:]:
                inter = []
                for a in base:
                    for b in g:
                        if a.contig == b.contig and a.start < b.end and b.start < a.end:
                            inter.append(Interval(a.contig, max(a.start, b.start),
                                                  min(a.end, b.end)))
                base = _merge(inter, merge_abutting)
        else:
            base = _merge([iv for g in groups for iv in g], merge_abutting)
    if getattr(args, "exclude_intervals", None):
        xpad = getattr(args, "interval_exclusion_padding", 0) or 0
        excl = parse_intervals_arg(args.exclude_intervals, contig_lengths)
        if xpad:
            excl = [iv.expand(xpad, (contig_lengths or {}).get(iv.contig))
                    for iv in excl]
        if base is None:
            # no -L: exclusion applies to whole contigs
            if contig_lengths:
                base = [Interval(c, 0, ln) for c, ln in contig_lengths.items()]
            else:
                return None
        base = _subtract(base, _merge(excl))
    return base
