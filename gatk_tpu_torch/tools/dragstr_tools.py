# Copied verbatim from gatk_tpu/tools/dragstr_tools.py; only import lines may differ.
"""DRAGstr command line tools: ComposeSTRTableFile + CalibrateDragstrModel.

Reference parity: tools/dragstr/ComposeSTRTableFile.java (reference STR scan
with decimation into an STR table zip), CalibrateDragstrModel.java (per-locus
case sampling from reads, minimum-case gate -> defaults, grid-ML estimation).
"""
from __future__ import annotations

import argparse

from ..cli import register_tool
from ..utils import dragstr


@register_tool("ComposeSTRTableFile")
def compose_str_table_file(argv):
    """Scan the reference for STR loci and compose a decimated STR table file."""
    p = argparse.ArgumentParser(description="ComposeSTRTableFile")
    p.add_argument("-R", "--reference", required=True)
    p.add_argument("-O", "--output", required=True, help="output .zip STR table")
    p.add_argument("-L", "--intervals", action="append", default=None)
    p.add_argument("--decimation", default="DEFAULT")
    args = p.parse_args(argv)

    from ..engine import intervals as ivx
    from ..io import fasta

    ref = fasta.FastaReference(args.reference)
    lengths = {name: ref.contig_length(name) for name in ref.contigs()}
    if args.intervals:
        targets = [ivx.parse_interval(s, lengths) for s in args.intervals]
    else:
        targets = [ivx.Interval(c, 0, lengths[c]) for c in lengths]

    decimation = (dragstr.DEFAULT_DECIMATION if args.decimation == "DEFAULT"
                  else [[0]] if args.decimation == "NONE" else None)
    if decimation is None:
        raise SystemExit(f"unsupported decimation spec: {args.decimation}")

    loci_by_contig = {}
    n = 0
    for t in targets:
        bases = ref.fetch(t.contig, t.start, t.end)
        loci = dragstr.find_str_loci(bases)
        if args.decimation != "NONE":
            loci = dragstr.decimate_loci(loci, decimation)
        shifted = [(s + t.start, p_, r, e + t.start) for (s, p_, r, e) in loci]
        loci_by_contig.setdefault(t.contig, []).extend(shifted)
        n += len(shifted)
    dragstr.write_str_table(args.output, loci_by_contig)
    print(f"wrote {n} STR loci to {args.output}")
    return 0


@register_tool("CalibrateDragstrModel")
def calibrate_dragstr_model(argv):
    """Estimate DRAGstr model parameters (GOP/GCP/API) from read data at STR loci."""
    p = argparse.ArgumentParser(description="CalibrateDragstrModel")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-R", "--reference", required=True)
    p.add_argument("--str-table-path", "-str", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("--parallel", action="store_true")
    p.add_argument("--sampling-min-mq", type=int, default=20)
    p.add_argument("--minimum-depth", type=int, default=10)
    p.add_argument("--sampling-padding", type=int, default=5)
    p.add_argument("--force-estimation", action="store_true")
    args = p.parse_args(argv)

    from ..io import bam as bamio, fasta

    ref = fasta.FastaReference(args.reference)
    reader = bamio.BamReader(args.input)
    loci_by_contig = dragstr.read_str_table(args.str_table_path)

    cases = {}
    n_cases = 0
    for contig, loci in loci_by_contig.items():
        if contig not in ref.contigs():
            continue
        clen = ref.contig_length(contig)
        for (start0, period, repeats, end0) in loci:
            reads = [r for r in reader.query(contig, max(0, start0 - 200), end0 + 200)
                     if not r.is_unmapped and not r.is_duplicate and not r.is_secondary]
            n, k, min_mq, n_sup = dragstr.collect_case(
                reads, clen, start0, end0, args.sampling_padding)
            # qualifyingOnly(minDepth, minMQ, maxSup=0)
            if n < args.minimum_depth or min_mq < args.sampling_min_mq or n_sup > 0:
                continue
            key = (period, min(repeats, dragstr.MAX_REPEATS))
            cases.setdefault(key, []).append((n, k))
            n_cases += 1

    if not args.force_estimation and not dragstr.enough_cases(cases):
        params = dragstr.DragstrParams()
        label = "defaults"
    else:
        params = dragstr.estimate_params(cases)
        label = "estimated" if dragstr.enough_cases(cases) else "estimatedByForce"
    params.write(args.output, [("estimatedOrDefaults", label)])
    print(f"collected {n_cases} qualifying cases; parameters ({label}) -> {args.output}")
    return 0
