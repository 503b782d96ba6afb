# Copied verbatim from gatk_tpu/tools/plotting_tools.py; only import lines may differ.
"""CNV plotting tools (matplotlib equivalents of the reference's R scripts).

Reference behavior: tools/copynumber/plotting/{PlotDenoisedCopyRatios,
PlotModeledSegments}.java driving org/broadinstitute/hellbender/utils/R/
CNVPlottingLibrary.R — scatter of per-interval copy ratios with segment
overlays, one panel per contig concatenated along the genome axis.
"""
from __future__ import annotations

import argparse
import os

from ..cli import register_tool


def _read_tsv_table(path):
    """Read a SAM-header-prefixed TSV (the copy-number formats): returns
    (columns, rows) skipping @-lines and the ## comments."""
    cols, rows = None, []
    with open(path) as fh:
        for line in fh:
            if line.startswith(("@", "##")) or not line.strip():
                continue
            f = line.rstrip("\n").split("\t")
            if cols is None:
                cols = f
            else:
                rows.append(f)
    return cols, rows


def _genome_axis(rows, contig_col, start_col):
    """Concatenate contigs along x; returns (x positions, contig boundaries)."""
    offsets = {}
    offset = 0
    xs = []
    order = []
    for r in rows:
        c = r[contig_col]
        if c not in offsets:
            offsets[c] = None
            order.append(c)
    # contig extent = max end seen
    extents = {c: 0 for c in offsets}
    for r in rows:
        extents[r[contig_col]] = max(extents[r[contig_col]], int(r[start_col + 1]))
    for c in order:
        offsets[c] = offset
        offset += extents[c]
    for r in rows:
        xs.append(offsets[r[contig_col]] + int(r[start_col]))
    bounds = [offsets[c] for c in order[1:]]
    return xs, bounds


@register_tool("PlotDenoisedCopyRatios")
def plot_denoised_copy_ratios(argv):
    """Plot standardized vs denoised log2 copy ratios
    (plotting/PlotDenoisedCopyRatios.java; writes <prefix>.denoised.png and
    the denoising-comparison panel)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    p = argparse.ArgumentParser(description="PlotDenoisedCopyRatios")
    p.add_argument("--standardized-copy-ratios", required=True)
    p.add_argument("--denoised-copy-ratios", required=True)
    p.add_argument("--sequence-dictionary", default=None)
    p.add_argument("-O", "--output", required=True, help="output directory")
    p.add_argument("--output-prefix", required=True)
    args = p.parse_args(argv)
    os.makedirs(args.output, exist_ok=True)
    fig, axes = plt.subplots(2, 1, figsize=(12, 7), sharex=True)
    for ax, path, title in ((axes[0], args.standardized_copy_ratios, "Standardized"),
                            (axes[1], args.denoised_copy_ratios, "Denoised")):
        cols, rows = _read_tsv_table(path)
        ci, si = cols.index("CONTIG"), cols.index("START")
        vi = cols.index("LOG2_COPY_RATIO")
        xs, bounds = _genome_axis(rows, ci, si)
        ys = [float(r[vi]) for r in rows]
        ax.scatter(xs, ys, s=2, c="#2166ac", alpha=0.6, linewidths=0)
        for b in bounds:
            ax.axvline(b, color="0.8", lw=0.5)
        ax.axhline(0.0, color="0.4", lw=0.5)
        ax.set_ylabel("log2 copy ratio")
        ax.set_title(title)
    axes[1].set_xlabel("genomic position")
    out = os.path.join(args.output, args.output_prefix + ".denoised.png")
    fig.tight_layout()
    fig.savefig(out, dpi=110)
    plt.close(fig)
    print(f"wrote {out}")
    return 0


@register_tool("PlotModeledSegments")
def plot_modeled_segments(argv):
    """Plot denoised copy ratios with modeled-segment posterior overlays and the
    allele-fraction track (plotting/PlotModeledSegments.java)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    p = argparse.ArgumentParser(description="PlotModeledSegments")
    p.add_argument("--denoised-copy-ratios", default=None)
    p.add_argument("--allelic-counts", default=None)
    p.add_argument("--segments", required=True, help=".modelFinal.seg")
    p.add_argument("--sequence-dictionary", default=None)
    p.add_argument("-O", "--output", required=True, help="output directory")
    p.add_argument("--output-prefix", required=True)
    args = p.parse_args(argv)
    os.makedirs(args.output, exist_ok=True)
    n_panels = 1 + (args.allelic_counts is not None)
    fig, axes = plt.subplots(n_panels, 1, figsize=(12, 4 * n_panels),
                             sharex=True, squeeze=False)
    ax_cr = axes[0][0]

    scols, srows = _read_tsv_table(args.segments)
    sci, ssi = scols.index("CONTIG"), scols.index("START")
    sxs, bounds = _genome_axis(srows, sci, ssi)

    if args.denoised_copy_ratios:
        cols, rows = _read_tsv_table(args.denoised_copy_ratios)
        ci, si, vi = cols.index("CONTIG"), cols.index("START"), cols.index("LOG2_COPY_RATIO")
        xs, _ = _genome_axis(rows, ci, si)
        ax_cr.scatter(xs, [float(r[vi]) for r in rows], s=2, c="0.6",
                      alpha=0.5, linewidths=0)
    if "LOG2_COPY_RATIO_POSTERIOR_50" in scols:
        v50 = scols.index("LOG2_COPY_RATIO_POSTERIOR_50")
        ei = scols.index("END")
        for x0, r in zip(sxs, srows):
            width = int(r[ei]) - int(r[ssi])
            try:
                y = float(r[v50])
            except ValueError:
                continue
            ax_cr.plot([x0, x0 + width], [y, y], c="#b2182b", lw=2)
    for b in bounds:
        ax_cr.axvline(b, color="0.85", lw=0.5)
    ax_cr.set_ylabel("log2 copy ratio")

    if args.allelic_counts:
        ax_af = axes[1][0]
        cols, rows = _read_tsv_table(args.allelic_counts)
        ci, si = cols.index("CONTIG"), cols.index("POSITION" if "POSITION" in cols else "START")
        refi, alti = cols.index("REF_COUNT"), cols.index("ALT_COUNT")
        xs, _ = _genome_axis([[r[ci], r[si], r[si]] for r in rows], 0, 1)
        afs = []
        for r in rows:
            tot = int(r[refi]) + int(r[alti])
            afs.append(int(r[alti]) / tot if tot else 0.0)
        ax_af.scatter(xs, afs, s=2, c="#2166ac", alpha=0.5, linewidths=0)
        ax_af.set_ylim(0, 1)
        ax_af.set_ylabel("alternate-allele fraction")
        if "MINOR_ALLELE_FRACTION_POSTERIOR_50" in scols:
            v50 = scols.index("MINOR_ALLELE_FRACTION_POSTERIOR_50")
            ei = scols.index("END")
            for x0, r in zip(sxs, srows):
                width = int(r[ei]) - int(r[ssi])
                try:
                    y = float(r[v50])
                except ValueError:
                    continue
                ax_af.plot([x0, x0 + width], [y, y], c="#b2182b", lw=2)
                ax_af.plot([x0, x0 + width], [1 - y, 1 - y], c="#b2182b", lw=2)

    axes[-1][0].set_xlabel("genomic position")
    out = os.path.join(args.output, args.output_prefix + ".modeled.png")
    fig.tight_layout()
    fig.savefig(out, dpi=110)
    plt.close(fig)
    print(f"wrote {out}")
    return 0
