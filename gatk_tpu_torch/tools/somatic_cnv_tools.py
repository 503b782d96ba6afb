# Copied verbatim from gatk_tpu/tools/somatic_cnv_tools.py; only import lines and the --device flags of CreateReadCountPanelOfNormals and ModelSegments (somatic_cnv_tools.py:326, :452) differ.
"""Somatic CNV command line tools.

Reference parity: tools/copynumber/{PreprocessIntervals,AnnotateIntervals,
FilterIntervals,CollectAllelicCounts,CreateReadCountPanelOfNormals,
DenoiseReadCounts,ModelSegments,CallCopyRatioSegments}.java. Formats mirror
formats/collections/*.java (SAM-header TSVs).
"""
from __future__ import annotations

import argparse
import math
import os

import numpy as np

from .. import devices
from ..cli import UserError, register_tool
from ..cnv import somatic

NAN = float("nan")


def _read_sequence_dict_header(bam_or_fasta_header_lines):
    return [ln for ln in bam_or_fasta_header_lines if ln.startswith(("@HD", "@SQ"))]


def _dict_header_from_fasta(fasta_path):
    lines = ["@HD\tVN:1.6"]
    fai = fasta_path + ".fai"
    dict_path = os.path.splitext(fasta_path)[0] + ".dict"
    if os.path.exists(dict_path):
        with open(dict_path) as fh:
            return [ln.rstrip("\n") for ln in fh if ln.startswith(("@HD", "@SQ"))]
    if os.path.exists(fai):
        with open(fai) as fh:
            for ln in fh:
                f = ln.split("\t")
                lines.append(f"@SQ\tSN:{f[0]}\tLN:{f[1]}")
    return lines


def _read_intervals_arg(path):
    """Picard interval_list or simple 'contig:start-end' strings file."""
    from ..cnv.cnv_io import read_interval_list

    return read_interval_list(path)


@register_tool("PreprocessIntervals")
def preprocess_intervals(argv):
    """Prepare bins for coverage collection (WGS binning or padded targets)."""
    p = argparse.ArgumentParser(description="PreprocessIntervals")
    p.add_argument("-R", "--reference", required=True)
    p.add_argument("-L", "--intervals", action="append", default=None)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("--bin-length", type=int, default=1000)
    p.add_argument("--padding", type=int, default=250)
    p.add_argument("--interval-merging-rule", default="OVERLAPPING_ONLY")
    args = p.parse_args(argv)

    from ..engine import intervals as ivx
    from ..io import fasta

    ref = fasta.FastaReference(args.reference)
    lengths = {name: ref.contig_length(name) for name in ref.contigs()}

    if args.intervals:
        raw = []
        for s in args.intervals:
            if os.path.exists(s):
                raw.extend((c, st - 1, en) for c, st, en in _read_intervals_arg(s))
            else:
                t = ivx.parse_interval(s, lengths)
                raw.append((t.contig, t.start, t.end))
        # pad and merge overlapping
        padded = [(c, max(0, s - args.padding), min(lengths[c], e + args.padding))
                  for c, s, e in raw]
        padded.sort(key=lambda x: (list(lengths).index(x[0]), x[1]))
        merged = []
        for c, s, e in padded:
            if merged and merged[-1][0] == c and s <= merged[-1][2]:
                merged[-1] = (c, merged[-1][1], max(merged[-1][2], e))
            else:
                merged.append((c, s, e))
    else:
        merged = [(c, 0, lengths[c]) for c in lengths]

    bins = []
    for c, s, e in merged:
        if args.bin_length == 0:
            bins.append((c, s, e))
        else:
            pos = s
            while pos < e:
                bins.append((c, pos, min(pos + args.bin_length, e)))
                pos += args.bin_length
    # drop bins that are all N? (tool filters bins with only N bases)
    out_bins = []
    for c, s, e in bins:
        seq = ref.fetch_bytes(c, s, e)
        if seq.upper().strip(b"N"):
            out_bins.append((c, s, e))

    with open(args.output, "w") as fh:
        fh.write("@HD\tVN:1.6\n")
        for name in lengths:
            fh.write(f"@SQ\tSN:{name}\tLN:{lengths[name]}\n")
        for c, s, e in out_bins:
            fh.write(f"{c}\t{s + 1}\t{e}\t+\t.\n")
    print(f"wrote {len(out_bins)} bins to {args.output}")
    return 0


@register_tool("AnnotateIntervals")
def annotate_intervals(argv):
    """Annotate intervals with GC content (optionally mappability/segdup inputs)."""
    p = argparse.ArgumentParser(description="AnnotateIntervals")
    p.add_argument("-R", "--reference", required=True)
    p.add_argument("-L", "--intervals", required=True)
    p.add_argument("-O", "--output", required=True)
    args = p.parse_args(argv)

    from ..io import fasta

    ref = fasta.FastaReference(args.reference)
    intervals = _read_intervals_arg(args.intervals)
    rows = []
    for c, s1, e1 in intervals:
        seq = ref.fetch_bytes(c, s1 - 1, e1)
        arr = np.frombuffer(seq, np.uint8)
        at = ((arr == ord("A")) | (arr == ord("T"))).sum()
        gc = ((arr == ord("G")) | (arr == ord("C"))).sum()
        frac = gc / max(at + gc, 1)
        rows.append((c, s1, e1, somatic.format_double(frac)))

    header = _dict_header_from_fasta(args.reference)
    somatic.write_sam_tsv(args.output, None,
                          ["CONTIG", "START", "END", "GC_CONTENT"], rows, header)
    print(f"annotated {len(rows)} intervals -> {args.output}")
    return 0


def _read_annotated_intervals(path):
    _s, _h, cols, rows = somatic.read_sam_tsv(path)
    gc_i = cols.index("GC_CONTENT")
    intervals = [(r[0], int(r[1]), int(r[2])) for r in rows]
    gc = np.array([float(r[gc_i]) for r in rows])
    return intervals, gc


def _read_counts_any(path):
    """Counts from TSV or HDF5 (CollectReadCounts --format HDF5 files)."""
    with open(path, "rb") as fh:
        magic = fh.read(8)
    if magic[:4] == b"\x89HDF":
        import h5py

        with h5py.File(path, "r") as f:
            # GATK HDF5 layout: intervals/transposed_index_start_end + counts/values
            if "counts" in f and "values" in f["counts"]:
                counts = np.asarray(f["counts"]["values"][:]).ravel()
                ivg = f["intervals"]
                contig_names = [c.decode() if isinstance(c, bytes) else str(c)
                                for c in ivg["indexed_contig_names"][:]]
                mat = ivg["transposed_index_start_end"][:]
                contigs = [contig_names[int(i)] for i in mat[0]]
                starts = mat[1].astype(int)
                ends = mat[2].astype(int)
                sample = "sample"
                try:
                    sample = f["sample_metadata"]["sample_name"][()]
                    if isinstance(sample, bytes):
                        sample = sample.decode()
                    elif isinstance(sample, np.ndarray):
                        sample = sample.item().decode()
                except Exception:
                    pass
                intervals = list(zip(contigs, starts, ends))
                return sample, [], intervals, counts
            raise UserError(f"unrecognized HDF5 counts layout in {path}")
    sample, header, cols, rows = somatic.read_sam_tsv(path)
    intervals = [(r[0], int(r[1]), int(r[2])) for r in rows]
    counts = np.array([float(r[3]) for r in rows])
    return sample, header, intervals, counts


@register_tool("FilterIntervals")
def filter_intervals(argv):
    """Filter intervals by GC content and count statistics."""
    p = argparse.ArgumentParser(description="FilterIntervals")
    p.add_argument("-L", "--intervals", required=True)
    p.add_argument("--annotated-intervals", default=None)
    p.add_argument("-I", "--input", action="append", default=[], help="counts files")
    p.add_argument("-O", "--output", required=True)
    p.add_argument("--minimum-gc-content", type=float, default=0.1)
    p.add_argument("--maximum-gc-content", type=float, default=0.9)
    p.add_argument("--low-count-filter-count-threshold", type=int, default=5)
    p.add_argument("--low-count-filter-percentage-of-samples", type=float, default=90.0)
    p.add_argument("--extreme-count-filter-minimum-percentile", type=float, default=1.0)
    p.add_argument("--extreme-count-filter-maximum-percentile", type=float, default=99.0)
    p.add_argument("--extreme-count-filter-percentage-of-samples", type=float, default=90.0)
    args = p.parse_args(argv)

    intervals = _read_intervals_arg(args.intervals)
    keep = np.ones(len(intervals), bool)

    if args.annotated_intervals:
        ann_intervals, gc = _read_annotated_intervals(args.annotated_intervals)
        idx = {iv: i for i, iv in enumerate(ann_intervals)}
        for i, iv in enumerate(intervals):
            j = idx.get(iv)
            if j is not None and not (args.minimum_gc_content <= gc[j] <= args.maximum_gc_content):
                keep[i] = False

    if args.input:
        mats = []
        for path in args.input:
            _s, _h, c_intervals, counts = _read_counts_any(path)
            sub = {iv: c for iv, c in zip(c_intervals, counts)}
            mats.append(np.array([sub.get(iv, 0.0) for iv in intervals]))
        m = np.stack(mats)  # samples x intervals
        frac_low = (m < args.low_count_filter_count_threshold).mean(axis=0) * 100
        keep &= frac_low < args.low_count_filter_percentage_of_samples
        # extreme counts per sample (percentiles over currently-kept intervals)
        extreme = np.zeros_like(m, bool)
        for s in range(m.shape[0]):
            vals = m[s][keep]
            if not len(vals):
                continue
            lo = np.percentile(vals, args.extreme_count_filter_minimum_percentile)
            hi = np.percentile(vals, args.extreme_count_filter_maximum_percentile)
            extreme[s] = (m[s] < lo) | (m[s] > hi)
        keep &= extreme.mean(axis=0) * 100 < args.extreme_count_filter_percentage_of_samples

    with open(args.output, "w") as fh:
        with open(args.intervals) as src:
            for ln in src:
                if ln.startswith("@"):
                    fh.write(ln)
        for iv, k in zip(intervals, keep):
            if k:
                fh.write(f"{iv[0]}\t{iv[1]}\t{iv[2]}\t+\t.\n")
    print(f"kept {int(keep.sum())} / {len(intervals)} intervals -> {args.output}")
    return 0


@register_tool("CollectAllelicCounts")
def collect_allelic_counts(argv):
    """Collect ref/alt counts at specified sites (CollectAllelicCounts.java)."""
    p = argparse.ArgumentParser(description="CollectAllelicCounts")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-R", "--reference", required=True)
    p.add_argument("-L", "--intervals", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("--minimum-base-quality", type=int, default=20)
    args = p.parse_args(argv)

    from ..engine import pileup as pileup_mod
    from ..io import bam as bamio, fasta

    ref = fasta.FastaReference(args.reference)
    reader = bamio.BamReader(args.input)
    sample = "SAMPLE"
    for rg in reader.header.read_groups:
        if rg.get("SM"):
            sample = rg["SM"]
            break
    sites = _read_intervals_arg(args.intervals)

    # expand interval sites to per-position list
    positions = []
    for c, s1, e1 in sites:
        for pos in range(s1, e1 + 1):
            positions.append((c, pos))

    rows = []
    base_order = "ACGT"
    for c, pos1 in positions:
        pos0 = pos1 - 1
        ref_base = ref.fetch_bytes(c, pos0, pos0 + 1).decode()
        if ref_base not in base_order:
            continue
        counts = {b: 0 for b in base_order}
        for r in reader.query(c, pos0, pos0 + 1):
            if r.is_unmapped or r.is_duplicate or r.is_secondary:
                continue
            rp, base, qual, flags = pileup_mod.expand_read(r)
            here = rp == pos0
            if not here.any():
                continue
            i = int(np.nonzero(here)[0][0])
            if flags[i] & pileup_mod.F_DELETION or qual[i] < args.minimum_base_quality:
                continue
            b = chr(base[i]).upper()
            if b in counts:
                counts[b] += 1
        ref_count = counts[ref_base]
        alts = {b: n for b, n in counts.items() if b != ref_base}
        alt_base = max(alts, key=lambda b: (alts[b], -base_order.index(b))) if alts else "N"
        alt_count = alts.get(alt_base, 0)
        if alt_count == 0:
            alt_base = "N"
        rows.append((c, pos1, ref_count, alt_count, ref_base, alt_base))

    header = _dict_header_from_fasta(args.reference)
    somatic.write_sam_tsv(args.output, sample,
                          ["CONTIG", "POSITION", "REF_COUNT", "ALT_COUNT",
                           "REF_NUCLEOTIDE", "ALT_NUCLEOTIDE"], rows, header)
    print(f"wrote {len(rows)} allelic counts -> {args.output}")
    return 0


@register_tool("CreateReadCountPanelOfNormals")
def create_read_count_panel_of_normals(argv):
    """Build an SVD panel of normals from normal-sample read counts."""
    p = argparse.ArgumentParser(description="CreateReadCountPanelOfNormals")
    p.add_argument("-I", "--input", action="append", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("--annotated-intervals", default=None)
    p.add_argument("--minimum-interval-median-percentile", type=float, default=10.0)
    p.add_argument("--maximum-zeros-in-sample-percentage", type=float, default=5.0)
    p.add_argument("--maximum-zeros-in-interval-percentage", type=float, default=5.0)
    p.add_argument("--extreme-sample-median-percentile", type=float, default=2.5)
    p.add_argument("--do-impute-zeros", default="true")
    p.add_argument("--extreme-outlier-truncation-percentile", type=float, default=0.1)
    p.add_argument("--number-of-eigensamples", type=int, default=20)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the panel's SVD runs: the CUDA device or the host")
    args = p.parse_args(argv)
    devices.set_default_device(args.device)

    mats = []
    names = []
    intervals0 = None
    for path in args.input:
        sample, _h, intervals, counts = _read_counts_any(path)
        if intervals0 is None:
            intervals0 = intervals
        elif intervals != intervals0:
            raise UserError("input counts files must share identical intervals")
        mats.append(counts)
        names.append(sample or os.path.basename(path))

    gc = None
    if args.annotated_intervals:
        ann_intervals, gc_arr = _read_annotated_intervals(args.annotated_intervals)
        if ann_intervals != intervals0:
            raise UserError("annotated intervals must match counts intervals")
        gc = gc_arr

    pon = somatic.build_panel_of_normals(
        np.stack(mats), intervals0, gc=gc, sample_names=names,
        minimum_interval_median_percentile=args.minimum_interval_median_percentile,
        maximum_zeros_in_sample_percentage=args.maximum_zeros_in_sample_percentage,
        maximum_zeros_in_interval_percentage=args.maximum_zeros_in_interval_percentage,
        extreme_sample_median_percentile=args.extreme_sample_median_percentile,
        do_impute_zeros=args.do_impute_zeros.lower() != "false",
        extreme_outlier_truncation_percentile=args.extreme_outlier_truncation_percentile,
        number_of_eigensamples=args.number_of_eigensamples,
    )
    pon.save_hdf5(args.output)
    print(f"panel of normals with {pon.num_eigensamples} eigensamples over "
          f"{len(pon.panel_interval_idx)} intervals -> {args.output}")
    return 0


@register_tool("DenoiseReadCounts")
def denoise_read_counts(argv):
    """Denoise read counts via the PoN SVD projection (or standardize without one)."""
    p = argparse.ArgumentParser(description="DenoiseReadCounts")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("--count-panel-of-normals", default=None)
    p.add_argument("--annotated-intervals", default=None)
    p.add_argument("--number-of-eigensamples", type=int, default=None)
    p.add_argument("--standardized-copy-ratios", required=True)
    p.add_argument("--denoised-copy-ratios", required=True)
    args = p.parse_args(argv)

    sample, header, intervals, counts = _read_counts_any(args.input)
    dict_header = [ln for ln in header if ln.startswith(("@HD", "@SQ"))] or ["@HD\tVN:1.6"]

    if args.count_panel_of_normals:
        pon = somatic.PanelOfNormals.load_hdf5(args.count_panel_of_normals)
        if pon.original_intervals != intervals:
            raise UserError("sample intervals must match the PoN's original intervals")
        standardized, denoised = somatic.denoise_sample(
            pon, counts, args.number_of_eigensamples)
        out_intervals = [intervals[i] for i in pon.panel_interval_idx]
    else:
        gc = None
        if args.annotated_intervals:
            ann_intervals, gc_arr = _read_annotated_intervals(args.annotated_intervals)
            if ann_intervals != intervals:
                raise UserError("annotated intervals must match counts intervals")
            gc = gc_arr
        standardized = somatic.standardize_sample(counts, gc)
        denoised = standardized.copy()
        out_intervals = intervals

    for path, values in ((args.standardized_copy_ratios, standardized),
                         (args.denoised_copy_ratios, denoised)):
        rows = [(c, s, e, somatic.format_double(v))
                for (c, s, e), v in zip(out_intervals, values)]
        somatic.write_sam_tsv(path, sample,
                              ["CONTIG", "START", "END", "LOG2_COPY_RATIO"],
                              rows, dict_header)
    print(f"denoised {len(out_intervals)} intervals (sample {sample})")
    return 0


def _read_copy_ratios(path):
    sample, header, cols, rows = somatic.read_sam_tsv(path)
    intervals = [(r[0], int(r[1]), int(r[2])) for r in rows]
    log2 = np.array([float(r[3]) for r in rows])
    return sample, header, intervals, log2


def _read_allelic_counts(path):
    sample, header, cols, rows = somatic.read_sam_tsv(path)
    recs = [(r[0], int(r[1]), int(r[2]), int(r[3]), r[4], r[5]) for r in rows]
    return sample, header, recs


def _homozygous_log_ratio(ref_count, alt_count, error_rate):
    from scipy.special import betainc

    n = ref_count + alt_count
    r = ref_count
    beta_all = 1.0
    beta_error = betainc(r + 1, n - r + 1, error_rate)
    beta_one_minus_error = betainc(r + 1, n - r + 1, 1 - error_rate)
    beta_hom = beta_error + beta_all - beta_one_minus_error
    beta_het = beta_one_minus_error - beta_error
    return math.log(max(beta_hom, 1e-300)) - math.log(max(beta_het, 1e-300))


@register_tool("ModelSegments")
def model_segments(argv):
    """Segment denoised copy ratios and allelic counts; estimate segment posteriors."""
    p = argparse.ArgumentParser(description="ModelSegments")
    p.add_argument("--denoised-copy-ratios", default=None)
    p.add_argument("--allelic-counts", default=None)
    p.add_argument("--normal-allelic-counts", default=None)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("--output-prefix", required=True)
    p.add_argument("--minimum-total-allele-count-case", type=int, default=0)
    p.add_argument("--minimum-total-allele-count-normal", type=int, default=30)
    p.add_argument("--genotyping-homozygous-log-ratio-threshold", type=float, default=-10.0)
    p.add_argument("--genotyping-base-error-rate", type=float, default=0.05)
    p.add_argument("--maximum-number-of-segments-per-chromosome", type=int, default=1000)
    p.add_argument("--kernel-variance-copy-ratio", type=float, default=0.0)
    p.add_argument("--kernel-variance-allele-fraction", type=float, default=0.025)
    p.add_argument("--kernel-approximation-dimension", type=int, default=100)
    p.add_argument("--window-size", type=int, action="append", default=None)
    p.add_argument("--number-of-changepoints-penalty-factor", type=float, default=1.0)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the slice-sampling chains run: the CUDA device or the host")
    args = p.parse_args(argv)
    devices.set_default_device(args.device)

    if args.denoised_copy_ratios is None and args.allelic_counts is None:
        raise UserError("must provide --denoised-copy-ratios and/or --allelic-counts")
    os.makedirs(args.output, exist_ok=True)
    prefix = os.path.join(args.output, args.output_prefix)
    windows = tuple(args.window_size or (8, 16, 32, 64, 128, 256))

    sample = None
    dict_header = ["@HD\tVN:1.6"]
    cr_intervals, cr_log2 = [], np.array([])
    if args.denoised_copy_ratios:
        sample, header, cr_intervals, cr_log2 = _read_copy_ratios(args.denoised_copy_ratios)
        dict_header = [ln for ln in header if ln.startswith(("@HD", "@SQ"))] or dict_header

    hets = []
    if args.allelic_counts:
        ac_sample, ac_header, case_counts = _read_allelic_counts(args.allelic_counts)
        sample = sample or ac_sample
        if not args.denoised_copy_ratios:
            dict_header = [ln for ln in ac_header if ln.startswith(("@HD", "@SQ"))] or dict_header
        if args.normal_allelic_counts:
            _ns, _nh, normal_counts = _read_allelic_counts(args.normal_allelic_counts)
            het_sites = set()
            for c, pos, rc, ac, rb, ab in normal_counts:
                if rc + ac < args.minimum_total_allele_count_normal:
                    continue
                if _homozygous_log_ratio(rc, ac, args.genotyping_base_error_rate) \
                        < args.genotyping_homozygous_log_ratio_threshold:
                    het_sites.add((c, pos))
            hets = [r for r in case_counts if (r[0], r[1]) in het_sites]
        else:
            hets = []
            for r in case_counts:
                c, pos, rc, ac, rb, ab = r
                if rc + ac < max(args.minimum_total_allele_count_case, 1):
                    continue
                if _homozygous_log_ratio(rc, ac, args.genotyping_base_error_rate) \
                        < args.genotyping_homozygous_log_ratio_threshold:
                    hets.append(r)

    # ---- segmentation: joint changepoints from CR and AF per contig ----
    seg_kwargs = dict(max_num_changepoints=args.maximum_number_of_segments_per_chromosome,
                      approximation_dim=args.kernel_approximation_dimension,
                      window_sizes=windows,
                      penalty_linear=args.number_of_changepoints_penalty_factor,
                      penalty_log_linear=args.number_of_changepoints_penalty_factor)

    boundaries = {}  # contig -> set of genomic breakpoint positions (1-based start of new segment)
    contig_order = []

    def add_contig(c):
        if c not in boundaries:
            boundaries[c] = set()
            contig_order.append(c)

    if len(cr_log2):
        contigs = [iv[0] for iv in cr_intervals]
        finite = np.isfinite(cr_log2)
        segs = somatic.segment_values(
            [c for c, f in zip(contigs, finite) if f], cr_log2[finite],
            kernel_variance=args.kernel_variance_copy_ratio, **seg_kwargs)
        fin_idx = np.nonzero(finite)[0]
        for c, i0, i1 in segs:
            add_contig(c)
            boundaries[c].add(cr_intervals[fin_idx[i0]][1])
    if hets:
        af = np.array([r[3] / (r[2] + r[3]) for r in hets])
        af_contigs = [r[0] for r in hets]
        segs = somatic.segment_values(
            af_contigs, af, kernel_variance=args.kernel_variance_allele_fraction,
            **seg_kwargs)
        for c, i0, i1 in segs:
            add_contig(c)
            boundaries[c].add(hets[i0][1])

    # ---- build segments and per-segment summaries ----
    segments = []  # (contig, start, end, cr_points(list), af_points(list))
    for c in contig_order:
        cuts = sorted(boundaries[c])
        cr_pts = [(iv[1], iv[2], v) for iv, v in zip(cr_intervals, cr_log2)
                  if iv[0] == c and np.isfinite(v)]
        af_pts = [(r[1], r[2], r[3]) for r in hets if r[0] == c]
        positions = sorted({p for p, *_ in cr_pts} | {p for p, *_ in af_pts})
        if not positions:
            continue
        cuts = [p for p in cuts if p > positions[0]]
        bounds = [positions[0]] + cuts + [positions[-1] + 1]
        for k in range(len(bounds) - 1):
            lo, hi = bounds[k], bounds[k + 1]
            seg_cr = [v for p, e, v in cr_pts if lo <= p < hi]
            seg_af = [(rc, ac) for p, rc, ac in af_pts if lo <= p < hi]
            if not seg_cr and not seg_af:
                continue
            starts = [p for p, e, v in cr_pts if lo <= p < hi] + \
                     [p for p, rc, ac in af_pts if lo <= p < hi]
            ends = [e for p, e, v in cr_pts if lo <= p < hi] + \
                   [p for p, rc, ac in af_pts if lo <= p < hi]
            segments.append((c, min(starts), max(ends), seg_cr, seg_af))

    # ---- posterior sampling (utils/mcmc Gibbs/slice equivalents, jax-native:
    # every segment's parameter slice-steps in parallel per sweep; cnv/mcmc.py) ----
    from ..cnv import mcmc as cnvmcmc

    cr_quantiles = cnvmcmc.sample_copy_ratio_posteriors(
        [seg_cr for _, _, _, seg_cr, _ in segments])
    af_quantiles = cnvmcmc.sample_allele_fraction_posteriors(
        [seg_af for _, _, _, _, seg_af in segments])

    fd = somatic.format_double

    def fmt(x):
        return "NaN" if not np.isfinite(x) else fd(x)

    model_rows = []
    cr_seg_rows = []
    for i, (c, s, e, seg_cr, seg_af) in enumerate(segments):
        c10, c50, c90 = cr_quantiles[i]
        a10, a50, a90 = af_quantiles[i]
        model_rows.append((c, s, e, len(seg_cr), len(seg_af),
                           fmt(c10), fmt(c50), fmt(c90), fmt(a10), fmt(a50), fmt(a90)))
        cr_seg_rows.append((c, s, e, len(seg_cr),
                            fmt(c50 if seg_cr else NAN)))

    model_cols = ["CONTIG", "START", "END", "NUM_POINTS_COPY_RATIO",
                  "NUM_POINTS_ALLELE_FRACTION",
                  "LOG2_COPY_RATIO_POSTERIOR_10", "LOG2_COPY_RATIO_POSTERIOR_50",
                  "LOG2_COPY_RATIO_POSTERIOR_90", "MINOR_ALLELE_FRACTION_POSTERIOR_10",
                  "MINOR_ALLELE_FRACTION_POSTERIOR_50", "MINOR_ALLELE_FRACTION_POSTERIOR_90"]
    somatic.write_sam_tsv(prefix + ".modelBegin.seg", sample, model_cols, model_rows, dict_header)
    somatic.write_sam_tsv(prefix + ".modelFinal.seg", sample, model_cols, model_rows, dict_header)
    somatic.write_sam_tsv(prefix + ".cr.seg", sample,
                          ["CONTIG", "START", "END", "NUM_POINTS_COPY_RATIO",
                           "MEAN_LOG2_COPY_RATIO"], cr_seg_rows, dict_header)
    if args.allelic_counts:
        somatic.write_sam_tsv(prefix + ".hets.tsv", sample,
                              ["CONTIG", "POSITION", "REF_COUNT", "ALT_COUNT",
                               "REF_NUCLEOTIDE", "ALT_NUCLEOTIDE"], hets, dict_header)
    # IGV-compatible outputs (no SAM header)
    with open(prefix + ".cr.igv.seg", "w") as fh:
        fh.write("Sample\tChromosome\tStart\tEnd\tNum_Probes\tSegment_Mean\n")
        for (c, s, e, n_cr, mean) in cr_seg_rows:
            fh.write(f"{sample}\t{c}\t{s}\t{e}\t{n_cr}\t{mean}\n")
    with open(prefix + ".af.igv.seg", "w") as fh:
        fh.write("Sample\tChromosome\tStart\tEnd\tNum_Probes\tSegment_Mean\n")
        for row in model_rows:
            fh.write(f"{sample}\t{row[0]}\t{row[1]}\t{row[2]}\t{row[4]}\t{row[9]}\n")
    # global model parameters (deterministic point estimates across percentiles)
    param_cols = ["PARAMETER_NAME"] + [f"POSTERIOR_{q}" for q in range(10, 100, 10)]
    for suffix, names in ((".cr.param", ["VARIANCE", "OUTLIER_PROBABILITY"]),
                          (".af.param", ["MEAN_BIAS", "BIAS_VARIANCE", "OUTLIER_PROBABILITY"])):
        rows = []
        for name in names:
            if name == "VARIANCE" and len(cr_log2):
                val = float(np.nanvar(cr_log2))
            elif name == "MEAN_BIAS":
                val = 1.0
            elif name == "BIAS_VARIANCE":
                val = 0.05
            else:
                val = 0.02
            rows.append([name] + [fd(val)] * 9)
        for stage in ("modelBegin", "modelFinal"):
            somatic.write_sam_tsv(f"{prefix}.{stage}{suffix}", sample, param_cols, rows,
                                  ["@HD\tVN:1.6"])
    print(f"modeled {len(segments)} segments (prefix {prefix})")
    return 0


@register_tool("CallCopyRatioSegments")
def call_copy_ratio_segments_tool(argv):
    """Call amplification/deletion/neutral on copy-ratio segments."""
    p = argparse.ArgumentParser(description="CallCopyRatioSegments")
    p.add_argument("-I", "--input", required=True, help=".cr.seg file")
    p.add_argument("-O", "--output", required=True)
    p.add_argument("--neutral-segment-copy-ratio-lower-bound", type=float, default=0.9)
    p.add_argument("--neutral-segment-copy-ratio-upper-bound", type=float, default=1.1)
    p.add_argument("--outlier-neutral-segment-copy-ratio-z-score-threshold", type=float, default=2.0)
    p.add_argument("--calling-copy-ratio-z-score-threshold", type=float, default=2.0)
    args = p.parse_args(argv)

    sample, header, cols, rows = somatic.read_sam_tsv(args.input)
    segments = [(r[0], int(r[1]), int(r[2]), int(r[3]), float(r[4])) for r in rows]
    calls = somatic.call_copy_ratio_segments(
        segments,
        neutral_lower=args.neutral_segment_copy_ratio_lower_bound,
        neutral_upper=args.neutral_segment_copy_ratio_upper_bound,
        outlier_z=args.outlier_neutral_segment_copy_ratio_z_score_threshold,
        calling_z=args.calling_copy_ratio_z_score_threshold)

    out_rows = [(c, s, e, n, somatic.format_double(m), call)
                for (c, s, e, n, m), call in zip(segments, calls)]
    somatic.write_sam_tsv(args.output, sample,
                          ["CONTIG", "START", "END", "NUM_POINTS_COPY_RATIO",
                           "MEAN_LOG2_COPY_RATIO", "CALL"], out_rows,
                          [ln for ln in header if ln.startswith(("@HD", "@SQ"))])
    # legacy IGV-style file
    legacy = os.path.splitext(args.output)[0] + ".igv.seg"
    with open(legacy, "w") as fh:
        fh.write("Sample\tChromosome\tStart\tEnd\tNum_Probes\tSegment_Mean\tSegment_Call\n")
        for (c, s, e, n, m, call) in out_rows:
            fh.write(f"{sample}\t{c}\t{s}\t{e}\t{n}\t{m}\t{call}\n")
    print(f"called {len(out_rows)} segments -> {args.output}")
    return 0
