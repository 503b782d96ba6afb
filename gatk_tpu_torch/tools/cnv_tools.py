# Copied verbatim from gatk_tpu/tools/cnv_tools.py; only import lines and the GermlineCNVCaller --device flag (cnv_tools.py:72) differ.
"""CNV command line tools: DetermineGermlineContigPloidy, GermlineCNVCaller,
PostprocessGermlineCNVCalls, CollectReadCounts."""
from __future__ import annotations

import argparse
import os

import numpy as np

from .. import devices
from ..cli import UserError, register_tool
from ..cnv import cnv_io, ploidy as ploidy_mod
from ..io import bam, vcf


@register_tool("DetermineGermlineContigPloidy")
def determine_germline_contig_ploidy(argv):
    """Determine contig-level ploidy from read counts (gcnvkernel ploidy model)."""
    p = argparse.ArgumentParser(description="DetermineGermlineContigPloidy")
    p.add_argument("-I", "--input", action="append", required=True, help="counts TSVs")
    p.add_argument("--contig-ploidy-priors", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("--output-prefix", default="ploidy")
    args = p.parse_args(argv)

    priors = cnv_io.read_ploidy_priors(args.contig_ploidy_priors)
    outdir = os.path.join(args.output, args.output_prefix + "-calls")
    os.makedirs(outdir, exist_ok=True)
    totals_per_sample = {}
    lengths = {}
    names = []
    for path in args.input:
        sample, contigs, starts, ends, counts = cnv_io.read_counts_tsv(path)
        totals = {}
        for c, s, e, n in zip(contigs, starts, ends, counts):
            if c not in priors:
                continue
            totals[c] = totals.get(c, 0) + int(n)
            if c not in lengths:
                lengths[c] = 0
            if sample == (names[0] if names else sample):
                pass
        if not names:
            lengths = {}
            for c, s, e in zip(contigs, starts, ends):
                if c in priors:
                    lengths[c] = lengths.get(c, 0) + int(e - s + 1)
        totals_per_sample[sample] = totals
        names.append(sample)
    results = ploidy_mod.determine_cohort_ploidy(names, totals_per_sample, lengths, priors)
    for sample in names:
        contigs_u, ploidies, gqs, depth = results[sample]
        cnv_io.write_contig_ploidy_calls(outdir, sample, contigs_u, ploidies, gqs, depth, 2.0)
        print(f"{sample}: " + " ".join(f"{c}={p}" for c, p in zip(contigs_u, ploidies)))
    return 0


@register_tool("GermlineCNVCaller")
def germline_cnv_caller(argv):
    """Call copy-number variants via the coherent denoising model (cohort mode)."""
    p = argparse.ArgumentParser(description="GermlineCNVCaller")
    p.add_argument("--run-mode", choices=["COHORT", "CASE"], default="COHORT")
    p.add_argument("-I", "--input", action="append", required=True)
    p.add_argument("--contig-ploidy-calls", required=True)
    p.add_argument("-L", "--intervals", default=None)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("--output-prefix", default="gcnv")
    p.add_argument("--max-copy-number", type=int, default=5)
    p.add_argument("--p-alt", type=float, default=1e-6)
    p.add_argument("--cnv-coherence-length", type=float, default=10000.0)
    p.add_argument("--max-bias-factors", type=int, default=5)
    p.add_argument("--max-rounds", type=int, default=12)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the denoising model and its copy-number HMM run: the "
                        "CUDA kernel, or the plain PyTorch version on the host")
    args = p.parse_args(argv)
    devices.set_default_device(args.device)

    from ..cnv.denoising import DenoisingConfig, GermlineDenoisingModel

    samples = []
    count_rows = []
    key_intervals = None
    contig_list = None
    for path in args.input:
        sample, contigs, starts, ends, counts = cnv_io.read_counts_tsv(path)
        ivs = list(zip(contigs, starts.tolist(), ends.tolist()))
        if key_intervals is None:
            key_intervals = ivs
            contig_list = contigs
        elif ivs != key_intervals:
            raise UserError(f"{path}: intervals differ from first sample")
        samples.append(sample)
        count_rows.append(counts)

    if len(samples) < 2 and args.run_mode == "COHORT":
        print("WARNING: cohort mode with a single sample cannot learn bias factors; "
              "results will be poorly calibrated (use more samples)")
    ploidy_calls, _depths = cnv_io.read_contig_ploidy_calls(args.contig_ploidy_calls)
    counts = np.stack(count_rows)
    S, T = counts.shape
    interval_ploidy = np.zeros((S, T), int)
    for si, s in enumerate(samples):
        # sample naming in ploidy calls may differ (SAMPLE_0 vs SAMPLE_000)
        calls = ploidy_calls.get(s)
        if calls is None:
            alt = {k.replace("_00", "_").replace("_0", "_"): k for k in ploidy_calls}
            k = alt.get(s.replace("_00", "_").replace("_0", "_"))
            calls = ploidy_calls[k] if k else None
        if calls is None:
            raise UserError(f"no ploidy call for sample {s}")
        for ti, (c, _s, _e) in enumerate(key_intervals):
            interval_ploidy[si, ti] = calls.get(c, 2)

    uniq = {c: i for i, c in enumerate(dict.fromkeys(contig_list))}
    contig_ids = np.array([uniq[c] for c in contig_list])
    mids = np.array([(s + e) / 2.0 for _c, s, e in key_intervals])
    distances = np.abs(np.diff(mids))

    cfg = DenoisingConfig(
        max_copy_number=args.max_copy_number, p_alt=args.p_alt,
        cnv_coherence_length=args.cnv_coherence_length,
        max_bias_factors=args.max_bias_factors, max_rounds=args.max_rounds,
    )
    lengths_arr = np.array([e - s + 1 for _c, s, e in key_intervals], float)
    model = GermlineDenoisingModel(counts, interval_ploidy, contig_ids, distances,
                                   interval_lengths=lengths_arr, config=cfg)
    model.fit()
    cn, cnlp, cnq = model.copy_number_calls()

    outdir = os.path.join(args.output, args.output_prefix + "-calls")
    os.makedirs(outdir, exist_ok=True)
    np.save(os.path.join(outdir, "cn.npy"), cn)
    np.save(os.path.join(outdir, "cnlp.npy"), cnlp)
    np.save(os.path.join(outdir, "cnq.npy"), cnq)
    with open(os.path.join(outdir, "samples.txt"), "w") as fh:
        fh.write("\n".join(samples) + "\n")
    with open(os.path.join(outdir, "intervals.tsv"), "w") as fh:
        fh.write("CONTIG\tSTART\tEND\n")
        for c, s, e in key_intervals:
            fh.write(f"{c}\t{s}\t{e}\n")
    n_var = int((cn != interval_ploidy).sum())
    print(f"fit {S} samples x {T} intervals; {n_var} non-baseline interval calls")
    return 0


@register_tool("PostprocessGermlineCNVCalls")
def postprocess_germline_cnv_calls(argv):
    """Write per-interval copy-number VCFs from GermlineCNVCaller output."""
    p = argparse.ArgumentParser(description="PostprocessGermlineCNVCalls")
    p.add_argument("--calls-shard-path", required=True)
    p.add_argument("--sample-index", type=int, required=True)
    p.add_argument("--output-genotyped-intervals", required=True)
    args = p.parse_args(argv)

    d = args.calls_shard_path
    cn = np.load(os.path.join(d, "cn.npy"))
    cnlp = np.load(os.path.join(d, "cnlp.npy"))
    cnq = np.load(os.path.join(d, "cnq.npy"))
    samples = open(os.path.join(d, "samples.txt")).read().split()
    intervals = []
    with open(os.path.join(d, "intervals.tsv")) as fh:
        fh.readline()
        for line in fh:
            c, s, e = line.split("\t")
            intervals.append((c, int(s), int(e)))

    si = args.sample_index
    sample = samples[si]
    header = [
        '##ALT=<ID=DEL,Description="Deletion">',
        '##ALT=<ID=DUP,Description="Duplication">',
        '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
        '##FORMAT=<ID=CN,Number=1,Type=Integer,Description="Copy number">',
        '##FORMAT=<ID=CNLP,Number=.,Type=Integer,Description="Copy number log posterior (phred)">',
        '##FORMAT=<ID=CNQ,Number=1,Type=Integer,Description="Copy number quality">',
        '##INFO=<ID=END,Number=1,Type=Integer,Description="End position">',
    ]
    w = vcf.VcfWriter(args.output_genotyped_intervals, [sample], extra_header_lines=header)
    # baseline CN per interval from the calls themselves: the most common CN per contig
    for ti, (c, s, e) in enumerate(intervals):
        this_cn = int(cn[si, ti])
        # determine baseline (ploidy) as the argmin CNLP==0 state most common on contig
        baseline = int(np.bincount(cn[si, [i for i, iv in enumerate(intervals) if iv[0] == c]]).argmax())
        gt = "0" if this_cn == baseline else ("1" if this_cn < baseline else "2")
        w.write(vcf.Variant(
            contig=c, pos=s - 1, ref="N", alts=("<DEL>", "<DUP>"),
            id=f"CNV_{c}_{s}_{e}", qual=None, filters=(),
            info={"END": str(e)},
            fmt_keys=("GT", "CN", "CNLP", "CNQ"),
            samples=[{
                "GT": gt,
                "CN": str(this_cn),
                "CNLP": ",".join(str(int(x)) for x in cnlp[si, ti]),
                "CNQ": str(int(cnq[si, ti])),
            }],
        ))
    w.close()
    print(f"wrote {len(intervals)} intervals for {sample}")
    return 0


@register_tool("CollectReadCounts")
def collect_read_counts(argv):
    """Count reads per interval into the gCNV counts TSV format."""
    p = argparse.ArgumentParser(description="CollectReadCounts")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-L", "--intervals", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("--format", default="TSV")
    args = p.parse_args(argv)

    intervals = cnv_io.read_interval_list(args.intervals)
    reader = bam.BamReader(args.input)
    sample = reader.header.read_groups[0].get("SM", "SAMPLE") if reader.header.read_groups else "SAMPLE"
    by_contig = {}
    for i, (c, s, e) in enumerate(intervals):
        by_contig.setdefault(c, []).append((s, e, i))
    counts = np.zeros(len(intervals), int)
    for contig, ivs in by_contig.items():
        import bisect

        starts = [s for s, _e, _i in ivs]
        for r in reader.query(contig, 0, None if not ivs else ivs[-1][1]):
            if r.is_unmapped or r.is_duplicate or r.is_secondary or r.is_supplementary or r.mapq < 30:
                continue
            # assign by read start (IntervalCachingOverlapDetector center? GATK
            # counts a read in the interval containing its start)
            k = bisect.bisect_right(starts, r.pos + 1) - 1
            if k >= 0:
                s, e, i = ivs[k]
                if s <= r.pos + 1 <= e:
                    counts[i] += 1
    with open(args.output, "w") as fh:
        for sq in reader.header.sequences:
            fh.write(f"@SQ\tSN:{sq.name}\tLN:{sq.length}\n")
        fh.write(f"@RG\tID:GATKCopyNumber\tSM:{sample}\n")
        fh.write("CONTIG\tSTART\tEND\tCOUNT\n")
        for (c, s, e), n in zip(intervals, counts):
            fh.write(f"{c}\t{s}\t{e}\t{n}\n")
    print(f"wrote counts for {len(intervals)} intervals")
    return 0
