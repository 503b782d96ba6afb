"""VQSR command line tools: gatk_tpu/tools/vqsr_tools.py in the PyTorch port,
with one change: NVScoreVariants takes --device {cuda,cpu} (the CNN runs on
the CUDA device, or on the host).

Reference parity: tools/walkers/vqsr/ApplyVQSR.java (doSiteSpecificFiltering
:~500, generateFilterString :442-466, mode checks via
VariantDataManager.checkVariationClass), VariantRecalibrator.java (GMM training
via VariantRecalibratorEngine/GaussianMixtureModel, tranche computation via
TrancheManager).
"""
from __future__ import annotations

import argparse
import math

import numpy as np

from .. import devices
from ..cli import UserError, register_tool

LOW_VQSLOD = "LOW_VQSLOD"
MIN_ACCEPTABLE_LOD_SCORE = -20000.0


def check_variation_class(v, mode: str) -> bool:
    """VariantDataManager.checkVariationClass(vc, mode)."""
    if mode == "BOTH":
        return True
    is_snp = v.is_snp() or (
        len(v.ref) > 1 and all(len(a) == len(v.ref) for a in v.alts
                               if not a.startswith("<") and a != "*"))  # MNP
    if mode == "SNP":
        return is_snp
    if mode == "INDEL":
        return not is_snp
    raise UserError(f"unknown mode {mode}")


def generate_filter_string(lod: float, tranches, ts_filter_level, vqslod_cutoff):
    if ts_filter_level is not None:
        for i in range(len(tranches) - 1, -1, -1):
            if lod >= tranches[i].min_vqslod:
                return "PASS" if i == len(tranches) - 1 else tranches[i].name
        return tranches[0].name + "+"
    return LOW_VQSLOD if lod < vqslod_cutoff else "PASS"


@register_tool("ApplyVQSR")
def apply_vqsr(argv):
    """Apply a VQSLOD recalibration: annotate VQSLOD/culprit and set tranche filters."""
    from ..engine import intervals as ivx
    from ..gvcf.annotations import format_vcf_double
    from ..io import vcf as vcfio
    from ..vqsr.tranches import read_tranches

    p = argparse.ArgumentParser(description="ApplyVQSR")
    p.add_argument("-V", "--variant", required=True)
    p.add_argument("--recal-file", required=True)
    p.add_argument("--tranches-file", default=None)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("-mode", "--mode", default="SNP")
    p.add_argument("-L", "--intervals", action="append", default=None)
    p.add_argument("--truth-sensitivity-filter-level", "-truth-sensitivity-filter-level",
                   type=float, default=None)
    p.add_argument("--lod-score-cutoff", type=float, default=None)
    p.add_argument("-exclude-filtered", "--exclude-filtered", action="store_true")
    p.add_argument("--ignore-all-filters", action="store_true")
    p.add_argument("--ignore-filter", action="append", default=[])
    args = p.parse_args(argv)

    ts_level = args.truth_sensitivity_filter_level
    vqslod_cutoff = args.lod_score_cutoff
    if ts_level is not None and vqslod_cutoff is not None:
        raise UserError("specify only one of --truth-sensitivity-filter-level / --lod-score-cutoff")

    tranches = []
    if ts_level is not None:
        if args.tranches_file is None:
            raise UserError("--tranches-file required with --truth-sensitivity-filter-level")
        tranches = [t for t in read_tranches(args.tranches_file)
                    if t.target_truth_sensitivity >= ts_level]
        if not tranches:
            raise UserError("No tranches at or above the truth sensitivity filter level")
    elif vqslod_cutoff is None:
        vqslod_cutoff = 0.0

    # recal records keyed by (contig, pos): [(end, lod_str, culprit, pos_label, neg_label)]
    recal = {}
    for rv in vcfio.VcfReader(args.recal_file):
        recal.setdefault((rv.contig, rv.pos), []).append((
            rv.end, rv.info.get("VQSLOD"), rv.info.get("culprit"),
            "POSITIVE_TRAIN_SITE" in rv.info, "NEGATIVE_TRAIN_SITE" in rv.info))

    reader = vcfio.VcfReader(args.variant)
    targets = None
    if args.intervals:
        targets = [ivx.parse_interval(s, {}) for s in args.intervals]

    new_header = [
        '##FILTER=<ID=PASS,Description="Site contains at least one allele that passes filters">',
        '##INFO=<ID=VQSLOD,Number=1,Type=Float,Description="Log odds of being a true variant versus being false under the trained gaussian mixture model">',
        '##INFO=<ID=culprit,Number=1,Type=String,Description="The annotation which was the worst performing in the Gaussian mixture model, likely the reason why the variant was filtered out">',
    ]
    if ts_level is not None:
        for i, t in enumerate(tranches):
            if i < len(tranches) - 1:
                new_header.append(f'##FILTER=<ID={t.name},Description="Truth sensitivity tranche level">')
        new_header.append(f'##FILTER=<ID={tranches[0].name}+,Description="Truth sensitivity above the highest tranche">')
    else:
        new_header.append(f'##FILTER=<ID={LOW_VQSLOD},Description="VQSLOD < {vqslod_cutoff}">')

    ignore_set = set(args.ignore_filter)
    w = vcfio.VcfWriter(args.output, reader.samples,
                        extra_header_lines=reader.header_lines + new_header,
                        write_format=bool(reader.samples))
    n = 0
    for v in reader:
        if targets is not None and not any(
                t.contig == v.contig and t.start <= v.pos < t.end for t in targets):
            continue
        evaluate = check_variation_class(v, args.mode)
        not_filtered = (args.ignore_all_filters or not v.filters
                        or v.filters == ("PASS",)
                        or (ignore_set and set(v.filters) <= ignore_set))
        if evaluate and not_filtered:
            matches = recal.get((v.contig, v.pos), [])
            datum = next((m for m in matches if m[0] == v.end), None)
            if datum is None:
                raise UserError(
                    f"input variant not found in the recal file at {v.contig}:{v.pos + 1}")
            end, lod_str, culprit, pos_label, neg_label = datum
            if lod_str is None:
                raise UserError(f"no VQSLOD in recal record at {v.contig}:{v.pos + 1}")
            lod = float(lod_str)
            info = dict(v.info)
            info["VQSLOD"] = format_vcf_double(lod)
            info["culprit"] = culprit
            if pos_label:
                info["POSITIVE_TRAIN_SITE"] = True
            if neg_label:
                info["NEGATIVE_TRAIN_SITE"] = True
            v.info = {k: info[k] for k in sorted(info)}
            fs = generate_filter_string(lod, tranches, ts_level, vqslod_cutoff)
            v.filters = (fs,) if fs != "." else ()
            if args.exclude_filtered and v.filters not in ((), ("PASS",)):
                continue
        w.write(v)
        n += 1
    w.close()
    print(f"wrote {n} records to {args.output}")
    return 0


def _parse_resources(argv):
    """Extract --resource:name,key=val,... FILE args (Barclay tagged arguments).
    Returns (cleaned_argv, [ {name, known, training, truth, prior, path} ])."""
    out = []
    cleaned = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a.startswith("--resource:") or a.startswith("-resource:"):
            spec = a.split(":", 1)[1]
            parts = spec.split(",")
            res = {"name": parts[0], "known": False, "training": False,
                   "truth": False, "prior": 0.0}
            for kv in parts[1:]:
                k, v = kv.split("=")
                if k == "prior":
                    res["prior"] = float(v)
                else:
                    res[k] = v.lower() == "true"
            res["path"] = argv[i + 1]
            out.append(res)
            i += 2
        else:
            cleaned.append(a)
            i += 1
    return cleaned, out


def _is_transition(ref, alt):
    pairs = {("A", "G"), ("G", "A"), ("C", "T"), ("T", "C")}
    return (ref, alt) in pairs


@register_tool("VariantRecalibrator")
def variant_recalibrator(argv):
    """Train the VQSR Gaussian mixture model and write recal + tranches files."""
    from ..gvcf.annotations import format_vcf_double  # noqa: F401 (parity w/ ApplyVQSR)
    from ..io import vcf as vcfio
    from ..vqsr import gmm
    from ..vqsr.tranches import Tranche, write_tranches

    argv, resources = _parse_resources(list(argv))

    p = argparse.ArgumentParser(description="VariantRecalibrator")
    p.add_argument("-V", "--variant", action="append", required=True)
    p.add_argument("-O", "--output", required=True, help="recal VCF")
    p.add_argument("--tranches-file", required=True)
    p.add_argument("-an", "--use-annotation", action="append", required=True)
    p.add_argument("-mode", "--mode", default="SNP")
    p.add_argument("-tranche", "--truth-sensitivity-tranche", type=float, action="append",
                   default=None)
    p.add_argument("--max-gaussians", type=int, default=8)
    p.add_argument("--max-negative-gaussians", type=int, default=2)
    p.add_argument("--bad-lod-score-cutoff", type=float, default=-5.0)
    p.add_argument("--std-threshold", type=float, default=10.0)
    p.add_argument("--max-iterations", type=int, default=150)
    p.add_argument("--k-means-iterations", type=int, default=100)
    p.add_argument("--rscript-file", default=None,
                   help="write the tranche/annotation plotting script "
                        "(VariantRecalibrator.RECAL_PLOTS) + a rendered .pdf")
    p.add_argument("--output-model", default=None,
                   help="serialize the trained positive/negative GMMs as a "
                        "GATKReport (scattered-training workflows)")
    args = p.parse_args(argv)

    if not any(r["training"] for r in resources):
        raise UserError("No training set found! Add --resource:...,training=true")
    if not any(r["truth"] for r in resources):
        raise UserError("No truth set found! Add --resource:...,truth=true")

    ts_levels = sorted(args.truth_sensitivity_tranche or [100.0, 99.9, 99.0, 90.0])
    annotations = args.use_annotation

    # load resource site maps: (contig, pos, is_snp) -> per-resource flags
    res_sites = []
    for r in resources:
        sites = set()
        for rv in vcfio.VcfReader(r["path"]):
            if rv.filters not in ((), ("PASS",)):
                continue
            sites.add((rv.contig, rv.pos, rv.is_snp()))
        res_sites.append(sites)

    # collect data
    data = []  # dicts: ann (raw), is_null, prior, training, truth, known, variant info
    for path in args.variant:
        for v in vcfio.VcfReader(path):
            if not check_variation_class(v, args.mode):
                continue
            if v.filters not in ((), ("PASS",)):
                continue
            ann = np.zeros(len(annotations))
            is_null = np.zeros(len(annotations), bool)
            for i, key in enumerate(annotations):
                val = v.info.get(key)
                try:
                    ann[i] = float(val)
                    if math.isnan(ann[i]) or math.isinf(ann[i]):
                        is_null[i] = True
                except (TypeError, ValueError):
                    is_null[i] = True
            key3 = (v.contig, v.pos, v.is_snp())
            prior = 2.0
            training = truth = known = False
            for r, sites in zip(resources, res_sites):
                if key3 in sites:
                    if r["training"]:
                        training = True
                        prior = max(prior, r["prior"])
                    truth = truth or r["truth"]
                    known = known or r["known"]
            data.append(dict(v=v, ann=ann, is_null=is_null, prior=prior,
                             training=training, truth=truth, known=known))

    if not data:
        raise UserError("no input variants found for mode " + args.mode)

    rng = np.random.default_rng(47382911)
    train_mask = np.array([d["training"] for d in data])
    raw = np.stack([d["ann"] for d in data])
    nulls = np.stack([d["is_null"] for d in data])

    # normalize over training points (VariantDataManager.normalizeData)
    x = np.empty_like(raw)
    for i in range(len(annotations)):
        tvals = raw[train_mask & ~nulls[:, i], i]
        if len(tvals) == 0:
            raise UserError(f"annotation {annotations[i]} missing for all training variants")
        mean = tvals.mean()
        std = tvals.std(ddof=1) if len(tvals) > 1 else 0.0
        if std < 1e-5:
            raise UserError(f"annotation {annotations[i]} has zero variance")
        x[:, i] = np.where(nulls[:, i], 0.1 * rng.standard_normal(len(data)),
                           (raw[:, i] - mean) / std)
    failing_std = (np.abs(x) > args.std_threshold).any(axis=1)

    # positive model on training data
    good_idx = np.nonzero(train_mask & ~failing_std)[0]
    if len(good_idx) == 0:
        raise UserError("no training variants after standard-deviation thresholding")
    good_model = gmm.train_gmm(x[good_idx], args.max_gaussians,
                               max_iterations=args.max_iterations,
                               kmeans_iterations=args.k_means_iterations)
    lod_good = good_model.evaluate_log10(x)

    # negative model on worst-scoring variants
    anti = (~failing_std) & np.isfinite(lod_good) & (lod_good < args.bad_lod_score_cutoff)
    if anti.sum() < 2:
        order = np.argsort(lod_good)
        anti = np.zeros(len(data), bool)
        anti[order[: max(2, len(data) // 100)]] = True
    bad_model = gmm.train_gmm(x[anti], args.max_negative_gaussians,
                              max_iterations=args.max_iterations,
                              kmeans_iterations=args.k_means_iterations)
    lod_bad = bad_model.evaluate_log10(x)

    # contrastive lod = prior(log10 odds) + good - bad
    prior_q = np.array([d["prior"] for d in data])
    prior_p = 1.0 - 10.0 ** (-prior_q / 10.0)
    prior_log_odds = np.log10(prior_p) - np.log10(1.0 - prior_p)
    lod = prior_log_odds + lod_good - lod_bad
    lod = np.where(np.isneginf(lod_good),
                   MIN_ACCEPTABLE_LOD_SCORE + rng.random(len(lod)) * MIN_ACCEPTABLE_LOD_SCORE,
                   lod)

    # culprit: worst-performing annotation dimension
    good_1d = np.stack([good_model.evaluate_one_dimension_log10(x, i)
                        for i in range(len(annotations))], axis=1)
    bad_1d = np.stack([bad_model.evaluate_one_dimension_log10(x, i)
                       for i in range(len(annotations))], axis=1)
    delta = np.where(nulls, np.inf, good_1d - bad_1d)
    culprit_idx = delta.argmin(axis=1)

    # ---- write recal VCF ----
    header = [
        '##INFO=<ID=END,Number=1,Type=Integer,Description="Stop position of the interval">',
        '##INFO=<ID=VQSLOD,Number=1,Type=Float,Description="Log odds of being a true variant versus being false under the trained gaussian mixture model">',
        '##INFO=<ID=culprit,Number=1,Type=String,Description="The annotation which was the worst performing in the Gaussian mixture model, likely the reason why the variant was filtered out">',
        '##INFO=<ID=POSITIVE_TRAIN_SITE,Number=0,Type=Flag,Description="This variant was used to build the positive training set of good variants">',
        '##INFO=<ID=NEGATIVE_TRAIN_SITE,Number=0,Type=Flag,Description="This variant was used to build the negative training set of bad variants">',
        f'##GATKCommandLine=<ID=VariantRecalibrator,CommandLine="mode={args.mode}">',
    ]
    from ..io.vcf import Variant

    order = sorted(range(len(data)), key=lambda i: (data[i]["v"].contig, data[i]["v"].pos))
    w = vcfio.VcfWriter(args.output, [], extra_header_lines=header, write_format=False)
    for i in order:
        v = data[i]["v"]
        info = {"END": str(v.end), "VQSLOD": f"{lod[i]:.4f}",
                "culprit": annotations[int(culprit_idx[i])]}
        if data[i]["training"]:
            info["POSITIVE_TRAIN_SITE"] = True
        if anti[i]:
            info["NEGATIVE_TRAIN_SITE"] = True
        w.write(Variant(contig=v.contig, pos=v.pos, ref="N", alts=("<VQSR>",),
                        qual=None, filters=(), info=info))
    w.close()

    # ---- tranches (TrancheManager.findTranches with TruthSensitivityMetric) ----
    truth_mask = np.array([d["truth"] for d in data])
    n_truth = int(truth_mask.sum())
    order_lod = np.argsort(-lod, kind="stable")  # decreasing
    sorted_truth = truth_mask[order_lod]
    sorted_lod = lod[order_lod]
    # runningSensitivity[i] = 1 - (#truth among i..end)/nTruth (over increasing-lod
    # ordering in the reference; equivalent computed on the decreasing ordering)
    called_at_truth = np.cumsum(sorted_truth)
    tranches = []
    prev_ts = 0.0
    for ts in ts_levels:
        threshold = 1.0 - ts / 100.0
        # find largest group with sensitivity-miss >= threshold:
        # fraction of truth sites NOT included when keeping top-i variants
        miss = 1.0 - called_at_truth / max(n_truth, 1)
        idx = np.nonzero(miss <= threshold)[0]
        if len(idx) == 0:
            continue
        cut = idx[0]
        min_lod = float(sorted_lod[cut])
        sel = lod >= min_lod
        is_snp_arr = np.array([d["v"].is_snp() for d in data])
        known = np.array([d["known"] for d in data])
        ti = tv = ti_n = tv_n = 0
        for i in np.nonzero(sel & is_snp_arr)[0]:
            v = data[i]["v"]
            trans = _is_transition(v.ref, v.alts[0])
            if known[i]:
                ti += trans
                tv += not trans
            else:
                ti_n += trans
                tv_n += not trans
        name = f"VQSRTranche{args.mode}{prev_ts:.2f}to{ts:.2f}"
        tranches.append(Tranche(
            target_truth_sensitivity=ts,
            num_known=int((sel & known).sum()), num_novel=int((sel & ~known).sum()),
            known_titv=ti / tv if tv else 0.0, novel_titv=ti_n / tv_n if tv_n else 0.0,
            min_vqslod=min_lod, name=name, model=args.mode,
            accessible_truth_sites=n_truth,
            calls_at_truth_sites=int((sel & truth_mask).sum()),
            truth_sensitivity=(sel & truth_mask).sum() / max(n_truth, 1)))
        prev_ts = ts
    write_tranches(args.tranches_file, tranches, args.mode)

    if args.output_model:
        # GATKReport serialization of both GMMs (VariantRecalibrator
        # --output-model; GATKReport tables of per-gaussian mean/covariance,
        # the format VariantRecalibrator re-reads with --input-model)
        from ..recal.report import ReportTable, render_report

        tables = []
        for label, model in (("Positive", good_model), ("Negative", bad_model)):
            t = ReportTable(f"{label}ModelMeans",
                            f"{label} model gaussian means",
                            [("Gaussian", "%d")] + [(a, "%.6f") for a in annotations],
                            sort_by_column=False)
            for kk in range(model.k):
                t.add_row(kk, *[float(m) for m in model.mu[kk]])
            tables.append(t)
            tc = ReportTable(f"{label}ModelCovariances",
                             f"{label} model gaussian covariances",
                             [("Gaussian", "%d"), ("Row", "%s")]
                             + [(a, "%.6f") for a in annotations],
                             sort_by_column=False)
            for kk in range(model.k):
                for ri_ in range(len(annotations)):
                    tc.add_row(kk, annotations[ri_],
                               *[float(c) for c in model.sigma[kk][ri_]])
            tables.append(tc)
        with open(args.output_model, "w") as fh:
            fh.write(render_report(tables))

    if args.rscript_file:
        # the .R script the reference emits for its plots, plus a directly
        # rendered PDF so no R runtime is needed
        with open(args.rscript_file, "w") as fh:
            fh.write("# VariantRecalibrator plots (gatk_tpu)\n"
                     "# tranche plot data embedded below; the companion .pdf\n"
                     "# is rendered directly by the tool.\n")
            fh.write("tranches <- read.csv(textConnection('\n")
            fh.write("targetTruthSensitivity,minVQSLod,numKnown,numNovel\n")
            for t in tranches:
                fh.write(f"{t.target_truth_sensitivity},{t.min_vqslod},"
                         f"{t.num_known},{t.num_novel}\n")
            fh.write("'))\n")
            fh.write("plot(tranches$targetTruthSensitivity, tranches$minVQSLod)\n")
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            fig, axes = plt.subplots(1, 2, figsize=(11, 4.5))
            ts_vals = [t.target_truth_sensitivity for t in tranches]
            axes[0].plot(ts_vals, [t.min_vqslod for t in tranches], "o-")
            axes[0].set_xlabel("target truth sensitivity (%)")
            axes[0].set_ylabel("min VQSLOD")
            axes[0].set_title(f"VQSR tranches ({args.mode})")
            axes[1].bar([str(t) for t in ts_vals],
                        [t.num_known + t.num_novel for t in tranches])
            axes[1].set_xlabel("tranche")
            axes[1].set_ylabel("variants retained")
            fig.tight_layout()
            fig.savefig(args.rscript_file + ".pdf")
            plt.close(fig)
        except Exception:  # pragma: no cover - plotting is best-effort
            pass
    print(f"recalibrated {len(data)} variants; {len(tranches)} tranches -> {args.output}")
    return 0


@register_tool("FilterVariantTranches")
def filter_variant_tranches(argv):
    """Tranche-filter a VCF by an info-key score (e.g. CNN_1D) against truth resources."""
    from ..io import vcf as vcfio

    p = argparse.ArgumentParser(description="FilterVariantTranches")
    p.add_argument("-V", "--variant", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("--resource", action="append", required=True)
    p.add_argument("--info-key", default="CNN_1D")
    p.add_argument("-snp-tranche", "--snp-tranche", type=float, action="append", default=None)
    p.add_argument("-indel-tranche", "--indel-tranche", type=float, action="append", default=None)
    p.add_argument("--invalidate-previous-filters", default="false")
    args = p.parse_args(argv)

    snp_tranches = sorted(set(args.snp_tranche or [99.95]))
    indel_tranches = sorted(set(args.indel_tranche or [99.4]))
    info_key = args.info_key
    remove_old = str(args.invalidate_previous_filters).lower() == "true"

    # resource sites: (contig, pos) -> set of (ref, alt)
    resource_alleles = {}
    for path in args.resource:
        for rv in vcfio.VcfReader(path):
            s = resource_alleles.setdefault((rv.contig, rv.pos), set())
            for a in rv.alts:
                s.add((rv.ref, a))

    reader = vcfio.VcfReader(args.variant)
    records = list(reader)

    snp_scores, indel_scores = [], []
    n_snp = n_indel = 0
    for v in records:
        if info_key not in v.info:
            continue
        score = float(v.info[info_key])
        if v.is_snp():
            n_snp += 1
        elif v.is_indel():
            n_indel += 1
        alleles = resource_alleles.get((v.contig, v.pos))
        if alleles and any((v.ref, a) in alleles for a in v.alts):
            (snp_scores if v.is_snp() else indel_scores).append(score)

    if n_snp == 0 and n_indel == 0:
        raise UserError(f"VCF contains no variants with INFO score key \"{info_key}\"")
    if not snp_scores and not indel_scores:
        raise UserError("Neither SNP nor indel resource contains variants overlapping input.")

    snp_scores.sort(reverse=True)
    indel_scores.sort(reverse=True)
    snp_cutoffs = [snp_scores[int((t / 100.0) * (len(snp_scores) - 1))]
                   for t in snp_tranches] if snp_scores else []
    indel_cutoffs = [indel_scores[int((t / 100.0) * (len(indel_scores) - 1))]
                     for t in indel_tranches] if indel_scores else []

    def tranche_name(kind, t1, t2):
        return f"{info_key}_{kind}_Tranche_{t1:.2f}_{t2:.2f}"

    def filter_string(kind, score, tranches, cutoffs):
        for i in range(len(cutoffs)):
            if score > cutoffs[i] and i > 0:
                return tranche_name(kind, tranches[i - 1], tranches[i])
        return tranche_name(kind, tranches[-1], 100.0)

    new_header = ['##FILTER=<ID=PASS,Description="All filters passed">']
    for kind, tranches in (("SNP", snp_tranches), ("INDEL", indel_tranches)):
        bounds = tranches + [100.0]
        for t1, t2 in zip(bounds, bounds[1:]):
            new_header.append(
                f'##FILTER=<ID={tranche_name(kind, t1, t2)},Description="{kind} truth'
                f' resource sensitivity between {t1:.2f} and {t2:.2f} for info key {info_key}">')

    w = vcfio.VcfWriter(args.output, reader.samples,
                        extra_header_lines=reader.header_lines + new_header,
                        write_format=bool(reader.samples))
    n_filtered = 0
    for v in records:
        filters = () if remove_old else tuple(f for f in v.filters if f != "PASS")
        if info_key in v.info:
            score = float(v.info[info_key])
            if v.is_snp() and snp_cutoffs and score <= snp_cutoffs[0]:
                filters = filters + (filter_string("SNP", score, snp_tranches, snp_cutoffs),)
                n_filtered += 1
            elif v.is_indel() and indel_cutoffs and score <= indel_cutoffs[0]:
                filters = filters + (filter_string("INDEL", score, indel_tranches, indel_cutoffs),)
                n_filtered += 1
        v.filters = filters if filters else ("PASS",)
        w.write(v)
    w.close()
    print(f"filtered {n_filtered} of {len(records)} variants -> {args.output}")
    return 0


@register_tool("NVScoreVariants")
def nv_score_variants(argv):
    """Score variants with a 1D CNN over the reference context + annotations (CNN_1D)."""
    from ..calling import cnn_score as cnn
    from ..io import fasta, vcf as vcfio

    p = argparse.ArgumentParser(description="NVScoreVariants")
    p.add_argument("-V", "--variant", required=True)
    p.add_argument("-R", "--reference", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("--model-weights", default=None,
                   help=".npz (jax) or .pt (the reference's shipped PyTorch "
                        "state_dicts, e.g. 1d_cnn_mix_train_full_bn.pt) weights")
    p.add_argument("--truth-vcf", action="append", default=[],
                   help="truth resource(s); enables on-the-fly training")
    p.add_argument("--save-model-weights", default=None)
    p.add_argument("--epochs", type=int, default=40)
    p.add_argument("--tensor-type", default="reference", choices=["reference"])
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the CNN runs: the CUDA device or the host")
    args = p.parse_args(argv)
    devices.set_default_device(args.device)

    ref = fasta.FastaReference(args.reference)
    reader = vcfio.VcfReader(args.variant)
    records = list(reader)
    if not records:
        raise UserError("no variants to score")

    refs = []
    anns = []
    is_snp = []
    for v in records:
        start = max(0, v.pos - cnn.WINDOW // 2)
        window = ref.fetch_bytes(v.contig, start, start + cnn.WINDOW).decode()
        refs.append(cnn.encode_reference(window))
        anns.append(cnn.encode_annotations(v.info))
        is_snp.append(v.is_snp())
    refs = np.stack(refs)
    anns = np.stack(anns)
    is_snp = np.array(is_snp)

    use_ref_arch = bool(args.model_weights) and args.model_weights.endswith(
        (".pt", ".pth", ".ckpt"))
    if use_ref_arch:
        # reference-compatible GATK_CNN_1D (scorevariants/models/gatk_1d.py):
        # loads the .pt weights GATK ships in resources/large/nvscorevariants/
        from ..calling import nvscore_models as nvm

        params = nvm.load_torch_1d(args.model_weights)
        refs2 = []
        anns2 = []
        for v in records:
            start = max(0, v.pos - nvm.WINDOW // 2)
            window = ref.fetch_bytes(v.contig, start, start + nvm.WINDOW).decode()
            refs2.append(nvm.encode_reference_window(window))
            anns2.append(nvm.encode_best_practices(v.info))
        logits = np.asarray(nvm.forward_1d(params, np.stack(refs2), np.stack(anns2)))
        # score = log-odds of the true class vs its artifact class
        # (SNP vs NOT_SNP, INDEL vs NOT_INDEL)
        scores = np.where(is_snp, logits[:, 0] - logits[:, 1],
                          logits[:, 2] - logits[:, 3])
    elif args.model_weights:
        params = cnn.load_weights(args.model_weights)
    elif args.truth_vcf:
        truth = set()
        for path in args.truth_vcf:
            for rv in vcfio.VcfReader(path):
                for a in rv.alts:
                    truth.add((rv.contig, rv.pos, rv.ref, a))
        labels = []
        for v, snp in zip(records, is_snp):
            good = any((v.contig, v.pos, v.ref, a) in truth for a in v.alts)
            labels.append((0 if good else 1) if snp else (2 if good else 3))
        params = cnn.train(cnn.init_params(), refs, anns, np.array(labels),
                           epochs=args.epochs)
        if args.save_model_weights:
            cnn.save_weights(params, args.save_model_weights)
    else:
        raise UserError("provide --model-weights or --truth-vcf for training")

    if not use_ref_arch:
        scores = cnn.score(params, refs, anns, is_snp)
    header = reader.header_lines + [
        '##INFO=<ID=CNN_1D,Number=1,Type=Float,Description="Log odds of being a true variant versus being false under the trained 1D convolutional neural network">']
    w = vcfio.VcfWriter(args.output, reader.samples,
                        extra_header_lines=header, write_format=bool(reader.samples))
    from ..gvcf.annotations import format_vcf_double

    for v, s in zip(records, scores):
        info = dict(v.info)
        info["CNN_1D"] = format_vcf_double(float(s))
        v.info = {k: info[k] for k in sorted(info)}
        w.write(v)
    w.close()
    print(f"scored {len(records)} variants -> {args.output}")
    return 0
