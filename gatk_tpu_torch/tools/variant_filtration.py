# Copied verbatim from gatk_tpu/tools/variant_filtration.py; only import lines may differ.
"""VariantFiltration: annotate FILTER / FT fields with JEXL-driven filters.

Reference behavior: tools/walkers/filters/VariantFiltration.java (filter
:400-440, getGenotypeFilters :447-462, areClusteredSNPs :474-510,
addMaskIfCoversVariant :384-394, splitMultiAllelics :371-380) with
GATKVariantContextUtils.setFilteredGenotypeToNocall and mutect/filtering/
AlleleFilterUtils.addAlleleAndSiteFilters for --apply-allele-specific-filters.
"""
from __future__ import annotations

import argparse
import bisect

from ..cli import UserError, register_tool
from ..engine import walkers
from ..io import vcf
from .select_variants import (JexlMissing, calculate_chromosome_counts,
                              encode_record, eval_jexl, gt_sep, gt_tokens,
                              is_called, trim_alleles)

CLUSTERED_SNP_FILTER_NAME = "SnpCluster"
SITE_LEVEL_FILTERS = "SITE"


def _load_mask(path):
    """{contig: sorted list of (start0, end0exclusive)} from a VCF or BED."""
    by_contig = {}
    if path.endswith((".bed", ".bed.gz")):
        import gzip

        op = gzip.open if path.endswith(".gz") else open
        with op(path, "rt") as fh:
            for line in fh:
                if line.startswith(("#", "track", "browser")) or not \
                        line.strip():
                    continue
                f = line.split()
                by_contig.setdefault(f[0], []).append((int(f[1]), int(f[2])))
    else:
        for rec in vcf.VcfReader(path):
            by_contig.setdefault(rec.contig, []).append((rec.pos, rec.end))
    for spans in by_contig.values():
        spans.sort()
    return by_contig


def _mask_overlaps(mask, contig, start0, end0, ext):
    spans = mask.get(contig)
    if not spans:
        return False
    lo, hi = start0 - ext, end0 + ext
    i = bisect.bisect_left(spans, (hi, float("inf")))
    for s, e in spans[max(0, i - 64):i]:
        if e > lo and s < hi:
            return True
    return False


@register_tool("VariantFiltration")
def variant_filtration(argv):
    # normalize "--mask:TYPE path" into "--mask path"
    argv = [("--mask" if a.startswith("--mask:") else a) for a in argv]
    p = argparse.ArgumentParser(description="VariantFiltration")
    p.add_argument("-V", "--variant", required=True)
    p.add_argument("-O", "--output", required=True)
    p.add_argument("-R", "--reference", default=None)
    p.add_argument("-L", "--intervals", action="append", default=None)
    p.add_argument("-filter", "--filter-expression", dest="filters",
                   action="append", default=[])
    p.add_argument("-filter-name", "--filter-name", dest="filter_names",
                   action="append", default=[])
    p.add_argument("-G-filter", "--genotype-filter-expression",
                   dest="g_filters", action="append", default=[])
    p.add_argument("-G-filter-name", "--genotype-filter-name",
                   dest="g_filter_names", action="append", default=[])
    p.add_argument("--cluster-size", type=int, default=3)
    p.add_argument("-cluster-window-size", "--cluster-window-size",
                   type=int, default=0)
    p.add_argument("--mask", default=None)
    p.add_argument("-mask-name", "--mask-name", default="Mask")
    p.add_argument("--mask-description", default=None)
    p.add_argument("--mask-extension", type=int, default=0)
    p.add_argument("-filter-not-in-mask", "--filter-not-in-mask",
                   action="store_true")
    p.add_argument("--missing-values-evaluate-as-failing",
                   action="store_true")
    p.add_argument("--invert-filter-expression", action="store_true")
    p.add_argument("--invert-genotype-filter-expression",
                   action="store_true")
    p.add_argument("--set-filtered-genotype-to-no-call", action="store_true")
    p.add_argument("--apply-allele-specific-filters", action="store_true")
    p.add_argument("--invalidate-previous-filters", action="store_true")
    p.add_argument("--add-output-vcf-command-line", default="true")
    args = p.parse_args(argv)
    if args.cluster_size <= 1:
        raise UserError("cluster-size values lower than 2 are not allowed")
    if args.mask_extension < 0:
        raise UserError("mask-extension: negative values are not allowed")
    if args.filter_not_in_mask and args.mask is None:
        raise UserError("filter-not-in-mask requires a mask")
    if len(args.filters) != len(args.filter_names) or \
            len(args.g_filters) != len(args.g_filter_names):
        raise UserError("each filter expression needs a matching name")
    for name in args.filter_names + args.g_filter_names:
        if any(c in name for c in " <>=!"):
            raise UserError(f"invalid filter name: '{name}'")

    w = _VariantFiltrationWalker(variant_path=args.variant,
                                 intervals=args.intervals)
    w.args = args
    w.run()
    return 0


class _VariantFiltrationWalker(walkers.VariantWalker):
    tool_name = "VariantFiltration"
    default_read_filters = ()

    def on_traversal_start(self):
        args = self.args
        rdr = self.variant_reader
        self.mask = _load_mask(args.mask) if args.mask else None
        self.samples = [s for s in rdr.samples if s]
        self.sample_of = {s: i for i, s in enumerate(self.samples)}
        # SNP starts per contig for the cluster scan
        self.snp_starts = {}
        self.records = []
        for v in rdr:
            if v.filters == ("0",):
                v.filters = ("PASS",)
            self.records.append(v)
            if v.is_snp():
                self.snp_starts.setdefault(v.contig, []).append(v.pos)
        hdr = list(rdr.header_lines)
        for name, expr in zip(args.filter_names, args.filters):
            hdr.append(f'##FILTER=<ID={name},Description="{expr}">')
        if args.mask:
            hdr.append(f'##FILTER=<ID={args.mask_name},Description='
                       f'"{args.mask_description or "Overlaps a user-input mask"}">')
        self.writer = vcf.VcfWriter(args.output, self.samples,
                                    extra_header_lines=hdr,
                                    write_format=bool(self.samples))
        self.n = 0

    def _variants(self):
        targets = self.targets if self.intervals_arg else None
        for v in self.records:
            if targets is not None and not any(
                    t.contig == v.contig and v.pos < t.end and v.end > t.start
                    for t in targets):
                continue
            yield v

    # ---- predicates ----

    def _match(self, v, expr, g=None, invert=False):
        try:
            m = eval_jexl(expr, v, g)
        except JexlMissing:
            m = self.args.missing_values_evaluate_as_failing
        return (not m) if invert else m

    def _clustered_snps(self, v):
        args = self.args
        if args.cluster_window_size < 1 or not v.is_snp():
            return False
        starts = self.snp_starts.get(v.contig, [])
        lo = bisect.bisect_left(starts, v.pos - args.cluster_window_size)
        hi = bisect.bisect_right(starts, v.end - 1 + args.cluster_window_size)
        vicinity = starts[lo:hi]
        n = args.cluster_size - 1
        if len(vicinity) < args.cluster_size:
            return False
        first = 0
        while vicinity[first] <= v.pos and first + n < len(vicinity):
            if vicinity[first + n] - vicinity[first] < \
                    args.cluster_window_size:
                return True
            first += 1
        return False

    def _mask_applies(self, contig, start0, end0):
        args = self.args
        overlaps = _mask_overlaps(self.mask, contig, start0, end0,
                                  args.mask_extension)
        return (not overlaps) == args.filter_not_in_mask

    def _genotype_filters(self, v, s):
        args = self.args
        out = []
        ft = s.get("FT")
        if ft not in (None, ".", "PASS"):
            out.extend(ft.split(";"))
        for name, expr in zip(args.g_filter_names, args.g_filters):
            if self._match(v, expr, g=s,
                           invert=args.invert_genotype_filter_expression):
                out.append(name)
        return out

    def _site_filters(self, v, contig, start0, end0, existing):
        """Site filter set for one (possibly allele-split) record."""
        args = self.args
        filters = list(existing)
        if self.mask is not None and args.mask_name not in filters and \
                self._mask_applies(contig, start0, end0):
            filters.append(args.mask_name)
        if self._clustered_snps(v):
            filters.append(CLUSTERED_SNP_FILTER_NAME)
        for name, expr in zip(args.filter_names, args.filters):
            if self._match(v, expr, invert=args.invert_filter_expression):
                filters.append(name)
        return filters

    def apply(self, v):
        args = self.args
        existing = () if args.invalidate_previous_filters else tuple(
            f for f in v.filters if f != "PASS")
        out = vcf.Variant(contig=v.contig, pos=v.pos, ref=v.ref, alts=v.alts,
                          id=v.id, qual=v.qual, filters=v.filters,
                          info=dict(v.info), fmt_keys=v.fmt_keys,
                          samples=[dict(s) for s in v.samples])

        # genotype-level filters (FT) and optional no-calling
        if args.g_filters or args.set_filtered_genotype_to_no_call:
            nocalled = False
            for s in out.samples:
                gt = s.get("GT", ".")
                if not is_called(gt):
                    continue
                ft = self._genotype_filters(v, s)
                if ft:
                    s["FT"] = ";".join(ft)
                else:
                    s.pop("FT", None)  # unfiltered: FT only rendered (as
                    # PASS) when some genotype in the record is filtered
                if ft and args.set_filtered_genotype_to_no_call:
                    sep = gt_sep(gt)
                    s["GT"] = sep.join("." for _ in gt_tokens(gt))
                    nocalled = True
            if nocalled:
                calculate_chromosome_counts(
                    out, self.samples, self.sample_of, remove_stale=True)

        if args.apply_allele_specific_filters:
            allele_filters = []
            for alt in v.alts:
                split = vcf.Variant(contig=v.contig, pos=v.pos, ref=v.ref,
                                    alts=(alt,), info={})
                trim_alleles(split)
                flt = self._site_filters(split, split.contig, split.pos,
                                         split.pos + len(split.ref), ())
                allele_filters.append(flt)
            self._add_allele_and_site_filters(out, v, allele_filters)
        else:
            filters = self._site_filters(v, v.contig, v.pos, v.end, existing)
            out.filters = tuple(dict.fromkeys(filters)) or ("PASS",)
            if args.invalidate_previous_filters and not filters:
                out.filters = ()
        line = encode_record(out, self.samples, self.sample_of)
        self.writer.write_line(line)
        self.n += 1

    def _add_allele_and_site_filters(self, out, v, allele_filters):
        """AlleleFilterUtils.addAlleleAndSiteFilters."""
        args = self.args
        current = []
        raw = str(out.info.get("AS_FilterStatus", ""))
        if raw:
            current = [[x.strip() for x in sec.split(",")]
                       for sec in raw.split("|")]
        if not current or args.invalidate_previous_filters:
            current = [[SITE_LEVEL_FILTERS]] * len(allele_filters)
        updated = []
        for cur, new in zip(current, allele_filters):
            if not new:
                updated.append(cur)
            elif not cur or cur == [SITE_LEVEL_FILTERS]:
                updated.append(list(new))
            else:
                updated.append(list(dict.fromkeys(cur + new)))
        out.info["AS_FilterStatus"] = "|".join(",".join(sec)
                                               for sec in updated)
        site = set(allele_filters[0])
        for flt in allele_filters[1:]:
            site &= set(flt)
        existing = () if args.invalidate_previous_filters else tuple(
            f for f in out.filters if f != "PASS")
        filters = list(existing) + [f for f in allele_filters[0]
                                    if f in site and f not in existing]
        out.filters = tuple(dict.fromkeys(filters))
        if not out.filters and not args.invalidate_previous_filters:
            out.filters = ("PASS",)

    def close_tool(self):
        self.writer.close()
        print(f"filtered {self.n} variants")
