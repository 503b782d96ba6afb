# Copied verbatim from gatk_tpu/funcotator/datasources.py; only import lines may differ.
"""Funcotator data-source factory framework.

Reference behavior: tools/funcotator/dataSources/ — DataSourceUtils.java scans
datasource directories for per-source `.config` files (name/version/type/
src_file keys) and builds one FuncotationFactory per source:
SimpleKeyXsvFuncotationFactory (gene/transcript-keyed tables),
LocatableXsvFuncotationFactory (interval-keyed tables),
VcfFuncotationFactory (allele-matched VCF INFO fields), and
CosmicFuncotationFactory (sqlite; falls back to TSV snapshots). Output fields
are named `<name>_<version>_<column>` per the reference convention.
"""
from __future__ import annotations

import os

from ..cli import UserError


def parse_config(path: str) -> dict:
    conf = {}
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            if "=" in line:
                k, v = line.split("=", 1)
                conf[k.strip()] = v.strip()
    conf["_dir"] = os.path.dirname(os.path.abspath(path))
    return conf


class FuncotationFactory:
    """One annotation source: field names + per-allele annotation lookup
    (tools/funcotator/FuncotationFactory pattern)."""

    name = "?"
    version = "?"

    @property
    def field_names(self) -> list:
        raise NotImplementedError

    def annotate(self, variant, alt: str, gene_symbol: str | None,
                 transcript_id: str | None) -> dict:
        """field -> value for one alt allele (empty strings when no match)."""
        raise NotImplementedError

    def _prefix(self, col: str) -> str:
        return f"{self.name}_{self.version}_{col}"

    def _empty(self):
        return {f: "" for f in self.field_names}


class SimpleKeyXsvFuncotationFactory(FuncotationFactory):
    """dataSources/xsv/SimpleKeyXsvFuncotationFactory.java: rows keyed by gene
    name or transcript id."""

    def __init__(self, conf):
        self.name = conf["name"]
        self.version = conf["version"]
        self.key_kind = conf.get("xsv_key", "GENE_NAME") or "GENE_NAME"
        key_col = int(conf["xsv_key_column"])
        delim = conf.get("xsv_delimiter") or "\t"
        delim = delim.replace("\\t", "\t")
        permissive = (conf.get("xsv_permissive_cols", "") or "false").lower() == "true"
        path = os.path.join(conf["_dir"], conf["src_file"])
        self.rows: dict[str, list] = {}
        with open(path) as fh:
            header = fh.readline().rstrip("\n").split(delim)
            self.columns = [c for i, c in enumerate(header) if i != key_col]
            for line in fh:
                f = line.rstrip("\n").split(delim)
                if len(f) != len(header) and not permissive:
                    continue
                f += [""] * (len(header) - len(f))
                key = f[key_col]
                self.rows.setdefault(key, [x for i, x in enumerate(f) if i != key_col])

    @property
    def field_names(self):
        return [self._prefix(c) for c in self.columns]

    def annotate(self, variant, alt, gene_symbol, transcript_id):
        key = transcript_id if self.key_kind == "TRANSCRIPT_ID" else gene_symbol
        row = self.rows.get(key or "")
        if row is None:
            return self._empty()
        return dict(zip(self.field_names, row))


class LocatableXsvFuncotationFactory(FuncotationFactory):
    """dataSources/xsv/LocatableXsvFuncotationFactory.java: rows keyed by
    (contig, start, end), 1-based inclusive coordinates."""

    def __init__(self, conf):
        self.name = conf["name"]
        self.version = conf["version"]
        delim = (conf.get("xsv_delimiter") or "\t").replace("\\t", "\t")
        ci = int(conf["contig_column"])
        si = int(conf["start_column"])
        ei = int(conf["end_column"])
        self.coord_idx = (ci, si, ei)
        path = os.path.join(conf["_dir"], conf["src_file"])
        self.by_contig: dict[str, list] = {}
        with open(path) as fh:
            header = fh.readline().rstrip("\n").split(delim)
            self.columns = [c for i, c in enumerate(header) if i not in (ci, si, ei)]
            for line in fh:
                f = line.rstrip("\n").split(delim)
                if len(f) < len(header):
                    continue
                try:
                    start, end = int(f[si]), int(f[ei])
                except ValueError:
                    continue
                vals = [x for i, x in enumerate(f) if i not in (ci, si, ei)]
                self.by_contig.setdefault(f[ci], []).append((start, end, vals))
        for c in self.by_contig:
            self.by_contig[c].sort()

    @property
    def field_names(self):
        return [self._prefix(c) for c in self.columns]

    def annotate(self, variant, alt, gene_symbol, transcript_id):
        pos1 = variant.pos + 1
        end1 = variant.pos + len(variant.ref)
        hits = []
        for start, end, vals in self.by_contig.get(variant.contig, []):
            if start > end1:
                break
            if end >= pos1:
                hits.append(vals)
        if not hits:
            return self._empty()
        # multiple overlaps: pipe-joined per column (the reference's behavior)
        return {f: "|".join(h[i] for h in hits)
                for i, f in enumerate(self.field_names)}


class VcfFuncotationFactory(FuncotationFactory):
    """dataSources/vcf/VcfFuncotationFactory.java: exact position+allele match;
    fields are the source's INFO keys plus ID."""

    def __init__(self, conf):
        from ..io import vcf as vcfio

        self.name = conf["name"]
        self.version = conf["version"]
        path = os.path.join(conf["_dir"], conf["src_file"])
        self.records: dict[tuple, list] = {}
        info_keys: list[str] = []
        seen = set()
        for v in vcfio.VcfReader(path):
            self.records.setdefault((v.contig, v.pos), []).append(v)
            for k in v.info:
                if k not in seen:
                    seen.add(k)
                    info_keys.append(k)
        self.info_keys = info_keys

    @property
    def field_names(self):
        return [self._prefix("ID")] + [self._prefix(k) for k in self.info_keys]

    def annotate(self, variant, alt, gene_symbol, transcript_id):
        out = self._empty()
        for rv in self.records.get((variant.contig, variant.pos), []):
            if rv.ref == variant.ref and alt in rv.alts:
                out[self._prefix("ID")] = rv.id if rv.id != "." else ""
                for k in self.info_keys:
                    if k in rv.info:
                        val = rv.info[k]
                        out[self._prefix(k)] = "true" if val is True else str(val)
                break
        return out


class CosmicFuncotationFactory(FuncotationFactory):
    """dataSources/cosmic/CosmicFuncotationFactory.java: sqlite db keyed by gene
    with per-mutation genome positions; reports overlapping-mutation counts."""

    def __init__(self, conf):
        import sqlite3

        self.name = conf["name"]
        self.version = conf["version"]
        path = os.path.join(conf["_dir"], conf["src_file"])
        self.conn = sqlite3.connect(f"file:{path}?mode=ro", uri=True)
        cols = [r[1] for r in self.conn.execute("PRAGMA table_info(Cosmic)")]
        self.gene_col = "Gene name" if "Gene name" in cols else (
            "GENE_NAME" if "GENE_NAME" in cols else cols[0])
        self.pos_col = next((c for c in ("Mutation genome position",
                                         "MUTATION_GENOME_POSITION") if c in cols), None)

    @property
    def field_names(self):
        return [self._prefix("overlapping_mutations")]

    def annotate(self, variant, alt, gene_symbol, transcript_id):
        out = self._empty()
        if not gene_symbol:
            return out
        pos1 = variant.pos + 1
        n = 0
        q = f'SELECT "{self.pos_col}" FROM Cosmic WHERE "{self.gene_col}" = ?' \
            if self.pos_col else None
        if q is None:
            row = self.conn.execute(
                f'SELECT COUNT(*) FROM Cosmic WHERE "{self.gene_col}" = ?',
                (gene_symbol,)).fetchone()
            n = row[0] if row else 0
        else:
            for (gp,) in self.conn.execute(q, (gene_symbol,)):
                # format: contig:start-end
                try:
                    _c, span = str(gp).split(":")
                    lo, hi = (int(x) for x in span.split("-"))
                except (ValueError, AttributeError):
                    continue
                if lo <= pos1 <= hi:
                    n += 1
        out[self._prefix("overlapping_mutations")] = str(n)
        return out


def load_data_sources(paths, ref_version=None):
    """Scan datasource directories for .config files
    (DataSourceUtils.getAndValidateDataSourcesFromPaths). Returns
    (gencode_sources, other_factories)."""
    from . import gencode as gc

    gencode_sources = []
    factories = []
    for root_path in paths:
        for root, _dirs, files in os.walk(root_path):
            for fname in sorted(files):
                if not fname.endswith(".config"):
                    continue
                conf = parse_config(os.path.join(root, fname))
                dtype = conf.get("type", "")
                if ref_version and os.path.basename(root) not in ("", ref_version) \
                        and os.path.basename(root).startswith("hg") \
                        and os.path.basename(root) != ref_version:
                    continue  # skip other builds' configs
                if dtype == "gencode":
                    gencode_sources.append(gc.GencodeDataSource.load(root, ref_version))
                elif dtype == "simpleXSV":
                    factories.append(SimpleKeyXsvFuncotationFactory(conf))
                elif dtype == "locatableXSV":
                    factories.append(LocatableXsvFuncotationFactory(conf))
                elif dtype == "vcf":
                    factories.append(VcfFuncotationFactory(conf))
                elif dtype == "cosmic":
                    factories.append(CosmicFuncotationFactory(conf))
                elif dtype:
                    raise UserError(f"unknown datasource type '{dtype}' in {root}/{fname}")
    return gencode_sources, factories
