# Copied verbatim from gatk_tpu/io/vcf.py; only import lines may differ.
"""VCF reader/writer (htsjdk VariantContext + VCFWriter equivalents).

Reference behavior: htsjdk VCF codecs as used by engine/FeatureDataSource.java:68 and
utils/variant/writers/. Text VCF (plain or bgzf/gzip), VCFv4.2 output formatting
compatible with GATK's writer (QUAL with trailing .00 trimmed, GT first, etc.).
"""
from __future__ import annotations

import gzip
import math
import os
from dataclasses import dataclass, field

from . import bgzf


@dataclass
class Variant:
    contig: str
    pos: int  # 0-based
    ref: str
    alts: tuple
    id: str = "."
    qual: float | None = None
    filters: tuple = ()  # () = unfiltered ('.'); ('PASS',) = pass
    info: dict = field(default_factory=dict)
    samples: list = field(default_factory=list)  # list of per-sample dicts
    fmt_keys: tuple = ()

    @property
    def alleles(self):
        return (self.ref,) + tuple(self.alts)

    @property
    def end(self) -> int:
        if "END" in self.info:
            return int(self.info["END"])
        return self.pos + len(self.ref)

    def is_snp(self):
        return len(self.ref) == 1 and all(len(a) == 1 and a != "*" and not a.startswith("<") for a in self.alts)

    def is_indel(self):
        return any(len(a) != len(self.ref) for a in self.alts if not a.startswith("<") and a != "*")


def _parse_info(s: str) -> dict:
    if s == ".":
        return {}
    out = {}
    for item in s.split(";"):
        if "=" in item:
            k, v = item.split("=", 1)
            out[k] = v
        else:
            out[item] = True
    return out


class VcfReader:
    def __init__(self, path: str):
        from .gatk_path import resolve

        path = resolve(path)  # file:// and mirrored cloud URIs (GATKPath)
        self.path = path
        with open(path, "rb") as fh:
            head = fh.read(4)
        if head[:2] == b"\x1f\x8b":
            try:
                text = bgzf.decompress_file(path).decode()
            except ValueError:
                with gzip.open(path, "rt") as fh:
                    text = fh.read()
        else:
            with open(path, "rt") as fh:
                text = fh.read()
        self.header_lines = []
        self.samples = []
        self._body = []
        for line in text.splitlines():
            if line.startswith("##"):
                self.header_lines.append(line)
            elif line.startswith("#CHROM"):
                # tolerate a trailing tab (empty trailing sample column)
                cols = line.rstrip("\t").split("\t")
                self.samples = cols[9:]
                self._chrom_line = line
            elif line:
                self._body.append(line)

    def __iter__(self):
        for line in self._body:
            yield parse_vcf_line(line)

    def _parse_line(self, line: str) -> Variant:
        return parse_vcf_line(line)


def iter_vcf_features(path: str, intervals=None, pad: int = 0):
    """Yield Variants from a VCF resource, using the .tbi index when both an
    index and target intervals are available (the FeatureDataSource pattern,
    engine/FeatureDataSource.java:68: only BGZF blocks overlapping the
    intervals are decompressed — required for gnomAD-scale resources). Falls
    back to streaming the whole file otherwise.

    intervals: iterable of objects with .contig/.start/.end (0-based
    half-open), or (contig, start, end) tuples. pad expands each interval."""
    import os as _os

    if intervals is not None and _os.path.exists(path + ".tbi"):
        from .tabix import TabixReader

        rd = TabixReader(path)
        seen = set()
        for t in intervals:
            contig, start, end = (
                (t.contig, t.start, t.end) if hasattr(t, "contig") else t
            )
            for fields in rd.query(contig, max(0, start - pad), end + pad):
                v = parse_vcf_line("\t".join(fields))
                key = (v.contig, v.pos, v.ref, tuple(v.alts))
                if key in seen:
                    continue
                seen.add(key)
                yield v
        return
    yield from VcfReader(path)


def parse_vcf_line(line: str) -> Variant:
        # tolerate trailing tabs (empty trailing sample columns in hand-made VCFs)
        f = line.rstrip("\t").split("\t")
        chrom, pos, vid, ref, alt, qual, flt, info = f[:8]
        v = Variant(
            contig=chrom,
            pos=int(pos) - 1,
            ref=ref,
            alts=tuple(alt.split(",")) if alt != "." else (),
            id=vid,
            qual=None if qual == "." else float(qual),
            filters=() if flt == "." else tuple(flt.split(";")),
            info=_parse_info(info),
        )
        if len(f) > 9:
            v.fmt_keys = tuple(f[8].split(":"))
            for scol in f[9:]:
                vals = scol.split(":")
                v.samples.append({k: (vals[i] if i < len(vals) else ".") for i, k in enumerate(v.fmt_keys)})
        return v


def format_qual(q) -> str:
    """GATK/htsjdk QUAL formatting: 2 decimals, trailing '.00' dropped."""
    if q is None:
        return "."
    if q == 0:
        q = 0.0  # avoid "-0"
    s = f"{q:.2f}"
    if s.endswith(".00"):
        return s[:-3]
    return s


class VcfWriter:
    VERSION = "VCFv4.2"

    def __init__(self, path: str, sample_names, contigs=None, extra_header_lines=(), write_format=True):
        """contigs: list of (name, length) for ##contig lines."""
        self.path = path
        self.samples = list(sample_names)
        self._lines = [f"##fileformat={self.VERSION}"]
        self._lines.extend(extra_header_lines)
        if contigs:
            for name, length in contigs:
                self._lines.append(f"##contig=<ID={name},length={length}>")
        cols = ["#CHROM", "POS", "ID", "REF", "ALT", "QUAL", "FILTER", "INFO"]
        if self.samples or write_format:
            cols.append("FORMAT")
            cols.extend(self.samples)
        self._lines.append("\t".join(cols))

    def write(self, v: Variant):
        self._lines.append(variant_to_line(v))

    def write_line(self, line: str):
        """Append an already-formatted data line (checkpoint resume path)."""
        self._lines.append(line.rstrip("\n"))

    def close(self):
        payload = ("\n".join(self._lines) + "\n").encode()
        if self.path.endswith(".gz"):
            with open(self.path, "wb") as fh:
                fh.write(bgzf.compress_bytes(payload))
        else:
            with open(self.path, "wb") as fh:
                fh.write(payload)


def variant_to_line(v: Variant) -> str:
    """Serialize a Variant to a VCF data line (VcfWriter record format)."""
    info = ";".join(
        k if val is True else f"{k}={val}" for k, val in v.info.items()
    ) or "."
    row = [
        v.contig,
        str(v.pos + 1),
        v.id or ".",
        v.ref,
        ",".join(v.alts) if v.alts else ".",
        format_qual(v.qual),
        ";".join(v.filters) if v.filters else ".",
        info,
    ]
    if v.samples:
        row.append(":".join(v.fmt_keys))
        for s in v.samples:
            vals = [str(s.get(k, ".")) for k in v.fmt_keys]
            # htsjdk drops trailing missing fields (but always keeps GT)
            while len(vals) > 1 and vals[-1] == ".":
                vals.pop()
            row.append(":".join(vals))
    return "\t".join(row)
