# Copied verbatim from gatk_tpu/engine/transformers.py; only import lines may differ.
"""Read transformers — in-place/functional read rewrites applied pre-filter.

Reference: transformers/*.java (ReadTransformer interface plus the standard
set). Each transformer here is a function Read -> Read (possibly the same
object), composable with `compose`. The registry mirrors the read-filter
plugin registry (engine/filters.py) so tools can accept
--read-transformer NAME.

Ported behaviors:
- IUPACReadTransformer.java:31-42 (non-ACGT -> N, strict mode raises)
- PalindromeArtifactClipReadTransformer.java:60-130 (FFPE/end-repair
  palindrome artifact hard-clip when the reference upstream of the adaptor
  boundary reverse-complement-matches the soft-clipped read end)
- MisencodedBaseQualityReadTransformer.java (Illumina 1.5 -> 1.8: qual - 31)
- StripMateNumberTransformer.java (strip /1, /2 suffixes)
- MappingQualityReadTransformer.java (remap one mapq value to another)
- DRAGENMappingQualityReadTransformer.java (mapq 255 -> 60)
"""
from __future__ import annotations

import numpy as np

from ..utils.errors import UserError
from . import clipping

# IUPAC ambiguity codes (BaseUtils.convertIUPACtoN): anything not ACGTacgtN
# and not a gap char is converted to N
_VALID = frozenset(b"ACGTacgtNn")
_IUPAC_TABLE = np.full(256, ord("N"), np.uint8)
for _b in _VALID:
    _IUPAC_TABLE[_b] = _b


def iupac_to_n(read, strict: bool = False):
    """Convert IUPAC ambiguity bases to N (IUPACReadTransformer.java:31)."""
    bases = read.bases
    transformed = _IUPAC_TABLE[bases]
    if not np.array_equal(bases, transformed):
        if strict:
            raise UserError(f"read {read.name} contains IUPAC bases")
        read.bases = transformed
    return read


def misencoded_quals(read):
    """Illumina 1.5 (+64) -> standard (+33) base quals (subtract 31)."""
    q = read.quals.astype(np.int32) - 31
    if q.min() < 0:
        raise UserError(
            f"read {read.name} appears to already use standard quality encoding")
    read.quals = q.astype(np.uint8)
    return read


def strip_mate_number(read):
    """Remove /1 /2 (and \\1 \\2) name suffixes (StripMateNumberTransformer)."""
    name = read.name
    if len(name) > 2 and name[-2] in "/\\" and name[-1] in "12":
        read.name = name[:-2]
    return read


def remap_mapping_quality(from_quality: int = 255, to_quality: int = 60):
    """MappingQualityReadTransformer: map one mapq value to another."""

    def _apply(read):
        if read.mapq == from_quality:
            read.mapq = to_quality
        return read

    return _apply


def dragen_mapping_quality(read):
    """DRAGENMappingQualityReadTransformer: mapq 255 -> 60."""
    if read.mapq == 255:
        read.mapq = 60
    return read


MIN_FRACTION_OF_MATCHING_BASES = 0.9
_COMP = np.zeros(256, np.uint8)
for _a, _b in zip(b"ACGTacgt", b"TGCATGCA"):
    _COMP[_a] = _b


def palindrome_artifact_clip(reference, min_palindrome_size: int = 5):
    """PalindromeArtifactClipReadTransformer: hard-clip the soft-clipped (or
    inserted) start/end of a properly-paired read when the reference sequence
    beyond the adaptor boundary matches its reverse complement — the
    single-strand-loop end-repair artifact of FFPE samples
    (PalindromeArtifactClipReadTransformer.java:60-130). `reference` is a
    FastaReference; returns a Read -> Read callable."""

    def _apply(read):
        from ..recal.engine import _adaptor_boundary

        boundary_1b = _adaptor_boundary(read)  # 1-based or None
        if boundary_1b is None or not read.is_paired or read.is_unmapped:
            return read
        if len(read.cigar_ops) == 0:
            return read
        from ..io import sam

        first_op = int(read.cigar_ops[0])
        last_op = int(read.cigar_ops[-1])
        upstream = read.tlen > 0
        if (upstream and first_op not in (sam.OP_S, sam.OP_I)) or (
                not upstream and last_op not in (sam.OP_S, sam.OP_I)):
            return read
        n_artifact = int(read.cigar_lens[0] if upstream else read.cigar_lens[-1])
        n_compare = min(n_artifact + min_palindrome_size, len(read.bases))
        contig = getattr(read, "contig", None) or _contig_of(read, reference)
        if contig is None:
            return read
        clen = reference.contig_length(contig)
        # 1-based [ref_start, ref_end] of the suspected artifact's revcomp
        if upstream:
            ref_start, ref_end = boundary_1b - n_compare, boundary_1b - 1
        else:
            ref_start, ref_end = boundary_1b + 1, boundary_1b + n_compare
        if ref_start < 1 or ref_end > clen:
            return read
        # reference overlap with the soft clip itself -> not an artifact
        if (upstream and ref_start < read.pos + 1) or (
                not upstream and read.end < ref_end):
            return read
        ref_bases = reference.fetch_bytes(contig, ref_start - 1, ref_end)
        ref_arr = np.frombuffer(bytes(ref_bases), np.uint8)
        read_idx_hi = n_compare - 1 if upstream else len(read.bases) - 1
        # traverse reference forward == read reversed
        seg = read.bases[read_idx_hi - len(ref_arr) + 1 : read_idx_hi + 1][::-1]
        if len(seg) != len(ref_arr):
            return read
        n_match = int((_COMP[ref_arr] == seg).sum())
        if n_match / n_compare >= MIN_FRACTION_OF_MATCHING_BASES:
            if upstream:
                return clipping.hard_clip_by_read_coords(read, 0, n_artifact - 1)
            return clipping.hard_clip_by_read_coords(
                read, len(read.bases) - n_artifact, len(read.bases) - 1)
        return read

    return _apply


def _contig_of(read, reference):
    names = list(reference.index)
    if 0 <= read.ref_id < len(names):
        return names[read.ref_id]
    return None


def compose(*transformers):
    """Left-to-right composition (ReadTransformer.andThen)."""

    def _apply(read):
        for t in transformers:
            read = t(read)
            if read is None:
                return None
        return read

    return _apply


# --read-transformer registry (mirrors filters.READ_FILTER_REGISTRY)
TRANSFORMER_REGISTRY = {
    "IUPACReadTransformer": lambda **kw: lambda r: iupac_to_n(r, strict=False),
    "MisencodedBaseQualityReadTransformer": lambda **kw: misencoded_quals,
    "StripMateNumberTransformer": lambda **kw: strip_mate_number,
    "MappingQualityReadTransformer": lambda **kw: remap_mapping_quality(
        kw.get("from_quality", 255), kw.get("to_quality", 60)),
    "DRAGENMappingQualityReadTransformer": lambda **kw: dragen_mapping_quality,
}
