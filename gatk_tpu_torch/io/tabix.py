# Copied verbatim from gatk_tpu/io/tabix.py; only import lines may differ.
"""Tabix (.tbi) index read/write + indexed feature queries over BGZF text.

Reference behavior: engine/FeatureDataSource.java:68 (indexed VCF/BED feature
queries with lookahead caching via htsjdk tribble/tabix readers) and htslib's
tbx.c/hts.c index builder (the reference bundles htsjdk's port). The .tbi
format is the SAM-spec binning scheme (same reg2bin/reg2bins as .bai,
io/bam.py) over a BGZF-compressed text file, plus a 16kb-window linear index.

write_tbi reproduces htslib's builder exactly (in-add chunk merging when a
record starts at the previous record's end voffset, finish-time merging of
chunks sharing a compressed block, linear-index gap filling) — outputs are
payload-identical to `tabix -p vcf` on the reference's own test files
(tests/test_tabix.py).
"""
from __future__ import annotations

import struct

import numpy as np

from . import bgzf

TBI_MAGIC = b"TBI\x01"
FMT_GENERIC = 0
FMT_SAM = 1
FMT_VCF = 2
FLAG_UCSC = 0x10000  # BED-style 0-based half-open begin column

# preset configs (htslib tbx_conf_t: fmt, col_seq, col_beg, col_end, meta, skip)
CONF_VCF = (FMT_VCF, 1, 2, 0, ord("#"), 0)
CONF_BED = (FMT_GENERIC | FLAG_UCSC, 1, 2, 3, ord("#"), 0)
CONF_GFF = (FMT_GENERIC, 1, 4, 5, ord("#"), 0)

MAX_BIN = 37450


def reg2bin(beg: int, end: int) -> int:
    """SAM-spec reg2bin for a 0-based half-open interval."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def reg2bins(beg: int, end: int):
    end -= 1
    bins = [0]
    for shift, base in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        bins.extend(range(base + (beg >> shift), base + (end >> shift) + 1))
    return bins


class TbxIndex:
    """Parsed .tbi index."""

    def __init__(self, path: str):
        data = bgzf.decompress_file(path)
        if data[:4] != TBI_MAGIC:
            raise ValueError(f"{path}: not a TBI index")
        (n_ref, self.fmt, self.col_seq, self.col_beg, self.col_end,
         self.meta, self.skip, l_nm) = struct.unpack_from("<8i", data, 4)
        names = data[36 : 36 + l_nm].split(b"\x00")[:-1]
        self.names = [n.decode() for n in names]
        self.tid = {n: i for i, n in enumerate(self.names)}
        off = 36 + l_nm
        self.bins = []
        self.linear = []
        for _ in range(n_ref):
            (n_bin,) = struct.unpack_from("<i", data, off)
            off += 4
            bins = {}
            for _b in range(n_bin):
                bin_no, n_chunk = struct.unpack_from("<Ii", data, off)
                off += 8
                chunks = list(struct.iter_unpack("<QQ", data[off : off + 16 * n_chunk]))
                off += 16 * n_chunk
                if bin_no != MAX_BIN:
                    bins[bin_no] = chunks
            (n_intv,) = struct.unpack_from("<i", data, off)
            off += 4
            self.linear.append(np.frombuffer(data, "<u8", n_intv, off).copy())
            off += 8 * n_intv
            self.bins.append(bins)
        self.n_no_coor = struct.unpack_from("<Q", data, off)[0] if off + 8 <= len(data) else 0

    def chunks_for(self, contig: str, beg: int, end: int):
        tid = self.tid.get(contig)
        if tid is None:
            return []
        bins = self.bins[tid]
        linear = self.linear[tid]
        win = beg >> 14
        min_offset = int(linear[min(win, len(linear) - 1)]) if len(linear) else 0
        chunks = []
        for b in reg2bins(beg, end):
            for cbeg, cend in bins.get(b, ()):
                if cend > min_offset:
                    chunks.append((max(cbeg, min_offset), cend))
        chunks.sort()
        merged = []
        for cbeg, cend in chunks:
            if merged and (cbeg >> 16) <= (merged[-1][1] >> 16):
                merged[-1][1] = max(merged[-1][1], cend)
            else:
                merged.append([cbeg, cend])
        return merged


def _line_interval(fields, fmt, col_beg, col_end):
    """0-based half-open [beg, end) of one record per the tabix format flags."""
    beg = int(fields[col_beg - 1])
    if fmt & 0xFFFF == FMT_VCF:
        beg -= 1
        end = beg + len(fields[3])
        # INFO END= overrides the REF-length end when present (htslib
        # tbx_parse1: token at INFO start or after ';')
        if len(fields) >= 8 and "END=" in fields[7]:
            for kv in fields[7].split(";"):
                if kv.startswith("END="):
                    try:
                        end = int(kv[4:])
                    except ValueError:
                        pass
                    break
    elif fmt & FLAG_UCSC:
        end = int(fields[col_end - 1]) if col_end else beg + 1
    else:
        beg -= 1
        end = int(fields[col_end - 1]) if col_end else beg + 1
    if end <= beg:
        end = beg + 1
    return beg, end


class TabixReader:
    """Indexed queries over a BGZF-compressed, coordinate-sorted text file.

    query(contig, beg, end) decompresses ONLY the BGZF blocks the index maps to
    the interval (O(overlap)) — never the whole file. Lines are returned as
    strings without the trailing newline."""

    def __init__(self, path: str, index_path: str | None = None):
        self.path = path
        self.reader = bgzf.BgzfReader(path)
        self.index = TbxIndex(index_path or path + ".tbi")

    @property
    def contigs(self):
        return list(self.index.names)

    def query(self, contig: str, beg: int, end: int):
        idx = self.index
        fmt, col_seq, col_beg, col_end = idx.fmt, idx.col_seq, idx.col_beg, idx.col_end
        meta = chr(idx.meta)
        for cbeg, cend in idx.chunks_for(contig, beg, end):
            raw = self.reader.read_range(cbeg, cend)
            # the chunk may start mid-record only if cbeg was clamped by the
            # linear index; records are newline-delimited and chunk starts are
            # record starts in htslib-built indices
            for line in raw.split(b"\n"):
                if not line or line.startswith(meta.encode()):
                    continue
                fields = line.decode().split("\t")
                if len(fields) < max(col_beg, col_seq):
                    continue
                if fields[col_seq - 1] != contig:
                    continue
                b0, e0 = _line_interval(fields, fmt, col_beg, col_end)
                if b0 < end and e0 > beg:
                    yield fields


def _iter_lines_with_voffsets(path: str):
    """Yield (line_bytes, voff_start, voff_end) over a BGZF text file."""
    import os

    file_size = os.path.getsize(path)
    with open(path, "rb") as fh:
        data = fh.read()
    carry = b""
    carry_voff = 0
    off = 0
    while off < len(data):
        bsize = bgzf._read_block_size(data, off)
        payload = bgzf.decompress_bytes(data[off : off + bsize])
        if not payload:
            off += bsize
            continue
        pos = 0
        while True:
            nl = payload.find(b"\n", pos)
            if nl == -1:
                rest = payload[pos:]
                if rest:
                    if not carry:
                        carry_voff = (off << 16) | pos
                    carry += rest
                break
            if carry:
                line = carry + payload[pos : nl + 1]
                voff_start = carry_voff
                carry = b""
            else:
                line = payload[pos : nl + 1]
                voff_start = (off << 16) | pos
            nxt = off + bsize if nl + 1 == len(payload) else off
            voff_end = (nxt << 16) | (0 if nl + 1 == len(payload) else nl + 1)
            yield line[:-1], voff_start, voff_end
            pos = nl + 1
        off += bsize
    if carry:
        yield carry, carry_voff, file_size << 16


def write_tbi(path: str, conf=CONF_VCF, out_path: str | None = None) -> str:
    """Build a .tbi for a BGZF-compressed, coordinate-sorted text file.

    Replicates htslib's hts_idx builder: per-record reg2bin chunks with
    in-add merging (a record starting exactly at the previous chunk's end
    voffset extends it), finish-time merging of chunks sharing a compressed
    block, a 16kb linear index holding the first record voffset per window
    with gap filling, and names/config in the header."""
    fmt, col_seq, col_beg, col_end, meta, skip = conf
    names: list[str] = []
    tid_of: dict[str, int] = {}
    bins: list[dict] = []  # per tid: bin -> [ [beg, end] voffset chunks ]
    linear: list[dict] = []  # per tid: window -> first voffset
    max_win: list[int] = []
    n_no_coor = 0
    lineno = 0
    for line, voff_start, voff_end in _iter_lines_with_voffsets(path):
        lineno += 1
        if lineno <= skip or not line or line[0] == meta:
            continue
        fields = line.decode().split("\t")
        name = fields[col_seq - 1]
        if name not in tid_of:
            tid_of[name] = len(names)
            names.append(name)
            bins.append({})
            linear.append({})
            max_win.append(-1)
        tid = tid_of[name]
        beg, end = _line_interval(fields, fmt, col_beg, col_end)
        b = reg2bin(beg, end)
        blist = bins[tid].setdefault(b, [])
        if blist and blist[-1][1] == voff_start:
            blist[-1][1] = voff_end
        else:
            blist.append([voff_start, voff_end])
        lin = linear[tid]
        for w in range(beg >> 14, ((end - 1) >> 14) + 1):
            if w not in lin:
                lin[w] = voff_start
        max_win[tid] = max(max_win[tid], (end - 1) >> 14)

    # serialize
    out = bytearray()
    out += TBI_MAGIC
    nm = b"".join(n.encode() + b"\x00" for n in names)
    out += struct.pack("<8i", len(names), fmt, col_seq, col_beg, col_end, meta,
                       skip, len(nm))
    out += nm
    for tid in range(len(names)):
        bd = bins[tid]
        # finish-time merge: chunks whose start shares the compressed block of
        # the previous chunk's end (hts.c compress_binning)
        ser = {}
        for b, chunks in bd.items():
            merged = []
            for cbeg, cend in chunks:
                if merged and (cbeg >> 16) == (merged[-1][1] >> 16):
                    merged[-1][1] = cend
                else:
                    merged.append([cbeg, cend])
            ser[b] = merged
        out += struct.pack("<i", len(ser))
        for b in sorted(ser):
            chunks = ser[b]
            out += struct.pack("<Ii", b, len(chunks))
            for cbeg, cend in chunks:
                out += struct.pack("<QQ", cbeg, cend)
        lin = linear[tid]
        n_intv = max_win[tid] + 1
        out += struct.pack("<i", n_intv)
        arr = np.zeros(n_intv, "<u8")
        for w, v in lin.items():
            if w < n_intv:
                arr[w] = v
        # gap fill: empty windows inherit the previous window's offset
        last = 0
        a = arr.view()
        for i in range(n_intv):
            if a[i] == 0:
                a[i] = last
            else:
                last = a[i]
        out += arr.tobytes()
    if n_no_coor:
        out += struct.pack("<Q", n_no_coor)
    dest = out_path or path + ".tbi"
    with open(dest, "wb") as fh:
        fh.write(bgzf.compress_bytes(bytes(out)))
    return dest


class FeatureDataSource:
    """Indexed feature source with lookahead caching
    (engine/FeatureDataSource.java:68 + FeatureCache.java).

    query(contig, start, end) fetches [start, end + lookahead) once and serves
    subsequent overlapping queries from the cache — walkers advancing along the
    genome hit the index once per lookahead window instead of once per locus.
    parse: fn(fields) -> feature (defaults to VCF Variant parsing)."""

    DEFAULT_LOOKAHEAD = 100_000

    def __init__(self, path: str, parse=None, lookahead: int = DEFAULT_LOOKAHEAD):
        self.path = path
        self.lookahead = lookahead
        self.n_index_queries = 0
        if parse is None:
            from .vcf import parse_vcf_line

            parse = lambda fields: parse_vcf_line("\t".join(fields))  # noqa: E731
        self.parse = parse
        self.reader = TabixReader(path)
        self._cache: list = []
        self._cache_key: tuple | None = None  # (contig, start, end)

    def query(self, contig: str, start: int, end: int):
        """Features overlapping the 0-based half-open [start, end)."""
        ck = self._cache_key
        if ck is None or ck[0] != contig or start < ck[1] or end > ck[2]:
            fetch_end = max(end, start + 1) + self.lookahead
            self.n_index_queries += 1
            self._cache = [
                (self.parse(f), *_line_interval(f, self.reader.index.fmt,
                                                self.reader.index.col_beg,
                                                self.reader.index.col_end))
                for f in self.reader.query(contig, start, fetch_end)
            ]
            self._cache_key = (contig, start, fetch_end)
        return [feat for feat, b, e in self._cache if b < end and e > start]
