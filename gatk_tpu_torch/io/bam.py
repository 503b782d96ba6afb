# Copied verbatim from gatk_tpu/io/bam.py; only import lines may differ.
"""BAM reader/writer (htsjdk BAMFileReader / ReadsPathDataSource equivalent).

Reference behavior: engine/ReadsPathDataSource.java (interval queries via the
.bai index — htsjdk BAMFileReader.query), format per the SAM/BAM spec. Interval
queries use the BAI binning+linear index so only overlapping BGZF blocks are
decompressed (O(overlap), not O(file)); whole-file iteration decompresses the
stream once via the multithreaded native BGZF codec.
"""
from __future__ import annotations

import os
import struct

import numpy as np

from . import bgzf, sam
from .reads import Read, encode_tags, parse_tags

_UNPACK_CORE = struct.Struct("<iiIHHiiii").unpack_from


def _parse_record(data, off):
    """Parse one BAM record at byte offset off; returns (Read, next_offset)."""
    (block_size,) = struct.unpack_from("<i", data, off)
    rec_end = off + 4 + block_size
    (ref_id, pos, l_rn_mapq_bin, n_cigar, flag, l_seq,
     next_ref, next_pos, tlen) = _UNPACK_CORE(data, off + 4)
    l_read_name = l_rn_mapq_bin & 0xFF
    mapq = (l_rn_mapq_bin >> 8) & 0xFF
    p = off + 4 + 32
    name = data[p : p + l_read_name - 1].decode()
    p += l_read_name
    cigar_raw = np.frombuffer(data, dtype="<u4", count=n_cigar, offset=p)
    p += 4 * n_cigar
    n_seq_bytes = (l_seq + 1) // 2
    seq4 = np.frombuffer(data, dtype=np.uint8, count=n_seq_bytes, offset=p)
    p += n_seq_bytes
    quals = np.frombuffer(data, dtype=np.uint8, count=l_seq, offset=p).copy()
    p += l_seq
    tags = parse_tags(data[p:rec_end])
    hi = seq4 >> 4
    lo = seq4 & 0xF
    codes = np.empty(n_seq_bytes * 2, np.uint8)
    codes[0::2] = hi
    codes[1::2] = lo
    bases = sam._NT16_TO_CHAR[codes[:l_seq]]
    read = Read.make(
        name, flag, ref_id, pos, mapq,
        (cigar_raw & 0xF).astype(np.uint8),
        (cigar_raw >> 4).astype(np.int32),
        bases, quals, next_ref, next_pos, tlen, tags,
    )
    return read, rec_end


_NATIVE = None
_NATIVE_TRIED = False


def _load_native():
    """ctypes binding to native/readprep bam_parse_records (the batched C++
    record splitter; ~3x the pure-python per-record parse)."""
    global _NATIVE, _NATIVE_TRIED
    if _NATIVE_TRIED:
        return _NATIVE
    _NATIVE_TRIED = True
    import ctypes

    so = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..",
                      "native", "readprep", "libreadprep_native.so")
    if not os.path.exists(so) or os.environ.get("GATK_TPU_NO_NATIVE"):
        return None
    try:
        lib = ctypes.CDLL(so)
        c = ctypes
        u8 = np.ctypeslib.ndpointer(np.uint8)
        i32 = np.ctypeslib.ndpointer(np.int32)
        i64 = np.ctypeslib.ndpointer(np.int64)
        lib.bam_parse_records.restype = c.c_int64
        lib.bam_parse_records.argtypes = [
            u8, c.c_int64, c.c_int64, c.c_int64, c.c_int64, c.c_int64,
            c.c_int64, c.c_int64, i32, i64, u8, i64, u8, i32, i64, u8, u8,
            i64, u8, c.POINTER(c.c_int64)]
    except (OSError, AttributeError):
        return None
    _NATIVE = lib
    return lib


def _parse_records_batch(data, off, end):
    """Yield Reads for every record in data[off:end) via the native batch
    splitter; returns None when the native library is unavailable."""
    lib = _load_native()
    if lib is None:
        return None
    import ctypes

    arr = np.frombuffer(data, np.uint8)
    nbytes = end - off
    cap_rec = nbytes // 36 + 2
    name_cap = nbytes + 1
    cig_cap = nbytes // 4 + 2
    seq_cap = 2 * nbytes + 2
    tag_cap = nbytes + 1
    out = []
    while off < end:
        core = np.empty((cap_rec, 8), np.int32)
        name_off = np.empty(cap_rec + 1, np.int64)
        name_buf = np.empty(name_cap, np.uint8)
        cig_off = np.empty(cap_rec + 1, np.int64)
        cig_ops = np.empty(cig_cap, np.uint8)
        cig_lens = np.empty(cig_cap, np.int32)
        seq_off = np.empty(cap_rec + 1, np.int64)
        seq_buf = np.empty(seq_cap, np.uint8)
        qual_buf = np.empty(seq_cap, np.uint8)
        tag_off = np.empty(cap_rec + 1, np.int64)
        tag_buf = np.empty(tag_cap, np.uint8)
        consumed = ctypes.c_int64()
        n = lib.bam_parse_records(
            arr, np.int64(off), np.int64(end), np.int64(cap_rec),
            np.int64(name_cap), np.int64(cig_cap), np.int64(seq_cap),
            np.int64(tag_cap), core, name_off, name_buf, cig_off, cig_ops,
            cig_lens, seq_off, seq_buf, qual_buf, tag_off, tag_buf,
            ctypes.byref(consumed))
        if n <= 0:
            break
        # freeze the shared buffers: slices become read-only views, so any
        # in-place mutation downstream raises (same contract as the old
        # frombuffer-on-bytes views)
        for a in (cig_ops, cig_lens, seq_buf, qual_buf):
            a.flags.writeable = False
        names = name_buf[: name_off[n]].tobytes()
        tags_blob = tag_buf[: tag_off[n]].tobytes()
        make = Read.make
        for i in range(n):
            c0 = core[i]
            end_cache = int(c0[7])
            r = make(
                names[name_off[i]: name_off[i + 1]].decode(),
                int(c0[2]), int(c0[0]), int(c0[1]), int(c0[3]),
                cig_ops[cig_off[i]: cig_off[i + 1]],
                cig_lens[cig_off[i]: cig_off[i + 1]],
                seq_buf[seq_off[i]: seq_off[i + 1]],
                qual_buf[seq_off[i]: seq_off[i + 1]],
                int(c0[4]), int(c0[5]), int(c0[6]),
                parse_tags(tags_blob[tag_off[i]: tag_off[i + 1]]))
            r.__dict__["_end_cache"] = end_cache
            out.append(r)
        if consumed.value == off:
            break  # no progress (malformed trailing bytes)
        off = consumed.value
    return out


class BaiIndex:
    """BAM binning+linear index (.bai), per the SAM spec section 5.2."""

    MAX_BIN = 37450  # pseudo-bin holding unmapped counts

    def __init__(self, path: str):
        with open(path, "rb") as fh:
            data = fh.read()
        if data[:4] != b"BAI\x01":
            raise ValueError(f"{path}: not a BAI index")
        (n_ref,) = struct.unpack_from("<i", data, 4)
        off = 8
        self.bins = []  # per ref: dict bin -> [(beg, end) voffset chunks]
        self.linear = []  # per ref: array of voffsets per 16kb window
        self.meta = {}  # ref index -> pseudo-bin chunks [(span), (mapped, unmapped)]
        meta = self.meta
        for _ in range(n_ref):
            (n_bin,) = struct.unpack_from("<i", data, off)
            off += 4
            bins = {}
            for _b in range(n_bin):
                bin_no, n_chunk = struct.unpack_from("<Ii", data, off)
                off += 8
                chunks = list(
                    struct.iter_unpack("<QQ", data[off : off + 16 * n_chunk])
                )
                off += 16 * n_chunk
                if bin_no != self.MAX_BIN:
                    bins[bin_no] = chunks
                else:
                    # pseudo-bin metadata: chunk0 = ref span voffsets,
                    # chunk1 = (n_mapped, n_unmapped) (SAM spec 5.2)
                    meta[len(self.bins)] = chunks
            (n_intv,) = struct.unpack_from("<i", data, off)
            off += 4
            self.linear.append(np.frombuffer(data, "<u8", n_intv, off))
            off += 8 * n_intv
            self.bins.append(bins)

    @staticmethod
    def reg2bins(beg: int, end: int):
        """All bin numbers overlapping [beg, end) (SAM spec reg2bins)."""
        end -= 1
        bins = [0]
        for shift, base in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
            bins.extend(range(base + (beg >> shift), base + (end >> shift) + 1))
        return bins

    def chunks_for(self, ref_id: int, beg: int, end: int):
        """Merged voffset chunks possibly containing reads overlapping
        [beg, end), filtered by the linear index (htsjdk BAMIndexContent)."""
        if ref_id < 0 or ref_id >= len(self.bins):
            return []
        bins = self.bins[ref_id]
        linear = self.linear[ref_id]
        win = beg >> 14
        min_offset = int(linear[min(win, len(linear) - 1)]) if len(linear) else 0
        chunks = []
        for b in self.reg2bins(beg, end):
            for cbeg, cend in bins.get(b, ()):
                if cend > min_offset:
                    chunks.append((max(cbeg, min_offset), cend))
        chunks.sort()
        merged = []
        for cbeg, cend in chunks:
            # merge chunks that touch or share a compressed block
            if merged and (cbeg >> 16) <= (merged[-1][1] >> 16):
                merged[-1][1] = max(merged[-1][1], cend)
            else:
                merged.append([cbeg, cend])
        return [(b, e) for b, e in merged]


class BamReader:
    def __init__(self, path: str):
        from .gatk_path import resolve

        path = resolve(path)  # file:// and mirrored cloud URIs (GATKPath)
        self.path = path
        self._bgzf = bgzf.BgzfReader(path)
        self._data = None  # full uncompressed stream (lazy, for iteration)
        # parse header incrementally from the leading blocks
        head = self._read_prefix(4 + 4)
        if head[:4] != b"BAM\x01":
            raise ValueError(f"{path}: not a BAM file")
        (l_text,) = struct.unpack_from("<i", head, 4)
        head = self._read_prefix(8 + l_text + 4)
        text = head[8 : 8 + l_text].split(b"\x00", 1)[0].decode()
        off = 8 + l_text
        (n_ref,) = struct.unpack_from("<i", head, off)
        off += 4
        names, lengths = [], []
        for _ in range(n_ref):
            head = self._read_prefix(off + 8)
            (l_name,) = struct.unpack_from("<i", head, off)
            head = self._read_prefix(off + 8 + l_name)
            off += 4
            names.append(head[off : off + l_name - 1].decode())
            off += l_name
            (l_ref,) = struct.unpack_from("<i", head, off)
            off += 4
            lengths.append(l_ref)
        self.header = sam.SamHeader.parse(text, names, lengths)
        if not self.header.sequences:
            self.header.sequences = [
                sam.SequenceRecord(n, l, i) for i, (n, l) in enumerate(zip(names, lengths))
            ]
            self.header._name_to_index = {s.name: s.index for s in self.header.sequences}
        self._records_start = off
        self._prefix = head
        self._index = None
        self._index_checked = False

    def _read_prefix(self, n: int) -> bytes:
        """At least n uncompressed leading bytes (block-incremental)."""
        if getattr(self, "_prefix", None) is not None and len(self._prefix) >= n:
            return self._prefix
        buf = bytearray()
        coff = 0
        while len(buf) < n and coff < len(self._bgzf._data):
            buf.extend(self._bgzf._block_at(coff))
            coff = self._bgzf._cache_next
        self._prefix = bytes(buf)
        return self._prefix

    @property
    def index(self) -> BaiIndex | None:
        if not self._index_checked:
            self._index_checked = True
            for cand in (self.path + ".bai", os.path.splitext(self.path)[0] + ".bai"):
                if os.path.exists(cand):
                    self._index = BaiIndex(cand)
                    break
        return self._index

    def _full_data(self) -> bytes:
        if self._data is None:
            self._data = bgzf.decompress_file(self.path)
        return self._data

    def __iter__(self):
        data = self._full_data()
        off = self._records_start
        n = len(data)
        batch = _parse_records_batch(data, off, n)
        if batch is not None:
            yield from batch
            return
        while off < n:
            read, off = _parse_record(data, off)
            yield read

    def query(self, contig: str | None = None, start: int = 0, end: int | None = None):
        """Reads overlapping [start, end) on contig (0-based); whole file if no
        contig. Uses the .bai index when present (only overlapping BGZF blocks
        are read); falls back to a full scan otherwise.

        Unmapped-with-mapped-mate reads placed in the interval are included (they
        carry a position); fully unmapped reads only appear in whole-file iteration.
        """
        if contig is None:
            yield from iter(self)
            return
        rid = self.header.sequence_index(contig)
        if end is None:
            end = self.header.sequences[rid].length
        idx = self.index
        if idx is not None and self._data is None:
            for chunk_beg, chunk_end in idx.chunks_for(rid, start, end):
                buf = self._bgzf.read_range(chunk_beg, chunk_end)
                off = 0
                n = len(buf)
                batch = _parse_records_batch(buf, off, n)
                if batch is not None:
                    for read in batch:
                        if read.ref_id != rid or read.pos >= end:
                            continue
                        if read.is_unmapped or read.end > start:
                            yield read
                    continue
                while off + 4 <= n:
                    read, off = _parse_record(buf, off)
                    if read.ref_id != rid or read.pos >= end:
                        continue
                    if read.is_unmapped or read.end > start:
                        yield read
            return
        for r in self:
            if r.ref_id != rid:
                continue
            if r.pos < end and (r.is_unmapped or r.end > start):
                yield r


class BamWriter:
    def __init__(self, path: str, header: sam.SamHeader):
        self.path = path
        self.header = header
        self._chunks = []
        text = header.text
        if not text:
            text = "".join(
                f"@SQ\tSN:{s.name}\tLN:{s.length}\n" for s in header.sequences
            ) + "".join(
                "@RG\t" + "\t".join(f"{k}:{v}" for k, v in rg.items()) + "\n"
                for rg in header.read_groups
            )
        tb = text.encode()
        head = [b"BAM\x01", struct.pack("<i", len(tb)), tb, struct.pack("<i", len(header.sequences))]
        for s in header.sequences:
            nb = s.name.encode() + b"\x00"
            head.append(struct.pack("<i", len(nb)) + nb + struct.pack("<i", s.length))
        self._chunks.append(b"".join(head))

    def write(self, r: Read):
        nb = r.name.encode() + b"\x00"
        l_seq = len(r.bases)
        cigar_raw = (r.cigar_lens.astype(np.uint32) << 4) | r.cigar_ops.astype(np.uint32)
        codes = sam._CHAR_TO_NT16[r.bases]
        if l_seq % 2:
            codes = np.concatenate([codes, np.zeros(1, np.uint8)])
        seq4 = ((codes[0::2] << 4) | codes[1::2]).astype(np.uint8)
        tags = encode_tags(r.tags)
        body = (
            struct.pack(
                "<iiIHHiiii",
                r.ref_id, r.pos,
                len(nb) | (r.mapq << 8) | (_reg2bin(max(r.pos, 0), max(r.end, r.pos + 1)) << 16),
                len(r.cigar_ops), r.flag, l_seq, r.mate_ref_id, r.mate_pos, r.tlen,
            )
            + nb
            + cigar_raw.astype("<u4").tobytes()
            + seq4.tobytes()
            + r.quals.astype(np.uint8).tobytes()
            + tags
        )
        self._chunks.append(struct.pack("<i", len(body)) + body)

    def close(self):
        payload = b"".join(self._chunks)
        with open(self.path, "wb") as fh:
            fh.write(bgzf.compress_bytes(payload))


def _reg2bin(beg: int, end: int) -> int:
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
