# Copied verbatim from gatk_tpu/io/cram_writer.py; only import lines may differ.
"""CRAM 3.0 writer.

Reference behavior: htsjdk CRAMFileWriter (what GATK's ReadsPathDataSource uses
for .cram outputs) in htslib "no_ref" style: reference not required (RR=0),
read bases carried by 'b'/'I'/'S' read features derived from the cigar, full
quality strings preserved (CF_QS_PRESERVED), all mates detached (CF_DETACHED),
one multi-ref slice per container (slice ref_id = -2 with a per-record RI
series), every data series EXTERNAL (gzip-compressed blocks).

Round-trips through io/cram.CramReader without a reference; the encodings used
(EXTERNAL, BYTE_ARRAY_STOP, BYTE_ARRAY_LEN) are the spec's §12 codecs.
"""
from __future__ import annotations

import gzip
import struct
import zlib

import numpy as np

from . import sam
from .cram import (CF_DETACHED, CF_QS_PRESERVED, COMPRESSION_HEADER, CORE,
                   CRAM_MAGIC, E_BYTE_ARRAY_LEN, E_BYTE_ARRAY_STOP, E_EXTERNAL,
                   EXTERNAL, FILE_HEADER, SLICE_HEADER)

GZIP = 1
RECORDS_PER_CONTAINER = 10000

# data series -> external block content id (ints); byte-array series get a
# dedicated (len, val) pair
_SERIES = ["BF", "CF", "RI", "RL", "AP", "RG", "MF", "NS", "NP", "TS", "MQ",
           "FN", "FC", "FP", "DL", "RS", "PD", "HC", "BA", "QS", "TL"]
_ID = {k: i + 1 for i, k in enumerate(_SERIES)}
_RN_ID = 40
_IN_LEN, _IN_VAL = 41, 42
_SC_LEN, _SC_VAL = 43, 44
_BB_LEN, _BB_VAL = 45, 46
_TAG_BASE = 100


def itf8(v: int) -> bytes:
    v &= 0xFFFFFFFF
    if v < 0x80:
        return bytes([v])
    if v < 0x4000:
        return bytes([0x80 | (v >> 8), v & 0xFF])
    if v < 0x200000:
        return bytes([0xC0 | (v >> 16), (v >> 8) & 0xFF, v & 0xFF])
    if v < 0x10000000:
        return bytes([0xE0 | (v >> 24), (v >> 16) & 0xFF, (v >> 8) & 0xFF, v & 0xFF])
    return bytes([0xF0 | (v >> 28), (v >> 20) & 0xFF, (v >> 12) & 0xFF,
                  (v >> 4) & 0xFF, v & 0x0F])


def ltf8(v: int) -> bytes:
    if 0 <= v < 0x80:
        return bytes([v])
    return bytes([0xFF]) + (v & ((1 << 64) - 1)).to_bytes(8, "big")


def _itf8_array(vals) -> bytes:
    return itf8(len(vals)) + b"".join(itf8(v) for v in vals)


def _encoding_external(content_id: int) -> bytes:
    params = itf8(content_id)
    return itf8(E_EXTERNAL) + itf8(len(params)) + params


def _encoding_byte_array_stop(stop: int, content_id: int) -> bytes:
    params = bytes([stop]) + itf8(content_id)
    return itf8(E_BYTE_ARRAY_STOP) + itf8(len(params)) + params


def _encoding_byte_array_len(len_id: int, val_id: int) -> bytes:
    params = _encoding_external(len_id) + _encoding_external(val_id)
    return itf8(E_BYTE_ARRAY_LEN) + itf8(len(params)) + params


def _block(content_type: int, content_id: int, data: bytes,
           compress: bool = True) -> bytes:
    method = GZIP if compress and len(data) > 64 else 0
    payload = gzip.compress(data, 5) if method == GZIP else data
    head = bytes([method, content_type]) + itf8(content_id) + \
        itf8(len(payload)) + itf8(len(data))
    body = head + payload
    return body + struct.pack("<I", zlib.crc32(body) & 0xFFFFFFFF)


def _container(ref_id, start, span, n_records, record_counter, n_bases,
               blocks: list) -> bytes:
    payload = b"".join(blocks)
    landmarks = []
    off = 0
    for b in blocks:
        landmarks.append(off)
        off += len(b)
    head = (itf8(ref_id) + itf8(start) + itf8(span) + itf8(n_records)
            + ltf8(record_counter) + ltf8(n_bases) + itf8(len(blocks))
            + _itf8_array(landmarks))
    head_full = struct.pack("<i", len(payload)) + head
    crc = struct.pack("<I", zlib.crc32(head_full) & 0xFFFFFFFF)
    return head_full + crc + payload


_TAG_PACK = {"c": "<b", "C": "<B", "s": "<h", "S": "<H", "i": "<i", "I": "<I",
             "f": "<f"}


def _tag_type_and_raw(value):
    if isinstance(value, float):
        return "f", struct.pack("<f", value)
    if isinstance(value, int):
        for t in ("c", "s", "i"):
            fmt = _TAG_PACK[t]
            try:
                return t, struct.pack(fmt, value)
            except struct.error:
                continue
        return "i", struct.pack("<i", 0)
    if isinstance(value, (bytes, bytearray)):
        return "Z", bytes(value) + b"\x00"
    if isinstance(value, np.ndarray):
        code = {np.dtype(np.int8): "c", np.dtype(np.uint8): "C",
                np.dtype(np.int16): "s", np.dtype(np.uint16): "S",
                np.dtype(np.int32): "i", np.dtype(np.uint32): "I",
                np.dtype(np.float32): "f"}.get(value.dtype, "i")
        arr = value.astype({"c": np.int8, "C": np.uint8, "s": np.int16,
                            "S": np.uint16, "i": np.int32, "I": np.uint32,
                            "f": np.float32}[code])
        return "B", bytes([ord(code)]) + struct.pack("<i", len(arr)) + arr.tobytes()
    s = str(value)
    if len(s) == 1:
        return "A", s.encode()
    return "Z", s.encode() + b"\x00"


class CramWriter:
    """Write Read objects to a CRAM 3.0 file (coordinate order preserved)."""

    def __init__(self, path: str, header: sam.SamHeader):
        self.path = path
        self.header = header
        self._fh = open(path, "wb")
        self._fh.write(CRAM_MAGIC + bytes([3, 0]) + path.encode()[:20].ljust(20, b"\x00"))
        self._write_file_header()
        self._pending = []
        self._counter = 0
        self._rg_index = {rg.get("ID"): i for i, rg in enumerate(header.read_groups)}

    def _write_file_header(self):
        text = self.header.text
        if not text:
            text = "".join(f"@SQ\tSN:{s.name}\tLN:{s.length}\n"
                           for s in self.header.sequences)
            text += "".join("@RG\t" + "\t".join(f"{k}:{v}" for k, v in rg.items())
                            + "\n" for rg in self.header.read_groups)
        data = struct.pack("<i", len(text)) + text.encode()
        blk = _block(FILE_HEADER, 0, data, compress=False)
        self._fh.write(_container(0, 0, 0, 0, 0, 0, [blk]))

    def write(self, read):
        self._pending.append(read)
        if len(self._pending) >= RECORDS_PER_CONTAINER:
            self._flush()

    # ---- container emission ----

    def _flush(self):
        if not self._pending:
            return
        reads = self._pending
        self._pending = []

        ext: dict[int, bytearray] = {i: bytearray() for i in _ID.values()}
        for i in (_RN_ID, _IN_LEN, _IN_VAL, _SC_LEN, _SC_VAL, _BB_LEN, _BB_VAL):
            ext[i] = bytearray()
        tag_defs: list = []       # TL dictionary: list of [(tag, type, key)]
        tag_index: dict = {}
        tag_streams: dict[int, bytearray] = {}

        def put_int(series, v):
            ext[_ID[series]] += itf8(v)

        def put_byte(series, v):
            ext[_ID[series]].append(v & 0xFF)

        def put_arr(len_id, val_id, data: bytes):
            ext[len_id] += itf8(len(data))
            ext[val_id] += data

        n_bases = 0
        for r in reads:
            n_bases += len(r.bases)
            bf = r.flag & ~(sam.MATE_REVERSE | sam.MATE_UNMAPPED)
            cf = CF_DETACHED | CF_QS_PRESERVED
            put_int("BF", bf)
            put_int("CF", cf)
            put_int("RI", r.ref_id)
            put_int("RL", len(r.bases))
            put_int("AP", r.pos + 1)
            rg = self._rg_index.get((r.tags or {}).get("RG"), -1)
            put_int("RG", rg)
            ext[_RN_ID] += r.name.encode() + b"\t"
            mf = (1 if r.flag & sam.MATE_REVERSE else 0) | \
                 (2 if r.flag & sam.MATE_UNMAPPED else 0)
            put_int("MF", mf)
            put_int("NS", r.mate_ref_id)
            put_int("NP", r.mate_pos + 1)
            put_int("TS", r.tlen)

            # tag line
            tags = {k: v for k, v in (r.tags or {}).items() if k != "RG"}
            typed = []
            for tag, value in sorted(tags.items()):
                tchar, raw = _tag_type_and_raw(value)
                key = (ord(tag[0]) << 16) | (ord(tag[1]) << 8) | ord(tchar)
                typed.append((tag, tchar, key, raw))
            sig = tuple((t, c) for t, c, _k, _r in typed)
            tl = tag_index.get(sig)
            if tl is None:
                tl = len(tag_defs)
                tag_index[sig] = tl
                tag_defs.append([(t, c, k) for t, c, k, _ in typed])
            put_int("TL", tl)
            for _tag, _c, key, raw in typed:
                streams = tag_streams.setdefault(key, [bytearray(), bytearray()])
                streams[0] += itf8(len(raw))
                streams[1] += raw

            if r.is_unmapped or r.ref_id < 0:
                for b in r.bases:
                    put_byte("BA", int(b))
                ext[_ID["QS"]] += bytes(np.asarray(r.quals, np.uint8))
                continue

            # mapped: features from the cigar (no-reference style)
            feats = []  # (1-based read pos, code char, payload)
            rpos = 1
            for op, ln in zip(r.cigar_ops, r.cigar_lens):
                op, ln = int(op), int(ln)
                if op in (sam.OP_M, sam.OP_EQ, sam.OP_X):
                    feats.append((rpos, "b", bytes(r.bases[rpos - 1: rpos - 1 + ln])))
                    rpos += ln
                elif op == sam.OP_I:
                    feats.append((rpos, "I", bytes(r.bases[rpos - 1: rpos - 1 + ln])))
                    rpos += ln
                elif op == sam.OP_S:
                    feats.append((rpos, "S", bytes(r.bases[rpos - 1: rpos - 1 + ln])))
                    rpos += ln
                elif op == sam.OP_D:
                    feats.append((rpos, "D", ln))
                elif op == sam.OP_N:
                    feats.append((rpos, "N", ln))
                elif op == sam.OP_H:
                    feats.append((rpos, "H", ln))
                elif op == sam.OP_P:
                    feats.append((rpos, "P", ln))
            put_int("FN", len(feats))
            prev = 0
            for fpos, code, payload in feats:
                put_byte("FC", ord(code))
                put_int("FP", fpos - prev)
                prev = fpos
                if code == "b":
                    put_arr(_BB_LEN, _BB_VAL, payload)
                elif code == "I":
                    put_arr(_IN_LEN, _IN_VAL, payload)
                elif code == "S":
                    put_arr(_SC_LEN, _SC_VAL, payload)
                elif code == "D":
                    put_int("DL", payload)
                elif code == "N":
                    put_int("RS", payload)
                elif code == "H":
                    put_int("HC", payload)
                elif code == "P":
                    put_int("PD", payload)
            put_int("MQ", r.mapq)
            ext[_ID["QS"]] += bytes(np.asarray(r.quals, np.uint8))

        # ---- compression header ----
        pres = bytearray()
        entries = []
        entries.append(b"RN" + bytes([1]))
        entries.append(b"AP" + bytes([0]))
        entries.append(b"RR" + bytes([0]))
        entries.append(b"SM" + bytes(5))
        td = bytearray()
        for line in tag_defs:
            for tag, tchar, _k in line:
                td += tag.encode() + tchar.encode()
            td += b"\x00"
        if not tag_defs:
            td += b"\x00"
        entries.append(b"TD" + itf8(len(td)) + bytes(td))
        body = itf8(len(entries)) + b"".join(entries)
        pres += itf8(len(body)) + body

        series = bytearray()
        enc_map = {k: _encoding_external(_ID[k]) for k in _SERIES}
        enc_map["RN"] = _encoding_byte_array_stop(ord("\t"), _RN_ID)
        enc_map["IN"] = _encoding_byte_array_len(_IN_LEN, _IN_VAL)
        enc_map["SC"] = _encoding_byte_array_len(_SC_LEN, _SC_VAL)
        enc_map["BB"] = _encoding_byte_array_len(_BB_LEN, _BB_VAL)
        sbody = itf8(len(enc_map))
        for k in sorted(enc_map):
            sbody += k.encode() + enc_map[k]
        series += itf8(len(sbody)) + sbody

        tenc = bytearray()
        keys = sorted(tag_streams)
        tbody = itf8(len(keys))
        tag_block_ids = {}
        next_id = _TAG_BASE
        for key in keys:
            lid, vid = next_id, next_id + 1
            next_id += 2
            tag_block_ids[key] = (lid, vid)
            tbody += itf8(key) + _encoding_byte_array_len(lid, vid)
        tenc += itf8(len(tbody)) + tbody

        comp_data = bytes(pres + series + tenc)
        comp_block = _block(COMPRESSION_HEADER, 0, comp_data)

        # ---- slice ----
        starts = [r.pos + 1 for r in reads if not r.is_unmapped and r.ref_id >= 0]
        sl_start = min(starts) if starts else 0
        sl_span = (max(r.pos + len(r.bases) for r in reads
                       if not r.is_unmapped and r.ref_id >= 0) - sl_start + 1) \
            if starts else 0
        content_ids = ([i for i in sorted(ext) if ext[i]]
                       + [i for key in keys for i in tag_block_ids[key]])
        data_blocks = [_block(CORE, 0, b"")]
        for i in sorted(ext):
            if ext[i]:
                data_blocks.append(_block(EXTERNAL, i, bytes(ext[i])))
        for key in keys:
            lid, vid = tag_block_ids[key]
            data_blocks.append(_block(EXTERNAL, lid, bytes(tag_streams[key][0])))
            data_blocks.append(_block(EXTERNAL, vid, bytes(tag_streams[key][1])))
        sh = (itf8(-2) + itf8(sl_start) + itf8(sl_span) + itf8(len(reads))
              + ltf8(self._counter) + itf8(len(data_blocks))
              + _itf8_array(content_ids) + itf8(-1) + bytes(16))
        slice_block = _block(SLICE_HEADER, 0, sh)

        blocks = [comp_block, slice_block] + data_blocks
        self._fh.write(_container(-2, sl_start, sl_span, len(reads),
                                  self._counter, n_bases, blocks))
        self._counter += len(reads)

    def close(self):
        self._flush()
        # EOF sentinel container (spec §9: ref_id -1, start 4542278)
        eof_block = _block(COMPRESSION_HEADER, 0, itf8(0) + itf8(0), compress=False)
        self._fh.write(_container(-1, 4542278, 0, 0, 0, 0, [eof_block]))
        self._fh.close()


def open_reads_writer(path: str, header):
    """ReadsPathDataSource-style writer dispatch: .cram -> CramWriter,
    else BamWriter."""
    if path.endswith(".cram"):
        return CramWriter(path, header)
    from . import bam as bamio

    return bamio.BamWriter(path, header)
