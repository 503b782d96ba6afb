# Copied verbatim from gatk_tpu/io/bgzf.py; only import lines may differ.
"""BGZF (blocked gzip) codec — the container format of BAM/tabix files.

Equivalent of htsjdk's BlockCompressedInputStream/OutputStream (the reference's I/O
foundation; GATK defaults to the Intel GKL deflater, CommandLineProgram.java — here we
use zlib, with a C++ accelerated path planned in native/).

A BGZF file is a series of gzip members, each with a BSIZE extra field giving the
total compressed block size; uncompressed payloads are <= 65536 bytes. Virtual file
offsets are (compressed_block_offset << 16) | offset_within_uncompressed_block.
"""
from __future__ import annotations

import ctypes
import os
import struct
import zlib

# ---------------------------------------------------------------------------
# native multithreaded codec (native/bgzf/bgzf_native.cpp, GKL-deflater
# equivalent); loaded via ctypes with a transparent pure-python fallback
# ---------------------------------------------------------------------------
_NATIVE = None


def _load_native():
    global _NATIVE
    if _NATIVE is not None:
        return _NATIVE
    so = os.path.join(os.path.dirname(__file__), "..", "..", "native", "bgzf",
                      "libbgzf_native.so")
    so = os.path.abspath(so)
    if not os.path.exists(so) or os.environ.get("GATK_TPU_NO_NATIVE"):
        _NATIVE = False
        return False
    try:
        lib = ctypes.CDLL(so)
        lib.bgzf_compress.restype = ctypes.c_long
        lib.bgzf_compress.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_long,
            ctypes.c_int, ctypes.c_int]
        lib.bgzf_decompress_blocks.restype = ctypes.c_int
        lib.bgzf_decompress_blocks.argtypes = [
            ctypes.c_char_p, ctypes.c_long,
            ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_long),
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_long),
            ctypes.c_int]
        _NATIVE = lib
    except OSError:
        _NATIVE = False
    return _NATIVE


_N_THREADS = min(os.cpu_count() or 1, 8)

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)
_HEADER = struct.Struct("<4BI2B2H")  # magic..xlen


def _read_block_size(data: bytes, off: int) -> int:
    """Parse the BSIZE extra subfield of the gzip member starting at off."""
    if data[off : off + 2] != b"\x1f\x8b":
        raise ValueError(f"not a gzip block at offset {off}")
    xlen = struct.unpack_from("<H", data, off + 10)[0]
    xoff = off + 12
    end = xoff + xlen
    while xoff < end:
        si1, si2, slen = struct.unpack_from("<2BH", data, xoff)
        if si1 == 66 and si2 == 67:  # 'B','C'
            return struct.unpack_from("<H", data, xoff + 4)[0] + 1
        xoff += 4 + slen
    raise ValueError("BGZF BSIZE subfield missing")


def decompress_bytes(data: bytes) -> bytes:
    """Decompress a whole in-memory BGZF stream (parallel native path when
    available; the block table is parsed on the host either way)."""
    spans = []  # (cstart, clen, isize)
    off = 0
    n = len(data)
    total = 0
    while off < n:
        bsize = _read_block_size(data, off)
        xlen = struct.unpack_from("<H", data, off + 10)[0]
        cstart = off + 12 + xlen
        cend = off + bsize - 8
        isize = struct.unpack_from("<I", data, off + bsize - 4)[0]
        if cend > cstart and isize > 0:
            spans.append((cstart, cend - cstart, total, isize))
            total += isize
        off += bsize

    lib = _load_native()
    if lib and spans:
        out = ctypes.create_string_buffer(total)
        nb = len(spans)
        in_offs = (ctypes.c_long * nb)(*[s[0] for s in spans])
        in_lens = (ctypes.c_long * nb)(*[s[1] for s in spans])
        out_offs = (ctypes.c_long * nb)(*[s[2] for s in spans])
        out_lens = (ctypes.c_long * nb)(*[s[3] for s in spans])
        rc = lib.bgzf_decompress_blocks(data, nb, in_offs, in_lens, out, out_offs,
                                        out_lens, _N_THREADS)
        if rc == 0:
            return out.raw
    return b"".join(
        zlib.decompress(data[cs : cs + cl], wbits=-15) for cs, cl, _o, _i in spans
    )


def decompress_file(path: str) -> bytes:
    with open(path, "rb") as fh:
        return decompress_bytes(fh.read())


class BgzfReader:
    """Random-access BGZF reader supporting virtual offsets (for BAI/tabix)."""

    def __init__(self, path: str):
        with open(path, "rb") as fh:
            self._data = fh.read()
        self._cache_coffset = -1
        self._cache_block = b""
        self.blocks_read = 0  # decompressed-block count (index-efficiency tests)

    def _block_at(self, coffset: int) -> bytes:
        if coffset == self._cache_coffset:
            return self._cache_block
        self.blocks_read += 1
        data = self._data
        bsize = _read_block_size(data, coffset)
        xlen = struct.unpack_from("<H", data, coffset + 10)[0]
        cstart = coffset + 12 + xlen
        cend = coffset + bsize - 8
        block = zlib.decompress(data[cstart:cend], wbits=-15) if cend > cstart else b""
        self._cache_coffset = coffset
        self._cache_block = block
        self._cache_next = coffset + bsize
        return block

    def read_range(self, voffset_start: int, voffset_end: int) -> bytes:
        """Read uncompressed bytes between two virtual offsets."""
        out = []
        coff = voffset_start >> 16
        uoff = voffset_start & 0xFFFF
        end_coff = voffset_end >> 16
        end_uoff = voffset_end & 0xFFFF
        while True:
            block = self._block_at(coff)
            nxt = self._cache_next
            if coff == end_coff:
                out.append(block[uoff:end_uoff])
                break
            out.append(block[uoff:])
            uoff = 0
            coff = nxt
            if coff >= len(self._data):
                break
        return b"".join(out)


def compress_bytes(payload: bytes, level: int = 6) -> bytes:
    """Compress bytes into a BGZF stream (with EOF marker); parallel native
    path when available."""
    lib = _load_native()
    if lib and payload:
        n_blocks = -(-len(payload) // 0xFF00)
        cap = n_blocks * (0xFF00 + 1024 + 26)
        out_buf = ctypes.create_string_buffer(cap)
        w = lib.bgzf_compress(payload, len(payload), out_buf, cap, level, _N_THREADS)
        if w > 0:
            return out_buf.raw[:w] + BGZF_EOF
    out = []
    for off in range(0, len(payload), 65000):
        chunk = payload[off : off + 65000]
        co = zlib.compressobj(level, zlib.DEFLATED, -15)
        cdata = co.compress(chunk) + co.flush()
        bsize = len(cdata) + 26
        header = struct.pack(
            "<4BIBBHBBHH", 0x1F, 0x8B, 8, 4, 0, 0, 0xFF, 6, 66, 67, 2, bsize - 1
        )
        footer = struct.pack("<II", zlib.crc32(chunk) & 0xFFFFFFFF, len(chunk))
        out.append(header + cdata + footer)
    out.append(BGZF_EOF)
    return b"".join(out)
