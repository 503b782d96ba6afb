# Copied verbatim from gatk_tpu/io/reads.py; only import lines may differ.
"""Read model (GATKRead/SAMRecord equivalent) as numpy-backed records.

Positions are 0-based half-open internally (GATK uses 1-based closed in its public
API but htsjdk stores 0-based; we standardize on 0-based and convert at I/O edges).
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

from . import sam


@dataclass
class Read:
    name: str
    flag: int
    ref_id: int
    pos: int  # 0-based alignment start (POS-1); -1 if unmapped
    mapq: int
    cigar_ops: np.ndarray  # uint8
    cigar_lens: np.ndarray  # int32
    bases: np.ndarray  # uint8 ASCII
    quals: np.ndarray  # uint8 phred
    mate_ref_id: int = -1
    mate_pos: int = -1
    tlen: int = 0
    tags: dict = field(default_factory=dict)

    def __setattr__(self, name, value):
        # invalidate the cached alignment end whenever the alignment changes
        # (clipping/realignment mutate pos/cigar in place via _rebuild)
        if name == "pos" or name == "cigar_ops" or name == "cigar_lens":
            object.__setattr__(self, "_end_cache", None)
        object.__setattr__(self, name, value)

    @classmethod
    def make(cls, name, flag, ref_id, pos, mapq, cigar_ops, cigar_lens, bases,
             quals, mate_ref_id=-1, mate_pos=-1, tlen=0, tags=None):
        """Hot-path constructor: one __dict__.update instead of 13 __setattr__
        dispatches (BAM parse + per-region clipping create hundreds of
        thousands of Reads per interval)."""
        r = object.__new__(cls)
        r.__dict__.update(
            name=name, flag=flag, ref_id=ref_id, pos=pos, mapq=mapq,
            cigar_ops=cigar_ops, cigar_lens=cigar_lens, bases=bases,
            quals=quals, mate_ref_id=mate_ref_id, mate_pos=mate_pos, tlen=tlen,
            tags={} if tags is None else tags, _end_cache=None)
        return r

    # --- flag helpers -------------------------------------------------------------
    @property
    def is_unmapped(self):
        return bool(self.flag & sam.UNMAPPED)

    @property
    def is_paired(self):
        return bool(self.flag & sam.PAIRED)

    @property
    def is_reverse(self):
        return bool(self.flag & sam.REVERSE)

    @property
    def is_duplicate(self):
        return bool(self.flag & sam.DUPLICATE)

    @property
    def is_secondary(self):
        return bool(self.flag & sam.SECONDARY)

    @property
    def is_supplementary(self):
        return bool(self.flag & sam.SUPPLEMENTARY)

    @property
    def mate_is_unmapped(self):
        return bool(self.flag & sam.MATE_UNMAPPED)

    @property
    def is_first_of_pair(self):
        return bool(self.flag & sam.FIRST_OF_PAIR)

    @property
    def is_f1r2(self):
        """ReadUtils.isF1R2: reverse-strand != first-of-pair."""
        return self.is_reverse != self.is_first_of_pair

    @property
    def fails_vendor_quality(self):
        return bool(self.flag & sam.FAILS_VENDOR_QUALITY)

    def __len__(self):
        return len(self.bases)

    @property
    def end(self) -> int:
        """0-based exclusive reference end of the alignment (cached; the cache
        is invalidated by __setattr__ when pos/cigar change)."""
        e = self._end_cache
        if e is None:
            e = self.pos + sam.cigar_ref_length(self.cigar_ops, self.cigar_lens)
            object.__setattr__(self, "_end_cache", e)
        return e

    @property
    def read_group(self):
        return self.tags.get("RG")

    def unclipped_start(self) -> int:
        """Alignment start minus leading soft/hard clips (GATK getUnclippedStart)."""
        p = self.pos
        for o, l in zip(self.cigar_ops, self.cigar_lens):
            if o in (sam.OP_S, sam.OP_H):
                p -= int(l)
            else:
                break
        return p

    def unclipped_end(self) -> int:
        p = self.end
        for o, l in zip(self.cigar_ops[::-1], self.cigar_lens[::-1]):
            if o in (sam.OP_S, sam.OP_H):
                p += int(l)
            else:
                break
        return p

    def copy(self):
        return Read.make(
            self.name, self.flag, self.ref_id, self.pos, self.mapq,
            self.cigar_ops.copy(), self.cigar_lens.copy(), self.bases.copy(),
            self.quals.copy(), self.mate_ref_id, self.mate_pos, self.tlen,
            dict(self.tags),
        )


_TAG_FMT = {
    ord("c"): ("<b", 1), ord("C"): ("<B", 1), ord("s"): ("<h", 2), ord("S"): ("<H", 2),
    ord("i"): ("<i", 4), ord("I"): ("<I", 4), ord("f"): ("<f", 4), ord("A"): ("<c", 1),
}


_TAG_KEY_CACHE: dict = {}


def parse_tags(buf: bytes) -> dict:
    """Parse BAM auxiliary tags into a python dict (hot per-record path:
    interned 2-char keys, int.from_bytes instead of struct for scalars)."""
    tags = {}
    off = 0
    n = len(buf)
    from_bytes = int.from_bytes
    while off + 3 <= n:
        kraw = buf[off : off + 2]
        key = _TAG_KEY_CACHE.get(kraw)
        if key is None:
            key = _TAG_KEY_CACHE.setdefault(kraw, kraw.decode("ascii", "replace"))
        tp = buf[off + 2]
        off += 3
        if tp == 90 or tp == 72:  # Z / H
            endz = buf.index(0, off)
            tags[key] = buf[off:endz].decode("ascii", "replace")
            off = endz + 1
        elif tp == 105:  # i
            tags[key] = from_bytes(buf[off : off + 4], "little", signed=True)
            off += 4
        elif tp == 67:  # C
            tags[key] = buf[off]
            off += 1
        elif tp == 99:  # c
            v = buf[off]
            tags[key] = v - 256 if v > 127 else v
            off += 1
        elif tp == 83:  # S
            tags[key] = from_bytes(buf[off : off + 2], "little")
            off += 2
        elif tp == 115:  # s
            tags[key] = from_bytes(buf[off : off + 2], "little", signed=True)
            off += 2
        elif tp == 73:  # I
            tags[key] = from_bytes(buf[off : off + 4], "little")
            off += 4
        elif tp == 102:  # f
            (tags[key],) = struct.unpack_from("<f", buf, off)
            off += 4
        elif tp == 65:  # A
            tags[key] = chr(buf[off])
            off += 1
        elif tp == 66:  # B
            sub = buf[off]
            cnt = from_bytes(buf[off + 1 : off + 5], "little")
            fmt, sz = _TAG_FMT[sub]
            tags[key] = np.frombuffer(buf, dtype=np.dtype(fmt[1]), count=cnt,
                                      offset=off + 5).copy()
            off += 5 + cnt * sz
        else:
            raise ValueError(f"unknown tag type {chr(tp)} for {key}")
    return tags


def encode_tags(tags: dict) -> bytes:
    out = []
    for key, val in tags.items():
        kb = key.encode()
        if isinstance(val, str) and len(val) == 1 and key in ("XT",):
            out.append(kb + b"A" + val.encode())
        elif isinstance(val, str):
            out.append(kb + b"Z" + val.encode() + b"\x00")
        elif isinstance(val, (int, np.integer)):
            iv = int(val)
            if -2147483648 <= iv <= 2147483647:
                out.append(kb + b"i" + struct.pack("<i", iv))
            else:
                raise ValueError("tag int out of range")
        elif isinstance(val, (float, np.floating)):
            out.append(kb + b"f" + struct.pack("<f", float(val)))
        elif isinstance(val, np.ndarray):
            code = {np.dtype(np.int8): b"c", np.dtype(np.uint8): b"C",
                    np.dtype(np.int16): b"s", np.dtype(np.uint16): b"S",
                    np.dtype(np.int32): b"i", np.dtype(np.uint32): b"I",
                    np.dtype(np.float32): b"f"}[val.dtype]
            out.append(kb + b"B" + code + struct.pack("<I", len(val)) + val.tobytes())
        else:
            raise ValueError(f"cannot encode tag {key}={val!r}")
    return b"".join(out)
