# Copied verbatim from gatk_tpu/io/sam.py; only import lines may differ.
"""SAM flags, CIGAR, and header model (htsjdk SAMRecord/SAMFileHeader equivalents)."""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# SAM flags
PAIRED = 0x1
PROPER_PAIR = 0x2
UNMAPPED = 0x4
MATE_UNMAPPED = 0x8
REVERSE = 0x10
MATE_REVERSE = 0x20
FIRST_OF_PAIR = 0x40
SECOND_OF_PAIR = 0x80
SECONDARY = 0x100
FAILS_VENDOR_QUALITY = 0x200
DUPLICATE = 0x400
SUPPLEMENTARY = 0x800

CIGAR_OPS = "MIDNSHP=X"
OP_M, OP_I, OP_D, OP_N, OP_S, OP_H, OP_P, OP_EQ, OP_X = range(9)
# ops that consume read bases / reference bases
CONSUMES_READ = np.array([1, 1, 0, 0, 1, 0, 0, 1, 1], dtype=bool)
CONSUMES_REF = np.array([1, 0, 1, 1, 0, 0, 0, 1, 1], dtype=bool)

SEQ_NT16 = "=ACMGRSVTWYHKDBN"  # BAM 4-bit base codes
_NT16_TO_CHAR = np.frombuffer(SEQ_NT16.encode(), dtype=np.uint8)
_CHAR_TO_NT16 = np.zeros(256, dtype=np.uint8)
for _i, _c in enumerate(SEQ_NT16):
    _CHAR_TO_NT16[ord(_c)] = _i
    _CHAR_TO_NT16[ord(_c.lower())] = _i


@dataclass
class SequenceRecord:
    name: str
    length: int
    index: int
    md5: str | None = None

    def __repr__(self):
        return f"SequenceRecord({self.name}:{self.length})"


@dataclass
class SamHeader:
    text: str = ""
    sequences: list = field(default_factory=list)
    read_groups: list = field(default_factory=list)  # list of dicts of RG tags
    programs: list = field(default_factory=list)
    sort_order: str = "unknown"

    _name_to_index: dict = field(default_factory=dict)

    @classmethod
    def parse(cls, text: str, ref_names=None, ref_lengths=None):
        h = cls(text=text)
        seqs = []
        for line in text.splitlines():
            if not line.startswith("@"):
                continue
            fields = line.split("\t")
            tag = fields[0]
            kv = {}
            for f in fields[1:]:
                if ":" in f:
                    k, v = f.split(":", 1)
                    kv[k] = v
            if tag == "@SQ":
                seqs.append(
                    SequenceRecord(kv.get("SN", "?"), int(kv.get("LN", 0)), len(seqs), kv.get("M5"))
                )
            elif tag == "@RG":
                h.read_groups.append(kv)
            elif tag == "@PG":
                h.programs.append(kv)
            elif tag == "@HD":
                h.sort_order = kv.get("SO", "unknown")
        if not seqs and ref_names is not None:
            seqs = [
                SequenceRecord(n, int(l), i) for i, (n, l) in enumerate(zip(ref_names, ref_lengths))
            ]
        h.sequences = seqs
        h._name_to_index = {s.name: s.index for s in seqs}
        return h

    def sequence_index(self, name: str) -> int:
        return self._name_to_index[name]

    def sequence_length(self, name: str) -> int:
        return self.sequences[self._name_to_index[name]].length


def cigar_to_string(ops: np.ndarray, lens: np.ndarray) -> str:
    return "".join(f"{l}{CIGAR_OPS[o]}" for o, l in zip(ops, lens))


def cigar_from_string(s: str):
    ops, lens = [], []
    num = ""
    for ch in s:
        if ch.isdigit():
            num += ch
        elif ch == "*":
            break
        else:
            ops.append(CIGAR_OPS.index(ch))
            lens.append(int(num))
            num = ""
    return np.array(ops, np.uint8), np.array(lens, np.int32)


# plain-tuple lookup tables: these helpers run per read on 1-5 element cigars,
# where a python loop is ~20x faster than numpy fancy indexing
_CONSUMES_READ_T = (1, 1, 0, 0, 1, 0, 0, 1, 1)
_CONSUMES_REF_T = (1, 0, 1, 1, 0, 0, 0, 1, 1)


def cigar_read_length(ops, lens) -> int:
    n = 0
    for o, l in zip(ops, lens):
        if _CONSUMES_READ_T[o]:
            n += l
    return int(n)


def cigar_ref_length(ops, lens) -> int:
    n = 0
    for o, l in zip(ops, lens):
        if _CONSUMES_REF_T[o]:
            n += l
    return int(n)
