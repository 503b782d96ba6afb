"""A BAM writer with its .bai, for the benchmark's own reads.

Frozen copy of the record layout of gatk_tpu_torch/io/bam.py (BamWriter and
_reg2bin) and of the BGZF framing of gatk_tpu_torch/io/bgzf.py, as of the
port's first benchmark, with the index written beside it per the SAM
specification (section 5.2: bins, chunks, the 16 kb linear index and the
pseudo-bin of counts). Records are laid out in numpy for the whole file; only
reads with a CIGAR of more than one operation are packed one by one. It
imports nothing of the program.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

BLOCK = 0xFF00  # uncompressed bytes in a BGZF block, as htslib writes them
EOF = bytes.fromhex("1f8b08040000000000ff0600424302001b0003000000000000000000")
_NT16 = np.zeros(256, np.uint8)
for _i, _c in enumerate("=ACMGRSVTWYHKDBN"):
    _NT16[ord(_c)] = _i
PSEUDO_BIN = 37450
RG_TAG = b"RGZrg1\x00"


def reg2bin(beg, end):
    """SAM spec reg2bin over numpy arrays of [beg, end)."""
    beg = np.asarray(beg, np.int64)
    end = np.asarray(end, np.int64) - 1
    out = np.zeros(beg.shape, np.int64)
    done = np.zeros(beg.shape, bool)
    for shift, base in ((14, 4681), (17, 585), (20, 73), (23, 9), (26, 1)):
        hit = ~done & ((beg >> shift) == (end >> shift))
        out[hit] = base + (beg[hit] >> shift)
        done |= hit
    return out


def _bgzf_blocks(payload, level):
    """(compressed bytes, compressed offset of each block)."""
    out, offsets, off = [], [], 0
    for k in range(0, len(payload), BLOCK):
        raw = payload[k : k + BLOCK]
        c = zlib.compressobj(level, zlib.DEFLATED, -15)
        data = c.compress(raw) + c.flush()
        head = struct.pack("<4BI2BH2BHH", 31, 139, 8, 4, 0, 0, 255, 6, 66, 67, 2,
                           len(data) + 25)
        block = head + data + struct.pack("<II", zlib.crc32(raw) & 0xFFFFFFFF, len(raw))
        offsets.append(off)
        off += len(block)
        out.append(block)
    offsets.append(off)  # where the EOF block starts
    return b"".join(out) + EOF, np.array(offsets, np.int64)


def _voffset(u, coffsets):
    u = np.asarray(u, np.int64)
    return (coffsets[u // BLOCK] << 16) | (u % BLOCK)


def write_bam(path, contig, length, sample, pos, bases, quals, flag, cigars, names,
              mate_pos, tlen, mapq=60, level=1):
    """Write `path` and `path`.bai: one contig, reads sorted by (pos, name),
    each named r<k> for its fragment k (`names`), bases and quals (n, L)
    uint8, SAM flags, the mate's position and the template length of each
    (mates on the same contig), cigars {read index: (ops, lens)} for reads
    that are not L matches."""
    n, L = bases.shape
    text = (f"@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:{contig}\tLN:{length}\n"
            f"@RG\tID:rg1\tSM:{sample}\n").encode()
    cname = contig.encode() + b"\x00"
    header = (b"BAM\x01" + struct.pack("<i", len(text)) + text + struct.pack("<i", 1)
              + struct.pack("<i", len(cname)) + cname + struct.pack("<i", length))

    n_frag = int(np.max(names)) + 1 if n else 0
    width = len(str(max(n_frag - 1, 0)))
    table = np.frombuffer(b"".join(b"r%0*d\x00" % (width, k) for k in range(n_frag)),
                          np.uint8).reshape(n_frag, width + 2)
    names = table[np.asarray(names, np.int64)]
    codes = _NT16[bases]
    if L % 2:
        codes = np.concatenate([codes, np.zeros((n, 1), np.uint8)], axis=1)
    seq4 = (codes[:, 0::2] << 4) | codes[:, 1::2]
    ref_len = np.full(n, L, np.int64)
    for i, (ops, lens) in cigars.items():
        ref_len[i] = int(lens[(ops == 0) | (ops == 2) | (ops == 3)].sum())
    end = pos + ref_len
    bins = reg2bin(pos, end)
    flag = np.asarray(flag, np.int64)

    # fixed-width records for reads of one operation, packed as a table
    l_name = width + 2
    fixed = np.empty(n, dtype=np.dtype([
        ("block_size", "<i4"), ("ref_id", "<i4"), ("pos", "<i4"), ("bin_mq_nl", "<u4"),
        ("flag_nc", "<u4"), ("l_seq", "<i4"), ("next_ref", "<i4"), ("next_pos", "<i4"),
        ("tlen", "<i4"), ("name", "u1", (l_name,)), ("cigar", "<u4"),
        ("seq", "u1", (seq4.shape[1],)), ("qual", "u1", (L,)), ("tag", "u1", (len(RG_TAG),))]))
    fixed["block_size"] = fixed.dtype.itemsize - 4
    fixed["ref_id"] = 0
    fixed["pos"] = pos
    fixed["bin_mq_nl"] = (bins << 16) | (mapq << 8) | l_name
    fixed["flag_nc"] = (flag << 16) | 1
    fixed["l_seq"] = L
    fixed["next_ref"] = 0
    fixed["next_pos"] = mate_pos
    fixed["tlen"] = tlen
    fixed["name"] = names
    fixed["cigar"] = (L << 4) | 0
    fixed["seq"] = seq4
    fixed["qual"] = quals
    fixed["tag"] = np.frombuffer(RG_TAG, np.uint8)
    rec_bytes = fixed.view(np.uint8).reshape(n, fixed.dtype.itemsize)
    sizes = np.full(n, fixed.dtype.itemsize, np.int64)
    if cigars:  # splice in the reads of several operations
        parts, prev = [], 0
        for i in sorted(cigars):
            ops, lens = cigars[i]
            cig = ((lens.astype(np.uint32) << 4) | ops.astype(np.uint32)).astype("<u4").tobytes()
            body = (struct.pack("<iiIIiiii", 0, int(pos[i]),
                                (int(bins[i]) << 16) | (mapq << 8) | l_name,
                                (int(flag[i]) << 16) | len(ops), L, 0, int(mate_pos[i]),
                                int(tlen[i]))
                    + names[i].tobytes() + cig + seq4[i].tobytes() + quals[i].tobytes()
                    + RG_TAG)
            parts.append(rec_bytes[prev:i].tobytes())
            parts.append(struct.pack("<i", len(body)) + body)
            sizes[i] = 4 + len(body)
            prev = i + 1
        parts.append(rec_bytes[prev:].tobytes())
        records = b"".join(parts)
    else:
        records = rec_bytes.tobytes()
    payload = header + records
    data, coffsets = _bgzf_blocks(payload, level)
    with open(path, "wb") as fh:
        fh.write(data)

    starts_u = len(header) + np.concatenate([[0], np.cumsum(sizes)[:-1]])
    beg_v = _voffset(starts_u, coffsets)
    end_v = _voffset(starts_u + sizes, coffsets)
    write_bai(path + ".bai", pos, end, bins, beg_v, end_v)


def write_bai(path, pos, end, bins, beg_v, end_v):
    """The .bai of one contig's sorted reads: each bin's chunks (runs of
    records adjacent in the file merged), the linear index (per 16 kb window,
    the smallest offset of a read overlapping it) and the pseudo-bin."""
    chunks = {}
    for b, v0, v1 in zip(bins.tolist(), beg_v.tolist(), end_v.tolist()):
        cur = chunks.get(b)
        if cur and cur[-1][1] == v0:
            cur[-1][1] = v1
        else:
            chunks.setdefault(b, []).append([v0, v1])
    n_win = int((end.max() - 1) >> 14) + 1 if len(end) else 0
    linear = np.full(n_win, np.iinfo(np.int64).max, np.int64)
    w0, w1 = pos >> 14, (end - 1) >> 14
    np.minimum.at(linear, w0, beg_v)
    far = w1 != w0
    for k in range(1, int((w1 - w0).max()) + 1 if len(pos) else 1):
        sel = far & (w0 + k <= w1)
        np.minimum.at(linear, w0[sel] + k, beg_v[sel])
    # a window no read overlaps takes the next window's offset (never higher
    # than any offset a query starting there needs)
    for k in range(n_win - 2, -1, -1):
        if linear[k] == np.iinfo(np.int64).max:
            linear[k] = linear[k + 1]
    linear[linear == np.iinfo(np.int64).max] = 0
    out = [b"BAI\x01", struct.pack("<i", 1), struct.pack("<i", len(chunks) + 1)]
    for b in sorted(chunks):
        out.append(struct.pack("<Ii", b, len(chunks[b])))
        out.append(b"".join(struct.pack("<QQ", v0, v1) for v0, v1 in chunks[b]))
    out.append(struct.pack("<Ii", PSEUDO_BIN, 2))
    out.append(struct.pack("<QQ", int(beg_v.min()), int(end_v.max())))
    out.append(struct.pack("<QQ", len(pos), 0))
    out.append(struct.pack("<i", n_win))
    out.append(linear.astype("<u8").tobytes())
    out.append(struct.pack("<Q", 0))  # reads without a coordinate
    with open(path, "wb") as fh:
        fh.write(b"".join(out))
