# Copied verbatim from gatk_tpu/tools/hadoop_compat.py; only import lines may differ.
"""Hadoop/Spark-ecosystem compatibility utilities.

Reference behavior:
  * ConvertHeaderlessHadoopBamShardToBam.java:56-86 +
    utils/spark/SparkUtils.java (convertHeaderlessHadoopBamShardToBam):
    prepend a header and append a BGZF terminator to a headerless BAM shard.
  * spark/CreateHadoopBamSplittingIndex.java:60-150: write an htsjdk SBI
    splitting index (SBIIndexWriter format: magic, file length, MD5, UUID,
    record count, granularity, offset count, virtual offsets) and optionally
    a BAI.
  * spark/ParallelCopyGCSDirectoryIntoHDFSSpark.java: chunked parallel copy
    of a file or the files of a directory (subdirectories skipped). Without
    GCS/HDFS connectivity in this environment the same chunked fan-out runs
    over local/POSIX paths.
"""
from __future__ import annotations

import argparse
import bisect
import concurrent.futures as cf
import hashlib
import os
import shutil
import struct

from ..cli import register_tool
from ..io import bgzf

SBI_MAGIC = b"SBI\x01"
DEFAULT_GRANULARITY = 4096
CHUNK_SIZE = 64 * 1024 * 1024  # ParallelCopy...Spark.java:82 64MiB buffer


def _bam_header_span(u: bytes) -> int:
    """Byte length of the uncompressed BAM header block (magic..refs)."""
    if u[:4] != b"BAM\x01":
        raise ValueError("not a BAM stream")
    l_text = struct.unpack_from("<i", u, 4)[0]
    off = 8 + l_text
    n_ref = struct.unpack_from("<i", u, off)[0]
    off += 4
    for _ in range(n_ref):
        l_name = struct.unpack_from("<i", u, off)[0]
        off += 4 + l_name + 4
    return off


@register_tool("ConvertHeaderlessHadoopBamShardToBam")
def convert_headerless_shard(argv):
    """Make a headerless Spark BAM shard readable: recompress the donor BAM's
    header block, splice the shard's BGZF blocks after it, terminate."""
    p = argparse.ArgumentParser(description="ConvertHeaderlessHadoopBamShardToBam")
    p.add_argument("--bam-shard", required=True)
    p.add_argument("--bam-with-header", required=True)
    p.add_argument("-O", "--output", required=True)
    args = p.parse_args(argv)

    donor = bgzf.decompress_file(args.bam_with_header)
    header = donor[:_bam_header_span(donor)]
    header_blocks = bgzf.compress_bytes(header)
    if header_blocks.endswith(bgzf.BGZF_EOF):
        header_blocks = header_blocks[: -len(bgzf.BGZF_EOF)]
    shard = open(args.bam_shard, "rb").read()
    while shard.endswith(bgzf.BGZF_EOF):
        shard = shard[: -len(bgzf.BGZF_EOF)]
    with open(args.output, "wb") as out:
        out.write(header_blocks)
        out.write(shard)
        out.write(bgzf.BGZF_EOF)
    print(f"wrote {args.output} ({os.path.getsize(args.output)} bytes)")
    return 0


def _record_virtual_offsets(path):
    """(virtual offsets of every BAM record start, total records, file size)."""
    data = open(path, "rb").read()
    # block table: (uncompressed logical start, compressed offset)
    ustarts, coffs = [], []
    off, total_u = 0, 0
    while off < len(data):
        bsize = bgzf._read_block_size(data, off)
        isize = struct.unpack_from("<I", data, off + bsize - 4)[0]
        if isize > 0:
            ustarts.append(total_u)
            coffs.append(off)
            total_u += isize
        off += bsize
    u = bgzf.decompress_bytes(data)

    def voffset(pos):
        i = bisect.bisect_right(ustarts, pos) - 1
        return (coffs[i] << 16) | (pos - ustarts[i])

    offsets, count = [], 0
    pos = _bam_header_span(u)
    while pos < len(u):
        offsets.append(voffset(pos))
        count += 1
        pos += 4 + struct.unpack_from("<i", u, pos)[0]
    return offsets, count, len(data)


def write_sbi(bam_path, sbi_path, granularity=DEFAULT_GRANULARITY):
    """htsjdk SBIIndexWriter layout: magic, fileLength, md5(16), uuid(16),
    totalNumberOfRecords, granularity, numberOfOffsets, offsets[] — one entry
    per `granularity` records plus the end-of-file virtual offset."""
    offsets, count, file_len = _record_virtual_offsets(bam_path)
    sampled = offsets[::granularity]
    sampled.append(file_len << 16)
    with open(sbi_path, "wb") as out:
        out.write(SBI_MAGIC)
        out.write(struct.pack("<q", file_len))
        out.write(hashlib.md5(open(bam_path, "rb").read()).digest())
        out.write(b"\x00" * 16)  # UUID unset
        out.write(struct.pack("<qqq", count, granularity, len(sampled)))
        for v in sampled:
            out.write(struct.pack("<q", v))
    return count, len(sampled)


@register_tool("CreateHadoopBamSplittingIndex")
def create_splitting_index(argv):
    p = argparse.ArgumentParser(description="CreateHadoopBamSplittingIndex")
    p.add_argument("-I", "--input", required=True)
    p.add_argument("-O", "--output", default=None)
    p.add_argument("--splitting-index-granularity", type=int,
                   default=DEFAULT_GRANULARITY)
    p.add_argument("--create-bai", action="store_true")
    p.add_argument("--read-validation-stringency", default="SILENT")
    args = p.parse_args(argv)
    if args.splitting_index_granularity <= 0:
        raise ValueError("Granularity must be > 0")
    out = args.output or args.input + ".sbi"
    if not out.endswith(".sbi"):
        out += ".sbi"
    count, n_off = write_sbi(args.input, out, args.splitting_index_granularity)
    print(f"wrote {out}: {count} records, {n_off} offsets")
    if args.create_bai:
        from .sam_tools import build_bam_index

        build_bam_index(["-I", args.input])
    return 0


def _copy_chunk(src, dst, start, length):
    with open(src, "rb") as fi, open(dst, "r+b") as fo:
        fi.seek(start)
        fo.seek(start)
        remaining = length
        while remaining:
            buf = fi.read(min(remaining, 8 * 1024 * 1024))
            if not buf:
                break
            fo.write(buf)
            remaining -= len(buf)


def _parallel_copy_file(src, dst, chunk_size, pool):
    size = os.path.getsize(src)
    with open(dst, "wb") as fo:
        fo.truncate(size)
    futs = [pool.submit(_copy_chunk, src, dst, start,
                        min(chunk_size, size - start))
            for start in range(0, max(size, 1), chunk_size)]
    for f in futs:
        f.result()


@register_tool("ParallelCopyGCSDirectoryIntoHDFSSpark")
def parallel_copy_directory(argv):
    """Chunked parallel copy of a file or a directory's files (subdirectories
    skipped, as in the reference). gs://-to-HDFS specifics need cloud
    connectors unavailable here; local/POSIX paths use the same fan-out."""
    p = argparse.ArgumentParser(description="ParallelCopyGCSDirectoryIntoHDFSSpark")
    p.add_argument("--input-gcs-path", required=True)
    p.add_argument("--output-hdfs-directory", required=True)
    p.add_argument("--chunk-size", type=int, default=CHUNK_SIZE)
    args = p.parse_args(argv)
    src, outdir = args.input_gcs_path, args.output_hdfs_directory
    if src.startswith(("gs://", "hdfs://")) or outdir.startswith(
            ("gs://", "hdfs://")):
        raise ValueError("gs://,hdfs:// schemes require cloud connectors "
                         "unavailable in this build; use local paths")
    os.makedirs(outdir, exist_ok=True)
    files = ([src] if os.path.isfile(src) else
             [os.path.join(src, f) for f in sorted(os.listdir(src))
              if os.path.isfile(os.path.join(src, f))])
    copied = 0
    with cf.ThreadPoolExecutor(max_workers=min(16, os.cpu_count() or 4)) as pool:
        for f in files:
            dst = os.path.join(outdir, os.path.basename(f))
            _parallel_copy_file(f, dst, args.chunk_size, pool)
            shutil.copystat(f, dst)
            copied += 1
    print(f"copied {copied} file(s) to {outdir}")
    return 0
