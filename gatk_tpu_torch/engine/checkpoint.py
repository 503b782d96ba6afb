# Copied verbatim from gatk_tpu/engine/checkpoint.py; only import lines may differ.
"""Per-interval-shard checkpoint/resume for scatter-gather tools.

Reference pattern: the scatter-gather workflows checkpoint at shard
granularity — a failed run re-runs only unfinished shards (SURVEY §5.4c:
ShardingVCFWriter GATKTool.java:929, WDL per-shard retries; also
RampedHaplotypeCaller's serialized intermediate state,
haplotypecaller/RampedHaplotypeCaller.java:1-30).

Layout: <dir>/shard_<contig>_<start>_<end>.vcf written atomically (tmp +
rename) after a shard completes; the rename is the commit point, so a killed
run never leaves a half-written shard marked done. Re-running the same
command skips completed shards and produces the identical output.
"""
from __future__ import annotations

import os

from ..io import vcf as vcfio


class ShardCheckpointer:
    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)

    def _path(self, interval) -> str:
        return os.path.join(
            self.dir, f"shard_{interval.contig}_{interval.start}_{interval.end}.vcf")

    def is_done(self, interval) -> bool:
        return os.path.exists(self._path(interval))

    def load(self, interval) -> list:
        """Records of a completed shard (in written order)."""
        return list(vcfio.VcfReader(self._path(interval)))

    def load_lines(self, interval) -> list[str]:
        """Raw data lines of a completed shard — byte-exact resume path."""
        with open(self._path(interval)) as fh:
            return [line.rstrip("\n") for line in fh if not line.startswith("#")]

    def save_lines(self, interval, lines):
        """Atomically persist a completed shard's formatted data lines."""
        path = self._path(interval)
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            fh.write("##fileformat=VCFv4.2\n")
            fh.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
            for line in lines:
                fh.write(line.rstrip("\n") + "\n")
        os.replace(tmp, path)

    def save(self, interval, variants, sample_names=(), header_lines=()):
        """Atomically persist a completed shard."""
        path = self._path(interval)
        tmp = path + ".tmp"
        w = vcfio.VcfWriter(tmp, list(sample_names),
                            extra_header_lines=list(header_lines))
        for v in variants:
            w.write(v)
        w.close()
        os.replace(tmp, path)

    def completed(self) -> list[str]:
        return sorted(f for f in os.listdir(self.dir)
                      if f.startswith("shard_") and f.endswith(".vcf"))
