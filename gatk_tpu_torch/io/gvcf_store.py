# Copied verbatim from gatk_tpu/io/gvcf_store.py; only import lines may differ.
"""Columnar cohort GVCF store (the GenomicsDB/TileDB equivalent).

Reference behavior: tools/genomicsdb/GenomicsDBImport.java:195 (per-sample GVCF
import into a columnar variant store; batching; incremental import) and its use
by GenotypeGVCFs / CombineGVCFs through `gendb://<workspace>` inputs
(engine/FeatureDataSource.java:68 GENOMIC_DB_URI_SCHEME).

TPU-first design: instead of a TileDB array with JNI, the workspace is a
directory of per-(contig, sample) packed numpy columns — a position index
(int64 sorted array for O(log n) interval queries via searchsorted) plus a
record blob with offsets. Imports are embarrassingly parallel over samples and
appends are new files, so multi-host scatter imports need no coordination.
"""
from __future__ import annotations

import json
import os

import numpy as np

from .vcf import VcfReader, Variant, parse_vcf_line, variant_to_line

SCHEME = "gendb://"
META_FILE = "__metadata.json"


def is_gendb_path(path: str) -> bool:
    return path.startswith(SCHEME)


def workspace_dir(path: str) -> str:
    return path[len(SCHEME):] if path.startswith(SCHEME) else path


class GvcfStore:
    def __init__(self, workspace: str):
        self.workspace = workspace_dir(workspace)
        meta_path = os.path.join(self.workspace, META_FILE)
        if not os.path.exists(meta_path):
            raise FileNotFoundError(meta_path)
        with open(meta_path) as fh:
            self.meta = json.load(fh)

    @property
    def samples(self):
        return self.meta["samples"]

    @property
    def contigs(self):
        return self.meta["contigs"]

    # ------------------------------------------------------------------
    @staticmethod
    def create(workspace: str):
        ws = workspace_dir(workspace)
        os.makedirs(ws, exist_ok=True)
        meta = {"samples": [], "contigs": [], "version": 1}
        with open(os.path.join(ws, META_FILE), "w") as fh:
            json.dump(meta, fh)
        return GvcfStore(ws)

    def _save_meta(self):
        with open(os.path.join(self.workspace, META_FILE), "w") as fh:
            json.dump(self.meta, fh)

    def import_gvcf(self, path: str, sample: str | None = None):
        """Import a single-sample GVCF; appendable (incremental import)."""
        reader = VcfReader(path)
        if len(reader.samples) != 1:
            raise ValueError(f"{path} must be a single-sample GVCF")
        sample = sample or reader.samples[0]
        if sample in self.meta["samples"]:
            raise ValueError(f"sample {sample} already imported")
        sidx = len(self.meta["samples"])
        self.meta["samples"].append(sample)

        by_contig = {}
        for line in reader._body:
            contig = line.split("\t", 1)[0]
            by_contig.setdefault(contig, []).append(line)

        for contig, lines in by_contig.items():
            if contig not in self.meta["contigs"]:
                self.meta["contigs"].append(contig)
            cdir = os.path.join(self.workspace, contig)
            os.makedirs(cdir, exist_ok=True)
            pos = np.array([int(ln.split("\t", 2)[1]) - 1 for ln in lines], np.int64)
            ends = np.empty(len(lines), np.int64)
            for i, ln in enumerate(lines):
                f = ln.split("\t", 8)
                end = pos[i] + len(f[3])
                if "END=" in f[7]:
                    for kv in f[7].split(";"):
                        if kv.startswith("END="):
                            end = int(kv[4:])
                            break
                ends[i] = end
            blob = "\n".join(lines).encode()
            offsets = np.zeros(len(lines) + 1, np.int64)
            np.cumsum([len(ln.encode()) + 1 for ln in lines], out=offsets[1:])
            np.savez_compressed(os.path.join(cdir, f"s{sidx:06d}.npz"),
                                pos=pos, end=ends,
                                blob=np.frombuffer(blob, np.uint8), offsets=offsets)
        self._save_meta()

    # ------------------------------------------------------------------
    def query(self, contig: str, start: int | None = None, end: int | None = None):
        """Per-sample record lists over [start, end) (0-based). Samples with no
        data on the contig get empty lists. Returns (samples, [records per sample])."""
        out = []
        cdir = os.path.join(self.workspace, contig)
        for sidx in range(len(self.samples)):
            path = os.path.join(cdir, f"s{sidx:06d}.npz")
            if not os.path.exists(path):
                out.append([])
                continue
            z = np.load(path)
            pos, ends, blob, offsets = z["pos"], z["end"], z["blob"].tobytes(), z["offsets"]
            if start is None:
                lo, hi = 0, len(pos)
            else:
                # records overlapping [start, end): pos < end and record end > start
                hi = int(np.searchsorted(pos, end, side="left"))
                lo = hi
                while lo > 0 and ends[lo - 1] > start:
                    lo -= 1
                # lo may overshoot for interleaved ends; scan back conservatively
                while lo > 0 and pos[lo - 1] >= start:
                    lo -= 1
            records = []
            for i in range(lo, hi):
                if start is not None and ends[i] <= start:
                    continue
                line = blob[offsets[i]:offsets[i + 1] - 1].decode()
                records.append(parse_vcf_line(line))
            out.append(records)
        return self.samples, out
