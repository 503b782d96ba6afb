# Copied verbatim from gatk_tpu/cnv/cnv_io.py; only import lines may differ.
"""Readers/writers for copy-number formats.

Reference behavior: tools/copynumber/formats/collections/*.java (SAM-style
@-header + TSV body), gcnvkernel io_* modules.
"""
from __future__ import annotations

import os

import numpy as np


def read_counts_tsv(path: str):
    """(sample_name, contigs, starts, ends, counts) from a CollectReadCounts TSV."""
    sample = None
    rows = []
    with open(path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if line.startswith("@"):
                if line.startswith("@RG"):
                    for f in line.split("\t"):
                        if f.startswith("SM:"):
                            sample = f[3:]
                continue
            if line.startswith("CONTIG"):
                continue
            if line:
                rows.append(line.split("\t"))
    contigs = [r[0] for r in rows]
    starts = np.array([int(r[1]) for r in rows])
    ends = np.array([int(r[2]) for r in rows])
    counts = np.array([int(r[3]) for r in rows])
    return sample, contigs, starts, ends, counts


def read_ploidy_priors(path: str):
    """{contig: np.ndarray of priors over ploidy 0..K}."""
    out = {}
    with open(path) as fh:
        header = fh.readline().rstrip("\n").split("\t")
        for line in fh:
            f = line.rstrip("\n").split("\t")
            if not f or not f[0]:
                continue
            out[f[0]] = np.array([float(x) for x in f[1:]])
    return out


def read_interval_list(path: str):
    """[(contig, start_1b, end_1b)] from a Picard .interval_list."""
    out = []
    with open(path) as fh:
        for line in fh:
            if line.startswith("@") or not line.strip():
                continue
            f = line.split("\t")
            out.append((f[0], int(f[1]), int(f[2])))
    return out


def write_contig_ploidy_calls(outdir: str, sample: str, contigs, ploidies, gqs,
                              read_depth: float, depth_var: float):
    d = os.path.join(outdir, sample)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "contig_ploidy.tsv"), "w") as fh:
        fh.write(f"@RG\tID:GATKCopyNumber\tSM:{sample}\n")
        fh.write("CONTIG\tPLOIDY\tPLOIDY_GQ\n")
        for c, p, g in zip(contigs, ploidies, gqs):
            fh.write(f"{c}\t{int(p)}\t{g}\n")
    with open(os.path.join(d, "global_read_depth.tsv"), "w") as fh:
        fh.write(f"@RG\tID:GATKCopyNumber\tSM:{sample}\n")
        fh.write("GLOBAL_READ_DEPTH\tAVERAGE_PLOIDY\n")
        fh.write(f"{read_depth}\t{depth_var}\n")
    with open(os.path.join(d, "sample_name.txt"), "w") as fh:
        fh.write(sample + "\n")


def read_contig_ploidy_calls(calls_dir: str):
    """{sample: {contig: ploidy}} plus read depths from a contig-ploidy-calls dir."""
    out = {}
    depths = {}
    for name in sorted(os.listdir(calls_dir)):
        d = os.path.join(calls_dir, name)
        cp = os.path.join(d, "contig_ploidy.tsv")
        if not os.path.isfile(cp):
            continue
        sample = None
        ploidies = {}
        with open(cp) as fh:
            for line in fh:
                if line.startswith("@RG"):
                    for f in line.rstrip().split("\t"):
                        if f.startswith("SM:"):
                            sample = f[3:]
                elif not line.startswith("CONTIG") and line.strip():
                    f = line.split("\t")
                    ploidies[f[0]] = int(f[1])
        sn = os.path.join(d, "sample_name.txt")
        if sample is None and os.path.isfile(sn):
            sample = open(sn).read().strip()
        out[sample] = ploidies
        gd = os.path.join(d, "global_read_depth.tsv")
        if os.path.isfile(gd):
            with open(gd) as fh:
                for line in fh:
                    if not line.startswith(("@", "GLOBAL")):
                        depths[sample] = float(line.split("\t")[0])
    return out, depths
