# Copied verbatim from gatk_tpu/vqsr/tranches.py; only import lines may differ.
"""Tranche file I/O (tools/walkers/vqsr/Tranche.java, TruthSensitivityTranche.java).

Format: '# Variant quality score tranches file' / '# Version number 4' header +
CSV with columns targetTruthSensitivity,numKnown,numNovel,knownTiTv,novelTiTv,
minVQSLod,filterName,model,accessibleTruthSites,callsAtTruthSites,truthSensitivity.
"""
from __future__ import annotations

from dataclasses import dataclass

COLUMNS = ["targetTruthSensitivity", "numKnown", "numNovel", "knownTiTv", "novelTiTv",
           "minVQSLod", "filterName", "model", "accessibleTruthSites",
           "callsAtTruthSites", "truthSensitivity"]


@dataclass
class Tranche:
    target_truth_sensitivity: float
    num_known: int
    num_novel: int
    known_titv: float
    novel_titv: float
    min_vqslod: float
    name: str
    model: str
    accessible_truth_sites: int = 0
    calls_at_truth_sites: int = 0
    truth_sensitivity: float = 0.0


def read_tranches(path: str):
    tranches = []
    with open(path) as fh:
        cols = None
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            f = line.split(",")
            if cols is None and f[0] == "targetTruthSensitivity":
                cols = f
                continue
            tranches.append(Tranche(
                target_truth_sensitivity=float(f[0]), num_known=int(f[1]),
                num_novel=int(f[2]), known_titv=float(f[3]), novel_titv=float(f[4]),
                min_vqslod=float(f[5]), name=f[6], model=f[7],
                accessible_truth_sites=int(f[8]), calls_at_truth_sites=int(f[9]),
                truth_sensitivity=float(f[10])))
    tranches.sort(key=lambda t: t.target_truth_sensitivity)
    return tranches


def write_tranches(path: str, tranches, mode: str):
    with open(path, "w") as fh:
        fh.write("# Variant quality score tranches file\n")
        fh.write("# Version number 4\n")
        fh.write(",".join(COLUMNS) + "\n")
        for t in sorted(tranches, key=lambda t: t.target_truth_sensitivity):
            fh.write(f"{t.target_truth_sensitivity:.2f},{t.num_known},{t.num_novel},"
                     f"{t.known_titv:.4f},{t.novel_titv:.4f},{t.min_vqslod:.4f},"
                     f"{t.name},{mode},{t.accessible_truth_sites},"
                     f"{t.calls_at_truth_sites},{t.truth_sensitivity:.4f}\n")
