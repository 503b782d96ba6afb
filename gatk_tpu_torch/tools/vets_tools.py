# Copied verbatim from gatk_tpu/tools/vets_tools.py; only import lines may differ.
"""VETS: scalable variant-annotation training/scoring (the VQSR successor).

Reference: tools/walkers/vqsr/scalable/ —
  ExtractVariantAnnotations.java (label sites from training/calibration
  resources, write annotations HDF5 + sites-only VCF),
  TrainVariantAnnotationsModel.java (per-variant-type model training with the
  isolation-forest backend of resources/...scalable/isolation-forest.py,
  writing .trainingScores.hdf5 / .calibrationScores.hdf5 / scorer),
  ScoreVariantAnnotations.java (score each input site, convert to calibration
  sensitivity = 1 - ECDF(score) per VariantAnnotationsScorer.java:61-67, and
  FILTER with LOW_SCORE when sensitivity >= threshold).

The annotations HDF5 layout matches LabeledVariantAnnotationsData.writeHDF5
(/annotations/{chunk_0,names,num_chunks,num_columns,num_rows} + /labels/*),
so files interoperate with the reference's python backend.
"""
from __future__ import annotations

import argparse
import json
import os
import pickle

import numpy as np

from ..cli import register_tool
from ..io import vcf as vcfio

SCORE_KEY = "SCORE"
CALIBRATION_SENSITIVITY_KEY = "CALIBRATION_SENSITIVITY"
LOW_SCORE_FILTER_NAME = "LOW_SCORE"

ANNOT_SUFFIX = ".annot.hdf5"
TRAINING_SCORES_SUFFIX = ".trainingScores.hdf5"
CALIBRATION_SCORES_SUFFIX = ".calibrationScores.hdf5"
SCORES_SUFFIX = ".scores.hdf5"
SCORER_SUFFIX = ".scorer.pkl"


def _variant_type(v) -> str:
    return "SNP" if v.is_snp() else "INDEL"


def _parse_resource_args(values):
    """--resource name,training=true,calibration=true:path (Barclay tagged arg)."""
    out = []
    for spec in values:
        tags, _, path = spec.rpartition(":")
        parts = tags.split(",")
        labels = set()
        for p in parts[1:]:
            k, _, val = p.partition("=")
            if val.lower() == "true":
                labels.add(k)
        out.append((labels, path))
    return out


def write_annotations_hdf5(path, names, matrix, labels):
    import h5py

    with h5py.File(path, "w") as f:
        f.create_dataset("/annotations/chunk_0", data=np.asarray(matrix, np.float64))
        f.create_dataset("/annotations/names",
                         data=np.array([n.encode() for n in names]))
        f.create_dataset("/annotations/num_chunks", data=1)
        f.create_dataset("/annotations/num_columns", data=len(names))
        f.create_dataset("/annotations/num_rows", data=len(matrix))
        for key, arr in labels.items():
            f.create_dataset(f"/labels/{key}", data=np.asarray(arr, np.float64))


def read_annotations_hdf5(path):
    import h5py

    with h5py.File(path, "r") as f:
        names = [n.decode() if isinstance(n, bytes) else str(n)
                 for n in f["/annotations/names"][()]]
        num_chunks = int(f["/annotations/num_chunks"][()])
        chunks = [f[f"/annotations/chunk_{i}"][()] for i in range(num_chunks)]
        matrix = np.concatenate(chunks, axis=0) if chunks else np.zeros((0, len(names)))
        labels = {}
        if "labels" in f:
            for key in f["labels"]:
                labels[key] = f[f"/labels/{key}"][()]
    return names, matrix, labels


def _write_scores_hdf5(path, scores):
    import h5py

    with h5py.File(path, "w") as f:
        f.create_dataset("/data/scores", data=np.asarray(scores, np.float64))


def _read_scores_hdf5(path):
    import h5py

    with h5py.File(path, "r") as f:
        return f["/data/scores"][()]


@register_tool("ExtractVariantAnnotations")
def extract_variant_annotations(argv):
    """Extract site-level annotations and training/calibration labels to HDF5."""
    p = argparse.ArgumentParser(description="ExtractVariantAnnotations")
    p.add_argument("-V", "--variant", required=True)
    p.add_argument("-O", "--output", required=True, help="output prefix")
    p.add_argument("-A", "--use-annotation", action="append", required=True)
    p.add_argument("--resource", action="append", default=[],
                   help="name,training=true,calibration=true:path")
    p.add_argument("--mode", action="append", choices=["SNP", "INDEL"],
                   default=None)
    args = p.parse_args(argv)

    modes = set(args.mode or ["SNP"])
    resources = _parse_resource_args(args.resource)
    resource_sites = []  # (labels, set of (contig,pos,ref,alt))
    for labels, path in resources:
        sites = set()
        for v in vcfio.VcfReader(path):
            for alt in v.alts:
                sites.add((v.contig, v.pos, v.ref, alt))
        resource_sites.append((labels, sites))

    names = list(args.use_annotation)
    rows, row_training, row_calibration, row_snp = [], [], [], []
    kept = []
    reader = vcfio.VcfReader(args.variant)
    for v in reader:
        if _variant_type(v) not in modes:
            continue
        training = calibration = False
        for labels, sites in resource_sites:
            if any((v.contig, v.pos, v.ref, alt) in sites for alt in v.alts):
                training |= "training" in labels
                calibration |= "calibration" in labels
        if not (training or calibration):
            continue  # unlabeled sites are reservoir-sampled in the reference; off by default
        row = [float(v.info[a]) if a in v.info and v.info[a] not in (".", "")
               else np.nan for a in names]
        rows.append(row)
        row_training.append(1.0 if training else 0.0)
        row_calibration.append(1.0 if calibration else 0.0)
        row_snp.append(1.0 if v.is_snp() else 0.0)
        kept.append(v)

    write_annotations_hdf5(
        args.output + ANNOT_SUFFIX, names,
        np.array(rows, np.float64).reshape(len(rows), len(names)),
        {"training": row_training, "calibration": row_calibration, "snp": row_snp})
    w = vcfio.VcfWriter(args.output + ".vcf", [], write_format=False)
    for v in kept:
        w.write(vcfio.Variant(contig=v.contig, pos=v.pos, ref=v.ref, alts=v.alts,
                              qual=v.qual, filters=(), info={}))
    w.close()
    print(f"extracted {len(rows)} labeled sites -> {args.output}{ANNOT_SUFFIX}")
    return 0


class IsolationForestScorer:
    """sklearn IsolationForest + median imputation (isolation-forest.py parity)."""

    def __init__(self, names, imputer, forest):
        self.names = list(names)
        self.imputer = imputer
        self.forest = forest

    def score(self, names, matrix):
        assert list(names) == self.names, "annotation names differ from training"
        return self.forest.score_samples(self.imputer.transform(matrix))


@register_tool("TrainVariantAnnotationsModel")
def train_variant_annotations_model(argv):
    """Train per-variant-type isolation-forest scorers from extracted annotations."""
    p = argparse.ArgumentParser(description="TrainVariantAnnotationsModel")
    p.add_argument("--annotations-hdf5", required=True)
    p.add_argument("-O", "--output", required=True, help="output prefix")
    p.add_argument("--mode", action="append", choices=["SNP", "INDEL"], default=None)
    p.add_argument("--hyperparameters-json", default=None)
    args = p.parse_args(argv)

    import sklearn.ensemble
    import sklearn.impute

    hyper = {"random_state": 0}
    if args.hyperparameters_json:
        hyper.update(json.load(open(args.hyperparameters_json)))

    names, matrix, labels = read_annotations_hdf5(args.annotations_hdf5)
    training = labels.get("training", np.ones(len(matrix))) > 0.5
    calibration = labels.get("calibration", np.zeros(len(matrix))) > 0.5
    is_snp = labels.get("snp", np.ones(len(matrix))) > 0.5

    modes = args.mode or ["SNP"]
    for mode in modes:
        tag = "." + mode.lower()
        sel = is_snp if mode == "SNP" else ~is_snp
        train_rows = matrix[training & sel]
        if len(train_rows) == 0:
            continue
        imputer = sklearn.impute.SimpleImputer(strategy="median")
        x = imputer.fit_transform(train_rows)
        forest = sklearn.ensemble.IsolationForest(**hyper)
        forest.fit(x)
        scorer = IsolationForestScorer(names, imputer, forest)
        with open(args.output + tag + SCORER_SUFFIX, "wb") as fh:
            pickle.dump(scorer, fh)
        _write_scores_hdf5(args.output + tag + TRAINING_SCORES_SUFFIX,
                           scorer.score(names, train_rows))
        calib_rows = matrix[calibration & sel]
        if len(calib_rows):
            _write_scores_hdf5(args.output + tag + CALIBRATION_SCORES_SUFFIX,
                               scorer.score(names, calib_rows))
        print(f"{mode}: trained on {len(train_rows)} sites "
              f"({len(calib_rows)} calibration) -> {args.output}{tag}{SCORER_SUFFIX}")
    return 0


@register_tool("ScoreVariantAnnotations")
def score_variant_annotations(argv):
    """Score input variants with a trained model; annotate SCORE and
    CALIBRATION_SENSITIVITY, filter LOW_SCORE above the sensitivity threshold."""
    p = argparse.ArgumentParser(description="ScoreVariantAnnotations")
    p.add_argument("-V", "--variant", required=True)
    p.add_argument("-O", "--output", required=True, help="output prefix")
    p.add_argument("-A", "--use-annotation", action="append", required=True)
    p.add_argument("--model-prefix", required=True)
    p.add_argument("--mode", action="append", choices=["SNP", "INDEL"], default=None)
    p.add_argument("--snp-calibration-sensitivity-threshold", type=float, default=None)
    p.add_argument("--indel-calibration-sensitivity-threshold", type=float, default=None)
    args = p.parse_args(argv)

    names = list(args.use_annotation)
    modes = set(args.mode or ["SNP"])

    scorers, calib_scores = {}, {}
    for mode in ("SNP", "INDEL"):
        tag = "." + mode.lower()
        scorer_path = args.model_prefix + tag + SCORER_SUFFIX
        if os.path.exists(scorer_path):
            with open(scorer_path, "rb") as fh:
                scorers[mode] = pickle.load(fh)
        calib_path = args.model_prefix + tag + CALIBRATION_SCORES_SUFFIX
        if os.path.exists(calib_path):
            calib_scores[mode] = np.sort(_read_scores_hdf5(calib_path))

    def sensitivity(mode, score):
        """1 - ECDF(score) over the calibration scores
        (VariantAnnotationsScorer.createScoreToCalibrationSensitivityConverter)."""
        cal = calib_scores.get(mode)
        if cal is None or len(cal) == 0:
            return None
        return 1.0 - np.searchsorted(cal, score, side="right") / len(cal)

    thresholds = {"SNP": args.snp_calibration_sensitivity_threshold,
                  "INDEL": args.indel_calibration_sensitivity_threshold}

    reader = vcfio.VcfReader(args.variant)
    variants = list(reader)
    scored_rows, scored_idx, scored_mode = [], [], []
    for i, v in enumerate(variants):
        mode = _variant_type(v)
        if mode not in modes or mode not in scorers:
            continue
        row = [float(v.info[a]) if a in v.info and v.info[a] not in (".", "")
               else np.nan for a in names]
        scored_rows.append(row)
        scored_idx.append(i)
        scored_mode.append(mode)

    all_scores = np.full(len(scored_rows), np.nan)
    for mode in set(scored_mode):
        sel = [j for j, m in enumerate(scored_mode) if m == mode]
        if sel:
            sub = np.array([scored_rows[j] for j in sel], np.float64)
            all_scores[sel] = scorers[mode].score(names, sub)

    for j, i in enumerate(scored_idx):
        v = variants[i]
        mode = scored_mode[j]
        score = float(all_scores[j])
        v.info[SCORE_KEY] = f"{score:.4f}"
        sens = sensitivity(mode, score)
        if sens is not None:
            v.info[CALIBRATION_SENSITIVITY_KEY] = f"{sens:.4f}"
            thr = thresholds[mode]
            if thr is not None and sens >= thr:
                v.filters = tuple(sorted(set(v.filters) - {"PASS", "."} | {LOW_SCORE_FILTER_NAME}))
            elif not v.filters or v.filters == (".",):
                v.filters = ("PASS",)

    _write_scores_hdf5(args.output + SCORES_SUFFIX, all_scores)
    header = [
        f'##INFO=<ID={SCORE_KEY},Number=1,Type=Float,Description="Score according to the model applied by ScoreVariantAnnotations">',
        f'##INFO=<ID={CALIBRATION_SENSITIVITY_KEY},Number=1,Type=Float,Description="Calibration sensitivity corresponding to the score of the site">',
        f'##FILTER=<ID={LOW_SCORE_FILTER_NAME},Description="Site failed low-score filter applied by ScoreVariantAnnotations.">',
    ]
    w = vcfio.VcfWriter(args.output + ".vcf", reader.samples,
                        extra_header_lines=reader.header_lines + header)
    for v in variants:
        w.write(v)
    w.close()
    print(f"scored {len(scored_rows)} sites -> {args.output}.vcf")
    return 0
