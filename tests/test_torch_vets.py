"""The port's copy of VETS (tools/vets_tools.py: ExtractVariantAnnotations,
TrainVariantAnnotationsModel, ScoreVariantAnnotations) against gatk_tpu's, on
the CPU, on tests/test_vets.py's synthetic call set.

The scorer's pickle names the package that wrote it, so the two .scorer.pkl
files differ in their bytes: the test unpickles both and holds the forests'
parameters and their scores on the same matrix equal. Every other file (the
extracted and scored VCFs, the .hdf5 annotations and scores) and what each
tool prints must be byte-identical.
"""
import pickle
import shutil

import numpy as np
import pytest

from tests.torch_tool_cases import REGISTRIES, read_tree, run


def _write_vcf(path, records, with_annots=True):
    with open(path, "w") as fh:
        fh.write("##fileformat=VCFv4.2\n")
        fh.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        for pos, ref, alt, qd, fs in records:
            info = f"QD={qd:.2f};FS={fs:.2f}" if with_annots else "."
            fh.write(f"chr1\t{pos}\t.\t{ref}\t{alt}\t100\t.\t{info}\n")


@pytest.fixture(scope="module")
def vets(tmp_path_factory):
    """tests/test_vets.py's data, with ten indels added for the INDEL mode:
    good sites (QD ~ N(20, 2), FS ~ N(2, 0.5)), outliers (QD ~ N(1.5, 0.5),
    FS ~ N(40, 5)), the good SNPs as the training resource and 40 of them for
    calibration. Each package runs Extract, Train and Score in turn in the same
    directory; returns {package: (the tools' (rc, stdout), {file: bytes})}."""
    d = tmp_path_factory.mktemp("vets")
    rng = np.random.default_rng(7)
    good = [(1000 + i, "A", "G", rng.normal(20, 2), abs(rng.normal(2, 0.5))) for i in range(120)]
    bad = [(9000 + i, "C", "T", abs(rng.normal(1.5, 0.5)), rng.normal(40, 5)) for i in range(12)]
    indels = [(5000 + 10 * i, "AT", "A", rng.normal(18, 2), abs(rng.normal(2, 0.5)))
              for i in range(10)]
    _write_vcf(str(d / "input.vcf"), sorted(good + bad + indels))
    _write_vcf(str(d / "training.vcf"), sorted(good + indels), with_annots=False)
    _write_vcf(str(d / "calib.vcf"), good[:40] + indels[:5], with_annots=False)
    out = {}
    w = d / "run"
    for pkg in REGISTRIES:
        shutil.rmtree(w, ignore_errors=True)
        w.mkdir()
        steps = [run(pkg, "ExtractVariantAnnotations", [
                     "-V", str(d / "input.vcf"), "-O", str(w / "extract"), "-A", "QD", "-A", "FS",
                     "--mode", "SNP", "--mode", "INDEL",
                     "--resource", f"train,training=true:{d / 'training.vcf'}",
                     "--resource", f"calib,calibration=true:{d / 'calib.vcf'}"]),
                 run(pkg, "TrainVariantAnnotationsModel", [
                     "--annotations-hdf5", str(w / "extract.annot.hdf5"), "-O", str(w / "train"),
                     "--mode", "SNP", "--mode", "INDEL"]),
                 run(pkg, "ScoreVariantAnnotations", [
                     "-V", str(d / "input.vcf"), "-O", str(w / "score"), "-A", "QD", "-A", "FS",
                     "--model-prefix", str(w / "train"), "--mode", "SNP", "--mode", "INDEL",
                     "--snp-calibration-sensitivity-threshold", "0.99",
                     "--indel-calibration-sensitivity-threshold", "0.99"])]
        out[pkg] = (steps, read_tree(w))
    return dict(out=out, good=good, bad=bad, indels=indels)


def test_vets_tools_identical_to_jax_but_the_pickle(vets):
    steps, files = vets["out"]["port"]
    jax_steps, jax_files = vets["out"]["jax"]
    assert steps == jax_steps
    assert [rc for rc, _ in steps] == [0, 0, 0]
    pickles = sorted(f for f in files if f.endswith(".scorer.pkl"))
    assert pickles == ["train.indel.scorer.pkl", "train.snp.scorer.pkl"]
    rest = {f: b for f, b in files.items() if f not in pickles}
    assert rest == {f: b for f, b in jax_files.items() if f not in pickles}
    for f in ("extract.annot.hdf5", "extract.vcf", "train.snp.trainingScores.hdf5",
              "train.snp.calibrationScores.hdf5", "train.indel.calibrationScores.hdf5",
              "score.scores.hdf5", "score.vcf"):
        assert rest[f], f
    for f in pickles:
        assert b"gatk_tpu_torch.tools.vets_tools" in files[f]
        assert b"gatk_tpu_torch" not in jax_files[f]


@pytest.mark.parametrize("mode", ["snp", "indel"])
def test_vets_scorers_unpickle_to_equal_forests(vets, mode):
    """The two packages' pickled scorers: the same annotation names, imputer
    medians and forest parameters, trees of the same shape, and equal scores
    on one matrix."""
    port = pickle.loads(vets["out"]["port"][1][f"train.{mode}.scorer.pkl"])
    jax = pickle.loads(vets["out"]["jax"][1][f"train.{mode}.scorer.pkl"])
    assert type(port).__module__ == "gatk_tpu_torch.tools.vets_tools"
    assert type(jax).__module__ == "gatk_tpu.tools.vets_tools"
    assert port.names == jax.names == ["QD", "FS"]
    assert np.array_equal(port.imputer.statistics_, jax.imputer.statistics_)
    assert port.forest.get_params() == jax.forest.get_params()
    assert len(port.forest.estimators_) == len(jax.forest.estimators_)
    for a, b in zip(port.forest.estimators_, jax.forest.estimators_):
        assert np.array_equal(a.tree_.feature, b.tree_.feature)
        assert np.array_equal(a.tree_.threshold, b.tree_.threshold)
    m = np.random.default_rng(1).normal([15, 10], [8, 15], (200, 2))
    m[::17, 1] = np.nan
    assert np.array_equal(port.score(["QD", "FS"], m), jax.score(["QD", "FS"], m))


def test_vets_outliers_filtered_and_good_sites_pass(vets):
    """tests/test_vets.py's gate on the port's scored VCF: every outlier is
    LOW_SCORE, at least 95 % of the good SNPs pass, and the sites carry SCORE
    and CALIBRATION_SENSITIVITY."""
    text = vets["out"]["port"][1]["score.vcf"].decode()
    rows = [l.split("\t") for l in text.splitlines() if not l.startswith("#")]
    by_pos = {int(r[1]): r for r in rows}
    assert all("LOW_SCORE" in by_pos[pos][6] for pos, *_ in vets["bad"])
    good = vets["good"]
    assert sum(by_pos[pos][6] == "PASS" for pos, *_ in good) >= 0.95 * len(good)
    assert "SCORE=" in by_pos[good[0][0]][7]
    assert "CALIBRATION_SENSITIVITY=" in by_pos[good[0][0]][7]
    assert all("SCORE=" in by_pos[pos][7] for pos, *_ in vets["indels"])
