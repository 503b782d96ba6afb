"""Variant scoring in the port (gatk_tpu_torch) against gatk_tpu, on the CPU:
the CNN of NVScoreVariants (calling/cnn_score.py: forward, one Adam step, a
short training), the reference architectures GATK_CNN_1D and GATK_CNN_2D
(calling/nvscore_models.py), and the tools VariantRecalibrator, ApplyVQSR,
FilterVariantTranches and NVScoreVariants through both CLIs (the port with
--device cpu). The same parameter dicts and inputs, made from seeds with numpy
(or a torch model initialised from a seed and saved, as
tests/test_nvscore_models.py does), go to both packages.
"""
import os
import re

import numpy as np
import pytest
import torch

from gatk_tpu.calling import cnn_score as jax_cnn
from gatk_tpu.calling import nvscore_models as jax_nv
from gatk_tpu.cli import TOOL_REGISTRY as JAX_TOOLS
from gatk_tpu_torch import cli as port_cli
from gatk_tpu_torch import devices
from gatk_tpu_torch.calling import cnn_score as port_cnn
from gatk_tpu_torch.calling import nvscore_models as port_nv
from gatk_tpu_torch.utils import synthetic
from tests.test_nvscore_models import TorchCNN1D, TorchCNN2D, _randomize_bn
from tests.test_torch_pairhmm import one_torch_thread  # noqa: F401

FORWARD_RTOL = 1e-5  # of the largest |logit|: float32 sums in other orders
STEP_TOL = 1e-6  # a parameter after one Adam step, where its gradient is not at rounding level
GRAD_TOL = 1e-6  # a gradient of the mean cross entropy
TRAIN_TOL = 1e-3  # a score after a short training
LR = 1e-3


def _inputs(seed, n):
    rng = np.random.default_rng(seed)
    ref = np.zeros((n, jax_cnn.WINDOW, 4), np.float32)
    ref[np.arange(n)[:, None], np.arange(jax_cnn.WINDOW)[None], rng.integers(0, 4, (n, 128))] = 1
    ann = rng.normal(30, 10, (n, len(jax_cnn.ANNOTATIONS))).astype(np.float32)
    return rng, ref, ann


def _params(ann):
    p = jax_cnn.init_params()
    p["ann_mean"] = ann.mean(axis=0).astype(np.float32)
    p["ann_std"] = np.maximum(ann.std(axis=0), 1e-3).astype(np.float32)
    return p


@pytest.mark.parametrize("seed,n", [(0, 1), (1, 50), (2, 300)])
def test_cnn_forward_matches_jax(seed, n):
    _, ref, ann = _inputs(seed, n)
    p = _params(ann)
    want = np.asarray(jax_cnn.forward(p, ref, ann))
    got = port_cnn.forward(port_cnn.params_to_torch(p, "cpu"), torch.from_numpy(ref),
                           torch.from_numpy(ann)).numpy()
    assert got.shape == want.shape == (n, 4)
    assert np.abs(got - want).max() <= FORWARD_RTOL * np.abs(want).max()


def test_params_cross_between_packages(tmp_path):
    """The same seed gives the same weights; an .npz either package writes,
    the other reads; params_to_torch and params_to_numpy are each other's
    inverse."""
    p = jax_cnn.init_params()
    q = port_cnn.init_params()
    assert p.keys() == q.keys() and all(np.array_equal(p[k], q[k]) for k in p)
    jax_cnn.save_weights(p, str(tmp_path / "j.npz"))
    port_cnn.save_weights(p, str(tmp_path / "p.npz"))
    for a, b in ((jax_cnn.load_weights(str(tmp_path / "p.npz")), p),
                 (port_cnn.load_weights(str(tmp_path / "j.npz")), p),
                 (port_cnn.params_to_numpy(port_cnn.params_to_torch(p, "cpu")), p)):
        assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)


def _jax_grads(p, ref, ann, labels):
    import jax
    import optax

    frozen = {k: p[k] for k in port_cnn.FROZEN}

    def loss(tr):
        logits = jax_cnn.forward({**tr, **frozen}, ref, ann)
        return optax.softmax_cross_entropy_with_integer_labels(logits, labels).mean()

    return {k: np.asarray(v) for k, v in jax.grad(loss)(
        {k: v for k, v in p.items() if k not in port_cnn.FROZEN}).items()}


def test_one_train_step_matches_jax():
    """One batch of `train` (50 variants, one epoch): the gradients of the mean
    cross entropy agree within GRAD_TOL, and the parameters after the Adam step
    within STEP_TOL wherever gatk_tpu's gradient is at least 1e-5. Adam's first
    step moves a parameter by lr g / (|g| + 1e-8), so where |g| is within a few
    eps of 0 the float32 rounding of g (4e-8 apart here) moves the step by up
    to lr; there the parameters agree within the step itself, 2 lr."""
    rng, ref, ann = _inputs(3, 50)
    labels = rng.integers(0, 4, 50)
    p = _params(ann)
    want_g = _jax_grads(p, ref, ann, labels)
    _, got_g = port_cnn.loss_and_grads(port_cnn.params_to_torch(p, "cpu"), torch.from_numpy(ref),
                                       torch.from_numpy(ann), torch.from_numpy(labels).long())
    assert want_g.keys() == got_g.keys()
    for k in want_g:
        assert np.abs(got_g[k].numpy() - want_g[k]).max() <= GRAD_TOL, k
    want = jax_cnn.train(jax_cnn.init_params(), ref, ann, labels, epochs=1)
    got = port_cnn.train(port_cnn.init_params(), ref, ann, labels, epochs=1, device="cpu")
    assert want.keys() == got.keys()
    n_small = 0
    for k in want:
        d = np.abs(got[k] - want[k])
        if k in port_cnn.FROZEN:
            assert np.array_equal(got[k], want[k])
            continue
        big = np.abs(want_g[k]) >= 1e-5
        n_small += int((~big).sum())
        assert d[big].max(initial=0) <= STEP_TOL, k
        assert d.max() <= 2 * LR, k
    assert n_small < 0.05 * sum(v.size for v in want_g.values())


def test_short_training_matches_jax():
    """train on 256 variants for 3 epochs (12 steps): the scores agree within
    TRAIN_TOL and have the same sign."""
    rng, ref, ann = _inputs(4, 256)
    labels = rng.integers(0, 4, 256)
    ann[labels % 2 == 1] += 15.0  # artifacts apart from true sites
    is_snp = labels < 2
    want = jax_cnn.score(jax_cnn.train(jax_cnn.init_params(), ref, ann, labels, epochs=3),
                         ref, ann, is_snp)
    got = port_cnn.score(port_cnn.train(port_cnn.init_params(), ref, ann, labels, epochs=3,
                                        device="cpu"), ref, ann, is_snp, device="cpu")
    assert np.abs(got - want).max() <= TRAIN_TOL
    assert np.array_equal(np.sign(got), np.sign(want))


def _nv_inputs(seed, n):
    rng = np.random.default_rng(seed)
    ref = np.zeros((n, 128, 4), np.float32)
    ref[np.arange(n)[:, None], np.arange(128)[None], rng.integers(0, 4, (n, 128))] = 1.0
    return rng, ref, rng.normal(30, 10, (n, 7)).astype(np.float32)


def test_forward_1d_matches_jax_and_torch(tmp_path):
    torch.manual_seed(0)
    model = TorchCNN1D().eval()
    _randomize_bn(model)
    pt = str(tmp_path / "w1d.pt")
    torch.save(model.state_dict(), pt)
    jp, pp = jax_nv.load_torch_1d(pt), port_nv.load_torch_1d(pt)
    assert jp.keys() == pp.keys() and all(np.array_equal(jp[k], pp[k]) for k in jp)
    _, ref, ann = _nv_inputs(0, 5)
    want = np.asarray(jax_nv.forward_1d(jp, ref, ann))
    got = port_nv.forward_1d(pp, ref, ann, device="cpu")
    assert isinstance(got, np.ndarray) and got.shape == (5, 4)
    assert np.abs(got - want).max() <= FORWARD_RTOL * np.abs(want).max()
    tp = port_nv.params_to_torch(pp, "cpu")
    with torch.no_grad():
        on_tensors = port_nv.forward_1d(tp, torch.from_numpy(ref), torch.from_numpy(ann))
        module = model({"reference": torch.from_numpy(ref),
                        "best_practices": torch.from_numpy(ann)})
    assert torch.equal(on_tensors, torch.from_numpy(got))
    assert (on_tensors - module).abs().max().item() <= FORWARD_RTOL * np.abs(want).max()


def test_forward_2d_matches_jax_and_torch(tmp_path):
    torch.manual_seed(2)
    model = TorchCNN2D().eval()
    _randomize_bn(model)
    pt = str(tmp_path / "w2d.pt")
    torch.save(model.state_dict(), pt)
    jp, pp = jax_nv.load_torch_2d(pt), port_nv.load_torch_2d(pt)
    rng = np.random.default_rng(2)
    reads = rng.random((2, 128, 128, 15)).astype(np.float32)
    ann = rng.normal(30, 10, (2, 7)).astype(np.float32)
    want = np.asarray(jax_nv.forward_2d(jp, reads, ann))
    got = port_nv.forward_2d(pp, reads, ann, device="cpu")
    assert np.abs(got - want).max() <= FORWARD_RTOL * np.abs(want).max()
    with torch.no_grad():
        module = model({"read_tensor": torch.from_numpy(reads),
                        "best_practices": torch.from_numpy(ann)}).numpy()
    assert np.abs(got - module).max() <= FORWARD_RTOL * np.abs(module).max()


# --------------------------------------------------------------------------- tools


@pytest.fixture(scope="module")
def callset(tmp_path_factory):
    """write_callset at 200 kb: 180 SNVs and 20 indels, a truth VCF and a
    GATK_CNN_1D .pt."""
    return synthetic.write_callset(str(tmp_path_factory.mktemp("callset")), seed=0,
                                   length=200_000, n_snv=180, n_indel=20)


def _both(tool, argv, out_dir, outputs, port_extra=()):
    """Runs `tool` in both packages with {out} in argv set to a directory of
    each; returns {package: [bytes of each output]}."""
    res = {}
    for name, run in (("jax", lambda a: JAX_TOOLS[tool](a)),
                      ("port", lambda a: port_cli.main([tool, *a, *port_extra]))):
        d = os.path.join(out_dir, name)
        os.makedirs(d, exist_ok=True)
        assert run([a.format(out=d) for a in argv]) == 0
        res[name] = []
        for f in outputs:
            with open(os.path.join(d, f), "rb") as fh:
                res[name].append(fh.read())
    return res


def _cnn_scores(vcf_bytes):
    out = {}
    for line in vcf_bytes.decode().splitlines():
        if not line.startswith("#"):
            f = line.split("\t")
            info = dict(kv.split("=", 1) for kv in f[7].split(";") if "=" in kv)
            out[int(f[1])] = float(info["CNN_1D"])
    return out


SCORE_TOL = 1e-5  # |CNN_1D port - gatk_tpu|: a difference of float32 logits near 0


def _same_but_scores(want, got):
    """Both VCFs alike in every byte but CNN_1D values, which agree within
    SCORE_TOL; returns {position: (gatk_tpu's, the port's)} where they differ
    in print (format_vcf_double), for the test to report."""
    strip = [re.sub(rb"CNN_1D=[^;\t\n]*", b"CNN_1D", v) for v in (want, got)]
    assert strip[0] == strip[1]
    w, g = _cnn_scores(want), _cnn_scores(got)
    assert w.keys() == g.keys()
    differing = {p: (w[p], g[p]) for p in w if w[p] != g[p]}
    assert all(abs(a - b) <= SCORE_TOL for a, b in differing.values()), differing
    if differing:
        print(f"CNN_1D differs in print at {len(differing)} of {len(w)} sites: {differing}")
    return differing


def test_nvscore_variants_npz_matches_jax(callset, tmp_path):
    """NVScoreVariants --model-weights .npz (gatk_tpu's CNN, init_params with
    the callset's annotation scale) in both packages: the VCFs are alike byte
    for byte but where a CNN_1D lies near 0, a difference of two float32
    logits, and prints differently (write_callset(seed=0) at 200 kb: one site,
    158318, 8.040e-04 against 8.043e-04)."""
    rows = []
    for line in open(callset["vcf"]):
        if not line.startswith("#"):
            info = dict(kv.split("=") for kv in line.split("\t")[7].split(";"))
            rows.append(jax_cnn.encode_annotations(info))
    weights = str(tmp_path / "cnn.npz")
    jax_cnn.save_weights(_params(np.stack(rows)), weights)
    res = _both("NVScoreVariants", ["-V", callset["vcf"], "-R", callset["fasta"], "-O",
                                    "{out}/scored.vcf", "--model-weights", weights],
                str(tmp_path), ["scored.vcf"], port_extra=["--device", "cpu"])
    differing = _same_but_scores(res["jax"][0], res["port"][0])
    assert len(differing) <= 2
    assert len(_cnn_scores(res["port"][0])) == len(callset["sites"])


def test_nvscore_variants_pt_matches_jax(callset, tmp_path):
    """NVScoreVariants --model-weights .pt (a GATK_CNN_1D state dict): as with
    the .npz (write_callset(seed=0) at 200 kb: one site, 128693, 0.0007521
    against 0.000752)."""
    res = _both("NVScoreVariants", ["-V", callset["vcf"], "-R", callset["fasta"], "-O",
                                    "{out}/scored.vcf", "--model-weights",
                                    callset["weights_1d"]],
                str(tmp_path), ["scored.vcf"], port_extra=["--device", "cpu"])
    differing = _same_but_scores(res["jax"][0], res["port"][0])
    assert len(differing) <= 2
    assert len(_cnn_scores(res["port"][0])) == len(callset["sites"])


def test_nvscore_variants_training_matches_jax(callset, tmp_path):
    """NVScoreVariants --truth-vcf (on-the-fly training, 2 epochs) and then
    FilterVariantTranches on gatk_tpu's scores in both packages."""
    res = _both("NVScoreVariants", ["-V", callset["vcf"], "-R", callset["fasta"], "-O",
                                    "{out}/scored.vcf", "--truth-vcf", callset["truth"],
                                    "--epochs", "2"],
                str(tmp_path), ["scored.vcf"], port_extra=["--device", "cpu"])
    want, got = _cnn_scores(res["jax"][0]), _cnn_scores(res["port"][0])
    assert want.keys() == got.keys()
    w, g = np.array(list(want.values())), np.array([got[p] for p in want])
    assert np.abs(w - g).max() <= TRAIN_TOL + 5e-4  # and CNN_1D printed to 3 decimals
    scored = os.path.join(str(tmp_path), "jax", "scored.vcf")
    res = _both("FilterVariantTranches", ["-V", scored, "-O", "{out}/filtered.vcf",
                                          "--resource", callset["truth"]],
                str(tmp_path / "fvt"), ["filtered.vcf"])
    assert res["port"] == res["jax"]
    assert b"CNN_1D_SNP_Tranche" in res["port"][0]


def test_nvscore_variants_on_cuda_raises_without_a_card(callset, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(devices, "_DEFAULT_DEVICE", torch.device("cuda"))
    argv = ["NVScoreVariants", "-V", callset["vcf"], "-R", callset["fasta"], "-O",
            str(tmp_path / "x.vcf"), "--model-weights", callset["weights_1d"]]
    for extra in ([], ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_cli.main(argv + extra)
    assert not (tmp_path / "x.vcf").exists()


def _write_vcf(path, rows, infos=("QD", "FS", "MQ")):
    with open(path, "w") as fh:
        fh.write("##fileformat=VCFv4.2\n")
        for k in infos:
            fh.write(f'##INFO=<ID={k},Number=1,Type=Float,Description="x">\n')
        fh.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        for r in rows:
            fh.write("\t".join(str(x) for x in r) + "\n")


def test_vqsr_identical_to_jax(tmp_path):
    """tests/test_vqsr.py:47-134's synthetic clusters through VariantRecalibrator
    (with --output-model) and ApplyVQSR at 99 % truth sensitivity: recal VCF,
    tranches, model report and filtered VCF byte-identical to gatk_tpu's,
    under that test's gates."""
    rng = np.random.default_rng(12)
    rows, truth_rows = [], []
    n_good, n_bad = 400, 400
    pos = 1000
    for i in range(n_good):
        qd, fs, mq = rng.normal(20, 2), abs(rng.normal(2, 1)), rng.normal(60, 2)
        rows.append(("20", pos, ".", "A", "G", 100, ".", f"QD={qd:.2f};FS={fs:.2f};MQ={mq:.2f}"))
        if i % 2 == 0:
            truth_rows.append(("20", pos, ".", "A", "G", 100, ".", "."))
        pos += 10
    for i in range(n_bad):
        qd, fs, mq = abs(rng.normal(2, 1)), rng.normal(30, 5), rng.normal(30, 5)
        rows.append(("20", pos, ".", "A", "T", 50, ".", f"QD={qd:.2f};FS={fs:.2f};MQ={mq:.2f}"))
        pos += 10
    input_vcf, truth_vcf = str(tmp_path / "input.vcf"), str(tmp_path / "truth.vcf")
    _write_vcf(input_vcf, rows)
    _write_vcf(truth_vcf, truth_rows)
    res = _both("VariantRecalibrator",
                ["-V", input_vcf, "-O", "{out}/out.recal.vcf", "--tranches-file",
                 "{out}/out.tranches", "-an", "QD", "-an", "FS", "-an", "MQ", "-mode", "SNP",
                 "--max-gaussians", "2", "--output-model", "{out}/model.report",
                 "--resource:truthres,known=false,training=true,truth=true,prior=15.0",
                 truth_vcf],
                str(tmp_path), ["out.recal.vcf", "out.tranches", "model.report"])
    assert res["port"] == res["jax"]
    recal = os.path.join(str(tmp_path), "port", "out.recal.vcf")
    tranches = os.path.join(str(tmp_path), "port", "out.tranches")
    res = _both("ApplyVQSR", ["-V", input_vcf, "--recal-file", recal, "--tranches-file",
                              tranches, "-mode", "SNP", "--truth-sensitivity-filter-level",
                              "99.0", "-O", "{out}/filtered.vcf"],
                str(tmp_path / "apply"), ["filtered.vcf"])
    assert res["port"] == res["jax"]
    status = {int(ln.split("\t")[1]): ln.split("\t")[6]
              for ln in res["port"][0].decode().splitlines() if not ln.startswith("#")}
    good_pass = np.mean([status[1000 + 10 * i] == "PASS" for i in range(n_good)])
    bad_pass = np.mean([status[1000 + 10 * (n_good + i)] == "PASS" for i in range(n_bad)])
    assert good_pass > 0.95
    assert bad_pass < 0.1
