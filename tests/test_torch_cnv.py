"""The germline CNV path of the port (gatk_tpu_torch) against gatk_tpu, on the CPU.

Both packages get the same numpy inputs: a synthetic cohort of 6 samples x 300
intervals over 3 autosomes, X and Y (utils/synthetic.write_cnv_cohort, seed
1), whose contig changes break the HMM's chains; the gcnv gate also on 32
samples x 400 intervals, wide enough for the model's 5 bias factors.
gatk_tpu runs its jitted jnp code, the port its PyTorch code on the CPU,
where the copy-number HMM runs its plain version
(ops/cnv_hmm.hmm_forward_backward_reference).

Tolerances, and why:
  * model pieces (NegBin log pmf, emissions, loss, gradients, scale M-steps,
    one ADAM step): relative 1e-5 of the largest magnitude, float32 against
    float32 with another lgamma and another order of sums; the gradient of
    log_alpha sums digamma terms, whose implementations differ more (2e-4).
  * the HMM on the same inputs: 1e-4 absolute on log posteriors (log joints
    of 300 intervals reach |2e3|, where a float32 step is 1.2e-4); the whole
    posterior pass, emissions included: 2e-3.
  * fits: the copy-number calls are equal, CNLP within 1 phred (a log
    posterior differing in the 4th decimal rounds to the neighbouring phred
    integer now and then).
"""
import contextlib
import io
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from gatk_tpu.cli import TOOL_REGISTRY as JAX_TOOLS
from gatk_tpu.cnv import denoising as jax_den
from gatk_tpu_torch import cli as port_cli
from gatk_tpu_torch import devices
from gatk_tpu_torch.cnv import cnv_io
from gatk_tpu_torch.cnv import denoising as port_den
from gatk_tpu_torch.ops import cnv_hmm
from gatk_tpu_torch.utils import synthetic
from tests.test_torch_pairhmm import one_torch_thread  # noqa: F401

GERMLINE_TOOLS = ("CollectReadCounts", "DetermineGermlineContigPloidy", "GermlineCNVCaller",
                  "PostprocessGermlineCNVCalls")
SOMATIC_TOOLS = ("PreprocessIntervals", "AnnotateIntervals", "FilterIntervals",
                 "CollectAllelicCounts", "CreateReadCountPanelOfNormals", "DenoiseReadCounts",
                 "ModelSegments", "CallCopyRatioSegments")
# the gates chip_smoke.py holds the card's run to
EVENT_SHARE, BASELINE_SHARE = 0.95, 0.99


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """6 samples x 300 intervals, 6 planted events of 10-15 intervals, a weak
    rank-5 bias (the small cohort runs the model without bias factors, which
    6 samples cannot constrain: gatk_tpu's model fits the events into them)."""
    d = str(tmp_path_factory.mktemp("torch_cnv"))
    return synthetic.write_cnv_cohort(d, seed=1, n_samples=6, n_intervals=300, n_events=6,
                                      event_len=(10, 15), factor_sd=0.05)


def _model_inputs(coh):
    """The arrays GermlineCNVCaller hands the model (cnv_tools.py:95-122)."""
    counts = np.stack([cnv_io.read_counts_tsv(p)[4] for p in coh["counts"]])
    contigs = [c for c, _, _ in coh["intervals"]]
    uniq = {c: i for i, c in enumerate(dict.fromkeys(contigs))}
    mids = np.array([(s + e) / 2.0 for _, s, e in coh["intervals"]])
    lengths = np.array([e - s + 1 for _, s, e in coh["intervals"]], float)
    return (counts, coh["baseline"], np.array([uniq[c] for c in contigs]),
            np.abs(np.diff(mids)), lengths)


def _models(coh, cfg=None):
    args = _model_inputs(coh)
    return (jax_den.GermlineDenoisingModel(*args[:4], interval_lengths=args[4], config=cfg),
            port_den.GermlineDenoisingModel(*args[:4], interval_lengths=args[4], config=cfg,
                                            device="cpu"))


def _perturbed(params, seed):
    """gatk_tpu's initial parameters moved off their start, as numpy."""
    rng = np.random.default_rng(seed)
    return {k: (np.asarray(v) + rng.normal(0, 0.1, np.shape(v))).astype(np.float32)
            for k, v in params.items()}


def _to_jax(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def _to_port(p):
    return {k: torch.as_tensor(v) for k, v in p.items()}


def _close(got, want, rel=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


def test_nb_logpmf_matches():
    rng = np.random.default_rng(0)
    y = rng.poisson(150, 1000).astype(np.float32)
    mu = rng.uniform(0.5, 600, 1000).astype(np.float32)
    alpha = rng.uniform(5, 200, 1000).astype(np.float32)
    want = np.asarray(jax_den._nb_logpmf(*(jnp.asarray(a) for a in (y, mu, alpha))))
    got = port_den._nb_logpmf(*(torch.as_tensor(a) for a in (y, mu, alpha))).numpy()
    _close(got, want)


def test_initial_parameters_are_identical(cohort):
    jm, pm = _models(cohort)
    for k in port_den.PARAM_NAMES:
        np.testing.assert_array_equal(pm.params[k].numpy(), np.asarray(jm.params[k]))
    np.testing.assert_array_equal(pm.distances.numpy(), np.asarray(jm.distances))


def test_emission_loss_gradient_and_scale_steps_match(cohort):
    jm, pm = _models(cohort)
    p = _perturbed(jm.params, 1)
    _close(pm._emission(_to_port(p)).numpy(), jm._emission(_to_jax(p)))
    q = np.exp(np.asarray(jm._posteriors(_to_jax(p))))
    want_loss, want_grad = jax.value_and_grad(jm._loss)(_to_jax(p), jnp.asarray(q))
    loss, grad = pm._loss_and_grad(_to_port(p), torch.as_tensor(q))
    _close(loss.numpy(), want_loss)
    for k in port_den.PARAM_NAMES:
        _close(grad[k].numpy(), want_grad[k], rel=2e-4 if k == "log_alpha" else 1e-5)
    want = jm._closed_form_scale_updates(_to_jax(p), jnp.asarray(q))
    got = pm._closed_form_scale_updates(_to_port(p), torch.as_tensor(q))
    for k in ("log_d", "b"):
        _close(got[k].numpy(), want[k])


def test_one_adam_step_matches(cohort):
    """gatk_tpu's ADAM arithmetic (denoising.py:201-205) on its own gradient,
    against the port's step, from the same moments at step t = 3."""
    jm, pm = _models(cohort)
    p = _perturbed(jm.params, 2)
    m, v = _perturbed(jm.params, 3), {k: np.abs(x) for k, x in _perturbed(jm.params, 4).items()}
    q = np.exp(np.asarray(jm._posteriors(_to_jax(p))))
    _, g = jax.value_and_grad(jm._loss)(_to_jax(p), jnp.asarray(q))
    b1, b2, eps, t = 0.9, 0.999, 1e-8, 3
    new_p, new_m, new_v, _ = pm._adam_step(_to_port(p), _to_port(m), _to_port(v),
                                           torch.as_tensor(q), t)
    for k in port_den.PARAM_NAMES:
        want_m = b1 * m[k] + (1 - b1) * np.asarray(g[k])
        want_v = b2 * v[k] + (1 - b2) * np.asarray(g[k]) ** 2
        want_p = p[k] - jm.cfg.learning_rate * (want_m / (1 - b1 ** t)) / (
            np.sqrt(want_v / (1 - b2 ** t)) + eps)
        rel = 2e-4 if k == "log_alpha" else 1e-5
        _close(new_m[k].numpy(), want_m, rel)
        _close(new_v[k].numpy(), want_v, 2 * rel)
        _close(new_p[k].numpy(), want_p, rel)


def _jax_hmm(log_em, log_pi, stay):
    """gatk_tpu's posterior pass on given emissions and priors: its
    per-sample transitions (denoising.py:140-147) and _hmm_forward_backward."""
    eye = jnp.eye(log_em.shape[2])
    stay = jnp.asarray(stay)

    def per_sample(le, lp):
        trans = jnp.log(stay[:, None, None] * eye[None]
                        + (1.0 - stay)[:, None, None] * jnp.exp(lp[1:])[:, None, :])
        return jax_den._hmm_forward_backward(le[None], lp[0], trans)[0]

    return np.asarray(jax.vmap(per_sample)(jnp.asarray(log_em), jnp.asarray(log_pi)))


def _hmm_inputs(rng, S, T, C, stay):
    log_em = rng.normal(-5.0, 3.0, (S, T, C)).astype(np.float32)
    base = rng.integers(0, C, (S, 1, 1))
    pi = np.where(np.arange(C)[None, None, :] == base, 1.0 - (C - 1) * 1e-6, 1e-6)
    log_pi = np.broadcast_to(np.log(pi), (S, T, C)).astype(np.float32).copy()
    return log_em, log_pi, np.asarray(stay, np.float32)


@pytest.mark.parametrize("case", ["coherent", "T=1", "break everywhere", "stay=1"])
def test_hmm_plain_version_matches_gatk_tpu(case):
    """hmm_forward_backward_reference against gatk_tpu's pass on the same
    emissions, priors and stay probabilities, at the kernel's edges: a
    single interval, a chain break at every interval (stay 0) and no
    transitions at all (stay 1: off-diagonal log transitions are -inf)."""
    rng = np.random.default_rng(5)
    S, C = 4, 6
    T = {"coherent": 300, "T=1": 1}.get(case, 40)
    stay = {"break everywhere": np.zeros(T - 1), "stay=1": np.ones(T - 1)}.get(
        case, np.exp(-rng.uniform(500, 3000, T - 1) / 10000.0))
    if case == "coherent":
        stay[[99, 199]] = 0.0  # two chain breaks
    log_em, log_pi, stay = _hmm_inputs(rng, S, T, C, stay)
    got = cnv_hmm.hmm_forward_backward_reference(*map(torch.as_tensor, (log_em, log_pi, stay)))
    want = _jax_hmm(log_em, log_pi, stay)
    assert got.shape == (S, T, C) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("C", [33, 64])
def test_entry_matches_gatk_tpu_past_32_states(C):
    """The port's entry on CPU tensors (the plain version) against gatk_tpu's
    pass at more states than a warp has lanes (GermlineCNVCaller
    --max-copy-number 32 and 63), a coherent chain with a break: 1e-4
    absolute, as at 6 states."""
    rng = np.random.default_rng(C)
    T = 120
    stay = np.exp(-rng.uniform(500, 3000, T - 1) / 10000.0)
    stay[60] = 0.0
    log_em, log_pi, stay = _hmm_inputs(rng, 3, T, C, stay)
    got = cnv_hmm.hmm_forward_backward(*map(torch.as_tensor, (log_em, log_pi, stay)))
    assert got.shape == (3, T, C) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), _jax_hmm(log_em, log_pi, stay), atol=1e-4, rtol=0)


def test_entry_on_cpu_runs_the_plain_version_uncounted():
    rng = np.random.default_rng(6)
    args = [torch.as_tensor(a) for a in _hmm_inputs(rng, 2, 20, 6, np.full(19, 0.9))]
    entry = cnv_hmm.hmm_forward_backward
    before = (entry.passes, entry.launches, entry.cells)
    assert torch.equal(entry(*args), cnv_hmm.hmm_forward_backward_reference(*args))
    assert (entry.passes, entry.launches, entry.cells) == before


def test_posterior_pass_matches(cohort):
    jm, pm = _models(cohort)
    p = _perturbed(jm.params, 7)
    got = pm._posteriors(_to_port(p)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm._posteriors(_to_jax(p))), atol=2e-3, rtol=0)


@pytest.fixture(scope="module")
def short_fits(cohort):
    """4 rounds x 10 ADAM steps (2 warm-up rounds, 3 posterior passes)."""
    cfg = jax_den.DenoisingConfig(max_rounds=4, m_steps_per_round=10)
    jm, _ = _models(cohort, cfg)
    _, pm = _models(cohort, port_den.DenoisingConfig(max_rounds=4, m_steps_per_round=10))
    return jm.fit(), pm.fit()


def test_short_fit_gives_the_same_calls(short_fits):
    jm, pm = short_fits
    (cn_j, cnlp_j, cnq_j), (cn_p, cnlp_p, cnq_p) = jm.copy_number_calls(), pm.copy_number_calls()
    np.testing.assert_array_equal(cn_p, cn_j)
    assert np.abs(cnlp_p - cnlp_j).max() <= 1
    assert np.abs(cnq_p - cnq_j).max() <= 1
    np.testing.assert_allclose(pm.denoised_copy_ratios(), jm.denoised_copy_ratios(), rtol=1e-4)
    assert pm.stats["posteriors"]["calls"] == 3 and pm.stats["adam"]["calls"] == 40
    assert pm.stats["scale"]["calls"] == 8


def test_params_from_numpy_gives_gatk_tpu_posteriors(cohort, short_fits):
    jm, _ = short_fits
    _, pm = _models(cohort)
    pm.params_from_numpy({k: np.asarray(v) for k, v in jm.params.items()})
    np.testing.assert_allclose(pm._posteriors(pm.params).numpy(), jm.log_posteriors,
                               atol=2e-3, rtol=0)


def _quiet(fn, argv):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(argv)


@pytest.fixture(scope="module")
def germline_runs(cohort, tmp_path_factory):
    """DetermineGermlineContigPloidy, GermlineCNVCaller (--max-bias-factors 0)
    and PostprocessGermlineCNVCalls for every sample, through both CLIs, the
    port given --device cpu: {package: output dir}."""
    d = str(tmp_path_factory.mktemp("torch_cnv_cli"))
    inputs = sum((["-I", p] for p in cohort["counts"]), [])
    out = {}
    for pkg in ("jax", "port"):
        o = out[pkg] = os.path.join(d, pkg)

        def run(argv, pkg=pkg):
            if pkg == "jax":
                return _quiet(JAX_TOOLS[argv[0]], argv[1:])
            return _quiet(port_cli.main, argv)

        device = ["--device", "cpu"] if pkg == "port" else []
        assert run(["DetermineGermlineContigPloidy", *inputs, "--contig-ploidy-priors",
                    cohort["ploidy_priors"], "-O", o, "--output-prefix", "ploidy"]) == 0
        assert run(["GermlineCNVCaller", *inputs, "--contig-ploidy-calls",
                    os.path.join(o, "ploidy-calls"), "-O", o, "--output-prefix", "gcnv",
                    "--max-bias-factors", "0", *device]) == 0
        for si in range(len(cohort["samples"])):
            assert run(["PostprocessGermlineCNVCalls", "--calls-shard-path",
                        os.path.join(o, "gcnv-calls"), "--sample-index", str(si),
                        "--output-genotyped-intervals", os.path.join(o, f"sample{si}.vcf")]) == 0
    return out


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def test_ploidy_calls_are_identical_and_planted(cohort, germline_runs):
    for s in cohort["samples"]:
        for name in ("contig_ploidy.tsv", "global_read_depth.tsv", "sample_name.txt"):
            path = os.path.join("ploidy-calls", s, name)
            assert _read(os.path.join(germline_runs["port"], path)) == _read(
                os.path.join(germline_runs["jax"], path))
    calls, _ = cnv_io.read_contig_ploidy_calls(os.path.join(germline_runs["port"], "ploidy-calls"))
    assert calls == cohort["ploidy"]


def test_gcnv_calls_are_identical(germline_runs):
    shard = [os.path.join(germline_runs[pkg], "gcnv-calls") for pkg in ("jax", "port")]
    np.testing.assert_array_equal(np.load(os.path.join(shard[1], "cn.npy")),
                                  np.load(os.path.join(shard[0], "cn.npy")))
    for name in ("cnlp.npy", "cnq.npy"):
        diff = np.load(os.path.join(shard[1], name)) - np.load(os.path.join(shard[0], name))
        assert np.abs(diff).max() <= 1
    for name in ("samples.txt", "intervals.tsv"):
        assert _read(os.path.join(shard[1], name)) == _read(os.path.join(shard[0], name))


def _vcf_fields(path):
    """Every record's fields, with CNLP split out as integers."""
    out = []
    for ln in _read(path).decode().splitlines():
        if ln.startswith("#"):
            out.append((ln, None))
            continue
        f = ln.split("\t")
        gt, cn, cnlp, cnq = f[9].split(":")
        out.append(("\t".join(f[:9] + [gt, cn]), [int(x) for x in cnlp.split(",")] + [int(cnq)]))
    return out


def test_postprocessed_vcfs_agree(cohort, germline_runs):
    """Each package's VCF from its own calls: identical but for CNLP and CNQ,
    which are within 1 phred; and the port's PostprocessGermlineCNVCalls on
    gatk_tpu's calls writes gatk_tpu's VCF byte for byte."""
    for si in range(len(cohort["samples"])):
        got = _vcf_fields(os.path.join(germline_runs["port"], f"sample{si}.vcf"))
        want = _vcf_fields(os.path.join(germline_runs["jax"], f"sample{si}.vcf"))
        assert [g[0] for g in got] == [w[0] for w in want]
        assert max(np.abs(np.subtract(g[1], w[1])).max() for g, w in zip(got, want)
                   if w[1] is not None) <= 1
    out = os.path.join(germline_runs["port"], "sample0.from_jax.vcf")
    assert _quiet(port_cli.main, ["PostprocessGermlineCNVCalls", "--calls-shard-path",
                                  os.path.join(germline_runs["jax"], "gcnv-calls"),
                                  "--sample-index", "0", "--output-genotyped-intervals", out]) == 0
    assert _read(out) == _read(os.path.join(germline_runs["jax"], "sample0.vcf"))


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_planted_events_are_called(cohort, germline_runs, pkg):
    """The gate of chip_smoke.py's gcnv phase, met by gatk_tpu as by the port:
    the planted CN on >= 95 % of the event intervals, the baseline on >= 99 %
    of the others."""
    cn = np.load(os.path.join(germline_runs[pkg], "gcnv-calls", "cn.npy"))
    events, baseline = synthetic.cnv_call_concordance(cohort, cn)
    assert events >= EVENT_SHARE and baseline >= BASELINE_SHARE, (events, baseline)


def _fit_calls(pkg, coh):
    """Copy-number calls of one package's model fitted at DenoisingConfig's
    defaults (5 bias factors), as GermlineCNVCaller fits it."""
    model = _models(coh)[pkg == "port"]
    model.fit()
    return model.copy_number_calls()[0]


def _wide_cohort(tmp_path_factory, bias_rank):
    """32 samples, as on the card, over 400 intervals: 12 events of 10-30
    intervals and a rank-`bias_rank` bias of the card's strength."""
    d = str(tmp_path_factory.mktemp(f"torch_cnv_rank{bias_rank}"))
    return synthetic.write_cnv_cohort(d, seed=0, n_samples=32, n_intervals=400, n_events=12,
                                      event_len=(10, 30), bias_rank=bias_rank)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_gate_with_five_bias_factors(tmp_path_factory, pkg):
    """The gcnv gate on a cohort wide enough for the model's 5 bias factors,
    whose bias has rank 5 as on the card: met by gatk_tpu as by the port."""
    coh = _wide_cohort(tmp_path_factory, 5)
    events, baseline = synthetic.cnv_call_concordance(coh, _fit_calls(pkg, coh))
    assert events >= EVENT_SHARE and baseline >= BASELINE_SHARE, (events, baseline)


def test_rank3_bias_falls_under_the_gate(tmp_path_factory):
    """A fault of gatk_tpu's model (ROADMAP §3): with fewer true bias factors
    (3) than its 5, the warm-up rounds spend the spare factors on whole
    samples' events, which are then called at baseline (0.62 of the event
    intervals here); the other intervals keep their baseline."""
    coh = _wide_cohort(tmp_path_factory, 3)
    events, baseline = synthetic.cnv_call_concordance(coh, _fit_calls("jax", coh))
    assert events < EVENT_SHARE and baseline >= BASELINE_SHARE, (events, baseline)


def test_collect_read_counts_is_identical(tmp_path):
    sample = synthetic.write_sample(str(tmp_path), seed=3, length=4000, n_reads=1500, n_snv=4,
                                    n_indel=2)
    intervals = tmp_path / "bins.interval_list"
    intervals.write_text("@HD\tVN:1.6\n@SQ\tSN:chrM\tLN:4000\n" + "".join(
        f"chrM\t{1 + 250 * k}\t{250 * (k + 1)}\t+\t.\n" for k in range(16)))
    out = {}
    for pkg in ("jax", "port"):
        out[pkg] = str(tmp_path / f"{pkg}.counts.tsv")
        argv = ["-I", sample["bam"], "-L", str(intervals), "-O", out[pkg]]
        if pkg == "jax":
            assert _quiet(JAX_TOOLS["CollectReadCounts"], argv) == 0
        else:
            assert _quiet(port_cli.main, ["CollectReadCounts", *argv]) == 0
    assert _read(out["port"]) == _read(out["jax"])
    assert b"\tSM:SYN1\n" in _read(out["port"])


def test_every_cnv_tool_is_registered():
    for tools in (GERMLINE_TOOLS, SOMATIC_TOOLS):
        assert set(tools) <= set(port_cli.TOOL_REGISTRY) and set(tools) <= set(JAX_TOOLS)


def test_cohort_writer_plants_what_it_reports(cohort):
    """The writer's contract: XX and XY samples, events on the autosomes at CN
    0, 1, 3 or 4 with the counts following the copy number."""
    assert {cohort["ploidy"][s]["X"] for s in cohort["samples"]} == {1, 2}
    assert len(cohort["events"]) == 6
    counts = np.stack([cnv_io.read_counts_tsv(p)[4] for p in cohort["counts"]])
    for si, a, b, c in cohort["events"]:
        assert c in (0, 1, 3, 4) and 10 <= b - a + 1 <= 15
        ratio = counts[si, a : b + 1].mean() / np.median(counts[si, cohort["baseline"][si] == 2])
        assert abs(ratio - c / 2.0) < 0.25 + 0.1 * c, (si, a, b, c, ratio)


def test_default_device_is_cuda_and_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(devices, "_DEFAULT_DEVICE", torch.device("cuda"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        devices.resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_den.GermlineDenoisingModel(np.ones((2, 3)), np.full((2, 3), 2), np.zeros(3, int),
                                        np.ones(2))
    assert devices.resolve_device("cpu") == torch.device("cpu")
