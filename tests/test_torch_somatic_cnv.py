"""The somatic CNV path of the port (gatk_tpu_torch) against gatk_tpu, on the CPU.

The panel of normals' SVD runs in float32 on both sides (jnp without x64, and
torch.linalg.svd), so the singular vectors agree up to their signs and float32
rounding; the projection onto them and the denoised copy ratios agree within
1e-4 (float32 singular vectors of a 12 x ~270 panel, used in float64). The
MCMC chains draw other random numbers than gatk_tpu's (torch.Generator against
jax.random), so they agree in distribution: gatk_tpu's own assertions hold for
the port, and the two packages' posterior deciles agree within 0.03 (log2 copy
ratio) and 0.02 (minor-allele fraction), a few posterior widths. The host
tools are copies, and write gatk_tpu's bytes.
"""
import contextlib
import io
import os

import numpy as np
import pytest

from gatk_tpu.cli import TOOL_REGISTRY as JAX_TOOLS
from gatk_tpu.cnv import mcmc as jax_mcmc
from gatk_tpu.cnv import somatic as jax_somatic
from gatk_tpu_torch import cli as port_cli
from gatk_tpu_torch.cnv import mcmc, somatic
from gatk_tpu_torch.utils import synthetic
from tests.test_torch_pairhmm import one_torch_thread  # noqa: F401


def _quiet(fn, argv):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(argv)


def _run(pkg, argv):
    """One tool through gatk_tpu's registry or the port's CLI."""
    if pkg == "jax":
        return _quiet(JAX_TOOLS[argv[0]], argv[1:])
    return _quiet(port_cli.main, argv)


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def _pon_inputs():
    """test_somatic_cnv.py::test_pon_denoising_removes_systematic_bias's panel
    and case: 12 normals x 300 intervals with two latent noise factors, and a
    case with a 2x amplification over intervals 100-149."""
    rng = np.random.default_rng(42)
    n_intervals = 300
    bias = np.exp(rng.normal(0.0, 0.5, n_intervals))
    intervals = [("20", 1 + 1000 * i, 1000 * (i + 1)) for i in range(n_intervals)]
    factors = rng.normal(0.0, 0.4, (2, n_intervals))
    normals = np.stack([rng.poisson(400 * bias * np.exp(rng.normal(0, 0.7, 2) @ factors))
                        for _ in range(12)]).astype(float)
    cn = np.ones(n_intervals)
    cn[100:150] = 2.0
    case = rng.poisson(400 * bias * np.exp(np.array([0.8, -0.5]) @ factors) * cn).astype(float)
    return normals, intervals, case


def test_panel_of_normals_matches():
    normals, intervals, case = _pon_inputs()
    want = jax_somatic.build_panel_of_normals(normals, intervals, number_of_eigensamples=5)
    got = somatic.build_panel_of_normals(normals, intervals, number_of_eigensamples=5,
                                         device="cpu")
    np.testing.assert_array_equal(got.panel_interval_idx, want.panel_interval_idx)
    assert got.sample_names == want.sample_names
    np.testing.assert_array_equal(got.panel_fractional_medians, want.panel_fractional_medians)
    assert got.eigensample_vectors.dtype == want.eigensample_vectors.dtype == np.float32
    np.testing.assert_allclose(got.singular_values, want.singular_values, rtol=1e-5)
    u, w = (p.eigensample_vectors.astype(np.float64) for p in (got, want))
    np.testing.assert_allclose(u @ u.T, w @ w.T, atol=1e-5)  # sign-free
    for k in (None, 3):
        pairs = zip(somatic.denoise_sample(got, case, k), jax_somatic.denoise_sample(want, case, k))
        for a, b in pairs:
            np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)


def _het_segments(rng, fractions, n, depth=60):
    """test_somatic_cnv.py::test_mcmc_allele_fraction_posteriors's hets."""
    out = []
    for f in fractions:
        seg = []
        for _ in range(n):
            p = f if rng.random() < 0.5 else 1 - f
            a = rng.binomial(depth, p)
            seg.append((depth - a, a))
        out.append(seg)
    return out


def test_copy_ratio_posteriors_recover_means():
    """test_somatic_cnv.py::test_mcmc_copy_ratio_posteriors's assertions, on the port."""
    rng = np.random.default_rng(3)
    seg_means = [0.0, 1.5, -0.8]
    seg_values = [rng.normal(m, 0.15, 300) for m in seg_means]
    q = mcmc.sample_copy_ratio_posteriors(seg_values, seed=1, device="cpu")
    for i, m in enumerate(seg_means):
        q10, q50, q90 = q[i]
        assert abs(q50 - m) < 0.05, (i, q[i])
        assert q10 < q50 < q90
        assert (q90 - q10) < 0.1
    q2 = mcmc.sample_copy_ratio_posteriors([rng.normal(0, 0.1, 50), []], device="cpu")
    assert np.isnan(q2[1]).all() and not np.isnan(q2[0]).any()


def test_copy_ratio_outliers_are_absorbed():
    rng = np.random.default_rng(4)
    with_outliers = np.concatenate([rng.normal(0.5, 0.1, 200), np.full(8, 4.0)])
    q = mcmc.sample_copy_ratio_posteriors([with_outliers], seed=2, device="cpu")
    assert abs(q[0][1] - 0.5) < 0.1, q


def test_allele_fraction_posteriors_recover_fractions():
    rng = np.random.default_rng(5)
    q = mcmc.sample_allele_fraction_posteriors(_het_segments(rng, (0.5, 0.2), 150), seed=3,
                                               device="cpu")
    assert abs(q[0][1] - 0.5) < 0.03, q[0]
    assert abs(q[1][1] - 0.2) < 0.03, q[1]
    assert q[0][0] < q[0][1] <= q[0][2]


def test_deciles_agree_with_gatk_tpu():
    rng = np.random.default_rng(8)
    seg_values = [rng.normal(m, 0.2, n) for m, n in ((0.0, 400), (0.6, 120), (-1.0, 60))]
    got = mcmc.sample_copy_ratio_posteriors(seg_values, seed=4, device="cpu")
    want = jax_mcmc.sample_copy_ratio_posteriors(seg_values, seed=4)
    np.testing.assert_allclose(got, want, atol=0.03, rtol=0)
    hets = _het_segments(rng, (0.5, 1 / 3, 0.25), 120, depth=100)
    got = mcmc.sample_allele_fraction_posteriors(hets, seed=4, device="cpu")
    want = jax_mcmc.sample_allele_fraction_posteriors(hets, seed=4)
    np.testing.assert_allclose(got, want, atol=0.02, rtol=0)


def test_same_seed_same_chains():
    rng = np.random.default_rng(9)
    seg_values = [rng.normal(0.2, 0.1, 80), rng.normal(-0.3, 0.1, 40)]
    hets = _het_segments(rng, (0.4, 0.3), 40)
    for fn, data in ((mcmc.sample_copy_ratio_posteriors, seg_values),
                     (mcmc.sample_allele_fraction_posteriors, hets)):
        a, b = fn(data, seed=11, device="cpu"), fn(data, seed=11, device="cpu")
        np.testing.assert_array_equal(a, b)
        assert not np.array_equal(a, fn(data, seed=12, device="cpu"))


def _model_segments(pkg, d, extra):
    out = os.path.join(d, pkg)
    device = ["--device", "cpu"] if pkg == "port" else []
    assert _run(pkg, ["ModelSegments", *extra, "-O", out, "--output-prefix", "case", *device]) == 0
    return out


def test_model_segments_finds_gatk_tpus_segments(tmp_path):
    """test_somatic_cnv.py::test_model_segments_synthetic's input through both
    CLIs: the same segments and point counts, posterior medians within 0.02."""
    rng = np.random.default_rng(9)
    log2 = rng.normal(0, 0.08, 300)
    log2[120:180] += 1.0
    rows = [("20", 1 + 1000 * i, 1000 * (i + 1), somatic.format_double(v))
            for i, v in enumerate(log2)]
    cr = str(tmp_path / "denoised.tsv")
    somatic.write_sam_tsv(cr, "case", ["CONTIG", "START", "END", "LOG2_COPY_RATIO"], rows,
                          ["@HD\tVN:1.6", "@SQ\tSN:20\tLN:63025520"])
    segs = {}
    for pkg in ("jax", "port"):
        out = _model_segments(pkg, str(tmp_path), ["--denoised-copy-ratios", cr])
        segs[pkg] = somatic.read_sam_tsv(os.path.join(out, "case.cr.seg"))[3]
    assert len(segs["port"]) == 3
    assert [r[:4] for r in segs["port"]] == [r[:4] for r in segs["jax"]]
    np.testing.assert_allclose([float(r[4]) for r in segs["port"]],
                               [float(r[4]) for r in segs["jax"]], atol=0.02)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """A small somatic case: 8 normals and a case over 4 contigs of 500
    intervals, two of them with a planted altered segment, 400 het sites."""
    d = str(tmp_path_factory.mktemp("torch_somatic"))
    return synthetic.write_somatic_cnv_case(d, seed=2, n_normals=8, n_intervals=2000,
                                            n_contigs=4, n_event_contigs=2, n_hets=400)


def test_pon_and_denoising_through_both_clis(case, tmp_path):
    """CreateReadCountPanelOfNormals and DenoiseReadCounts through both CLIs:
    the same intervals and values within 1e-4 (float32 SVDs)."""
    inputs = sum((["-I", p] for p in case["normals"]), [])
    values = {}
    for pkg in ("jax", "port"):
        pon = str(tmp_path / f"{pkg}.pon.hdf5")
        device = ["--device", "cpu"] if pkg == "port" else []
        assert _run(pkg, ["CreateReadCountPanelOfNormals", *inputs, "-O", pon,
                          "--number-of-eigensamples", "5", *device]) == 0
        std, den = str(tmp_path / f"{pkg}.std.tsv"), str(tmp_path / f"{pkg}.den.tsv")
        assert _run(pkg, ["DenoiseReadCounts", "-I", case["case"], "--count-panel-of-normals", pon,
                          "--standardized-copy-ratios", std, "--denoised-copy-ratios", den]) == 0
        values[pkg] = [somatic.read_sam_tsv(p)[3] for p in (std, den)]
    for got, want in zip(values["port"], values["jax"]):
        assert [r[:3] for r in got] == [r[:3] for r in want]
        np.testing.assert_allclose([float(r[3]) for r in got], [float(r[3]) for r in want],
                                   atol=1e-4, rtol=0)


def test_model_segments_finds_the_planted_breakpoints(case, tmp_path):
    """The port's panel, denoising and ModelSegments on the small case: every
    planted breakpoint within 3 intervals, and the medians of segments with at
    least 10 points within 0.1 (log2 copy ratio) and 0.05 (minor-allele
    fraction) of the planted values, as chip_smoke.py's somatic phase checks."""
    pon = somatic.build_panel_of_normals(case["normal_counts"], case["intervals"], device="cpu")
    _, den = somatic.denoise_sample(pon, case["case_counts"])
    ivs = [case["intervals"][i] for i in pon.panel_interval_idx]
    cr = str(tmp_path / "den.tsv")
    somatic.write_sam_tsv(cr, "CASE", ["CONTIG", "START", "END", "LOG2_COPY_RATIO"],
                          [(c, s, e, somatic.format_double(v)) for (c, s, e), v in zip(ivs, den)],
                          ["@HD\tVN:1.6"] + [f"@SQ\tSN:{c}\tLN:{n}" for c, n in case["sq"]])
    out = _model_segments("port", str(tmp_path), ["--denoised-copy-ratios", cr,
                                                  "--allelic-counts", case["allelic_counts"]])
    rows = somatic.read_sam_tsv(os.path.join(out, "case.modelFinal.seg"))[3]
    report = synthetic.score_somatic_segments(case, rows)
    assert report["breakpoints_missed"] == [], report
    assert report["log2_cr_max_err"] < 0.1 and report["maf_max_err"] < 0.05, report


@pytest.mark.parametrize("tool", ["PreprocessIntervals", "AnnotateIntervals", "FilterIntervals",
                                  "CollectAllelicCounts", "CallCopyRatioSegments"])
def test_host_tools_are_identical(tool, tmp_path):
    """The copied host tools write gatk_tpu's bytes on synthetic inputs."""
    sample = synthetic.write_sample(str(tmp_path), seed=4, length=5000, n_reads=1500, n_snv=6,
                                    n_indel=2)
    bins = str(tmp_path / "bins.interval_list")
    assert _run("port", ["PreprocessIntervals", "-R", sample["fasta"], "-O", bins,
                         "--bin-length", "500", "--padding", "0"]) == 0
    sites = str(tmp_path / "sites.interval_list")
    with open(sites, "w") as fh:
        fh.write("@HD\tVN:1.6\n" + "".join(f"chrM\t{v.pos + 1}\t{v.pos + 1}\t+\t.\n"
                                            for v in sample["variants"] if v.is_snv))
    counts = str(tmp_path / "counts.tsv")
    assert _run("port", ["CollectReadCounts", "-I", sample["bam"], "-L", bins, "-O", counts]) == 0
    seg = str(tmp_path / "case.cr.seg")
    rng = np.random.default_rng(1)
    somatic.write_sam_tsv(seg, "case", ["CONTIG", "START", "END", "NUM_POINTS_COPY_RATIO",
                                        "MEAN_LOG2_COPY_RATIO"],
                          [("1", 1 + 1000 * k, 1000 * (k + 1), 50, somatic.format_double(v))
                           for k, v in enumerate(rng.normal(0, 0.3, 12))], ["@HD\tVN:1.6"])
    argv = {"PreprocessIntervals": ["-R", sample["fasta"], "--bin-length", "700"],
            "AnnotateIntervals": ["-R", sample["fasta"], "-L", bins],
            "FilterIntervals": ["-L", bins, "-I", counts, "--low-count-filter-count-threshold",
                                "60"],
            "CollectAllelicCounts": ["-I", sample["bam"], "-R", sample["fasta"], "-L", sites],
            "CallCopyRatioSegments": ["-I", seg]}[tool]
    out = {}
    for pkg in ("jax", "port"):
        out[pkg] = str(tmp_path / f"{pkg}.out.tsv")
        assert _run(pkg, [tool, *argv, "-O", out[pkg]]) == 0
    assert _read(out["port"]) == _read(out["jax"])
    assert len(_read(out["port"]).splitlines()) > 3
