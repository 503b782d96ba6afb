"""RampedHaplotypeCaller through the port (gatk_tpu_torch) against gatk_tpu, on the CPU.

A synthetic sample (utils/synthetic.write_sample: 3,000 bp, 800 reads of 151
bp, 3 het SNVs and 1 het indel) goes through the off-ramp after assembly
(POST_ASSEMBLER_OFF) and the on-ramp (POST_ASSEMBLER_ON) in both packages,
the port given --device cpu (the plain PairHMM through PoolBatcher).
Tolerance: none; the state files hold the same regions, reads and
haplotypes, and the VCFs are byte-identical. The depth is 800 reads, not
2,000: at 2,000 the off-ramp saves 48-144 haplotypes a region, and gatk_tpu's
on-ramp on the CPU (a compiled scan a region) ran for over 15 minutes.

The round trip does not give a straight HaplotypeCaller run's VCF: the
on-ramp genotypes the assembler's haplotypes over the padded region as saved,
so the same sites and genotypes carry other annotations (QUAL, AD, DP, FS).
"""
import contextlib
import io
import json
import os
import zipfile

import numpy as np
import pytest
import torch

from gatk_tpu.cli import TOOL_REGISTRY as JAX_TOOLS
from gatk_tpu_torch import cli as port_cli
from gatk_tpu_torch import devices
from gatk_tpu_torch.utils import synthetic
from tests.test_torch_pairhmm import one_torch_thread  # noqa: F401


def _run(pkg, argv):
    with contextlib.redirect_stdout(io.StringIO()):
        if pkg == "jax":
            return JAX_TOOLS[argv[0]](argv[1:])
        return port_cli.main(argv + ["--device", "cpu"])


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


@pytest.fixture(scope="module")
def sample(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_ramped"))
    return synthetic.write_sample(d, seed=2, length=3000, n_reads=800, n_snv=3, n_indel=1)


@pytest.fixture(scope="module")
def runs(sample, tmp_path_factory):
    """Each package's off-ramp state, on-ramp VCF and straight HaplotypeCaller
    VCF, and the port's on-ramp of gatk_tpu's state: {name: path}."""
    d = str(tmp_path_factory.mktemp("torch_ramped_runs"))
    out = {}
    for pkg in ("jax", "port"):
        state, on, hc = (os.path.join(d, f"{pkg}.{n}") for n in ("state.zip", "on.vcf", "hc.vcf"))
        assert _run(pkg, ["RampedHaplotypeCaller", "-I", sample["bam"], "-R", sample["fasta"],
                          "-O", state, "--off-ramp-type", "POST_ASSEMBLER_OFF",
                          "--off-ramp-file", state]) == 0
        assert _run(pkg, ["RampedHaplotypeCaller", "-R", sample["fasta"], "-O", on,
                          "--on-ramp-type", "POST_ASSEMBLER_ON", "--on-ramp-file", state]) == 0
        assert _run(pkg, ["HaplotypeCaller", "-I", sample["bam"], "-R", sample["fasta"],
                          "-O", hc]) == 0
        out.update({f"{pkg}.state": state, f"{pkg}.on": on, f"{pkg}.hc": hc})
    out["port.on_jax_state"] = os.path.join(d, "port.on_jax_state.vcf")
    assert _run("port", ["RampedHaplotypeCaller", "-R", sample["fasta"],
                         "-O", out["port.on_jax_state"], "--on-ramp-type", "POST_ASSEMBLER_ON",
                         "--on-ramp-file", out["jax.state"]]) == 0
    return out


def _state(path):
    with zipfile.ZipFile(path) as zf:
        manifest = json.loads(zf.read("manifest.json"))
        arrays = [dict(np.load(io.BytesIO(zf.read(e["npz"])), allow_pickle=False))
                  for e in manifest["regions"]]
    return manifest, arrays


def test_off_ramp_states_hold_the_same_regions(runs):
    want_manifest, want = _state(runs["jax.state"])
    got_manifest, got = _state(runs["port.state"])
    assert got_manifest == want_manifest and len(got) > 0
    for a, b in zip(got, want):
        assert a.keys() == b.keys() and "hap_bases" in a
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_on_ramp_vcf_identical_to_jax(sample, runs):
    got = _read(runs["port.on"])
    assert got == _read(runs["jax.on"])
    called = {(int(f[1]) - 1, f[3], f[4]) for f in
              (ln.split("\t") for ln in got.decode().splitlines() if not ln.startswith("#"))}
    for v in sample["variants"]:
        if v.is_snv:
            assert (v.pos, v.ref, v.alt) in called, v


def test_port_on_ramp_of_gatk_tpu_state(runs):
    """One state format: the port's on-ramp reads gatk_tpu's off-ramp zip."""
    assert _read(runs["port.on_jax_state"]) == _read(runs["jax.on"])


def _sites(path):
    return [(f[0], f[1], f[3], f[4], f[9].split(":")[0]) for f in
            (ln.split("\t") for ln in _read(path).decode().splitlines()
             if not ln.startswith("#"))]


def test_round_trip_gives_a_straight_runs_sites_not_its_vcf(runs):
    assert _read(runs["port.hc"]) == _read(runs["jax.hc"])
    assert _sites(runs["port.on"]) == _sites(runs["port.hc"])
    assert _read(runs["port.on"]) != _read(runs["port.hc"])


def test_no_ramp_runs_as_haplotype_caller(sample, tmp_path):
    out = {pkg: str(tmp_path / f"{pkg}.vcf") for pkg in ("jax", "port")}
    for pkg in out:
        assert _run(pkg, ["RampedHaplotypeCaller", "-I", sample["bam"], "-R", sample["fasta"],
                          "-O", out[pkg]]) == 0
    assert _read(out["port"]) == _read(out["jax"])


def test_on_cuda_raises_without_a_card(monkeypatch, sample, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(devices, "_DEFAULT_DEVICE", torch.device("cuda"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cli.main(["RampedHaplotypeCaller", "-R", sample["fasta"],
                       "-O", str(tmp_path / "x.vcf"), "--on-ramp-type", "POST_ASSEMBLER_ON",
                       "--on-ramp-file", str(tmp_path / "missing.zip")])
