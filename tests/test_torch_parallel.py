"""The port's data parallelism (gatk_tpu_torch.parallel.mesh and .multihost,
gatk_tpu_torch.graft_entry, HaplotypeCaller's --distributed-* flags) against
gatk_tpu's, on the CPU.

Single-process pieces run on lists of CPU devices beside gatk_tpu's functions
on its forced 8-device CPU mesh (tests/conftest.py), the Pallas kernel in
interpret mode. Multi-process pieces run as subprocesses in a gloo group over
tcp://127.0.0.1, each under its own timeout and killed when it runs out: the
collective gather and the cross-process histogram in a small worker, and
HaplotypeCaller --device cpu in 2 processes, whose gathered VCF must be a
1-process run's, which must be gatk_tpu's byte for byte (the pattern of
tests/test_multihost.py, on a synthetic sample).
"""
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import __graft_entry__
from gatk_tpu.cli import TOOL_REGISTRY as JAX_TOOLS
from gatk_tpu.engine.intervals import Interval as JaxInterval
from gatk_tpu.ops import pairhmm_tpu
from gatk_tpu.parallel import mesh as jax_mesh
from gatk_tpu.parallel import multihost as jax_multihost
from gatk_tpu_torch import cli as port_cli
from gatk_tpu_torch import graft_entry
from gatk_tpu_torch.engine.intervals import Interval
from gatk_tpu_torch.ops import pairhmm
from gatk_tpu_torch.parallel import mesh, multihost
from gatk_tpu_torch.utils import synthetic
from tests.test_torch_pairhmm import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
PROC_TIMEOUT = 300  # seconds a subprocess may take before it is killed
PAIR_TOL = 1e-4  # the kernel contract's, as tests/test_torch_pairhmm.py (v6 interpret)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = ROOT
    env["OMP_NUM_THREADS"] = "1"  # the suite runs files in parallel workers
    return env


def _run_all(cmds):
    """Run the commands at once; each must exit 0 within PROC_TIMEOUT, and all
    are killed when one does not. Returns their outputs."""
    procs = [subprocess.Popen(c, cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for c in cmds]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=PROC_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    return outs


# --------------------------------------------------------------------------- shard_targets


def _targets(rng, n):
    """n targets over two contigs, of 1..999 bp."""
    out, pos = [], {"c1": 0, "c2": 0}
    for k in range(n):
        contig = "c1" if k < (n + 1) // 2 else "c2"
        start = pos[contig] + int(rng.integers(0, 50))
        end = start + int(rng.integers(1, 1000))
        pos[contig] = end
        out.append((contig, start, end))
    return out


@pytest.mark.parametrize("mode", ["contiguous", "round-robin"])
@pytest.mark.parametrize("n_procs", [1, 2, 3, 4, 5])
def test_shard_targets_matches_jax(n_procs, mode):
    """Every process's shard, for target lists with fewer, as many and more
    targets than processes; num_processes and process_id given explicitly."""
    rng = np.random.default_rng(n_procs)
    for n_targets in sorted({1, max(1, n_procs - 1), n_procs, n_procs + 1, 3 * n_procs + 2}):
        t = _targets(rng, n_targets)
        for pid in range(n_procs):
            want = jax_multihost.shard_targets([JaxInterval(*x) for x in t], n_procs, pid,
                                               mode=mode)
            got = multihost.shard_targets([Interval(*x) for x in t], n_procs, pid, mode=mode)
            assert [(i.contig, i.start, i.end) for i in got] == \
                [(i.contig, i.start, i.end) for i in want], (n_targets, pid)
    # without a process group, the defaults are one process
    t = [Interval(*x) for x in _targets(rng, 4)]
    assert multihost.shard_targets(t, mode=mode) == t


# --------------------------------------------------------------------------- VCF gathers


HEADER = ("##fileformat=VCFv4.2\n##contig=<ID=c1,length=5000>\n##contig=<ID=c2,length=5000>\n"
          "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS\n")


def _shard_texts(sort):
    """Three shards: contiguous runs, or (sort=True) records dealt round-robin."""
    recs = [f"{c}\t{p}\t.\tA\tC\t50\tPASS\t.\tGT\t0/1\n"
            for c in ("c1", "c2") for p in (5, 40, 300, 2000, 4100)]
    parts = [recs[i::3] for i in range(3)] if sort else [recs[:4], recs[4:7], recs[7:]]
    return [HEADER + "".join(p) for p in parts]


def _write_shards(shard_path, texts):
    for pid, text in enumerate(texts):
        with open(shard_path(pid), "w") as fh:
            fh.write(text)


@pytest.mark.parametrize("sort", [False, True])
def test_gather_vcf_shards_matches_jax(tmp_path, sort):
    texts = _shard_texts(sort)
    outs = {}
    for name, mod in (("jax", jax_multihost), ("port", multihost)):
        out = str(tmp_path / f"{name}.vcf")
        _write_shards(lambda pid: mod.shard_vcf_path(out, pid), texts)
        mod.gather_vcf_shards(out, len(texts), sort=sort)
        assert not any(os.path.exists(mod.shard_vcf_path(out, p)) for p in range(len(texts)))
        outs[name] = open(out, "rb").read()
    assert outs["port"] == outs["jax"]
    body = [ln for ln in outs["port"].decode().splitlines() if not ln.startswith("#")]
    assert len(body) == 10 and body[0].startswith("c1\t5\t") and body[-1].startswith("c2\t4100\t")


WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    from gatk_tpu_torch.parallel import mesh, multihost
    port, pid, n, out, sort = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5] == "1"
    multihost.initialize(f"127.0.0.1:{port}", n, pid)
    rng = np.random.default_rng(1)
    keys = rng.integers(0, 64, 4096).astype(np.int32)
    errors = rng.random(4096).astype(np.float32)
    half = slice(pid * 2048, (pid + 1) * 2048)
    obs, errs = mesh.bqsr_histogram_step(["cpu"], keys[half], errors[half], 64)
    np.save(out + ".hist.npy", np.stack([obs.numpy(), errs.numpy()]))
    multihost.gather_vcf_shards_collective(out, multihost.shard_vcf_path(out, pid), sort=sort)
    multihost.shutdown()
""")


@pytest.mark.parametrize("sort", [False, True])
def test_collective_gather_and_histogram_in_two_processes(tmp_path, sort):
    """Two gloo processes with private directories: process 0 writes what
    gatk_tpu's file gather writes, both shards are removed, process 1 writes no
    output; the histogram reduced across the processes is the whole key list's."""
    texts = _shard_texts(sort)[:2]
    outs = [str(tmp_path / f"proc{pid}" / "out.vcf") for pid in range(2)]
    for pid, out in enumerate(outs):
        os.makedirs(os.path.dirname(out))
        with open(multihost.shard_vcf_path(out, pid), "w") as fh:
            fh.write(texts[pid])
    port = _free_port()
    _run_all([[sys.executable, "-c", WORKER, str(port), str(pid), "2", outs[pid],
               str(int(sort))] for pid in range(2)])
    want = str(tmp_path / "jax.vcf")
    _write_shards(lambda pid: jax_multihost.shard_vcf_path(want, pid), texts)
    jax_multihost.gather_vcf_shards(want, 2, sort=sort)
    assert open(outs[0], "rb").read() == open(want, "rb").read()
    assert not os.path.exists(outs[1])
    assert not any(os.path.exists(multihost.shard_vcf_path(o, p)) for p, o in enumerate(outs))

    rng = np.random.default_rng(1)
    keys = rng.integers(0, 64, 4096).astype(np.int32)
    errors = rng.random(4096).astype(np.float32)
    obs, errs = jax_mesh.bqsr_histogram_step(jax_mesh.make_mesh(2), keys, errors, 64)
    for out in outs:
        got = np.load(out + ".hist.npy")
        np.testing.assert_array_equal(got[0], np.asarray(obs))
        np.testing.assert_allclose(got[1], np.asarray(errs), rtol=1e-5, atol=0)


# --------------------------------------------------------------------------- mesh


@pytest.fixture(scope="module")
def jax_sharded():
    """gatk_tpu's pairhmm_sharded on a 2-device mesh, kernel v6 interpreted,
    over __graft_entry__'s 128 example pairs."""
    packed, rp, hmax = __graft_entry__._example_batch(n_pairs=128)
    packed = jax_mesh.pad_pairs_to_devices(packed, 128, 2)
    out = jax_mesh.pairhmm_sharded(jax_mesh.make_mesh(2), packed, rp, hmax, interpret=True)
    return np.asarray(out)[0, :128]


@pytest.mark.parametrize("n_devices", [1, 2, 3])
def test_pairhmm_sharded_matches_jax(jax_sharded, n_devices):
    packed, rp, hmax = graft_entry._example_batch(n_pairs=128)
    packed = mesh.pad_pairs_to_devices(packed, 128, n_devices)
    assert packed["rbase"].shape[1] == 128 * n_devices
    out = mesh.pairhmm_sharded([CPU] * n_devices, packed, rp, hmax)
    assert out.shape == (1, 128 * n_devices) and out.dtype == torch.float32
    assert (jax_sharded > pairhmm.MIN_ACCEPTED_LOG10).all()
    np.testing.assert_allclose(out[0, :128].numpy(), jax_sharded, atol=PAIR_TOL, rtol=0)


def test_pairhmm_sharded_scores_a_haplotype_n_as_v6_does():
    """gatk_tpu's mesh runs kernel v6, which scores an N in the haplotype as a
    mismatch; so does the port's sharded step, and the host rule would not."""
    rng = np.random.default_rng(4)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    haps = []
    for _ in range(4):
        h = bases[rng.integers(0, 4, 180)].copy()
        h[rng.integers(0, 180, 6)] = ord("N")
        haps.append(h.tobytes())
    reads = []
    for k in range(8):
        s = int(rng.integers(0, 60))
        rb = np.frombuffer(haps[k % 4], np.uint8)[s:s + 100].copy()
        rb[rb == ord("N")] = ord("A")
        reads.append(dict(bases=rb.tobytes(), rq=rng.integers(20, 40, 100).astype(np.uint8),
                          iq=np.full(100, 45, np.uint8), dq=np.full(100, 45, np.uint8),
                          gcp=np.full(100, 10, np.uint8)))
    ri, hi = np.tile(np.arange(8), 16), np.repeat(np.arange(4), 32)
    jpacked, rp, hmax, _ = pairhmm_tpu.pack_batch(reads, haps, ri, hi)
    want = np.asarray(jax_mesh.pairhmm_sharded(jax_mesh.make_mesh(2), jpacked, rp, hmax,
                                               interpret=True))[0]
    packed, rp2, hmax2, _ = pairhmm.pack_batch(reads, haps, ri, hi)
    assert (rp2, hmax2) == (rp, hmax)
    got = mesh.pairhmm_sharded([CPU, CPU], packed, rp, hmax)[0].numpy()
    np.testing.assert_allclose(got, want, atol=PAIR_TOL, rtol=0)
    host_rule = pairhmm.pairhmm_pairs(*pairhmm.from_jax_packed(packed)).numpy()
    assert np.abs(host_rule - want).max() > 0.1


def test_pairhmm_sharded_refuses_an_uneven_split():
    packed, rp, hmax = graft_entry._example_batch(n_pairs=128)
    with pytest.raises(ValueError, match="split evenly"):
        mesh.pairhmm_sharded([CPU] * 3, packed, rp, hmax)


@pytest.mark.parametrize("n_devices", [2, 4])
def test_bqsr_histogram_step_matches_jax(n_devices):
    rng = np.random.default_rng(1)
    n = 1024 * n_devices
    keys = rng.integers(0, 64, n).astype(np.int32)
    errors = rng.random(n).astype(np.float32)
    want_obs, want_errs = jax_mesh.bqsr_histogram_step(jax_mesh.make_mesh(n_devices), keys,
                                                       errors, 64)
    obs, errs = mesh.bqsr_histogram_step([CPU] * n_devices, keys, errors, 64)
    assert obs.dtype == errs.dtype == torch.float32 and obs.shape == (64,)
    np.testing.assert_array_equal(obs.numpy(), np.asarray(want_obs))
    np.testing.assert_allclose(errs.numpy(), np.asarray(want_errs), rtol=1e-5, atol=0)


def test_make_mesh_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.make_mesh(1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.entry()


# --------------------------------------------------------------------------- graft entry


def test_graft_entry_matches_jax_entry():
    fn, args = __graft_entry__.entry()
    want = np.asarray(fn(*args))[0]
    fn, args = graft_entry.entry(device="cpu")
    got = fn(*args)
    assert got.shape == want.shape == (256,) and got.device == CPU
    np.testing.assert_allclose(got.numpy(), want, atol=PAIR_TOL, rtol=0)


def test_dryrun_multichip_on_two_cpu_devices():
    graft_entry.dryrun_multichip(2, [CPU, CPU])


# --------------------------------------------------------------------------- HaplotypeCaller


@pytest.fixture(scope="module")
def hc_runs(tmp_path_factory):
    """A 3 kb sample, gatk_tpu's 1-process VCF and the port's (--device cpu),
    both with --shard-size 500."""
    d = tmp_path_factory.mktemp("torch_parallel")
    sample = synthetic.write_sample(str(d), seed=0, length=3000, n_reads=2000, n_snv=3,
                                    n_indel=2)
    common = ["-I", sample["bam"], "-R", sample["fasta"], "--shard-size", "500"]
    jax_out, port_out = str(d / "jax.vcf"), str(d / "port.vcf")
    assert JAX_TOOLS["HaplotypeCaller"](common + ["-O", jax_out]) == 0
    assert port_cli.main(["HaplotypeCaller", *common, "-O", port_out, "--device", "cpu"]) == 0
    return sample, common, open(jax_out, "rb").read(), open(port_out, "rb").read()


def _body(text):
    return [ln for ln in text.decode().splitlines(keepends=True) if not ln.startswith("#")]


def test_one_process_hc_identical_to_jax(hc_runs):
    sample, _, want, got = hc_runs
    assert got == want
    called = {(int(f.split("\t")[1]) - 1, f.split("\t")[3]) for f in _body(got)}
    assert {(v.pos, v.ref) for v in sample["variants"] if v.is_snv} <= called


@pytest.mark.parametrize("shard_mode,gather,private", [
    ("contiguous", "collective", False),
    ("round-robin", "files", False),
    ("round-robin", "collective", True),
])
def test_two_process_hc_matches_one_process(hc_runs, tmp_path, shard_mode, gather, private):
    """python -m gatk_tpu_torch HaplotypeCaller --device cpu in 2 gloo
    processes: the gathered VCF is the 1-process run's; with private
    directories process 1 writes nothing and the shards are gone."""
    _, common, _, single = hc_runs
    dirs = [tmp_path / f"proc{pid}" if private else tmp_path for pid in range(2)]
    for d in dirs:
        d.mkdir(exist_ok=True)
    outs = [str(d / "dist.vcf") for d in dirs]
    port = _free_port()
    _run_all([[sys.executable, "-m", "gatk_tpu_torch", "HaplotypeCaller", *common,
               "-O", outs[pid], "--device", "cpu",
               "--distributed-coordinator", f"127.0.0.1:{port}",
               "--distributed-num-processes", "2", "--distributed-process-id", str(pid),
               "--distributed-gather", gather, "--distributed-shard-mode", shard_mode]
              for pid in range(2)])
    got = open(outs[0], "rb").read()
    assert _body(got) == _body(single) and len(_body(single)) >= 3
    assert got == single
    if private:
        assert not os.path.exists(outs[1])
    assert not any(os.path.exists(multihost.shard_vcf_path(o, p)) for p, o in enumerate(outs))


def test_failed_rendezvous_raises_before_calling(hc_runs, tmp_path):
    """A process group that cannot be joined fails the run once the
    initialisation thread is joined, before any shard is called or written."""
    _, common, _, _ = hc_runs
    out = tmp_path / "x.vcf"
    argv = [*common, "-O", str(out), "--device", "cpu",
            "--distributed-coordinator", "127.0.0.1:not-a-port",
            "--distributed-num-processes", "2", "--distributed-process-id", "0"]
    with pytest.raises(RuntimeError, match="joining the process group"):
        port_cli.TOOL_REGISTRY["HaplotypeCaller"](argv)
    assert not out.exists() and not os.path.exists(multihost.shard_vcf_path(str(out), 0))
    assert not torch.distributed.is_initialized()
