#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gatk_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:
  device   the card, its power limit, the kernel build, the native host libraries
  kernel   the PairHMM kernel on bench.py's workload (64 reads x 151 bp, 16
           haplotypes x 400 bp, 32,768 pairs) and on ragged batches with N
           bases (rp 160 and 320), against its plain PyTorch version and the
           host f64 reference; timed with CUDA events beside its bound and the
           scalar C++ baseline
  sample   the synthetic 16,569 bp sample (~20,000 reads of 151 bp, 24 het SNVs
           and 6 het indels), written as a BAM and an indexed FASTA
  hc       HaplotypeCaller end to end (BAM -> VCF) through the port's CLI; the
           planted variants must be called, and the kernel must have scored
           exactly the genotyped regions' read x haplotype pairs
  gvcf     the same sample with -ERC GVCF on a 2 kb interval (the cartesian route)
  main_launch  the largest kernel launch of the hc run, held against the plain
           version and timed at that shape
Then the card's name and power limit as nvidia-smi prints them, one JSON line
listing every kernel of the port, and the result line.
Needs a CUDA device and the repository's sources; imports neither jax nor gatk_tpu.
"""
import contextlib
import ctypes
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

KERNEL_TOL = 1e-4  # max |log10 kernel - log10 plain| and vs host f64, above the floor
FP32_PEAK = 67e12  # H100 SXM, FP32 outside the tensor cores (FLOP/s)
HBM_RATE = 3.35e12  # H100 SXM device memory (bytes/s)
# FP32 operations per DP cell, counted from the plain version
# (ops/pairhmm.py:pairhmm_pairs_reference): M = prior*(tmm*m + tim*(x + y)) is 5,
# X = tmi*m + tii*x is 3, Y = tmd*m + tdd*y is 3
FLOPS_PER_CELL = 11
ROOT = os.path.dirname(os.path.abspath(__file__))


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def median_ms(fn, reps, warmup=2):
    """Median of `reps` CUDA-event timings of fn(), after `warmup` calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return float(np.median(times))


def nvidia_smi_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------- device


def phase_device():
    from gatk_tpu_torch.assembly import rtgraph
    from gatk_tpu_torch.calling import read_prep
    from gatk_tpu_torch.engine import pileup
    from gatk_tpu_torch.io import bam, bgzf
    from gatk_tpu_torch.ops import _kernels, pdhmm, smith_waterman

    t0 = time.perf_counter()
    _kernels.library("pairhmm_fwd")
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in _kernels.BUILD_INFO["log"]["pairhmm_fwd"].splitlines()
             if "registers" in ln or "spill" in ln]
    native = {m.__name__.split(".", 1)[1]: m._load_native() is not None
              for m in (bgzf, bam, read_prep, rtgraph, pileup, pdhmm, smith_waterman)}
    emit(dict(phase="device", name=torch.cuda.get_device_name(0),
              nvidia_smi=nvidia_smi_line(), torch=torch.__version__, cuda=torch.version.cuda,
              kernel_build_s=round(build_s, 3), compiled_now=_kernels.BUILD_INFO["built"],
              ptxas=ptxas, native_loaded=native))


# --------------------------------------------------------------------------- kernel


def _bench_workload():
    """bench.py:55-82: the same seed, draws and shapes."""
    rng = np.random.default_rng(0)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    R, H, NP = 151, 400, 32768
    n_reads, n_haps = 64, 16
    hap_master = bases[rng.integers(0, 4, H)]
    haps = []
    for _ in range(n_haps):
        h = hap_master.copy()
        idx = rng.integers(0, H, 3)
        h[idx] = bases[rng.integers(0, 4, 3)]
        haps.append(h.tobytes())
    reads = []
    for k in range(n_reads):
        h = np.frombuffer(haps[k % n_haps], np.uint8)
        start = int(rng.integers(0, H - R))
        rb = h[start : start + R].copy()
        rb[rng.integers(0, R, 2)] = bases[rng.integers(0, 4, 2)]
        reads.append(dict(bases=rb.tobytes(), rq=rng.integers(20, 40, R).astype(np.uint8),
                          iq=np.full(R, 45, np.uint8), dq=np.full(R, 45, np.uint8),
                          gcp=np.full(R, 10, np.uint8)))
    ri = np.tile(np.arange(n_reads), NP // n_reads)[:NP].astype(np.int32)
    hi = np.repeat(np.arange(n_haps), NP // n_haps)[:NP].astype(np.int32)
    return reads, haps, ri, hi


def _ragged_workload(read_lens, hap_lens, seed):
    """Reads and haplotypes of the given lengths, cut from one sequence with ~2%
    N (reads also get a few errors of their own)."""
    rng = np.random.default_rng(seed)
    acgtn = np.frombuffer(b"ACGTN", dtype=np.uint8)
    span = max(hap_lens)
    master = acgtn[np.where(rng.random(span) < 0.02, 4, rng.integers(0, 4, span))]
    reads = []
    for L in read_lens:
        s = int(rng.integers(0, span - L + 1))
        rb = master[s : s + L].copy()
        rb[rng.integers(0, L, max(1, L // 50))] = acgtn[rng.integers(0, 5, max(1, L // 50))]
        reads.append(dict(bases=rb.tobytes(), rq=rng.integers(10, 41, L).astype(np.uint8),
                          iq=rng.integers(30, 50, L).astype(np.uint8),
                          dq=rng.integers(30, 50, L).astype(np.uint8),
                          gcp=np.full(L, 10, np.uint8)))
    haps = []
    for L in hap_lens:
        s = int(rng.integers(0, span - L + 1))
        haps.append(master[s : s + L].tobytes())
    return reads, haps


# (read lengths, haplotype lengths, rp, hmax): every length of the pool's
# buckets, then long reads over two 160-row stripes with haplotypes up to the
# largest bucket, as oversize regions reach the cartesian route
RAGGED = (
    (range(1, 159), (1, 2, 3, 31, 32, 33, 100, 158, 255, 256, 400, 511, 512), 160, 512),
    ((150, 159, 160, 161, 200, 255, 317, 318), (1, 160, 400, 1000, 1500, 2047, 2048), 320, 2048),
)


def _device_pools(reads, haps, ri, hi, dev, rp=None, hmax=None):
    from gatk_tpu_torch.ops import pairhmm

    packed, rp = pairhmm.pack_reads(reads, rp=rp, nr=len(reads))
    e, hlen, _ = pairhmm.pack_haps(haps, rp, hmax=hmax, nh=len(haps))
    pools = pairhmm.make_pools(packed, packed["rlen"], e, hlen, dev)
    return pools, torch.from_numpy(ri).to(dev), torch.from_numpy(hi).to(dev)


def _compare(pools, ri, hi, what):
    """Kernel against the plain version on the same inputs: (kernel output,
    max |kernel - plain| above the floor, pairs above it); the below-floor sets
    must be identical. Launches here are not counted as the main path's."""
    from gatk_tpu_torch.ops import _kernels, pairhmm

    got = _kernels.pairhmm_fwd(pools, ri, hi)
    want = pairhmm.pairhmm_pairs_reference(pools, ri, hi)
    torch.cuda.synchronize()
    check(got.shape == want.shape and not got.isnan().any(),
          f"{what}: kernel output has NaN or a wrong shape")
    ok = want > pairhmm.MIN_ACCEPTED_LOG10
    check(torch.equal(ok, got > pairhmm.MIN_ACCEPTED_LOG10),
          f"{what}: kernel and plain version disagree on which pairs are below the floor")
    err = (got[ok] - want[ok]).abs().max().item() if ok.any() else 0.0
    check(err <= KERNEL_TOL, f"{what}: max |kernel - plain| = {err} > {KERNEL_TOL}")
    return got, err, int(ok.sum())


def _timed(pools, ri, hi, plain_reps=3):
    """CUDA-event medians of the kernel (30 launches) and the plain version on
    the same inputs, and the bound: the larger of the FP32 time of the cells
    these pairs need (rlen x hlen each) and the time to read the pools and the
    pair lists once and write the output once."""
    from gatk_tpu_torch.ops import _kernels, pairhmm

    kernel_ms = median_ms(lambda: _kernels.pairhmm_fwd(pools, ri, hi), reps=30, warmup=3)
    plain_ms = median_ms(lambda: pairhmm.pairhmm_pairs_reference(pools, ri, hi),
                         reps=plain_reps, warmup=1)
    n = ri.numel()
    cells = int((pools.rlen[ri.long()].long() * pools.hlen[hi.long()].long()).sum().item())
    ops_ms = cells * FLOPS_PER_CELL / FP32_PEAK * 1e3
    in_bytes = sum(t.numel() * t.element_size() for t in pools) + 8 * n
    bytes_ms = (in_bytes + 4 * n) / HBM_RATE * 1e3
    return dict(pairs=n, kernel_ms=kernel_ms, plain_ms=plain_ms, useful_cells=cells,
                useful_gcups=cells / kernel_ms / 1e6, bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                ops_bound_ms=ops_ms, bytes_bound_ms=bytes_ms)


def _baseline_gcups(reads, haps, ri, hi, n_base=256):
    """Scalar C++ LoglessPairHMM (native/pairhmm/libpairhmm_baseline.so), single
    thread, on the first n_base pairs, as bench.py:120-150 runs it."""
    lib = ctypes.CDLL(os.path.join(ROOT, "native", "pairhmm", "libpairhmm_baseline.so"))
    lib.pairhmm_scalar_batch.argtypes = [ctypes.c_char_p] * 5 + [
        np.ctypeslib.ndpointer(np.int64), np.ctypeslib.ndpointer(np.int32),
        ctypes.c_char_p, np.ctypeslib.ndpointer(np.int64),
        np.ctypeslib.ndpointer(np.int32), np.ctypeslib.ndpointer(np.int32),
        np.ctypeslib.ndpointer(np.int32), ctypes.c_int32,
        np.ctypeslib.ndpointer(np.float64)]
    R, H = len(reads[0]["bases"]), len(haps[0])
    cat = {k: np.concatenate([r[k] for r in reads]).astype(np.uint8).tobytes()
           for k in ("rq", "iq", "dq", "gcp")}
    out = np.zeros(n_base)
    t0 = time.perf_counter()
    lib.pairhmm_scalar_batch(
        b"".join(r["bases"] for r in reads), cat["rq"], cat["iq"], cat["dq"], cat["gcp"],
        (np.arange(len(reads)) * R).astype(np.int64), np.full(len(reads), R, np.int32),
        b"".join(haps), (np.arange(len(haps)) * H).astype(np.int64),
        np.full(len(haps), H, np.int32), ri[:n_base].copy(), hi[:n_base].copy(), n_base, out)
    return n_base * R * H / (time.perf_counter() - t0) / 1e9, out


def phase_kernel(dev):
    from gatk_tpu_torch.ops import pairhmm, pairhmm_host

    reads, haps, ri, hi = _bench_workload()
    pools, rit, hit = _device_pools(reads, haps, ri, hi, dev, rp=160, hmax=512)
    got, err_bench, n_ok = _compare(pools, rit, hit, "bench workload")

    # 256 pairs against the host f64 reference and the scalar C++ baseline
    got_np = got[:256].cpu().numpy().astype(np.float64)
    host = np.array([pairhmm_host.compute_log10_likelihood(
        haps[hi[k]], reads[ri[k]]["bases"], reads[ri[k]]["rq"], reads[ri[k]]["iq"],
        reads[ri[k]]["dq"], reads[ri[k]]["gcp"]) for k in range(256)])
    ok = host > pairhmm.MIN_ACCEPTED_LOG10
    err_host = float(np.abs(got_np[ok] - host[ok]).max())
    check(err_host <= KERNEL_TOL, f"kernel vs host f64: {err_host} > {KERNEL_TOL}")
    base_gcups, base_out = _baseline_gcups(reads, haps, ri, hi)
    ok = base_out > pairhmm.MIN_ACCEPTED_LOG10
    err_base = float(np.abs(got_np[ok] - base_out[ok]).max())
    check(err_base <= KERNEL_TOL, f"kernel vs scalar C++ baseline: {err_base} > {KERNEL_TOL}")

    # ragged lengths and N bases, every read with every haplotype, in each
    # (rp, hmax) that the pool and the cartesian route use
    ragged = []
    for seed, (read_lens, hap_lens, rp, hmax) in enumerate(RAGGED, start=1):
        rr, hh = _ragged_workload(read_lens, hap_lens, seed)
        a, b = pairhmm.cartesian_pairs(len(rr), len(hh))
        _, err, n_ok_r = _compare(*_device_pools(rr, hh, a, b, dev, rp=rp, hmax=hmax),
                                  f"ragged/N rp={rp} hmax={hmax}")
        ragged.append(dict(rp=rp, hmax=hmax, pairs=len(a), above_floor=n_ok_r, max_abs_err=err))

    timed = _timed(pools, rit, hit)
    res = dict(phase="kernel", above_floor=n_ok, max_abs_err_bench=err_bench,
               max_abs_err_host_f64=err_host, max_abs_err_cpp_baseline=err_base,
               ragged=ragged, max_abs_err_ragged=max(r["max_abs_err"] for r in ragged),
               **timed, cpp_baseline_gcups=base_gcups,
               speedup_vs_cpp=timed["useful_gcups"] / base_gcups)
    emit(res)
    return res


@contextlib.contextmanager
def keeping_largest_launch():
    """Keeps the inputs of the largest kernel launch made inside the block, so
    that the kernel can be held against its plain version, and timed, at a shape
    the main path gave it."""
    from gatk_tpu_torch.ops import _kernels

    launch = _kernels.pairhmm_fwd
    kept = {"n": 0}

    def keep(pools, ri, hi):
        if ri.numel() > kept["n"]:
            kept.update(n=ri.numel(), args=(pools, ri, hi))
        return launch(pools, ri, hi)

    _kernels.pairhmm_fwd = keep
    try:
        yield kept
    finally:
        _kernels.pairhmm_fwd = launch


def phase_main_launch(kept):
    """The largest launch of the HaplotypeCaller run: kernel against plain, timed."""
    check(kept["n"] > 0, "the HaplotypeCaller run made no kernel launch")
    pools, ri, hi = kept["args"]
    _, err, n_ok = _compare(pools, ri, hi, "HaplotypeCaller's largest launch")
    res = dict(phase="main_launch", rp=pools.rp, hmax=pools.hmax, reads=pools.rbase.shape[1],
               haps=pools.e.shape[1], above_floor=n_ok, max_abs_err=err, **_timed(pools, ri, hi))
    emit(res)
    return res


# --------------------------------------------------------------------------- hc / gvcf


@contextlib.contextmanager
def counting_genotyped_pairs(hc_engine):
    """Counts reads x haplotypes of every region whose likelihoods were computed:
    regions genotyped by HaplotypeCallerEngine.finish_region (the pooled route)
    and by compute_pairhmm_likelihoods (the -ERC GVCF route). Restores both."""
    total = [0]
    finish = hc_engine.HaplotypeCallerEngine.finish_region
    compute = hc_engine.compute_pairhmm_likelihoods

    def finish_counted(self, prep):
        total[0] += len(prep["prepped"]) * len(prep["haplotypes"])
        return finish(self, prep)

    def compute_counted(haplotypes, reads, args):
        total[0] += len(reads) * len(haplotypes)
        return compute(haplotypes, reads, args)

    hc_engine.HaplotypeCallerEngine.finish_region = finish_counted
    hc_engine.compute_pairhmm_likelihoods = compute_counted
    try:
        yield total
    finally:
        hc_engine.HaplotypeCallerEngine.finish_region = finish
        hc_engine.compute_pairhmm_likelihoods = compute


def _records(path):
    out = []
    with open(path) as fh:
        for line in fh:
            if not line.startswith("#"):
                f = line.rstrip("\n").split("\t")
                out.append(dict(pos=int(f[1]) - 1, ref=f[3], alts=f[4].split(","),
                                gt=f[9].split(":")[0], line=line))
    return out


def _run_hc(argv, hc_engine):
    from gatk_tpu_torch import cli
    from gatk_tpu_torch.ops import pairhmm
    from gatk_tpu_torch.utils.stopwatch import STAGES

    STAGES.reset()
    pairhmm.pairhmm_pairs.reset()  # counts of the run below only
    with counting_genotyped_pairs(hc_engine) as genotyped:
        t0 = time.perf_counter()
        rc = cli.main(["HaplotypeCaller", *argv])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    check(rc == 0, f"HaplotypeCaller {' '.join(argv)} exited {rc}")
    launches, pairs = pairhmm.pairhmm_pairs.launches, pairhmm.pairhmm_pairs.pairs
    check(launches > 0, "the PairHMM kernel was never launched by HaplotypeCaller")
    check(pairs == genotyped[0], f"kernel scored {pairs} pairs, the genotyped regions "
                                 f"hold {genotyped[0]} reads x haplotypes")
    return wall, launches, pairs, STAGES.report()


def _device_profile(argv):
    """The same HaplotypeCaller run again under torch.profiler: device time of the
    PairHMM kernel and of all device work (copies included) beside the run's wall
    time. The profiler slows the host, so this wall is not the one reported above."""
    from torch.profiler import ProfilerActivity, profile

    from gatk_tpu_torch import cli

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rc = cli.main(["HaplotypeCaller", *argv])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    check(rc == 0, f"profiled HaplotypeCaller {' '.join(argv)} exited {rc}")
    stats = prof.key_averages()
    busy_us = sum(e.self_device_time_total for e in stats)
    kernel_us = sum(e.self_device_time_total for e in stats if "pairhmm_fwd_kernel" in e.key)
    if busy_us == 0:  # the profiler saw no device activity: say so, invent nothing
        return dict(profiled_wall_s=wall, device_kernel_ms="not measured",
                    device_busy_ms="not measured", device_idle_share="not measured")
    return dict(profiled_wall_s=wall, device_kernel_ms=kernel_us / 1e3,
                device_busy_ms=busy_us / 1e3, device_idle_share=1 - busy_us / 1e6 / wall)


def phase_hc(sample, tmp):
    from gatk_tpu_torch.calling import hc_engine

    out = os.path.join(tmp, "out.vcf")
    with keeping_largest_launch() as kept:
        wall, launches, pairs, stages = _run_hc(
            ["-I", sample["bam"], "-R", sample["fasta"], "-O", out], hc_engine)
    recs = _records(out)
    by_pos = {r["pos"]: r for r in recs}
    snvs = [v for v in sample["variants"] if v.is_snv]
    indels = [v for v in sample["variants"] if not v.is_snv]
    missed_snv = [v.pos for v in snvs
                  if not (v.pos in by_pos and by_pos[v.pos]["ref"] == v.ref
                          and by_pos[v.pos]["alts"] == [v.alt] and by_pos[v.pos]["gt"] == "0/1")]
    indel_called = [v.pos for v in indels
                    if any(abs(r["pos"] - v.pos) <= 20 and len(r["ref"]) != len(r["alts"][0])
                           for r in recs)]
    profiled = _device_profile(["-I", sample["bam"], "-R", sample["fasta"], "-O", out + ".2"])
    with open(out, "rb") as a, open(out + ".2", "rb") as b:
        check(a.read() == b.read(), "a second HaplotypeCaller run wrote a different VCF")
    res = dict(phase="hc", reads=sample["n_reads"], records=len(recs), wall_s=wall,
               reads_per_s=sample["n_reads"] / wall, snvs_called=len(snvs) - len(missed_snv),
               snvs_planted=len(snvs), indels_called=len(indel_called),
               indels_planted=len(indels), launches=launches, pairs=pairs, stages=stages,
               **profiled)
    emit(res)
    check(not missed_snv, f"planted SNVs not called as 0/1: {missed_snv}")
    check(len(indel_called) >= len(indels) - 1,
          f"only {len(indel_called)} of {len(indels)} planted indels called")
    return res, kept


def phase_gvcf(sample, tmp):
    from gatk_tpu_torch.calling import hc_engine

    out = os.path.join(tmp, "out.g.vcf")
    first = min(v.pos for v in sample["variants"])
    start = max(0, first - 200)
    end = start + 2000  # 2 kb holding the first planted variants
    interval = f"{sample['contig']}:{start + 1}-{end}"
    wall, launches, pairs, stages = _run_hc(
        ["-I", sample["bam"], "-R", sample["fasta"], "-O", out, "-ERC", "GVCF",
         "-L", interval], hc_engine)
    recs = _records(out)
    planted = [v for v in sample["variants"] if start <= v.pos < end]
    found = [v.pos for v in planted
             if any(abs(r["pos"] - v.pos) <= 20 and "<NON_REF>" in r["alts"] and len(r["alts"]) > 1
                    for r in recs)]
    res = dict(phase="gvcf", interval=interval, records=len(recs), wall_s=wall,
               variants_planted=len(planted), variants_called=len(found),
               launches=launches, pairs=pairs, stages=stages)
    emit(res)
    check(len(found) == len(planted) and planted, f"GVCF missed planted variants: "
                                                  f"{sorted(set(v.pos for v in planted) - set(found))}")
    return res


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t_start = time.perf_counter()
    phase_device()
    k = phase_kernel(dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        from gatk_tpu_torch.utils import synthetic

        t0 = time.perf_counter()
        sample = synthetic.write_sample(tmp, seed=0)
        emit(dict(phase="sample", contig_len=sample["length"], reads=sample["n_reads"],
                  variants=len(sample["variants"]), write_s=time.perf_counter() - t0))
        hc, kept = phase_hc(sample, tmp)
        phase_gvcf(sample, tmp)
    main_launch = phase_main_launch(kept)
    smi = nvidia_smi_line()
    # times at the shape of the HaplotypeCaller run's largest launch; the bench
    # workload's are in the kernel phase's line. No single PyTorch call computes
    # the PairHMM, so there is no library time.
    err = max(k["max_abs_err_bench"], k["max_abs_err_ragged"], main_launch["max_abs_err"])
    kernels = [dict(name="pairhmm_fwd", route="cuda", source="gatk_tpu_torch/csrc/pairhmm_fwd.cu",
                    replaces="gatk_tpu/ops/pairhmm_tpu.py:746", launches=hc["launches"],
                    max_abs_err=err, max_abs_diff=err, ms=main_launch["kernel_ms"],
                    plain_ms=main_launch["plain_ms"], bound_ms=main_launch["bound_ms"],
                    bound_by=main_launch["bound_by"], library_ms=None)]
    print(f"total {time.perf_counter() - t_start:.1f} s", file=sys.stderr)
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
