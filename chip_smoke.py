#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gatk_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --dense-turns build/old/flow_pairhmm_dense.cu

The second form runs only the device phase and the postcall phase's dense
launch, and times the dense flow kernel against the earlier one of that
source (an earlier commit's csrc/flow_pairhmm_dense.cu, written there with
git show) in turns: earlier, current, current, earlier; then the postcall
phase's wide case, its device route timed in turns with a grid whose state
stays in the L2 cache.

Phases, each printing one JSON line; any failure exits non-zero:
  device   the card, its power limit, the kernel builds, the native host libraries
  kernel   the PairHMM pair kernel on bench.py's workload (64 reads x 151 bp, 16
           haplotypes x 400 bp, 32,768 pairs) and on ragged batches with N
           bases (rp 160 and 320; reads at every lane-group edge), against its
           plain PyTorch version and the host f64 reference; timed with CUDA
           events beside its bound and the scalar C++ baseline
  variants the port's entry point for each of gatk_tpu's pair kernels
           (ops/pairhmm.PAIR_VARIANTS, the counterpart of
           tools_dev/bench_kernels.py) on the bench workload and on a ragged
           batch whose haplotypes hold N, each against the plain version under
           its own N rule, timed
  sample   the synthetic 16,569 bp sample (~20,000 reads of 151 bp, 24 het SNVs
           and 6 het indels), written as a BAM and an indexed FASTA
  hc       HaplotypeCaller end to end (BAM -> VCF) through the port's CLI; the
           planted variants must be called, and the kernels must have scored
           exactly the genotyped regions' read x haplotype pairs
  ramped   RampedHaplotypeCaller --device cuda on the hc sample: the off-ramp
           after assembly, then the on-ramp (the pair kernel through
           PoolBatcher); every planted SNV called and >= 5 of 6 indels, the
           kernels scoring exactly the genotyped pairs, its largest launch held
           against the plain version and timed; whether the round trip calls
           the hc phase's sites and genotypes is reported
  recaller HaplotypeBasedVariantRecaller --device cuda on the hc sample's calls
           and -bamout: one pair-kernel launch a variant with reads, the matrix
           CSV within one step of its 4th decimal (1e-4) of a --device cpu run
           of the same tool on the first 8 variants; launches, median pairs a
           launch and walls
  gvcf     the same sample with -ERC GVCF on a 2 kb interval (the cartesian
           route: the matrix kernel)
  trio     a synthetic trio (utils/synthetic.write_trio: 16,569 bp, 20,000 reads
           a sample, 24 SNVs and 6 indels with Mendelian genotypes):
           HaplotypeCaller -ERC GVCF --device cuda over the whole contig for
           each sample (the matrix kernel), CombineGVCFs, GenotypeGVCFs, and
           GenomicsDBImport then GenotypeGVCFs on gendb://; every planted SNV
           with its planted genotype in all three samples, >= n - 1 of the
           indels in each, no Mendelian violation at a planted site, and the
           gendb:// VCF byte-identical to the CombineGVCFs path's; the largest
           matrix launch of the three held against the plain version and
           timed; each tool's wall and a profiled -ERC GVCF run; the sites a
           gatk_tpu fault reaches, with the samples' GVCF lines there
  mutect2  a synthetic tumor-only sample of the same size (8 germline het SNVs,
           12 somatic SNVs and 4 somatic indels at allele fractions 0.1-0.3)
           through Mutect2 and FilterMutectCalls on the port's CLI; the planted
           somatic variants must be called, the .stats file written, and the
           kernels must have scored exactly the genotyped regions' pairs
  preprocess  a chrM-length sample with 1,000 planted duplicates through
           MarkDuplicates (--metrics-file), BaseRecalibrator --known-sites and
           ApplyBQSR (host code, each timed), then HaplotypeCaller --device cuda
           on the recalibrated BAM: every planted duplicate flagged and as many
           flagged as the groups of one strand and unclipped 5' end hold, the
           read group's empirical quality within 1 of the planted error rate's
           (23.0), every planted SNV called, the largest launch held against
           the plain version and timed
  distributed  the port's data-parallel paths on every card (one on the
           card machine): graft_entry.entry() against its plain version,
           graft_entry.dryrun_multichip over the cards and over two slices of
           cuda:0, mesh.pairhmm_sharded on the bench workload over the cards
           and over two slices of cuda:0, each bit for bit against a
           one-device launch (timed), mesh.bqsr_histogram_step in a one-rank
           NCCL group against a float64 bincount, HaplotypeCaller --shard-size
           2000 on the hc sample in one process and in two processes on the
           card over gloo (collective gather; file gather with round-robin
           shards), each a subprocess under a timeout that reports its own
           kernel counts, whose records must equal the one process's with
           every planted SNV called and every process launching the pair
           kernel, and ReadsPipelineSpark --device cuda --known-sites on the
           preprocess sample (every planted SNV called; whether its records
           equal the preprocess phase's is reported)
  flow     HaplotypeCaller --likelihood-calculation-engine FlowBasedHMM
           --flow-order TGCA --device cuda over a synthetic flow-space sample
           (utils/synthetic.write_flow_sample: 16,569 bp, 3,400 reads of 200
           bases with tp and t0 tags, 24 het SNVs and 6 het indels, 3 of them
           a homopolymer's length): every planted SNV called 0/1 and >= 5 of 6
           indels, the flow kernel scoring exactly the genotyped regions' reads
           x haplotypes, a profiled second run (idle share), the largest launch
           held against both plain versions (the coset lattice's and the dense
           scan's) and timed beside its bound, its longest pair's rows and the
           microseconds a row, and the dense kernel on its pairs within 1e-4
           of the coset plain version, timed in turns with the coset kernel;
           the same for the pairs of the earlier dense kernel's largest launch
           (FLOW_DENSE_LARGEST), where the run makes them
  vqsr     a sites-only callset (utils/synthetic.write_callset: one 20 Mb
           contig, 18,000 SNVs and 2,000 indels, 80 % true sites, the seven
           annotations drawn apart, a truth VCF of 60 % of the true sites, a
           GATK_CNN_1D .pt made from a seed) through VariantRecalibrator (SNP,
           six annotations) and ApplyVQSR at 99 % truth sensitivity (true SNVs
           > 0.95 PASS, artifacts < 0.1), NVScoreVariants with the .pt on the
           card and with --device cpu (CNN_1D within 1e-3), NVScoreVariants
           --truth-vcf (40 epochs on the card; AUC of the scores against the
           planted labels >= 0.9) and FilterVariantTranches; the GATK_CNN_1D
           forward and a training step timed on the card, with launches a step
  postcall FlowPairHMMAlignReadsToHaplotypes --device cuda on every read of the
           flow sample (3,400 reads of 200 bases) against the reference and
           planted windows (300-400 bp) of its first 4 variants: one launch of
           the coset kernel over 27,200 pairs, within 1e-4 of its plain
           version on the card (equal -inf sets), the TSV equal to the kernel's
           values at 4 decimals, timed beside its bound, and the dense kernel
           on its pairs checked and timed in turns with it; the same tool with
           --flow-order TGCATGAC (not 4-periodic) on the reads of chrM:1-2000
           (PrintReads -L): one launch of the dense kernel over every pair,
           within 1e-4 of gatk_tpu's dense scan on the card
           (flow_pairhmm_dense_plain), the TSV equal to its values at 4
           decimals, timed beside its plain version, its bound (the cells of
           its live lattices alone) and the earlier dense count (each pair's
           own columns of all four lattices), with its state route; the
           same reads against the sample's whole contig as one haplotype
           (16,569 bp, 25,036 flows in TGCA, past the width the coset
           kernel's shared memory holds): one launch of the dense kernel
           over every pair and none of the coset kernel, within 1e-4 of both
           plain versions on the card, the TSV equal to its values at 4
           decimals, timed beside its bounds, with its state route. Then the
           post-calling chain on the vqsr phase's callset:
           SelectVariants --select-type-to-include SNP (exactly the SNVs) and
           -select "QD > 2.0" (exactly the records whose INFO QD is above 2);
           VariantFiltration with GATK's six SNP hard filters (FILTER names
           exactly the filters the phase computes from INFO); VariantEval
           --comp truth.vcf (CountVariants' nSNPs, nInsertions and nDeletions
           and CompOverlap's nVariantsAtComp equal the phase's counts of the
           PASS records); Funcotator VCF and MAF against a synthetic GENCODE
           datasource of 1,000 genes (utils/synthetic.write_gencode_datasource;
           every site outside the genes IGR, or FIVE_PRIME_FLANK within 5 kb
           before one, every SNV inside a CDS SILENT, MISSENSE or NONSENSE by
           the phase's own translation with the standard code, outside the
           first and last codons and 2 bases from an exon end), then
           FilterFuncotations; each tool's host seconds and record counts
  main_launch  the largest pair-kernel launch of the hc run, held against the
           plain version and timed at that shape
  gcnv     the germline CNV tools through the port's CLI on a GermlineCNVCaller
           shard of 32 samples x 10,000 intervals (utils/synthetic.write_cnv_cohort,
           DenoisingConfig's defaults): CollectReadCounts (on the hc sample's
           BAM), DetermineGermlineContigPloidy, GermlineCNVCaller --device cuda
           and PostprocessGermlineCNVCalls; every contig-ploidy call must be the
           planted one, the planted CN called on >= 95 % of the event intervals
           and the baseline on >= 99 % of the rest. It reports the seconds of
           fit's posterior passes, ADAM steps and scale steps, and from a
           profiled second GermlineCNVCaller run their launches and the device
           idle share
  cnv_hmm  the copy-number HMM kernels (csrc/cnv_hmm.cu, a chunked pass) on the
           gcnv run's fitted shard and on edge batches (one interval, a chain
           break at every interval, stay 1, 32 states, 1 state, the chunks'
           edges, and 33, 64, 100 and 257 states: a warp a vector), against
           the float64 and float32 sequential plain versions and the chunked
           plain version (HMM_TOL_*); timed beside its bound (the batches past
           32 states too), at every chunk of a sweep, and profiled by kernel
  somatic_cnv  a panel of 40 normals x 50,000 intervals built in-process, its SVD
           on the card, a tumor case denoised against it, then ModelSegments
           --device cuda (all 50 contigs, 10,000 het sites) and
           CallCopyRatioSegments through the CLI; every planted breakpoint must
           be found within 3 intervals and the posterior medians within 0.1
           (log2 copy ratio) and 0.05 (minor-allele fraction) of the planted
           values. It reports the SVD's milliseconds, the host segmentation's
           seconds and the chains' seconds and launches
  matrix   the cartesian kernel on the bench workload's 1,024 unique pairs, a
           ragged rp 320 / hmax 2048 region with N, a region of reads at every
           lane-group edge, a region of 1,100
           haplotypes and the largest launch of the gvcf run, against its plain
           version; timed beside its bound and beside the pair kernel on the
           same product expanded into pairs
  tools    host tools only (no kernel): the port's registry holds gatk_tpu's 312
           tool names and 36 Spark-named aliases (on the card machine, which
           has none of h5py, scikit-learn and matplotlib); then on the hc sample
           ValidateSamFile (no error), SamToFastq then FastqToSam (the same
           read names and, in sequencing orientation, the same bases),
           CreateSequenceDictionary (chrM at its length), CollectWgsMetrics
           (MEAN_COVERAGE above 0 and at most the raw depth the phase counts)
           and SortSam of a shuffled copy (the input's coordinates in order,
           the same reads at each), each tool's wall on the host clock
Each of the runs hc, ramped, recaller, gvcf, flow, trio, mutect2, preprocess,
distributed (its sharded calls; its two-process HaplotypeCaller runs, summed
over the processes; its ReadsPipelineSpark run), postcall (its two
FlowPairHMMAlignReadsToHaplotypes runs, summed), gcnv and variants starts with
every kernel's launch count at 0 and reads the counts at its end. hc, gvcf and mutect2 also
profile a second run (device time of the sweep kernels, of the plan kernels
their launchers run first, and of all device work) and report every launch's
useful cells, bound, group-width histogram and slot use (launch_stats), and
the sum of the bounds. Then the whole run's seconds, the card's name and power
limit as nvidia-smi prints them, one JSON line listing every kernel of the
port, and the result line.
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
# (ops/pairhmm.py:_forward): M = prior*(tmm*m + tim*(x + y)) is 5,
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


# --------------------------------------------------------------------------- counts


def _entries():
    """The port's kernel entries, each with its launch counter and a counter of
    its work (PairHMM and flow PairHMM pairs, HMM states)."""
    from gatk_tpu_torch.ops import cnv_hmm, flow_pairhmm, pairhmm

    return {"pairhmm_fwd": pairhmm.pairhmm_pairs,
            "pairhmm_fwd_hap_n_mismatch": pairhmm.pairhmm_pairs_hap_n_mismatch,
            "pairhmm_matrix": pairhmm.pairhmm_matrix,
            "cnv_hmm": cnv_hmm.hmm_forward_backward,
            "flow_pairhmm": flow_pairhmm.flow_pairhmm_pairs,
            "flow_pairhmm_dense": flow_pairhmm.flow_pairhmm_pairs.dense}


def reset_counts():
    for entry in _entries().values():
        entry.reset()


def read_counts():
    return {name: dict(launches=e.launches, **({"passes": e.passes, "cells": e.cells}
                                               if hasattr(e, "cells") else {"pairs": e.pairs}))
            for name, e in _entries().items()}


def _pairs(counts):
    """Pairs scored, summed over the PairHMM entries (the flow PairHMM's too;
    its dense kernel scores again pairs the coset kernel's launch held,
    except past the coset kernel's width, where no genotyped region's
    haplotypes reach)."""
    return sum(c.get("pairs", 0) for name, c in counts.items() if name != "flow_pairhmm_dense")


# --------------------------------------------------------------------------- device


def phase_device():
    from gatk_tpu_torch.assembly import rtgraph
    from gatk_tpu_torch.calling import read_prep
    from gatk_tpu_torch.engine import pileup
    from gatk_tpu_torch.io import bam, bgzf
    from gatk_tpu_torch.ops import _kernels, pdhmm, smith_waterman

    t0 = time.perf_counter()
    _kernels.library("pairhmm_fwd")  # builds every kernel, one nvcc each, in parallel
    build_s = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if any(w in ln for w in ("registers", "spill", "Function properties"))]
             for name, log in _kernels.BUILD_INFO["log"].items()}
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


def _ragged_workload(read_lens, hap_lens, seed, hap_n=0.0):
    """Reads and haplotypes of the given lengths, cut from one sequence with ~2%
    N (reads also get a few errors of their own, haplotypes a share hap_n of Ns
    of their own)."""
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
        h = master[s : s + L].copy()
        if hap_n:
            h[rng.random(L) < hap_n] = ord("N")
        haps.append(h.tobytes())
    return reads, haps


# (read lengths, haplotype lengths, rp, hmax): every length of the pool's
# buckets, then long reads over two 160-row stripes with haplotypes up to the
# largest bucket, as oversize regions reach the cartesian route, then every
# edge of the lane groups (4, 8, 16, 32 lanes of 5 rows) with haplotypes of 1 to
# 512 bases
RAGGED = (
    (range(1, 159), (1, 2, 3, 31, 32, 33, 100, 158, 255, 256, 400, 511, 512), 160, 512),
    ((150, 159, 160, 161, 200, 255, 317, 318), (1, 160, 400, 1000, 1500, 2047, 2048), 320, 2048),
    ((1, 19, 20, 21, 39, 40, 41, 79, 80, 81, 159, 160, 161), (1, 2, 7, 64, 113, 200, 333, 511, 512),
     320, 512),
)


def _device_pools(reads, haps, ri, hi, dev, rp=None, hmax=None):
    from gatk_tpu_torch.ops import pairhmm

    packed, rp = pairhmm.pack_reads(reads, rp=rp, nr=len(reads))
    e, hlen, _ = pairhmm.pack_haps(haps, rp, hmax=hmax, nh=len(haps))
    pools = pairhmm.make_pools(packed, packed["rlen"], e, hlen, dev)
    return pools, torch.from_numpy(ri).to(dev), torch.from_numpy(hi).to(dev)


def _check_close(got, want, what):
    """Kernel output against the plain version's on the same inputs: (max
    |kernel - plain| above the floor, entries above it); the below-floor sets
    must be identical."""
    from gatk_tpu_torch.ops import pairhmm

    torch.cuda.synchronize()
    check(got.shape == want.shape and not got.isnan().any(),
          f"{what}: kernel output has NaN or a wrong shape")
    ok = want > pairhmm.MIN_ACCEPTED_LOG10
    check(torch.equal(ok, got > pairhmm.MIN_ACCEPTED_LOG10),
          f"{what}: kernel and plain version disagree on which pairs are below the floor")
    err = (got[ok] - want[ok]).abs().max().item() if ok.any() else 0.0
    check(err <= KERNEL_TOL, f"{what}: max |kernel - plain| = {err} > {KERNEL_TOL}")
    return err, int(ok.sum())


def _compare(pools, ri, hi, what, hap_n_mismatch=False):
    """The pair kernel against its plain version: (kernel output, max error
    above the floor, pairs above it). Launches here are not counted as a path's."""
    from gatk_tpu_torch.ops import _kernels, pairhmm

    got = _kernels.pairhmm_fwd(pools, ri, hi, hap_n_mismatch=hap_n_mismatch)
    want = pairhmm.pairhmm_pairs_reference(pools, ri, hi, hap_n_mismatch=hap_n_mismatch)
    return (got, *_check_close(got, want, what))


def _bound(cells, in_bytes, out_bytes, flops_per_cell=FLOPS_PER_CELL):
    """The least time the card could take: the larger of the FP32 time of the
    cells and the time to read the inputs once and write the output once."""
    ops_ms = cells * flops_per_cell / FP32_PEAK * 1e3
    bytes_ms = (in_bytes + out_bytes) / HBM_RATE * 1e3
    return dict(useful_cells=cells, bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                ops_bound_ms=ops_ms, bytes_bound_ms=bytes_ms)


def _pool_bytes(pools):
    return sum(t.numel() * t.element_size() for t in pools)


def _timed(pools, ri, hi, plain_reps=3, hap_n_mismatch=False):
    """CUDA-event medians of the pair kernel (30 launches) and the plain version
    on the same inputs, beside the bound of the cells these pairs need (rlen x
    hlen each), the pools and pair lists read once and the output written once."""
    from gatk_tpu_torch.ops import _kernels, pairhmm

    kernel_ms = median_ms(lambda: _kernels.pairhmm_fwd(pools, ri, hi, hap_n_mismatch),
                          reps=30, warmup=3)
    plain_ms = median_ms(lambda: pairhmm.pairhmm_pairs_reference(pools, ri, hi, hap_n_mismatch),
                         reps=plain_reps, warmup=1)
    n = ri.numel()
    cells = int((pools.rlen[ri.long()].long() * pools.hlen[hi.long()].long()).sum().item())
    bound = _bound(cells, _pool_bytes(pools) + 8 * n, 4 * n)
    return dict(pairs=n, kernel_ms=kernel_ms, plain_ms=plain_ms,
                useful_gcups=cells / kernel_ms / 1e6, **bound)


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


# --------------------------------------------------------------------------- variants


def phase_variants(dev):
    """Each of gatk_tpu's pair kernels through the port's entry point for it, as
    tools_dev/bench_kernels.py runs them: the bench workload and a ragged batch
    whose haplotypes hold Ns of their own. The entries' outputs are held against
    the plain version under each entry's N rule; then each N rule's kernel
    instance is timed (v2, v4, v5, v6 and v7 share one instance)."""
    from gatk_tpu_torch.ops import pairhmm

    reads, haps, ri, hi = _bench_workload()
    bench = _device_pools(reads, haps, ri, hi, dev, rp=160, hmax=512)
    read_lens, hap_lens, rp, hmax = RAGGED[0]
    rr, hh = _ragged_workload(read_lens, hap_lens, seed=3, hap_n=0.02)
    ragged = _device_pools(rr, hh, *pairhmm.cartesian_pairs(len(rr), len(hh)), dev, rp=rp,
                           hmax=hmax)

    reset_counts()
    outs = {name: (entry(*bench), entry(*ragged)) for name, entry in pairhmm.PAIR_VARIANTS.items()}
    torch.cuda.synchronize()
    counts = read_counts()
    n_rules = {rule: sum(e.hap_n_mismatch == rule for e in pairhmm.PAIR_VARIANTS.values())
               for rule in (False, True)}
    check(counts["pairhmm_fwd"]["launches"] == 2 * n_rules[False]
          and counts["pairhmm_fwd_hap_n_mismatch"]["launches"] == 2 * n_rules[True],
          f"the variant entries did not launch their kernel instances: {counts}")

    plain = {rule: tuple(pairhmm.pairhmm_pairs_reference(*w, hap_n_mismatch=rule)
                         for w in (bench, ragged)) for rule in (False, True)}
    ok = plain[True][1] > pairhmm.MIN_ACCEPTED_LOG10
    rule_gap = (plain[True][1] - plain[False][1])[ok].abs().max().item()
    check(rule_gap > 1e-2, f"the ragged batch does not tell the N rules apart ({rule_gap})")
    timed = {rule: _timed(*bench, plain_reps=2, hap_n_mismatch=rule) for rule in (False, True)}
    variants = []
    for name, entry in pairhmm.PAIR_VARIANTS.items():
        rule = entry.hap_n_mismatch
        err_b, _ = _check_close(outs[name][0], plain[rule][0], f"{name} bench")
        err_r, n_ok = _check_close(outs[name][1], plain[rule][1], f"{name} ragged/N")
        variants.append(dict(jax=name, hap_n_mismatch=rule,
                             max_abs_err_bench=err_b, max_abs_err_ragged=err_r,
                             ragged_above_floor=n_ok, kernel_ms=timed[rule]["kernel_ms"],
                             plain_ms=timed[rule]["plain_ms"], bound_ms=timed[rule]["bound_ms"]))
    res = dict(phase="variants", counts=counts, ragged_pairs=ragged[1].numel(),
               n_rule_gap=rule_gap, variants=variants,
               timed={"host_rule": timed[False], "hap_n_mismatch": timed[True]})
    emit(res)
    return res


# --------------------------------------------------------------------------- hc / gvcf / mutect2


@contextlib.contextmanager
def keeping_launches(kernel):
    """Keeps the inputs of every launch of `kernel` (a wrapper of ops/_kernels:
    "pairhmm_fwd" or "pairhmm_matrix") made inside the block: kept["all"] in
    launch order, kept["args"] the largest, so that the kernel can be held
    against its plain version, and timed, at a shape the main path gave it,
    and every launch's cells and lane-slots counted (launch_stats)."""
    from gatk_tpu_torch.ops import _kernels

    launch = getattr(_kernels, kernel)
    kept = {"n": 0, "all": []}

    def keep(pools, *args, **kwargs):
        n = args[0].numel() if args else pools.rbase.shape[1] * pools.e.shape[1]
        kept["all"].append((pools, *args))
        if n > kept["n"]:
            kept.update(n=n, args=(pools, *args))
        return launch(pools, *args, **kwargs)

    setattr(_kernels, kernel, keep)
    try:
        yield kept
    finally:
        setattr(_kernels, kernel, launch)


def _lanes(rows):
    """(lanes a read's group sweeps with, its 160-row stripes): one stripe of
    ceil(rows / 5) lanes up to 160 rows, 32 lanes a stripe beyond."""
    stripes = (rows + 159) // 160
    return torch.where(rows > 160, torch.full_like(rows, 32), (rows + 4) // 5), stripes


def launch_stats(args):
    """One launch's work, counted on the host from its inputs and from the plan
    (ops/_kernels.plan_groups, the plain version of the one the launcher builds
    on the card): pairs, useful cells (rlen x hlen summed), the bound, the
    group-width histogram, and lane-slots (one lane computing one row-cell:
    160 a warp-step) of this design and of one warp per pair or read (the
    design of commit 0487e99); slot use = useful cells / lane-slots."""
    from gatk_tpu_torch.ops import _kernels

    pools = args[0]
    rlen, hlen = pools.rlen.long().cpu(), pools.hlen.long().cpu()
    nr, nh = len(rlen), len(hlen)
    if len(args) > 1:  # the pair kernel: one item per pair
        ri, hi = (t.long().cpu() for t in args[1:3])
        rows, hl = rlen[ri], hlen[hi]
        perm, seg = _kernels.plan_groups(rows, hl, pools.hmax)
        cells = int((rows * hl).sum())
        lanes, stripes = _lanes(rows)
        item_steps = torch.where((rows > 0) & (hl > 0), stripes * (hl + lanes - 1), 0)
        one_warp_slots = 160 * int(item_steps.sum())
        n, out_bytes, in_bytes = len(ri), 4 * len(ri), _pool_bytes(pools) + 8 * len(ri)
    else:  # the matrix kernel: one item per read, every haplotype
        rows = rlen
        perm, seg = _kernels.plan_groups(rows)
        valid = hlen[hlen > 0]
        sum_h, n_h = int(valid.sum()), len(valid)
        cells = int(rows.sum()) * int(hlen.sum())
        lanes, stripes = _lanes(rows)
        one_warp_slots = 160 * int((torch.where(rows > 0, stripes, 0)
                               * (sum_h + n_h * (lanes - 1))).sum())
        n, out_bytes, in_bytes = nr * nh, 4 * nr * nh, _pool_bytes(pools)
    slots = 0
    widths = {}
    for c, width in enumerate(_kernels.GROUP_WIDTHS):
        idx = perm[seg[c] : seg[c + 1]].long()
        widths[str(width)] = len(idx)
        if not len(idx):
            continue
        per_warp = 32 // width
        pad = (-len(idx)) % per_warp
        la, st = (torch.cat([t[idx], t.new_zeros(pad)]).reshape(-1, per_warp) for t in _lanes(rows))
        if len(args) > 1:  # a warp runs until its longest group is done
            h = torch.cat([hl[idx], hl.new_zeros(pad)]).reshape(-1, per_warp)
            slots += 160 * int(torch.where(h > 0, st * (h + la - 1), 0).max(1).values.sum())
        else:  # every haplotype, for the warp's most lanes
            slots += 160 * int((st.max(1).values * (sum_h + n_h * (la.max(1).values - 1))).sum())
    return dict(pairs=n, widths=widths, lane_slots=slots, slot_use=cells / max(slots, 1),
                one_warp_slot_use=cells / max(one_warp_slots, 1),
                **_bound(cells, in_bytes, out_bytes))


def _launches_summary(kept):
    """Every launch of a path: its stats, and the sum of their bounds."""
    stats = [launch_stats(a) for a in kept["all"]]
    return dict(launch_stats=stats, sum_bound_ms=sum(st["bound_ms"] for st in stats))


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


@contextlib.contextmanager
def counting_m2_regions(m2_engine):
    """Counts reads x haplotypes of every region Mutect2Engine genotyped, and
    times its host stages in STAGES (activity: the active-region scan;
    prepare_region: finalize-reads, assembly, read prep and pair dispatch;
    finish_region: waiting for the likelihoods and somatic genotyping; flush:
    the pool's last launch). Restores what it wraps."""
    from gatk_tpu_torch.ops import pairhmm
    from gatk_tpu_torch.utils.stopwatch import STAGES

    total = [0]
    eng = m2_engine.Mutect2Engine
    saved = (eng._prepare_region, eng._finish_region, m2_engine.m2_activity.find_active_regions,
             pairhmm.PoolBatcher.flush)

    def timed(name, fn):
        def run(*args, **kwargs):
            with STAGES.stage(name):
                return fn(*args, **kwargs)
        return run

    def finish_counted(self, prep, sample_of_read=None):
        total[0] += len(prep["prepped"]) * len(prep["haplotypes"])
        return saved[1](self, prep, sample_of_read)

    eng._prepare_region = timed("prepare_region", saved[0])
    eng._finish_region = timed("finish_region", finish_counted)
    m2_engine.m2_activity.find_active_regions = timed("activity", saved[2])
    pairhmm.PoolBatcher.flush = timed("flush", saved[3])
    try:
        yield total
    finally:
        (eng._prepare_region, eng._finish_region, m2_engine.m2_activity.find_active_regions,
         pairhmm.PoolBatcher.flush) = saved


def _records(path):
    out = []
    with open(path) as fh:
        for line in fh:
            if not line.startswith("#"):
                f = line.rstrip("\n").split("\t")
                out.append(dict(pos=int(f[1]) - 1, ref=f[3], alts=f[4].split(","),
                                filter=f[6], gt=f[9].split(":")[0], line=line))
    return out


def _run_tool(argv, counting=None):
    """One run of a tool through the port's CLI with every kernel count at 0
    before it: (wall s ending in a device synchronisation, counts, stage
    report); fails the script when the tool fails. With `counting`, the
    kernels must have scored exactly the pairs of the regions it saw
    genotyped."""
    from gatk_tpu_torch import cli
    from gatk_tpu_torch.utils.stopwatch import STAGES

    STAGES.reset()
    reset_counts()  # counts of the run below only
    with counting or contextlib.nullcontext() as genotyped:
        t0 = time.perf_counter()
        rc = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    check(rc == 0, f"{' '.join(argv)} exited {rc}")
    counts = read_counts()
    if counting is not None:
        pairs = _pairs(counts)
        check(pairs == genotyped[0], f"{argv[0]}: the kernels scored {pairs} pairs, the "
                                     f"genotyped regions hold {genotyped[0]} reads x haplotypes")
    return wall, counts, STAGES.report()


SWEEPS = ["pairhmm_fwd_kernel", "pairhmm_matrix_kernel"]
PLAN = ["plan_count", "plan_scan", "plan_scatter"]  # csrc/pairhmm_sweep.cuh


LAUNCH_EVENTS = ("cudaLaunchKernel", "cuLaunchKernel")  # CUDA runtime / driver launch calls


def _profile(fn, range_prefix=None, kernels=None):
    """fn() under torch.profiler, read from the profiler's raw events (building
    its FunctionEvents takes minutes for a run of 10^5 launches): wall s,
    device busy ms (kernels and copies), idle share, kernel launches (CUDA
    runtime or driver launch calls, ours by ctypes included); for each
    kernels[k], a list of name parts, the device ms of the kernels whose names
    hold one as device_<k>_ms; and per range whose name starts with
    range_prefix how often it ran and the launches the host made inside it.
    The profiler slows the host, so this wall is not the unprofiled one."""
    import bisect

    from torch.profiler import ProfilerActivity, profile

    kernels = kernels or {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_ns, launches, ranges = 0, [], []
    named_ns = dict.fromkeys(kernels, 0)
    events = prof.profiler.kineto_results.events()
    on_card = [e.device_type() == torch.autograd.DeviceType.CUDA for e in events]
    # a device event named as a host event is a record_function range's copy on
    # the device's timeline, not device work
    host_names = {e.name() for e, card in zip(events, on_card) if not card}
    for e, card in zip(events, on_card):
        name = e.name()
        if range_prefix and name.startswith(range_prefix):
            if not card:
                ranges.append((name, e.start_ns(), e.start_ns() + e.duration_ns()))
        elif card and name not in host_names:
            busy_ns += e.duration_ns()
            for k, parts in kernels.items():
                if any(p in name for p in parts):
                    named_ns[k] += e.duration_ns()
        elif not card and name.startswith(LAUNCH_EVENTS):
            launches.append(e.start_ns())
    launches.sort()
    per_range = {}
    for name, lo, hi in ranges:
        r = per_range.setdefault(name, dict(ranges=0, launches=0))
        r["ranges"] += 1
        r["launches"] += bisect.bisect_right(launches, hi) - bisect.bisect_left(launches, lo)
    # the profiler saw no device activity or no launch call: say so, invent nothing
    if not launches:
        per_range = {name: dict(r, launches="not measured") for name, r in per_range.items()}
    out = dict(profiled_wall_s=wall, profiled_launches=len(launches) or "not measured")
    if busy_ns:
        out.update(device_busy_ms=busy_ns / 1e6, device_idle_share=1 - busy_ns / 1e9 / wall,
                   **{f"device_{k}_ms": ns / 1e6 for k, ns in named_ns.items()})
    else:
        out.update(device_busy_ms="not measured", device_idle_share="not measured",
                   **{f"device_{k}_ms": "not measured" for k in kernels})
    if range_prefix:
        out["ranges"] = per_range
    return out


def _profile_tool(argv):
    """The same tool run again under _profile: device time of the sweep kernels,
    of the plan kernels their launchers run first, and of all device work."""
    from gatk_tpu_torch import cli

    return _profile(lambda: check(cli.main(argv) == 0, f"profiled {' '.join(argv)} failed"),
                    kernels=dict(kernel=SWEEPS, plan=PLAN))


def _indels_called(planted, recs):
    """Planted indels with a called indel of the same length change within 20 bp
    (an indel in a repeat is reported left-aligned)."""
    return [v.pos for v in planted
            if any(abs(r["pos"] - v.pos) <= 20
                   and len(r["ref"]) - len(r["alts"][0]) == len(v.ref) - len(v.alt)
                   for r in recs)]


def _germline_gates(sample, recs):
    """(planted SNVs not called 0/1 with their alleles, planted indels called)."""
    by_pos = {r["pos"]: r for r in recs}
    missed = [v.pos for v in sample["variants"] if v.is_snv
              and not (v.pos in by_pos and by_pos[v.pos]["ref"] == v.ref
                       and by_pos[v.pos]["alts"] == [v.alt] and by_pos[v.pos]["gt"] == "0/1")]
    return missed, _indels_called([v for v in sample["variants"] if not v.is_snv], recs)


def _largest_launch(kept, what):
    """The largest pair-kernel launch a path kept (keeping_launches), held
    against its plain version and timed beside it."""
    check(kept["n"] > 0, f"{what}: no pair-kernel launch was kept")
    pools, ri, hi = kept["args"]
    _, err, n_ok = _compare(pools, ri, hi, what)
    return dict(rp=pools.rp, hmax=pools.hmax, reads=pools.rbase.shape[1], haps=pools.e.shape[1],
                above_floor=n_ok, max_abs_err=err, **_timed(pools, ri, hi))


def phase_hc(sample, tmp):
    from gatk_tpu_torch.calling import hc_engine

    out = os.path.join(tmp, "out.vcf")
    argv = ["HaplotypeCaller", "-I", sample["bam"], "-R", sample["fasta"], "-O", out]
    with keeping_launches("pairhmm_fwd") as kept:
        wall, counts, stages = _run_tool(argv, counting_genotyped_pairs(hc_engine))
    check(counts["pairhmm_fwd"]["launches"] > 0,
          "the PairHMM kernel was never launched by HaplotypeCaller")
    recs = _records(out)
    missed_snv, indel_called = _germline_gates(sample, recs)
    snvs = [v for v in sample["variants"] if v.is_snv]
    indels = [v for v in sample["variants"] if not v.is_snv]
    profiled = _profile_tool(argv[:-1] + [out + ".2"])
    with open(out, "rb") as a, open(out + ".2", "rb") as b:
        check(a.read() == b.read(), "a second HaplotypeCaller run wrote a different VCF")
    res = dict(phase="hc", reads=sample["n_reads"], records=len(recs), wall_s=wall,
               reads_per_s=sample["n_reads"] / wall, snvs_called=len(snvs) - len(missed_snv),
               snvs_planted=len(snvs), indels_called=len(indel_called),
               indels_planted=len(indels), launches=counts["pairhmm_fwd"]["launches"],
               pairs=_pairs(counts), counts=counts, stages=stages,
               **profiled, **_launches_summary(kept))
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
    argv = ["HaplotypeCaller", "-I", sample["bam"], "-R", sample["fasta"], "-ERC", "GVCF",
            "-L", interval, "-O", out]
    with keeping_launches("pairhmm_matrix") as kept:
        wall, counts, stages = _run_tool(argv, counting_genotyped_pairs(hc_engine))
    check(counts["pairhmm_matrix"]["launches"] > 0,
          "the cartesian kernel was never launched by HaplotypeCaller -ERC GVCF")
    recs = _records(out)
    planted = [v for v in sample["variants"] if start <= v.pos < end]
    found = [v.pos for v in planted
             if any(abs(r["pos"] - v.pos) <= 20 and "<NON_REF>" in r["alts"] and len(r["alts"]) > 1
                    for r in recs)]
    profiled = _profile_tool(argv[:-1] + [out + ".2"])
    with open(out, "rb") as a, open(out + ".2", "rb") as b:
        check(a.read() == b.read(), "a second -ERC GVCF run wrote a different GVCF")
    res = dict(phase="gvcf", interval=interval, records=len(recs), wall_s=wall,
               variants_planted=len(planted), variants_called=len(found),
               launches=counts["pairhmm_matrix"]["launches"],
               pairs=_pairs(counts), counts=counts, stages=stages,
               **profiled, **_launches_summary(kept))
    emit(res)
    check(len(found) == len(planted) and planted, f"GVCF missed planted variants: "
                                                  f"{sorted(set(v.pos for v in planted) - set(found))}")
    return res, kept


def phase_mutect2(tmp):
    from gatk_tpu_torch import cli
    from gatk_tpu_torch.mutect import engine as m2_engine
    from gatk_tpu_torch.utils import synthetic

    t0 = time.perf_counter()
    sample = synthetic.write_tumor_sample(os.path.join(tmp, "tumor"), seed=0)
    write_s = time.perf_counter() - t0
    out = os.path.join(tmp, "tumor.vcf")
    argv = ["Mutect2", "-I", sample["bam"], "-R", sample["fasta"], "-O", out]
    with keeping_launches("pairhmm_fwd") as kept:
        wall, counts, stages = _run_tool(argv, counting_m2_regions(m2_engine))
    check(counts["pairhmm_fwd"]["launches"] > 0, "the PairHMM kernel was never launched by Mutect2")
    check(os.path.exists(out + ".stats"), "Mutect2 wrote no .stats file")
    recs = _records(out)
    called = {(r["pos"], r["ref"], r["alts"][0]) for r in recs}
    snvs = [v for v in sample["somatic"] if v.is_snv]
    indels = [v for v in sample["somatic"] if not v.is_snv]
    missed_snv = [v.pos for v in snvs if (v.pos, v.ref, v.alt) not in called]
    indel_called = _indels_called(indels, recs)
    germline_called = sum((v.pos, v.ref, v.alt) in called for v in sample["germline"])

    filtered = os.path.join(tmp, "tumor.filtered.vcf")
    t0 = time.perf_counter()
    rc = cli.main(["FilterMutectCalls", "-V", out, "-O", filtered])
    filter_s = time.perf_counter() - t0
    check(rc == 0, f"FilterMutectCalls exited {rc}")
    frecs = _records(filtered)
    check(len(frecs) == len(recs), "FilterMutectCalls dropped or added records")
    passing = {(r["pos"], r["ref"], r["alts"][0]) for r in frecs if r["filter"] == "PASS"}
    somatic_pass = sum((v.pos, v.ref, v.alt) in passing for v in sample["somatic"])

    profiled = _profile_tool(argv[:-1] + [out + ".2"])
    with open(out, "rb") as a, open(out + ".2", "rb") as b:
        check(a.read() == b.read(), "a second Mutect2 run wrote a different VCF")
    largest = _largest_launch(kept, "Mutect2's largest launch")
    res = dict(phase="mutect2", contig_len=sample["length"], reads=sample["n_reads"],
               write_s=write_s, records=len(recs), wall_s=wall,
               reads_per_s=sample["n_reads"] / wall, somatic_snvs_planted=len(snvs),
               somatic_snvs_called=len(snvs) - len(missed_snv),
               somatic_indels_planted=len(indels), somatic_indels_called=len(indel_called),
               germline_planted=len(sample["germline"]), germline_called=germline_called,
               filter_s=filter_s, passing=len(passing), somatic_passing=somatic_pass,
               launches=counts["pairhmm_fwd"]["launches"],
               pairs=_pairs(counts), counts=counts,
               stages=stages, largest_launch=largest, **profiled, **_launches_summary(kept))
    emit(res)
    check(not missed_snv, f"planted somatic SNVs not in the unfiltered VCF: {missed_snv}")
    check(len(indel_called) >= len(indels) - 1,
          f"only {len(indel_called)} of {len(indels)} planted somatic indels called")
    return res


def phase_main_launch(kept):
    """The largest launch of the HaplotypeCaller run: kernel against plain, timed."""
    res = dict(phase="main_launch", **_largest_launch(kept, "HaplotypeCaller's largest launch"))
    emit(res)
    return res


# --------------------------------------------------------------------------- flow

FLOW = dict(seed=0)  # utils/synthetic.write_flow_sample at its defaults: 16,569 bp, 3,400 reads
# FP32 operations per needed flow DP cell, counted from the kernel's function
# (csrc/flow_pairhmm.cu): M 5, I 3, D 3 (m * MD, dd * d, the sum), and the 2
# comparisons of the row maximum of M and I
FLOW_FLOPS_PER_CELL = 13
# FP32 operations per dense cell of the dense kernel's function
# (csrc/flow_pairhmm_dense.cu, gatk_tpu's dense scan): M 5, I 3, D 3, and the
# 3 comparisons of the row maximum of M, I and D
FLOW_DENSE_FLOPS_PER_CELL = 14
# The largest launch of the earlier dense flow kernel (a block a pair on a
# gathered (B, Rp, W) prior, which took a region's pairs in parts of whole
# pairs) on this sample: the first 1,948 pairs of the region whose launch has
# Rp 260 and W 265; timed again here to set the kernel beside the dense
# kernel's time on the same pairs (PERF.md)
FLOW_DENSE_LARGEST = dict(pairs=1948, Rp=260, W=265)


@contextlib.contextmanager
def keeping_flow_launches():
    """Keeps the inputs (tables, ri, hi) of the largest launch of the flow
    kernel made inside the block, by pairs x rows x width (B x Rp x (Hp + 5)),
    the (B, Rp, Hp + 5) of every launch, and as "dense" the pairs of
    FLOW_DENSE_LARGEST where a launch has its Rp and W."""
    from gatk_tpu_torch.ops import _kernels, flow_pairhmm

    launch = _kernels.flow_pairhmm
    kept = {"n": 0, "shapes": [], "dense": None}
    dense = FLOW_DENSE_LARGEST

    def keep(tab, ri, hi):
        shape = (ri.numel(), tab["rfo"].shape[1], tab["hkey"].shape[1] + 1 + flow_pairhmm.FLOW_SIZE)
        kept["shapes"].append(shape)
        if int(np.prod(shape)) > kept["n"]:
            kept.update(n=int(np.prod(shape)), args=(tab, ri, hi))
        if shape[1:] == (dense["Rp"], dense["W"]) and shape[0] >= dense["pairs"]:
            kept["dense"] = (tab, ri[:dense["pairs"]], hi[:dense["pairs"]])
        return launch(tab, ri, hi)

    _kernels.flow_pairhmm = keep
    try:
        yield kept
    finally:
        _kernels.flow_pairhmm = launch


@contextlib.contextmanager
def counting_flow_pairs(hc_engine):
    """Counts reads x haplotypes of every region HaplotypeCallerEngine
    genotyped through FlowBasedHMM (its prep holds no PairHMM reads)."""
    total = [0]
    finish = hc_engine.HaplotypeCallerEngine.finish_region

    def finish_counted(self, prep):
        total[0] += len(prep["final_reads"]) * len(prep["haplotypes"])
        return finish(self, prep)

    hc_engine.HaplotypeCallerEngine.finish_region = finish_counted
    try:
        yield total
    finally:
        hc_engine.HaplotypeCallerEngine.finish_region = finish


def _flow_bound(tab, ri, hi):
    """The flow kernel's bound on these pairs: the coset cells each pair needs
    (its rows up to clip(rlen - 1, 0, Rp - 1), ceil((hlen + 5) / 4) cells a
    row, as GATK's loop and the kernel walk), and each input byte they need
    read once: of each of their reads its rows of the table and the
    transitions and its flow bases, of each haplotype its keys and flow bases,
    the lengths and the pair list; the output written once. Also the rows of
    the launch's longest pair."""
    from gatk_tpu_torch.ops import flow_pairhmm

    F = flow_pairhmm.FLOW_SIZE
    rows, in_bytes = _flow_rows_and_bytes(tab, ri, hi)
    cells = int((rows * ((tab["hlen"].long()[hi.long()] + 2 * F) // F)).sum().item())
    return dict(_bound(cells, in_bytes, 4 * ri.numel(), FLOW_FLOPS_PER_CELL),
                rows=int(rows.max().item()))


def _flow_rows_and_bytes(tab, ri, hi):
    """The rows each pair needs (to clip(rlen - 1, 0, Rp - 1)), and the input
    bytes the pairs need, each read once: of each of their reads its rows of
    the table and the transitions and its flow bases, of each haplotype its
    keys and flow bases, the lengths and the pair list."""
    from gatk_tpu_torch.ops import flow_pairhmm

    Rp, T1 = tab["tables"].shape[1:]
    rows = flow_pairhmm.final_rows(tab["rlen"], Rp) + 1
    hlen = tab["hlen"].long()
    ri, hi = ri.long(), hi.long()
    reads, haps = torch.unique(ri), torch.unique(hi)
    in_bytes = (int(rows[reads].sum().item()) * (4 * T1 + 4 * 6 + 1) + 4 * reads.numel()
                + int(hlen[haps].sum().item()) * (4 + 1) + 4 * haps.numel() + 8 * ri.numel())
    return rows[ri], in_bytes


def _flow_dense_bound(tab, ri, hi):
    """The dense kernel's bound on these pairs: the cells of the live lattices
    alone (live_cells; the lattices row 0 does not seed are exactly 0, so the
    function needs none of their cells): of each row a pair needs,
    ceil((hlen + 5) / 4) cells of each lattice its row 0 seeds
    (ops/flow_pairhmm.live_residues), at FLOW_FLOPS_PER_CELL operations a cell
    as _flow_bound counts the coset kernel's; the bytes of
    _flow_rows_and_bytes; the output written once. Beside it, as
    dense_count_bound_ms, the count of the earlier dense kernel's rows (before
    the live lattices were found): of each row a pair needs, the 4
    ceil((hlen + 5) / 4) columns of all four lattices,
    FLOW_DENSE_FLOPS_PER_CELL operations a cell, the same bytes. Also the
    cells an every-column walk of the tables' width would take, Wp a row."""
    from gatk_tpu_torch.ops import flow_pairhmm

    F = flow_pairhmm.FLOW_SIZE
    Wp = -(-(tab["hkey"].shape[1] + 1 + F) // F) * F
    rows, in_bytes = _flow_rows_and_bytes(tab, ri, hi)
    G = (tab["hlen"].long()[hi.long()] + 2 * F) // F
    cells = int((rows * F * G).sum().item())
    lattices = flow_pairhmm.live_residues(tab, ri, hi).sum(dim=1)
    live_cells = int((rows * lattices * G).sum().item())
    dense = _bound(cells, in_bytes, 4 * ri.numel(), FLOW_DENSE_FLOPS_PER_CELL)
    return dict(_bound(live_cells, in_bytes, 4 * ri.numel(), FLOW_FLOPS_PER_CELL),
                rows=int(rows.max().item()), Wp=Wp, walked_cells=int(rows.sum().item()) * Wp,
                tasks=int(lattices.sum().item()), live_cells=live_cells, dense_cells=cells,
                dense_count_bound_ms=dense["bound_ms"], dense_count_bound_by=dense["bound_by"])


def _flow_err(got, want, what):
    """max |got - want| over the finite pairs, after checking the shapes, the
    NaNs and the -inf sets."""
    fin = torch.isfinite(want)
    check(got.shape == want.shape and not got.isnan().any(), f"{what}: NaN or a wrong shape")
    check(torch.equal(fin, torch.isfinite(got)) and bool((got[~fin] == -np.inf).all()),
          f"{what}: kernel and plain version disagree on which pairs are -inf")
    err = (got[fin] - want[fin]).abs().max().item() if fin.any() else 0.0
    check(err <= KERNEL_TOL, f"{what}: max |kernel - plain| = {err} > {KERNEL_TOL}")
    return err


def _coset_and_dense(tab, ri, hi, want, what):
    """The dense kernel on pairs that keep the coset rule, where its one live
    lattice a pair is the coset kernel's: within KERNEL_TOL of the coset plain
    version's values `want`, and the two kernels timed in turns on the same
    pairs (coset, dense, dense, coset; each a median of 30 CUDA-event
    timings)."""
    from gatk_tpu_torch.ops import _kernels

    err = _flow_err(_kernels.flow_pairhmm_dense(tab, ri, hi), want, f"{what} (dense kernel)")
    runs = []
    for name in ("coset", "dense", "dense", "coset"):
        fn = ((lambda: _kernels.flow_pairhmm(tab, ri, hi)) if name == "coset"
              else (lambda: _kernels.flow_pairhmm_dense(tab, ri, hi)))
        runs.append((name, median_ms(fn, reps=30, warmup=3)))
    coset = [ms for name, ms in runs if name == "coset"]
    dense = [ms for name, ms in runs if name == "dense"]
    return dict(order=[name for name, _ in runs], coset_ms=coset, dense_ms=dense,
                dense_over_coset=float(np.mean(dense) / np.mean(coset)),
                dense_max_abs_err=err, **_dense_layout(tab, ri))


def _flow_case(args, what, plain_reps=3, with_dense=False):
    """The flow kernel against both plain versions on one launch's inputs: the
    coset lattice's (flow_pairhmm_pairs_plain) and gatk_tpu's dense scan
    (flow_pairhmm_batch_plain on the gathered prior); equal -inf sets, finite
    values within KERNEL_TOL, no read or haplotype flagged. Timed beside both,
    its bound, the rows of its longest pair and the microseconds a row. With
    `with_dense`, also the dense kernel on the same pairs, checked and timed
    in turns with the coset kernel (_coset_and_dense)."""
    from gatk_tpu_torch.ops import _kernels, flow_pairhmm

    tab, ri, hi = args
    got, bad = _kernels.flow_pairhmm(tab, ri, hi)
    want = flow_pairhmm.flow_pairhmm_pairs_plain(tab, ri, hi)
    dense_args = (flow_pairhmm.flow_prior(tab, ri, hi), tab["trans"][ri], tab["rlen"][ri],
                  tab["hlen"][hi])
    dense = flow_pairhmm.flow_pairhmm_batch_plain(*dense_args)
    torch.cuda.synchronize()
    check(bad.tolist() == [0, 0], f"{what}: the kernel flagged flow orders {bad.tolist()}")
    err = _flow_err(got, want, f"{what} (coset plain version)")
    err_dense = _flow_err(got, dense, f"{what} (dense plain version)")
    kernel_ms = median_ms(lambda: _kernels.flow_pairhmm(tab, ri, hi), reps=30, warmup=3)
    plain_ms = median_ms(lambda: flow_pairhmm.flow_pairhmm_pairs_plain(tab, ri, hi),
                         reps=plain_reps, warmup=1)
    dense_ms = median_ms(lambda: flow_pairhmm.flow_pairhmm_batch_plain(*dense_args),
                         reps=plain_reps, warmup=1)
    del dense_args
    bound = _flow_bound(tab, ri, hi)
    NR, Rp, T1 = tab["tables"].shape
    Hp = tab["hkey"].shape[1]
    res = dict(case=what, pairs=ri.numel(), reads=NR, haplotypes=tab["hkey"].shape[0], Rp=Rp,
               Hp=Hp, W=Hp + 1 + flow_pairhmm.FLOW_SIZE, T1=T1,
               finite=int(torch.isfinite(want).sum()), max_abs_err=max(err, err_dense),
               max_abs_err_plain=err, max_abs_err_dense=err_dense, kernel_ms=kernel_ms,
               plain_ms=plain_ms, dense_plain_ms=dense_ms,
               us_per_row=kernel_ms * 1e3 / bound["rows"],
               useful_gcups=bound["useful_cells"] / kernel_ms / 1e6, **bound)
    if with_dense:
        res["dense_kernel"] = _coset_and_dense(tab, ri, hi, want, what)
    return res


def phase_flow(tmp):
    """HaplotypeCaller --likelihood-calculation-engine FlowBasedHMM --device cuda
    over the whole contig of a flow-space sample (the flow kernel), its calls
    gated as the hc phase's; the kernels must have scored exactly the
    genotyped regions' reads x haplotypes; a profiled second run; the largest
    launch held against both plain versions and timed."""
    from gatk_tpu_torch import cli
    from gatk_tpu_torch.calling import hc_engine
    from gatk_tpu_torch.utils import synthetic

    d = os.path.join(tmp, "flow")
    t0 = time.perf_counter()
    sample = synthetic.write_flow_sample(d, **FLOW)
    write_s = time.perf_counter() - t0
    out = os.path.join(d, "flow.vcf")
    argv = ["HaplotypeCaller", "-I", sample["bam"], "-R", sample["fasta"], "-O", out,
            "--likelihood-calculation-engine", "FlowBasedHMM", "--flow-order",
            sample["flow_order"], "--device", "cuda"]
    with keeping_flow_launches() as kept:
        wall, counts, stages = _run_tool(argv, counting_flow_pairs(hc_engine))
    launches = counts["flow_pairhmm"]["launches"]
    check(launches > 0, "the flow kernel was never launched by FlowBasedHMM")
    recs = _records(out)
    missed_snv, indel_called = _germline_gates(sample, recs)
    snvs = [v for v in sample["variants"] if v.is_snv]
    indels = [v for v in sample["variants"] if not v.is_snv]
    argv2 = argv[:6] + [out + ".2"] + argv[7:]
    profiled = _profile(lambda: check(cli.main(argv2) == 0, "profiled FlowBasedHMM run failed"),
                        kernels=dict(kernel=["flow_pairhmm_kernel"]))
    with open(out, "rb") as a, open(out + ".2", "rb") as b:
        check(a.read() == b.read(), "a second FlowBasedHMM run wrote a different VCF")
    largest = _flow_case(kept["args"], "FlowBasedHMM's largest launch", with_dense=True)
    dense_largest = (_flow_case(kept["dense"], "the dense kernel's largest launch's pairs")
                     if kept["dense"] else None)
    res = dict(phase="flow", contig_len=sample["length"], reads=sample["n_reads"],
               write_s=write_s, wall_s=wall, reads_per_s=sample["n_reads"] / wall,
               records=len(recs), snvs_called=len(snvs) - len(missed_snv),
               snvs_planted=len(snvs), indels_called=len(indel_called),
               indels_planted=len(indels),
               hmer_indels_called=sum(v.pos in indel_called for v in sample["hmer_indels"]),
               hmer_indels_planted=len(sample["hmer_indels"]), launches=launches,
               pairs=counts["flow_pairhmm"]["pairs"], counts=counts, stages=stages,
               launch_shapes=kept["shapes"], largest_launch=largest,
               dense_kernel_largest_launch=dense_largest, **profiled)
    emit(res)
    check(not missed_snv, f"flow: planted SNVs not called as 0/1: {missed_snv}")
    check(len(indel_called) >= len(indels) - 1,
          f"flow: only {len(indel_called)} of {len(indels)} planted indels called")
    return res, sample


# --------------------------------------------------------------------------- vqsr

CALLSET = dict(seed=0)  # utils/synthetic.write_callset at its defaults: 20 Mb, 20,000 sites
VQSR_ANNOTATIONS = ("QD", "FS", "MQ", "SOR", "MQRankSum", "ReadPosRankSum")
VQSR_GOOD_PASS = 0.95  # tests/test_vqsr.py:132-133: true SNVs PASS above, artifacts below
VQSR_BAD_PASS = 0.1
NV_TOL = 1e-3  # CNN_1D of the card's run against the --device cpu run's
AUC_MIN = 0.9  # trained CNN_1D scores against the planted labels


@contextlib.contextmanager
def keeping_outputs(module, name, into):
    """Keeps (arguments, output) of every call of module.<name> in into[name]."""
    fn = getattr(module, name)
    into[name] = []

    def keep(*args, **kwargs):
        out = fn(*args, **kwargs)
        into[name].append((args, out))
        return out

    setattr(module, name, keep)
    try:
        yield into[name]
    finally:
        setattr(module, name, fn)


def _auc(scores, labels):
    """The chance that a true site outscores an artifact (ties count half)."""
    from scipy.stats import rankdata

    r = rankdata(scores)
    n1 = int(labels.sum())
    n0 = len(labels) - n1
    return float((r[labels].sum() - n1 * (n1 + 1) / 2) / (n1 * n0))


def _site_records(path):
    """(FILTER, INFO dict) of each record of a sites-only VCF."""
    out = []
    with open(path) as fh:
        for line in fh:
            if not line.startswith("#"):
                f = line.rstrip("\n").split("\t")
                out.append((f[6], dict(kv.split("=", 1) for kv in f[7].split(";") if "=" in kv)))
    return out


def _scores(logits, is_snp):
    return np.where(is_snp, logits[:, 0] - logits[:, 1], logits[:, 2] - logits[:, 3])


def _cnn_timings(dev, callset, nv_args, train_args):
    """CUDA-event times on the card: GATK_CNN_1D's forward over the callset's
    20,000 windows (the .pt run's inputs), and one training step of the CNN
    (forward, backward and Adam on a batch of 64), with the launches a step
    makes, counted by the profiler over 20 steps."""
    from gatk_tpu_torch.calling import cnn_score, nvscore_models

    params = nvscore_models.params_to_torch(nvscore_models.load_torch_1d(callset["weights_1d"]),
                                            dev)
    ref, ann = (torch.as_tensor(np.asarray(a, np.float32)).to(dev) for a in nv_args)

    def forward_all():
        with torch.no_grad():
            for i in range(0, len(ref), nvscore_models.BATCH):
                nvscore_models.forward_1d(params, ref[i:i + nvscore_models.BATCH],
                                          ann[i:i + nvscore_models.BATCH])

    forward_ms = median_ms(forward_all, reps=5, warmup=1)
    p = cnn_score.params_to_torch(cnn_score.init_params(), dev)
    opt = cnn_score.Adam({k: v for k, v in p.items() if k not in cnn_score.FROZEN})
    x, a = (torch.as_tensor(np.asarray(v[:64], np.float32)).to(dev) for v in train_args)
    y = torch.zeros(64, dtype=torch.long, device=dev)

    def step():
        _, grads = cnn_score.loss_and_grads(p, x, a, y)
        opt.step(p, grads)

    step_ms = median_ms(step, reps=50, warmup=5)
    prof = _profile(lambda: [step() for _ in range(20)])
    n = prof["profiled_launches"]
    return dict(gatk_cnn_1d_forward_ms=forward_ms, windows=len(ref), train_step_ms=step_ms,
                launches_per_step=n / 20 if isinstance(n, int) else n,
                train_step_device_busy_ms=prof["device_busy_ms"])


def phase_vqsr(dev, tmp):
    """Variant scoring through the port's CLI on a 20,000-site callset:
    VariantRecalibrator (SNP) and ApplyVQSR at 99 % truth sensitivity, held to
    tests/test_vqsr.py's gates; NVScoreVariants with a GATK_CNN_1D .pt on the
    card and with --device cpu, CNN_1D within NV_TOL; NVScoreVariants
    --truth-vcf (40 epochs of training on the card), its scores separating the
    planted labels (AUC); FilterVariantTranches on them; the CNN's forward and
    training step timed on the card."""
    from gatk_tpu_torch.calling import cnn_score, nvscore_models
    from gatk_tpu_torch.utils import synthetic

    d = os.path.join(tmp, "vqsr")
    t0 = time.perf_counter()
    cs = synthetic.write_callset(d, **CALLSET)
    write_s = time.perf_counter() - t0
    is_snp = np.array([s[3] for s in cs["sites"]])
    true = np.array([s[4] for s in cs["sites"]])
    recal, tranches, applied = (os.path.join(d, f) for f in ("recal.vcf", "t.tranches",
                                                             "applied.vcf"))
    tool_s = {}
    tool_s["VariantRecalibrator"], _, _ = _run_tool(
        ["VariantRecalibrator", "-V", cs["vcf"], "-O", recal, "--tranches-file", tranches,
         *sum((["-an", a] for a in VQSR_ANNOTATIONS), []), "-mode", "SNP",
         "--resource:truth,known=false,training=true,truth=true,prior=15.0", cs["truth"]])
    tool_s["ApplyVQSR"], _, _ = _run_tool(
        ["ApplyVQSR", "-V", cs["vcf"], "--recal-file", recal, "--tranches-file", tranches,
         "-mode", "SNP", "--truth-sensitivity-filter-level", "99.0", "-O", applied])
    status = np.array([f == "PASS" for f, _ in _site_records(applied)])
    good_pass = float(status[is_snp & true].mean())
    bad_pass = float(status[is_snp & ~true].mean())

    kept = {}
    nv = {}
    for device in ("cuda", "cpu"):
        out = os.path.join(d, f"nv_{device}.vcf")
        with keeping_outputs(nvscore_models, "forward_1d", kept):
            tool_s[f"NVScoreVariants .pt {device}"], c, _ = _run_tool(
                ["NVScoreVariants", "-V", cs["vcf"], "-R", cs["fasta"], "-O", out,
                 "--model-weights", cs["weights_1d"], "--device", device])
        nv[device] = (_scores(kept["forward_1d"][0][1], is_snp),
                      [info["CNN_1D"] for _, info in _site_records(out)])
    nv_args = kept["forward_1d"][0][0][1:3]
    nv_err = float(np.abs(nv["cuda"][0] - nv["cpu"][0]).max())
    printed_differ = sum(a != b for a, b in zip(nv["cuda"][1], nv["cpu"][1]))

    trained = os.path.join(d, "trained.vcf")
    timed = {}
    with contextlib.ExitStack() as stack:
        stack.enter_context(timing(cnn_score, "train", dev, timed))
        scored = stack.enter_context(keeping_outputs(cnn_score, "score", kept))
        tool_s["NVScoreVariants --truth-vcf"], _, _ = _run_tool(
            ["NVScoreVariants", "-V", cs["vcf"], "-R", cs["fasta"], "-O", trained,
             "--truth-vcf", cs["truth"], "--device", "cuda"])
    train_args = timed["train"].pop("args")
    epochs = 40
    steps = epochs * -(-len(cs["sites"]) // 64)
    auc = _auc(scored[0][1], true)
    filtered = os.path.join(d, "filtered.vcf")
    tool_s["FilterVariantTranches"], _, _ = _run_tool(
        ["FilterVariantTranches", "-V", trained, "-O", filtered, "--resource", cs["truth"]])
    n_filtered = sum(f != "PASS" for f, _ in _site_records(filtered))
    timings = _cnn_timings(dev, cs, nv_args, train_args[1:3])
    res = dict(phase="vqsr", sites=len(cs["sites"]), snvs=int(is_snp.sum()),
               contig_len=cs["length"], write_s=write_s, tool_s=tool_s,
               wall_s=sum(tool_s.values()), vqsr_good_pass=good_pass, vqsr_bad_pass=bad_pass,
               nv_max_abs_diff_cuda_cpu=nv_err, nv_printed_differ=printed_differ,
               train_s=timed["train"]["seconds"], train_steps=steps,
               train_ms_per_step=timed["train"]["seconds"] * 1e3 / steps,
               trained_auc=auc, filtered=n_filtered, **timings)
    emit(res)
    check(good_pass > VQSR_GOOD_PASS and bad_pass < VQSR_BAD_PASS,
          f"ApplyVQSR: true SNVs PASS {good_pass}, artifacts PASS {bad_pass}")
    check(nv_err <= NV_TOL, f"NVScoreVariants: CNN_1D on the card {nv_err} from the host's")
    check(auc >= AUC_MIN, f"NVScoreVariants --truth-vcf: AUC {auc} < {AUC_MIN}")
    check(0 < n_filtered < len(cs["sites"]), f"FilterVariantTranches filtered {n_filtered}")
    return res, cs


# --------------------------------------------------------------------------- postcall

POSTCALL_HAPLOTYPES = 4  # planted variants whose reference and planted windows are the haplotypes
OFF_RULE_ORDER = "TGCATGAC"  # a flow order that does not repeat with period 4
OFF_RULE_WINDOW = "chrM:1-2000"
# GATK's documented hard filters for SNVs (expression, name, INFO key, fails when)
SNP_HARD_FILTERS = (("QD < 2.0", "QD2", "QD", lambda x: x < 2.0),
                    ("FS > 60.0", "FS60", "FS", lambda x: x > 60.0),
                    ("MQ < 40.0", "MQ40", "MQ", lambda x: x < 40.0),
                    ("SOR > 3.0", "SOR3", "SOR", lambda x: x > 3.0),
                    ("MQRankSum < -12.5", "MQRankSum-12.5", "MQRankSum", lambda x: x < -12.5),
                    ("ReadPosRankSum < -8.0", "ReadPosRankSum-8", "ReadPosRankSum",
                     lambda x: x < -8.0))
GENCODE_GENES = 1000  # synthetic.write_gencode_datasource's genes over the callset's 20 Mb
FLANK_5P = 5000  # funcotator/gencode.py:199: bases before a gene whose sites are its 5' flank
SPLICE_SITE_WINDOW = 2  # funcotator/gencode.py:197
_BASES = "TCAG"
_AMINO = "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"
STANDARD_CODE = {a + b + c: _AMINO[16 * i + 4 * j + k] for i, a in enumerate(_BASES)
                 for j, b in enumerate(_BASES) for k, c in enumerate(_BASES)}
_COMPLEMENT = str.maketrans("ACGT", "TGCA")


def _tsv_matrix(path):
    """(header, read names, [printed cells of each read]) of the tool's TSV."""
    with open(path) as fh:
        rows = [ln.rstrip("\n").split("\t") for ln in fh]
    return rows[0], [r[0] for r in rows[1:]], [r[1:] for r in rows[1:]]


def _printed(got, n_haps):
    """The kernel's (B,) values as the tool prints them, read-major."""
    vals = got.cpu().numpy().astype(np.float64).reshape(-1, n_haps)
    return [[f"{x:.4f}" for x in row] for row in vals]


def _postcall_haplotypes(tmp, sample):
    """The directory of the postcall flow runs and the haplotypes FASTA of the
    reference and planted windows of the sample's first POSTCALL_HAPLOTYPES
    variants: (dir, path, names)."""
    from gatk_tpu_torch.utils import synthetic

    d = os.path.join(tmp, "postcall_flow")
    os.makedirs(d, exist_ok=True)
    haps = os.path.join(d, "haplotypes.fa")
    names = synthetic.write_flow_haplotypes(haps, sample["fasta"], sample["contig"],
                                            sample["variants"], n_variants=POSTCALL_HAPLOTYPES,
                                            seed=0)
    return d, haps, names


def _postcall_flow(tmp, sample):
    """FlowPairHMMAlignReadsToHaplotypes --device cuda on every read of the flow
    sample against the reference and planted windows of its first
    POSTCALL_HAPLOTYPES variants (one launch of the coset kernel); then with
    the flow order OFF_RULE_ORDER on the reads of OFF_RULE_WINDOW (the dense
    kernel); then on those reads against the sample's whole contig in its own
    order (past the coset kernel's width: the dense kernel alone). Each launch
    held against its plain versions on the card, the TSV against the kernel's
    values as the tool prints them, and timed."""
    from gatk_tpu_torch.ops import _kernels, flow_pairhmm

    d, haps, names = _postcall_haplotypes(tmp, sample)
    out = {}
    tsv = os.path.join(d, "matrix.tsv")
    kept = {}
    with keeping_outputs(_kernels, "flow_pairhmm", kept):
        wall, counts, _ = _run_tool(["FlowPairHMMAlignReadsToHaplotypes", "-I", sample["bam"],
                                     "-H", haps, "-O", tsv, "--device", "cuda"])
    check(counts["flow_pairhmm"]["launches"] == 1 and counts["flow_pairhmm_dense"]["launches"] == 0,
          f"FlowPairHMMAlignReadsToHaplotypes: launches {counts}, not one of the coset kernel")
    check(len(kept["flow_pairhmm"]) == 1, "the coset kernel's launch was not kept")
    (tab, ri, hi), _ = kept["flow_pairhmm"][0]
    header, reads, cells = _tsv_matrix(tsv)
    check(header[1:] == names and len(reads) == sample["n_reads"],
          f"FlowPairHMMAlignReadsToHaplotypes wrote {len(reads)} reads x {header[1:]}")
    check(ri.numel() == len(reads) * len(names), f"the launch held {ri.numel()} pairs")
    got, bad = _kernels.flow_pairhmm(tab, ri, hi)
    want = flow_pairhmm.flow_pairhmm_pairs_plain(tab, ri, hi)
    torch.cuda.synchronize()
    check(bad.tolist() == [0, 0], f"the coset kernel flagged flow orders {bad.tolist()}")
    err = _flow_err(got, want, "FlowPairHMMAlignReadsToHaplotypes' launch")
    check(cells == _printed(got, len(names)),
          "FlowPairHMMAlignReadsToHaplotypes' TSV is not the kernel's matrix at 4 decimals")
    kernel_ms = median_ms(lambda: _kernels.flow_pairhmm(tab, ri, hi), reps=30, warmup=3)
    plain_ms = median_ms(lambda: flow_pairhmm.flow_pairhmm_pairs_plain(tab, ri, hi), reps=1,
                         warmup=0)
    bound = _flow_bound(tab, ri, hi)
    NR, Rp, T1 = tab["tables"].shape
    out["coset"] = dict(tool_s=wall, counts=counts, pairs=ri.numel(), reads=NR,
                        haplotypes=len(names), Rp=Rp, Hp=tab["hkey"].shape[1], T1=T1,
                        finite=int(torch.isfinite(want).sum()), max_abs_err=err,
                        kernel_ms=kernel_ms, plain_ms=plain_ms,
                        us_per_row=kernel_ms * 1e3 / bound["rows"], **bound,
                        dense_kernel=_coset_and_dense(tab, ri, hi, want,
                                                      "FlowPairHMMAlignReadsToHaplotypes' launch"))
    del tab, ri, hi, got, want

    window, print_reads_s = _off_rule_window(d, sample)
    out["dense"] = dict(_postcall_dense(d, window, haps, names), print_reads_s=print_reads_s)
    out["wide"] = _postcall_wide(d, window, sample)
    return out


def _off_rule_window(d, sample):
    """The sample's reads of OFF_RULE_WINDOW (PrintReads -L): (BAM path, s)."""
    window = os.path.join(d, "window.bam")
    seconds, _, _ = _run_tool(["PrintReads", "-I", sample["bam"], "-O", window,
                               "-L", OFF_RULE_WINDOW])
    return window, seconds


def _dense_layout(tab, ri):
    """The dense kernel's state route for these tables (flow_pairhmm_dense_layout)
    and, on the device route, the resident warps of its grid."""
    from gatk_tpu_torch.ops import _kernels

    Hp, T1 = tab["hkey"].shape[1], tab["tables"].shape[2]
    route, warps, smem = _kernels.flow_pairhmm_dense_layout(Hp, T1)
    slots = _kernels.flow_pairhmm_dense_slots(ri.device, ri.numel()) if route == "device" else None
    return dict(route=route, warps_a_block=warps, smem_bytes=smem, slots=slots)


def _postcall_dense(d, window, haps, names, old_dense=None):
    """FlowPairHMMAlignReadsToHaplotypes --device cuda --flow-order OFF_RULE_ORDER
    on the reads of `window` against the haplotypes: one launch of the dense
    kernel over every pair (beside one of the coset kernel, which flags the
    order), within KERNEL_TOL of gatk_tpu's dense scan on the card
    (flow_pairhmm_dense_plain), the TSV equal to the kernel's values at 4
    decimals; timed beside its plain version and its bounds. With
    `old_dense`, the source of an earlier dense kernel, also the two kernels
    in turns on the launch's pairs (_dense_in_turns)."""
    from gatk_tpu_torch.ops import _kernels, flow_pairhmm

    tsv = os.path.join(d, "matrix_off_rule.tsv")
    kept = {}
    with keeping_outputs(_kernels, "flow_pairhmm_dense", kept):
        wall, counts, _ = _run_tool(["FlowPairHMMAlignReadsToHaplotypes", "-I", window,
                                     "-H", haps, "-O", tsv, "--device", "cuda",
                                     "--flow-order", OFF_RULE_ORDER])
    dense = counts["flow_pairhmm_dense"]
    check(dense["launches"] == 1 and counts["flow_pairhmm"]["launches"] == 1,
          f"--flow-order {OFF_RULE_ORDER}: launches {counts}, not one of each flow kernel")
    (tab, ri, hi), _ = kept["flow_pairhmm_dense"][0]
    header, reads, cells = _tsv_matrix(tsv)
    check(dense["pairs"] == ri.numel() == len(reads) * len(names) > 0,
          f"--flow-order {OFF_RULE_ORDER}: the dense kernel scored {dense['pairs']} of "
          f"{len(reads)} reads x {len(names)} haplotypes")
    got = _kernels.flow_pairhmm_dense(tab, ri, hi)
    want = flow_pairhmm.flow_pairhmm_dense_plain(tab, ri, hi)
    torch.cuda.synchronize()
    err = _flow_err(got, want, f"the dense kernel (--flow-order {OFF_RULE_ORDER})")
    check(cells == _printed(got, len(names)),
          f"--flow-order {OFF_RULE_ORDER}: the TSV is not the dense kernel's matrix at 4 decimals")
    kernel_ms = median_ms(lambda: _kernels.flow_pairhmm_dense(tab, ri, hi), reps=30, warmup=3)
    plain_ms = median_ms(lambda: flow_pairhmm.flow_pairhmm_dense_plain(tab, ri, hi), reps=1,
                         warmup=0)
    bound = _flow_dense_bound(tab, ri, hi)
    NR, Rp, T1 = tab["tables"].shape
    res = dict(tool_s=wall, counts=counts, pairs=ri.numel(), reads=NR, haplotypes=len(names),
               Rp=Rp, Hp=tab["hkey"].shape[1], T1=T1, finite=int(torch.isfinite(want).sum()),
               max_abs_err=err, kernel_ms=kernel_ms, plain_ms=plain_ms,
               us_per_row=kernel_ms * 1e3 / bound["rows"], **_dense_layout(tab, ri), **bound)
    if old_dense:
        res["turns"] = _dense_in_turns(tab, ri, hi, old_dense)
    return res


def _postcall_wide(d, window, sample, l2_turns=False):
    """FlowPairHMMAlignReadsToHaplotypes --device cuda on the reads of `window`
    against the sample's whole contig as one haplotype (its FASTA: 16,569 bp,
    25,036 flows in TGCA), past the width whose coset state fits shared
    memory: the entry makes one launch of the dense kernel over every pair and
    none of the coset kernel; the kernel within KERNEL_TOL of both plain
    versions on the card (the coset lattice's and gatk_tpu's dense scan), the
    TSV equal to its values at 4 decimals; timed beside its bounds, with its
    state route. With `l2_turns`, also timed in turns with a grid whose
    state stays in the L2 cache (_l2_resident_turns)."""
    from gatk_tpu_torch.ops import _kernels, flow_pairhmm

    tsv = os.path.join(d, "matrix_wide.tsv")
    kept = {}
    with keeping_outputs(_kernels, "flow_pairhmm_dense", kept):
        wall, counts, _ = _run_tool(["FlowPairHMMAlignReadsToHaplotypes", "-I", window,
                                     "-H", sample["fasta"], "-O", tsv, "--device", "cuda"])
    dense = counts["flow_pairhmm_dense"]
    check(dense["launches"] == 1 and counts["flow_pairhmm"]["launches"] == 0,
          f"the whole contig as a haplotype: launches {counts}, not one of the dense kernel alone")
    (tab, ri, hi), _ = kept["flow_pairhmm_dense"][0]
    header, reads, cells = _tsv_matrix(tsv)
    check(header[1:] == [sample["contig"]] and dense["pairs"] == ri.numel() == len(reads) > 0,
          f"the whole contig as a haplotype: the dense kernel scored {dense['pairs']} of "
          f"{len(reads)} reads x {header[1:]}")
    NR, Rp, T1 = tab["tables"].shape
    Hp = tab["hkey"].shape[1]
    check(_kernels.flow_pairhmm_smem(Hp, T1) > _kernels.FLOW_MAX_SMEM,
          f"Hp = {Hp} fits the coset kernel's shared memory")
    got = _kernels.flow_pairhmm_dense(tab, ri, hi)
    err = _flow_err(got, flow_pairhmm.flow_pairhmm_pairs_plain(tab, ri, hi),
                    "the wide dense launch (coset plain version)")
    t0 = time.perf_counter()
    want = flow_pairhmm.flow_pairhmm_dense_plain(tab, ri, hi)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err_dense = _flow_err(got, want, "the wide dense launch (dense plain version)")
    check(cells == _printed(got, 1),
          "the whole contig as a haplotype: the TSV is not the dense kernel's values at 4 decimals")
    kernel_ms = median_ms(lambda: _kernels.flow_pairhmm_dense(tab, ri, hi), reps=5, warmup=1)
    bound = _flow_dense_bound(tab, ri, hi)
    res = dict(tool_s=wall, counts=counts, pairs=ri.numel(), reads=NR, Rp=Rp, Hp=Hp, T1=T1,
               finite=int(torch.isfinite(want).sum()), max_abs_err=max(err, err_dense),
               max_abs_err_plain=err, max_abs_err_dense=err_dense, kernel_ms=kernel_ms,
               plain_ms=plain_ms, us_per_row=kernel_ms * 1e3 / bound["rows"],
               **_dense_layout(tab, ri), **bound)
    if l2_turns:
        res["l2_turns"] = _l2_resident_turns(tab, ri, hi, got)
    return res


def _l2_resident_turns(tab, ri, hi, want):
    """The dense kernel's device route on its grid (flow_pairhmm_dense_slots)
    and on a grid whose warps' state would stay in 3/4 of the L2 cache, in
    turns (default, L2, L2, default; each a median of 5 CUDA-event timings);
    the L2 grid's values equal to `want`, the default grid's."""
    from gatk_tpu_torch.ops import _kernels

    Hp = tab["hkey"].shape[1]
    l2_slots = max(1, torch.cuda.get_device_properties(ri.device).L2_cache_size * 3 // 4
                   // _kernels.library("flow_pairhmm_dense").flow_pairhmm_dense_state(Hp))
    slots = _kernels.flow_pairhmm_dense_slots

    def l2(dev, B):
        return l2_slots

    runs = []
    try:
        for name in ("default", "l2", "l2", "default"):
            _kernels.flow_pairhmm_dense_slots = slots if name == "default" else l2
            runs.append((name, median_ms(lambda: _kernels.flow_pairhmm_dense(tab, ri, hi),
                                         reps=5, warmup=1)))
        _kernels.flow_pairhmm_dense_slots = l2
        same = torch.equal(_kernels.flow_pairhmm_dense(tab, ri, hi), want)
    finally:
        _kernels.flow_pairhmm_dense_slots = slots
    check(same, "the dense kernel's values on the L2-resident grid differ from its own grid's")
    return dict(order=[name for name, _ in runs], slots=slots(ri.device, ri.numel()),
                l2_slots=l2_slots, default_ms=[ms for name, ms in runs if name == "default"],
                l2_ms=[ms for name, ms in runs if name == "l2"])


def _old_dense_library(source):
    """An earlier dense flow kernel (a block a pair over every column) built from
    `source` with the port's nvcc flags into build/old_dense/ and bound by
    ctypes to its C interface: flow_pairhmm_dense(tables, rfo, trans, rlen,
    hkey, hfo, hlen, ri, hi, out, scratch, B, NR, Rp, T1, NH, Hp, grid,
    stream), flow_pairhmm_dense_smem(Hp), flow_pairhmm_dense_state(Hp).
    Returns (library, its ptxas lines)."""
    from gatk_tpu_torch.ops import _kernels

    out_dir = os.path.join(ROOT, "build", "old_dense")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, "libold_dense.so")
    proc = subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-o", so, source],
                          capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"nvcc failed for {source}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(so)
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.flow_pairhmm_dense.restype = i
    lib.flow_pairhmm_dense.argtypes = [vp] * 11 + [i] * 7 + [vp]
    for name in ("flow_pairhmm_dense_smem", "flow_pairhmm_dense_state"):
        getattr(lib, name).restype = ll
        getattr(lib, name).argtypes = [i]
    log = proc.stdout + proc.stderr
    return lib, [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]


def _old_dense(lib, tab, ri, hi):
    """One launch of the earlier dense kernel on the current stream."""
    from gatk_tpu_torch.ops import _kernels

    B = ri.numel()
    NR, Rp, T1 = tab["tables"].shape
    NH, Hp = tab["hkey"].shape
    dev = ri.device
    if lib.flow_pairhmm_dense_smem(Hp) <= _kernels.FLOW_MAX_SMEM:
        grid, scratch = B, None
    else:
        grid = min(B, 8 * torch.cuda.get_device_properties(dev).multi_processor_count)
        scratch = torch.empty(grid * lib.flow_pairhmm_dense_state(Hp), dtype=torch.float32,
                              device=dev)
    out = torch.empty(B, dtype=torch.float32, device=dev)
    ptrs = [tab[name].data_ptr() for name in _kernels.FLOW_TABLES] + [ri.data_ptr(),
                                                                       hi.data_ptr(),
                                                                       out.data_ptr()]
    rc = lib.flow_pairhmm_dense(*ptrs, None if scratch is None else scratch.data_ptr(), B, NR,
                                Rp, T1, NH, Hp, grid, torch.cuda.current_stream(dev).cuda_stream)
    check(rc == 0, f"the earlier dense kernel's launch failed: {rc}")
    return out


def _dense_in_turns(tab, ri, hi, source):
    """The dense kernel and the earlier one of `source` on the same pairs, timed
    in turns in this one process (earlier, current, current, earlier; each a
    median of 30 CUDA-event timings), with the largest difference of their
    finite values and whether their -inf sets agree."""
    from gatk_tpu_torch.ops import _kernels

    lib, ptxas = _old_dense_library(source)
    old = _old_dense(lib, tab, ri, hi)
    new = _kernels.flow_pairhmm_dense(tab, ri, hi)
    torch.cuda.synchronize()
    fin = torch.isfinite(old)
    runs = []
    for name in ("earlier", "current", "current", "earlier"):
        fn = ((lambda: _old_dense(lib, tab, ri, hi)) if name == "earlier"
              else (lambda: _kernels.flow_pairhmm_dense(tab, ri, hi)))
        runs.append((name, median_ms(fn, reps=30, warmup=3)))
    earlier = [ms for name, ms in runs if name == "earlier"]
    current = [ms for name, ms in runs if name == "current"]
    return dict(order=[name for name, _ in runs], ms=[ms for _, ms in runs],
                earlier_ms=earlier, current_ms=current,
                speedup=float(np.mean(earlier) / np.mean(current)),
                same_inf_set=bool(torch.equal(fin, torch.isfinite(new))),
                max_abs_diff=(new[fin] - old[fin]).abs().max().item() if fin.any() else 0.0,
                earlier_ptxas=ptxas)


def _vcf_sites(path):
    """(pos 1-based, REF, ALT, FILTER, INFO dict, the line) of each record."""
    out = []
    with open(path) as fh:
        for line in fh:
            if not line.startswith("#"):
                f = line.rstrip("\n").split("\t")
                info = dict(kv.split("=", 1) for kv in f[7].split(";") if "=" in kv)
                out.append((int(f[1]), f[3], f[4], f[6], info, line))
    return out


def _expected_filters(info):
    return {name for _, name, key, fails in SNP_HARD_FILTERS if fails(float(info[key]))}


def _eval_table(path, table):
    """The 'all' row of a GATKReport table of VariantEval's output: {column: value}."""
    with open(path) as fh:
        lines = fh.read().splitlines()
    start = next(i for i, ln in enumerate(lines) if ln.startswith(f"#:GATKTable:{table}:"))
    cols = lines[start + 1].split()
    for ln in lines[start + 2:]:
        vals = ln.split()
        if not vals:
            break
        row = dict(zip(cols, vals))
        if row.get("Novelty") == "all":
            return row
    fail(f"VariantEval: no 'all' row in {table}")


def _codon_class(ref_seq, gene, pos1, alt):
    """The phase's own class of an SNV at pos1 inside gene's CDS: SILENT,
    MISSENSE or NONSENSE by the standard code on its codon, or None where
    Funcotator's rules set it otherwise (the first or last codon, within
    SPLICE_SITE_WINDOW of an exon end)."""
    if any(abs(pos1 - b) < SPLICE_SITE_WINDOW for e in gene["exons"] for b in e):
        return None
    cds = "".join(ref_seq[a - 1:b] for a, b in gene["cds"])
    offsets = [pos1 - a + sum(b0 - a0 + 1 for a0, b0 in gene["cds"][:k])
               for k, (a, b) in enumerate(gene["cds"]) if a <= pos1 <= b]
    if not offsets:
        return None
    i = offsets[0]
    mutated = cds[:i] + alt + cds[i + 1:]
    if gene["strand"] == "-":
        cds, mutated = (x.translate(_COMPLEMENT)[::-1] for x in (cds, mutated))
        i = len(cds) - 1 - i
    c = i // 3
    if c == 0 or c == len(cds) // 3 - 1:
        return None
    ref_aa, alt_aa = STANDARD_CODE[cds[3 * c:3 * c + 3]], STANDARD_CODE[mutated[3 * c:3 * c + 3]]
    check(ref_aa != "*", f"{gene['gene']}: a stop codon inside the CDS at {pos1}")
    return "SILENT" if ref_aa == alt_aa else "NONSENSE" if alt_aa == "*" else "MISSENSE"


def _postcall_chain(tmp, cs):
    """SelectVariants, VariantFiltration (GATK's SNP hard filters), VariantEval
    and Funcotator (VCF and MAF, then FilterFuncotations) on the vqsr phase's
    callset, each held to the phase's own reading of the records."""
    from gatk_tpu_torch.io.fasta import FastaReference
    from gatk_tpu_torch.utils import synthetic

    d = os.path.join(tmp, "postcall")
    os.makedirs(d, exist_ok=True)
    sites = _vcf_sites(cs["vcf"])
    tool_s, records = {}, {}

    snp_vcf = os.path.join(d, "snp.vcf")
    tool_s["SelectVariants SNP"], _, _ = _run_tool(
        ["SelectVariants", "-V", cs["vcf"], "-O", snp_vcf, "--select-type-to-include", "SNP"])
    got = [s[:3] for s in _vcf_sites(snp_vcf)]
    want = [s[:3] for s in sites if len(s[1]) == len(s[2]) == 1]
    records["SelectVariants SNP"] = len(got)
    check(got == want, f"SelectVariants SNP wrote {len(got)} records, the callset has "
                       f"{len(want)} SNVs")

    qd_vcf = os.path.join(d, "qd.vcf")
    tool_s["SelectVariants QD > 2.0"], _, _ = _run_tool(
        ["SelectVariants", "-V", cs["vcf"], "-O", qd_vcf, "-select", "QD > 2.0"])
    got = [s[:3] for s in _vcf_sites(qd_vcf)]
    want = [s[:3] for s in sites if float(s[4]["QD"]) > 2.0]
    records["SelectVariants QD > 2.0"] = len(got)
    check(got == want, f"SelectVariants QD > 2.0 wrote {len(got)} records, {len(want)} have it")

    filtered = os.path.join(d, "filtered.vcf")
    tool_s["VariantFiltration"], _, _ = _run_tool(
        ["VariantFiltration", "-V", cs["vcf"], "-O", filtered]
        + sum((["--filter-expression", e, "--filter-name", n] for e, n, _, _ in SNP_HARD_FILTERS),
              []))
    fsites = _vcf_sites(filtered)
    check([s[:3] for s in fsites] == [s[:3] for s in sites],
          "VariantFiltration did not write the callset's records")
    wrong = [s[0] for s in fsites
             if set(s[3].split(";")) - {"PASS"} != _expected_filters(s[4])]
    records["VariantFiltration"] = len(fsites)
    records["filtered"] = sum(s[3] != "PASS" for s in fsites)
    check(not wrong, f"VariantFiltration: FILTER wrong at {len(wrong)} records, e.g. {wrong[:5]}")
    check(0 < records["filtered"] < len(fsites),
          f"VariantFiltration filtered {records['filtered']} of {len(fsites)}")

    grp = os.path.join(d, "eval.grp")
    tool_s["VariantEval"], _, _ = _run_tool(["VariantEval", "--eval", filtered, "--comp",
                                             cs["truth"], "-O", grp])
    passing = [s for s in fsites if s[3] == "PASS"]
    truth = {s[:3] for s in _vcf_sites(cs["truth"])}
    counts = _eval_table(grp, "CountVariants")
    overlap = _eval_table(grp, "CompOverlap")
    want_counts = dict(nSNPs=sum(len(s[1]) == len(s[2]) == 1 for s in passing),
                       nInsertions=sum(len(s[2]) > len(s[1]) for s in passing),
                       nDeletions=sum(len(s[2]) < len(s[1]) for s in passing),
                       nVariantsAtComp=sum(s[:3] in truth for s in passing))
    got_counts = {k: int((counts if k != "nVariantsAtComp" else overlap)[k]) for k in want_counts}
    records["VariantEval"] = got_counts
    check(got_counts == want_counts, f"VariantEval: {got_counts}, the phase counts {want_counts}")

    t0 = time.perf_counter()
    ds = synthetic.write_gencode_datasource(os.path.join(d, "datasources"), cs["fasta"],
                                            cs["contig"], seed=0, n_genes=GENCODE_GENES)
    datasource_s = time.perf_counter() - t0
    func_vcf, func_maf = os.path.join(d, "funcotated.vcf"), os.path.join(d, "funcotated.maf")
    common = ["-V", filtered, "-R", cs["fasta"], "--data-sources-path", ds["dir"],
              "--ref-version", ds["build"]]
    tool_s["Funcotator VCF"], _, _ = _run_tool(["Funcotator", *common, "-O", func_vcf])
    tool_s["Funcotator MAF"], _, _ = _run_tool(["Funcotator", *common, "-O", func_maf,
                                                "--output-file-format", "MAF"])
    with open(func_maf) as fh:
        maf_rows = sum(1 for ln in fh if not ln.startswith(("#", "Hugo_Symbol")))
    ref_seq = bytes(FastaReference(cs["fasta"]).fetch_bytes(cs["contig"])).decode().upper()
    genes = ds["genes"]
    classes, wrong, coding = {}, [], 0
    for pos1, ref, alt, _, info, _ in _vcf_sites(func_vcf):
        got = info["FUNCOTATION"].strip("[]").split("|")[5]
        classes[got] = classes.get(got, 0) + 1
        end1 = pos1 + len(ref) - 1
        inside = [g for g in genes if g["start"] <= end1 and g["end"] >= pos1]
        if not inside:
            near = any(g["start"] <= end1 + FLANK_5P and g["end"] >= pos1 - 1 for g in genes)
            want = "FIVE_PRIME_FLANK" if near else "IGR"
        elif len(ref) == len(alt) == 1 and len(inside) == 1 and any(
                a <= pos1 <= b for a, b in inside[0]["cds"]):
            want = _codon_class(ref_seq, inside[0], pos1, alt)
            coding += want is not None
        else:
            continue
        if want is not None and got != want:
            wrong.append((pos1, ref, alt, got, want))
    records["Funcotator"] = dict(vcf=sum(classes.values()), maf=maf_rows, classes=classes,
                                 coding_snvs_checked=coding)
    check(not wrong, f"Funcotator: {len(wrong)} sites classified otherwise than the phase's "
                     f"reading, e.g. {wrong[:5]}")
    check(maf_rows == len(fsites) and coding > 0 and classes.get("IGR", 0) > 0,
          f"Funcotator: {maf_rows} MAF rows, {coding} coding SNVs checked, classes {classes}")
    ff = os.path.join(d, "filter_funcotations.vcf")
    tool_s["FilterFuncotations"], _, _ = _run_tool(["FilterFuncotations", "-V", func_vcf,
                                                    "-O", ff])
    ff_sites = _vcf_sites(ff)
    records["FilterFuncotations"] = dict(records=len(ff_sites), not_clinsig=sum(
        "NOT_CLINSIG" in s[3] for s in ff_sites))
    check(len(ff_sites) == len(fsites), f"FilterFuncotations wrote {len(ff_sites)} records")
    return dict(tool_s=tool_s, records=records, datasource_s=datasource_s,
                genes=len(genes), sites=len(sites))


def phase_postcall(tmp, flow_sample, cs):
    """FlowPairHMMAlignReadsToHaplotypes on the card (both flow kernels), then
    the post-calling chain on the vqsr phase's callset."""
    t0 = time.perf_counter()
    flow = _postcall_flow(tmp, flow_sample)
    chain = _postcall_chain(tmp, cs)
    res = dict(phase="postcall", flow=flow, **chain, seconds=time.perf_counter() - t0)
    emit(res)
    return res


# --------------------------------------------------------------------------- ramped / recaller


# gatk_tpu's registry (gatk_tpu/cli.py) holds 312 tool names, 36 of them
# Spark-named aliases; the port registers each of them
N_TOOLS, N_ALIASES = 312, 36


def _host_tool(argv):
    """One run of a host tool through the port's CLI: (wall s on the host
    clock, what it printed); fails the script when the tool fails."""
    import io

    from gatk_tpu_torch import cli

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    wall = time.perf_counter() - t0
    check(rc == 0, f"{' '.join(argv)} exited {rc}: {out.getvalue()[-500:]}")
    return wall, out.getvalue()


def _fastq_records(path):
    with open(path) as fh:
        lines = fh.read().splitlines()
    return [(lines[i][1:], lines[i + 1]) for i in range(0, len(lines), 4)]


def _metrics_row(path, first_column):
    """The first row of a metrics file's table, by column name."""
    with open(path) as fh:
        lines = fh.read().splitlines()
    i = next(k for k, line in enumerate(lines) if line.startswith(first_column + "\t"))
    return dict(zip(lines[i].split("\t"), lines[i + 1].split("\t")))


def phase_tools(tmp, sample):
    """Host tools copied from gatk_tpu, on the hc sample; see the module
    docstring. No kernel runs here: every wall is on the host clock."""
    from gatk_tpu_torch import cli
    from gatk_tpu_torch.io import bam

    check(len(cli.TOOL_REGISTRY) == N_TOOLS and len(cli.TOOL_ALIASES) == N_ALIASES,
          f"the registry holds {len(cli.TOOL_REGISTRY)} names and {len(cli.TOOL_ALIASES)} "
          f"aliases, gatk_tpu's {N_TOOLS} and {N_ALIASES}")
    check(all(t in cli.TOOL_REGISTRY for t in cli.TOOL_ALIASES.values()),
          "an alias names a tool that is not registered")
    d = os.path.join(tmp, "tools")
    os.makedirs(d)
    walls = {}
    reads = list(bam.BamReader(sample["bam"]))

    walls["ValidateSamFile"], text = _host_tool(["ValidateSamFile", "-I", sample["bam"]])
    check(text.strip() == "No errors found", f"ValidateSamFile: {text.strip()[-300:]}")

    fq = os.path.join(d, "reads.fastq")
    walls["SamToFastq"], _ = _host_tool(["SamToFastq", "-I", sample["bam"], "-F", fq])
    unaligned = os.path.join(d, "unaligned.bam")
    walls["FastqToSam"], _ = _host_tool(["FastqToSam", "-F1", fq, "-O", unaligned,
                                         "-SM", "SYN1"])
    comp = np.arange(256, dtype=np.uint8)
    for a, b in zip(b"ACGTN", b"TGCAN"):
        comp[a] = b
    want = [(r.name, (comp[r.bases[::-1]] if r.is_reverse else r.bases).tobytes().decode())
            for r in reads]
    check(_fastq_records(fq) == want, "SamToFastq: the FASTQ is not the reads in sequencing "
                                      "orientation")
    back = [(r.name, r.bases.tobytes().decode()) for r in bam.BamReader(unaligned)]
    check(sorted(back) == sorted(want), "FastqToSam did not give back the reads' names and bases")

    dict_path = os.path.join(d, "ref.dict")
    walls["CreateSequenceDictionary"], _ = _host_tool(
        ["CreateSequenceDictionary", "-R", sample["fasta"], "-O", dict_path])
    with open(dict_path) as fh:
        sq = [line.split("\t") for line in fh if line.startswith("@SQ")]
    check([(f[1], f[2]) for f in sq] == [("SN:chrM", f"LN:{sample['length']}")],
          f"CreateSequenceDictionary: {sq}")

    wgs = os.path.join(d, "wgs.txt")
    walls["CollectWgsMetrics"], _ = _host_tool(["CollectWgsMetrics", "-I", sample["bam"],
                                                "-R", sample["fasta"], "-O", wgs])
    raw_depth = sum(len(r.bases) for r in reads) / sample["length"]
    mean_cov = float(_metrics_row(wgs, "GENOME_TERRITORY")["MEAN_COVERAGE"])
    check(0 < mean_cov <= raw_depth, f"CollectWgsMetrics: MEAN_COVERAGE {mean_cov}, raw depth "
                                     f"{raw_depth}")

    shuffled = os.path.join(d, "shuffled.bam")
    reader = bam.BamReader(sample["bam"])
    order = np.random.default_rng(0).permutation(len(reads))
    w = bam.BamWriter(shuffled, reader.header)
    for k in order:
        w.write(reads[int(k)])
    w.close()
    sorted_bam = os.path.join(d, "sorted.bam")
    walls["SortSam"], _ = _host_tool(["SortSam", "-I", shuffled, "-O", sorted_bam])
    got = [(r.pos, r.name) for r in bam.BamReader(sorted_bam)]
    check([p for p, _ in got] == [r.pos for r in reads] and sorted(got) == sorted(
        (r.pos, r.name) for r in reads), "SortSam did not give back the input's order")

    res = dict(phase="tools", clock="host", registry=len(cli.TOOL_REGISTRY),
               aliases=len(cli.TOOL_ALIASES), reads=len(reads), mean_coverage=mean_cov,
               raw_depth=raw_depth, host_wall_s=walls, host_total_s=sum(walls.values()))
    emit(res)
    return res


def _sites(recs):
    return [(r["pos"], r["ref"], r["alts"], r["gt"]) for r in recs]


def phase_ramped(sample, tmp, hc_vcf):
    """RampedHaplotypeCaller on the hc sample: the off-ramp after assembly
    (POST_ASSEMBLER_OFF, host only), then the on-ramp (POST_ASSEMBLER_ON:
    Smith-Waterman of the saved haplotypes, the PairHMM through PoolBatcher,
    genotyping). The round trip does not write a straight run's VCF (it
    genotypes the saved haplotypes over the padded regions' reads, so the
    annotations differ: tests/test_torch_ramped_hc.py); whether it calls the
    hc phase's sites and genotypes is reported."""
    from gatk_tpu_torch.calling import hc_engine

    state = os.path.join(tmp, "ramped.zip")
    out = os.path.join(tmp, "ramped.vcf")
    dev = ["--device", "cuda"]
    off_s, off_counts, _ = _run_tool(["RampedHaplotypeCaller", "-I", sample["bam"],
                                      "-R", sample["fasta"], "-O", state,
                                      "--off-ramp-type", "POST_ASSEMBLER_OFF",
                                      "--off-ramp-file", state, *dev])
    argv = ["RampedHaplotypeCaller", "-R", sample["fasta"], "-O", out,
            "--on-ramp-type", "POST_ASSEMBLER_ON", "--on-ramp-file", state, *dev]
    with keeping_launches("pairhmm_fwd") as kept:
        on_s, counts, _ = _run_tool(argv, counting_genotyped_pairs(hc_engine))
    recs = _records(out)
    missed, indels = _germline_gates(sample, recs)
    res = dict(phase="ramped", off_ramp_s=off_s, on_ramp_s=on_s,
               same_sites_as_hc=_sites(recs) == _sites(_records(hc_vcf)),
               off_ramp_launches=_pairs(off_counts), state_bytes=os.path.getsize(state),
               records=len(recs), launches=counts["pairhmm_fwd"]["launches"],
               pairs=_pairs(counts), counts=counts,
               snvs_called=sum(v.is_snv for v in sample["variants"]) - len(missed),
               indels_called=len(indels), largest_launch=_largest_launch(
                   kept, "the on-ramp's largest launch"), **_launches_summary(kept))
    emit(res)
    check(counts["pairhmm_fwd"]["launches"] > 0, "the on-ramp never launched the pair kernel")
    check(not missed, f"on-ramp: planted SNVs not called as 0/1: {missed}")
    check(len(indels) >= sum(not v.is_snv for v in sample["variants"]) - 1,
          f"on-ramp: only {len(indels)} planted indels called")
    return res


RECALLER_TOL = 1e-4  # a printed log10 likelihood (4 decimals): one step of the 4th


def _matrix_csv(path):
    with open(path) as fh:
        return [ln.split() for ln in fh.read().splitlines()]


def _first_records(vcf_in, vcf_out, n):
    """vcf_in's header and its first n records, into vcf_out."""
    with open(vcf_in) as src, open(vcf_out, "w") as dst:
        for line in src:
            if line.startswith("#") or n > 0:
                dst.write(line)
                n -= not line.startswith("#")


# variants of the recaller's --device cpu run: its plain PairHMM on the host
# of an NVIDIA H100 machine took 103-120 s for all 30 (PERF.md §5)
RECALLER_HOST_VARIANTS = 8


def phase_recaller(sample, tmp):
    """HaplotypeBasedVariantRecaller on the hc sample: HaplotypeCaller -bamout
    gives the alleles (its VCF) and the haplotypes (its bamout); the recaller
    flushes the pool once a variant, so the card gets one launch a variant
    with reads. Its matrix CSV is held to a --device cpu run (the plain
    versions on the host) of the same tool on the same inputs, cut to the
    first RECALLER_HOST_VARIANTS variants (each variant's block is computed
    on its own)."""
    vcf_out = os.path.join(tmp, "recaller.alleles.vcf")
    bamout = os.path.join(tmp, "recaller.haps.bam")
    hc_s, _, _ = _run_tool(["HaplotypeCaller", "-I", sample["bam"], "-R", sample["fasta"],
                            "-O", vcf_out, "-bamout", bamout, "--device", "cuda"])
    alleles = {"cuda": vcf_out, "cpu": os.path.join(tmp, "recaller.alleles.head.vcf")}
    _first_records(vcf_out, alleles["cpu"], RECALLER_HOST_VARIANTS)
    csv = {d: os.path.join(tmp, f"recaller.{d}.csv") for d in ("cuda", "cpu")}
    argv = {d: ["HaplotypeBasedVariantRecaller", "--alleles-file-vcf", alleles[d],
                "--haplotypes-file-bam", bamout, "--matrix-file-csv", csv[d],
                "-I", sample["bam"], "-R", sample["fasta"], "--device", d]
            for d in ("cuda", "cpu")}
    with keeping_launches("pairhmm_fwd") as kept:
        wall, counts, _ = _run_tool(argv["cuda"])
    cpu_s, _, _ = _run_tool(argv["cpu"])
    got_all, want = _matrix_csv(csv["cuda"]), _matrix_csv(csv["cpu"])
    blocks = sum(row[0].startswith("#") for row in got_all)
    starts = [i for i, row in enumerate(got_all) if row[0].startswith("#")]
    got = got_all[: starts[RECALLER_HOST_VARIANTS]] if blocks > RECALLER_HOST_VARIANTS else got_all
    shape_ok = len(got) == len(want) and all(
        len(a) == len(b) and (a[:5] == b[:5] if not a[0].startswith("#") else a == b)
        for a, b in zip(got, want))
    diffs = [abs(float(x) - float(y)) for a, b in zip(got, want) if not a[0].startswith("#")
             for x, y in zip(a[5:], b[5:])] if shape_ok else []
    pairs = sorted(a[1].numel() for a in kept["all"])
    res = dict(phase="recaller", hc_bamout_s=hc_s, wall_s=wall, cpu_wall_s=cpu_s,
               variants=blocks, cpu_variants=sum(row[0].startswith("#") for row in want),
               rows=len(got_all), rows_compared=len(got),
               launches=counts["pairhmm_fwd"]["launches"],
               pairs=_pairs(counts), median_pairs_per_launch=(
                   float(np.median(pairs)) if pairs else 0.0), counts=counts,
               values=len(diffs), max_abs_diff_vs_cpu=max(diffs, default=0.0),
               values_differing=sum(x > 0 for x in diffs))
    emit(res)
    check(blocks > 0, "the recaller wrote no variant")
    check(counts["pairhmm_fwd"]["launches"] == blocks,
          f"{counts['pairhmm_fwd']['launches']} pair-kernel launches for {blocks} variants")
    check(shape_ok, "the recaller's CSV on the card and on the host differ in their rows")
    check(max(diffs, default=0.0) <= RECALLER_TOL + 1e-9,
          f"the recaller's CSV is {max(diffs)} from the host's > {RECALLER_TOL}")
    return res


# --------------------------------------------------------------------------- trio


def _genotype_columns(path):
    """(sample names, records with each sample's GT) of a multi-sample VCF."""
    names, recs = [], []
    with open(path) as fh:
        for line in fh:
            if line.startswith("#CHROM"):
                names = line.rstrip("\n").split("\t")[9:]
            elif not line.startswith("#"):
                f = line.rstrip("\n").split("\t")
                recs.append(dict(pos=int(f[1]) - 1, ref=f[3], alts=f[4].split(","),
                                 gts=dict(zip(names, (s.split(":")[0] for s in f[9:])))))
    return names, recs


def _same_genotype(gt, want):
    return sorted(gt.replace("|", "/").split("/")) == sorted(want.split("/"))


def _gvcf_records(path):
    """A single-sample GVCF's records: (pos, end, alts, GT, PL, line); a ref
    block's end is its END, a variant record's pos + 1."""
    out = []
    with open(path) as fh:
        for line in fh:
            if not line.startswith("#"):
                f = line.rstrip("\n").split("\t")
                info = dict(kv.split("=", 1) for kv in f[7].split(";") if "=" in kv)
                fmt = dict(zip(f[8].split(":"), f[9].split(":")))
                pos = int(f[1]) - 1
                out.append((pos, int(info["END"]) if "END" in info else pos + 1,
                            f[4].split(","), fmt["GT"], [int(x) for x in fmt["PL"].split(",")],
                            line.rstrip("\n")))
    return out


def _gvcf_call(records, v):
    """The planted SNV v in a single-sample GVCF: (its GT, v's alt as 1 and any
    other alt as x, or 0/0 from a ref block; the alts of a variant record at
    v, else None; whether v lies in a ref block whose PL is least at a
    genotype other than 0/0)."""
    for pos, end, alts, gt, pl, _ in records:
        if pos == v.pos and any(a != "<NON_REF>" for a in alts):
            names = {"0": "0", **{str(i + 1): "1" if a == v.alt else "x"
                                  for i, a in enumerate(alts)}}
            return ("/".join(names.get(a, a) for a in gt.replace("|", "/").split("/")), alts,
                    False)
        if pos <= v.pos < end:
            return "0/0", None, min(pl) < pl[0]
    return "missing", None, False


def _mendelian(gts):
    """True unless the child's called alleles cannot be one of the mother's
    and one of the father's."""
    alleles = {s: gts[s].replace("|", "/").split("/") for s in ("MOTHER", "FATHER", "CHILD")}
    if any("." in a for a in alleles.values()):
        return True
    c = alleles["CHILD"]
    return ((c[0] in alleles["MOTHER"] and c[1] in alleles["FATHER"])
            or (c[1] in alleles["MOTHER"] and c[0] in alleles["FATHER"]))


TRIO = dict(seed=0)  # utils/synthetic.write_trio at its defaults: 16,569 bp, 20,000 reads a sample


def phase_trio(tmp):
    """Joint genotyping of a trio through the port's CLI: HaplotypeCaller
    -ERC GVCF --device cuda over the whole contig for each sample (the matrix
    kernel), CombineGVCFs and GenotypeGVCFs, then GenomicsDBImport and
    GenotypeGVCFs on gendb://; one -ERC GVCF run again under the profiler."""
    from gatk_tpu_torch.calling import hc_engine
    from gatk_tpu_torch.utils import synthetic

    d = os.path.join(tmp, "trio")
    t0 = time.perf_counter()
    trio = synthetic.write_trio(d, **TRIO)
    write_s = time.perf_counter() - t0
    gvcf, tool_s, counts, pairs = {}, {}, {}, {}
    with keeping_launches("pairhmm_matrix") as kept:
        for sm, bam in trio["bams"].items():
            gvcf[sm] = os.path.join(d, f"{sm}.g.vcf")
            argv = ["HaplotypeCaller", "-I", bam, "-R", trio["fasta"], "-ERC", "GVCF",
                    "-O", gvcf[sm], "--device", "cuda"]
            tool_s[f"HaplotypeCaller -ERC GVCF {sm}"], c, _ = _run_tool(
                argv, counting_genotyped_pairs(hc_engine))
            counts[sm] = c["pairhmm_matrix"]["launches"]
            pairs[sm] = _pairs(c)
            check(counts[sm] > 0, f"-ERC GVCF of {sm} never launched the matrix kernel")
    check(kept["n"] > 0, "the trio's -ERC GVCF runs made no cartesian launch")
    largest = _matrix_case(kept["args"][0], "the trio's largest launch")
    profiled = _profile_tool(argv[:-3] + [gvcf[sm] + ".2", "--device", "cuda"])
    vs = sum((["-V", gvcf[sm]] for sm in synthetic.TRIO_SAMPLES), [])
    comb, gg, ws, gg_db = (os.path.join(d, f) for f in ("comb.g.vcf", "gg.vcf", "ws", "gg_db.vcf"))
    tool_s["CombineGVCFs"], _, _ = _run_tool(["CombineGVCFs", *vs, "-R", trio["fasta"],
                                              "-O", comb])
    tool_s["GenotypeGVCFs"], _, _ = _run_tool(["GenotypeGVCFs", "-V", comb,
                                               "-R", trio["fasta"], "-O", gg])
    tool_s["GenomicsDBImport"], _, _ = _run_tool(["GenomicsDBImport", *vs,
                                                  "--genomicsdb-workspace-path", ws])
    tool_s["GenotypeGVCFs gendb"], _, _ = _run_tool(["GenotypeGVCFs", "-V", f"gendb://{ws}",
                                                     "-R", trio["fasta"], "-O", gg_db])
    with open(gg, "rb") as a, open(gg_db, "rb") as b:
        gendb_same = a.read() == b.read()
    _, recs = _genotype_columns(gg)
    _, comb_recs = _genotype_columns(comb)
    sample_recs = {sm: _gvcf_records(gvcf[sm]) for sm in synthetic.TRIO_SAMPLES}
    wrong_snv, wrong_gvcf, fault_sites = [], [], []
    indels_called, violations = {sm: 0 for sm in synthetic.TRIO_SAMPLES}, []
    for k, v in enumerate(trio["variants"]):
        want = {sm: trio["genotypes"][sm][k] for sm in synthetic.TRIO_SAMPLES}
        if v.is_snv:
            calls = {sm: _gvcf_call(sample_recs[sm], v) for sm in synthetic.TRIO_SAMPLES}
            if not all(_same_genotype(calls[sm][0], want[sm]) for sm in calls):
                wrong_gvcf.append((v.pos, {sm: c[0] for sm, c in calls.items()}, want))
            at = [r for r in recs if r["pos"] == v.pos and r["ref"] == v.ref and v.alt in r["alts"]]
            got = at[0]["gts"] if at else {}
            # two faults of gatk_tpu, carried as-is (ROADMAP §3), let
            # GenotypeGVCFs call a sample otherwise than its own GVCF does:
            # the combined record gives a sample's variant record PL 0 for
            # every genotype with an allele that record lacks
            # (gvcf/combine.py:_remap_pls); and a ref block can carry the PL
            # of a het, least at 0/NON_REF (calling/hc_engine.py, GVCF ref
            # blocks). Such samples are reported, not held to the planted
            # genotype in the joint VCF; their GVCF calls are held above.
            alleles = [a for r in comb_recs if r["pos"] == v.pos for a in r["alts"]]
            hit = {}
            for sm, (_, alts, het_block) in calls.items():
                if alts is not None and any(a not in alts for a in alleles):
                    hit[sm] = "combine_pl"
                elif het_block:
                    hit[sm] = "ref_block_pl"
            if hit:  # with each such sample's GVCF lines there, to hold against gatk_tpu's
                fault_sites.append(dict(pos=v.pos, combined_alleles=alleles, samples=hit,
                                        joint=got, planted=want, gvcf={
                                            sm: [r[5] for r in sample_recs[sm]
                                                 if r[0] <= v.pos < r[1]] for sm in hit}))
            if not at or not all(sm in hit or _same_genotype(got[sm].replace(
                    str(at[0]["alts"].index(v.alt) + 1), "1"), want[sm])
                    for sm in synthetic.TRIO_SAMPLES):
                wrong_snv.append(dict(pos=v.pos, joint=got, planted=want, gvcf={
                    sm: [r for r in sample_recs[sm] if r[0] <= v.pos < r[1]]
                    for sm in synthetic.TRIO_SAMPLES}, combined=[
                    r for r in comb_recs if r["pos"] == v.pos]))
        else:
            near = [r for r in recs if abs(r["pos"] - v.pos) <= 20
                    and len(r["ref"]) - len(r["alts"][0]) == len(v.ref) - len(v.alt)]
            got = near[0]["gts"] if near else {}
            for sm in synthetic.TRIO_SAMPLES:
                indels_called[sm] += bool(near) and _same_genotype(got[sm], want[sm])
        at = [r for r in recs if abs(r["pos"] - v.pos) <= 20]
        violations += [v.pos for r in at if not _mendelian(r["gts"])]
    n_indels = sum(not v.is_snv for v in trio["variants"])
    res = dict(phase="trio", contig_len=trio["length"], reads_per_sample=trio["n_reads"],
               write_s=write_s, tool_s=tool_s, wall_s=sum(tool_s.values()),
               matrix_launches=counts, launches=sum(counts.values()), pairs=pairs,
               counts={"pairhmm_matrix": {"launches": sum(counts.values())}},
               records=len(recs), snvs_planted=sum(v.is_snv for v in trio["variants"]),
               snvs_wrong=wrong_snv, snvs_wrong_in_gvcf=wrong_gvcf,
               gatk_tpu_fault_sites=fault_sites, indels_planted=n_indels,
               indels_called=indels_called,
               mendelian_violations=violations, gendb_same_as_combine=gendb_same,
               largest_launch=largest, profiled_sample=sm, **profiled)
    emit(res)
    check(not wrong_gvcf, f"trio: planted SNVs whose -ERC GVCF call is not the planted "
                          f"genotype: {wrong_gvcf}")
    check(not wrong_snv, f"trio: planted SNVs without their planted genotypes: {wrong_snv}")
    check(all(n >= n_indels - 1 for n in indels_called.values()),
          f"trio: indels called with their genotypes {indels_called} of {n_indels}")
    check(not violations, f"trio: Mendelian violations at planted sites {violations}")
    check(gendb_same, "GenotypeGVCFs on gendb:// differs from the CombineGVCFs path")
    return res


# --------------------------------------------------------------------------- preprocess

PREPROCESS = dict(seed=0, n_duplicates=1000)  # write_sample's chrM-length sample
# the read group's empirical mismatch quality: within this of the planted
# error rate's phred (write_sample's err_rate 0.005: 23.0)
BQSR_EMPIRICAL_Q_TOL = 1.0
REF_OPS = (0, 2, 3, 7, 8)  # M, D, N, =, X: the ops that consume the reference


def _duplicates_expected(bam_path):
    """(reads, duplicates MarkDuplicates must flag, counted here): reads that
    share a strand and an unclipped 5' end form a group, and all but one of
    each group are duplicates."""
    from gatk_tpu_torch.io import bam as bamio

    groups = {}
    n = 0
    for r in bamio.BamReader(bam_path):
        n += 1
        ops, lens = r.cigar_ops.tolist(), r.cigar_lens.tolist()
        lead = lens[0] if ops[0] == 4 else 0
        trail = lens[-1] if ops[-1] == 4 else 0
        ref_len = sum(ln for op, ln in zip(ops, lens) if op in REF_OPS)
        rev = bool(r.flag & 16)
        five = r.pos + ref_len + trail if rev else r.pos - lead
        groups[(rev, five)] = groups.get((rev, five), 0) + 1
    return n, sum(c - 1 for c in groups.values())


def phase_preprocess(tmp):
    """MarkDuplicates (with --metrics-file), BaseRecalibrator --known-sites,
    ApplyBQSR (host code, each timed) on a chrM-length sample with planted
    duplicates, then HaplotypeCaller --device cuda on the recalibrated BAM."""
    import math

    from gatk_tpu_torch.calling import hc_engine
    from gatk_tpu_torch.io import bam as bamio
    from gatk_tpu_torch.recal.report import parse_report
    from gatk_tpu_torch.utils import synthetic

    d = os.path.join(tmp, "pre")
    t0 = time.perf_counter()
    sample = synthetic.write_sample(d, **PREPROCESS)
    write_s = time.perf_counter() - t0
    md, metrics, table, bqsr, out = (os.path.join(d, f) for f in (
        "md.bam", "md.metrics", "recal.table", "bqsr.bam", "out.vcf"))
    tool_s = {}
    tool_s["MarkDuplicates"], _, _ = _run_tool(["MarkDuplicates", "-I", sample["bam"], "-O", md,
                                           "-M", metrics])
    tool_s["BaseRecalibrator"], _, _ = _run_tool([
        "BaseRecalibrator", "-I", md, "-R", sample["fasta"], "--known-sites",
        sample["known_sites"], "-O", table])
    tool_s["ApplyBQSR"], _, _ = _run_tool(["ApplyBQSR", "-I", md, "-R", sample["fasta"],
                                      "--bqsr-recal-file", table, "-O", bqsr])
    argv = ["HaplotypeCaller", "-I", bqsr, "-R", sample["fasta"], "-O", out, "--device", "cuda"]
    with keeping_launches("pairhmm_fwd") as kept:
        tool_s["HaplotypeCaller"], counts, _ = _run_tool(argv, counting_genotyped_pairs(hc_engine))
    flagged = {r.name for r in bamio.BamReader(md) if r.flag & 1024}
    n_reads, expected = _duplicates_expected(sample["bam"])
    missed_dups = sorted(set(sample["duplicates"]) - flagged)
    rows = {t[0]: t for t in parse_report(open(table).read())}["RecalTable0"]
    cols = [c for c, _ in rows[2]]
    mism = [dict(zip(cols, r)) for r in rows[3] if dict(zip(cols, r))["EventType"] == "M"]
    planted_q = -10 * math.log10(0.005)
    emp_q = [float(r["EmpiricalQuality"]) for r in mism]
    recs = _records(out)
    missed, indels = _germline_gates(sample, recs)
    res = dict(phase="preprocess", reads=n_reads, write_s=write_s, tool_s=tool_s,
               wall_s=sum(tool_s.values()), duplicates_planted=len(sample["duplicates"]),
               duplicates_flagged=len(flagged), duplicates_expected=expected,
               planted_duplicates_missed=len(missed_dups), empirical_q=emp_q,
               planted_error_q=planted_q, records=len(recs),
               snvs_called=sum(v.is_snv for v in sample["variants"]) - len(missed),
               indels_called=len(indels), launches=counts["pairhmm_fwd"]["launches"],
               pairs=_pairs(counts), counts=counts, largest_launch=_largest_launch(
                   kept, "HaplotypeCaller's largest launch on the recalibrated BAM"))
    emit(res)
    check(not missed_dups, f"{len(missed_dups)} planted duplicates not flagged")
    check(len(flagged) == expected,
          f"MarkDuplicates flagged {len(flagged)} reads, the groups hold {expected} duplicates")
    check(len(emp_q) == 1 and abs(emp_q[0] - planted_q) <= BQSR_EMPIRICAL_Q_TOL,
          f"empirical quality {emp_q} is not within {BQSR_EMPIRICAL_Q_TOL} of {planted_q:.2f}")
    check(counts["pairhmm_fwd"]["launches"] > 0,
          "HaplotypeCaller on the recalibrated BAM never launched the pair kernel")
    check(not missed, f"HaplotypeCaller on the recalibrated BAM missed planted SNVs: {missed}")
    return res, sample


# --------------------------------------------------------------------------- distributed


DIST_SHARD_SIZE = 2000  # HaplotypeCaller --shard-size of the one- and two-process runs
DIST_TIMEOUT = 240  # seconds a HaplotypeCaller subprocess may take before it is killed
HIST_KEYS = 3_171_000  # the preprocess sample's bases (21,000 reads x 151)
HIST_BINS = 65_536
HIST_RTOL = 1e-5  # float32 sums in any order against float64


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_processes(cmds, what):
    """Run the commands at once on this card: (host wall s, each one's output);
    every one must exit 0 within DIST_TIMEOUT, and all are killed when one
    does not."""
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="0")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(c, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for c in cmds]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=DIST_TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        fail(f"{what}: a process ran past {DIST_TIMEOUT} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    wall = time.perf_counter() - t0
    for p, out in zip(procs, outs):
        check(p.returncode == 0, f"{what} exited {p.returncode}:\n{out[-4000:]}")
    return wall, outs


def _add_counts(a, b):
    return {name: {k: a[name][k] + b[name][k] for k in a[name]} for name in a}


# A tool run in a subprocess of its own, which reports its own kernel counts:
# every count set to 0, the port's CLI on the arguments, a device
# synchronisation, then the counts as JSON on a line that starts with COUNTS_TAG.
COUNTS_TAG = "chip_smoke counts: "
COUNTING_DRIVER = (
    "import json, sys, torch, chip_smoke\n"
    "from gatk_tpu_torch import cli\n"
    "chip_smoke.reset_counts()\n"
    "rc = cli.main(sys.argv[1:])\n"
    "torch.cuda.synchronize()\n"
    "print(chip_smoke.COUNTS_TAG + json.dumps(chip_smoke.read_counts()), flush=True)\n"
    "sys.exit(rc)\n")


def _process_counts(out, what):
    lines = [l for l in out.splitlines() if l.startswith(COUNTS_TAG)]
    check(len(lines) == 1, f"{what} printed {len(lines)} count lines")
    return json.loads(lines[0][len(COUNTS_TAG):])


def _histogram_in_nccl_group(dev):
    """mesh.bqsr_histogram_step inside a one-rank NCCL group, created and
    destroyed here, against a float64 bincount on the host."""
    import torch.distributed as dist
    from gatk_tpu_torch.parallel import mesh

    rng = np.random.default_rng(2)
    keys = rng.integers(0, HIST_BINS, HIST_KEYS).astype(np.int32)
    errors = rng.random(HIST_KEYS).astype(np.float32)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)
    try:
        check(dist.get_backend() == "nccl", f"the group's backend is {dist.get_backend()}")
        obs, errs = mesh.bqsr_histogram_step([dev], keys, errors, HIST_BINS)
        torch.cuda.synchronize()
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            mesh.bqsr_histogram_step([dev], keys, errors, HIST_BINS)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
    finally:
        dist.destroy_process_group()
    want_obs = np.bincount(keys, minlength=HIST_BINS)
    want_errs = np.bincount(keys, weights=errors.astype(np.float64), minlength=HIST_BINS)
    check(obs.device == dev and np.array_equal(obs.cpu().numpy(), want_obs),
          "the NCCL histogram's counts differ from the host's")
    rel = float(np.max(np.abs(errs.cpu().numpy() - want_errs) / np.maximum(want_errs, 1e-30)))
    check(rel <= HIST_RTOL, f"the NCCL histogram's errors are {rel} from the host's")
    return dict(keys=HIST_KEYS, bins=HIST_BINS, wall_ms=float(np.median(walls)),
                max_rel_err_errs=rel)


def _hc_processes(sample, tmp, n, extra):
    """HaplotypeCaller --device cuda --shard-size DIST_SHARD_SIZE on the hc
    sample in n processes over gloo (one plain run when n is 1), each through
    COUNTING_DRIVER: (wall s, the gathered VCF's records, each process's
    kernel counts)."""
    out = os.path.join(tmp, f"dist_{n}_{'_'.join(extra) or 'one'}.vcf")
    base = [sys.executable, "-c", COUNTING_DRIVER, "HaplotypeCaller", "-I", sample["bam"],
            "-R", sample["fasta"], "-O", out, "--shard-size", str(DIST_SHARD_SIZE),
            "--device", "cuda"]
    if n == 1:
        cmds = [base]
    else:
        port = _free_port()
        cmds = [base + ["--distributed-coordinator", f"127.0.0.1:{port}",
                        "--distributed-num-processes", str(n),
                        "--distributed-process-id", str(pid)] + extra for pid in range(n)]
    what = f"HaplotypeCaller in {n} process(es) {' '.join(extra)}"
    wall, outs = _run_processes(cmds, what)
    return wall, _records(out), [_process_counts(o, what) for o in outs]


def phase_distributed(dev, tmp, sample, pre_sample):
    """The port's data-parallel paths on this machine's cards (one here): the
    graft entry, the multi-device dry run over the cards and over two slices of
    the first, the sharded pair kernel on the bench workload (the same two
    ways), the histogram in a one-rank NCCL group, HaplotypeCaller in two
    processes over gloo on one card (both gathers), and ReadsPipelineSpark.
    Three paths, each counted on its own: `distributed` (this process's
    sharded calls), `distributed_hc` (the two-process HaplotypeCaller runs,
    each process counting its own launches) and `reads_pipeline_spark`."""
    from gatk_tpu_torch import graft_entry
    from gatk_tpu_torch.calling import hc_engine
    from gatk_tpu_torch.ops import pairhmm
    from gatk_tpu_torch.parallel import mesh

    t_phase = time.perf_counter()
    n_cards = torch.cuda.device_count()
    reads, haps, ri, hi = _bench_workload()
    packed, rp, hmax, n_pairs = pairhmm.pack_batch(reads, haps, ri, hi)
    cards = mesh.make_mesh()
    # two slices on the one card: the split, the per-slice upload and the
    # gather's order run even where there is one card
    halves = [dev, dev]

    reset_counts()  # the launches of the driven path below only
    t0 = time.perf_counter()
    fn, args = graft_entry.entry()
    entry_out = fn(*args)
    graft_entry.dryrun_multichip(n_cards)
    graft_entry.dryrun_multichip(2, halves)
    sharded = mesh.pairhmm_sharded(cards, packed, rp, hmax)
    sharded_halves = mesh.pairhmm_sharded(halves, packed, rp, hmax)
    torch.cuda.synchronize()
    driven_s = time.perf_counter() - t0
    counts = read_counts()
    argv = ["ReadsPipelineSpark", "-I", pre_sample["bam"], "-R", pre_sample["fasta"],
            "--known-sites", pre_sample["known_sites"], "-O", os.path.join(tmp, "rps.vcf"),
            "--device", "cuda", "--spark-master", "local[*]"]
    rps_wall, rps_counts, _ = _run_tool(argv, counting_genotyped_pairs(hc_engine))

    # the checks, after the counts are read
    entry_err, _ = _check_close(entry_out, pairhmm.pairhmm_pairs_reference(
        *args, hap_n_mismatch=True), "graft_entry.entry() on the card")
    one = mesh.PAIR_ENTRY(*pairhmm.from_jax_packed(packed, device=dev))
    for got, devs in ((sharded, cards), (sharded_halves, halves)):
        check(got.shape == (1, n_pairs) and got.device == devs[0],
              f"pairhmm_sharded over {devs} gave {tuple(got.shape)} on {got.device}")
        check(torch.equal(got[0], one),
              f"pairhmm_sharded over {devs} differs from a one-device launch of the same pairs")
    walls = {}
    for name, devs in (("cards", cards), ("two_slices", halves)):
        walls[name] = []
        for _ in range(5):
            t0 = time.perf_counter()
            mesh.pairhmm_sharded(devs, packed, rp, hmax)
            torch.cuda.synchronize()
            walls[name].append((time.perf_counter() - t0) * 1e3)
    pools, rit, hit = pairhmm.from_jax_packed(packed, device=dev)
    timed = _timed(pools, rit, hit, plain_reps=1, hap_n_mismatch=True)
    hist = _histogram_in_nccl_group(dev)

    one_s, want, one_counts = _hc_processes(sample, tmp, 1, [])
    runs = {}
    hc_counts = None
    for mode in (["--distributed-gather", "collective"],
                 ["--distributed-gather", "files", "--distributed-shard-mode", "round-robin"]):
        wall, got, per_process = _hc_processes(sample, tmp, 2, mode)
        for c in per_process:
            hc_counts = c if hc_counts is None else _add_counts(hc_counts, c)
        runs[mode[1]] = dict(wall_s=wall, records=len(got),
                             equal=[r["line"] for r in got] == [r["line"] for r in want],
                             missed_snvs=_germline_gates(sample, got)[0],
                             launches_per_process=[c["pairhmm_fwd"]["launches"]
                                                   for c in per_process])
    rps = _records(os.path.join(tmp, "rps.vcf"))
    pre = _records(os.path.join(tmp, "pre", "out.vcf"))
    rps_missed = _germline_gates(pre_sample, rps)[0]
    res = dict(phase="distributed", seconds=time.perf_counter() - t_phase, cards=n_cards,
               driven_s=driven_s,
               entry_max_abs_err=entry_err, sharded_pairs=n_pairs,
               sharded_wall_ms=float(np.median(walls["cards"])),
               sharded_two_slices_wall_ms=float(np.median(walls["two_slices"])),
               one_device=timed,
               histogram_nccl=hist, hc_one_process_s=one_s, hc_records=len(want),
               hc_one_process_launches=one_counts[0]["pairhmm_fwd"]["launches"],
               hc_missed_snvs=_germline_gates(sample, want)[0], hc_two_process=runs,
               reads_pipeline_spark_s=rps_wall, reads_pipeline_records=len(rps),
               reads_pipeline_missed_snvs=rps_missed,
               reads_pipeline_equals_preprocess=[r["line"] for r in rps] == [
                   r["line"] for r in pre],
               launches=counts["pairhmm_fwd"]["launches"]
               + counts["pairhmm_fwd_hap_n_mismatch"]["launches"], counts=counts,
               hc_counts=hc_counts, rps_counts=rps_counts)
    emit(res)
    check(counts["pairhmm_fwd_hap_n_mismatch"]["launches"] > 0,
          "the sharded path never launched the pair kernel")
    check(counts["pairhmm_fwd"]["launches"] > 0,
          "the dry runs' sharded calling never launched the pair kernel")
    check(rps_counts["pairhmm_fwd"]["launches"] > 0,
          "ReadsPipelineSpark never launched the pair kernel")
    check(not res["hc_missed_snvs"], f"one-process HaplotypeCaller missed {res['hc_missed_snvs']}")
    for name, r in runs.items():
        check(r["equal"], f"2-process HaplotypeCaller ({name} gather) differs from one process")
        check(not r["missed_snvs"], f"2-process HaplotypeCaller ({name}) missed {r['missed_snvs']}")
        check(all(n > 0 for n in r["launches_per_process"]),
              f"a process of the 2-process HaplotypeCaller ({name}) never launched the pair "
              f"kernel: {r['launches_per_process']}")
    check(not rps_missed, f"ReadsPipelineSpark missed planted SNVs: {rps_missed}")
    return res


# --------------------------------------------------------------------------- matrix


def _matrix_case(pools, what, plain_reps=3, timed=True):
    """The cartesian kernel against its plain version on `pools`, and, when
    timed, CUDA-event medians of the kernel, the plain version and the pair
    kernel over the same product expanded into pairs, beside the bound of the
    cells (sum of rlen x sum of hlen), the pools read once and the (NH, NR)
    output written once."""
    from gatk_tpu_torch.ops import _kernels, pairhmm

    got = _kernels.pairhmm_matrix(pools)
    err, n_ok = _check_close(got, pairhmm.pairhmm_matrix_reference(pools), what)
    nr, nh = pools.rbase.shape[1], pools.e.shape[1]
    res = dict(case=what, rp=pools.rp, hmax=pools.hmax, reads=nr, haps=nh, pairs=nr * nh,
               above_floor=n_ok, max_abs_err=err)
    if not timed:
        return res
    ri, hi = (torch.from_numpy(a).to(pools.rbase.device) for a in pairhmm.cartesian_pairs(nr, nh))
    _, err_fwd = _check_close(_kernels.pairhmm_fwd(pools, ri, hi).reshape(nh, nr), got,
                              f"{what}: pair kernel over the expanded product")
    kernel_ms = median_ms(lambda: _kernels.pairhmm_matrix(pools), reps=30, warmup=3)
    fwd_ms = median_ms(lambda: _kernels.pairhmm_fwd(pools, ri, hi), reps=30, warmup=3)
    plain_ms = median_ms(lambda: pairhmm.pairhmm_matrix_reference(pools), reps=plain_reps,
                         warmup=1)
    cells = int(pools.rlen.long().sum().item()) * int(pools.hlen.long().sum().item())
    bound = _bound(cells, _pool_bytes(pools), 4 * nr * nh)
    return dict(res, kernel_ms=kernel_ms, pair_kernel_expanded_ms=fwd_ms, plain_ms=plain_ms,
                useful_gcups=cells / kernel_ms / 1e6, **bound)


def phase_matrix(dev, kept):
    from gatk_tpu_torch.ops import pairhmm

    cases = []
    reads, haps, _, _ = _bench_workload()  # all 64 x 16 unique pairs
    a, b = pairhmm.cartesian_pairs(len(reads), len(haps))
    pools, _, _ = _device_pools(reads, haps, a, b, dev, rp=160, hmax=512)
    cases.append(_matrix_case(pools, "bench 64 x 16"))
    for seed, (read_lens, hap_lens, rp, hmax) in ((2, RAGGED[1]), (5, RAGGED[2])):
        rr, hh = _ragged_workload(read_lens, hap_lens, seed=seed)
        a, b = pairhmm.cartesian_pairs(len(rr), len(hh))
        pools, _, _ = _device_pools(rr, hh, a, b, dev, rp=rp, hmax=hmax)
        cases.append(_matrix_case(pools, f"ragged/N rp={rp} hmax={hmax} reads "
                                         f"{min(read_lens)}-{max(read_lens)}", timed=False))
    # more haplotypes than the pool holds (PoolBatcher sends these here)
    rng = np.random.default_rng(7)
    rr, hh = _ragged_workload(rng.integers(100, 152, 24), rng.integers(150, 451, 1100), seed=4)
    a, b = pairhmm.cartesian_pairs(len(rr), len(hh))
    pools, _, _ = _device_pools(rr, hh, a, b, dev, rp=160, hmax=512)
    cases.append(_matrix_case(pools, "24 reads x 1,100 haplotypes", plain_reps=2))
    check(kept["n"] > 0, "the -ERC GVCF run made no cartesian launch")
    cases.append(_matrix_case(kept["args"][0], "gvcf largest launch"))
    res = dict(phase="matrix", cases=cases, max_abs_err=max(c["max_abs_err"] for c in cases))
    emit(res)
    return res


# --------------------------------------------------------------------------- CNV

# GermlineCNVCaller's shard and the somatic case (utils/synthetic.py): the
# gCNV cohort at DenoisingConfig's defaults; the panel of normals at 40 x
# 50,000, and the case's every interval and het site through ModelSegments
GCNV_COHORT = dict(seed=0, n_samples=32, n_intervals=10000)
SOMATIC_CASE = dict(seed=0, n_normals=40, n_intervals=50000, n_contigs=50, n_event_contigs=7,
                    n_hets=10000)
GCNV_EVENT_SHARE, GCNV_BASELINE_SHARE = 0.95, 0.99
SOMATIC_CR_TOL, SOMATIC_MAF_TOL = 0.1, 0.05  # |posterior median - planted|
# the HMM kernel's log posteriors: within HMM_TOL_F64 of the float64
# sequential plain version; within the float32 sequential plain version's own
# distance from float64 plus HMM_TOL_F64 of that version (the two associate
# the sums otherwise: a chunked pass never forms the |4e4| log joints whose
# float32 rounding step is 0.004); within HMM_TOL_CHUNKED plus HMM_CHUNKED_ULPS
# float32 rounding steps of the value of the plain version of the kernel's
# own association (a log posterior of a state far from the data reaches -6e3
# on the fitted shard, where one float32 rounding step is 4.9e-4, and the two
# round the same sum of nearly equal terms); and the same argmax state as
# float64 wherever float64's top two states differ by more than HMM_ARGMAX_GAP
HMM_TOL_F64 = 1e-3
HMM_TOL_CHUNKED = 1e-4
HMM_CHUNKED_ULPS = 2
HMM_ARGMAX_GAP = 0.1
HMM_CHUNK_SWEEP = (32, 64, 96, 128, 160, 192, 256)
HMM_KERNELS = ("log_stay_kernel", "transfer_kernel", "starts_kernel", "posterior_kernel")
PLAIN_PROFILED = 500  # intervals of the plain HMM whose launches are counted


def _device_flag(dev):
    return ["--device", dev.type]


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def keeping_models():
    """The GermlineDenoisingModel of every GermlineCNVCaller run inside the
    block, kept when its fit starts (the CLI builds it inside the tool)."""
    from gatk_tpu_torch.cnv import denoising

    fit = denoising.GermlineDenoisingModel.fit
    models = []

    def keep(self, *args, **kwargs):
        models.append(self)
        return fit(self, *args, **kwargs)

    denoising.GermlineDenoisingModel.fit = keep
    try:
        yield models
    finally:
        denoising.GermlineDenoisingModel.fit = fit


def phase_gcnv(dev, tmp, sample):
    """The four germline tools through the port's CLI on a GermlineCNVCaller
    shard: CollectReadCounts on the hc phase's BAM (the cohort's counts are
    synthetic), DetermineGermlineContigPloidy, GermlineCNVCaller --device cuda
    and PostprocessGermlineCNVCalls of one sample; then GermlineCNVCaller
    again under torch.profiler."""
    from gatk_tpu_torch import cli
    from gatk_tpu_torch.cnv import cnv_io
    from gatk_tpu_torch.utils import synthetic

    d = os.path.join(tmp, "gcnv")
    t0 = time.perf_counter()
    coh = synthetic.write_cnv_cohort(d, **GCNV_COHORT)
    write_s = time.perf_counter() - t0
    bins = os.path.join(d, "chrM.interval_list")
    with open(bins, "w") as fh:
        fh.write(f"@HD\tVN:1.6\n@SQ\tSN:{sample['contig']}\tLN:{sample['length']}\n" + "".join(
            f"{sample['contig']}\t{s + 1}\t{min(s + 1000, sample['length'])}\t+\t.\n"
            for s in range(0, sample["length"], 1000)))
    inputs = sum((["-I", p] for p in coh["counts"]), [])
    calls = os.path.join(d, "gcnv-calls")
    vcf = os.path.join(d, "sample0.vcf")
    argv = {
        "CollectReadCounts": ["-I", sample["bam"], "-L", bins,
                              "-O", os.path.join(d, "hc.counts.tsv")],
        "DetermineGermlineContigPloidy": [*inputs, "--contig-ploidy-priors", coh["ploidy_priors"],
                                          "-O", d, "--output-prefix", "ploidy"],
        "GermlineCNVCaller": [*inputs, "--contig-ploidy-calls", os.path.join(d, "ploidy-calls"),
                              "-O", d, "--output-prefix", "gcnv", *_device_flag(dev)],
        "PostprocessGermlineCNVCalls": ["--calls-shard-path", calls, "--sample-index", "0",
                                        "--output-genotyped-intervals", vcf],
    }
    tool_s = {}
    reset_counts()  # counts of the path below only
    with keeping_models() as models:
        t_path = time.perf_counter()
        for tool, args in argv.items():
            t0 = time.perf_counter()
            check(cli.main([tool, *args]) == 0, f"{tool} failed")
            _sync(dev)
            tool_s[tool] = time.perf_counter() - t0
        wall = time.perf_counter() - t_path
    counts = read_counts()
    check(counts["cnv_hmm"]["launches"] > 0, "GermlineCNVCaller never launched the HMM kernel")
    model = models[0]
    ploidy, _ = cnv_io.read_contig_ploidy_calls(os.path.join(d, "ploidy-calls"))
    ploidy_wrong = sorted((s, c) for s in coh["samples"] for c, p in coh["ploidy"][s].items()
                          if ploidy[s].get(c) != p)
    events, baseline = synthetic.cnv_call_concordance(coh, np.load(os.path.join(calls, "cn.npy")))
    n_records = sum(1 for ln in open(vcf) if not ln.startswith("#"))

    profiled_argv = ["GermlineCNVCaller", *argv["GermlineCNVCaller"][:-4], "--output-prefix",
                     "gcnv_profiled", *_device_flag(dev)]
    profiled = _profile(lambda: check(cli.main(profiled_argv) == 0,
                                      "profiled GermlineCNVCaller failed"), "gcnv.")
    parts = profiled.pop("ranges")
    fit = {part: dict(seconds=st["seconds"], calls=st["calls"],
                      launches_profiled=parts.get(f"gcnv.{part}", {}).get("launches"))
           for part, st in model.stats.items()}
    res = dict(phase="gcnv", samples=model.S, intervals=model.T, states=model.C,
               events_planted=len(coh["events"]), write_s=write_s, wall_s=wall, tool_s=tool_s,
               fit=fit, counts={"cnv_hmm": counts["cnv_hmm"]},
               ploidy_calls_wrong=ploidy_wrong, event_interval_share=events,
               baseline_interval_share=baseline, vcf_records=n_records,
               **profiled)
    emit(res)
    check(not ploidy_wrong, f"contig-ploidy calls differ from the planted ploidy: {ploidy_wrong}")
    check(events >= GCNV_EVENT_SHARE, f"planted CN called on {events:.4f} of the event intervals")
    check(baseline >= GCNV_BASELINE_SHARE, f"baseline called on {baseline:.4f} of the others")
    check(n_records == model.T, "PostprocessGermlineCNVCalls wrote the wrong number of records")
    return res, model


def _hmm_bound(S, T, C):
    """The least time of one forward-backward pass: log_em and log_pi read
    once, stay read once, the posteriors written once, over 3.35 TB/s; and the
    FP32 operations of the plain version per sample and interval, a
    transcendental counted as one (forward 5 C^2 + 9 C, backward 5 C^2 + 10 C,
    normalisation 6 C + 2), over 67 TFLOP/s. It assumes no step waits on the
    one before; the kernel's T dependent steps a direction do."""
    ops = S * T * (10 * C * C + 25 * C + 2)
    nbytes = 4 * (3 * S * T * C + max(T - 1, 0))
    ops_ms, bytes_ms = ops / FP32_PEAK * 1e3, nbytes / HBM_RATE * 1e3
    return dict(bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                ops_bound_ms=ops_ms, bytes_bound_ms=bytes_ms)


# more states than a lane group holds: a warp a vector, ceil(C / 32) states a
# lane (2, 2 full, 4 with the last part full, 9 with one state in the last)
HMM_WIDE_STATES = (33, 64, 100, 257)


def _hmm_edge_cases(dev, chunk):
    """(name, log_em, log_pi, stay) at the kernel's edges: one interval, a
    chain break at every interval (stay 0), stay 1 (off-diagonal log
    transitions -inf), one state on every lane (C = 32) and one state (C = 1);
    then the chunks' edges: T = L, L + 1, 2 L + 1 and a T - 1 that is not a
    multiple of L (L = chunk); then C of HMM_WIDE_STATES over several chunks."""
    rng = np.random.default_rng(11)
    out = []
    wide = tuple((f"C={C}, T=700", 3, 700, C, None) for C in HMM_WIDE_STATES)
    for name, S, T, C, stay in (("T=1", 4, 1, 6, np.zeros(0)), ("break everywhere", 4, 64, 6, 0.0),
                                ("stay=1", 4, 64, 6, 1.0), ("C=32", 3, 64, 32, 0.9),
                                ("C=1", 2, 64, 1, 0.9), ("T=L", 4, chunk, 6, None),
                                ("T=L+1", 4, chunk + 1, 6, None),
                                ("T=2L+1", 4, 2 * chunk + 1, 6, None),
                                ("T=1000", 4, 1000, 6, None),
                                ("C=13, T=700", 3, 700, 13, None)) + wide:
        base = rng.integers(0, C, (S, 1, 1))
        pi = np.where(np.arange(C)[None, None, :] == base, 1.0 - (C - 1) * 1e-6, 1e-6)
        if stay is None:  # coherent, as on the shard, with a chain break
            stay = np.exp(-rng.uniform(500, 3000, T - 1) / 10000.0)
            stay[rng.integers(0, T - 1)] = 0.0
        arrays = (rng.normal(-5.0, 3.0, (S, T, C)), np.broadcast_to(np.log(pi), (S, T, C)),
                  np.broadcast_to(stay, (max(T - 1, 0),)))
        out.append((name, *(torch.tensor(np.ascontiguousarray(a, np.float32), device=dev)
                            for a in arrays)))
    return out


def _ulp(x):
    """The float32 rounding step at each value of x (finite, float32)."""
    a = x.abs()
    return torch.nextafter(a, torch.full_like(a, float("inf"))) - a


def _hmm_errors(got, args, chunk):
    """The kernel's log posteriors against the three plain versions on the
    same inputs: the float64 and float32 sequential passes and the chunked
    plain version at the same chunk; and its argmax against float64's where
    float64's top two states differ by more than HMM_ARGMAX_GAP."""
    from gatk_tpu_torch.ops import cnv_hmm

    want64 = cnv_hmm.hmm_forward_backward_reference(*(a.double() for a in args))
    want32 = cnv_hmm.hmm_forward_backward_reference(*args)
    chunked = cnv_hmm.hmm_forward_backward_chunked_reference(*args, chunk=chunk)
    top2 = want64.topk(min(2, want64.shape[-1]), dim=-1).values
    clear = (top2[..., 0] - top2[..., -1] > HMM_ARGMAX_GAP) if want64.shape[-1] > 1 else \
        torch.ones(want64.shape[:-1], dtype=torch.bool, device=want64.device)
    return dict(finite=bool(torch.isfinite(got).all()),
                max_abs_err_f64=(got.double() - want64).abs().max().item(),
                max_abs_err_plain=(got - want32).abs().max().item(),
                plain_err_f64=(want32.double() - want64).abs().max().item(),
                max_abs_err_chunked=(got - chunked).abs().max().item(),
                chunked_excess=((got - chunked).abs() - HMM_CHUNKED_ULPS * _ulp(chunked)
                                ).max().item(),
                chunked_err_f64=(chunked.double() - want64).abs().max().item(),
                argmax_checked=int(clear.sum()),
                argmax_differs=int((got.argmax(-1) != want64.argmax(-1))[clear].sum()))


def _hmm_check(name, e):
    check(e["finite"], f"HMM kernel: non-finite log posteriors at {name}")
    check(e["max_abs_err_f64"] <= HMM_TOL_F64,
          f"HMM kernel at {name}: {e['max_abs_err_f64']} from float64 > {HMM_TOL_F64}")
    check(e["max_abs_err_plain"] <= e["plain_err_f64"] + HMM_TOL_F64,
          f"HMM kernel at {name}: {e['max_abs_err_plain']} from the float32 plain version > "
          f"{e['plain_err_f64']} + {HMM_TOL_F64}")
    check(e["chunked_excess"] <= HMM_TOL_CHUNKED,
          f"HMM kernel at {name}: |kernel - chunked plain| less {HMM_CHUNKED_ULPS} float32 "
          f"steps of the chunked plain value = {e['chunked_excess']} > {HMM_TOL_CHUNKED}")
    check(e["argmax_differs"] == 0,
          f"HMM kernel at {name}: {e['argmax_differs']} argmax states differ from float64's")


def phase_cnv_hmm(dev, model):
    """The HMM kernel on the posterior pass of the gcnv run's fitted shard and
    on the edge batches, against the float64 and float32 sequential plain
    versions and the chunked plain version; timed beside its bound, at every
    chunk of HMM_CHUNK_SWEEP, and profiled by kernel."""
    from gatk_tpu_torch.ops import _kernels, cnv_hmm

    chunk = _kernels.CNV_HMM_CHUNK
    with torch.no_grad():
        log_em = model._emission(model.params).contiguous()
        log_pi, stay = model._prior_and_trans()
    args = (log_em, log_pi.contiguous(), stay.contiguous())
    S, T, C = log_em.shape
    got, launches_per_pass = _kernels.cnv_hmm_launch(*args)
    shard = _hmm_errors(got, args, chunk)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    cnv_hmm.hmm_forward_backward_reference(*args)
    t1.record()
    t1.synchronize()
    plain_ms = t0.elapsed_time(t1)  # one call: the plain version takes seconds
    chunked_plain_ms = median_ms(
        lambda: cnv_hmm.hmm_forward_backward_chunked_reference(*args, chunk=chunk), reps=3,
        warmup=1)
    edges = []
    for name, *edge in _hmm_edge_cases(dev, chunk):
        e = dict(case=name, shape=list(edge[0].shape),
                 **_hmm_errors(_kernels.cnv_hmm(*edge), edge, chunk))
        if edge[0].shape[-1] in HMM_WIDE_STATES:  # a pass past 32 states, timed
            e["kernel_ms"] = median_ms(lambda: _kernels.cnv_hmm(*edge), reps=10, warmup=2)
            e.update(_hmm_bound(*edge[0].shape))
        edges.append(e)
    kernel_ms = median_ms(lambda: _kernels.cnv_hmm(*args), reps=30, warmup=3)
    sweep = {L: median_ms(lambda: _kernels.cnv_hmm(*args, chunk=L), reps=20, warmup=3)
             for L in HMM_CHUNK_SWEEP}
    reps = 10
    prof = _profile(lambda: [_kernels.cnv_hmm(*args) for _ in range(reps)],
                    kernels={k: [k] for k in HMM_KERNELS})
    by_kernel = {k: prof[f"device_{k}_ms"] / reps if isinstance(prof[f"device_{k}_ms"], float)
                 else "not measured" for k in HMM_KERNELS}
    profiled = prof["profiled_launches"]
    # the launches the kernel replaces: the plain version's on the shard's first
    # PLAIN_PROFILED intervals (a fixed number each), scaled to the pass
    n = min(T, PLAIN_PROFILED)
    head = (args[0][:, :n].contiguous(), args[1][:, :n].contiguous(), args[2][: n - 1].contiguous())
    plain = _profile(lambda: cnv_hmm.hmm_forward_backward_reference(*head))
    plain_launches = plain["profiled_launches"]
    per_pass = (round(plain_launches * T / n) if isinstance(plain_launches, int)
                else "not measured")
    err = max([shard["max_abs_err_chunked"]] + [e["max_abs_err_chunked"] for e in edges])
    res = dict(phase="cnv_hmm", samples=S, intervals=T, states=C, chunk=chunk,
               launches_per_pass=launches_per_pass,
               profiled_launches_per_pass=(profiled / reps if isinstance(profiled, int)
                                           else "not measured"),
               dependent_steps=_kernels.cnv_hmm_dependent_steps(T, chunk), shard=shard,
               edges=edges, max_abs_err=err, kernel_ms=kernel_ms, kernel_ms_by_chunk=sweep,
               device_ms_by_kernel=by_kernel, plain_ms=plain_ms,
               chunked_plain_ms=chunked_plain_ms, plain_launches_profiled=plain_launches,
               plain_intervals_profiled=n, plain_launches_per_pass=per_pass,
               step_us=kernel_ms * 1e3 / _kernels.cnv_hmm_dependent_steps(T, chunk),
               **_hmm_bound(S, T, C),
               latency_note="dependent steps per direction (2 L + P) set the kernel's time; "
                            "the bound assumes no step waits on the one before")
    emit(res)
    _hmm_check("the shard", shard)
    for e in edges:
        _hmm_check(e["case"], e)
    return res


@contextlib.contextmanager
def timing(module, name, dev, into):
    """Times every call of module.<name> between device synchronisations into
    into[name] (seconds, calls), and keeps the last call's arguments."""
    fn = getattr(module, name)
    rec = into.setdefault(name, dict(seconds=0.0, calls=0))

    def timed(*args, **kwargs):
        _sync(dev)
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        _sync(dev)
        rec["seconds"] += time.perf_counter() - t0
        rec["calls"] += 1
        rec["args"] = args
        return out

    setattr(module, name, timed)
    try:
        yield rec
    finally:
        setattr(module, name, fn)


def phase_somatic_cnv(dev, tmp):
    """The panel of normals (build_panel_of_normals, its SVD on the card) and
    denoise_sample in-process, the machine having no h5py for the panel's
    file; the denoised copy ratios written with write_sam_tsv; then
    ModelSegments --device cuda and CallCopyRatioSegments through the CLI."""
    from gatk_tpu_torch import cli
    from gatk_tpu_torch.cnv import mcmc, somatic
    from gatk_tpu_torch.utils import synthetic

    d = os.path.join(tmp, "somatic")
    t0 = time.perf_counter()
    case = synthetic.write_somatic_cnv_case(d, **SOMATIC_CASE)
    write_s = time.perf_counter() - t0
    timed = {}
    t_path = time.perf_counter()
    with timing(torch.linalg, "svd", dev, timed):
        pon = somatic.build_panel_of_normals(case["normal_counts"], case["intervals"], device=dev)
    pon_s = time.perf_counter() - t_path
    _, denoised = somatic.denoise_sample(pon, case["case_counts"])
    ivs = [case["intervals"][i] for i in pon.panel_interval_idx]
    header = ["@HD\tVN:1.6"] + [f"@SQ\tSN:{c}\tLN:{n}" for c, n in case["sq"]]
    cr = os.path.join(d, "case.denoised.tsv")
    rows = [(c, s, e, somatic.format_double(v)) for (c, s, e), v in zip(ivs, denoised)]
    somatic.write_sam_tsv(cr, "CASE", ["CONTIG", "START", "END", "LOG2_COPY_RATIO"], rows, header)
    denoise_s = time.perf_counter() - t_path - pon_s
    t0 = time.perf_counter()
    with timing(somatic, "segment_values", dev, timed), \
            timing(mcmc, "_copy_ratio_chain", dev, timed), \
            timing(mcmc, "_allele_fraction_chain", dev, timed):
        check(cli.main(["ModelSegments", "--denoised-copy-ratios", cr,
                        "--allelic-counts", case["allelic_counts"], "-O", d,
                        "--output-prefix", "case", *_device_flag(dev)]) == 0,
              "ModelSegments failed")
    model_segments_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    called = os.path.join(d, "case.called.seg")
    check(cli.main(["CallCopyRatioSegments", "-I", os.path.join(d, "case.cr.seg"),
                    "-O", called]) == 0, "CallCopyRatioSegments failed")
    call_s = time.perf_counter() - t0
    wall = time.perf_counter() - t_path
    model_rows = somatic.read_sam_tsv(os.path.join(d, "case.modelFinal.seg"))[3]
    calls = [r[-1] for r in somatic.read_sam_tsv(called)[3]]
    score = synthetic.score_somatic_segments(case, model_rows)

    # the SVD alone at the panel's shape, and each chain again under the profiler
    panel = timed["svd"]["args"][0]
    svd_ms = median_ms(lambda: torch.linalg.svd(panel, full_matrices=False), reps=5, warmup=1)
    chains = {}
    for name in ("_copy_ratio_chain", "_allele_fraction_chain"):
        _, *chain_args = timed[name]["args"]
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        profiled = _profile(lambda: getattr(mcmc, name)(gen, *chain_args))
        chains[name] = dict(seconds=timed[name]["seconds"], points=int(chain_args[0].numel()),
                            segments=chain_args[-3], sweeps=chain_args[-2] + chain_args[-1],
                            launches_profiled=profiled.pop("profiled_launches"), **profiled)
    res = dict(phase="somatic_cnv", normals=len(case["normals"]), panel_intervals=len(ivs),
               panel_shape=list(panel.shape), contigs=len(case["sq"]),
               hets=len(case["het_index"]), write_s=write_s, wall_s=wall, pon_s=pon_s,
               svd_s=timed["svd"]["seconds"], svd_ms=svd_ms, denoise_s=denoise_s,
               model_segments_s=model_segments_s,
               segmentation_s=timed["segment_values"]["seconds"], call_s=call_s,
               chains=chains, calls={c: calls.count(c) for c in "+-0"}, **score)
    emit(res)
    check(not score["breakpoints_missed"],
          f"planted breakpoints not found within {synthetic.BREAKPOINT_TOLERANCE} intervals: "
          f"{score['breakpoints_missed']}")
    check(score["log2_cr_max_err"] < SOMATIC_CR_TOL,
          f"a log2 copy-ratio median is {score['log2_cr_max_err']:.4f} off its planted value")
    check(score["maf_max_err"] < SOMATIC_MAF_TOL,
          f"a minor-allele-fraction median is {score['maf_max_err']:.4f} off its planted value")
    check(len(calls) == len(model_rows), "CallCopyRatioSegments did not call every segment")
    return res


def dense_turns(source):
    """Only the dense flow kernel against an earlier one (`source`, that
    commit's csrc/flow_pairhmm_dense.cu) in turns, on the pairs of the
    postcall phase's dense launch (FlowPairHMMAlignReadsToHaplotypes
    --flow-order OFF_RULE_ORDER on the flow sample's reads of
    OFF_RULE_WINDOW), with the launch's gates; then the postcall phase's wide
    case with its device route in turns with an L2-resident grid."""
    from gatk_tpu_torch.utils import synthetic

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        sample = synthetic.write_flow_sample(os.path.join(tmp, "flow"), **FLOW)
        d, haps, names = _postcall_haplotypes(tmp, sample)
        window, _ = _off_rule_window(d, sample)
        emit(dict(phase="dense_turns", source=source,
                  **_postcall_dense(d, window, haps, names, old_dense=source)))
        emit(dict(phase="dense_wide_l2", **_postcall_wide(d, window, sample, l2_turns=True)))


def main():
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--dense-turns", metavar="SOURCE",
                   help="run only the device phase and the dense flow kernel against the "
                        "earlier dense kernel of SOURCE in turns, then the result line")
    args = p.parse_args()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t_start = time.perf_counter()
    phase_device()
    if args.dense_turns:
        dense_turns(args.dense_turns)
        print(nvidia_smi_line(), flush=True)
        emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return
    k = phase_kernel(dev)
    var = phase_variants(dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        from gatk_tpu_torch.utils import synthetic

        t0 = time.perf_counter()
        sample = synthetic.write_sample(tmp, seed=0)
        emit(dict(phase="sample", contig_len=sample["length"], reads=sample["n_reads"],
                  variants=len(sample["variants"]), write_s=time.perf_counter() - t0))
        hc, kept_hc = phase_hc(sample, tmp)
        ramped = phase_ramped(sample, tmp, os.path.join(tmp, "out.vcf"))
        recaller = phase_recaller(sample, tmp)
        gvcf, kept_gvcf = phase_gvcf(sample, tmp)
        flow, flow_sample = phase_flow(tmp)
        trio = phase_trio(tmp)
        m2 = phase_mutect2(tmp)
        pre, pre_sample = phase_preprocess(tmp)
        dist = phase_distributed(dev, tmp, sample, pre_sample)
        _, callset = phase_vqsr(dev, tmp)
        postcall = phase_postcall(tmp, flow_sample, callset)
        gcnv, gcnv_model = phase_gcnv(dev, tmp, sample)
        hmm = phase_cnv_hmm(dev, gcnv_model)
        del gcnv_model
        phase_somatic_cnv(dev, tmp)
        main_launch = phase_main_launch(kept_hc)
        mat = phase_matrix(dev, kept_gvcf)
        phase_tools(tmp, sample)
    smi = nvidia_smi_line()

    # launches on each path, counted from 0 at its start; a kernel is timed at
    # the largest launch of the path it serves. No single PyTorch call computes
    # the PairHMM, the flow PairHMM or the HMM's forward-backward pass, so there
    # is no library time.
    path_counts = [(path, r["counts"]) for path, r in (
        ("hc", hc), ("gvcf", gvcf), ("mutect2", m2), ("variants", var), ("gcnv", gcnv),
        ("ramped", ramped), ("recaller", recaller), ("trio", trio), ("preprocess", pre),
        ("flow", flow), ("distributed", dist))]
    path_counts += [("distributed_hc", dist["hc_counts"]),
                    ("reads_pipeline_spark", dist["rps_counts"]),
                    ("postcall", _add_counts(_add_counts(postcall["flow"]["coset"]["counts"],
                                                         postcall["flow"]["dense"]["counts"]),
                                             postcall["flow"]["wide"]["counts"]))]

    def by_path(name):
        return {path: counts[name]["launches"] for path, counts in path_counts
                if name in counts}

    fwd_err = max(k["max_abs_err_bench"], k["max_abs_err_ragged"], main_launch["max_abs_err"],
                  *(r["largest_launch"]["max_abs_err"] for r in (m2, ramped, pre)),
                  *(v["max_abs_err_ragged"] for v in var["variants"] if not v["hap_n_mismatch"]))
    hapn_err = max(max(v["max_abs_err_bench"], v["max_abs_err_ragged"])
                   for v in var["variants"] if v["hap_n_mismatch"])
    gv = mat["cases"][-1]
    hapn = var["timed"]["hap_n_mismatch"]
    src = "gatk_tpu_torch/csrc/"
    tpu = "gatk_tpu/ops/pairhmm_tpu.py"
    kernels = [
        dict(name="pairhmm_fwd", route="cuda", source=src + "pairhmm_fwd.cu",
             replaces=f"{tpu}:746 (_pairhmm_kernel_v6, haplotype N scored as the host does), "
                      f"{tpu}:56 (_pairhmm_kernel, v1)",
             launches=hc["counts"]["pairhmm_fwd"]["launches"], launches_by_path=by_path(
                 "pairhmm_fwd"), max_abs_err=fwd_err, ms=main_launch["kernel_ms"],
             plain_ms=main_launch["plain_ms"], bound_ms=main_launch["bound_ms"],
             bound_by=main_launch["bound_by"], library_ms=None),
        dict(name="pairhmm_matrix", route="cuda", source=src + "pairhmm_matrix.cu",
             replaces=f"{tpu}:151 (_pairhmm_matrix_kernel)",
             launches=gvcf["counts"]["pairhmm_matrix"]["launches"],
             launches_by_path=by_path("pairhmm_matrix"),
             max_abs_err=max(mat["max_abs_err"], trio["largest_launch"]["max_abs_err"]),
             ms=gv["kernel_ms"], plain_ms=gv["plain_ms"], bound_ms=gv["bound_ms"],
             bound_by=gv["bound_by"], library_ms=None),
        dict(name="pairhmm_fwd_hap_n_mismatch", route="cuda", source=src + "pairhmm_fwd.cu",
             replaces=f"{tpu}:320 (_pairhmm_kernel_v2), {tpu}:445 (_pairhmm_kernel_v4), "
                      f"{tpu}:622 (_pairhmm_kernel_v5), {tpu}:857 (_pairhmm_kernel_v7), "
                      f"{tpu}:746 (_pairhmm_kernel_v6 with its own N rule)",
             launches=var["counts"]["pairhmm_fwd_hap_n_mismatch"]["launches"],
             launches_by_path=by_path("pairhmm_fwd_hap_n_mismatch"), max_abs_err=hapn_err,
             ms=hapn["kernel_ms"], plain_ms=hapn["plain_ms"], bound_ms=hapn["bound_ms"],
             bound_by=hapn["bound_by"], library_ms=None),
        dict(name="cnv_hmm", route="cuda", source=src + "cnv_hmm.cu",
             replaces="gatk_tpu/cnv/denoising.py:42 (_hmm_forward_backward under lax.scan; "
                      "not a Pallas kernel)",
             launches=gcnv["counts"]["cnv_hmm"]["launches"], launches_by_path=by_path("cnv_hmm"),
             launches_per_pass=(gcnv["counts"]["cnv_hmm"]["launches"]
                                / gcnv["counts"]["cnv_hmm"]["passes"]),
             max_abs_err=hmm["max_abs_err"],
             max_abs_err_f64=max([hmm["shard"]["max_abs_err_f64"]]
                                 + [e["max_abs_err_f64"] for e in hmm["edges"]]),
             ms=hmm["kernel_ms"], plain_ms=hmm["plain_ms"],
             bound_ms=hmm["bound_ms"], bound_by=hmm["bound_by"], library_ms=None),
    ]
    fl = flow["largest_launch"]
    kernels.append(dict(
        name="flow_pairhmm", route="cuda", source=src + "flow_pairhmm.cu",
        replaces="gatk_tpu/ops/flow_pairhmm.py:116 (flow_pairhmm_batch_jax under lax.scan; "
                 "not a Pallas kernel)",
        design="a warp a pair on the coset lattice, prior gathered in the kernel",
        launches=flow["counts"]["flow_pairhmm"]["launches"],
        launches_by_path=by_path("flow_pairhmm"), max_abs_err=fl["max_abs_err"],
        ms=fl["kernel_ms"], plain_ms=fl["plain_ms"], dense_plain_ms=fl["dense_plain_ms"],
        bound_ms=fl["bound_ms"], bound_by=fl["bound_by"], rows=fl["rows"],
        us_per_row=fl["us_per_row"], library_ms=None,
        postcall_launch=dict((k, postcall["flow"]["coset"][k]) for k in (
            "pairs", "max_abs_err", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
            "dense_kernel")),
        dense_kernel_in_turns=fl["dense_kernel"]))
    fd, fw = postcall["flow"]["dense"], postcall["flow"]["wide"]
    kernels.append(dict(
        name="flow_pairhmm_dense", route="cuda", source=src + "flow_pairhmm_dense.cu",
        replaces="gatk_tpu/ops/flow_pairhmm.py:116 (flow_pairhmm_batch_jax under lax.scan, "
                 "for flow orders that do not repeat with period 4 and haplotypes past the "
                 "coset kernel's width; not a Pallas kernel)",
        design="gatk_tpu's dense scan as the sum of each pair's live coset lattices, a warp "
               "a lattice after a plan on the card, prior gathered in the kernel",
        launches=by_path("flow_pairhmm_dense")["postcall"],
        launches_by_path=by_path("flow_pairhmm_dense"),
        max_abs_err=max(fd["max_abs_err"], fw["max_abs_err"]), ms=fd["kernel_ms"],
        plain_ms=fd["plain_ms"], bound_ms=fd["bound_ms"], bound_by=fd["bound_by"],
        dense_count_bound_ms=fd["dense_count_bound_ms"], live_cells=fd["live_cells"],
        state_route=fd["route"], rows=fd["rows"], us_per_row=fd["us_per_row"], library_ms=None,
        wide_launch=dict((k, fw[k]) for k in (
            "pairs", "Hp", "max_abs_err", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
            "dense_count_bound_ms", "live_cells", "route", "slots"))))
    for kd in kernels:
        kd["max_abs_diff"] = kd["max_abs_err"]
    total_s = time.perf_counter() - t_start
    emit(dict(phase="total", seconds=total_s))
    print(f"total {total_s:.1f} s", file=sys.stderr)
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
