"""Driver entry points of the port: the pair kernel on one device, and a dry run
of data-parallel calling over several. The counterpart of __graft_entry__.py
at the repository root, with its numpy draws from the same seeds."""
from __future__ import annotations

import numpy as np
import torch

from .devices import resolve_device


def _check(cond, msg):
    if not cond:
        raise RuntimeError(f"dry run: {msg}")


def _example_batch(n_reads=8, n_haps=4, R=120, H=200, n_pairs=256):
    """__graft_entry__._example_batch's reads and haplotypes, packed by the
    port's pack_batch: (packed, rp, hmax)."""
    rng = np.random.default_rng(0)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    haps = []
    master = bases[rng.integers(0, 4, H)]
    for _ in range(n_haps):
        h = master.copy()
        h[rng.integers(0, H, 2)] = bases[rng.integers(0, 4, 2)]
        haps.append(h.tobytes())
    reads = []
    for k in range(n_reads):
        h = np.frombuffer(haps[k % n_haps], np.uint8)
        s = int(rng.integers(0, H - R))
        rb = h[s : s + R].copy()
        rb[rng.integers(0, R, 2)] = bases[rng.integers(0, 4, 2)]
        reads.append(
            dict(
                bases=rb.tobytes(),
                rq=rng.integers(20, 40, R).astype(np.uint8),
                iq=np.full(R, 45, np.uint8),
                dq=np.full(R, 45, np.uint8),
                gcp=np.full(R, 10, np.uint8),
            )
        )
    ri = np.tile(np.arange(n_reads), n_pairs // n_reads)[:n_pairs]
    hi = np.repeat(np.arange(n_haps), n_pairs // n_haps)[:n_pairs]
    from .ops import pairhmm

    packed, rp, hmax, n = pairhmm.pack_batch(reads, haps, ri, hi)
    return packed, rp, hmax


def entry(device=None):
    """(fn, args): the flagship compute path's step, the pair kernel entry with
    gatk_tpu's v6 rules (parallel/mesh.PAIR_ENTRY), and its example pools and
    pairs on `device` (the default device, CUDA, when None). fn(*args) gives
    the (n_pairs,) float32 log10 likelihoods."""
    from .ops import pairhmm
    from .parallel import mesh

    packed, rp, hmax = _example_batch()
    return mesh.PAIR_ENTRY, pairhmm.from_jax_packed(packed, device=resolve_device(device))


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """The data-parallel calling step over n_devices devices (the first local
    CUDA devices unless `devices` is given) on tiny shapes: the sharded pair
    kernel, the BQSR histogram reduction, then sharded calling."""
    from .parallel import mesh as pmesh

    devices = pmesh.make_mesh(n_devices) if devices is None else list(devices)
    _check(len(devices) == n_devices, f"{len(devices)} devices for n_devices={n_devices}")
    packed, rp, hmax = _example_batch(n_pairs=128 * n_devices)
    packed = pmesh.pad_pairs_to_devices(packed, packed["rbase"].shape[1], n_devices)
    out = pmesh.pairhmm_sharded(devices, packed, rp, hmax).cpu().numpy()
    _check(out.shape == (1, packed["rbase"].shape[1]), f"sharded output of shape {out.shape}")
    _check(np.isfinite(out).all(), "the sharded pair kernel gave non-finite likelihoods")

    # global reduction path (BQSR-style histogram, summed over the devices)
    rng = np.random.default_rng(1)
    n = 1024 * n_devices
    keys = rng.integers(0, 64, n).astype(np.int32)
    errors = rng.random(n).astype(np.float32)
    obs, errs = pmesh.bqsr_histogram_step(devices, keys, errors, 64)
    _check(obs.sum().item() == n, f"the histogram counts {obs.sum().item()} of {n} keys")

    # full distributed CALLING step: the interval-shard scheduler over the
    # devices - activity -> assembly -> per-region PairHMM round-robined onto
    # every device -> genotyping -> coordinate-sorted gather
    _dryrun_sharded_calling(n_devices, devices)


def _dryrun_sharded_calling(n_devices: int, devices=None) -> None:
    """A 600 bp synthetic contig with het SNPs at 200 and 400, called by
    ShardedCaller over the devices; both sites must be called."""
    from .calling import hc_engine
    from .engine.intervals import Interval
    from .io.reads import Read
    from .parallel.mesh import make_mesh
    from .parallel.scheduler import ShardedCaller, split_interval_shards

    rng = np.random.default_rng(7)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    L = 600
    ref_arr = bases[rng.integers(0, 4, L)]

    class _Ref:
        def contig_length(self, c):
            return L

        def fetch(self, c, s, e):
            return ref_arr[s:e]

    # two het SNP sites on a synthetic contig
    alt = ref_arr.copy()
    alt[200] = bases[(np.searchsorted(bases, alt[200]) + 1) % 4]
    alt[400] = bases[(np.searchsorted(bases, alt[400]) + 1) % 4]
    reads = []
    rl = 100
    for k in range(120):
        pos = int(rng.integers(0, L - rl))
        src = alt if k % 2 else ref_arr
        rb = src[pos : pos + rl].copy()
        reads.append(Read(
            name=f"r{k}", flag=0 if k % 4 < 2 else 16, ref_id=0, pos=pos, mapq=60,
            cigar_ops=np.array([0], np.uint8), cigar_lens=np.array([rl], np.int32),
            bases=rb, quals=np.full(rl, 30, np.uint8),
            mate_ref_id=-1, mate_pos=-1, tlen=0, tags={},
        ))
    reads.sort(key=lambda r: r.pos)

    engine = hc_engine.HaplotypeCallerEngine(_Ref(), "S", hc_engine.HCArgs())
    devices = make_mesh(n_devices) if devices is None else [torch.device(d) for d in devices]
    _check(len(devices) == n_devices, f"{len(devices)} devices for n_devices={n_devices}")
    caller = ShardedCaller(engine, devices)
    shards = split_interval_shards([Interval("syn", 0, L)], n_devices)
    _check(sum(len(s) for s in shards) >= 1, "no interval shard")
    variants = caller.call_targets(lambda iv: reads, [Interval("syn", 0, L)],
                                   contig_order=["syn"])
    called = {v.pos for v in variants}
    _check({200, 400} <= called, f"sharded calling missed sites: {called}")
