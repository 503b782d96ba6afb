"""Interval-shard scheduler: end-to-end calling over the local CUDA devices.

Port of gatk_tpu/parallel/scheduler.py. Active-region detection runs once over
each target interval on the host; host assembly of each region then feeds a
pooled PairHMM batcher per device (regions round-robined over the devices),
and regions are genotyped in coordinate order, so one-device and many-device
runs give identical VCFs. split_interval_shards gives contiguous target shards
for a per-process scatter-gather.
"""
from __future__ import annotations

import torch


def split_interval_shards(targets, n_shards: int):
    """Split target intervals into n_shards contiguous chunks of ~equal bp
    (SplitIntervals.java:77 INTERVAL_SUBDIVISION semantics: split by base count,
    never joining across target gaps). Returns list of lists of Interval."""
    from ..engine.intervals import Interval

    total = sum(t.end - t.start for t in targets)
    if total == 0 or n_shards <= 1:
        return [list(targets)]
    per = -(-total // n_shards)
    shards = []
    cur = []
    room = per
    for t in targets:
        s = t.start
        while s < t.end:
            take = min(room, t.end - s)
            cur.append(Interval(t.contig, s, s + take))
            s += take
            room -= take
            if room == 0 and len(shards) < n_shards - 1:
                shards.append(cur)
                cur = []
                room = per
    if cur:
        shards.append(cur)
    return shards


def _fault_injection_hook(target, attempt):
    """Test-only fault injection: GATK_TPU_FAULT_INJECT="contig:start:n_fails"
    makes the matching shard's first n_fails attempts raise, exercising the
    retry path end-to-end without patching internals."""
    import os
    spec = os.environ.get("GATK_TPU_FAULT_INJECT")
    if not spec:
        return
    contig, start, n_fails = spec.split(":")
    if target.contig == contig and target.start == int(start) and \
            attempt < int(n_fails):
        raise RuntimeError(f"injected fault on {target} attempt {attempt}")


def cuda_devices():
    """All local CUDA devices; raises when there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass devices=[torch.device('cpu')] "
            "(HaplotypeCaller --device cpu) to run the plain PyTorch PairHMM on the host")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class ShardedCaller:
    """Schedules per-region calling work across devices.

    engine: HaplotypeCallerEngine (or any engine exposing plan_interval /
    prepare_region / finish_region). devices: torch devices to round-robin
    PairHMM batches onto; defaults to every local CUDA device and raises when
    there is none, unless the caller passes [torch.device("cpu")].
    """

    def __init__(self, engine, devices=None, host_threads: int | None = None):
        if host_threads is None:
            # assembly/SW/finalize spend most of their time in native code that
            # releases the GIL, and threads also hide device round-trips; cap at
            # 6 to bound memory for live regions
            import os
            try:
                cpus = len(os.sched_getaffinity(0))  # respects taskset pinning
            except AttributeError:  # pragma: no cover - non-linux
                cpus = os.cpu_count() or 2
            host_threads = max(2, min(6, 2 * cpus))
        self.engine = engine
        self.devices = [torch.device(d) for d in devices] if devices is not None else cuda_devices()
        from ..ops.pairhmm import PoolBatcher
        # one pooled cross-region dispatcher per device: regions' read x hap
        # pairs aggregate into large launches (uint8 pools on the device,
        # gathered in the kernel), round-robined across the devices
        self.batchers = [PoolBatcher(device=d) for d in self.devices]
        # host assembly threads: regions assemble concurrently on CPU while
        # earlier regions' PairHMM batches run on the device. finish_region
        # stays serialized in region order so the shared seeded RNG (QD jitter)
        # and output ordering are identical to the sequential path.
        self.host_threads = max(1, host_threads)

    def call_interval(self, reads, interval):
        """Full pipeline on one interval: parallel host prepare feeding pooled
        per-device PairHMM dispatch, then in-order genotyping.
        Returns (variants, summaries) identical to engine.call_interval."""
        from concurrent.futures import ThreadPoolExecutor

        from ..calling.hc_engine import AssemblyRegionCall, read_bounds_of

        usable, spans = self.engine.plan_interval(reads, interval)
        variants = []
        summaries = []
        bounds = read_bounds_of(usable)
        # windowed consume: genotype window w while the pool threads assemble
        # w+1 and the device runs its flushed batches — bounds live preps to
        # ~WINDOW regions instead of the whole interval (memory), while
        # keeping finish_region strictly in region order (shared seeded RNG).
        WINDOW = 64
        with ThreadPoolExecutor(max_workers=self.host_threads) as pool:
            futures = [
                [span, pool.submit(
                    self.engine.prepare_region, usable, span,
                    batcher=self.batchers[i % len(self.batchers)],
                    read_bounds=bounds)]
                for i, span in enumerate(spans)
            ]
            idx = 0
            n = len(futures)
            while idx < n:
                hi = min(idx + WINDOW, n)
                window = [(f[0], f[1].result()) for f in futures[idx:hi]]
                for f in futures[idx:hi]:
                    f[1] = None  # release the Future's reference to the prep
                # materialize this window's handles: flush whatever is pooled
                # (later windows' already-assembled regions ride along)
                for b in self.batchers:
                    b.flush()
                for span, prep in window:
                    if prep is None:
                        summaries.append(AssemblyRegionCall(span, span, 0, 0))
                        continue
                    v, summary = self.engine.finish_region(prep)
                    variants.extend(v)
                    summaries.append(summary)
                idx = hi
        variants = [v for v in variants if interval.start <= v.pos < interval.end]
        return variants, summaries

    # per-shard failure containment: transient device/host errors on one shard
    # retry with fresh state instead of killing the whole traversal; after the
    # last attempt the last error is re-raised.
    SHARD_MAX_ATTEMPTS = 3

    def _call_interval_with_retry(self, read_source, target):
        import logging
        last = None
        for attempt in range(self.SHARD_MAX_ATTEMPTS):
            try:
                reads = read_source(target)
                _fault_injection_hook(target, attempt)
                return self.call_interval(reads, target)
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception as e:  # transient device/host failure: retry shard
                last = e
                logging.getLogger("gatk_tpu_torch").warning(
                    "shard %s attempt %d/%d failed: %s", target, attempt + 1,
                    self.SHARD_MAX_ATTEMPTS, e)
        raise last

    def call_targets(self, read_source, targets, contig_order=None):
        """Scatter-gather over many target intervals: per-target region planning,
        device round-robin within each target, then a coordinate-sorted gather.

        read_source: fn(interval) -> coordinate-sorted reads overlapping it.
        Returns a coordinate-sorted variant list.
        """
        order = {c: i for i, c in enumerate(contig_order)} if contig_order else None
        per_shard = []
        for target in targets:
            variants, _ = self._call_interval_with_retry(read_source, target)
            per_shard.append((target, variants))
        out = []
        for target, variants in per_shard:
            out.extend(sorted(variants, key=lambda v: v.pos))
        if order is not None:
            out.sort(key=lambda v: (order.get(v.contig, 1 << 30), v.pos))
        return out
