# Copied verbatim from gatk_tpu/utils/stopwatch.py; only import lines may differ.
"""Per-stage wall-clock accumulators for the calling pipeline.

Reference behavior: utils/pairhmm/PairHMM.java:123-127,239-245 keeps nanoTime
counters (pairHMMComputeTime) reported at shutdown; VectorLoglessPairHMM.java:41
adds setup-time counters. Here every pipeline stage gets one: the engine wraps
each phase in `with STAGES.stage("assembly"): ...` and bench.py / tools report
the breakdown. Thread-safe; stage sums across worker threads can exceed wall
time (they measure CPU-stage occupancy, not the critical path).
"""
from __future__ import annotations

import threading
import time
from collections import defaultdict
from contextlib import contextmanager


class StageTimers:
    def __init__(self):
        self._lock = threading.Lock()
        self.seconds = defaultdict(float)
        self.counts = defaultdict(int)

    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.seconds[name] += dt
                self.counts[name] += 1

    def add(self, name: str, dt: float):
        with self._lock:
            self.seconds[name] += dt
            self.counts[name] += 1

    def reset(self):
        with self._lock:
            self.seconds.clear()
            self.counts.clear()

    def snapshot(self) -> dict:
        """{stage: {"s": seconds, "n": count}} sorted by descending time."""
        with self._lock:
            return {
                k: {"s": round(self.seconds[k], 3), "n": self.counts[k]}
                for k in sorted(self.seconds, key=self.seconds.get, reverse=True)
            }

    def report(self) -> str:
        snap = self.snapshot()
        return " | ".join(f"{k}={v['s']:.2f}s/{v['n']}" for k, v in snap.items())


# process-global pipeline timers (reset by bench/tools before a measured run)
STAGES = StageTimers()
