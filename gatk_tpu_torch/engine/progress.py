# Copied verbatim from gatk_tpu/engine/progress.py; only import lines may differ.
"""ProgressMeter: periodic throughput reporting.

Reference: engine/ProgressMeter.java:26,248-261 — INFO lines every
--seconds-between-progress-updates (default 10s) with elapsed minutes, records
processed, records/minute, and the current locus; a final summary line on
completion. This implementation adds an optional GCUPS-style extra column so
kernels can report device throughput (PairHMM.java:123-127 profiling counters).
"""
from __future__ import annotations

import sys
import time

DEFAULT_SECONDS_BETWEEN_UPDATES = 10.0


class ProgressMeter:
    def __init__(self, label: str = "Traversal", unit: str = "records",
                 seconds_between_updates: float = DEFAULT_SECONDS_BETWEEN_UPDATES,
                 out=None):
        self.label = label
        self.unit = unit
        self.interval = seconds_between_updates
        self.out = out or sys.stderr
        self._n = 0
        self._start = None
        self._last_print = None
        self._current_locus = ""
        self._started = False

    def start(self):
        self._start = self._last_print = time.time()
        self._started = True
        print(f"INFO  ProgressMeter - Starting {self.label} traversal", file=self.out)
        print(f"INFO  ProgressMeter -        Current Locus  Elapsed Minutes     "
              f"{self.unit.capitalize()} Processed   {self.unit.capitalize()}/Minute",
              file=self.out)
        return self

    def update(self, locus: str = "", n: int = 1):
        """Record n processed units; prints a line when the interval elapsed."""
        if not self._started:
            self.start()
        self._n += n
        if locus:
            self._current_locus = locus
        now = time.time()
        if now - self._last_print >= self.interval:
            self._print_line(now)
            self._last_print = now

    def _print_line(self, now):
        minutes = (now - self._start) / 60.0
        rate = self._n / minutes if minutes > 0 else float(self._n)
        print(f"INFO  ProgressMeter - {self._current_locus:>20} {minutes:16.1f} "
              f"{self._n:21d} {rate:14.1f}", file=self.out)

    def stop(self):
        if not self._started:
            return
        now = time.time()
        self._print_line(now)
        minutes = (now - self._start) / 60.0
        print(f"INFO  ProgressMeter - {self.label} complete. Processed {self._n} "
              f"total {self.unit} in {minutes:.1f} minutes.", file=self.out)
        self._started = False

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
