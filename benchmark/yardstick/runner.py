"""A whole run of one cell, as run.py drives it: set-up, the window, the
judgement and the result's line, with the lines printed before it."""
from __future__ import annotations

import json
import shutil
import statistics
import sys
import tempfile
import time

import torch

from . import catalog, core


def _device(device, run):
    if device == "cuda":
        return dict(platform="gpu", kind=torch.cuda.get_device_name(0), count=1,
                    memory_peak_bytes=run.memory_peak_bytes)
    return dict(platform="cpu", kind="cpu", count=1, memory_peak_bytes=0)


def _pass_medians(run, n_shards):
    """Median call wall of the first pass over the pool and of the later
    passes: a data cache that outlived a call would make the later faster."""
    first = [c["wall"] for c in run.calls[:n_shards]]
    later = [c["wall"] for c in run.calls[n_shards:]]
    return (statistics.median(first) if first else None,
            statistics.median(later) if later else None)


def execute(name, seed, seconds, trace, t_start, device="cuda", mode="program",
            root=catalog.ROOT, bench_dir=catalog.BENCH_DIR, cell=None, emit=print):
    """Run cell `name`; `emit` gets each earlier line. Returns (result, rows):
    the result's dict, its checks last, and the rows (name, value, limit, ok)
    compared."""
    cell = cell or catalog.cell(name, root, bench_dir)
    tmp = tempfile.mkdtemp(prefix="bench-")
    try:
        before = time.perf_counter() - t_start
        sample, facts = core.setup(cell, seed, device, tmp)
        facts["before_setup_s"] = before
        capture = core.Capture(seed, mode=mode, trace=trace)
        setup_s = time.perf_counter() - t_start
        facts["setup_s"] = setup_s
        emit(json.dumps({"setup": facts}))
        run = core.window(cell, sample, seconds, device, tmp, capture, trace=trace,
                          alter_records=mode == "records_altered")
        run.setup_s = setup_s
        emit(json.dumps({"nvidia_smi": run.nvidia_smi}))
        from gatk_tpu_torch.calling import read_prep

        first, later = _pass_medians(run, len(sample.shards))
        emit(json.dumps({"caches": {
            "module_state": {"read_prep._PCR_CACHE": sorted(map(str, read_prep._PCR_CACHE))},
            "pool_shards": len(sample.shards), "first_pass_median_s": first,
            "later_pass_median_s": later}}))
        emit(json.dumps({"calls": len(run.calls), "window_s": run.window_s,
                         "card_ms": run.card_ms,
                         "shards": [c["shard"] for c in run.calls],
                         "walls": [c["wall"] for c in run.calls],
                         "cpu_s": [c["cpu"] for c in run.calls],
                         "records": [c["text"].count("\n") - c["text"].count("\n#")
                                     for c in run.calls],
                         "reads": [c["reads"] for c in run.calls]}))
        emit(json.dumps({"counts": run.counts, "stages": run.stages, "spans": run.spans}))
        for c in run.calls:
            if c["rc"] != 0:
                print(f"call on shard {c['shard']} failed: {c['rc']}\n{c['said'][-4000:]}",
                      file=sys.stderr)
                break
        correct, nums, rows, totals = core.judge_run(cell, sample, run, capture, seed, device)
        emit(json.dumps({"numbers": nums, "totals": totals}))
        entries = cell["per_layer"] if trace else cell["end_to_end"]
        metrics = catalog.read_metrics(entries, run, bench_dir)
        dev = _device(device, run)
        result = dict(correct=correct, attempted=len(run.calls),
                      failed=sum(1 for c in run.calls if c["rc"] != 0), metrics=metrics,
                      device=dev)
        if trace and run.trace is not None:
            dev["busy_s"] = run.trace["busy_ns"] / 1e9
            dev["window_s"] = run.trace["window_ns"] / 1e9
            result["breakdown"] = dict(
                device_ops=[[n[:200], ns / 1e9] for n, ns in run.trace["device_ops"][:10]],
                idle_gaps=[[n, ns / 1e9] for n, ns in run.trace["idle"][:10]])
        result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim, _ in rows}
        return result, rows
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
