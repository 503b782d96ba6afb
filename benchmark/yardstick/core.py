"""One run of a cell: set-up, the window of scatter calls through the port's
CLI, the reading of its trace, and the judgement of what it wrote.

The window is a closed loop with one caller: each call runs the cell's tool
over one shard of the pool (-L contig:start-end, a scatter unit as GATK's
scatter-gather WDLs run it), builds its engine anew and ends in a device
synchronisation; calls start until the window's seconds have passed, and the
call in flight then finishes inside the window. The pool cycles.

The PairHMM entries (ops/pairhmm.pairhmm_pairs and pairhmm_matrix) are
wrapped for the whole window: each launch is timed on the card by a pair of
CUDA events around it, and its output and inputs of a seeded sample of its
pairs are gathered on the device, without a synchronisation, and judged
after the window against the plain PairHMM. `mode` puts the
control (the plain PairHMM in bfloat16) or a fault in the program's place.
"""
from __future__ import annotations

import contextlib
import gc
import io
import os
import subprocess
import sys
import threading
import time
import traceback
from types import SimpleNamespace

import numpy as np
import torch

from . import gen, judge, plain_pairhmm, readside, roofline

E_OFF = 16  # bottom padding rows of the kernels' packed haplotypes (ops/pairhmm.py)
FORBIDDEN = ("jax", "jaxlib", "flax", "gatk_tpu")
SAMPLE_PER_LAUNCH = 64
SAMPLE_MAX = 4096
MODES = ("program", "control", "half_batch", "records_altered")


def forbidden_modules():
    """Top-level names in sys.modules that a run may not load, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def nvidia_smi():
    query = "name,power.limit,clocks.sm,clocks.max.sm,power.draw,temperature.gpu"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return {"query": query, "error": repr(e)}
    return {"query": query, "lines": out.stdout.strip().splitlines()}


def _sync(device):
    if device == "cuda":
        torch.cuda.synchronize()


# --------------------------------------------------------------------------- launches


def pair_arrays(pools, r, h):
    """The plain form of pairs (read column r[k], haplotype column h[k]) of the
    kernels' packed pools: read tables hold read base k in row k + 1; a
    haplotype's base k sits at row E_OFF + rp + hmax - 2 - k of e."""
    rp = pools.rbase.shape[0]
    hmax = pools.e.shape[0] - 2 * rp - E_OFF
    rows = E_OFF + rp + hmax - 2 - torch.arange(hmax, device=pools.e.device)
    out = {k: getattr(pools, src)[1:, r].t() for k, src in
           (("rb", "rbase"), ("rq", "rq"), ("iq", "iq"), ("dq", "dq"), ("gcp", "gcp"))}
    out["rlen"] = pools.rlen[r]
    out["hb"] = pools.e[rows][:, h].t()
    out["hlen"] = pools.hlen[h]
    return out


def _pad_cat(parts, key):
    width = max(p[key].shape[1] for p in parts)
    return torch.cat([torch.nn.functional.pad(p[key], (0, width - p[key].shape[1]))
                      for p in parts])


def stack_pairs(parts):
    """One dict of (P, ...) tensors from per-launch pair_arrays dicts."""
    out = {k: _pad_cat(parts, k) for k in ("rb", "rq", "iq", "dq", "gcp", "hb")}
    out["rlen"] = torch.cat([p["rlen"] for p in parts])
    out["hlen"] = torch.cat([p["hlen"] for p in parts])
    return out


class Capture:
    """Wraps the PairHMM entries for a window. Keeps, per launch, its kind,
    pairs, output and a seeded sample of its pairs on the device, and on the
    card the CUDA events before and after the launch (the gather comes after
    the second); with `trace`, its cells as a device scalar and its bytes,
    for its bound."""

    def __init__(self, seed, mode="program", trace=False):
        if mode not in MODES:
            raise ValueError(f"mode {mode!r} is not one of {MODES}")
        self.rng = np.random.default_rng(seed)
        self.mode = mode
        self.trace = trace
        self.launches = []
        self._lock = threading.Lock()
        self._saved = None
        self._events = []

    def _replace(self, kind, pools, ri, hi, orig):
        """The output the mode puts in the kernels' place."""
        if self.mode == "control":
            if kind == "pairhmm_fwd":
                r, h = ri.long(), hi.long()
            else:
                nr, nh = pools.rbase.shape[1], pools.e.shape[1]
                r = torch.arange(nr, device=pools.rbase.device).repeat(nh)
                h = torch.arange(nh, device=pools.rbase.device).repeat_interleave(nr)
            vals = plain_pairhmm.log10_likelihoods(**pair_arrays(pools, r, h),
                                                   dtype=torch.bfloat16)
            out = vals.to(torch.float32)
            return out if kind == "pairhmm_fwd" else out.reshape(pools.e.shape[1], -1)
        out = orig()
        if self.mode == "half_batch":  # half the pairs left out, the mean taken over the rest
            flat = out.reshape(-1)
            k = flat.numel() // 2
            if k:
                flat[k:] = flat[:k].mean()
        return out

    def _timed(self, pools, launch):
        """launch() between two CUDA events on the current stream."""
        if pools.rbase.device.type != "cuda":
            return launch()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = launch()
        end.record()
        with self._lock:
            self._events.append((start, end))
        return out

    def card_ms(self):
        """Card time of the launches, ms, by their events; None without any.
        Call once the device has finished them."""
        if not self._events:
            return None
        return sum(start.elapsed_time(end) for start, end in self._events)

    def _keep(self, kind, pools, ri, hi, out):
        with torch.profiler.record_function("bench:capture"):
            self._gather(kind, pools, ri, hi, out)

    def _gather(self, kind, pools, ri, hi, out):
        n = out.numel()
        dev = out.device
        with self._lock:
            idx = np.sort(self.rng.choice(n, min(n, SAMPLE_PER_LAUNCH), replace=False))
        p = torch.from_numpy(idx).to(dev)
        if kind == "pairhmm_fwd":
            r, h = ri[p].long(), hi[p].long()
        else:
            nr = pools.rbase.shape[1]
            r, h = p % nr, p // nr
        rec = dict(kind=kind, n=n, sample=pair_arrays(pools, r, h), values=out.reshape(-1)[p])
        if self.trace:
            if kind == "pairhmm_fwd":
                rec["cells"] = (pools.rlen[ri.long()].long() * pools.hlen[hi.long()].long()).sum()
                extra = 8 * n
            else:
                rec["cells"] = pools.rlen.long().sum() * pools.hlen.long().sum()
                extra = 0
            rec["in_bytes"] = sum(t.numel() * t.element_size() for t in pools) + extra
            rec["out_bytes"] = 4 * n
        with self._lock:
            self.launches.append(rec)

    def install(self):
        from gatk_tpu_torch.ops import pairhmm

        pairs, matrix = pairhmm.pairhmm_pairs, pairhmm.pairhmm_matrix
        self._saved = (pairs, matrix)

        def fwd(pools, ri, hi):
            out = self._timed(pools, lambda: self._replace("pairhmm_fwd", pools, ri, hi,
                                                           lambda: pairs(pools, ri, hi)))
            self._keep("pairhmm_fwd", pools, ri, hi, out)
            return out

        def mat(pools):
            out = self._timed(pools, lambda: self._replace("pairhmm_matrix", pools, None, None,
                                                           lambda: matrix(pools)))
            self._keep("pairhmm_matrix", pools, None, None, out)
            return out

        pairhmm.pairhmm_pairs, pairhmm.pairhmm_matrix = fwd, mat

    def uninstall(self):
        from gatk_tpu_torch.ops import pairhmm

        if self._saved is not None:
            pairhmm.pairhmm_pairs, pairhmm.pairhmm_matrix = self._saved
            self._saved = None

    def samples(self, seed):
        """(stacked pair arrays on the host, the program's values) of at most
        SAMPLE_MAX sampled pairs, drawn from `seed`."""
        if not self.launches:
            return None, np.zeros(0)
        parts = [{k: v.cpu() for k, v in rec["sample"].items()} for rec in self.launches]
        values = torch.cat([rec["values"].float().cpu() for rec in self.launches]).numpy()
        pairs = stack_pairs(parts)
        if len(values) > SAMPLE_MAX:
            keep = np.sort(np.random.default_rng(seed).choice(len(values), SAMPLE_MAX,
                                                              replace=False))
            t = torch.from_numpy(keep)
            pairs = {k: v[t] for k, v in pairs.items()}
            values = values[keep]
        return pairs, values

    def bounds(self):
        """Each traced launch's kind and least time on the card."""
        out = []
        for rec in self.launches:
            b = roofline.bound(int(rec["cells"].item()), rec["in_bytes"], rec["out_bytes"])
            out.append(dict(kind=rec["kind"], pairs=rec["n"], **b))
        return out


# --------------------------------------------------------------------------- faults


def _alter_line(line):
    """A record altered where it is written: its position one base on, and a
    base added to its first ALT unless that is symbolic."""
    f = line.split("\t")
    f[1] = str(int(f[1]) + 1)
    alts = f[4].split(",")
    if not alts[0].startswith("<"):
        alts[0] += "A"
    f[4] = ",".join(alts)
    return "\t".join(f)


@contextlib.contextmanager
def records_altered():
    """Every record a call writes altered where the VCF writer writes it; a
    call that found nothing writes, altered, a heterozygous SNV at its
    shard's first base (state.site, set before each call) in its place."""
    from gatk_tpu_torch.io import vcf

    close = vcf.VcfWriter.close
    state = SimpleNamespace(site=None)

    def altered(self):
        lines = [ln if ln.startswith("#") else _alter_line(ln) for ln in self._lines]
        if all(ln.startswith("#") for ln in lines) and state.site is not None:
            contig, pos = state.site
            lines.append(f"{contig}\t{pos}\t.\tA\tC\t50\tPASS\t.\tGT\t0/1")
        self._lines = lines
        return close(self)

    vcf.VcfWriter.close = altered
    try:
        yield state
    finally:
        vcf.VcfWriter.close = close


# --------------------------------------------------------------------------- tracing


def _all_threads():
    """The profiler's setting that records the ranges of every thread (the
    program's worker threads too), where this PyTorch has it."""
    from torch._C._profiler import _ExperimentalConfig

    try:
        return _ExperimentalConfig(profile_all_threads=True)
    except TypeError:
        return None


@contextlib.contextmanager
def traced(device):
    """Host ranges for the trace: each STAGES stage of the program as
    stage:<name>, Mutect2's region preparation and finish as spans of the
    benchmark's own (span:m2.prepare_region, span:m2.finish_region), whose
    seconds it also sums; and torch.profiler over the block."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from gatk_tpu_torch.mutect import engine as m2_engine
    from gatk_tpu_torch.utils.stopwatch import STAGES

    spans = {}
    lock = threading.Lock()
    stage = STAGES.stage

    @contextlib.contextmanager
    def staged(name):
        with record_function("stage:" + name), stage(name):
            yield

    def spanned(name, fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                with record_function("span:" + name):
                    return fn(*args, **kwargs)
            finally:
                dt = time.perf_counter() - t0
                with lock:
                    spans[name] = spans.get(name, 0.0) + dt
        return run

    eng = m2_engine.Mutect2Engine
    saved = (eng._prepare_region, eng._finish_region)
    STAGES.stage = staged
    eng._prepare_region = spanned("m2.prepare_region", saved[0])
    eng._finish_region = spanned("m2.finish_region", saved[1])
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device == "cuda" else [])
    state = SimpleNamespace(spans=spans, prof=None)
    try:
        with profile(activities=acts, experimental_config=_all_threads()) as prof:
            state.prof = prof
            yield state
    finally:
        del STAGES.stage
        eng._prepare_region, eng._finish_region = saved


def read_profile(prof):
    """read_trace over the profiler's raw events, the window being the host
    range named "window"."""
    events = prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    win = [e for e in events if e.name() == "window" and e.device_type() != cuda]
    lo = win[0].start_ns()
    hi = lo + win[0].duration_ns()
    out = roofline.read_trace(events, (lo, hi), lambda e: e.device_type() == cuda)
    out["window_ns"] = hi - lo
    return out


# --------------------------------------------------------------------------- a run


def _entries():
    from gatk_tpu_torch.ops import pairhmm

    return {"pairhmm_fwd": pairhmm.pairhmm_pairs, "pairhmm_matrix": pairhmm.pairhmm_matrix}


def setup(cell, seed, device, tmp):
    """Take the device, load the kernels (built into the checkout's build
    directory on first use), generate the inputs, warm up every kernel and
    make one call on the first shard. Returns (sample, facts)."""
    facts = {}
    t0 = time.perf_counter()
    from gatk_tpu_torch import cli  # noqa: F401  (every tool module)
    from gatk_tpu_torch.ops import pairhmm

    facts["import_s"] = time.perf_counter() - t0
    if device == "cuda":
        t0 = time.perf_counter()
        torch.cuda.set_device(0)
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        facts["context_s"] = time.perf_counter() - t0
        from gatk_tpu_torch.ops import _kernels

        t0 = time.perf_counter()
        _kernels.library("pairhmm_fwd")
        facts["kernels_s"] = time.perf_counter() - t0
        facts["build"] = {k: _kernels.BUILD_INFO.get(k) for k in ("seconds", "built", "dir")}
    t0 = time.perf_counter()
    sample = gen.generate(os.path.join(tmp, "inputs"), seed, cell["params"])
    facts["generate_s"] = time.perf_counter() - t0
    facts["pool"] = dict(shards=len(sample.shards), reads=sample.n_reads,
                         variants=len(sample.variants), contig_bp=sample.length)
    t0 = time.perf_counter()
    read = dict(bases=b"ACGTACGTAC" * 10, **{k: np.full(100, q, np.uint8) for k, q in
                                             (("rq", 30), ("iq", 45), ("dq", 45), ("gcp", 10))})
    haps = [b"ACGTACGTAC" * 12, b"ACGTTCGTAC" * 12]
    pairhmm.compute_log10_likelihoods([read], haps, [0, 0], [0, 1], device=device)
    pairhmm.compute_likelihood_matrix([read], haps, device=device)
    one_call(cell, sample, sample.shards[0], device, tmp)
    _sync(device)
    facts["warm_s"] = time.perf_counter() - t0
    return sample, facts


def _argv(cell, sample, shard, device, out):
    argv = [a.replace("{device}", device) for a in cell["traffic"]["argv"]]
    return argv + ["-I", sample.bam, "-R", sample.fasta,
                   "-L", f"{sample.contig}:{shard.start + 1}-{shard.end}", "-O", out]


def one_call(cell, sample, shard, device, tmp):
    """One call of the cell's tool on `shard`: (return code or the exception's
    text, the output's text, what the tool printed). Its files are removed."""
    from gatk_tpu_torch import cli

    out = os.path.join(tmp, "call.vcf")
    sink = io.StringIO()
    try:
        with contextlib.redirect_stdout(sink), contextlib.redirect_stderr(sink):
            rc = cli.main(_argv(cell, sample, shard, device, out))
        _sync(device)
    except Exception:  # a call that fails is counted, and the window goes on
        rc = traceback.format_exc()
    text = ""
    if os.path.exists(out):
        with open(out) as fh:
            text = fh.read()
    for path in (out, out + ".stats", out + ".idx"):
        if os.path.exists(path):
            os.remove(path)
    return rc, text, sink.getvalue()


def window(cell, sample, seconds, device, tmp, capture, trace=False, alter_records=False):
    """The measured window; returns the run's record."""
    from torch.profiler import record_function

    from gatk_tpu_torch.utils.stopwatch import STAGES

    entries = _entries()
    for e in entries.values():
        e.reset()
    STAGES.reset()
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    calls = []
    tool = cell["traffic"]["argv"][0]
    smi_before = nvidia_smi() if device == "cuda" else None
    capture.install()
    tr = None
    try:
        with contextlib.ExitStack() as stack:
            altering = stack.enter_context(records_altered()) if alter_records else None
            if trace:
                tr = stack.enter_context(traced(device))
            with record_function("window"):
                t0 = time.perf_counter()
                k = 0
                while time.perf_counter() - t0 < seconds:
                    shard = sample.shards[k % len(sample.shards)]
                    if altering is not None:
                        altering.site = (sample.contig, shard.start + 1)
                    c0, p0 = time.perf_counter(), time.process_time()
                    with record_function(f"call:{tool}"):
                        rc, text, said = one_call(cell, sample, shard, device, tmp)
                    c1 = time.perf_counter()
                    calls.append(dict(shard=shard.index, wall=c1 - c0, reads=shard.reads, rc=rc,
                                      cpu=time.process_time() - p0, text=text,
                                      said=said if rc != 0 else ""))
                    k += 1
                t1 = time.perf_counter()
    finally:
        capture.uninstall()
    smi_after = nvidia_smi() if device == "cuda" else None
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    run = SimpleNamespace(
        calls=calls, window_s=t1 - t0, seconds=seconds,
        reads=sum(c["reads"] for c in calls),
        stages=dict(STAGES.seconds), stage_counts=dict(STAGES.counts),
        counts={name: dict(launches=e.launches, pairs=e.pairs) for name, e in entries.items()},
        nvidia_smi=dict(before=smi_before, after=smi_after), memory_peak_bytes=peak,
        spans=dict(tr.spans) if tr else {}, trace=None, bounds=[],
        card_ms=capture.card_ms())
    if tr is not None:
        run.trace = read_profile(tr.prof)
        run.bounds = capture.bounds()
    return run


def judge_run(cell, sample, run, capture, seed, device):
    """The numbers compared and each against its limit: (correct, numbers,
    rows). Runs after the window, once the program's state is freed; the
    plain PairHMM runs in blocks on the run's device."""
    spec = cell["traffic"]["judge"]
    by_index = {sh.index: sh for sh in sample.shards}
    totals = {}
    for c in run.calls:
        recs = judge.parse_records(c["text"]) if c["rc"] == 0 else []
        got = judge.judge_shard(recs, by_index[c["shard"]], spec["kinds"],
                                germline_gt=spec.get("germline_gt", True),
                                tiled=spec.get("tiled", False))
        for key, v in got.items():
            totals[key] = totals.get(key, 0) + v
    failed = sum(1 for c in run.calls if c["rc"] != 0)
    pairs, values = capture.samples(seed)
    gap = None
    read_counts = {}
    if pairs is not None:
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        pairs, read_counts = readside.rebuild(sample, pairs, cell["params"]["mapq"])
        ref = plain_pairhmm.in_blocks(pairs, device=device).numpy()
        gap = judge.likelihood_gap(values, ref)
    nums = judge.numbers(totals, gap, failed, len(run.calls))
    if read_counts:
        nums["read_side_mismatches"] = read_counts["mismatched"]
        nums["reads_rebuilt"] = read_counts["rebuilt"]
        nums["reads_short"] = read_counts["short"]
    nums["sampled_pairs"] = int(len(values))
    rows = judge.verdict(nums, cell["limits"])
    correct = bool(run.calls) and all(ok for *_, ok in rows)
    return correct, nums, rows, totals
