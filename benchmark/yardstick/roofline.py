"""Peaks of the card, a PairHMM launch's least time, and the reading of a
torch.profiler trace.

Frozen copies, as of the port's first benchmark: `bound` of chip_smoke.py's
_bound (FP32 operations of the cells over 67 TFLOP/s against the bytes read
once and written once over 3.35 TB/s, 11 operations a cell from the plain
recurrence: M is 5, I is 3, D is 3); `read_trace` of chip_smoke.py's _profile
(the profiler's raw kineto events, since building its FunctionEvents takes
minutes for a long run; a device event named like a host event is a
record_function range's copy on the device's timeline, not device work),
extended to give each kernel kind its own time, with each plan kernel charged
to the sweep that follows it on the device, the device's busy union, and the
idle gaps labelled by the host range that covered them. It imports nothing of
the program.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit
FP32_PEAK = 67e12  # FLOP/s, FP32 outside the tensor cores
HBM_RATE = 3.35e12  # bytes/s
FLOPS_PER_CELL = 11

# kernel names of csrc/pairhmm_fwd.cu, csrc/pairhmm_matrix.cu and the plan
# kernels both launchers run first (csrc/pairhmm_sweep.cuh)
SWEEPS = {"pairhmm_fwd": "pairhmm_fwd_kernel", "pairhmm_matrix": "pairhmm_matrix_kernel"}
PLAN = ("plan_count", "plan_scan", "plan_scatter")


def bound(cells, in_bytes, out_bytes, flops_per_cell=FLOPS_PER_CELL):
    """The least time the card could take: the larger of the FP32 time of the
    cells and the time to read the inputs once and write the output once."""
    ops_ms = cells * flops_per_cell / FP32_PEAK * 1e3
    bytes_ms = (in_bytes + out_bytes) / HBM_RATE * 1e3
    return dict(bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                ops_bound_ms=ops_ms, bytes_bound_ms=bytes_ms)


def _kind(name):
    for kind, part in SWEEPS.items():
        if part in name:
            return kind
    return None


def _union(intervals):
    """Total length of a union of [lo, hi) intervals, and its merged pieces."""
    merged = []
    for lo, hi in sorted(intervals):
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return sum(hi - lo for lo, hi in merged), merged


def _intersect(a, b):
    """Pieces of sorted disjoint intervals `a` that lie in sorted disjoint `b`."""
    out, j = [], 0
    for lo, hi in a:
        while j < len(b) and b[j][1] <= lo:
            j += 1
        k = j
        while k < len(b) and b[k][0] < hi:
            piece = (max(lo, b[k][0]), min(hi, b[k][1]))
            if piece[1] > piece[0]:
                out.append(piece)
            k += 1
    return out


def _subtract(a, cut):
    """Sorted disjoint intervals `a` less the sorted disjoint pieces `cut`
    (each piece inside one interval of `a`)."""
    out, j = [], 0
    for lo, hi in a:
        cur = lo
        while j < len(cut) and cut[j][0] < hi:
            if cut[j][0] > cur:
                out.append((cur, cut[j][0]))
            cur = max(cur, cut[j][1])
            j += 1
        if hi > cur:
            out.append((cur, hi))
    return out


def read_trace(events, window, is_device, host_prefixes=("stage:", "span:", "call:")):
    """Reduce raw profiler events to what the per-layer metrics read.

    events: kineto events (name(), start_ns(), duration_ns()); is_device(e)
    tells a device event; window: (lo_ns, hi_ns) of the traced window.
    Device work inside a device-side "bench:" range is the harness's and
    counts only in harness_ns.
    Returns dict(busy_ns: union of device activity, kernel_ns: {kind: ns of
    its sweeps and the plan kernels before them}, device_ops: [(name, ns)]
    summed by name, idle: [(label, ns)] idle time inside the window summed by
    the innermost host range (one whose name starts with host_prefixes, in
    that order) covering it, "none" where no such range ran). The profiler
    records the ranges of the thread that runs the window, not those of the
    program's worker threads."""
    lo_w, hi_w = window
    host, dev = [], []
    for e in events:
        (dev if is_device(e) else host).append(e)
    host_names = {e.name() for e in host}
    ranges = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name()) for e in host
              if e.name().startswith(host_prefixes)]
    # the harness's own device work (its sample gathers) runs inside host
    # ranges named "bench:...", whose copies on the device's timeline mark it
    _, harness = _union([(e.start_ns(), e.start_ns() + e.duration_ns()) for e in dev
                         if e.name().startswith("bench:")])
    work, harness_ns = [], 0
    for e in dev:
        if e.name() in host_names:
            continue
        lo, hi = e.start_ns(), e.start_ns() + e.duration_ns()
        if _intersect([((lo + hi) // 2, (lo + hi) // 2 + 1)], harness):
            harness_ns += hi - lo
        else:
            work.append((lo, hi, e.name()))
    work.sort()
    by_name, kernel_ns = {}, {kind: 0 for kind in SWEEPS}
    pending_plan = 0
    for lo, hi, name in work:
        by_name[name] = by_name.get(name, 0) + (hi - lo)
        if any(p in name for p in PLAN):
            pending_plan += hi - lo
            continue
        kind = _kind(name)
        if kind is not None:
            kernel_ns[kind] += (hi - lo) + pending_plan
            pending_plan = 0
    busy_ns, merged = _union([(max(lo, lo_w), min(hi, hi_w)) for lo, hi, _ in work
                              if hi > lo_w and lo < hi_w])
    gaps, cur = [], lo_w
    for lo, hi in merged:
        if lo > cur:
            gaps.append((cur, lo))
        cur = max(cur, hi)
    if hi_w > cur:
        gaps.append((cur, hi_w))
    # each stretch of idle time goes to the innermost kind of range that
    # covers it (a stage before a span before a call), "none" where none does
    idle = {}
    remaining = gaps
    for prefix in host_prefixes:
        names = sorted({name for _, _, name in ranges if name.startswith(prefix)})
        for name in names:
            _, cover = _union([(lo, hi) for lo, hi, n in ranges if n == name])
            hit = _intersect(remaining, cover)
            if hit:
                idle[name] = idle.get(name, 0) + sum(hi - lo for lo, hi in hit)
                remaining = _subtract(remaining, hit)
    left = sum(hi - lo for lo, hi in remaining)
    if left:
        idle["none"] = left
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])
    return dict(busy_ns=busy_ns, kernel_ns=kernel_ns, device_ops=device_ops,
                idle=sorted(idle.items(), key=lambda kv: -kv[1]), harness_ns=harness_ns)
