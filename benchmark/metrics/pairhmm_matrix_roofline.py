"""pairhmm_matrix_roofline: the sum of the least times of the window's pairhmm_matrix
launches (each from its own cells and bytes, yardstick.roofline.bound) over
the device time of its sweep kernels and of the plan kernels each launch runs
first, from the profiler's trace, in %."""


def read(run):
    if run.trace is None:
        return None
    bound_ms = sum(b["bound_ms"] for b in run.bounds if b["kind"] == "pairhmm_matrix")
    device_ms = run.trace["kernel_ns"]["pairhmm_matrix"] / 1e6
    if not bound_ms or not device_ms:
        return None
    return 100.0 * bound_ms / device_ms
