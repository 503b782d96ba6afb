"""m2.pairhmm_fwd_roofline: pairhmm_fwd_roofline in the Mutect2 cell, where
it moves card_ms_per_kread: the sum of the least times of the window's
pairhmm_fwd launches (each from its own cells and bytes,
yardstick.roofline.bound) over the device time of its sweep kernels and of
the plan kernels each launch runs first, from the profiler's trace, in %."""


def read(run):
    if run.trace is None:
        return None
    bound_ms = sum(b["bound_ms"] for b in run.bounds if b["kind"] == "pairhmm_fwd")
    device_ms = run.trace["kernel_ns"]["pairhmm_fwd"] / 1e6
    if not bound_ms or not device_ms:
        return None
    return 100.0 * bound_ms / device_ms
