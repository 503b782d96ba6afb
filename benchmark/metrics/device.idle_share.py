"""device.idle_share: 1 - the union of device activity over the traced
window's length, from the profiler's trace."""


def read(run):
    if run.trace is None or not run.trace["window_ns"]:
        return None
    return 1.0 - run.trace["busy_ns"] / run.trace["window_ns"]
