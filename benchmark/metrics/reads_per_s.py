"""reads_per_s: the reads of every call the window ran (those whose alignment
starts in the call's shard) over the window's whole time, host clock."""


def read(run):
    return run.reads / run.window_s if run.calls else None
