"""m2.reads_per_s: reads_per_s, per layer in the Mutect2 cell, whose runs
spread too widely on a shared host for an end-to-end bound: the reads of
every call the window ran over the window's whole time, host clock."""


def read(run):
    return run.reads / run.window_s if run.calls else None
