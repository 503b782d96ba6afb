"""front.bam_read_ms_per_kread: the program's STAGES["bam_read"] seconds over the window
(thread-occupancy: summed over ShardedCaller's host threads, not the
critical path), in ms per thousand reads of the window's calls."""


def read(run):
    s = run.stages.get("bam_read")
    if s is None or not run.reads:
        return None
    return s * 1e3 / (run.reads / 1e3)
