"""gvcf.prep_wait_ms_per_kread: the program's STAGES["prep_wait"] seconds over the window
(the main thread's wait in ShardedCaller's pool loop for the next window's -ERC GVCF region
preparations from the pool threads (the queue wait)), in ms per thousand reads of the
window's calls; nothing where the program records no such stage."""


def read(run):
    s = run.stages.get("prep_wait")
    if s is None or not run.reads:
        return None
    return s * 1e3 / (run.reads / 1e3)
