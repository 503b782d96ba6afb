"""m2.interval_self_ms_per_kread: the program's STAGES["m2.call_interval.self"] seconds
over the window (the self time of the span around Mutect2Engine.call_interval: its read
filter, palindrome clip and reference fetch, outside its stages and spans), in ms per
thousand reads of the window's calls; nothing where the program records no such stage."""


def read(run):
    s = run.stages.get("m2.call_interval.self")
    if s is None or not run.reads:
        return None
    return s * 1e3 / (run.reads / 1e3)
