"""gvcf.interval_self_ms_per_kread: the program's STAGES["hc.gvcf_interval.self"] seconds
over the window (the self time of the span around hc_engine.call_interval_gvcf: its read
filter, per-region read selection and hom-ref block loop, outside its stages), in ms per
thousand reads of the window's calls; nothing where the program records no such stage."""


def read(run):
    s = run.stages.get("hc.gvcf_interval.self")
    if s is None or not run.reads:
        return None
    return s * 1e3 / (run.reads / 1e3)
