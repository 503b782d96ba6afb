"""m2.activity_ms_per_kread: the program's STAGES["m2_activity"] seconds over the window
(mutect/activity.find_active_regions, Mutect2's active-region scan), in ms per thousand
reads of the window's calls; nothing where the program records no such stage."""


def read(run):
    s = run.stages.get("m2_activity")
    if s is None or not run.reads:
        return None
    return s * 1e3 / (run.reads / 1e3)
