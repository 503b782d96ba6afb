"""gvcf.refconf_ms_per_kread: the program's STAGES["refconf"] seconds over the window
(gvcf/refconf.ref_vs_any_gls, the interval's reference-confidence likelihoods), in ms
per thousand reads of the window's calls; nothing where the program records no such
stage."""


def read(run):
    s = run.stages.get("refconf")
    if s is None or not run.reads:
        return None
    return s * 1e3 / (run.reads / 1e3)
