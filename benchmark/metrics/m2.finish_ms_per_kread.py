"""m2.finish_ms_per_kread: seconds inside Mutect2Engine._finish_region, a span of the
benchmark's own around the engine's method, over the window, in ms per
thousand reads of the window's calls."""


def read(run):
    s = run.spans.get("m2.finish_region")
    if s is None or not run.reads:
        return None
    return s * 1e3 / (run.reads / 1e3)
