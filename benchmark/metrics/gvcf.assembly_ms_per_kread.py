"""gvcf.assembly_ms_per_kread: the program's STAGES["assembly"] seconds over the window
(assembly/assembler.assemble on the -ERC GVCF path), in ms per thousand reads of the
window's calls; nothing where the program records no such stage."""


def read(run):
    s = run.stages.get("assembly")
    if s is None or not run.reads:
        return None
    return s * 1e3 / (run.reads / 1e3)
