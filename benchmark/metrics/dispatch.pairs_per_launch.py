"""dispatch.pairs_per_launch: PairHMM pairs scored over kernel launches in the
window, by the port's own counters (ops/pairhmm.pairhmm_pairs and
pairhmm_matrix .pairs and .launches; a matrix launch's pairs are reads x
haplotypes)."""


def read(run):
    launches = sum(c["launches"] for c in run.counts.values())
    if not launches:
        return None
    return sum(c["pairs"] for c in run.counts.values()) / launches
