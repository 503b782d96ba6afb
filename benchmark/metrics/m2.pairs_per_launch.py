"""m2.pairs_per_launch: dispatch.pairs_per_launch in the Mutect2
cell, where it moves card_ms_per_kread: PairHMM pairs scored over kernel
launches in the window, by the port's own counters (ops/pairhmm.pairhmm_pairs
and pairhmm_matrix .pairs and .launches; a matrix launch's pairs are reads x
haplotypes)."""


def read(run):
    launches = sum(c["launches"] for c in run.counts.values())
    if not launches:
        return None
    return sum(c["pairs"] for c in run.counts.values()) / launches
