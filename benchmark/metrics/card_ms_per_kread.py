"""card_ms_per_kread: the card time of the window's PairHMM launches, per
1,000 reads of the window's calls. Each launch is timed on the card by a CUDA
event recorded on its stream before the entry is called and one after it
returns: its plan kernels and sweep, all the compute the card does in a call,
and the time the idle stream waits for the host to enqueue them. With the card
idle nearly all of a call, a deployment packs shards onto one card, and this
sets how many it carries."""


def read(run):
    if not run.card_ms or not run.reads:
        return None
    return run.card_ms / (run.reads / 1000.0)
