"""The frozen plain PairHMM against the port's host float64 PairHMM, and its
bfloat16 control, at a small size."""
import numpy as np
import pytest
import torch

from yardstick import plain_pairhmm

ACGT = np.frombuffer(b"ACGT", np.uint8)


def _pairs(seed, P=24, R=60, H=90):
    rng = np.random.default_rng(seed)
    rl = rng.integers(1, R + 1, P)
    hl = rng.integers(1, H + 1, P)
    rb = ACGT[rng.integers(0, 4, (P, R))]
    hb = ACGT[rng.integers(0, 4, (P, H))]
    for p in range(P):  # reads drawn from their haplotype, with a few changes
        off = int(rng.integers(0, max(1, hl[p] - rl[p] + 1)))
        n = min(rl[p], hl[p] - off)
        rb[p, :n] = hb[p, off : off + n]
    rb[0, 2], hb[1, 3] = ord("N"), ord("N")
    rq = rng.integers(2, 41, (P, R)).astype(np.uint8)
    iq = rng.choice([45, 30, 15], (P, R)).astype(np.uint8)
    dq = rng.choice([45, 40, 10], (P, R)).astype(np.uint8)
    gcp = np.full((P, R), 10, np.uint8)
    return rb, rq, iq, dq, gcp, rl, hb, hl


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_matches_host_float64(seed):
    from gatk_tpu_torch.ops import pairhmm_host

    rb, rq, iq, dq, gcp, rl, hb, hl = _pairs(seed)
    want = np.array([pairhmm_host.compute_log10_likelihood(
        hb[p, : hl[p]], rb[p, : rl[p]], rq[p, : rl[p]], iq[p, : rl[p]], dq[p, : rl[p]],
        gcp[p, : rl[p]]) for p in range(len(rl))])
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    got = plain_pairhmm.log10_likelihoods(*(T(a) for a in (rb, rq, iq, dq, gcp, rl, hb, hl)))
    # GATK's Jacobian-table matchToMatch against the exact one: far below 1e-6
    assert np.abs(got.numpy() - want).max() < 1e-6


def test_control_reads_off():
    """The control (bfloat16) lies far from the reference; float32 does not."""
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    args = [T(a) for a in _pairs(4, P=32, R=151, H=300)]
    ref = plain_pairhmm.log10_likelihoods(*args).numpy()
    f32 = plain_pairhmm.log10_likelihoods(*args, dtype=torch.float32).numpy()
    bf16 = plain_pairhmm.log10_likelihoods(*args, dtype=torch.bfloat16).numpy()
    ok = ref > -28
    assert np.abs(f32 - ref)[ok].max() < 1e-4
    assert np.abs(bf16 - ref)[ok].max() > 1e-2


def test_in_blocks_equals_one_block():
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    keys = ("rb", "rq", "iq", "dq", "gcp", "rlen", "hb", "hlen")
    pairs = dict(zip(keys, (T(a) for a in _pairs(5, P=20))))
    whole = plain_pairhmm.log10_likelihoods(*(pairs[k] for k in keys))
    assert torch.equal(plain_pairhmm.in_blocks(pairs, block=7), whole)
