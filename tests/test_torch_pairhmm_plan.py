"""The lane-group plan of the port's PairHMM kernels (gatk_tpu_torch.ops._kernels.
plan_groups and pair_plan), and the haplotype layout they read, on the CPU.

The kernels sweep a read with a group of 4, 8, 16 or 32 lanes, 5 rows a lane,
and take the plan's order; they write each result at the pair's own index. The
plan is plain torch, so its properties are checked here; the kernels that read
it are held against the plain version on the card (tests/test_torch_kernel_cuda.py).
"""
import numpy as np
import pytest
import torch

from gatk_tpu_torch.ops import _kernels, pairhmm

ROWS = _kernels.ROWS_PER_LANE
WIDTHS = _kernels.GROUP_WIDTHS
EDGES = (1, 19, 20, 21, 39, 40, 41, 79, 80, 81, 159, 160, 161, 318)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread per worker process (see tests/test_torch_pairhmm.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pairs(seed, n, max_rows=318, hmax=512):
    rng = np.random.default_rng(seed)
    rows = np.concatenate([rng.integers(1, max_rows + 1, max(n - len(EDGES), 0)),
                           np.array(EDGES[:n])])
    rng.shuffle(rows)
    hlen = rng.integers(1, hmax + 1, len(rows))
    return torch.from_numpy(rows.astype(np.int32)), torch.from_numpy(hlen.astype(np.int32))


def _classes(perm, seg):
    cls = torch.empty(len(perm), dtype=torch.long)
    for c in range(len(WIDTHS)):
        cls[perm[seg[c] : seg[c + 1]].long()] = c
    return cls


@pytest.mark.parametrize("seed,n", [(0, 0), (1, 1), (2, 14), (3, 500), (4, 5000)])
def test_plan_is_a_permutation_with_class_segments(seed, n):
    rows, hlen = _pairs(seed, n)
    perm, seg = _kernels.plan_groups(rows, hlen, 512)
    assert perm.dtype == torch.int64 and seg.dtype == torch.int32
    assert torch.equal(torch.sort(perm.long()).values, torch.arange(n))
    assert seg.tolist()[0] == 0 and seg.tolist()[-1] == n
    assert (seg[1:] >= seg[:-1]).all()


@pytest.mark.parametrize("seed,n", [(1, 1), (2, 14), (3, 500), (4, 5000)])
def test_every_read_in_the_narrowest_group_that_holds_it(seed, n):
    """A read of L rows sits in the class whose 5G rows hold it and the next
    narrower does not; reads over 160 rows take the 32-lane (striped) class."""
    rows, hlen = _pairs(seed, n)
    perm, seg = _kernels.plan_groups(rows, hlen, 512)
    cls = _classes(perm, seg)
    width = torch.tensor(WIDTHS)[cls]
    long_reads = rows > ROWS * WIDTHS[-1]
    assert (long_reads <= (width == WIDTHS[-1])).all()
    assert ((rows <= ROWS * width) | long_reads).all()
    assert ((rows > ROWS * width // 2) | (width == WIDTHS[0])).all()


@pytest.mark.parametrize("seed,n", [(2, 14), (3, 500), (4, 5000)])
def test_hlen_non_decreasing_within_a_width(seed, n):
    rows, hlen = _pairs(seed, n)
    perm, seg = _kernels.plan_groups(rows, hlen, 512)
    for c in range(len(WIDTHS)):
        h = hlen[perm[seg[c] : seg[c + 1]].long()]
        assert (h[1:] >= h[:-1]).all()


def test_edges_of_each_width():
    rows = torch.tensor(EDGES, dtype=torch.int32)
    perm, seg = _kernels.plan_groups(rows, torch.full_like(rows, 7), 512)
    cls = _classes(perm, seg)
    assert cls.tolist() == [0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 3, 3]


def test_reads_of_a_region_sorted_by_lanes_within_a_width():
    """The matrix kernel's plan: reads only, by class, then lanes used."""
    rows, _ = _pairs(5, 300)
    perm, seg = _kernels.plan_groups(rows)
    lanes = (rows.clamp(1, 160) + ROWS - 1) // ROWS
    for c in range(len(WIDTHS)):
        la = lanes[perm[seg[c] : seg[c + 1]].long()]
        assert (la[1:] >= la[:-1]).all()
    assert torch.equal(torch.sort(perm.long()).values, torch.arange(300))


def test_pair_plan_takes_out_of_range_pairs():
    """Pairs with indices outside the pools are planned as length 0, in the
    narrowest class (the kernel writes NaN for them), instead of failing the
    gather."""
    rng = np.random.default_rng(6)
    reads, haps = _region(rng, (10, 30, 90, 150), (50, 200))
    pools, ri, hi = _cpu_pools(reads, haps)
    ri = torch.cat([ri, torch.tensor([-1, 4, 0], dtype=torch.int32)])
    hi = torch.cat([hi, torch.tensor([0, 0, 2], dtype=torch.int32)])
    perm, seg = _kernels.pair_plan(pools, ri, hi)
    assert torch.equal(torch.sort(perm).values, torch.arange(len(ri)))
    # reads of 10, 30, 90, 150 rows, two haplotypes each, and 3 pairs out of range
    assert seg.tolist() == [0, 5, 7, 7, 11]
    assert set(perm[:5].tolist()) >= {len(ri) - 3, len(ri) - 2, len(ri) - 1}


def _region(rng, read_lens, hap_lens):
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    span = max(max(read_lens), max(hap_lens))
    master = acgt[rng.integers(0, 4, span)]
    reads = []
    for n in read_lens:
        s = int(rng.integers(0, span - n + 1))
        reads.append(dict(bases=master[s : s + n].tobytes(),
                          rq=rng.integers(10, 41, n).astype(np.uint8),
                          iq=rng.integers(30, 50, n).astype(np.uint8),
                          dq=rng.integers(30, 50, n).astype(np.uint8),
                          gcp=np.full(n, 10, np.uint8)))
    haps = []
    for n in hap_lens:
        s = int(rng.integers(0, span - n + 1))
        haps.append(master[s : s + n].tobytes())
    return reads, haps


def _cpu_pools(reads, haps, rp=None):
    packed, rp = pairhmm.pack_reads(reads, rp=rp, nr=len(reads))
    e, hlen, _ = pairhmm.pack_haps(haps, rp, nh=len(haps))
    pools = pairhmm.make_pools(packed, packed["rlen"], e, hlen, "cpu")
    ri, hi = (torch.from_numpy(a) for a in pairhmm.cartesian_pairs(len(reads), len(haps)))
    return pools, ri, hi


@pytest.mark.parametrize("read_lens,hap_lens,rp", [
    ((1, 19, 20, 21, 39, 40, 41, 79, 80, 81, 120, 151), (1, 60, 200, 333), None),
    ((5, 150, 159, 160, 161, 250, 318), (3, 170, 400), 320),
])
def test_plan_order_scattered_back_equals_the_unpermuted_result(read_lens, hap_lens, rp):
    """pairhmm_pairs on the CPU over the plan-ordered pair list, scattered back
    to the caller's order, equals the unpermuted result bit for bit: a pair's
    likelihood does not depend on its place in the list."""
    rng = np.random.default_rng(len(read_lens))
    pools, ri, hi = _cpu_pools(*_region(rng, read_lens, hap_lens), rp=rp)
    # the caller's order, shuffled, as PoolBatcher's regions interleave
    order = torch.from_numpy(rng.permutation(len(ri)))
    ri, hi = ri[order].contiguous(), hi[order].contiguous()
    want = pairhmm.pairhmm_pairs(pools, ri, hi)
    perm, _ = _kernels.pair_plan(pools, ri, hi)
    p = perm.long()
    got = torch.empty_like(want)
    got[p] = pairhmm.pairhmm_pairs(pools, ri[p].contiguous(), hi[p].contiguous())
    assert torch.equal(got, want)
    assert (want > pairhmm.MIN_ACCEPTED_LOG10).any()


def test_pools_hold_haplotypes_haplotype_major(monkeypatch):
    """The kernels read each haplotype as one row of bytes: make_pools and
    PoolBatcher's flush both give e (He, NH) strides (1, He), with the values of
    pack_haps' (He, NH) array, and the pooled result is the cartesian route's."""
    rng = np.random.default_rng(7)
    reads, haps = _region(rng, (30, 90, 151), (50, 120, 200))
    pools, _, _ = _cpu_pools(reads, haps)
    e, _, _ = pairhmm.pack_haps(haps, pools.rp, nh=len(haps))
    assert pools.e.shape == e.shape and pools.e.t().is_contiguous()
    assert np.array_equal(pools.e.numpy(), e)

    flushed = []
    entry = pairhmm.pairhmm_pairs

    def spy(p, ri, hi):
        flushed.append(p)
        return entry(p, ri, hi)

    monkeypatch.setattr(pairhmm, "pairhmm_pairs", spy)
    batcher = pairhmm.PoolBatcher(device="cpu", nr_cap=16, nh_cap=8)
    handle = batcher.add_region(reads, haps)
    batcher.flush()
    (p,) = flushed
    want_e, _, _ = pairhmm.pack_haps(haps, batcher.rp, hmax=batcher.hmax, nh=len(haps))
    assert p.e.t().is_contiguous() and np.array_equal(p.e.numpy(), want_e)
    got = pairhmm.finish_likelihood_matrix(handle, reads, haps)
    want = pairhmm.compute_likelihood_matrix(reads, haps, device="cpu")
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
