"""The port's PairHMM (gatk_tpu_torch.ops.pairhmm) against gatk_tpu's.

Inputs are made with numpy from a seed and handed to both packages. On the CPU
the port runs its plain PyTorch version; gatk_tpu runs its compiled lax.scan
(the CPU path of its HaplotypeCaller) or its production Pallas kernel v6 in
interpret mode. The CUDA kernel itself is held against the plain version by
tests/test_torch_kernel_cuda.py, which needs a card.
"""
import numpy as np
import pytest
import torch

import __graft_entry__
from gatk_tpu.ops import pairhmm_host, pairhmm_tpu
from gatk_tpu_torch.ops import pairhmm
from tests.test_pairhmm_tpu import _host_matrix, _random_region

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run a module's torch ops on one thread. The suite runs test files in
    parallel worker processes, and a full-width torch thread pool in each of
    them (beside XLA's) oversubscribes the cores many times over; the port's
    tests on the CPU use small tensors and lose little on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _merged(packed, e, hlen):
    return dict(packed, e=e, hlen=hlen)


def _port_matrix(packed, e, hlen):
    """(NH, NR) plain-version matrix over gatk_tpu-packed reads and haplotypes."""
    pools, ri, hi = pairhmm.from_jax_packed(_merged(packed, e, hlen), cartesian=True)
    out = pairhmm.pairhmm_pairs_reference(pools, ri, hi)
    return out.numpy().reshape(e.shape[1], packed["rbase"].shape[1])


@pytest.mark.parametrize("seed,n_reads,n_haps", [(1, 12, 3), (2, 40, 5), (3, 7, 8)])
def test_plain_matches_jax_scan(seed, n_reads, n_haps):
    """(a) Element-wise against gatk_tpu's _pairhmm_scan_call. Both are f32 with
    the same operation order; 2e-5 in log10 leaves room for exp and log that
    differ in the last ulp and for XLA fusing multiplies and adds into FMAs."""
    rng = np.random.default_rng(seed)
    reads, haps = _random_region(rng, n_reads, n_haps)
    packed, rp = pairhmm_tpu.pack_reads(reads)
    e, hlen, hmax = pairhmm_tpu.pack_haps(haps, rp)
    args = tuple(packed[k] for k in ("rbase", "rq", "iq", "dq", "gcp")) + (e, packed["rlen"], hlen)
    want = np.asarray(pairhmm_tpu._pairhmm_scan_call(*args, rp=rp, hmax=hmax))
    got = _port_matrix(packed, e, hlen)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def test_start_likelihood_matrix_matches_jax_cpu_path():
    """(a) The cartesian route end to end: gatk_tpu's start/finish on its CPU
    scan path against the port's on the CPU device, after the clamp floor."""
    rng = np.random.default_rng(5)
    reads, haps = _random_region(rng, 30, 4)
    want = pairhmm_tpu.finish_likelihood_matrix(
        pairhmm_tpu.start_likelihood_matrix(reads, haps), reads, haps)
    got = pairhmm.finish_likelihood_matrix(
        pairhmm.start_likelihood_matrix(reads, haps, device=CPU), reads, haps)
    assert got.shape == (len(reads), len(haps))
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def test_plain_matches_v6_interpret():
    """(b) Against the production Pallas kernel v6 (interpret mode) on 128
    N-free pairs. v6 pre-rolls its tables and reorders the f32 operations, so
    the tolerance is the kernel contract's 1e-4."""
    packed, rp, hmax = __graft_entry__._example_batch(n_pairs=128)
    args = tuple(packed[k] for k in ("rbase", "rq", "iq", "dq", "gcp", "e", "rlen", "hlen"))
    want = np.asarray(pairhmm_tpu._pairhmm_call_v6(*args, rp=rp, hmax=hmax, interpret=True))[0]
    pools, ri, hi = pairhmm.from_jax_packed(packed)
    got = pairhmm.pairhmm_pairs_reference(pools, ri, hi).numpy()
    assert got.shape == want.shape == (128,)
    assert (want > pairhmm.MIN_ACCEPTED_LOG10).all()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def _host_random_cases():
    """The cases of tests/test_pairhmm_tpu.py::test_kernel_matches_host_random."""
    rng = np.random.default_rng(42)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    reads, haps, cases = [], [], []
    for _ in range(40):
        rlen = int(rng.integers(10, 120))
        hlen = int(rng.integers(rlen, 300))
        hap = bases[rng.integers(0, 4, hlen)].tobytes()
        start = int(rng.integers(0, hlen - rlen + 1))
        rb = bytearray(hap[start : start + rlen])
        for _ in range(int(rng.integers(0, 4))):
            rb[int(rng.integers(0, rlen))] = bases[int(rng.integers(0, 4))]
        rq = rng.integers(10, 50, rlen).astype(np.uint8)
        iq = rng.integers(30, 50, rlen).astype(np.uint8)
        dq = rng.integers(30, 50, rlen).astype(np.uint8)
        gcp = np.full(rlen, 10, np.uint8)
        reads.append(dict(bases=bytes(rb), rq=rq, iq=iq, dq=dq, gcp=gcp))
        haps.append(hap)
        cases.append((hap, bytes(rb), rq, iq, dq, gcp))
    return reads, haps, cases


def test_matches_host_random():
    """(c) compute_log10_likelihoods against the host f64 reference, 1e-4."""
    reads, haps, cases = _host_random_cases()
    idx = np.arange(len(reads))
    got = pairhmm.compute_log10_likelihoods(reads, haps, idx, idx, device=CPU)
    want = np.array([pairhmm_host.compute_log10_likelihood(*c) for c in cases])
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_extreme_underflow_recomputed_on_host():
    """(c) A read that mismatches everywhere falls below the f32 floor, so
    compute_log10_likelihoods recomputes it in f64 on the host."""
    rlen = 120
    hap = b"A" * 300
    rb = b"C" * rlen
    rq = np.full(rlen, 40, np.uint8)
    iq = np.full(rlen, 45, np.uint8)
    dq = np.full(rlen, 45, np.uint8)
    gcp = np.full(rlen, 10, np.uint8)
    reads = [dict(bases=rb, rq=rq, iq=iq, dq=dq, gcp=gcp)]
    packed, rp = pairhmm.pack_reads(reads, nr=1)
    e, hlen, _ = pairhmm.pack_haps([hap], rp, nh=1)
    pools = pairhmm.make_pools(packed, packed["rlen"], e, hlen, CPU)
    zero = torch.zeros(1, dtype=torch.int32)
    f32 = pairhmm.pairhmm_pairs_reference(pools, zero, zero)
    assert not (f32 > pairhmm.MIN_ACCEPTED_LOG10).any()
    got = pairhmm.compute_log10_likelihoods(reads, [hap], np.array([0]), np.array([0]), device=CPU)
    want = pairhmm_host.compute_log10_likelihood(hap, rb, rq, iq, dq, gcp)
    np.testing.assert_allclose(got[0], want, atol=1e-3 * abs(want), rtol=0)
    clamped = pairhmm.compute_likelihood_matrix(reads, [hap], device=CPU)
    assert clamped[0, 0] == pairhmm.MIN_ACCEPTED_LOG10


def _n_batch():
    """Reads drawn from haplotypes that carry N at a few positions (and one read
    with its own N), paired read k with haplotype k."""
    rng = np.random.default_rng(17)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    reads, haps = [], []
    for k in range(6):
        hlen, rlen = 220, 100
        hap = bases[rng.integers(0, 4, hlen)]
        start = int(rng.integers(0, hlen - rlen))
        rb = hap[start : start + rlen].copy()
        hap = hap.copy()
        hap[start + rng.integers(5, rlen - 5, 3)] = ord("N")
        if k == 0:
            rb[10] = ord("N")
        reads.append(dict(bases=rb.tobytes(), rq=rng.integers(20, 40, rlen).astype(np.uint8),
                          iq=np.full(rlen, 45, np.uint8), dq=np.full(rlen, 45, np.uint8),
                          gcp=np.full(rlen, 10, np.uint8)))
        haps.append(hap.tobytes())
    return reads, haps


def test_haplotype_n_follows_host_rule():
    """(d) An N in the haplotype scores as a match, as on the host in f64. v6
    (interpret mode) scores it as a mismatch; the test records that it differs."""
    reads, haps = _n_batch()
    idx = np.arange(len(reads))
    got = pairhmm.compute_log10_likelihoods(reads, haps, idx, idx, device=CPU)
    want = np.array([pairhmm_host.compute_log10_likelihood(
        h, r["bases"], r["rq"], r["iq"], r["dq"], r["gcp"]) for r, h in zip(reads, haps)])
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)

    packed, rp, hmax, n = pairhmm_tpu.pack_batch(reads, haps, idx, idx)
    args = tuple(packed[k] for k in ("rbase", "rq", "iq", "dq", "gcp", "e", "rlen", "hlen"))
    v6 = np.asarray(pairhmm_tpu._pairhmm_call_v6(*args, rp=rp, hmax=hmax, interpret=True))[0, :n]
    assert (np.abs(v6 - want) > 1e-2).all(), "v6 now scores haplotype N like the host"


def test_pool_batcher_split_and_several_flushes():
    """(e) Small caps force a region's reads to split across chunks and the pool
    to flush more than once; every region still equals the host f64 matrix."""
    rng = np.random.default_rng(7)
    batcher = pairhmm.PoolBatcher(device=CPU, rp=160, hmax=512, nr_cap=33, nh_cap=9,
                                  pool_n=256, pool_k=2)
    regions = [
        _random_region(rng, 5, 3),
        _random_region(rng, 40, 2),  # > nr_cap-1: split into chunks
        _random_region(rng, 8, 4),
    ]
    handles = [batcher.add_region(reads, haps) for reads, haps in regions]
    batcher.flush()
    assert len(handles[1].segments) >= 2
    assert len({id(rec) for h in handles for rec, _, _ in h.segments}) >= 2
    for (reads, haps), handle in zip(regions, handles):
        got = np.asarray(handle, np.float64)
        want = _host_matrix(reads, haps)
        ok = want > pairhmm.MIN_ACCEPTED_LOG10
        np.testing.assert_allclose(got[ok], want[ok], atol=2e-4, rtol=0)


def test_pool_batcher_fetch_before_flush():
    """(e) Fetching a handle before any flush flushes the pending pool itself."""
    rng = np.random.default_rng(11)
    batcher = pairhmm.PoolBatcher(device=CPU, rp=160, hmax=512, nr_cap=64, nh_cap=9,
                                  pool_n=256, pool_k=2)
    reads, haps = _random_region(rng, 6, 2)
    handle = batcher.add_region(reads, haps)
    got = np.asarray(handle, np.float64)
    want = _host_matrix(reads, haps)
    ok = want > pairhmm.MIN_ACCEPTED_LOG10
    np.testing.assert_allclose(got[ok], want[ok], atol=2e-4, rtol=0)


def test_pool_batcher_default_caps_match_jax():
    """(e) Default caps: one region through the port's pool equals gatk_tpu's
    default CPU path (its per-region scan) within the scan tolerance."""
    rng = np.random.default_rng(13)
    reads, haps = _random_region(rng, 4, 2)
    batcher = pairhmm.PoolBatcher(device=CPU)
    handle = batcher.add_region(reads, haps)
    batcher.flush()
    got = np.asarray(handle, np.float64)[: len(haps), : len(reads)]
    jb = pairhmm_tpu.PoolBatcher()
    jh = jb.add_region(reads, haps)
    jb.flush()
    want = np.asarray(jh, np.float64)[: len(haps), : len(reads)]
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    host = _host_matrix(reads, haps)
    ok = host > pairhmm.MIN_ACCEPTED_LOG10
    np.testing.assert_allclose(got[ok], host[ok], atol=2e-4, rtol=0)


def test_pool_batcher_oversize_region_takes_cartesian_route():
    """Reads longer than the pool's rp - 2 go to their own cartesian launch
    (rp = 320 there) and still match the host."""
    rng = np.random.default_rng(19)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    hap = bases[rng.integers(0, 4, 400)]
    reads = []
    for rlen in (200, 230):
        s = int(rng.integers(0, 400 - rlen))
        reads.append(dict(bases=hap[s : s + rlen].tobytes(),
                          rq=rng.integers(20, 40, rlen).astype(np.uint8),
                          iq=np.full(rlen, 45, np.uint8), dq=np.full(rlen, 45, np.uint8),
                          gcp=np.full(rlen, 10, np.uint8)))
    haps = [hap.tobytes(), hap[:300].tobytes()]
    batcher = pairhmm.PoolBatcher(device=CPU)
    handle = batcher.add_region(reads, haps)
    assert isinstance(handle, pairhmm._CartParts)
    got = np.asarray(handle, np.float64)
    want = _host_matrix(reads, haps)
    ok = want > pairhmm.MIN_ACCEPTED_LOG10
    np.testing.assert_allclose(got[ok], want[ok], atol=2e-4, rtol=0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pack_outputs_equal_jax(seed):
    """(f) pack_batch, pack_reads and pack_haps give gatk_tpu's arrays, byte for byte."""
    rng = np.random.default_rng(seed)
    reads, haps = _random_region(rng, 9 + seed, 3 + seed)
    ri = rng.integers(0, len(reads), 50)
    hi = rng.integers(0, len(haps), 50)
    mine, rp, hmax, n = pairhmm.pack_batch(reads, haps, ri, hi)
    theirs, rp2, hmax2, n2 = pairhmm_tpu.pack_batch(reads, haps, ri, hi)
    assert (rp, hmax, n) == (rp2, hmax2, n2)
    assert mine.keys() == theirs.keys()
    for k in theirs:
        assert mine[k].dtype == theirs[k].dtype and mine[k].tobytes() == theirs[k].tobytes(), k
    pr, rp = pairhmm.pack_reads(reads)
    jr, rp2 = pairhmm_tpu.pack_reads(reads)
    assert rp == rp2 and pr.keys() == jr.keys()
    for k in jr:
        assert pr[k].dtype == jr[k].dtype and pr[k].tobytes() == jr[k].tobytes(), k
    mine_h = pairhmm.pack_haps(haps, rp)
    theirs_h = pairhmm_tpu.pack_haps(haps, rp)
    assert mine_h[2] == theirs_h[2]
    for a, b in zip(mine_h[:2], theirs_h[:2]):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_cpu_pairs_use_the_plain_version_uncounted():
    """On CPU tensors pairhmm_pairs is the plain version and counts no launch."""
    rng = np.random.default_rng(3)
    reads, haps = _random_region(rng, 5, 2)
    packed, rp = pairhmm.pack_reads(reads, nr=len(reads))
    e, hlen, _ = pairhmm.pack_haps(haps, rp, nh=len(haps))
    pools = pairhmm.make_pools(packed, packed["rlen"], e, hlen, CPU)
    ri, hi = (torch.from_numpy(a) for a in pairhmm.cartesian_pairs(len(reads), len(haps)))
    before = (pairhmm.pairhmm_pairs.launches, pairhmm.pairhmm_pairs.pairs)
    got = pairhmm.pairhmm_pairs(pools, ri, hi)
    assert torch.equal(got, pairhmm.pairhmm_pairs_reference(pools, ri, hi))
    assert (pairhmm.pairhmm_pairs.launches, pairhmm.pairhmm_pairs.pairs) == before

