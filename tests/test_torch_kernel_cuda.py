"""The hand-written PairHMM kernel (gatk_tpu_torch/csrc/pairhmm_fwd.cu) on the card.

Every test here needs a CUDA device: the kernel has no CPU mode, so without a
card they skip. The file imports neither jax nor gatk_tpu, so it also runs where
only the port is installed:

    python -m pytest tests/test_torch_kernel_cuda.py -m cuda -q
"""
import numpy as np
import pytest
import torch

from gatk_tpu_torch.ops import pairhmm

pytestmark = pytest.mark.cuda

TOL = 1e-4  # max |log10 kernel - log10 plain| above the floor


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _batch(rng, read_lens, hap_lens):
    """Reads and haplotypes cut from one random sequence with ~2% N (N on both
    sides), each read with a few errors of its own, so that pairs whose read
    fits in the haplotype score above the floor."""
    acgtn = np.frombuffer(b"ACGTN", dtype=np.uint8)
    span = max(max(read_lens), max(hap_lens))
    master = acgtn[np.where(rng.random(span) < 0.02, 4, rng.integers(0, 4, span))]

    def cut(n):
        s = int(rng.integers(0, span - n + 1))
        return master[s : s + n].copy()

    reads = []
    for n in read_lens:
        rb = cut(n)
        rb[rng.integers(0, n, 1 + n // 50)] = acgtn[rng.integers(0, 5, 1 + n // 50)]
        reads.append(dict(bases=rb.tobytes(), rq=rng.integers(10, 41, n).astype(np.uint8),
                          iq=rng.integers(30, 50, n).astype(np.uint8),
                          dq=rng.integers(30, 50, n).astype(np.uint8),
                          gcp=np.full(n, 10, np.uint8)))
    return reads, [cut(n).tobytes() for n in hap_lens]


def _pools(reads, haps, rp, hmax, device):
    packed, rp = pairhmm.pack_reads(reads, rp=rp, nr=len(reads))
    e, hlen, _ = pairhmm.pack_haps(haps, rp, hmax=hmax, nh=len(haps))
    pools = pairhmm.make_pools(packed, packed["rlen"], e, hlen, device)
    ri, hi = (torch.from_numpy(a).to(device) for a in pairhmm.cartesian_pairs(len(reads), len(haps)))
    return pools, ri, hi


@pytest.mark.parametrize("rp,hmax,read_lens,hap_lens", [
    (160, 512, range(1, 159, 3), (1, 7, 64, 200, 511, 512)),
    # reads over two and four 160-row stripes, as oversize regions give
    (320, 1024, (1, 150, 159, 160, 161, 240, 318), (1, 300, 1023, 1024)),
    (640, 2048, (200, 320, 481, 638), (5, 700, 2048)),
])
def test_kernel_matches_plain(cuda_device, rp, hmax, read_lens, hap_lens):
    rng = np.random.default_rng(rp + hmax)
    pools, ri, hi = _pools(*_batch(rng, read_lens, hap_lens), rp, hmax, cuda_device)
    got = pairhmm.pairhmm_pairs(pools, ri, hi)
    want = pairhmm.pairhmm_pairs_reference(pools, ri, hi)
    torch.cuda.synchronize()
    assert got.shape == want.shape and not got.isnan().any()
    ok = want > pairhmm.MIN_ACCEPTED_LOG10
    assert ok.any() and torch.equal(ok, got > pairhmm.MIN_ACCEPTED_LOG10)
    assert (got[ok] - want[ok]).abs().max().item() <= TOL


def test_launches_and_pairs_are_counted(cuda_device):
    rng = np.random.default_rng(5)
    pools, ri, hi = _pools(*_batch(rng, (100, 120, 151), (300, 400)), 160, 512, cuda_device)
    before = (pairhmm.pairhmm_pairs.launches, pairhmm.pairhmm_pairs.pairs)
    pairhmm.pairhmm_pairs(pools, ri, hi)
    assert (pairhmm.pairhmm_pairs.launches, pairhmm.pairhmm_pairs.pairs) == (
        before[0] + 1, before[1] + ri.numel())


def test_pool_batcher_on_card_equals_cpu(cuda_device):
    """The same regions through a pool on the card and on the CPU."""
    rng = np.random.default_rng(9)
    regions = [_batch(rng, rng.integers(50, 152, n_r), rng.integers(150, 500, n_h))
               for n_r, n_h in ((30, 3), (70, 2), (12, 6))]
    results = []
    for device in (cuda_device, torch.device("cpu")):
        batcher = pairhmm.PoolBatcher(device=device, nr_cap=65, nh_cap=9)
        handles = [batcher.add_region(reads, haps) for reads, haps in regions]
        batcher.flush()
        results.append([np.asarray(h, np.float64) for h in handles])
    for got, want in zip(*results):
        ok = want > pairhmm.MIN_ACCEPTED_LOG10
        assert np.array_equal(ok, got > pairhmm.MIN_ACCEPTED_LOG10)
        np.testing.assert_allclose(got[ok], want[ok], atol=TOL, rtol=0)


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    rng = np.random.default_rng(2)
    pools, ri, hi = _pools(*_batch(rng, (20, 30), (40,)), 160, 512, cuda_device)
    from gatk_tpu_torch.ops import _kernels

    with pytest.raises(ValueError, match="int32"):
        _kernels.pairhmm_fwd(pools, ri.long(), hi.long())
    with pytest.raises(ValueError, match="contiguous"):
        _kernels.pairhmm_fwd(pools._replace(rq=pools.rq.t().contiguous().t()), ri, hi)
