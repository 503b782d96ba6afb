"""The hand-written kernels (gatk_tpu_torch/csrc/pairhmm_fwd.cu,
csrc/pairhmm_matrix.cu, csrc/cnv_hmm.cu, csrc/flow_pairhmm.cu and
csrc/flow_pairhmm_dense.cu) on the card.

Every test here needs a CUDA device: the kernels have no CPU mode, so without a
card they skip. The file imports neither jax nor gatk_tpu, so it also runs where
only the port is installed:

    python -m pytest tests/test_torch_kernel_cuda.py -m cuda -q
"""
import numpy as np
import pytest
import torch

from gatk_tpu_torch.ops import cnv_hmm, pairhmm

pytestmark = pytest.mark.cuda

TOL = 1e-4  # max |log10 kernel - log10 plain| above the floor


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
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


def _assert_close(got, want):
    torch.cuda.synchronize()
    assert got.shape == want.shape and not got.isnan().any()
    ok = want > pairhmm.MIN_ACCEPTED_LOG10
    assert ok.any() and torch.equal(ok, got > pairhmm.MIN_ACCEPTED_LOG10)
    assert (got[ok] - want[ok]).abs().max().item() <= TOL


@pytest.mark.parametrize("rp,hmax,read_lens,hap_lens", [
    (160, 512, range(1, 159, 5), (1, 7, 64, 200, 511, 512, 0)),
    # reads over two 160-row stripes, haplotypes up to the largest bucket
    (320, 2048, (1, 150, 159, 160, 161, 240, 318), (0, 1, 300, 1023, 2047, 2048)),
    # more haplotypes than the pool holds, as PoolBatcher sends to this route
    (160, 512, (40, 100, 151, 158), tuple(range(100, 500, 5)) * 14),
    # past the last bucket: _bucket rounds hmax to multiples of 2048
    (320, 4096, (151, 300), (2500, 4096)),
])
def test_matrix_kernel_matches_plain(cuda_device, rp, hmax, read_lens, hap_lens):
    """Kernel 2 against pairhmm_matrix_reference on every read x haplotype,
    length-0 haplotypes (NEG_INF) included."""
    rng = np.random.default_rng(rp + hmax + len(hap_lens))
    lens = [max(h, 1) for h in hap_lens]
    reads, haps = _batch(rng, read_lens, lens)
    haps = [h if n else b"" for h, n in zip(haps, hap_lens)]
    packed, rp = pairhmm.pack_reads(reads, rp=rp, nr=len(reads))
    e, hlen, _ = pairhmm.pack_haps(haps, rp, hmax=hmax, nh=len(haps))
    pools = pairhmm.make_pools(packed, packed["rlen"], e, hlen, cuda_device)
    before = (pairhmm.pairhmm_matrix.launches, pairhmm.pairhmm_matrix.pairs)
    got = pairhmm.pairhmm_matrix(pools)
    assert (pairhmm.pairhmm_matrix.launches, pairhmm.pairhmm_matrix.pairs) == (
        before[0] + 1, before[1] + len(reads) * len(haps))
    want = pairhmm.pairhmm_matrix_reference(pools)
    _assert_close(got, want)
    empty = torch.tensor([n == 0 for n in hap_lens], device=cuda_device)
    assert (got[empty] == pairhmm.NEG_INF).all()


@pytest.mark.parametrize("rp,hmax", [(160, 512), (320, 2048)])
def test_hap_n_mismatch_instance_matches_plain(cuda_device, rp, hmax):
    """The pair kernel's hap-N-mismatch instance against its plain version, and
    unlike the default instance wherever a haplotype N meets a read base."""
    rng = np.random.default_rng(rp)
    read_lens = (30, 80, 151, 158) if rp == 160 else (151, 200, 318)
    reads, haps = _batch(rng, read_lens, (100, 300, hmax))
    # Ns of the haplotypes' own, where the reads have a base
    haps = [np.where(rng.random(len(h)) < 0.02, ord("N"), np.frombuffer(h, np.uint8))
            .astype(np.uint8).tobytes() for h in haps]
    pools, ri, hi = _pools(reads, haps, rp, hmax, cuda_device)
    got = pairhmm.pairhmm_pairs_hap_n_mismatch(pools, ri, hi)
    _assert_close(got, pairhmm.pairhmm_pairs_reference(pools, ri, hi, hap_n_mismatch=True))
    default = pairhmm.pairhmm_pairs(pools, ri, hi)
    ok = got > pairhmm.MIN_ACCEPTED_LOG10
    assert ((got - default)[ok].abs() > 1e-3).any()


def test_matrix_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    from gatk_tpu_torch.ops import _kernels

    rng = np.random.default_rng(3)
    pools, _, _ = _pools(*_batch(rng, (20, 30), (40, 50)), 160, 512, cuda_device)
    with pytest.raises(ValueError, match="uint8"):
        _kernels.pairhmm_matrix(pools._replace(rq=pools.rq.int()))
    with pytest.raises(ValueError, match="int32"):
        _kernels.pairhmm_matrix(pools._replace(hlen=pools.hlen.long()))
    with pytest.raises(ValueError, match="haplotype-major"):  # e row-major
        _kernels.pairhmm_matrix(pools._replace(e=pools.e.contiguous()))
    with pytest.raises(ValueError, match="all operands must be on"):
        _kernels.pairhmm_matrix(pools._replace(rlen=pools.rlen.cpu()))
    with pytest.raises(ValueError, match="not a CUDA device"):
        _kernels.pairhmm_matrix(pairhmm.Pools(*(t.cpu() for t in pools)))


def test_cartesian_route_launches_the_matrix_kernel_and_raises_on_failure(cuda_device,
                                                                          monkeypatch):
    """start_likelihood_matrix on the card is one pairhmm_matrix launch; when the
    kernel cannot be built or launched it raises instead of falling back."""
    from gatk_tpu_torch.ops import _kernels

    rng = np.random.default_rng(4)
    reads, haps = _batch(rng, (60, 120, 151), (200, 300))
    before = (pairhmm.pairhmm_matrix.launches, pairhmm.pairhmm_pairs.launches)
    got = pairhmm.compute_likelihood_matrix(reads, haps, device=cuda_device)
    assert (pairhmm.pairhmm_matrix.launches, pairhmm.pairhmm_pairs.launches) == (
        before[0] + 1, before[1])
    want = pairhmm.compute_likelihood_matrix(reads, haps, device="cpu")
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)

    def broken(name):
        raise RuntimeError("nvcc failed for csrc/pairhmm_matrix.cu")

    monkeypatch.setattr(_kernels, "library", broken)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        pairhmm.compute_likelihood_matrix(reads, haps, device=cuda_device)


# Read lengths at every edge of the lane groups (4, 8, 16 and 32 lanes of 5 rows:
# 20, 40, 80, 160 rows) and past one 160-row stripe.
GROUP_EDGES = (1, 19, 20, 21, 39, 40, 41, 79, 80, 81, 159, 160, 161)


def _edge_batch(seed, hap_n=0.0):
    """Reads at every group edge with haplotypes of lengths from 1 to 512 (rp
    320, hmax 512), every read with every haplotype, the pair list shuffled."""
    rng = np.random.default_rng(seed)
    hap_lens = (1, 512, *rng.integers(1, 513, 10))
    reads, haps = _batch(rng, GROUP_EDGES, hap_lens)
    if hap_n:
        haps = [np.where(rng.random(len(h)) < hap_n, ord("N"), np.frombuffer(h, np.uint8))
                .astype(np.uint8).tobytes() for h in haps]
    return reads, haps, rng


@pytest.mark.parametrize("hap_n_mismatch", [False, True])
def test_pair_kernel_at_group_edges_in_a_shuffled_list(cuda_device, hap_n_mismatch):
    """Both N-rule instances against the plain version at every group edge, in
    one launch over a shuffled pair list; each result comes back at its pair's
    index, bit for bit what the unshuffled list gives."""
    reads, haps, rng = _edge_batch(11 + hap_n_mismatch, hap_n=0.02 if hap_n_mismatch else 0.0)
    pools, ri, hi = _pools(reads, haps, 320, 512, cuda_device)
    entry = pairhmm.pairhmm_pairs_hap_n_mismatch if hap_n_mismatch else pairhmm.pairhmm_pairs
    order = torch.from_numpy(rng.permutation(ri.numel())).to(cuda_device)
    ri_s, hi_s = ri[order].contiguous(), hi[order].contiguous()
    got = entry(pools, ri_s, hi_s)
    _assert_close(got, pairhmm.pairhmm_pairs_reference(pools, ri_s, hi_s, hap_n_mismatch))
    assert torch.equal(got, entry(pools, ri, hi)[order])


@pytest.mark.parametrize("hap_n_mismatch", [False, True])
def test_pair_kernel_instances_at_the_narrowest_width(cuda_device, hap_n_mismatch):
    """Reads of at most 20 rows (groups of 4 lanes, 8 pairs a warp) with
    haplotype Ns, under each N rule."""
    rng = np.random.default_rng(21)
    reads, haps = _batch(rng, rng.integers(1, 21, 40), (15, 60, 300))
    haps = [np.where(rng.random(len(h)) < 0.05, ord("N"), np.frombuffer(h, np.uint8))
            .astype(np.uint8).tobytes() for h in haps]
    pools, ri, hi = _pools(reads, haps, 160, 512, cuda_device)
    entry = pairhmm.pairhmm_pairs_hap_n_mismatch if hap_n_mismatch else pairhmm.pairhmm_pairs
    _assert_close(entry(pools, ri, hi),
                  pairhmm.pairhmm_pairs_reference(pools, ri, hi, hap_n_mismatch))


@pytest.mark.parametrize("seed,read_lens", [
    (31, GROUP_EDGES),
    # a region whose reads span all four widths, in no order
    (32, tuple(np.random.default_rng(32).integers(1, 161, 150)) + (161, 318)),
])
def test_matrix_kernel_at_group_edges(cuda_device, seed, read_lens):
    """The cartesian kernel against its plain version over reads of every
    width, with haplotypes of lengths from 1 to 512; out[h, r] in the caller's
    read order."""
    rng = np.random.default_rng(seed)
    reads, haps = _batch(rng, read_lens, (1, 512, *rng.integers(1, 513, 10)))
    pools, ri, hi = _pools(reads, haps, 320, 512, cuda_device)
    got = pairhmm.pairhmm_matrix(pools)
    _assert_close(got, pairhmm.pairhmm_matrix_reference(pools))
    _assert_close(got.reshape(-1), pairhmm.pairhmm_pairs(pools, ri, hi))


def test_kernels_write_nan_for_out_of_range_pairs(cuda_device):
    """Indices outside the pools and reads longer than rp - 1 give NaN, beside
    pairs that are scored."""
    rng = np.random.default_rng(41)
    pools, ri, hi = _pools(*_batch(rng, (10, 50, 120), (80, 200)), 160, 512, cuda_device)
    ri = torch.cat([ri, torch.tensor([-1, 3, 0], dtype=torch.int32, device=cuda_device)])
    hi = torch.cat([hi, torch.tensor([0, 0, 2], dtype=torch.int32, device=cuda_device)])
    got = pairhmm.pairhmm_pairs(pools, ri, hi)
    torch.cuda.synchronize()
    assert got[-3:].isnan().all() and not got[:-3].isnan().any()
    long_read = pools._replace(rlen=pools.rlen.clone().fill_(200))
    assert pairhmm.pairhmm_matrix(long_read).isnan().all()


@pytest.mark.parametrize("reads_only", [False, True])
def test_plan_kernels_order_as_the_plain_plan(cuda_device, reads_only):
    """The counting sort the launchers run (csrc/pairhmm_sweep.cuh) gives the
    segments of _kernels.plan_groups and the same keys in the same order; only
    items with equal keys may come in another order."""
    from gatk_tpu_torch.ops import _kernels

    rng = np.random.default_rng(51)
    reads, haps = _batch(rng, (*GROUP_EDGES, *rng.integers(1, 319, 60)),
                         (1, 512, *rng.integers(1, 513, 6)))
    pools, ri, hi = _pools(reads, haps, 320, 512, cuda_device)
    order = torch.from_numpy(rng.permutation(ri.numel())).to(cuda_device)
    ri, hi = ri[order].contiguous(), hi[order].contiguous()
    if reads_only:
        rows, hlen = pools.rlen.cpu(), None
        got_perm, got_seg = _kernels.plan_on_card(pools)
    else:
        rows, hlen = pools.rlen.cpu()[ri.cpu().long()], pools.hlen.cpu()[hi.cpu().long()]
        got_perm, got_seg = _kernels.plan_on_card(pools, ri, hi)
    want_perm, want_seg = _kernels.plan_groups(rows, hlen, pools.hmax)
    got_perm = got_perm.cpu().long()
    assert torch.equal(got_seg.cpu(), want_seg)
    assert torch.equal(torch.sort(got_perm).values, torch.arange(len(rows)))
    lanes = ((rows.long() + 4) // 5).clamp(1, 32)
    keys = [rows.long() > 20, rows.long() > 40, rows.long() > 80, lanes]
    if hlen is not None:
        keys.insert(3, hlen.long())
    for k in keys:
        assert torch.equal(k[got_perm], k[want_perm])


# the HMM kernel's log posteriors (as chip_smoke.py holds them): within 1e-3
# of the float64 sequential plain version; within the float32 sequential
# version's own distance from float64 plus 1e-3 of that version (the chunked
# pass associates the sums otherwise); within 1e-4 plus two float32 rounding
# steps of the value of the chunked plain version; the argmax state of
# float64 wherever its top two differ by > 0.1
HMM_TOL_F64, HMM_TOL_CHUNKED, HMM_CHUNKED_ULPS, HMM_ARGMAX_GAP = 1e-3, 1e-4, 2, 0.1


def _within_chunked(got, chunked):
    """|got - chunked| <= HMM_TOL_CHUNKED + HMM_CHUNKED_ULPS float32 steps of chunked."""
    a = chunked.abs()
    ulp = torch.nextafter(a, torch.full_like(a, float("inf"))) - a
    return bool(((got - chunked).abs() <= HMM_TOL_CHUNKED + HMM_CHUNKED_ULPS * ulp).all())


def _hmm_inputs(rng, S, T, C, stay, device, far=False):
    """Log emissions around -5, per-sample priors with p_alt 1e-6 off a
    baseline state, and the given stay probabilities, on the device. With
    far, the first and last states' emissions lie far below the data's
    (around -3,000 and -700), as a fitted shard's copy numbers 0 and 5 do."""
    log_em = rng.normal(-5.0, 3.0, (S, T, C))
    if far:
        log_em[:, :, 0] = rng.normal(-3000.0, 800.0, (S, T))
        log_em[:, :, -1] = rng.normal(-700.0, 200.0, (S, T))
    base = rng.integers(0, C, (S, 1, 1))
    pi = np.where(np.arange(C)[None, None, :] == base, 1.0 - (C - 1) * 1e-6, 1e-6)
    log_pi = np.broadcast_to(np.log(pi), (S, T, C))
    return [torch.tensor(np.ascontiguousarray(a, np.float32), device=device)
            for a in (log_em, log_pi, stay)]


L = cnv_hmm.CHUNK


@pytest.mark.parametrize("S,T,C,stay", [
    (32, 10000, 6, "coherent"),  # a GermlineCNVCaller shard, with chain breaks
    (3, 1, 6, "none"),  # one interval: no transition
    (4, 50, 6, "break"),  # a chain break at every interval (stay 0)
    (4, 50, 6, "one"),  # stay 1: off-diagonal log transitions are -inf
    (5, 37, 32, "coherent"),  # one state on every lane
    (2, 9, 1, "coherent"),
    (4, L, 6, "coherent"),  # the chunks' edges: one chunk of L - 1 steps,
    (4, L + 1, 6, "coherent"),  # one chunk of L steps,
    (4, 2 * L + 1, 6, "coherent"),  # two full chunks,
    (6, 1000, 6, "coherent"),  # and a last chunk shorter than L
    (3, 700, 13, "coherent"),  # C > 8: groups of 32 lanes, over several chunks
    (8, 3000, 6, "far"),  # states far from the data: log posteriors of -6e3
    (3, 700, 33, "coherent"),  # C > 32: a warp a vector, 2 states a lane,
    (2, 300, 64, "coherent"),  # 2 full,
    (2, 300, 100, "far"),  # 4, the last lane part full,
    (2, 300, 257, "coherent"),  # 9, one state in the last
])
def test_cnv_hmm_kernel_matches_plain(cuda_device, S, T, C, stay):
    rng = np.random.default_rng(S * T + C)
    coherent = stay in ("coherent", "far")
    stays = np.exp(-rng.uniform(500, 3000, max(T - 1, 0)) / 10000.0) if coherent else {
        "break": np.zeros(T - 1), "one": np.ones(T - 1), "none": np.zeros(0)}[stay]
    if coherent:
        stays[rng.integers(0, T - 1, max(1, T // 2000))] = 0.0
    args = _hmm_inputs(rng, S, T, C, stays, cuda_device, far=stay == "far")
    entry = cnv_hmm.hmm_forward_backward
    before = (entry.passes, entry.launches, entry.cells)
    got = entry(*args)
    # the kernels of a pass: the logs of stay when there is a transition, the
    # transfers when there are two chunks, the scan and the posteriors
    kernels = int(T > 1) + int(T - 1 > L) + 2
    assert (entry.passes, entry.launches, entry.cells) == (
        before[0] + 1, before[1] + kernels, before[2] + S * T * C)
    want64 = cnv_hmm.hmm_forward_backward_reference(*(a.double() for a in args))
    want32 = cnv_hmm.hmm_forward_backward_reference(*args)
    chunked = cnv_hmm.hmm_forward_backward_chunked_reference(*args)
    torch.cuda.synchronize()
    assert got.shape == (S, T, C) and torch.isfinite(got).all()
    plain_err_f64 = (want32.double() - want64).abs().max().item()
    assert (got.double() - want64).abs().max().item() <= HMM_TOL_F64
    assert (got - want32).abs().max().item() <= plain_err_f64 + HMM_TOL_F64
    assert _within_chunked(got, chunked)
    if C > 1:
        top2 = want64.topk(2, dim=-1).values
        clear = top2[..., 0] - top2[..., 1] > HMM_ARGMAX_GAP
        assert torch.equal(got.argmax(-1)[clear], want64.argmax(-1)[clear])


@pytest.mark.parametrize("chunk,C", [(1, 6), (3, 6), (64, 6), (256, 6), (3, 40), (64, 40)])
def test_cnv_hmm_kernel_at_other_chunks(cuda_device, chunk, C):
    """The kernel at chunk lengths other than the entry's, against the chunked
    plain version at the same length."""
    from gatk_tpu_torch.ops import _kernels

    rng = np.random.default_rng(chunk)
    stays = np.exp(-rng.uniform(500, 3000, 599) / 10000.0)
    stays[[100, 450]] = 0.0
    args = _hmm_inputs(rng, 5, 600, C, stays, cuda_device)
    got = _kernels.cnv_hmm(*args, chunk=chunk)
    want = cnv_hmm.hmm_forward_backward_chunked_reference(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert _within_chunked(got, want)


def test_cnv_hmm_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    from gatk_tpu_torch.ops import _kernels

    rng = np.random.default_rng(3)
    em, lp, stay = _hmm_inputs(rng, 2, 10, 6, np.full(9, 0.9), cuda_device)
    with pytest.raises(ValueError, match="float32"):
        _kernels.cnv_hmm(em.double(), lp.double(), stay.double())
    with pytest.raises(ValueError, match="contiguous"):
        _kernels.cnv_hmm(em.transpose(0, 1).contiguous().transpose(0, 1), lp, stay)
    with pytest.raises(ValueError, match="stay"):
        _kernels.cnv_hmm(em, lp, stay[:5])
    with pytest.raises(ValueError, match="C > 0"):
        empty = torch.zeros((2, 10, 0), device=cuda_device)
        _kernels.cnv_hmm(empty, empty, stay)
    with pytest.raises(ValueError, match="chunk"):
        _kernels.cnv_hmm(em, lp, stay, chunk=0)


def test_germline_cnv_caller_on_card_at_33_states(cuda_device, tmp_path):
    """GermlineCNVCaller --device cuda --max-copy-number 32 (C = 33, a warp a
    vector in the HMM kernel) runs to its end on the CPU tests' small cohort,
    every pass on the card; its copy numbers lie in 0..32, and its HMM pass
    of the fitted model is within HMM_TOL_F64 of the float64 plain version."""
    import contextlib
    import io
    import os

    from gatk_tpu_torch import cli
    from gatk_tpu_torch.cnv import denoising
    from gatk_tpu_torch.utils import synthetic

    coh = synthetic.write_cnv_cohort(str(tmp_path), seed=1, n_samples=6, n_intervals=300,
                                     n_events=6, event_len=(10, 15), factor_sd=0.05)
    inputs = sum((["-I", p] for p in coh["counts"]), [])
    fit = denoising.GermlineDenoisingModel.fit
    models = []

    def keep(self, *args, **kwargs):
        models.append(self)
        return fit(self, *args, **kwargs)

    entry = cnv_hmm.hmm_forward_backward
    passes = entry.passes
    with contextlib.redirect_stdout(io.StringIO()):
        assert cli.main(["DetermineGermlineContigPloidy", *inputs, "--contig-ploidy-priors",
                         coh["ploidy_priors"], "-O", str(tmp_path), "--output-prefix",
                         "ploidy"]) == 0
        denoising.GermlineDenoisingModel.fit = keep
        try:
            assert cli.main(["GermlineCNVCaller", *inputs, "--contig-ploidy-calls",
                             str(tmp_path / "ploidy-calls"), "-O", str(tmp_path),
                             "--output-prefix", "gcnv", "--max-bias-factors", "0",
                             "--max-copy-number", "32", "--device", "cuda"]) == 0
        finally:
            denoising.GermlineDenoisingModel.fit = fit
    (model,) = models
    assert model.C == 33 and entry.passes > passes
    cn = np.load(os.path.join(tmp_path, "gcnv-calls", "cn.npy"))
    assert cn.shape == (6, 300) and cn.min() >= 0 and cn.max() <= 32
    with torch.no_grad():
        log_em = model._emission(model.params).contiguous()
        log_pi, stay = model._prior_and_trans()
    args = (log_em, log_pi.contiguous(), stay.contiguous())
    got = entry(*args)
    want64 = cnv_hmm.hmm_forward_backward_reference(*(a.double() for a in args))
    torch.cuda.synchronize()
    assert (got.double() - want64).abs().max().item() <= HMM_TOL_F64


# --------------------------------------------------------------------------- flow PairHMM


def _flow_tables(seed, read_lens, hap_lens, device, edges=False, hap_order=None):
    """The flow kernel's inputs for every (read, haplotype) pair of a batch of
    utils/synthetic.flow_batch: the tables on `device` and ri, hi int32. With
    `edges`, read 0 has no flows and haplotype 1 none, as the packer writes
    such a read or haplotype (a batch of one haplotype gains a copy of it as
    haplotype 1, which Hp and so W do not change); `hap_order` puts haplotype
    1 in that flow order."""
    from gatk_tpu_torch.ops import flow, flow_pairhmm
    from gatk_tpu_torch.utils import synthetic

    hap_bases, read_specs = synthetic.flow_batch(seed, read_lens, hap_lens)
    haps = [flow.FlowBasedHaplotype(h) for h in hap_bases]
    if hap_order:
        haps[1] = flow.FlowBasedHaplotype(hap_bases[1], hap_order)
    reads = [flow.FlowBasedRead(b, q, tp=tp) for b, q, tp in read_specs]
    tab = flow_pairhmm.pack_flow_tables(haps, reads, device)
    if edges:
        if len(haps) == 1:
            for k in ("hkey", "hlen", "hfo"):
                tab[k] = torch.cat([tab[k], tab[k]])
        for k, v in (("tables", 0), ("trans", 0), ("rlen", 0), ("rfo", flow_pairhmm.READ_PAD)):
            tab[k][0] = v
        for k, v in (("hkey", 0), ("hlen", 0), ("hfo", flow_pairhmm.HAP_PAD)):
            tab[k][1] = v
    nh = tab["hkey"].shape[0]
    idx = torch.arange(len(reads) * nh, dtype=torch.int32, device=device)
    return tab, idx // nh, idx % nh


def _flow_dense(tab, ri, hi):
    """gatk_tpu's dense scan in the port on the same pairs, the second oracle."""
    from gatk_tpu_torch.ops import flow_pairhmm

    return flow_pairhmm.flow_pairhmm_batch_plain(flow_pairhmm.flow_prior(tab, ri, hi),
                                                 tab["trans"][ri], tab["rlen"][ri],
                                                 tab["hlen"][hi])


def _flow_close(got, want):
    torch.cuda.synchronize()
    assert got.shape == want.shape and not got.isnan().any()
    fin = torch.isfinite(want)
    assert torch.equal(fin, torch.isfinite(got)) and (got[~fin] == -np.inf).all()
    assert (got[fin] - want[fin]).abs().max().item() <= TOL


@pytest.mark.parametrize("seed,read_lens,hap_lens,edges", [
    (0, (40, 7, 120, 200, 31), (60, 250, 333, 101), True),  # ragged; W = 5 + Hp
    (1, (200,), (300,), False),  # B = 1
    (2, (1, 2, 3, 5), (1, 2, 4, 9), True),  # tiny reads and haplotypes
    (3, range(20, 220, 20), (180, 240, 600, 420), True),
    (6, (50, 80, 120), (150,), True),  # W = 232, a multiple of 4 (the others: 495, 471, 26, 857)
    (7, (60, 150), (900, 40), True),  # Hp over 507 flows: the state in shared memory
])
def test_flow_kernel_matches_plain(cuda_device, seed, read_lens, hap_lens, edges):
    from gatk_tpu_torch.ops import _kernels, flow_pairhmm

    tab, ri, hi = _flow_tables(seed, read_lens, hap_lens, cuda_device, edges)
    Rp, Hp = tab["rfo"].shape[1], tab["hkey"].shape[1]
    assert int(tab["rlen"].max()) == Rp  # a pair with rlen = Rp
    if seed == 7:
        assert (Hp + 8) // 4 > 32 * 4
    got, bad = _kernels.flow_pairhmm(tab, ri, hi)
    _flow_close(got, flow_pairhmm.flow_pairhmm_pairs_plain(tab, ri, hi))
    _flow_close(got, _flow_dense(tab, ri, hi))
    assert bad.tolist() == [0, 0]
    if edges:
        assert (got[(ri == 0) | (hi == 1)] == -np.inf).all()


def test_flow_entry_launches_and_counts(cuda_device):
    from gatk_tpu_torch.ops import flow, flow_pairhmm
    from gatk_tpu_torch.utils import synthetic

    hap_bases, read_specs = synthetic.flow_batch(4, (150, 90, 210), (260, 300))
    haps = [flow.FlowBasedHaplotype(h) for h in hap_bases]
    reads = [flow.FlowBasedRead(b, q, tp=tp) for b, q, tp in read_specs]
    entry = flow_pairhmm.flow_pairhmm_pairs
    launches, pairs = entry.launches, entry.pairs
    got = flow_pairhmm.compute_flow_likelihood_matrix(haps, reads, device=cuda_device)
    assert entry.launches == launches + 1 and entry.pairs == pairs + 6
    want = flow_pairhmm.compute_flow_likelihood_matrix(haps, reads, device="cpu")
    assert np.abs(got - want).max() <= TOL
    host = np.array([[flow_pairhmm.flow_pairhmm_log10(h, r) for h in haps] for r in reads])
    assert np.abs(got - host).max() <= 2e-3


def test_flow_threads_share_the_card(cuda_device):
    """Six host threads (ShardedCaller's) score their batches at once: each
    gets its own result."""
    from concurrent.futures import ThreadPoolExecutor

    from gatk_tpu_torch.ops import _kernels, flow_pairhmm

    batches = [_flow_tables(10 + s, (60 + 20 * s, 150, 33), (200, 170 + 30 * s), cuda_device)
               for s in range(6)]
    want = [flow_pairhmm.flow_pairhmm_pairs_plain(*b) for b in batches]
    with ThreadPoolExecutor(6) as pool:
        got = list(pool.map(lambda b: [_kernels.flow_pairhmm(*b)[0] for _ in range(20)], batches))
    for g, w in zip(got, want):
        for x in g:
            _flow_close(x, w)


def test_flow_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    from gatk_tpu_torch.ops import _kernels

    tab, ri, hi = _flow_tables(5, (30, 40), (50,), cuda_device)
    with pytest.raises(ValueError, match="not a CUDA device"):
        _kernels.flow_pairhmm({k: v.cpu() for k, v in tab.items()}, ri, hi)
    with pytest.raises(ValueError, match="float32"):
        _kernels.flow_pairhmm(dict(tab, tables=tab["tables"].double()), ri, hi)
    with pytest.raises(ValueError, match="int32"):
        _kernels.flow_pairhmm(dict(tab, rlen=tab["rlen"].long()), ri, hi)
    with pytest.raises(ValueError, match="int32"):
        _kernels.flow_pairhmm(tab, ri.long(), hi)
    with pytest.raises(ValueError, match="contiguous"):
        t = tab["tables"]
        _kernels.flow_pairhmm(dict(tab, tables=t.transpose(1, 2).contiguous().transpose(1, 2)),
                              ri, hi)
    with pytest.raises(ValueError, match="shared memory"):
        wide = 30000
        _kernels.flow_pairhmm(dict(tab, hkey=torch.zeros((1, wide), dtype=torch.int32,
                                                         device=cuda_device),
                                   hfo=torch.zeros((1, wide), dtype=torch.uint8,
                                                   device=cuda_device)), ri, hi * 0)


def _off_rule_tables(seed, read_lens, hap_lens, device, order="TGCATGAC", hap_only=False):
    """_flow_tables with every haplotype, and unless `hap_only` every read, in
    a flow order that does not repeat with period 4."""
    from gatk_tpu_torch.ops import flow, flow_pairhmm
    from gatk_tpu_torch.utils import synthetic

    hap_bases, read_specs = synthetic.flow_batch(seed, read_lens, hap_lens)
    haps = [flow.FlowBasedHaplotype(h, order) for h in hap_bases]
    reads = [flow.FlowBasedRead(b, q, "TGCA" if hap_only else order, tp=tp)
             for b, q, tp in read_specs]
    tab = flow_pairhmm.pack_flow_tables(haps, reads, device)
    nh = len(haps)
    idx = torch.arange(len(reads) * nh, dtype=torch.int32, device=device)
    return tab, idx // nh, idx % nh


@pytest.mark.parametrize("seed,read_lens,hap_lens,order,hap_only", [
    (8, (80, 120), (90, 110), "TGCATGAC", True),
    (9, (40, 7, 120, 200, 31), (60, 250, 333, 101), "TGCATGAC", False),
    (10, (1, 2, 3, 5), (1, 2, 4, 9), "ACGTTGCA", False),  # tiny reads and haplotypes
    (11, (200, 150, 90), (240, 260, 230), "TGCATGAC", False),  # the flow phase's widths
    (12, (60, 150), (900, 40), "ACGTACTG", True),  # W over 1,000: the state in shared memory
    (13, (60,), (4500,), "TGCATGAC", True),  # Hp 7,051: the state in shared memory
])
def test_flow_dense_kernel_matches_plain(cuda_device, seed, read_lens, hap_lens, order, hap_only):
    """The dense kernel against its plain version (gatk_tpu's dense scan on the
    gathered prior) on pairs whose flow orders break the coset rule (but for
    the tiny reads and haplotypes, whose few flows can keep it)."""
    from gatk_tpu_torch.ops import _kernels, flow_pairhmm

    tab, ri, hi = _off_rule_tables(seed, read_lens, hap_lens, cuda_device, order, hap_only)
    route = _kernels.flow_pairhmm_dense_layout(tab["hkey"].shape[1], tab["tables"].shape[2])[0]
    assert route == ("shared" if seed in (12, 13) else "registers")
    broken = flow_pairhmm.rule_broken_pairs(tab, ri, hi)
    assert broken.any() and (seed == 10 or broken.all())
    got = _kernels.flow_pairhmm_dense(tab, ri, hi)
    _flow_close(got, _flow_dense(tab, ri, hi))
    assert torch.isfinite(got).any()


@pytest.mark.parametrize("Hp,route", [(507, "registers"), (508, "registers"), (891, "registers"),
                                      (892, "shared"), (19323, "shared"), (19324, "device")])
def test_flow_dense_kernel_at_the_shared_memory_edge(cuda_device, Hp, route):
    """The dense kernel on tables widened to Hp haplotype flows (columns that
    match no read flow, as pack_flow_tables pads them) on either side of each
    edge of its state routes: 4 | 5 and 7 | 8 cells a lane (Hp 507 | 508,
    where the register route's state grows a cell, and 891 | 892, where it
    leaves the registers) and the widest state the warp's
    shared memory holds beside its row buffers at T1 = 8 (19,323 | 19,324):
    it launches and gives its plain version's result on every route."""
    from gatk_tpu_torch.ops import _kernels, flow_pairhmm

    tab, ri, hi = _off_rule_tables(14, (60, 90), (300, 120), cuda_device)
    assert tab["tables"].shape[2] == 8
    pad = Hp - tab["hkey"].shape[1]
    tab["hkey"] = torch.nn.functional.pad(tab["hkey"], (0, pad))
    tab["hfo"] = torch.nn.functional.pad(tab["hfo"], (0, pad), value=flow_pairhmm.HAP_PAD)
    assert _kernels.flow_pairhmm_dense_layout(Hp, 8)[0] == route
    got = _kernels.flow_pairhmm_dense(tab, ri, hi)
    _flow_close(got, _flow_dense(tab, ri, hi))
    assert torch.isfinite(got).all()


@pytest.mark.parametrize("seed,read_lens,hap_lens,route", [
    (15, (120, 200, 35), (450, 380), "registers"),  # Hp 672: 6 cells a lane
    (16, (80, 150), (1000, 300), "shared"),
    (17, (100, 60), (13000,), "device"),  # Hp ~19,600: one wide task a pair
])
def test_flow_dense_kernel_on_each_state_route(cuda_device, seed, read_lens, hap_lens, route):
    """The dense kernel on haplotypes as wide as the tables, in TGCATGAC, on
    each route of its state, against gatk_tpu's dense scan (its plain
    version) and the sum of the live lattices (flow_pairhmm_live_plain)."""
    from gatk_tpu_torch.ops import _kernels, flow_pairhmm

    tab, ri, hi = _off_rule_tables(seed, read_lens, hap_lens, cuda_device)
    Hp, T1 = tab["hkey"].shape[1], tab["tables"].shape[2]
    assert _kernels.flow_pairhmm_dense_layout(Hp, T1)[0] == route
    got = _kernels.flow_pairhmm_dense(tab, ri, hi)
    _flow_close(got, _flow_dense(tab, ri, hi))
    _flow_close(got, flow_pairhmm.flow_pairhmm_live_plain(tab, ri, hi))
    assert torch.isfinite(got).any()


def test_flow_smem_mirror_equals_the_library(cuda_device):
    """ops/_kernels.flow_pairhmm_smem, which the entry routes by, equals the
    coset kernel's own flow_pairhmm_smem."""
    import ctypes

    from gatk_tpu_torch.ops import _kernels

    lib = _kernels.library("flow_pairhmm")
    warps = ctypes.c_int(0)
    for Hp in (0, 1, 507, 508, 584, 4000, 20987, 20988, 21115, 21116, 21200, 25036):
        for T1 in (1, 8, 9, 10, 100, 185, 186, 1000):
            assert _kernels.flow_pairhmm_smem(Hp, T1) == lib.flow_pairhmm_smem(
                Hp, T1, ctypes.byref(warps)), (Hp, T1)


def test_flow_entry_past_the_coset_width_launches_the_dense_kernel(cuda_device):
    """A haplotype of 21,200 flows (T1 8), past the 21,115 the coset kernel's
    shared memory holds: the entry makes one dense launch over every pair and
    no coset launch, and gives the dense plain version's values and
    gatk_tpu's answer on the CPU, [-10.36303616, -10.9987011]."""
    from gatk_tpu_torch.ops import _kernels, flow, flow_pairhmm
    from gatk_tpu_torch.utils import synthetic

    hap_bases, read_specs = synthetic.flow_batch(0, (200, 200), (14000,))
    haps = [flow.FlowBasedHaplotype(h) for h in hap_bases]
    reads = [flow.FlowBasedRead(b, q, tp=tp) for b, q, tp in read_specs]
    tab = flow_pairhmm.pack_flow_tables(haps, reads, cuda_device)
    assert tab["hkey"].shape[1] == 21200 and tab["tables"].shape[2] == 8
    assert _kernels.flow_pairhmm_smem(21200, 8) > _kernels.FLOW_MAX_SMEM
    assert _kernels.flow_pairhmm_dense_layout(21200, 8)[0] == "device"
    entry = flow_pairhmm.flow_pairhmm_pairs
    before = (entry.launches, entry.dense.launches, entry.dense.pairs)
    got = flow_pairhmm.compute_flow_likelihood_matrix(haps, reads, device=cuda_device)
    assert (entry.launches, entry.dense.launches, entry.dense.pairs) == (
        before[0], before[1] + 1, before[2] + 2)
    ri, hi = torch.tensor([0, 1], dtype=torch.int32, device=cuda_device), torch.zeros(
        2, dtype=torch.int32, device=cuda_device)
    want = flow_pairhmm.flow_pairhmm_dense_plain(tab, ri, hi)
    _flow_close(torch.from_numpy(got.ravel()).float().to(cuda_device), want)
    assert np.abs(got.ravel() - [-10.36303616, -10.9987011]).max() <= TOL


def test_flow_entry_scores_an_order_that_is_not_4_periodic(cuda_device):
    """Haplotype 1 in an 8-letter flow order that does not repeat with period
    4: the coset kernel flags it as coset_rule_breaks does, and the entry
    scores the pairs of haplotype 1 with the dense kernel (one launch, counted)
    and the others with the coset kernel: the dense plain version's result on
    the first, the coset plain version's on the others."""
    from gatk_tpu_torch.ops import _kernels, flow_pairhmm

    tab, ri, hi = _flow_tables(8, (80, 120), (90, 110), cuda_device, hap_order="TGCATGAC")
    _, bad = _kernels.flow_pairhmm(tab, ri, hi)
    assert bad.tolist() == flow_pairhmm.coset_rule_breaks(tab, ri, hi).tolist() == [0, 2]
    entry = flow_pairhmm.flow_pairhmm_pairs
    launches, dense, dense_pairs = entry.launches, entry.dense.launches, entry.dense.pairs
    got = entry(tab, ri, hi)
    assert entry.launches == launches + 1
    assert (entry.dense.launches, entry.dense.pairs) == (dense + 1, dense_pairs + 2)
    broken = hi == 1
    _flow_close(got[broken], _flow_dense(tab, ri[broken], hi[broken]))
    _flow_close(got[~broken], flow_pairhmm.flow_pairhmm_pairs_plain(tab, ri[~broken], hi[~broken]))
    keep = hi == 0
    got = entry(tab, ri[keep], hi[keep])
    assert entry.dense.launches == dense + 1
    _flow_close(got, flow_pairhmm.flow_pairhmm_pairs_plain(tab, ri[keep], hi[keep]))
