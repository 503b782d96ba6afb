"""The port's cartesian PairHMM and its entry points for gatk_tpu's other pair
kernels, against gatk_tpu on the CPU.

Inputs are made with numpy from a seed and handed to both packages. The port
runs the plain PyTorch version of each entry (CPU tensors); gatk_tpu runs its
Pallas kernels in interpret mode, or, where a kernel cannot run so on the CPU,
the host f64 reference under the same N rule. The CUDA kernels themselves are
held against the plain versions by tests/test_torch_kernel_cuda.py on the card.
"""
import numpy as np
import pytest
import torch

from gatk_tpu.ops import pairhmm_host, pairhmm_tpu
from gatk_tpu_torch.ops import pairhmm
from tests.test_torch_pairhmm import one_torch_thread  # noqa: F401

TOL = 1e-4  # the kernel contract: log10 within 1e-4, above the f32 floor
RP, HMAX = 160, 256  # rp + hmax is a multiple of 8, so v5 runs
FLOOR = pairhmm.MIN_ACCEPTED_LOG10


def _n_region(seed, n_reads=16, n_haps=16):
    """Haplotypes: one 256 bp sequence with ~1% N sprinkled anew into each copy
    (and a base changed); reads: pieces of 30-150 bp of the sequence without N,
    each with one error of its own, one read with an N. Every read fits in
    every haplotype, so all pairs score above the floor."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    master = acgt[rng.integers(0, 4, HMAX)]
    haps = []
    for _ in range(n_haps):
        h = master.copy()
        h[rng.integers(0, HMAX, 2)] = acgt[rng.integers(0, 4, 2)]
        h[rng.random(HMAX) < 0.01] = ord("N")
        haps.append(h.tobytes())
    reads = []
    for k in range(n_reads):
        n = int(rng.integers(30, 151))
        s = int(rng.integers(0, HMAX - n + 1))
        rb = master[s : s + n].copy()
        rb[rng.integers(0, n)] = acgt[rng.integers(0, 4)]
        if k == 0:
            rb[n // 2] = ord("N")
        reads.append(dict(bases=rb.tobytes(), rq=rng.integers(10, 36, n).astype(np.uint8),
                          iq=rng.integers(30, 50, n).astype(np.uint8),
                          dq=rng.integers(30, 50, n).astype(np.uint8),
                          gcp=np.full(n, 10, np.uint8)))
    return reads, haps


def _host(reads, haps, ri, hi, hap_n_mismatch=False):
    """Host f64 log10 likelihoods of the pairs. For the mismatch rule every
    haplotype N becomes a byte no read base equals, which the host then scores
    as a mismatch unless the read base is N (a read N matches anything)."""
    def hap(h):
        return h.replace(b"N", b"X") if hap_n_mismatch else h

    return np.array([pairhmm_host.compute_log10_likelihood(
        hap(haps[h]), reads[r]["bases"], reads[r]["rq"], reads[r]["iq"], reads[r]["dq"],
        reads[r]["gcp"]) for r, h in zip(ri, hi)])


@pytest.fixture(scope="module")
def pair_batch():
    """256 pairs (16 reads x 16 haplotypes), packed pair-expanded by gatk_tpu."""
    reads, haps = _n_region(seed=4)
    ri, hi = pairhmm.cartesian_pairs(len(reads), len(haps))
    packed, rp, hmax, n = pairhmm_tpu.pack_batch(reads, haps, ri, hi, rp=RP, hmax=HMAX)
    assert (rp, hmax, n) == (RP, HMAX, 256) and packed["rbase"].shape[1] == 256
    return reads, haps, ri, hi, packed


@pytest.fixture(scope="module")
def pair_batch_host(pair_batch):
    """The host f64 values of pair_batch under each N rule: {hap_n_mismatch: (256,)}."""
    reads, haps, ri, hi, _ = pair_batch
    return {rule: _host(reads, haps, ri, hi, rule) for rule in (False, True)}


def _port(packed, name):
    pools, ri, hi = pairhmm.from_jax_packed(packed)
    return pairhmm.PAIR_VARIANTS[name](pools, ri, hi).numpy()


# the gatk_tpu pair kernels that run in Pallas interpret mode on the CPU
@pytest.mark.parametrize("name", ["_pairhmm_call", "_pairhmm_call_v2", "_pairhmm_call_v5",
                                  "_pairhmm_call_v6", "_pairhmm_call_v7"])
def test_variant_matches_its_pallas_kernel(pair_batch, name):
    """Each named entry point against its gatk_tpu function in interpret mode,
    within 1e-4, on 256 pairs whose haplotypes hold N: the port's entry applies
    the same haplotype-N rule as the Pallas kernel."""
    reads, haps, ri, hi, packed = pair_batch
    args = tuple(packed[k] for k in ("rbase", "rq", "iq", "dq", "gcp", "e", "rlen", "hlen"))
    want = np.asarray(getattr(pairhmm_tpu, name)(*args, rp=RP, hmax=HMAX, interpret=True))[0]
    got = _port(packed, name)
    assert got.shape == want.shape == (256,)
    assert (want > FLOOR).all()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_v4_matches_host_under_its_n_rule(pair_batch, pair_batch_host):
    """_pairhmm_call_v4 slices a value with pl.ds (pairhmm_tpu.py:520), which
    Pallas interpret mode refuses on the CPU, so its entry point is held against
    the host f64 reference under v4's rule instead: a haplotype N scores as a
    mismatch unless the read base is N (pairhmm_tpu.py:483-486)."""
    want = pair_batch_host[True]
    got = _port(pair_batch[-1], "_pairhmm_call_v4")
    assert (want > FLOOR).all()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("name,hap_n_mismatch", [
    ("_pairhmm_call", False), ("_pairhmm_call_v2", True), ("_pairhmm_call_v4", True),
    ("_pairhmm_call_v5", True), ("_pairhmm_call_v6", True), ("_pairhmm_call_v7", True)])
def test_variant_n_rule_is_the_one_it_names(pair_batch, pair_batch_host, name, hap_n_mismatch):
    """Each entry equals the host f64 reference under its own N rule and differs
    from the other rule on most pairs (where a haplotype N meets a read base)."""
    got = _port(pair_batch[-1], name)
    np.testing.assert_allclose(got, pair_batch_host[hap_n_mismatch], atol=TOL, rtol=0)
    assert (np.abs(got - pair_batch_host[not hap_n_mismatch]) > 1e-2).mean() > 0.5


def test_v5_entry_takes_any_shape():
    """v5's (rp + hmax) % 8 == 0 (pairhmm_tpu.py:1001) is a TPU layout rule: the
    port's v5 entry scores a shape that breaks it, like v2's entry does."""
    reads, haps = _n_region(seed=6, n_reads=5, n_haps=3)
    ri, hi = pairhmm.cartesian_pairs(len(reads), len(haps))
    packed, rp = pairhmm.pack_reads(reads, rp=163, nr=len(reads))
    e, hlen, hmax = pairhmm.pack_haps(haps, rp, hmax=258, nh=len(haps))
    assert (rp + hmax) % 8 != 0
    pools = pairhmm.make_pools(packed, packed["rlen"], e, hlen, "cpu")
    rit, hit = torch.from_numpy(ri), torch.from_numpy(hi)
    got = pairhmm.PAIR_VARIANTS["_pairhmm_call_v5"](pools, rit, hit).numpy()
    np.testing.assert_array_equal(
        got, pairhmm.PAIR_VARIANTS["_pairhmm_call_v2"](pools, rit, hit).numpy())
    np.testing.assert_allclose(got, _host(reads, haps, ri, hi, True), atol=TOL, rtol=0)


@pytest.fixture(scope="module")
def matrix_region():
    """6 haplotypes with N (padded by gatk_tpu's pack_haps to 8, the last two of
    length 0) and 16 reads (padded to 128 columns)."""
    reads, haps = _n_region(seed=5, n_reads=16, n_haps=6)
    packed, rp = pairhmm_tpu.pack_reads(reads, rp=RP)
    e, hlen, hmax = pairhmm_tpu.pack_haps(haps, rp, hmax=HMAX)
    assert packed["rbase"].shape == (RP, 128) and e.shape[1] == 8
    assert list(hlen[0, 6:]) == [0, 0]
    return reads, haps, packed, e, hlen


def test_matrix_reference_matches_pallas_matrix_kernel(matrix_region):
    """pairhmm_matrix_reference against _pairhmm_matrix_call in interpret mode
    (TPU kernel 2), the whole (NH, NR) matrix within 1e-4 above the floor and
    the same entries at or below it (the length-0 haplotypes' rows among them)."""
    reads, haps, packed, e, hlen = matrix_region
    args = tuple(packed[k] for k in ("rbase", "rq", "iq", "dq", "gcp")) + (e, packed["rlen"], hlen)
    want = np.asarray(pairhmm_tpu._pairhmm_matrix_call(*args, rp=RP, hmax=HMAX, interpret=True))
    pools, _, _ = pairhmm.from_jax_packed(dict(packed, e=e, hlen=hlen), cartesian=True)
    got = pairhmm.pairhmm_matrix_reference(pools).numpy()
    assert got.shape == want.shape == (8, 128)
    ok = want > FLOOR
    np.testing.assert_array_equal(ok, got > FLOOR)
    assert ok[:6, :16].all() and not ok[6:].any()
    assert (got[6:] == pairhmm.NEG_INF).all()
    np.testing.assert_allclose(got[ok], want[ok], atol=TOL, rtol=0)


def test_matrix_reference_matches_host(matrix_region):
    """The same matrix against the host f64 reference (an N on either side is a match)."""
    reads, haps, packed, e, hlen = matrix_region
    pools, _, _ = pairhmm.from_jax_packed(dict(packed, e=e, hlen=hlen), cartesian=True)
    got = pairhmm.pairhmm_matrix_reference(pools).numpy()[:6, :16]
    ri, hi = pairhmm.cartesian_pairs(16, 6)
    want = _host(reads, haps, ri, hi).reshape(6, 16)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_matrix_equals_pairs_over_the_cartesian_product(matrix_region):
    """The two plain versions agree: the matrix is the pair version over every
    read x haplotype, hap-major, bit for bit."""
    _, _, packed, e, hlen = matrix_region
    pools, ri, hi = pairhmm.from_jax_packed(dict(packed, e=e, hlen=hlen), cartesian=True)
    mat = pairhmm.pairhmm_matrix_reference(pools)
    pairs = pairhmm.pairhmm_pairs_reference(pools, ri, hi).reshape(mat.shape)
    assert torch.equal(mat, pairs)


def test_matrix_entry_on_cpu_is_the_plain_version_uncounted(matrix_region):
    _, _, packed, e, hlen = matrix_region
    pools, _, _ = pairhmm.from_jax_packed(dict(packed, e=e, hlen=hlen), cartesian=True)
    before = (pairhmm.pairhmm_matrix.launches, pairhmm.pairhmm_matrix.pairs)
    assert torch.equal(pairhmm.pairhmm_matrix(pools), pairhmm.pairhmm_matrix_reference(pools))
    assert (pairhmm.pairhmm_matrix.launches, pairhmm.pairhmm_matrix.pairs) == before


@pytest.mark.parametrize("entry", ["pairhmm_matrix", "pairhmm_pairs_hap_n_mismatch"])
def test_entries_never_fall_back_to_the_plain_version(entry):
    """Tensors that are not on the CPU go to the kernel's wrapper, which raises
    for anything but a CUDA device; no entry answers with its plain version."""
    reads, haps = _n_region(seed=8, n_reads=3, n_haps=2)
    packed, rp = pairhmm.pack_reads(reads, nr=3)
    e, hlen, _ = pairhmm.pack_haps(haps, rp, nh=2)
    pools = pairhmm.make_pools(packed, packed["rlen"], e, hlen, "meta")
    args = () if entry == "pairhmm_matrix" else tuple(
        torch.from_numpy(a).to("meta") for a in pairhmm.cartesian_pairs(3, 2))
    with pytest.raises(ValueError, match="not a CUDA device"):
        getattr(pairhmm, entry)(pools, *args)


def test_cartesian_route_goes_through_the_matrix_entry(monkeypatch):
    """start_likelihood_matrix scores a region with one call of pairhmm_matrix
    (on the CPU its plain version), not with the pair entry."""
    reads, haps = _n_region(seed=9, n_reads=7, n_haps=3)
    calls = []
    matrix = pairhmm.pairhmm_matrix

    def spy(pools):
        calls.append(tuple(pools.e.shape))
        return matrix(pools)

    def no_pairs(*args):
        raise AssertionError("the cartesian route called the pair entry")

    monkeypatch.setattr(pairhmm, "pairhmm_matrix", spy)
    monkeypatch.setattr(pairhmm, "pairhmm_pairs", no_pairs)
    got = pairhmm.compute_likelihood_matrix(reads, haps, device="cpu")
    assert len(calls) == 1 and calls[0][1] == 3
    ri, hi = pairhmm.cartesian_pairs(7, 3)
    want = _host(reads, haps, ri, hi).reshape(3, 7).T
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
