"""The dense flow scan as the sum of its live lattices, on the CPU.

gatk_tpu's dense scan (flow_pairhmm_batch_jax, its lax.scan on the CPU, on
its host packing _pack_flow_batch) never crosses (column - row) mod 4, so it
is the sum of four independent lattices, and only the ones that row 0 seeds
are nonzero. The port's plain version of that decomposition,
flow_pairhmm_live_plain (the structural oracle of csrc/flow_pairhmm_dense.cu),
is held to gatk_tpu's scan and to the port's dense plain version on the same
numpy-seeded reads and haplotypes, in flow orders that do and do not repeat
with period 4. Then the Python mirror of the coset kernel's shared-memory
need at its edges, and the CUDA entry's choice of kernel by that need, with
the kernels replaced by recorders on meta tensors.
"""
import math

import numpy as np
import pytest
import torch

from gatk_tpu.ops import flow as jax_flow
from gatk_tpu.ops import flow_pairhmm as jax_fp
from gatk_tpu_torch.ops import _kernels
from gatk_tpu_torch.ops import flow as port_flow
from gatk_tpu_torch.ops import flow_pairhmm as port_fp
from gatk_tpu_torch.utils import synthetic
from tests.test_torch_pairhmm import one_torch_thread  # noqa: F401

TOL = 1e-4  # |live - dense| per pair, log10: float32 rounding of the row scales and sums
ORDERS = ("TGCATGAC", "ACGTTGCA", "ACGTACTG", "TACGTGCA")


def _batch(seed, read_lens, hap_lens, order, edges=False):
    """The port's tables (on the CPU) and every (read, haplotype) pair of a
    synthetic.flow_batch in `order`, and gatk_tpu's dense result on the same
    pairs. With `edges`, read 0 has no flows and haplotype 1 none, in both
    packings, as the packers write such a read or haplotype."""
    hap_bases, read_specs = synthetic.flow_batch(seed, read_lens, hap_lens)
    tab = port_fp.pack_flow_tables(
        [port_flow.FlowBasedHaplotype(h, order) for h in hap_bases],
        [port_flow.FlowBasedRead(b, q, order, tp=tp) for b, q, tp in read_specs], "cpu")
    haps = [jax_flow.FlowBasedHaplotype(h, order) for h in hap_bases]
    reads = [jax_flow.FlowBasedRead(b, q, order, tp=tp) for b, q, tp in read_specs]
    pairs = [(r, h) for r in range(len(reads)) for h in range(len(haps))]
    packed = jax_fp._pack_flow_batch(haps, reads, pairs)
    ri = torch.tensor([p[0] for p in pairs], dtype=torch.int32)
    hi = torch.tensor([p[1] for p in pairs], dtype=torch.int32)
    if edges:
        for k, v in (("tables", 0), ("trans", 0), ("rlen", 0), ("rfo", port_fp.READ_PAD)):
            tab[k][0] = v
        for k, v in (("hkey", 0), ("hlen", 0), ("hfo", port_fp.HAP_PAD)):
            tab[k][1] = v
        for gone, key in (((ri == 0).numpy(), "rlen"), ((hi == 1).numpy(), "hlen")):
            packed["prior"][gone] = 0
            packed[key][gone] = 0
        packed["trans"][(ri == 0).numpy()] = 0
    want = np.asarray(jax_fp.flow_pairhmm_batch_jax(packed["prior"], packed["trans"],
                                                    packed["rlen"], packed["hlen"]))
    return tab, ri, hi, want


def _close(got, want):
    """Equal -inf and NaN sets, finite values within TOL."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    assert np.array_equal(fin, np.isfinite(got))
    if fin.any():
        assert np.abs(got[fin] - want[fin]).max() <= TOL


@pytest.mark.parametrize("order", ORDERS + ("TGCA",))
@pytest.mark.parametrize("seed,read_lens,hap_lens,edges", [
    (20, (40, 7, 120, 200, 31), (60, 250, 333, 101), True),  # ragged; no flows in read 0, hap 1
    (21, (200, 150, 90), (240, 260, 230), False),  # the flow phase's widths
    (22, (1, 2, 3, 5), (1, 2, 4, 9), False),  # tiny reads and haplotypes
])
def test_live_plain_matches_jax_and_dense_plain(order, seed, read_lens, hap_lens, edges):
    """flow_pairhmm_live_plain against gatk_tpu's dense scan and the port's
    dense plain version on the same pairs, in each order; a pair with no live
    lattice (the pairs without flows among them) gives -inf."""
    tab, ri, hi, want = _batch(seed, read_lens, hap_lens, order, edges)
    got = port_fp.flow_pairhmm_live_plain(tab, ri, hi)
    assert got.dtype == torch.float32
    _close(got.numpy(), want)
    _close(got.numpy(), port_fp.flow_pairhmm_dense_plain(tab, ri, hi).numpy())
    live = port_fp.live_residues(tab, ri, hi)
    assert live.shape == (len(ri), 4) and live.sum(dim=1).max() <= 2
    assert np.isneginf(got.numpy()[(live.sum(dim=1) == 0).numpy()]).all()
    if edges:
        assert not live[(ri == 0) | (hi == 1)].any()


def test_first_base_seeding_two_lattices():
    """In ACGTTGCA every base reads at two flows of different residues (A at
    flows 0 and 7): the reads' first flow, A, seeds two lattices of a
    haplotype long enough, and the sum of both gives gatk_tpu's result."""
    tab, ri, hi, want = _batch(23, (80, 120, 60, 150, 100, 70), (300, 280), "ACGTTGCA")
    assert (tab["rfo"][:, 0] == ord("A")).all()
    live = port_fp.live_residues(tab, ri, hi)
    assert (live[:, 0] & live[:, 3]).all() and not live[:, 1:3].any()
    _close(port_fp.flow_pairhmm_live_plain(tab, ri, hi).numpy(), want)


def test_four_live_lattices_sum_to_the_dense_scan():
    """Tables whose reads and haplotypes read one base at every flow: row 0
    seeds all four lattices, none dies, and their sum in the linear domain is
    gatk_tpu's scan of the same prior (flow_prior, equal bit for bit to its
    host packing) and the dense plain version's."""
    tab, ri, hi, _ = _batch(28, (70, 110), (90, 130), "TGCA")
    for fo, lens in (("rfo", "rlen"), ("hfo", "hlen")):
        inside = torch.arange(tab[fo].shape[1])[None, :] < tab[lens][:, None]
        tab[fo][inside] = ord("A")
    live = port_fp.live_residues(tab, ri, hi)
    assert live.all()
    for s in range(4):
        assert torch.isfinite(port_fp.flow_pairhmm_lattice_plain(
            tab, ri, hi, torch.full_like(ri, s))).all()
    prior = port_fp.flow_prior(tab, ri, hi).numpy()
    want = np.asarray(jax_fp.flow_pairhmm_batch_jax(prior, tab["trans"][ri.long()].numpy(),
                                                    tab["rlen"][ri.long()].numpy(),
                                                    tab["hlen"][hi.long()].numpy()))
    got = port_fp.flow_pairhmm_live_plain(tab, ri, hi).numpy()
    _close(got, want)
    _close(got, port_fp.flow_pairhmm_dense_plain(tab, ri, hi).numpy())


@pytest.mark.parametrize("order", ORDERS + ("TGCA",))
def test_unseeded_lattices_are_exactly_zero(order):
    """Every lattice that row 0 does not seed gives exactly -inf, on each
    residue of each pair. (A seeded one may die too, where the flow bases
    stop agreeing along it.)"""
    tab, ri, hi, _ = _batch(24, (90, 17, 160), (120, 200, 45), order)
    live = port_fp.live_residues(tab, ri, hi)
    finite = torch.zeros_like(live)
    for s in range(4):
        out = port_fp.flow_pairhmm_lattice_plain(tab, ri, hi, torch.full_like(ri, s))
        assert (out[~live[:, s]] == -math.inf).all()
        finite[:, s] = torch.isfinite(out)
    assert finite.any(dim=1).all()


def test_no_live_lattice_is_minus_inf():
    """A read whose first flow's table row is 0 seeds no lattice: -inf, as
    in gatk_tpu's scan of the same prior."""
    tab, ri, hi, _ = _batch(25, (60, 90), (120, 80), "TGCATGAC")
    tab["tables"][1, 0] = 0
    live = port_fp.live_residues(tab, ri, hi)
    assert not live[ri == 1].any() and live[ri == 0].any()
    got = port_fp.flow_pairhmm_live_plain(tab, ri, hi)
    assert (got[ri == 1] == -math.inf).all() and torch.isfinite(got[ri == 0]).all()
    _close(got.numpy(), port_fp.flow_pairhmm_dense_plain(tab, ri, hi).numpy())


@pytest.mark.parametrize("order", ("TGCA", "TGCATGAC"))
def test_wide_haplotype(order):
    """A haplotype of about 2,000 flows against gatk_tpu's scan."""
    tab, ri, hi, want = _batch(26, (150, 200), (1330,), order)
    assert 1900 <= tab["hkey"].shape[1] <= 2100
    _close(port_fp.flow_pairhmm_live_plain(tab, ri, hi).numpy(), want)


def test_lengths_out_of_range_are_nan():
    """rlen past Rp or hlen past Hp gives NaN, as in the kernels."""
    tab, ri, hi, _ = _batch(27, (40, 60), (50, 70), "TGCATGAC")
    tab["rlen"][0] = tab["rfo"].shape[1] + 1
    tab["hlen"][1] = -1
    got = port_fp.flow_pairhmm_live_plain(tab, ri, hi)
    bad = (ri == 0) | (hi == 1)
    assert got[bad].isnan().all() and torch.isfinite(got[~bad]).all()


@pytest.mark.parametrize("T1,Hp_max", [(1, 21115), (9, 21115), (10, 20987), (100, 20987),
                                       (185, 20987)])
def test_coset_shared_memory_mirror_at_its_edges(T1, Hp_max):
    """The Python mirror of csrc/flow_pairhmm.cu's flow_pairhmm_smem: the
    coset kernel's state fits shared memory up to Hp 21,115 flows where
    T1 <= 9 and up to 20,987 where 10 <= T1 <= 185; one flow more does not."""
    assert _kernels.flow_pairhmm_smem(Hp_max, T1) <= _kernels.FLOW_MAX_SMEM
    assert _kernels.flow_pairhmm_smem(Hp_max + 1, T1) > _kernels.FLOW_MAX_SMEM
    assert _kernels.flow_pairhmm_smem(507, T1) == 4 * 4 * 2 * (T1 + 7)  # registers, 4 warps


@pytest.mark.parametrize("Hp,dense", [(21115, False), (21116, True), (25036, True)])
def test_entry_routes_past_the_coset_width_to_the_dense_kernel(monkeypatch, Hp, dense):
    """The entry on tables that are not on the CPU (meta tensors here, the
    kernels replaced by recorders): past the coset kernel's shared memory it
    makes one dense launch over every pair and no coset launch, counted in
    dense.launches and dense.pairs; below it one coset launch."""
    calls = []

    def coset(tab, ri, hi):
        calls.append("coset")
        return torch.zeros(ri.numel()), torch.zeros(2, dtype=torch.int32)

    def dense_kernel(tab, ri, hi):
        calls.append(("dense", ri.numel()))
        return torch.zeros(ri.numel())

    monkeypatch.setattr(_kernels, "flow_pairhmm", coset)
    monkeypatch.setattr(_kernels, "flow_pairhmm_dense", dense_kernel)
    tab = {"tables": torch.empty((3, 300, 9), device="meta"),
           "hkey": torch.empty((2, Hp), dtype=torch.int32, device="meta")}
    ri, hi = torch.tensor([0, 1, 2, 0], dtype=torch.int32), torch.tensor([0, 0, 1, 1],
                                                                         dtype=torch.int32)
    entry = port_fp.flow_pairhmm_pairs
    before = (entry.launches, entry.pairs, entry.dense.launches, entry.dense.pairs)
    out = entry(tab, ri, hi)
    after = (entry.launches, entry.pairs, entry.dense.launches, entry.dense.pairs)
    assert out.shape == (4,)
    if dense:
        assert calls == [("dense", 4)]
        assert np.subtract(after, before).tolist() == [0, 0, 1, 4]
    else:
        assert calls == ["coset"]
        assert np.subtract(after, before).tolist() == [1, 4, 0, 0]
