"""The chunked association of the copy-number HMM pass
(ops/cnv_hmm.hmm_forward_backward_chunked_reference, the plain version of
csrc/cnv_hmm.cu) on the CPU: against gatk_tpu's _hmm_forward_backward, and
against the float64 sequential pass on a GermlineCNVCaller-length chain.

Tolerances, and why:
  * against gatk_tpu's pass, run in float64 (jax.enable_x64) on the float32
    inputs: 1e-4 absolute on log posteriors, at every chunk length from 1
    step to more than the chain. gatk_tpu's float32 pass is no oracle for
    this: its log joints of 300 intervals reach |2e3|, where a float32 step
    is 1.2e-4, and it is 7e-4 off its float64 self on the coherent case;
  * against the float64 sequential pass at 4 x 10,000 x 6: 1e-3, and at
    least 10 times closer than the float32 sequential pass, whose log joints
    of |4e4| round in steps of 0.004 (the chunked pass forms none);
  * states whose emissions lie far below the data's (log posteriors of
    -6e3, as on a fitted shard, where a float32 rounding step is 4.9e-4):
    1e-4 plus two float32 rounding steps of the value (2^-22 of it) against
    gatk_tpu's pass in float64, and 1e-3 in all;
  * a scale per row of a chunk's transfer instead of one per matrix loses the
    start states' relative weights: more than 0.1 off float64.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from gatk_tpu_torch.ops import cnv_hmm
from tests.test_torch_cnv import _hmm_inputs, _jax_hmm
from tests.test_torch_pairhmm import one_torch_thread  # noqa: F401

# (S, T, C, stay): a coherent chain with two breaks, one interval, a break at
# every interval (stay 0), stay 1 (off-diagonal log transitions -inf), one
# state on every lane of a warp, one state, and more states than a warp has
# lanes (the kernel's vectors a warp wide, 2 states a lane)
CASES = {"coherent": (4, 300, 6, "coherent"), "T=1": (4, 1, 6, "none"),
         "break everywhere": (4, 40, 6, "break"), "stay=1": (4, 40, 6, "one"),
         "C=32": (3, 64, 32, "coherent"), "C=1": (2, 30, 1, "coherent"),
         "C=33": (3, 200, 33, "coherent"), "C=64": (2, 150, 64, "coherent")}
# chunk lengths, from one step to more than the chain
CHUNKS = {"1": lambda T: 1, "7": lambda T: 7, "64": lambda T: 64, "T-1": lambda T: max(1, T - 1),
          "T+5": lambda T: T + 5}


def _stay(rng, T, kind):
    if kind == "coherent":
        stay = np.exp(-rng.uniform(500, 3000, T - 1) / 10000.0)
        stay[[(T - 1) // 3, 2 * (T - 1) // 3]] = 0.0  # two chain breaks
        return stay
    return {"none": np.zeros(0), "break": np.zeros(T - 1), "one": np.ones(T - 1)}[kind]


@functools.lru_cache(maxsize=None)
def _case(name):
    """The case's float32 numpy inputs and gatk_tpu's log posteriors on them,
    computed in float64."""
    S, T, C, kind = CASES[name]
    rng = np.random.default_rng(9)
    args = _hmm_inputs(rng, S, T, C, _stay(rng, T, kind))
    with jax.enable_x64(True):
        want = _jax_hmm(*(a.astype(np.float64) for a in args))
    assert want.dtype == np.float64
    return args, want


@pytest.mark.parametrize("chunk", list(CHUNKS))
@pytest.mark.parametrize("case", list(CASES))
def test_chunked_plain_version_matches_gatk_tpu(case, chunk):
    args, want = _case(case)
    L = CHUNKS[chunk](args[0].shape[1])
    got = cnv_hmm.hmm_forward_backward_chunked_reference(*map(torch.as_tensor, args), chunk=L)
    assert got.shape == want.shape and torch.isfinite(got).all()
    np.testing.assert_allclose(got.double().numpy(), want, atol=1e-4, rtol=0)


@functools.lru_cache(maxsize=None)
def _long_chain():
    """4 samples x 10,000 intervals x 6 states with chain breaks, and the
    float64 sequential pass on it."""
    rng = np.random.default_rng(10)
    T = 10000
    stay = np.exp(-rng.uniform(500, 3000, T - 1) / 10000.0)
    stay[rng.integers(0, T - 1, 5)] = 0.0
    args = [torch.as_tensor(a) for a in _hmm_inputs(rng, 4, T, 6, stay)]
    return args, cnv_hmm.hmm_forward_backward_reference(*(a.double() for a in args))


def test_chunked_plain_version_is_closer_to_float64_than_the_sequential_one():
    args, want = _long_chain()
    chunked = cnv_hmm.hmm_forward_backward_chunked_reference(*args)
    sequential = cnv_hmm.hmm_forward_backward_reference(*args)
    err = (chunked.double() - want).abs().max().item()
    err_sequential = (sequential.double() - want).abs().max().item()
    assert err <= 1e-3
    assert 10 * err <= err_sequential


def test_chunked_plain_version_with_states_far_from_the_data():
    """Copy numbers 0 and 5 of a fitted shard: their log emissions lie
    thousands below the others', so their log posteriors do too."""
    rng = np.random.default_rng(12)
    S, T, C = 4, 1500, 6
    log_em, log_pi, stay = _hmm_inputs(rng, S, T, C, _stay(rng, T, "coherent"))
    log_em[:, :, 0] = rng.normal(-3000.0, 800.0, (S, T))
    log_em[:, :, -1] = rng.normal(-700.0, 200.0, (S, T))
    with jax.enable_x64(True):
        want = _jax_hmm(log_em.astype(np.float64), log_pi.astype(np.float64),
                        stay.astype(np.float64))
    got = cnv_hmm.hmm_forward_backward_chunked_reference(
        *map(torch.as_tensor, (log_em, log_pi, stay))).double().numpy()
    assert np.abs(want).max() > 4096
    assert np.abs(got - want).max() <= 1e-3
    assert (np.abs(got - want) <= 1e-4 + 2.0 ** -22 * np.abs(want)).all()


@pytest.mark.parametrize("chunk", [1, 7])
def test_a_scale_per_row_loses_the_start_weights(monkeypatch, chunk):
    """The transfer's rows scaled each on its own (their log-scales dropped)
    instead of by one common scale: far off float64, where the common scale
    is within 1e-4."""
    args = [torch.as_tensor(a) for a in _case("coherent")[0]]
    want = cnv_hmm.hmm_forward_backward_reference(*(a.double() for a in args))
    good = cnv_hmm.hmm_forward_backward_chunked_reference(*args, chunk=chunk)
    transfers = cnv_hmm._transfers

    def per_row(*a):
        rows, acc = transfers(*a)
        return rows, torch.zeros_like(acc)

    monkeypatch.setattr(cnv_hmm, "_transfers", per_row)
    bad = cnv_hmm.hmm_forward_backward_chunked_reference(*args, chunk=chunk)
    assert (good.double() - want).abs().max().item() <= 1e-4
    assert (bad.double() - want).abs().max().item() > 0.1
