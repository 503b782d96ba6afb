"""Batched PairHMM on an NVIDIA GPU: the PyTorch port of gatk_tpu/ops/pairhmm_tpu.py.

log10 P(read | haplotype) for lists of (read, haplotype) pairs by GATK's logless
3-state forward recurrence (utils/pairhmm/LoglessPairHMM.java:48-70) in f32, with
the initial deletion row rescaled from 2^1020 to 2^INIT_LOG2 / hapLen and the
final-row M+I sum taken in linear f32. Results at or below MIN_ACCEPTED_LOG10
(including NaN) are either clamped to it or recomputed on the host in f64
(`pairhmm_host`), as the reference's native kernel does.

Layout (the same as gatk_tpu's pack_reads / pack_haps): read tables are
(rp, NR) with row 0 the boundary and read base k in row k+1; haplotypes are
stored reversed in an (He, NH) array, He = hmax + 2*rp + E_OFF, so that
haplotype base k sits at row E_OFF + rp - 1 + hmax - 1 - k.

Two kernels compute every pair, each behind an entry with launch and pair
counters. On a CUDA tensor an entry launches its hand-written Hopper kernel and
raises if the launch fails; on a CPU tensor it runs its plain PyTorch version,
which is also the kernel's oracle:
  * `pairhmm_pairs(pools, ri, hi)` scores pair p = (read column ri[p],
    haplotype column hi[p]) of device-resident uint8 pools
    (csrc/pairhmm_fwd.cu; plain version `pairhmm_pairs_reference`). The pool
    flush of `PoolBatcher` and `compute_log10_likelihoods` go through it.
  * `pairhmm_matrix(pools)` scores every read column with every haplotype
    column (csrc/pairhmm_matrix.cu; plain version `pairhmm_matrix_reference`).
    The cartesian route `start_likelihood_matrix` (-ERC GVCF, and the regions
    too large for the pool) goes through it.
Both kernels sweep a read with a group of 4, 8, 16 or 32 lanes chosen by its
length; the kernel wrappers (ops/_kernels) order the pairs or reads by group
width on the device (`_kernels.plan_groups`) and get the results back in the
caller's order, so nothing here depends on the order the kernels take.

Haplotype N: an N on either side scores as a match, as in the host f64 model
(pairhmm_model.base_priors) and gatk_tpu's CPU scan and matrix kernel.
gatk_tpu's other pair kernels (v2, v4-v7, the production v6 among them) score
a haplotype N as a mismatch; `pairhmm_pairs_hap_n_mismatch` is the pair
kernel's instance with that rule, and `PAIR_VARIANTS` maps each of gatk_tpu's
pair-kernel functions to the port's entry with its rule.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import NamedTuple

import numpy as np
import torch

from ..devices import resolve_device
from ..utils import trace

LN10 = math.log(10.0)
LN2 = math.log(2.0)
N_BASE = ord("N")
TRISTATE_CORRECTION = 3.0
LANES = 128
INIT_LOG2 = 100  # initial condition 2^100 / hapLen (vs Java's 2^1020; log-corrected)
MIN_ACCEPTED_LOG10 = -28.0  # below this, clamp or recompute in f64 on host (GKL contract)
NEG_INF = -1e30
E_OFF = 16  # bottom padding rows of the packed haplotype array (gatk_tpu layout)

# shape buckets of the packed layout (gatk_tpu/ops/pairhmm_tpu.py:1146-1149);
# kept so that pack_* produce the same arrays as gatk_tpu's
RP_BUCKETS = (160, 320)
HMAX_BUCKETS = (256, 512, 1024, 2048)
NR_BLOCK_BUCKETS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128)
NH_BUCKETS = (8, 16, 32, 64, 128)


def _round_up(x, m):
    return ((x + m - 1) // m) * m


def _bucket(value, buckets):
    for b in buckets:
        if value <= b:
            return b
    return _round_up(value, buckets[-1])


def _as_u8(x):
    return (np.frombuffer(bytes(x), dtype=np.uint8) if isinstance(x, (bytes, bytearray))
            else np.asarray(x, dtype=np.uint8))


# ---------------------------------------------------------------------------
# Host packing (numpy; same arrays as gatk_tpu's pack_batch / pack_reads / pack_haps)
# ---------------------------------------------------------------------------


def pack_batch(reads, haps, pair_read_idx, pair_hap_idx, rp=None, hmax=None):
    """Pack reads/haps into the pair-expanded wavefront layout.

    reads: list of dicts with keys bases (bytes/uint8), rq, iq, dq, gcp (uint8 arrays)
    haps: list of bytes/uint8 haplotype bases
    pair_read_idx/pair_hap_idx: int arrays of pair definitions
    Returns (dict of int32 arrays, rp, hmax, n_pairs); columns are padded to a
    multiple of LANES with rlen = hlen = 1 dummies.
    """
    n_pairs = len(pair_read_idx)
    max_r = max(len(r["bases"]) for r in reads)
    max_h = max(len(h) for h in haps)
    rp = rp or _bucket(max_r + 2, RP_BUCKETS)
    hmax = hmax or _bucket(max_h, HMAX_BUCKETS)
    if max_r > rp - 2 or max_h > hmax:
        raise ValueError(f"bucket too small: R={max_r}->rp={rp}, H={max_h}->hmax={hmax}")
    n = _round_up(max(n_pairs, 1), LANES)
    packed, _ = pack_reads(reads, rp=rp, nr=len(reads))
    e_h, hlen_h, _ = pack_haps(haps, rp, hmax=hmax, nh=len(haps))
    ri = np.asarray(pair_read_idx, np.int64)
    hi = np.asarray(pair_hap_idx, np.int64)
    pad_cols = n - n_pairs

    def sel(mat, idx, fill=0):
        picked = mat[:, idx]
        if pad_cols:
            picked = np.concatenate([picked, np.full((mat.shape[0], pad_cols), fill, mat.dtype)],
                                    axis=1)
        return picked

    out = {k: sel(packed[k], ri) for k in ("rbase", "rq", "iq", "dq", "gcp")}
    out["e"] = sel(e_h, hi)
    out["rlen"] = sel(packed["rlen"], ri, fill=1)
    out["hlen"] = sel(hlen_h, hi, fill=1)
    return out, rp, hmax, n_pairs


def pack_reads(reads, rp=None, nr=None):
    """Pack read data into (rp, NR) int32 arrays (NR padded to LANES unless given)."""
    max_r = max(len(r["bases"]) for r in reads)
    rp = rp or _bucket(max_r + 2, RP_BUCKETS)
    if max_r > rp - 2:
        raise ValueError(f"read bucket too small: {max_r} -> rp={rp}")
    if nr is None:
        nr = LANES * _bucket(-(-max(len(reads), 1) // LANES), NR_BLOCK_BUCKETS)
    elif len(reads) > nr:
        raise ValueError(f"nr target too small: {len(reads)} > {nr}")
    out = {k: np.zeros((rp, nr), np.int32) for k in ("rbase", "rq", "iq", "dq", "gcp")}
    rlen = np.ones((1, nr), np.int32)
    for k, r in enumerate(reads):
        b = _as_u8(r["bases"])
        L = len(b)
        rlen[0, k] = L
        out["rbase"][1 : L + 1, k] = b
        for key in ("rq", "iq", "dq", "gcp"):
            out[key][1 : L + 1, k] = _as_u8(r[key])
    out["rlen"] = rlen
    return out, rp


def pack_haps(haps, rp, hmax=None, nh=None):
    """Pack haplotypes into the reversed-extended (He, NH) int32 array + lengths;
    pad columns carry hlen = 0."""
    max_h = max(len(h) for h in haps)
    hmax = hmax or _bucket(max_h, HMAX_BUCKETS)
    if max_h > hmax:
        raise ValueError(f"hap bucket too small: {max_h} -> hmax={hmax}")
    if nh is None:
        nh = _bucket(len(haps), NH_BUCKETS)
    elif len(haps) > nh:
        raise ValueError(f"nh target too small: {len(haps)} > {nh}")
    e = np.zeros((hmax + 2 * rp + E_OFF, nh), np.int32)
    hlen = np.zeros((1, nh), np.int32)
    p = rp - 1
    for k, h in enumerate(haps):
        b = _as_u8(h)
        hlen[0, k] = len(b)
        e[E_OFF + p + hmax - len(b) : E_OFF + p + hmax, k] = b[::-1]
    return e, hlen, hmax


# ---------------------------------------------------------------------------
# Device pools and the pair entry point
# ---------------------------------------------------------------------------


class Pools(NamedTuple):
    """Packed reads and haplotypes on one device, as uint8 (lengths as int32):
    rbase, rq, iq, dq, gcp (rp, NR); rlen (NR,); e (He, NH), stored
    haplotype-major (strides (1, He): each haplotype one row of bytes, the
    layout the kernels read); hlen (NH,)."""

    rbase: torch.Tensor
    rq: torch.Tensor
    iq: torch.Tensor
    dq: torch.Tensor
    gcp: torch.Tensor
    rlen: torch.Tensor
    e: torch.Tensor
    hlen: torch.Tensor

    @property
    def rp(self) -> int:
        return self.rbase.shape[0]

    @property
    def hmax(self) -> int:
        return self.e.shape[0] - 2 * self.rp - E_OFF


def make_pools(read_tables, rlen, e, hlen, device) -> Pools:
    """Pools on `device` from host arrays: read_tables maps rbase/rq/iq/dq/gcp to
    (rp, NR) arrays with values in 0..255; e is (He, NH), uploaded haplotype-major;
    rlen/hlen any shape with NR/NH elements."""

    def u8(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint8)).to(device)

    def i32(a):
        return torch.from_numpy(np.ascontiguousarray(np.reshape(a, -1), dtype=np.int32)).to(device)

    return Pools(*(u8(read_tables[k]) for k in ("rbase", "rq", "iq", "dq", "gcp")),
                 i32(rlen), u8(np.transpose(e)).t(), i32(hlen))


def cartesian_pairs(nr: int, nh: int):
    """Hap-major (ri, hi) int32 index lists over all nr reads x nh haplotypes:
    pair p = h * nr + r."""
    ri = np.tile(np.arange(nr, dtype=np.int32), nh)
    hi = np.repeat(np.arange(nh, dtype=np.int32), nr)
    return ri, hi


def from_jax_packed(packed: dict, device="cpu", cartesian: bool = False):
    """Pools and pair index lists from gatk_tpu's packed numpy arrays.

    packed: gatk_tpu.ops.pairhmm_tpu.pack_batch's dict (pair-expanded columns:
    pair k is read column k with haplotype column k), or pack_reads's dict merged
    with pack_haps's ``e`` and ``hlen`` (pass cartesian=True: every read with every
    haplotype, hap-major). Returns (Pools, ri, hi) with ri/hi int32 tensors on
    `device`."""
    pools = make_pools(packed, packed["rlen"], packed["e"], packed["hlen"], device)
    nr, nh = pools.rbase.shape[1], pools.e.shape[1]
    if cartesian:
        ri, hi = cartesian_pairs(nr, nh)
    else:
        if nr != nh:
            raise ValueError(f"pair-expanded input needs as many read as haplotype "
                             f"columns, got {nr} and {nh}")
        ri = hi = np.arange(nr, dtype=np.int32)
    return pools, torch.from_numpy(ri).to(device), torch.from_numpy(hi).to(device)


def _forward(rbase, rq, iq, dq, gcp, rlen, e, hlen, rp, hmax, hap_n_mismatch):
    """The plain wavefront over any broadcast of reads against haplotypes.

    rbase..gcp: (rp, *R) read tables, rlen (*R); e: (He, *H) packed haplotypes,
    hlen (*H); R and H broadcast to the output shape S. Anti-diagonal wavefront
    on (rp, *S) f32 state, with padded read rows (i > rlen) carrying X through
    (tmi = tii = 1) to the last row, whose M + X is summed over j = 1..hlen.
    The sweep stops after diagonal rp - 1 + max(hlen); later diagonals add
    nothing. Haplotypes of length 0 give NEG_INF."""
    dev = rbase.device
    f32 = torch.float32
    neg = -LN10 / 10.0
    e_ins = torch.exp(iq.to(f32) * neg)
    e_del = torch.exp(dq.to(f32) * neg)
    e_gcp = torch.exp(gcp.to(f32) * neg)
    e_base = torch.exp(rq.to(f32) * neg)
    rbase = rbase.to(torch.int32)
    rlen = rlen.to(torch.int64)
    hlen = hlen.to(torch.int64)
    shape = torch.broadcast_shapes(rlen.shape, hlen.shape)

    iota = torch.arange(rp, device=dev).view(rp, *([1] * len(shape)))
    pad = iota > rlen[None]
    zero = torch.zeros((), dtype=f32, device=dev)
    one = torch.ones((), dtype=f32, device=dev)
    tmm = torch.where(pad, zero, one - torch.minimum(one, e_ins + e_del))
    tim = torch.where(pad, zero, one - e_gcp)
    tmi = torch.where(pad, one, e_ins)
    tii = torch.where(pad, one, e_gcp)
    tmd = torch.where(pad, zero, e_del)
    tdd = torch.where(pad, zero, e_gcp)
    peq = torch.where(pad, zero, one - e_base)
    pne = torch.where(pad, zero, e_base * (1.0 / TRISTATE_CORRECTION))

    y0 = torch.where(hlen > 0, (2.0 ** INIT_LOG2) / hlen.clamp(min=1).to(f32), zero)
    row0 = iota == 0
    y0_full = torch.where(row0, y0[None], zero)  # (rp, *H)
    e = e.to(torch.int32, memory_format=torch.contiguous_format)  # pools hold e haplotype-major

    zeros = torch.zeros((rp, *shape), dtype=f32, device=dev)
    m1, x1, y1 = zeros, zeros, y0_full.expand(rp, *shape)  # diagonal d-1 (d = 0: cell (0, 0))
    m2, x2, y2 = zeros, zeros, zeros  # diagonal d-2
    acc = torch.zeros(shape, dtype=f32, device=dev)
    last = rp - 1
    num_d = rp - 1 + min(int(hlen.max()), hmax)

    def roll1(x):
        return torch.roll(x, 1, dims=0)

    for d in range(1, num_d + 1):
        start = E_OFF + hmax + rp - 1 - d
        w = e[start : start + rp]  # W[i] = hap[d - i - 1]
        match = (rbase == w) | (rbase == N_BASE)
        if not hap_n_mismatch:
            match = match | (w == N_BASE)
        prior = torch.where(match, peq, pne)
        m_new = prior * (tmm * roll1(m2) + tim * (roll1(x2) + roll1(y2)))
        x_new = tmi * roll1(m1) + tii * roll1(x1)
        y_new = tmd * m1 + tdd * y1
        jvalid = iota <= d - 1  # rows with j = d - i >= 1
        interior = jvalid & ~row0
        m_new = torch.where(interior, m_new, zero)
        x_new = torch.where(interior, x_new, zero)
        y_new = torch.where(row0, y0_full, torch.where(jvalid, y_new, zero))
        j_here = d - last
        if j_here >= 1:
            c = m_new[last] + x_new[last]
            acc = acc + torch.where(j_here <= hlen, c, zero)
        m2, x2, y2 = m1, x1, y1
        m1, x1, y1 = m_new, x_new, y_new
    return torch.where(
        acc > 0,
        (torch.log(torch.clamp(acc, min=1e-44)) - INIT_LOG2 * LN2) * (1.0 / LN10),
        torch.full_like(acc, NEG_INF),
    )


def pairhmm_pairs_reference(pools: Pools, ri: torch.Tensor, hi: torch.Tensor,
                            hap_n_mismatch: bool = False) -> torch.Tensor:
    """Plain PyTorch PairHMM over a pair list: (n,) f32 log10 likelihoods.

    The math of gatk_tpu's _pairhmm_scan_call (pairhmm_tpu.py:1059-1134) taken
    over pairs instead of a cartesian product. hap_n_mismatch=False scores an N
    on either side as a match (the host rule and the scan's); True scores a
    haplotype N as a mismatch unless the read base is N too, as gatk_tpu's
    kernels v2 and v4-v7 do (their pne = peq only where the read base is N)."""
    if ri.numel() == 0:
        return torch.empty(0, dtype=torch.float32, device=pools.rbase.device)
    ri = ri.long()
    hi = hi.long()
    return _forward(*(t[:, ri] for t in (pools.rbase, pools.rq, pools.iq, pools.dq, pools.gcp)),
                    pools.rlen[ri], pools.e[:, hi], pools.hlen[hi], pools.rp, pools.hmax,
                    hap_n_mismatch)


def pairhmm_matrix_reference(pools: Pools) -> torch.Tensor:
    """Plain PyTorch PairHMM over every read column x every haplotype column of
    `pools`: (NH, NR) f32 log10 likelihoods, hap-major, with NEG_INF for
    haplotypes of length 0. The math of gatk_tpu's _pairhmm_scan_call
    (pairhmm_tpu.py:1059-1134), the oracle of its _pairhmm_matrix_call; an N on
    either side scores as a match (:228)."""
    return _forward(*(t[:, None, :] for t in (pools.rbase, pools.rq, pools.iq, pools.dq,
                                              pools.gcp)),
                    pools.rlen[None, :], pools.e[:, :, None], pools.hlen[:, None], pools.rp,
                    pools.hmax, False)


class _Counted:
    """`launches` and `pairs` count kernel launches and the pairs they scored;
    the plain version is not counted."""

    def __init__(self):
        self._lock = threading.Lock()
        self.launches = 0
        self.pairs = 0

    def reset(self):
        with self._lock:
            self.launches = 0
            self.pairs = 0

    def _count(self, pairs):
        with self._lock:
            self.launches += 1
            self.pairs += pairs


class _PairEntry(_Counted):
    """`pairhmm_pairs(pools, ri, hi)`: CUDA tensors launch the Hopper kernel
    (ops/_kernels.pairhmm_fwd), CPU tensors run pairhmm_pairs_reference, both
    with this entry's haplotype-N rule."""

    def __init__(self, hap_n_mismatch=False):
        super().__init__()
        self.hap_n_mismatch = hap_n_mismatch

    def __call__(self, pools: Pools, ri: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
        if pools.rbase.device.type == "cpu":
            return pairhmm_pairs_reference(pools, ri, hi, self.hap_n_mismatch)
        if ri.numel() == 0:
            return torch.empty(0, dtype=torch.float32, device=pools.rbase.device)
        from . import _kernels

        out = _kernels.pairhmm_fwd(pools, ri, hi, hap_n_mismatch=self.hap_n_mismatch)
        self._count(ri.numel())
        return out


class _MatrixEntry(_Counted):
    """`pairhmm_matrix(pools)` -> (NH, NR): CUDA tensors launch the cartesian
    Hopper kernel (ops/_kernels.pairhmm_matrix), CPU tensors run
    pairhmm_matrix_reference. `pairs` counts NR x NH per launch."""

    def __call__(self, pools: Pools) -> torch.Tensor:
        if pools.rbase.device.type == "cpu":
            return pairhmm_matrix_reference(pools)
        from . import _kernels

        out = _kernels.pairhmm_matrix(pools)
        self._count(out.numel())
        return out


# the pair kernel with the host's N rule: the pool flush and compute_log10_likelihoods
pairhmm_pairs = _PairEntry()
# the same kernel's instance that scores a haplotype N as a mismatch
pairhmm_pairs_hap_n_mismatch = _PairEntry(hap_n_mismatch=True)
# the cartesian kernel: start_likelihood_matrix (-ERC GVCF, oversize regions)
pairhmm_matrix = _MatrixEntry()


# The port's entry point for each of gatk_tpu's pair kernels (TPU kernels 1 and
# 3-7), by the rule the kernel applies to an N in the haplotype. They differ
# from one another otherwise only in TPU scheduling (lane widths, v4's
# interleaved chains, v5's groups of 8 diagonals and its (rp + hmax) % 8 == 0
# rule, v7's loop-carried state), which does not carry over to the GPU.
PAIR_VARIANTS = {
    "_pairhmm_call": pairhmm_pairs,  # v1: an N on either side matches (pairhmm_tpu.py:113)
    # a haplotype N mismatches unless the read base is N (pne = peq only there)
    "_pairhmm_call_v2": pairhmm_pairs_hap_n_mismatch,  # pairhmm_tpu.py:372-375
    "_pairhmm_call_v4": pairhmm_pairs_hap_n_mismatch,  # :483-486
    "_pairhmm_call_v5": pairhmm_pairs_hap_n_mismatch,  # :677-680
    "_pairhmm_call_v6": pairhmm_pairs_hap_n_mismatch,  # :792-795; calling keeps the host rule
    "_pairhmm_call_v7": pairhmm_pairs_hap_n_mismatch,  # :895-898
}


# ---------------------------------------------------------------------------
# Devices and device-to-host copies
# ---------------------------------------------------------------------------

def _on(device: torch.device):
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


class _HostCopy:
    """A device result on its way to the host: a non_blocking copy into a pinned
    buffer on the current stream, plus an event to wait on (CPU results are kept
    as they are)."""

    def __init__(self, out: torch.Tensor):
        self._event = None
        if out.device.type == "cuda":
            self._host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            self._host.copy_(out, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(out.device))
        else:
            self._host = out

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


# ---------------------------------------------------------------------------
# Cartesian route (one region, all reads x all haplotypes)
# ---------------------------------------------------------------------------


class _CartParts:
    """Lazy handle over one region's cartesian launch (duck-types an array for
    finish_likelihood_matrix): its (nh, nr) result on its way to the host.
    gatk_tpu tiles the product over fixed compile shapes; one launch over the
    real reads and haplotypes needs no tiles."""

    def __init__(self, res: _HostCopy, nh, nr):
        self.res = res
        self.nh = nh
        self.nr = nr

    def __array__(self, dtype=None, copy=None):
        out = self.res.numpy().reshape(self.nh, self.nr)
        return out.astype(dtype) if dtype is not None else out


def pack_likelihood_matrix(reads, haps):
    """The host half of start_likelihood_matrix: all reads and haplotypes
    packed (packed reads, e, hlen) as make_pools takes them. numpy only, so a
    host thread runs it without the device calls' trips through the GIL."""
    max_r = max(len(r["bases"]) for r in reads)
    max_h = max(len(h) for h in haps)
    rp = _bucket(max_r + 2, RP_BUCKETS)
    hmax = max(512, _bucket(max_h, HMAX_BUCKETS))
    packed, rp = pack_reads(reads, rp=rp, nr=len(reads))
    e, hlen, hmax = pack_haps(haps, rp, hmax=hmax, nh=len(haps))
    return packed, e, hlen


def launch_likelihood_matrix(packing, device=None):
    """The device half of start_likelihood_matrix: a pack_likelihood_matrix
    to the device and one launch of the cartesian kernel, without blocking;
    returns the handle for finish_likelihood_matrix."""
    packed, e, hlen = packing
    dev = resolve_device(device)
    with _on(dev):
        pools = make_pools(packed, packed["rlen"], e, hlen, dev)
        return _CartParts(_HostCopy(pairhmm_matrix(pools)), hlen.size, packed["rlen"].size)


def start_likelihood_matrix(reads, haps, device=None):
    """Pack and launch all reads x all haplotypes without blocking; returns an
    opaque handle for finish_likelihood_matrix. One launch of the cartesian
    kernel: the reads and haplotypes go to the device once, and each read's
    tables are built once for all the haplotypes."""
    return launch_likelihood_matrix(pack_likelihood_matrix(reads, haps), device)


def _apply_floor(mat, reads, haps, floor):
    """(n_reads, n_haps) float64: entries that are not above MIN_ACCEPTED_LOG10
    (NaN included) are clamped to it (floor='clamp') or recomputed on the host
    in f64 (floor='host')."""
    bad = ~(mat > MIN_ACCEPTED_LOG10)
    if bad.any():
        if floor == "host":
            from . import pairhmm_host

            for r_i, h_i in zip(*np.nonzero(bad)):
                r = reads[r_i]
                mat[r_i, h_i] = pairhmm_host.compute_log10_likelihood(
                    haps[h_i], r["bases"], r["rq"], r["iq"], r["dq"], r["gcp"])
        else:
            mat[bad] = MIN_ACCEPTED_LOG10
    return mat


@trace.stage("device_wait")
def finish_likelihood_matrix(handle, reads, haps, floor="clamp"):
    """Block on a start_likelihood_matrix / PoolBatcher handle and post-process:
    (n_reads, n_haps) float64 log10 likelihoods."""
    mat = np.asarray(handle, np.float64)[: len(haps), : len(reads)].T
    return _apply_floor(mat, reads, haps, floor)


def compute_likelihood_matrix(reads, haps, floor="clamp", device=None):
    """(n_reads, n_haps) float64 log10 likelihood matrix via the cartesian route.

    floor='clamp': values at/below the f32 floor become MIN_ACCEPTED_LOG10 — safe
    for HC because downstream normalization caps at best-4.5 and reads whose best
    is below -8 are filtered. floor='host': recompute such entries exactly on the
    host (GKL double-fallback semantics)."""
    return finish_likelihood_matrix(start_likelihood_matrix(reads, haps, device=device),
                                    reads, haps, floor=floor)


def compute_log10_likelihoods(reads, haps, pair_read_idx, pair_hap_idx, device=None):
    """(n_pairs,) float64 log10 likelihoods of the given pairs.

    Pairs whose f32 result is not above MIN_ACCEPTED_LOG10 (or is NaN) are
    recomputed on the host in f64, mirroring the reference native kernel's
    double-precision fallback."""
    dev = resolve_device(device)
    packed, rp = pack_reads(reads, nr=len(reads))
    e, hlen, _ = pack_haps(haps, rp, nh=len(haps))
    with _on(dev):
        pools = make_pools(packed, packed["rlen"], e, hlen, dev)
        ri = torch.as_tensor(np.asarray(pair_read_idx, np.int32), device=dev)
        hi = torch.as_tensor(np.asarray(pair_hap_idx, np.int32), device=dev)
        res = pairhmm_pairs(pools, ri, hi).cpu().numpy().astype(np.float64)
    bad = ~(res > MIN_ACCEPTED_LOG10)
    if bad.any():
        from . import pairhmm_host

        for k in np.nonzero(bad)[0]:
            r = reads[pair_read_idx[k]]
            h = haps[pair_hap_idx[k]]
            res[k] = pairhmm_host.compute_log10_likelihood(
                h, r["bases"], r["rq"], r["iq"], r["dq"], r["gcp"])
    return res


# ---------------------------------------------------------------------------
# Pooled cross-region dispatch
#
# Regions' reads and haplotypes are packed once into uint8 pools; each region's
# read x hap product becomes (read_idx, hap_idx) pair lists, and a flush sends
# the pools to the device and scores all queued pairs in ONE launch over the
# real pairs (the kernel gathers each pair from the pools in its loads).
# ---------------------------------------------------------------------------

POOL_NR = 16384  # read-instance pool capacity (last column reserved)
POOL_NH = 1024  # haplotype pool capacity (last column reserved)
POOL_N = 32768  # with POOL_K: pairs queued before an automatic flush
POOL_K = 16


class _PoolSlice:
    """Lazy handle for one region's (nh, nr) likelihood matrix inside a
    PoolBatcher (duck-types an array for finish_likelihood_matrix)."""

    def __init__(self, batcher, nh, nr):
        self.batcher = batcher
        self.segments = []  # (flush_record, pair_offset, n_read_cols) in fill order
        self.nh = nh
        self.nr = nr

    def __array__(self, dtype=None, copy=None):
        # pairs are hap-major within each read-column chunk, so each segment is
        # an (nh, take) column block of the final (nh, nr) matrix
        out = np.empty((self.nh, self.nr), np.float32)
        col = 0
        for rec, off, take in self.segments:
            self.batcher._materialize(rec)
            out[:, col : col + take] = rec["values"][off : off + self.nh * take].reshape(
                self.nh, take)
            col += take
        if col < self.nr:  # fetched before flush: push pending work out, retry
            self.batcher.flush()
            return self.__array__(dtype=dtype, copy=copy)
        return out.astype(dtype) if dtype is not None else out


class PoolBatcher:
    """Cross-region PairHMM dispatcher.

    Usage: handle = batcher.add_region(prepped_reads, hap_bases); ...;
    batcher.flush(); np.asarray(handle) -> (nh, nr) log10 matrix. add_region is
    thread-safe (host assembly workers feed one shared batcher). Regions whose
    reads or haplotypes exceed the pool's rp/hmax, or that have more haplotypes
    than the pool holds, take the cartesian route instead. On a CPU device the
    same pooling runs with the plain PyTorch version."""

    def __init__(self, device=None, rp=160, hmax=512, nr_cap=POOL_NR, nh_cap=POOL_NH,
                 pool_n=POOL_N, pool_k=POOL_K):
        self.device = resolve_device(device)
        self.rp = rp
        self.hmax = hmax
        self.nr_cap = nr_cap
        self.nh_cap = nh_cap
        self.pool_n = pool_n
        self.pool_k = pool_k
        self._lock = threading.Lock()
        self._reset_pool()

    def _reset_pool(self):
        rp, he = self.rp, self.hmax + 2 * self.rp + E_OFF
        nr, nh = self.nr_cap, self.nh_cap
        self._reads = {k: np.zeros((rp, nr), np.uint8) for k in ("rbase", "rq", "iq", "dq", "gcp")}
        self._rlen = np.ones(nr, np.int32)
        self._e = np.zeros((nh, he), np.uint8)  # haplotype-major: the pools' e transposed
        self._hlen = np.ones(nh, np.int32)
        self._n_reads = 0
        self._n_haps = 0
        self._pairs_ri = []  # list of (nr_i,) int32 per hap row, in stream order
        self._pairs_hi = []
        self._n_pairs = 0
        self._pending = []  # (slice, pair offset, n read cols) awaiting flush

    def _add_reads(self, reads):
        """Pack reads into pool columns [n_reads, n_reads+len); returns base idx."""
        base = self._n_reads
        for k, r in enumerate(reads):
            b = _as_u8(r["bases"])
            L = len(b)
            col = base + k
            self._rlen[col] = L
            self._reads["rbase"][1 : L + 1, col] = b
            for key in ("rq", "iq", "dq", "gcp"):
                self._reads[key][1 : L + 1, col] = _as_u8(r[key])
        self._n_reads = base + len(reads)
        return base

    def _add_haps(self, haps):
        base = self._n_haps
        p, hmax = self.rp - 1, self.hmax
        for k, h in enumerate(haps):
            b = _as_u8(h)
            col = base + k
            self._hlen[col] = len(b)
            self._e[col, E_OFF + p + hmax - len(b) : E_OFF + p + hmax] = b[::-1]
        self._n_haps = base + len(haps)
        return base

    @trace.stage("pack_dispatch")
    def add_region(self, reads, haps) -> object:
        """Queue one region's read x hap cartesian product; returns a lazy
        handle whose np.asarray() is the (nh, nr) log10 matrix."""
        max_r = max(len(r["bases"]) for r in reads)
        max_h = max(len(h) for h in haps)
        if max_r > self.rp - 2 or max_h > self.hmax or len(haps) > self.nh_cap - 1:
            # oversize region (long reads / long haplotypes): its own launch
            return start_likelihood_matrix(reads, haps, device=self.device)
        with self._lock:
            handle = _PoolSlice(self, len(haps), len(reads))
            # reads may exceed pool capacity: split into column chunks
            r0 = 0
            while r0 < len(reads):
                if self._n_haps + len(haps) > self.nh_cap - 1 or self._n_reads >= self.nr_cap - 1:
                    self._flush_locked()
                take = min(len(reads) - r0, self.nr_cap - 1 - self._n_reads)
                chunk = reads[r0 : r0 + take]
                rbase = self._add_reads(chunk)
                hbase = self._add_haps(haps)
                ri_row = np.arange(rbase, rbase + take, dtype=np.int32)
                for j in range(len(haps)):
                    self._pairs_ri.append(ri_row)
                    self._pairs_hi.append(np.full(take, hbase + j, np.int32))
                self._pending.append((handle, self._n_pairs, take))
                self._n_pairs += take * len(haps)
                r0 += take
            # auto-flush once enough pairs are queued: the device starts while
            # later regions are still assembling
            if self._n_pairs >= self.pool_k * self.pool_n:
                self._flush_locked()
            return handle

    @trace.stage("flush")
    def flush(self):
        with self._lock:
            self._flush_locked()

    def _flush_locked(self):
        if not self._pending:
            if self._n_reads:
                self._reset_pool()
            return
        nr, nh = self._n_reads, self._n_haps
        ri = np.concatenate(self._pairs_ri)
        hi = np.concatenate(self._pairs_hi)
        dev = self.device
        with _on(dev):
            pools = make_pools({k: v[:, :nr] for k, v in self._reads.items()},
                               self._rlen[:nr], self._e[:nh].T, self._hlen[:nh], dev)
            out = pairhmm_pairs(pools, torch.from_numpy(ri).to(dev), torch.from_numpy(hi).to(dev))
            rec = dict(values=None, out=_HostCopy(out), n=len(ri))
        for handle, off, take in self._pending:
            handle.segments.append((rec, off, take))
        self._reset_pool()

    def _materialize(self, rec):
        with self._lock:
            if rec["values"] is None:
                rec["values"] = rec["out"].numpy()[: rec["n"]]
                rec["out"] = None
