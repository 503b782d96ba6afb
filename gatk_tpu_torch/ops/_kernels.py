"""Build, load and launch the port's hand-written CUDA kernels.

Every source under gatk_tpu_torch/csrc/*.cu is compiled by nvcc for sm_90a into
its own shared library with a plain C interface, at first use, into
build/gatk_tpu_torch/<hash>/ at the repository root; the hash covers the
sources and the flags, so an edited kernel is rebuilt and an unchanged one is
reused. All sources build in parallel, one nvcc each. The libraries are loaded
with ctypes: pointers and the stream go in as c_void_p, and each launcher
returns cudaGetLastError(), which the wrapper turns into an exception.

Both PairHMM kernels sweep a read with a group of 4, 8, 16 or 32 lanes of a
warp, chosen by its length (csrc/pairhmm_sweep.cuh). Before the sweep each
launcher orders the pairs (or the reads) so that like ones share a warp, by a
counting sort on the card in three small kernels whose plain version is
`plan_groups`; the wrappers allocate its scratch, and the sweep writes each
result in the caller's order. The kernels read each haplotype as one row of
bytes: the pools' e (He, NH) is stored haplotype-major (ops/pairhmm.make_pools),
and the wrappers pass it as it is.

The copy-number HMM kernels (csrc/cnv_hmm.cu, wrapper `cnv_hmm_launch`, which
also returns how many kernels the pass launched, and `cnv_hmm`) run the
forward-backward pass of the gCNV denoising model in chunks of CNV_HMM_CHUNK
steps, parallel over the intervals, for any number of states C (a group of
8 or 32 lanes a vector, a lane a state, up to 32; a warp a vector and
ceil(C / 32) states a lane above); ops/cnv_hmm.py holds the sequential plain
version and the plain version of the chunked association. The chunked pass
rounds otherwise than the sequential one: it is held to 1e-3 of the float64
sequential pass and to 1e-4 plus two float32 rounding steps of the value of
the chunked plain version.

The flow-space PairHMM kernel (csrc/flow_pairhmm.cu, wrapper `flow_pairhmm`)
runs a warp a (read, haplotype) pair over the coset cells of the read's flow
rows, its prior gathered from the packed tables inside the kernel, its carried
rows in registers (in the warp's shared memory for the widest haplotypes);
the dense kernel (csrc/flow_pairhmm_dense.cu, wrapper `flow_pairhmm_dense`)
runs gatk_tpu's dense scan as the sum of each pair's live coset lattices, a
warp a lattice after a plan on the card, for the pairs whose flow order breaks
the coset rule and for haplotypes wider than the coset kernel's shared memory
holds; ops/flow_pairhmm.py holds the plain versions of both.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build", "gatk_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
E_OFF = 16  # must match csrc/pairhmm_sweep.cuh (kEOff) and ops/pairhmm.E_OFF
ROWS_PER_LANE = 5  # csrc/pairhmm_sweep.cuh: kRows
GROUP_WIDTHS = (4, 8, 16, 32)  # lanes of a group, by class (4 << c)
MAX_KEY_LEN = 4095  # csrc/pairhmm_sweep.cuh: kMaxKeyLen

_lock = threading.Lock()
_libs: dict = {}
# filled by the first build: {"seconds": wall time, "dir": build dir,
# "built": True if compiled now, False if reused, "log": {name: nvcc output}}
BUILD_INFO: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on first use and "
                           "need the CUDA toolkit (set CUDA_HOME or put nvcc on PATH)")
    return path


def _build_all() -> dict:
    sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(glob.glob(os.path.join(CSRC, "*"))):
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + f.read())
    out_dir = os.path.join(BUILD_ROOT, h.hexdigest()[:16])
    os.makedirs(out_dir, exist_ok=True)
    targets = {os.path.splitext(os.path.basename(s))[0]: s for s in sources}
    t0 = time.perf_counter()
    procs = {}
    for name, src in targets.items():
        so = os.path.join(out_dir, f"lib{name}.so")
        if os.path.exists(so):
            continue
        tmp = f"{so}.tmp{os.getpid()}"
        procs[name] = (subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, so)
    log = {}
    for name, (proc, tmp, so) in procs.items():
        out, _ = proc.communicate()
        log[name] = out
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{out}")
        os.replace(tmp, so)
    BUILD_INFO.update(seconds=time.perf_counter() - t0, dir=out_dir, built=bool(procs), log=log)
    return {name: os.path.join(out_dir, f"lib{name}.so") for name in targets}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, building every kernel on first use."""
    with _lock:
        if not _libs:
            for lib_name, path in _build_all().items():
                lib = ctypes.CDLL(path)
                lib.kernel_error_string.restype = ctypes.c_char_p
                lib.kernel_error_string.argtypes = [ctypes.c_int]
                _libs[lib_name] = lib
            _bind_pairhmm(_libs["pairhmm_fwd"])
            _bind_pairhmm_matrix(_libs["pairhmm_matrix"])
            _bind_cnv_hmm(_libs["cnv_hmm"])
            _bind_flow_pairhmm(_libs["flow_pairhmm"])
            _bind_flow_pairhmm_dense(_libs["flow_pairhmm_dense"])
        return _libs[name]


def _bind_pairhmm(lib):
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.pairhmm_fwd.restype = i
    lib.pairhmm_fwd.argtypes = [vp] * 12 + [i] * 6 + [vp]
    lib.pairhmm_plan.restype = i
    lib.pairhmm_plan.argtypes = [vp] * 5 + [i] * 4 + [vp]


def _bind_pairhmm_matrix(lib):
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.pairhmm_matrix.restype = i
    lib.pairhmm_matrix.argtypes = [vp] * 10 + [i] * 4 + [vp]


def _bind_cnv_hmm(lib):
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.cnv_hmm.restype = i
    lib.cnv_hmm.argtypes = [vp] * 5 + [i] * 4 + [vp, ctypes.POINTER(i)]
    lib.cnv_hmm_scratch.restype = ctypes.c_longlong
    lib.cnv_hmm_scratch.argtypes = [i] * 4


def _bind_flow_pairhmm(lib):
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.flow_pairhmm.restype = i
    lib.flow_pairhmm.argtypes = [vp] * 11 + [i] * 6 + [vp]
    lib.flow_pairhmm_smem.restype = ctypes.c_longlong
    lib.flow_pairhmm_smem.argtypes = [i, i, ctypes.POINTER(i)]


def _bind_flow_pairhmm_dense(lib):
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.flow_pairhmm_dense.restype = i
    lib.flow_pairhmm_dense.argtypes = [vp] * 11 + [i] * 7 + [vp]
    lib.flow_pairhmm_dense_route.restype = i
    lib.flow_pairhmm_dense_route.argtypes = [i, i, ctypes.POINTER(i), ctypes.POINTER(ll)]
    lib.flow_pairhmm_dense_state.restype = ll
    lib.flow_pairhmm_dense_state.argtypes = [i]
    lib.flow_pairhmm_dense_scratch.restype = ll
    lib.flow_pairhmm_dense_scratch.argtypes = [i] * 4


def plan_groups(rows: torch.Tensor, hlen: torch.Tensor | None = None, hmax: int = 0):
    """The kernels' plan over n items (pairs, or the reads of a region), the
    plain version of the counting sort in csrc/pairhmm_sweep.cuh (plan_count,
    plan_scan, plan_scatter) that the launchers run on the card. rows (n,)
    read lengths, hlen (n,) haplotype lengths of pairs (None for reads), hmax
    an upper bound of hlen. Returns (perm, seg): perm (int64) orders the items
    by group class, then hlen, then lanes used (stably; the kernels' order
    differs only among items with equal keys); class c holds
    perm[seg[c] : seg[c + 1]] (seg int32, 5 entries)."""
    rows = rows.long()
    lanes = ((rows + ROWS_PER_LANE - 1) // ROWS_PER_LANE).clamp(1, GROUP_WIDTHS[-1])
    # class c: the narrowest group of 4 << c lanes whose 5 (4 << c) rows hold
    # the read; reads over 160 rows take the 32-lane class
    cls = sum((rows > ROWS_PER_LANE * w).long() for w in GROUP_WIDTHS[:-1])
    kmax = min(max(int(hmax), 1), MAX_KEY_LEN)
    hbits = kmax.bit_length() if hlen is not None else 0
    key = (cls << (hbits + 5)) | (lanes - 1)
    if hlen is not None:
        key |= hlen.long().clamp(0, kmax) << 5
    perm = torch.argsort(key, stable=True)
    seg = torch.zeros(len(GROUP_WIDTHS) + 1, dtype=torch.int32, device=rows.device)
    seg[1:] = torch.bincount(cls, minlength=len(GROUP_WIDTHS)).cumsum(0)
    return perm, seg


def pair_plan(pools, ri: torch.Tensor, hi: torch.Tensor):
    """plan_groups over the pairs (read column ri[p], haplotype column hi[p]) of
    `pools`; pairs whose indices are out of range count as length 0, as in the
    kernels' plan (the sweep writes NaN for them)."""
    nr, nh = pools.rbase.shape[1], pools.e.shape[1]
    ok = (ri >= 0) & (ri < nr) & (hi >= 0) & (hi < nh)
    zero = torch.zeros((), dtype=pools.rlen.dtype, device=ri.device)
    rows = torch.where(ok, pools.rlen[ri.long().clamp(0, nr - 1)], zero)
    hlen = torch.where(ok, pools.hlen[hi.long().clamp(0, nh - 1)], zero)
    return plan_groups(rows, hlen, pools.hmax)


def plan_scratch(n: int, kmax: int) -> int:
    """int32 words of the plan's scratch (csrc/pairhmm_sweep.cuh: plan_scratch)
    for n items whose haplotype lengths are told apart up to kmax."""
    return 2 * n + 8 + len(GROUP_WIDTHS) * (kmax + 1) * 32


def _check(cond, what, msg):
    if not cond:
        raise ValueError(f"{what}: {msg}")


def _check_pools(pools, what):
    """The checks both kernels need of ops.pairhmm.Pools; returns (rp, nr, he, nh)."""
    dev = pools.rbase.device
    _check(dev.type == "cuda", what, f"pools are on {dev}, not a CUDA device")
    reads = (pools.rbase, pools.rq, pools.iq, pools.dq, pools.gcp)
    rp, nr = pools.rbase.shape
    he, nh = pools.e.shape
    for t in reads + (pools.e,):
        _check(t.dtype == torch.uint8 and t.dim() == 2, what, "read tables and e must be 2-D uint8")
    for t in reads:
        _check(t.shape == (rp, nr), what,
               f"read tables differ in shape: {tuple(t.shape)} vs {(rp, nr)}")
    _check(pools.rlen.shape == (nr,) and pools.hlen.shape == (nh,), what,
           "rlen must be (NR,) and hlen (NH,)")
    _check(pools.rlen.dtype == torch.int32 and pools.hlen.dtype == torch.int32, what,
           "rlen and hlen must be int32")
    for t in pools:
        _check(t.device == dev, what, f"all operands must be on {dev}")
    for t in reads + (pools.rlen, pools.hlen):
        _check(t.is_contiguous(), what, "all operands must be contiguous")
    _check(pools.e.t().is_contiguous(), what,
           "e must be haplotype-major (e.t() contiguous), as make_pools stores it")
    _check(he - 2 * rp - E_OFF >= 1 and rp >= 2, what, f"no room for a haplotype: He={he}, rp={rp}")
    _check(rp * nr < 2 ** 31 and he * nh < 2 ** 31, what, "operands too large")
    return rp, nr, he, nh


def _check_pairs(ri, hi, dev, what):
    _check(ri.dim() == 1 and ri.shape == hi.shape, what, "ri and hi must be 1-D of one length")
    for t in (ri, hi):
        _check(t.dtype == torch.int32, what, "ri and hi must be int32")
        _check(t.device == dev, what, f"all operands must be on {dev}")
        _check(t.is_contiguous(), what, "all operands must be contiguous")
    _check(ri.numel() < 2 ** 31, what, "operands too large")


def _raise_if_failed(lib, rc, what, shape):
    if rc != 0:
        raise RuntimeError(f"{what} launch failed ({shape}): "
                           f"{lib.kernel_error_string(rc).decode()}")


def pairhmm_fwd(pools, ri: torch.Tensor, hi: torch.Tensor,
                hap_n_mismatch: bool = False) -> torch.Tensor:
    """Launch the PairHMM forward kernel on PyTorch's current stream: (n,) f32
    log10 likelihoods of pairs (read column ri[p], haplotype column hi[p]).

    pools: ops.pairhmm.Pools on one CUDA device. hap_n_mismatch picks the
    kernel instance that scores a haplotype N as a mismatch (gatk_tpu's v2,
    v4-v7) instead of a match. The launcher builds the plan of the pairs on
    the device first (pair_plan is its plain version), so its time counts in
    the launch's. Pairs whose indices or lengths are out of range
    (ri/hi outside the pools, rlen > rp - 1, hlen > hmax) come back as NaN; the
    kernel reads nothing out of bounds for them."""
    what = "pairhmm_fwd"
    rp, nr, he, nh = _check_pools(pools, what)
    dev = pools.rbase.device
    _check_pairs(ri, hi, dev, what)
    n = ri.numel()
    lib = library("pairhmm_fwd")
    out = torch.empty(n, dtype=torch.float32, device=dev)
    reads = (pools.rbase, pools.rq, pools.iq, pools.dq, pools.gcp)
    scratch = torch.empty(plan_scratch(n, min(pools.hmax, MAX_KEY_LEN)), dtype=torch.int32,
                          device=dev)
    tensors = reads + (pools.rlen, pools.e, pools.hlen, ri, hi, scratch)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.pairhmm_fwd(*(t.data_ptr() for t in tensors), out.data_ptr(),
                             n, rp, nr, he, nh, int(hap_n_mismatch), stream)
    _raise_if_failed(lib, rc, what, f"rp={rp}, He={he}, n={n}")
    return out


def pairhmm_matrix(pools) -> torch.Tensor:
    """Launch the cartesian PairHMM kernel on PyTorch's current stream: the
    (NH, NR) f32 log10 likelihoods of every read column with every haplotype
    column of `pools` (ops.pairhmm.Pools on one CUDA device). Haplotypes of
    length 0 give NEG_INF; reads or haplotypes whose lengths are out of range
    (rlen > rp - 1, hlen > hmax) give NaN."""
    what = "pairhmm_matrix"
    rp, nr, he, nh = _check_pools(pools, what)
    _check(nr * nh < 2 ** 31, what, "operands too large")
    dev = pools.rbase.device
    lib = library("pairhmm_matrix")
    out = torch.empty((nh, nr), dtype=torch.float32, device=dev)
    reads = (pools.rbase, pools.rq, pools.iq, pools.dq, pools.gcp)
    scratch = torch.empty(plan_scratch(nr, 0), dtype=torch.int32, device=dev)
    tensors = reads + (pools.rlen, pools.e, pools.hlen, scratch)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.pairhmm_matrix(*(t.data_ptr() for t in tensors), out.data_ptr(),
                                rp, nr, he, nh, stream)
    _raise_if_failed(lib, rc, what, f"rp={rp}, He={he}, NR={nr}, NH={nh}")
    return out


def plan_on_card(pools, ri: torch.Tensor | None = None, hi: torch.Tensor | None = None):
    """The plan the launchers build (csrc/pairhmm_sweep.cuh), run alone on the
    card: of the pairs (ri, hi) of `pools`, or of its reads when ri is None.
    Returns (perm, seg) int32, as plan_groups orders them up to items with
    equal keys."""
    what = "pairhmm_plan"
    _check_pools(pools, what)
    dev = pools.rbase.device
    if ri is not None:
        _check_pairs(ri, hi, dev, what)
    nr, nh = pools.rbase.shape[1], pools.e.shape[1]
    n = nr if ri is None else ri.numel()
    kmax = 0 if ri is None else min(pools.hmax, MAX_KEY_LEN)
    scratch = torch.zeros(plan_scratch(n, kmax), dtype=torch.int32, device=dev)
    lib = library("pairhmm_fwd")
    ptr = (lambda t: None if t is None else t.data_ptr())
    with torch.cuda.device(dev):
        rc = lib.pairhmm_plan(ptr(ri), ptr(hi), pools.rlen.data_ptr(),
                              None if ri is None else pools.hlen.data_ptr(), scratch.data_ptr(),
                              n, nr, nh, kmax, torch.cuda.current_stream(dev).cuda_stream)
    _raise_if_failed(lib, rc, what, f"n={n}")
    return scratch[:n], scratch[2 * n : 2 * n + len(GROUP_WIDTHS) + 1]


CNV_HMM_CHUNK = 128  # steps a chunk of the HMM pass, picked by a sweep on the card


def cnv_hmm_launch(log_em: torch.Tensor, log_pi: torch.Tensor, stay: torch.Tensor,
                   chunk: int = CNV_HMM_CHUNK) -> tuple[torch.Tensor, int]:
    """Launch the copy-number HMM forward-backward pass (csrc/cnv_hmm.cu: the
    logs of stay, transfer, scan and posterior kernels) on PyTorch's current
    stream: (S, T, C) f32 log posteriors from log emissions and log priors
    (S, T, C) and stay probabilities (T - 1,), all f32, contiguous, on one CUDA
    device (ops/cnv_hmm.py states the model), and the number of kernels the
    pass launched. `chunk` is the steps of a chunk; the entry keeps
    CNV_HMM_CHUNK, and only a sweep on the card passes another."""
    what = "cnv_hmm"
    dev = log_em.device
    _check(dev.type == "cuda", what, f"log_em is on {dev}, not a CUDA device")
    _check(log_em.dim() == 3 and log_pi.shape == log_em.shape, what,
           "log_em and log_pi must be (S, T, C) of one shape")
    S, T, C = log_em.shape
    _check(S > 0 and T > 0 and C > 0, what, f"needs S, T, C > 0: {(S, T, C)}")
    _check(stay.shape == (T - 1,), what, f"stay must be (T - 1,) = ({T - 1},)")
    _check(chunk >= 1, what, f"chunk must be >= 1: {chunk}")
    for t in (log_em, log_pi, stay):
        _check(t.dtype == torch.float32, what, "all operands must be float32")
        _check(t.device == dev, what, f"all operands must be on {dev}")
        _check(t.is_contiguous(), what, "all operands must be contiguous")
    _check(log_em.numel() < 2 ** 31, what, "operands too large")
    lib = library("cnv_hmm")
    out = torch.empty_like(log_em)
    scratch = torch.empty(lib.cnv_hmm_scratch(S, T, C, chunk), dtype=torch.float32, device=dev)
    launched = ctypes.c_int(0)
    with torch.cuda.device(dev):
        rc = lib.cnv_hmm(log_em.data_ptr(), log_pi.data_ptr(), stay.data_ptr(), out.data_ptr(),
                         scratch.data_ptr(), S, T, C, chunk,
                         torch.cuda.current_stream(dev).cuda_stream, ctypes.byref(launched))
    _raise_if_failed(lib, rc, what, f"S={S}, T={T}, C={C}, chunk={chunk}")
    return out, launched.value


def cnv_hmm(log_em: torch.Tensor, log_pi: torch.Tensor, stay: torch.Tensor,
            chunk: int = CNV_HMM_CHUNK) -> torch.Tensor:
    """The log posteriors of cnv_hmm_launch."""
    return cnv_hmm_launch(log_em, log_pi, stay, chunk)[0]


def cnv_hmm_dependent_steps(T: int, chunk: int = CNV_HMM_CHUNK) -> int:
    """Dependent steps of one pass, per direction: a chunk's transfer, the
    scan over the chunks and the chunk's own values, 2 L + P (P chunks)."""
    P = max(1, -(-(T - 1) // chunk))
    return (2 * min(chunk, max(T - 1, 0)) if P > 1 else max(T - 1, 0)) + P


FLOW_MAX_SMEM = 232448  # bytes of shared memory a block may use on Hopper
FLOW_WARPS = 4  # csrc/flow_pairhmm.cu: kWarps, pairs a block at most
FLOW_REG_CELLS = 4  # csrc/flow_pairhmm.cu: kRegCells, cells a lane in registers at most
FLOW_ROW_TAIL = 7  # csrc/flow_pairhmm.cu: kRowTail, floats after a table row


def flow_pairhmm_smem(Hp: int, T1: int) -> int:
    """Bytes of dynamic shared memory a block of the coset kernel needs for
    tables of Hp haplotype flows and T1 table columns: the mirror of
    csrc/flow_pairhmm.cu's flow_pairhmm_smem. Two row buffers a warp, and past
    FLOW_REG_CELLS cells a lane (Hp > 507) the carried state, 11 words of 32
    lanes a cell; FLOW_WARPS warps a block, fewer where that would pass
    FLOW_MAX_SMEM, at least one. The coset kernel launches where this is at
    most FLOW_MAX_SMEM: Hp up to 21,115 flows for T1 <= 9, 20,987 for
    10 <= T1 <= 185."""
    n = ((Hp + 8) // 4 + 31) // 32
    per_warp = 4 * (2 * (T1 + FLOW_ROW_TAIL) + (11 * 32 * n if n > FLOW_REG_CELLS else 0))
    warps = FLOW_MAX_SMEM // per_warp if per_warp > FLOW_MAX_SMEM // FLOW_WARPS else FLOW_WARPS
    return per_warp * max(warps, 1)


FLOW_TABLES = {"tables": (torch.float32, 3), "rfo": (torch.uint8, 2),
               "trans": (torch.float32, 3), "rlen": (torch.int32, 1),
               "hkey": (torch.int32, 2), "hfo": (torch.uint8, 2), "hlen": (torch.int32, 1)}


def _check_flow_operands(tab, ri, hi, what):
    """The checks both flow kernels make of pack_flow_tables' tables and the
    pairs; returns (device, B, NR, Rp, T1, NH, Hp)."""
    dev = tab["tables"].device
    _check(dev.type == "cuda", what, f"tables are on {dev}, not a CUDA device")
    for name, (dtype, dim) in FLOW_TABLES.items():
        t = tab[name]
        _check(t.dtype == dtype and t.dim() == dim, what, f"{name} must be {dim}-D {dtype}")
        _check(t.device == dev, what, f"all operands must be on {dev}")
        _check(t.is_contiguous(), what, "all operands must be contiguous")
    NR, Rp, T1 = tab["tables"].shape
    NH, Hp = tab["hkey"].shape
    _check(tab["rfo"].shape == (NR, Rp) and tab["trans"].shape == (NR, Rp, 6)
           and tab["rlen"].shape == (NR,), what,
           "rfo, trans and rlen must be (NR, Rp), (NR, Rp, 6) and (NR,) of tables (NR, Rp, T1)")
    _check(tab["hfo"].shape == (NH, Hp) and tab["hlen"].shape == (NH,), what,
           "hfo and hlen must be (NH, Hp) and (NH,) of hkey (NH, Hp)")
    _check_pairs(ri, hi, dev, what)
    B = ri.numel()
    _check(B > 0 and NR > 0 and NH > 0 and Rp > 0 and T1 > 0, what,
           f"needs pairs, reads, haplotypes, flows and table columns: B={B}, NR={NR}, "
           f"NH={NH}, Rp={Rp}, T1={T1}")
    return dev, B, NR, Rp, T1, NH, Hp


def flow_pairhmm(tab, ri: torch.Tensor, hi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the flow-space PairHMM kernel (csrc/flow_pairhmm.cu) on PyTorch's
    current stream over the pairs (read ri[b], haplotype hi[b]) of `tab`
    (ops/flow_pairhmm.pack_flow_tables: tables (NR, Rp, T1) f32, rfo (NR, Rp)
    u8, trans (NR, Rp, 6) f32, rlen (NR,) i32, hkey (NH, Hp) i32, hfo
    (NH, Hp) u8, hlen (NH,) i32), all contiguous on one CUDA device; ri, hi
    (B,) int32. Returns (out, bad) without waiting: out (B,) f32 log10
    likelihoods (ops/flow_pairhmm.py states the DP; NaN for indices or lengths
    out of range), bad (2,) int32, 1 + the largest index of a read and of a
    haplotype whose flow bases break the coset rule, 0 where none does
    (ops/flow_pairhmm.coset_rule_breaks). A haplotype of up to 507 flows
    keeps its state in registers; a wider one in shared memory, which holds
    Hp up to 21,115 flows (flow_pairhmm_smem, its mirror); past that this
    wrapper raises, and the entry (ops/flow_pairhmm.flow_pairhmm_pairs) sends
    the call to flow_pairhmm_dense, which takes any width."""
    what = "flow_pairhmm"
    dev, B, NR, Rp, T1, NH, Hp = _check_flow_operands(tab, ri, hi, what)
    _check(T1 < 0xFFFF, what, f"T1 = {T1} table columns: keys must fit 16 bits")
    lib = library("flow_pairhmm")
    warps = ctypes.c_int(0)
    smem = lib.flow_pairhmm_smem(Hp, T1, ctypes.byref(warps))
    _check(smem <= FLOW_MAX_SMEM, what,
           f"Hp = {Hp}, T1 = {T1} need {smem} bytes of shared memory a block, over {FLOW_MAX_SMEM}")
    out = torch.empty(B, dtype=torch.float32, device=dev)
    bad = torch.zeros(2, dtype=torch.int32, device=dev)
    tensors = [tab[name] for name in FLOW_TABLES] + [ri, hi, out, bad]
    with torch.cuda.device(dev):
        rc = lib.flow_pairhmm(*(t.data_ptr() for t in tensors), B, NR, Rp, T1, NH, Hp,
                              torch.cuda.current_stream(dev).cuda_stream)
    _raise_if_failed(lib, rc, what, f"B={B}, Rp={Rp}, T1={T1}, Hp={Hp}")
    return out, bad


FLOW_DENSE_ROUTES = ("registers", "shared", "device")  # csrc/flow_pairhmm_dense.cu: Route
FLOW_DENSE_WARPS_PER_SM = 4  # resident warps a multiprocessor on the dense kernel's device route


def flow_pairhmm_dense_layout(Hp: int, T1: int) -> tuple[str, int, int]:
    """Where the dense kernel keeps a task's state for tables of Hp haplotype
    flows and T1 table columns (csrc/flow_pairhmm_dense.cu), as the library
    decides it: (route of FLOW_DENSE_ROUTES, tasks a block, bytes of dynamic
    shared memory a block)."""
    lib = library("flow_pairhmm_dense")
    warps, smem = ctypes.c_int(0), ctypes.c_longlong(0)
    route = lib.flow_pairhmm_dense_route(Hp, T1, ctypes.byref(warps), ctypes.byref(smem))
    return FLOW_DENSE_ROUTES[route], warps.value, smem.value


def flow_pairhmm_dense_slots(dev, B: int) -> int:
    """The warps of the dense kernel's grid on its device route for B pairs:
    FLOW_DENSE_WARPS_PER_SM a multiprocessor, at most the 4 B tasks the pairs
    can have. A warp's state there (flow_pairhmm_dense_state: 301 KB at
    25,036 haplotype flows) is read and written every row, and the row's
    latency bounds the route: a grid whose state stays in the L2 cache holds
    one warp a multiprocessor, and runs slower than this one (chip_smoke.py
    --dense-turns times both in turns)."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return max(1, min(4 * B, FLOW_DENSE_WARPS_PER_SM * sms))


def flow_pairhmm_dense(tab, ri: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Launch the dense flow-space PairHMM kernels (csrc/flow_pairhmm_dense.cu)
    on PyTorch's current stream over the pairs (read ri[b], haplotype hi[b])
    of `tab`, the tables and pairs flow_pairhmm takes. Returns (B,) f32 log10
    likelihoods without waiting: gatk_tpu's dense scan (ops/flow_pairhmm.py
    states it; NaN for indices or lengths out of range), for any flow order
    and any haplotype width, as the sum of each pair's live lattices, a warp
    a lattice. A lattice's state lives in registers up to Hp = 891
    haplotype flows, in the warp's shared memory while it fits, and past that
    in device scratch this wrapper allocates for the resident warps of the
    grid (flow_pairhmm_dense_slots; flow_pairhmm_dense_layout names the
    route). The scratch also holds the plan and the lattices' results."""
    what = "flow_pairhmm_dense"
    dev, B, NR, Rp, T1, NH, Hp = _check_flow_operands(tab, ri, hi, what)
    _check(B < 2 ** 29, what, "operands too large")
    _check(T1 < 0xFFFF, what, f"T1 = {T1} table columns: keys must fit 16 bits")
    lib = library("flow_pairhmm_dense")
    route, _, smem = flow_pairhmm_dense_layout(Hp, T1)
    _check(smem <= FLOW_MAX_SMEM, what,
           f"T1 = {T1} needs {smem} bytes of shared memory a block, over {FLOW_MAX_SMEM}")
    slots = flow_pairhmm_dense_slots(dev, B) if route == "device" else 0
    scratch = torch.empty(lib.flow_pairhmm_dense_scratch(B, Hp, T1, slots), dtype=torch.int32,
                          device=dev)
    out = torch.empty(B, dtype=torch.float32, device=dev)
    tensors = [tab[name] for name in FLOW_TABLES] + [ri, hi, out, scratch]
    with torch.cuda.device(dev):
        rc = lib.flow_pairhmm_dense(*(t.data_ptr() for t in tensors), B, NR, Rp, T1, NH, Hp,
                                    slots, torch.cuda.current_stream(dev).cuda_stream)
    _raise_if_failed(lib, rc, what, f"B={B}, Rp={Rp}, T1={T1}, Hp={Hp}, route={route}")
    return out
