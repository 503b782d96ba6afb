"""Build, load and launch the port's hand-written CUDA kernels.

Every source under gatk_tpu_torch/csrc/*.cu is compiled by nvcc for sm_90a into
its own shared library with a plain C interface, at first use, into
build/gatk_tpu_torch/<hash>/ at the repository root; the hash covers the
sources and the flags, so an edited kernel is rebuilt and an unchanged one is
reused. All sources build in parallel, one nvcc each. The libraries are loaded
with ctypes: pointers and the stream go in as c_void_p, and each launcher
returns cudaGetLastError(), which the wrapper turns into an exception.
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
E_OFF = 16  # must match csrc/pairhmm_fwd.cu and ops/pairhmm.E_OFF

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
        return _libs[name]


def _bind_pairhmm(lib):
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.pairhmm_fwd.restype = i
    lib.pairhmm_fwd.argtypes = [vp] * 11 + [i] * 5 + [vp]


def _check(cond, msg):
    if not cond:
        raise ValueError(f"pairhmm_fwd: {msg}")


def pairhmm_fwd(pools, ri: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Launch the PairHMM forward kernel on PyTorch's current stream: (n,) f32
    log10 likelihoods of pairs (read column ri[p], haplotype column hi[p]).

    pools: ops.pairhmm.Pools on one CUDA device. Pairs whose indices or lengths
    are out of range (ri/hi outside the pools, rlen > rp - 1, hlen > hmax) come
    back as NaN; the kernel reads nothing out of bounds for them."""
    dev = pools.rbase.device
    _check(dev.type == "cuda", f"pools are on {dev}, not a CUDA device")
    reads = (pools.rbase, pools.rq, pools.iq, pools.dq, pools.gcp)
    rp, nr = pools.rbase.shape
    he, nh = pools.e.shape
    for t in reads + (pools.e,):
        _check(t.dtype == torch.uint8 and t.dim() == 2, "read tables and e must be 2-D uint8")
    for t in reads:
        _check(t.shape == (rp, nr), f"read tables differ in shape: {tuple(t.shape)} vs {(rp, nr)}")
    _check(pools.rlen.shape == (nr,) and pools.hlen.shape == (nh,),
           "rlen must be (NR,) and hlen (NH,)")
    _check(ri.dim() == 1 and ri.shape == hi.shape, "ri and hi must be 1-D of one length")
    for t in (pools.rlen, pools.hlen, ri, hi):
        _check(t.dtype == torch.int32, "rlen, hlen, ri and hi must be int32")
    tensors = reads + (pools.rlen, pools.e, pools.hlen, ri, hi)
    for t in tensors:
        _check(t.device == dev, f"all operands must be on {dev}")
        _check(t.is_contiguous(), "all operands must be contiguous")
    _check(he - 2 * rp - E_OFF >= 1 and rp >= 2, f"no room for a haplotype: He={he}, rp={rp}")
    n = ri.numel()
    _check(n < 2 ** 31 and rp * nr < 2 ** 31 and he * nh < 2 ** 31, "operands too large")
    lib = library("pairhmm_fwd")
    out = torch.empty(n, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.pairhmm_fwd(*(t.data_ptr() for t in tensors), out.data_ptr(),
                             n, rp, nr, he, nh, stream)
    if rc != 0:
        raise RuntimeError(f"pairhmm_fwd launch failed (rp={rp}, He={he}, n={n}): "
                           f"{lib.kernel_error_string(rc).decode()}")
    return out
