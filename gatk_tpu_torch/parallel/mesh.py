"""Device-list data parallelism for variant calling: the port of
gatk_tpu/parallel/mesh.py.

gatk_tpu shards the PairHMM pair batch along its pair axis over a 1-D jax mesh
(shard_map) and reduces the BQSR covariate histogram with psum. Here a mesh is
an ordered list of torch devices:
  * `pairhmm_sharded` cuts the pair axis into one contiguous slice a device,
    uploads each slice's pools to its device and runs the pair kernel there
    (csrc/pairhmm_fwd.cu on a CUDA device, the plain PyTorch version on a CPU
    device); every slice is uploaded, then every slice launched, before any is
    waited on, and the results are gathered on the first device;
  * `bqsr_histogram_step` scatter-adds each device's slice of the keys
    (index_add_), sums the partial histograms on the first device and, when a
    torch.distributed group is up, all_reduces the sum across processes: the
    psum over a mesh that spans hosts.

Which transport reduces across processes: the group's. An NCCL group reduces
the histogram where it lies, on the card; a gloo group (multihost.initialize's)
reduces a CPU copy, which is then copied back. NCCL refuses two ranks on one
GPU, so a caller creates an NCCL group only where each rank owns its own card;
multihost.initialize creates a gloo group because its processes may share one
card and its collectives carry host bytes (the VCF shards) anyway.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..devices import resolve_device
from ..ops import pairhmm
from .scheduler import cuda_devices


def make_mesh(n_devices: int | None = None) -> list[torch.device]:
    """The first n_devices local CUDA devices (all by default); raises when
    there is no card. CPU callers pass a list of torch.device("cpu") instead."""
    devices = cuda_devices()
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(f"{n_devices} devices asked for, {len(devices)} present")
        devices = devices[:n_devices]
    return devices


def pad_pairs_to_devices(packed: dict, n_pairs: int, n_devices: int):
    """Pad the pair axis (last dim) so it divides n_devices * LANES; padded
    pairs carry rlen = hlen = 1. `packed` is ops/pairhmm.pack_batch's dict."""
    lane_mult = n_devices * pairhmm.LANES
    n = packed["rbase"].shape[1]
    target = ((n + lane_mult - 1) // lane_mult) * lane_mult
    if target == n:
        return packed
    out = {}
    for k, v in packed.items():
        pad = np.zeros((v.shape[0], target - n), v.dtype)
        if k in ("rlen", "hlen"):
            pad += 1
        out[k] = np.concatenate([v, pad], axis=1)
    return out


# gatk_tpu's mesh runs its production kernel v6, which scores an N in the
# haplotype as a mismatch; this is the port's entry with that rule
PAIR_ENTRY = pairhmm.PAIR_VARIANTS["_pairhmm_call_v6"]


def pairhmm_sharded(devices, packed: dict, rp: int, hmax: int) -> torch.Tensor:
    """The pair kernel data-parallel over `devices`: (1, N) float32 log10
    likelihoods on devices[0], pair k from column k of `packed` (pack_batch's
    pair-expanded layout, N a multiple of len(devices))."""
    devices = [torch.device(d) for d in devices]
    n = packed["rbase"].shape[1]
    if n % len(devices):
        raise ValueError(f"{n} pairs do not split evenly over {len(devices)} devices "
                         "(pad_pairs_to_devices pads them)")
    if packed["rbase"].shape[0] != rp or packed["e"].shape[0] != hmax + 2 * rp + pairhmm.E_OFF:
        raise ValueError(f"packed arrays are not of rp={rp}, hmax={hmax}")
    per = n // len(devices)
    # every slice's upload first, then every launch: no upload waits on a launch
    slices = [pairhmm.from_jax_packed({k: v[:, i * per:(i + 1) * per] for k, v in packed.items()},
                                      device=resolve_device(dev))
              for i, dev in enumerate(devices)]
    outs = [PAIR_ENTRY(*s) for s in slices]
    return torch.cat([o.to(devices[0]) for o in outs]).reshape(1, n)


def bqsr_histogram_step(devices, keys, errors, n_bins: int):
    """The BQSR pass-1 reduction (RecalibrationTables as scatter-add +
    all-reduce): (obs, errs), float32 (n_bins,) on devices[0], counting each
    key once into obs and adding its error into errs, summed over the devices
    and, when a torch.distributed group is up, over its processes."""
    devices = [resolve_device(d) for d in devices]
    keys = torch.as_tensor(np.asarray(keys)).long()
    errors = torch.as_tensor(np.asarray(errors, np.float32))
    parts = []
    for dev, k, e in zip(devices, torch.tensor_split(keys, len(devices)),
                         torch.tensor_split(errors, len(devices))):
        k, e = k.to(dev), e.to(dev)
        obs = torch.zeros(n_bins, dtype=torch.float32, device=dev)
        errs = torch.zeros(n_bins, dtype=torch.float32, device=dev)
        parts.append((obs.index_add_(0, k, torch.ones_like(e)), errs.index_add_(0, k, e)))
    obs = sum(o.to(devices[0]) for o, _ in parts)
    errs = sum(e.to(devices[0]) for _, e in parts)
    if dist.is_available() and dist.is_initialized():
        both = torch.stack([obs, errs])
        red = both if dist.get_backend() == "nccl" else both.cpu()
        dist.all_reduce(red)
        obs, errs = red.to(devices[0]).unbind()
    return obs, errs
