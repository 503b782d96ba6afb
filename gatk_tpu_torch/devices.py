"""The port's default device: where device work runs when its caller passes no
device (the PairHMM batchers, the gCNV denoising model, the panel of normals'
SVD, ModelSegments' chains). HaplotypeCaller, Mutect2, GermlineCNVCaller,
CreateReadCountPanelOfNormals and ModelSegments set it from --device."""
from __future__ import annotations

import torch

_DEFAULT_DEVICE = torch.device("cuda")


def set_default_device(device) -> None:
    """Device for callers that pass none; raises when that is CUDA and there is no card."""
    global _DEFAULT_DEVICE
    _DEFAULT_DEVICE = resolve_device(device)


def resolve_device(device=None) -> torch.device:
    """`device`, or the default; raises when that is CUDA and there is no card."""
    dev = torch.device(device) if device is not None else _DEFAULT_DEVICE
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (--device cpu on the command "
            "line) to run the plain PyTorch versions on the host")
    return dev


def synchronize(device: torch.device) -> None:
    """Waits for the device's queued work (nothing to wait for on the host)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
