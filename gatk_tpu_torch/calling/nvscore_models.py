"""NVScoreVariants reference-compatible CNN architectures: the PyTorch port of
gatk_tpu/calling/nvscore_models.py.

Reference behavior: src/main/python/.../scorevariants/models/gatk_1d.py
(GATK_CNN_1D) and gatk_2d.py (GATK_CNN_2D) — the exact architectures whose
pretrained weights GATK ships in resources/large/nvscorevariants/
(1d_cnn_mix_train_full_bn.pt, small_2d.pt). `load_torch_1d/2d` turn a
PyTorch state_dict into gatk_tpu's parameter dict of numpy arrays (the same
function as gatk_tpu's), so the shipped .pt files load directly;
`params_to_torch` and `params_to_numpy` carry either dict to tensors and back.
Inference is eval-mode (dropout = identity, batch-norm uses running
statistics), in float32 with cuDNN's TF32 off.

`forward_1d` and `forward_2d` run on the port's default device (or `device`):
numpy arrays in give a numpy array out, as gatk_tpu's callers use it; tensors
in (with params_to_torch's parameters on their device) give a tensor out.

Inputs (scorevariants/encoders.py): reference window = 128 bases one-hot
(BASE_MAP A,C,G,T), annotation vector BEST_PRACTICES =
[MQ, DP, SOR, FS, QD, MQRankSum, ReadPosRankSum]; 2D read tensor =
(reads=128, window=128, 15 channels). Output logits order:
[SNP, NOT_SNP, INDEL, NOT_INDEL] (scorevariants label order).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .cnn_score import (full_float32, params_to_numpy, params_to_torch,  # noqa: F401 (both dicts)
                        run_batched)

BEST_PRACTICES = ["MQ", "DP", "SOR", "FS", "QD", "MQRankSum", "ReadPosRankSum"]
WINDOW = 128
BN_EPS = 0.001
BATCH = 1024  # variants a forward pass takes at once (numpy in)


def _np(t):
    return np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach") else t,
                      np.float32)


def _extract_state_dict(obj):
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    for key in ("state_dict", "model_state_dict"):
        if isinstance(obj, dict) and key in obj and isinstance(obj[key], dict):
            obj = obj[key]
    # strip common prefixes (Lightning wrappers save as model.xxx)
    out = {}
    for k, v in obj.items():
        out[k[6:] if k.startswith("model.") else k] = v
    return out


def load_torch_1d(path_or_state) -> dict:
    """GATK_CNN_1D state_dict -> parameter dict (layer names per gatk_1d.py)."""
    if isinstance(path_or_state, (str, bytes)):
        sd = torch.load(path_or_state, map_location="cpu", weights_only=False)
    else:
        sd = path_or_state
    sd = _extract_state_dict(sd)
    return {
        "conv0_w": _np(sd["conv.0.weight"]), "conv0_b": _np(sd["conv.0.bias"]),
        "conv2_w": _np(sd["conv.2.weight"]), "conv2_b": _np(sd["conv.2.bias"]),
        "conv5_w": _np(sd["conv.5.weight"]), "conv5_b": _np(sd["conv.5.bias"]),
        "bn_w": _np(sd["normalize.weight"]), "bn_b": _np(sd["normalize.bias"]),
        "bn_mean": _np(sd["normalize.running_mean"]),
        "bn_var": _np(sd["normalize.running_var"]),
        "d1_w": _np(sd["dense_1.0.weight"]), "d1_b": _np(sd["dense_1.0.bias"]),
        "d2_w": _np(sd["dense_2.0.weight"]), "d2_b": _np(sd["dense_2.0.bias"]),
        "d3_w": _np(sd["dense_3.weight"]), "d3_b": _np(sd["dense_3.bias"]),
    }


def _batch_norm(p, annotations):
    norm = (annotations - p["bn_mean"]) / torch.sqrt(p["bn_var"] + BN_EPS)
    return norm * p["bn_w"] + p["bn_b"]


def _forward_1d(p, reference, annotations):
    x = reference.transpose(1, 2)  # (B, 4, L)
    with full_float32():
        x = torch.relu(F.conv1d(x, p["conv0_w"], p["conv0_b"]))
        x = torch.relu(F.conv1d(x, p["conv2_w"], p["conv2_b"]))
        x = torch.relu(F.conv1d(x, p["conv5_w"], p["conv5_b"]))
    conv_flat = x.transpose(1, 2).reshape(x.shape[0], -1)  # (B, L' * 128)
    norm = _batch_norm(p, annotations)
    d1 = torch.relu(norm @ p["d1_w"].T + p["d1_b"])
    d2 = torch.relu(torch.cat([conv_flat, d1], dim=-1) @ p["d2_w"].T + p["d2_b"])
    return torch.cat([d2, norm], dim=-1) @ p["d3_w"].T + p["d3_b"]


def _run(fn, params, inputs, annotations, device):
    """fn on tensors as they are, or on numpy arrays BATCH rows at a time on
    `device` (the port's default unless given), back as numpy."""
    if isinstance(inputs, torch.Tensor):
        return fn(params, inputs, annotations)
    return run_batched(fn, params_to_torch(params, device), inputs, annotations, BATCH)


def forward_1d(params, reference, annotations, device=None):
    """Eval-mode forward of GATK_CNN_1D: logits (B, 4).

    reference: (B, 128, 4) one-hot float; annotations: (B, 7)."""
    return _run(_forward_1d, params, reference, annotations, device)


def load_torch_2d(path_or_state) -> dict:
    """GATK_CNN_2D state_dict -> parameter dict (layer names per gatk_2d.py)."""
    if isinstance(path_or_state, (str, bytes)):
        sd = torch.load(path_or_state, map_location="cpu", weights_only=False)
    else:
        sd = path_or_state
    sd = _extract_state_dict(sd)
    return {
        "conv0_w": _np(sd["conv.0.weight"]), "conv0_b": _np(sd["conv.0.bias"]),
        "conv3_w": _np(sd["conv.3.weight"]), "conv3_b": _np(sd["conv.3.bias"]),
        "conv6_w": _np(sd["conv.6.weight"]), "conv6_b": _np(sd["conv.6.bias"]),
        "conv10_w": _np(sd["conv.10.weight"]), "conv10_b": _np(sd["conv.10.bias"]),
        "bn_w": _np(sd["dense_1.0.weight"]), "bn_b": _np(sd["dense_1.0.bias"]),
        "bn_mean": _np(sd["dense_1.0.running_mean"]),
        "bn_var": _np(sd["dense_1.0.running_var"]),
        "d1_w": _np(sd["dense_1.1.weight"]), "d1_b": _np(sd["dense_1.1.bias"]),
        "d2_w": _np(sd["dense_2.0.weight"]), "d2_b": _np(sd["dense_2.0.bias"]),
        "d3_w": _np(sd["dense_2.3.weight"]), "d3_b": _np(sd["dense_2.3.bias"]),
    }


def _forward_2d(p, read_tensor, annotations):
    x = read_tensor.permute(0, 3, 1, 2)  # NCHW

    def pool31(x):
        return F.max_pool2d(x, (3, 1), (3, 1))

    with full_float32():
        x = torch.relu(F.conv2d(x, p["conv0_w"], p["conv0_b"]))
        x = torch.relu(F.conv2d(x, p["conv3_w"], p["conv3_b"]))
        x = torch.relu(F.conv2d(x, p["conv6_w"], p["conv6_b"]))
        x = pool31(x)
        x = torch.relu(F.conv2d(x, p["conv10_w"], p["conv10_b"]))
        x = pool31(x)
    conv_flat = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    norm = _batch_norm(p, annotations)
    d1 = torch.relu(norm @ p["d1_w"].T + p["d1_b"])
    d2 = torch.relu(torch.cat([conv_flat, d1], dim=-1) @ p["d2_w"].T + p["d2_b"])
    return d2 @ p["d3_w"].T + p["d3_b"]


def forward_2d(params, read_tensor, annotations, device=None):
    """Eval-mode forward of GATK_CNN_2D: logits (B, 4).

    read_tensor: (B, reads=128, window=128, 15); annotations: (B, 7)."""
    return _run(_forward_2d, params, read_tensor, annotations, device)


def encode_reference_window(ref_bases: str) -> np.ndarray:
    """(128, 4) one-hot per encoders.py BASE_MAP (non-ACGT rows all-zero)."""
    out = np.zeros((WINDOW, 4), np.float32)
    for i, b in enumerate(ref_bases[:WINDOW]):
        j = {"A": 0, "C": 1, "G": 2, "T": 3}.get(b.upper())
        if j is not None:
            out[i, j] = 1.0
    return out


def encode_best_practices(info: dict) -> np.ndarray:
    out = np.zeros(len(BEST_PRACTICES), np.float32)
    for i, key in enumerate(BEST_PRACTICES):
        try:
            out[i] = float(str(info.get(key, 0.0)))
        except (TypeError, ValueError):
            out[i] = 0.0
    return out
