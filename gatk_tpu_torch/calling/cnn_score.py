"""CNN variant scoring (NVScoreVariants / CNNScoreVariants equivalent): the
PyTorch port of gatk_tpu/calling/cnn_score.py.

Reference behavior: tools/walkers/vqsr/NVScoreVariants.java +
src/main/python/org/broadinstitute/hellbender/scorevariants/models/gatk_1d.py
(1D CNN over a one-hot reference window + 7 best-practices annotations with a
4-class head: SNP / NOT_SNP / INDEL / NOT_INDEL; score = log-odds of the true
class vs its artifact class, written as the CNN_1D INFO key).

The network is gatk_tpu's: the same parameter dict (numpy arrays, conv weights
in gatk_tpu's WIO layout, `init_params` from the same seed), the same `.npz`
files (`save_weights`, `load_weights`), so each package reads the other's.
`params_to_torch` and `params_to_numpy` carry a dict across. `forward` runs on
tensors (F.conv1d over (N, 4, W), the weights turned to OIW); `train` is
torch.autograd with an Adam equal to optax.adam(1e-3), on the port's default
device (devices.resolve_device). Float32 throughout: convolutions run with
cuDNN's TF32 off (it is on by default), and matrix products keep PyTorch's
float32 default, so the card computes what the host does to float32 rounding.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..devices import resolve_device

WINDOW = 128
ANNOTATIONS = ("MQ", "DP", "SOR", "FS", "QD", "MQRankSum", "ReadPosRankSum")
_BASE_IDX = {b: i for i, b in enumerate("ACGT")}
FROZEN = ("ann_mean", "ann_std")  # set from the data before training, not trained
BATCH = 4096  # variants a forward pass takes at once when scoring


def encode_reference(ref_bases: str) -> np.ndarray:
    """(WINDOW, 4) one-hot reference window."""
    out = np.zeros((WINDOW, 4), np.float32)
    for i, b in enumerate(ref_bases[:WINDOW].upper()):
        j = _BASE_IDX.get(b)
        if j is not None:
            out[i, j] = 1.0
    return out


def encode_annotations(info: dict) -> np.ndarray:
    out = np.zeros(len(ANNOTATIONS), np.float32)
    for i, key in enumerate(ANNOTATIONS):
        try:
            out[i] = float(str(info.get(key, 0)).split(",")[0])
        except ValueError:
            out[i] = 0.0
    return out


# ---------------------------------------------------------------------------
# model (a dict of parameters, gatk_tpu's names and layouts)
# ---------------------------------------------------------------------------

def init_params(rng_seed=7, channels=(64, 64), kernel=12, dense=40):
    rng = np.random.default_rng(rng_seed)

    def glorot(shape, fan_in, fan_out):
        lim = math.sqrt(6.0 / (fan_in + fan_out))
        return rng.uniform(-lim, lim, size=shape).astype(np.float32)

    c1, c2 = channels
    params = {
        "conv1_w": glorot((kernel, 4, c1), kernel * 4, c1),
        "conv1_b": np.zeros(c1, np.float32),
        "conv2_w": glorot((kernel, c1, c2), kernel * c1, c2),
        "conv2_b": np.zeros(c2, np.float32),
        "ann_w": glorot((len(ANNOTATIONS), dense), len(ANNOTATIONS), dense),
        "ann_b": np.zeros(dense, np.float32),
        "ann_mean": np.zeros(len(ANNOTATIONS), np.float32),
        "ann_std": np.ones(len(ANNOTATIONS), np.float32),
        "head1_w": glorot((c2 + dense, dense), c2 + dense, dense),
        "head1_b": np.zeros(dense, np.float32),
        "head2_w": glorot((dense + len(ANNOTATIONS), 4), dense, 4),
        "head2_b": np.zeros(4, np.float32),
    }
    return params


def params_to_torch(params: dict, device=None) -> dict:
    """gatk_tpu's parameter dict (numpy) as float32 tensors on `device` (the
    port's default unless given), in the same layouts."""
    dev = resolve_device(device)
    return {k: torch.as_tensor(np.asarray(v, np.float32)).to(dev) for k, v in params.items()}


def params_to_numpy(params: dict) -> dict:
    """The port's parameter tensors back to gatk_tpu's dict of float32 arrays."""
    return {k: v.detach().cpu().numpy().astype(np.float32) for k, v in params.items()}


def full_float32():
    """Convolutions in full float32 on the card (cuDNN uses TF32 by default);
    the other cuDNN settings stay as they are."""
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                       deterministic=cudnn.deterministic, allow_tf32=False)


def forward(params: dict, ref_onehot: torch.Tensor, annotations: torch.Tensor) -> torch.Tensor:
    """Logits (N, 4): [SNP, NOT_SNP, INDEL, NOT_INDEL], from tensors on one
    device: params as params_to_torch makes them, ref_onehot (N, W, 4),
    annotations (N, 7)."""
    x = ref_onehot.transpose(1, 2)  # (N, 4, W)
    a = (annotations - params["ann_mean"]) / params["ann_std"]

    def conv(x, w, b):  # w in gatk_tpu's (width, in, out)
        return torch.relu(F.conv1d(x, w.permute(2, 1, 0), b))

    with full_float32():
        h = conv(x, params["conv1_w"], params["conv1_b"])
        h = conv(h, params["conv2_w"], params["conv2_b"])
    h = h.amax(dim=2)  # global max pool over positions -> (N, C)
    ann = torch.relu(a @ params["ann_w"] + params["ann_b"])
    z = torch.cat([h, ann], dim=-1)
    z = torch.relu(z @ params["head1_w"] + params["head1_b"])
    z = torch.cat([z, a], dim=-1)
    return z @ params["head2_w"] + params["head2_b"]


class Adam:
    """optax.adam(learning_rate) on a dict of tensors, in optax's order:
    mu = b1 mu + (1 - b1) g, nu = b2 nu + (1 - b2) g^2, the bias-corrected
    mu_hat / (sqrt(nu_hat) + eps), times -learning_rate, added to the
    parameter; one fused (foreach) launch per operation over all tensors."""

    def __init__(self, params: dict, learning_rate=1e-3, b1=0.9, b2=0.999, eps=1e-8):
        self.lr, self.b1, self.b2, self.eps = learning_rate, b1, b2, eps
        self.names = list(params)
        self.mu = [torch.zeros_like(params[k]) for k in self.names]
        self.nu = [torch.zeros_like(params[k]) for k in self.names]
        self.count = 0

    @torch.no_grad()
    def step(self, params: dict, grads: dict):
        self.count += 1
        p = [params[k] for k in self.names]
        g = [grads[k] for k in self.names]
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, g, alpha=1 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_addcmul_(self.nu, g, g, value=1 - self.b2)
        mu_hat = torch._foreach_div(self.mu, 1 - self.b1 ** self.count)
        nu_hat = torch._foreach_div(self.nu, 1 - self.b2 ** self.count)
        torch._foreach_sqrt_(nu_hat)
        torch._foreach_add_(nu_hat, self.eps)
        torch._foreach_div_(mu_hat, nu_hat)
        torch._foreach_add_(p, mu_hat, alpha=-self.lr)


def loss_and_grads(tparams: dict, x, a, y):
    """Softmax cross entropy with integer labels, averaged over the batch, and
    its gradients with respect to the trainable parameters."""
    trainable = {k: v for k, v in tparams.items() if k not in FROZEN}
    for v in trainable.values():
        v.requires_grad_(True)
    loss = F.cross_entropy(forward(tparams, x, a), y)
    grads = torch.autograd.grad(loss, list(trainable.values()))
    for v in trainable.values():
        v.requires_grad_(False)
    return loss.detach(), dict(zip(trainable, grads))


def train(params, ref_onehot, annotations, labels, epochs=40, batch=64,
          learning_rate=1e-3, seed=0, device=None):
    """labels: (N,) int in {0: SNP, 1: NOT_SNP, 2: INDEL, 3: NOT_INDEL}.
    gatk_tpu's train: ann_mean and ann_std set from the annotations and
    frozen, batches in the order of np.random.default_rng(seed).permutation
    each epoch, Adam on the mean cross entropy; on `device` (the port's
    default unless given). Returns a parameter dict of numpy arrays."""
    ann = np.asarray(annotations, np.float32)
    params = dict(params)
    params["ann_mean"] = ann.mean(axis=0).astype(np.float32)
    params["ann_std"] = np.maximum(ann.std(axis=0), 1e-3).astype(np.float32)
    tparams = params_to_torch(params, device)
    dev = tparams["conv1_w"].device
    opt = Adam({k: v for k, v in tparams.items() if k not in FROZEN}, learning_rate)

    x_all = torch.as_tensor(np.asarray(ref_onehot, np.float32)).to(dev)
    a_all = torch.as_tensor(ann).to(dev)
    y_all = torch.as_tensor(np.asarray(labels)).long().to(dev)
    rng = np.random.default_rng(seed)
    n = len(y_all)
    for _ in range(epochs):
        order = torch.as_tensor(rng.permutation(n)).to(dev)
        for i in range(0, n, batch):
            idx = order[i:i + batch]
            _loss, grads = loss_and_grads(tparams, x_all[idx], a_all[idx], y_all[idx])
            opt.step(tparams, grads)
    return params_to_numpy(tparams)


def run_batched(fn, tparams: dict, inputs, annotations, batch: int) -> np.ndarray:
    """fn(tparams, x, a) over numpy inputs and annotations, `batch` rows a
    pass on the parameters' device, without gradients; the (N, 4) logits as
    numpy."""
    dev = next(iter(tparams.values())).device
    x_all = np.asarray(inputs, np.float32)
    a_all = np.asarray(annotations, np.float32)
    parts = []
    with torch.no_grad():
        for i in range(0, len(x_all), batch):
            parts.append(fn(tparams, torch.as_tensor(x_all[i:i + batch]).to(dev),
                            torch.as_tensor(a_all[i:i + batch]).to(dev)).cpu())
    return torch.cat(parts).numpy() if parts else np.zeros((0, 4), np.float32)


def score(params, ref_onehot, annotations, is_snp, device=None):
    """CNN_1D scores: logit(true class) - logit(artifact class) per variant,
    on `device` (the port's default unless given), BATCH variants a pass."""
    logits = run_batched(forward, params_to_torch(params, device), ref_onehot, annotations,
                         BATCH)
    snp_score = logits[:, 0] - logits[:, 1]
    indel_score = logits[:, 2] - logits[:, 3]
    return np.where(np.asarray(is_snp), snp_score, indel_score)


def save_weights(params, path):
    np.savez_compressed(path, **params)


def load_weights(path):
    z = np.load(path)
    return {k: z[k] for k in z.files}

