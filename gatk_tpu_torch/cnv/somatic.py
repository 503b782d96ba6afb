# Copied from gatk_tpu/cnv/somatic.py; only import lines and build_panel_of_normals (somatic.py:180-265, whose SVD runs in PyTorch on a device) differ.
"""Somatic CNV stack: SVD denoising, kernel segmentation, copy-ratio calling.

Reference behavior:
- tools/copynumber/denoising/SVDDenoisingUtils.java (preprocessPanel :187-370,
  standardization :400-418, subtractProjection :426-451) and
  GCBiasCorrector.java:28-130 (per-sample GC curve = exponential-kernel-smoothed
  bin medians).
- tools/copynumber/utils/segmentation/KernelSegmenter.java (low-rank kernel
  approximation, per-window local costs, persistence-ranked candidates, backward
  model selection with penalty A*C + B*C*log(N/C)).
- tools/copynumber/caller/SimpleCopyRatioCaller.java (length-weighted z-score
  calling against copy-neutral segments).
- tools/copynumber/segmentation/{CopyRatio,AlleleFraction,
  MultisampleMultidimensional}KernelSegmenter.java (per-contig segmentation with
  variance kernels; ModelSegments.java parameter defaults).

TPU-first notes: segment costs reduce to prefix sums over the reduced
observation matrix Z (N x p), so window costs over all centers are vectorized
array ops; the PoN SVD and the Z construction (two N x p matmuls) run through
jnp on device.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..devices import resolve_device

EPSILON = 1e-9
SEG_EPSILON = 1e-10
LOG2_EPSILON = math.log2(EPSILON)


# ---------------------------------------------------------------------------
# SAM-header TSV collections (formats/collections/AbstractRecordCollection)
# ---------------------------------------------------------------------------

def read_sam_tsv(path: str):
    """Returns (sample, header_lines, column_names, rows[list of str lists])."""
    sample = None
    header = []
    cols = None
    rows = []
    with open(path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if line.startswith("@"):
                header.append(line)
                if line.startswith("@RG"):
                    for f in line.split("\t"):
                        if f.startswith("SM:"):
                            sample = f[3:]
                continue
            if not line:
                continue
            if cols is None:
                cols = line.split("\t")
            else:
                rows.append(line.split("\t"))
    return sample, header, cols, rows


def write_sam_tsv(path: str, sample: str, cols, rows, header_lines=None):
    with open(path, "w") as fh:
        if header_lines:
            for ln in header_lines:
                fh.write(ln + "\n")
        else:
            fh.write("@HD\tVN:1.6\n")
        if sample is not None and not any(h.startswith("@RG") for h in (header_lines or [])):
            fh.write(f"@RG\tID:GATKCopyNumber\tSM:{sample}\n")
        fh.write("\t".join(cols) + "\n")
        for r in rows:
            fh.write("\t".join(str(x) for x in r) + "\n")


def format_double(x: float) -> str:
    """CopyNumberFormatsUtils.formatDouble: 6 significant decimal places."""
    return f"{x:.6f}"


# ---------------------------------------------------------------------------
# GC-bias correction (GCBiasCorrector.java)
# ---------------------------------------------------------------------------

_N_GC_BINS = 101
_GC_CORR_DECAY = 1.0 / (0.02 * _N_GC_BINS)


def correct_gc_bias(counts: np.ndarray, gc: np.ndarray) -> np.ndarray:
    """counts: (samples, intervals). Returns GC-corrected copy (total preserved)."""
    counts = np.asarray(counts, np.float64)
    gc_bins = np.clip((gc * (_N_GC_BINS - 1)).round().astype(int), 0, _N_GC_BINS - 1)
    out = np.empty_like(counts)
    bin_idx = np.arange(_N_GC_BINS)
    kernel = np.exp(-np.abs(bin_idx[:, None] - bin_idx[None, :]) * _GC_CORR_DECAY)
    bin_sizes = np.bincount(gc_bins, minlength=_N_GC_BINS).astype(np.float64)
    for s in range(counts.shape[0]):
        medians = np.ones(_N_GC_BINS)
        for b in range(_N_GC_BINS):
            vals = counts[s][gc_bins == b]
            if len(vals):
                medians[b] = np.median(vals)
        weights = kernel * bin_sizes[None, :]
        smoothed = (weights @ medians) / weights.sum(axis=1)
        corrected = counts[s] / smoothed[gc_bins]
        total = counts[s].sum()
        out[s] = corrected * (total / corrected.sum())
    return out


# ---------------------------------------------------------------------------
# SVD denoising (SVDDenoisingUtils.java)
# ---------------------------------------------------------------------------

def _safe_log2(x):
    return np.where(x < EPSILON, LOG2_EPSILON, np.log2(np.maximum(x, EPSILON)))


def _standardize(frac: np.ndarray) -> np.ndarray:
    """divide by sample median, log2, subtract sample log2-median."""
    med = np.median(frac, axis=1, keepdims=True)
    if (med <= 0).any():
        raise ValueError("Sample does not have a positive sample median.")
    log2 = _safe_log2(frac / med)
    return log2 - np.median(log2, axis=1, keepdims=True)


@dataclass
class PanelOfNormals:
    """SVD read-count panel of normals (HDF5SVDReadCountPanelOfNormals equivalent)."""
    original_intervals: list          # [(contig, start_1b, end_1b)]
    original_gc: np.ndarray | None    # per original interval, or None
    panel_interval_idx: np.ndarray    # indices into original intervals
    panel_fractional_medians: np.ndarray
    eigensample_vectors: np.ndarray   # (panel intervals, K)
    singular_values: np.ndarray
    sample_names: list

    @property
    def num_eigensamples(self):
        return self.eigensample_vectors.shape[1]

    def save_hdf5(self, path: str):
        import h5py

        with h5py.File(path, "w") as f:
            g = f.create_group("panel")
            g.create_dataset("contigs", data=np.array([i[0] for i in self.original_intervals], dtype="S"))
            g.create_dataset("starts", data=np.array([i[1] for i in self.original_intervals]))
            g.create_dataset("ends", data=np.array([i[2] for i in self.original_intervals]))
            if self.original_gc is not None:
                g.create_dataset("gc", data=self.original_gc)
            g.create_dataset("panel_interval_idx", data=self.panel_interval_idx)
            g.create_dataset("fractional_medians", data=self.panel_fractional_medians)
            g.create_dataset("eigensample_vectors", data=self.eigensample_vectors)
            g.create_dataset("singular_values", data=self.singular_values)
            g.create_dataset("sample_names", data=np.array(self.sample_names, dtype="S"))

    @staticmethod
    def load_hdf5(path: str) -> "PanelOfNormals":
        import h5py

        with h5py.File(path, "r") as f:
            g = f["panel"]
            contigs = [c.decode() for c in g["contigs"][:]]
            starts = g["starts"][:]
            ends = g["ends"][:]
            return PanelOfNormals(
                original_intervals=[(c, int(s), int(e)) for c, s, e in zip(contigs, starts, ends)],
                original_gc=g["gc"][:] if "gc" in g else None,
                panel_interval_idx=g["panel_interval_idx"][:],
                panel_fractional_medians=g["fractional_medians"][:],
                eigensample_vectors=g["eigensample_vectors"][:],
                singular_values=g["singular_values"][:],
                sample_names=[s.decode() for s in g["sample_names"][:]],
            )


def build_panel_of_normals(counts: np.ndarray, intervals, gc=None, sample_names=None,
                           minimum_interval_median_percentile=10.0,
                           maximum_zeros_in_sample_percentage=5.0,
                           maximum_zeros_in_interval_percentage=5.0,
                           extreme_sample_median_percentile=2.5,
                           do_impute_zeros=True,
                           extreme_outlier_truncation_percentile=0.1,
                           number_of_eigensamples=20, device=None) -> PanelOfNormals:
    """counts: (samples, intervals) raw integer counts.
    Mirrors SVDDenoisingUtils.preprocessAndStandardizePanel. The SVD runs on
    `device` (devices.resolve_device: CUDA unless set otherwise)."""
    counts = np.asarray(counts, np.float64)
    n_samples, n_intervals = counts.shape

    # fractional coverage + optional GC correction
    frac = counts / counts.sum(axis=1, keepdims=True)
    if gc is not None:
        frac = correct_gc_bias(frac, np.asarray(gc))

    filter_intervals = np.zeros(n_intervals, bool)
    filter_samples = np.zeros(n_samples, bool)

    original_interval_medians = np.median(frac, axis=0)
    if minimum_interval_median_percentile > 0:
        thr = np.percentile(original_interval_medians, minimum_interval_median_percentile)
        filter_intervals |= original_interval_medians <= thr

    # divide by interval medians
    work = frac / np.maximum(original_interval_medians, EPSILON)[None, :]

    if maximum_zeros_in_sample_percentage < 100:
        n_keep_iv = (~filter_intervals).sum()
        zeros_per_sample = (work[:, ~filter_intervals] == 0).sum(axis=1)
        filter_samples |= zeros_per_sample >= n_keep_iv * maximum_zeros_in_sample_percentage / 100.0
    if maximum_zeros_in_interval_percentage < 100:
        n_keep_s = (~filter_samples).sum()
        zeros_per_interval = (work[~filter_samples] == 0).sum(axis=0)
        filter_intervals |= zeros_per_interval >= n_keep_s * maximum_zeros_in_interval_percentage / 100.0
    if extreme_sample_median_percentile > 0:
        sample_medians = np.array([
            np.median(work[s][~filter_intervals]) for s in range(n_samples)])
        lo = np.percentile(sample_medians, extreme_sample_median_percentile)
        hi = np.percentile(sample_medians, 100.0 - extreme_sample_median_percentile)
        filter_samples |= (sample_medians < lo) | (sample_medians > hi)

    keep_iv = np.nonzero(~filter_intervals)[0]
    keep_s = np.nonzero(~filter_samples)[0]
    if len(keep_iv) == 0 or len(keep_s) == 0:
        raise ValueError("Filtering removed all samples or intervals.")
    panel = work[np.ix_(keep_s, keep_iv)].copy()
    panel_medians = original_interval_medians[keep_iv]

    if do_impute_zeros:
        for j in range(panel.shape[1]):
            col = panel[:, j]
            nz = col[col > 0]
            if len(nz) and (col == 0).any():
                col[col == 0] = np.median(nz)
    if extreme_outlier_truncation_percentile > 0:
        lo = np.percentile(panel, extreme_outlier_truncation_percentile)
        hi = np.percentile(panel, 100.0 - extreme_outlier_truncation_percentile)
        panel = np.clip(panel, lo, hi)

    # standardize: log2 after dividing by sample median, then center by sample
    # median and the median of sample medians (preprocessAndStandardizePanel :88-100)
    med = np.median(panel, axis=1, keepdims=True)
    panel = _safe_log2(panel / med)
    sample_log2_medians = np.median(panel, axis=1, keepdims=True)
    panel = panel - sample_log2_medians

    # SVD on the device, in float32 as gatk_tpu computes it (jnp without x64);
    # a singular vector's sign may differ from gatk_tpu's, its projection not
    dev = resolve_device(device)
    k = int(min(number_of_eigensamples, min(panel.shape)))
    _u, s, vt = (x.cpu().numpy() for x in torch.linalg.svd(
        torch.as_tensor(panel, dtype=torch.float32, device=dev), full_matrices=False))
    eigen = vt[:k].T  # (panel intervals, K) right-singular vectors

    names = sample_names or [f"sample_{i}" for i in range(n_samples)]
    return PanelOfNormals(
        original_intervals=list(intervals),
        original_gc=None if gc is None else np.asarray(gc, np.float64),
        panel_interval_idx=keep_iv,
        panel_fractional_medians=panel_medians,
        eigensample_vectors=eigen,
        singular_values=s[:k],
        sample_names=[names[i] for i in keep_s],
    )


def standardize_sample(counts: np.ndarray, gc=None) -> np.ndarray:
    """No-PoN standardization (preprocessAndStandardizeSample :152-181)."""
    frac = np.asarray(counts, np.float64)[None, :]
    frac = frac / frac.sum()
    if gc is not None:
        frac = correct_gc_bias(frac, np.asarray(gc))
    return _standardize(frac)[0]


def denoise_sample(pon: PanelOfNormals, counts: np.ndarray, num_eigensamples=None):
    """Returns (standardized, denoised) log2 copy ratios over the panel intervals."""
    counts = np.asarray(counts, np.float64)
    frac = counts[None, :] / counts.sum()
    if pon.original_gc is not None:
        frac = correct_gc_bias(frac, pon.original_gc)
    sub = frac[:, pon.panel_interval_idx] / pon.panel_fractional_medians[None, :]
    standardized = _standardize(sub)

    k = pon.num_eigensamples if num_eigensamples is None else min(num_eigensamples, pon.num_eigensamples)
    if k == 0:
        return standardized[0], standardized[0].copy()
    u = pon.eigensample_vectors[:, :k]
    projection = (standardized @ u) @ u.T
    return standardized[0], (standardized - projection)[0]


# ---------------------------------------------------------------------------
# Kernel segmentation (KernelSegmenter.java, vectorized with prefix sums)
# ---------------------------------------------------------------------------

def _persistence_minima(values: np.ndarray):
    """Indices of local minima sorted by decreasing topological persistence
    (PersistenceOptimizer semantics)."""
    n = len(values)
    if n == 0:
        return []
    order = np.argsort(values, kind="stable")
    parent = np.full(n, -1, int)  # component representative (its minimum index)
    comp_min = {}
    persistence = {}
    active = np.zeros(n, bool)

    def find(i):
        root = i
        while parent[root] != root:
            root = parent[root]
        while parent[i] != root:
            parent[i], i = root, parent[i]
        return root

    for idx in order:
        idx = int(idx)
        left = idx - 1 if idx > 0 and active[idx - 1] else -1
        right = idx + 1 if idx < n - 1 and active[idx + 1] else -1
        active[idx] = True
        parent[idx] = idx
        if left < 0 and right < 0:
            comp_min[idx] = idx  # new component: idx is its minimum
            continue
        roots = []
        if left >= 0:
            roots.append(find(left))
        if right >= 0:
            roots.append(find(right))
        roots = list(dict.fromkeys(roots))
        # merge idx + neighbor components; the component with the lowest minimum survives
        all_mins = [comp_min[r] for r in roots]
        surviving = min(all_mins, key=lambda m: (values[m], m))
        for r in roots:
            m = comp_min[r]
            if m != surviving:
                persistence[m] = values[idx] - values[m]  # dies at this saddle
            parent[r] = find(surviving)
        parent[idx] = find(surviving)
        comp_min[find(surviving)] = surviving
    # global minimum persists forever
    global_min = int(order[0])
    persistence[global_min] = math.inf
    minima = sorted(persistence, key=lambda m: (-persistence[m], m))
    return minima


def _reduced_observation_matrix(data: np.ndarray, kernel_variance: float,
                                approximation_dim: int, rng: np.random.Generator):
    """Z (N x p): kernel feature map via SVD of a subsampled kernel matrix."""
    n = data.shape[0]
    p = min(approximation_dim, n)
    sub = data if p == n else data[rng.integers(0, n, size=p)]

    def kmat(a, b):
        if kernel_variance == 0.0:
            return np.outer(a, b) if a.ndim == 1 else a @ b.T
        d2 = (a[:, None] - b[None, :]) ** 2 if a.ndim == 1 else \
            ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
        return np.exp(-d2 / (2.0 * kernel_variance))

    K = kmat(sub, sub)
    u, s, _ = np.linalg.svd(K, hermitian=True)
    inv_sqrt = 1.0 / (np.sqrt(np.maximum(s, 0.0)) + SEG_EPSILON)
    return kmat(data, sub) @ (u * inv_sqrt[None, :])


def _segment_cost(zc: np.ndarray, dc: np.ndarray, start: int, end: int):
    """Cost of segment [start, end] from prefix sums zc (N+1, p), dc (N+1,)."""
    w = zc[end + 1] - zc[start]
    d = dc[end + 1] - dc[start]
    ln = end + 1 - start
    return d - (w @ w) / ln


def find_changepoints(data: np.ndarray, max_num_changepoints=1000,
                      kernel_variance=0.0, approximation_dim=100,
                      window_sizes=(8, 16, 32, 64, 128, 256),
                      penalty_linear=1.0, penalty_log_linear=1.0,
                      seed=1216):
    """Changepoint indices (sorted), each the last index of a segment.

    data: (N,) or (N, d) points in order."""
    data = np.asarray(data, np.float64)
    n = data.shape[0]
    if n == 0 or max_num_changepoints == 0:
        return []
    rng = np.random.default_rng(seed)
    z = _reduced_observation_matrix(data, kernel_variance, approximation_dim, rng)
    diag = (z * z).sum(axis=1)

    # prefix sums for O(p) segment costs
    zc = np.vstack([np.zeros(z.shape[1]), np.cumsum(z, axis=0)])
    dc = np.concatenate([[0.0], np.cumsum(diag)])

    # window costs, vectorized over centers via circular padding
    candidates = []
    for w in window_sizes:
        if 2 * w > n:
            continue
        zt = np.vstack([z, z])  # circular
        dt = np.concatenate([diag, diag])
        zc2 = np.vstack([np.zeros(z.shape[1]), np.cumsum(zt, axis=0)])
        dc2 = np.concatenate([[0.0], np.cumsum(dt)])

        centers = np.arange(n)
        start = (centers - w + 1 + n) % n       # left segment [start, center]
        # evaluate on the doubled array: left = [start, start + w - 1]
        ls = start
        le = start + w
        rs = start + w
        re = start + 2 * w

        def seg_cost(s_arr, e_arr, ln):
            wv = zc2[e_arr] - zc2[s_arr]
            dv = dc2[e_arr] - dc2[s_arr]
            return dv - (wv * wv).sum(axis=1) / ln

        left_c = seg_cost(ls, le, w)
        right_c = seg_cost(rs, re, w)
        total_c = seg_cost(ls, re, 2 * w)
        costs = left_c + right_c - total_c
        # costs[i] corresponds to changepoint at center = (start + w - 1) mod n
        center_of = (start + w - 1) % n
        window_costs = np.empty(n)
        window_costs[center_of] = costs

        minima = [m for m in _persistence_minima(window_costs) if m not in (0, n - 1)]
        candidates.extend(minima[:max_num_changepoints])

    if not candidates:
        return []

    # backward model selection
    cand = sorted(set(candidates))
    starts = [0] + [min(c + 1, n - 1) for c in cand]
    ends = cand + [n - 1]
    seg_costs = [_segment_cost(zc, dc, s, e) for s, e in zip(starts, ends)]
    segments = list(zip(starts, ends, seg_costs))

    merge_order = []  # changepoints in order of merging (least important first)
    total_costs = [sum(c for _, _, c in segments)]
    while len(segments) > 1:
        best_i, best_gain = 0, -math.inf
        merged_costs = []
        for i in range(len(segments) - 1):
            mc = _segment_cost(zc, dc, segments[i][0], segments[i + 1][1])
            merged_costs.append(mc)
            gain = segments[i][2] + segments[i + 1][2] - mc
            if gain > best_gain:
                best_gain, best_i = gain, i
        s0, e0, _ = segments[best_i]
        s1, e1, _ = segments[best_i + 1]
        merge_order.append(e0)
        segments[best_i:best_i + 2] = [(s0, e1, merged_costs[best_i])]
        total_costs.insert(0, sum(c for _, _, c in segments))

    changepoints_by_importance = merge_order[::-1]
    max_cp = min(max_num_changepoints, len(changepoints_by_importance))
    penalties = [penalty_linear * c + penalty_log_linear * c * math.log(n / (c + SEG_EPSILON))
                 for c in range(max_cp + 1)]
    scores = [total_costs[c] + penalties[c] for c in range(max_cp + 1)]
    n_opt = int(np.argmin(scores))
    return sorted(changepoints_by_importance[:n_opt])


def segment_values(contigs, values, **kwargs):
    """Per-contig kernel segmentation. Returns [(contig, first_idx, last_idx)]
    over global indices."""
    values = np.asarray(values)
    segments = []
    i = 0
    n = len(contigs)
    while i < n:
        j = i
        while j < n and contigs[j] == contigs[i]:
            j += 1
        cps = find_changepoints(values[i:j], **kwargs)
        bounds = [i - 1] + [i + c for c in cps] + [j - 1]
        for k in range(len(bounds) - 1):
            segments.append((contigs[i], bounds[k] + 1, bounds[k + 1]))
        i = j
    return segments


# ---------------------------------------------------------------------------
# SimpleCopyRatioCaller (caller/SimpleCopyRatioCaller.java)
# ---------------------------------------------------------------------------

def call_copy_ratio_segments(segments, neutral_lower=0.9, neutral_upper=1.1,
                             outlier_z=2.0, calling_z=2.0):
    """segments: [(contig, start, end, n_points, mean_log2_cr)].
    Returns per-segment calls '+', '-', or '0'."""

    def weighted_stats(segs):
        lengths = np.array([s[2] - s[1] + 1 for s in segs], float)
        crs = np.array([2.0 ** s[4] for s in segs])
        total = lengths.sum()
        mean = (lengths * crs).sum() / total
        m = len(segs)
        var = (lengths * (crs - mean) ** 2).sum() / (((m - 1) / m) * total) if m > 1 else 0.0
        return mean, math.sqrt(var)

    neutral = [s for s in segments if neutral_lower <= 2.0 ** s[4] <= neutral_upper]
    if not neutral:
        return ["+" if 2.0 ** s[4] > neutral_upper else "-" for s in segments]
    mean0, sd0 = weighted_stats(neutral)
    filtered = [s for s in neutral if abs(2.0 ** s[4] - mean0) <= sd0 * outlier_z] or neutral
    mean, sd = weighted_stats(filtered)

    calls = []
    for s in segments:
        cr = 2.0 ** s[4]
        if neutral_lower <= cr <= neutral_upper:
            calls.append("0")
        elif cr - mean < -sd * calling_z:
            calls.append("-")
        elif cr - mean > sd * calling_z:
            calls.append("+")
        else:
            calls.append("0")
    return calls
