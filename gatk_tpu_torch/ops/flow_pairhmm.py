"""Flow-space PairHMM (Ultima Genomics) on an NVIDIA GPU: the PyTorch port of
gatk_tpu/ops/flow_pairhmm.py.

Reference: utils/pairhmm/FlowBasedPairHMM.java:167-241. The DP runs over flow
*keys* (homopolymer run lengths per flow) instead of bases; frame shifts happen
in discrete units of FLOW_SIZE=4 (the flow-order cycle), so:
  * match      pulls (i-1, j-1)      — next flow on both
  * insertion  pulls (i-4, j)        — a full extra flow cycle in the read
  * deletion   pulls (i,   j-4)      — a full extra flow cycle in the haplotype
Priors are the read's flow-matrix P(true hmer = hapKey[j] | flow i), nonzero only
where read/hap flow nucleotides agree — which for period-4 cyclic flow orders
confines each DP to one (j - i) mod 4 coset, so the batched version computes
dense rows safely (off-coset cells stay exactly zero).

`flow_pairhmm_log10` is the host float64 reference, as gatk_tpu writes it. Both
batched versions run row by row over the read's flows in float32 with the row
renormalisation of gatk_tpu's flow_pairhmm_batch_jax (:116-194): a running
log10 offset in place of the 2^1020 scale.

`flow_pairhmm_pairs(tab, ri, hi)` scores the pairs (read ri[b], haplotype
hi[b]) of the tables `pack_flow_tables` uploads, on the coset cells alone, as
GATK loops: on a CUDA tensor it launches the hand-written Hopper kernel
csrc/flow_pairhmm.cu (ops/_kernels.flow_pairhmm), which gathers each cell's
prior from the tables itself, and raises if the launch fails; on a CPU tensor
it runs `flow_pairhmm_pairs_plain`, the plain PyTorch version on the same
lattice, which is also the kernel's oracle. The lattice needs flow bases that
repeat with period 4 over four distinct bases (`rule_broken_pairs`); the
pairs whose read or haplotype breaks that rule (an order such as TGCATGAC)
go to gatk_tpu's dense scan instead: on the card the hand-written kernel
csrc/flow_pairhmm_dense.cu (ops/_kernels.flow_pairhmm_dense), on the CPU its
plain version `flow_pairhmm_dense_plain`. On the card so do all the pairs of
a call whose haplotype width passes what the coset kernel's shared memory
holds (ops/_kernels.flow_pairhmm_smem). The dense kernel walks each pair's
live lattices (`live_residues`) alone; `flow_pairhmm_live_plain` is the
plain version of that decomposition. The entry's `launches` and `pairs`
count the coset kernel's launches and the pairs they scored, its
`dense.launches` and `dense.pairs` the dense kernel's.

`flow_pairhmm_batch_plain(prior, trans, rlen, hlen)` is gatk_tpu's dense scan
in PyTorch, on the (B, Rp, W) prior `flow_prior` gathers from the same tables
(equal bit for bit to gatk_tpu's host packing `_pack_flow_batch`, kept here as
the gather's oracle). `compute_flow_likelihood_matrix` runs it on the CPU, so
that the CPU result is gatk_tpu's, and the kernels on a card.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import pairhmm_model as pm
from ..devices import resolve_device
from .flow import FlowBasedHaplotype, FlowBasedRead
from .pairhmm import _Counted

FLOW_SIZE = 4
# floats of the dense prior the CPU route builds at once (512 MiB); a larger
# batch of pairs is cut into parts of whole pairs
MAX_PRIOR_FLOATS = 1 << 27


def _starting_point(hap_flow_order: np.ndarray, read_flow_order: np.ndarray) -> int:
    """First haplotype flow reading the same nucleotide as the read's first flow
    (FlowBasedPairHMM.java:141-147)."""
    for i, b in enumerate(hap_flow_order):
        if b == read_flow_order[0]:
            return i
    return 0


def flow_pairhmm_log10(hap: FlowBasedHaplotype, read: FlowBasedRead) -> float:
    """Host f64 reference, mirroring FlowBasedPairHMM.java:167-241 exactly."""
    rk = read.key
    hk = hap.key
    R, H = len(rk), len(hk)
    if R == 0 or H == 0:
        return -np.inf
    pr, pc = R + 1 + FLOW_SIZE, H + 1 + FLOW_SIZE
    hap_start = _starting_point(hap.flow_order_array, read.flow_order_array)

    iq, dq, gcp = read.key_space_quals()
    trans = pm.qual_to_trans_probs(iq, dq, gcp)  # (R, 6)

    prob = read.prob_table(int(hk.max()))  # (R, max_hmer+1)
    prior = np.zeros((pr, pc))
    same = hap.flow_order_array[None, :] == read.flow_order_array[:, None]
    prior[1 + FLOW_SIZE:, 1 + FLOW_SIZE:] = np.where(same, prob[:, hk], 0.0)

    m = np.zeros((pr, pc))
    ins = np.zeros((pr, pc))
    d = np.zeros((pr, pc))
    init = 2.0 ** 1020 / H
    d[: FLOW_SIZE + 1, :] = init

    MM, IM = pm.MATCH_TO_MATCH, pm.INDEL_TO_MATCH
    MI, II = pm.MATCH_TO_INSERTION, pm.INSERTION_TO_INSERTION
    MD, DD = pm.MATCH_TO_DELETION, pm.DELETION_TO_DELETION
    for i in range(1 + FLOW_SIZE, pr):
        t = trans[i - FLOW_SIZE - 1]
        for j in range((hap_start + i) % FLOW_SIZE + FLOW_SIZE, pc, FLOW_SIZE):
            m[i, j] = prior[i, j] * (
                m[i - 1, j - 1] * t[MM]
                + ins[i - 1, j - 1] * t[IM]
                + d[i - 1, j - 1] * t[IM]
            )
            ins[i, j] = m[i - FLOW_SIZE, j] * t[MI] + ins[i - FLOW_SIZE, j] * t[II]
            d[i, j] = m[i, j - FLOW_SIZE] * t[MD] + d[i, j - FLOW_SIZE] * t[DD]
    total = m[pr - 1, 1:].sum() + ins[pr - 1, 1:].sum()
    if total <= 0:
        return -np.inf
    return float(np.log10(total) - pm.INITIAL_CONDITION_LOG10)


# ---------------------------------------------------------------------------
# Batched path
# ---------------------------------------------------------------------------


def _pack_flow_batch(haps, reads, pairs):
    """Host-side packing of the batched DP's inputs, as gatk_tpu packs them.

    pairs: list of (read_idx, hap_idx). Returns dict of padded arrays."""
    B = len(pairs)
    Rp = max(len(reads[ri].key) for ri, _ in pairs)
    Hp = max(len(haps[hi].key) for _, hi in pairs)
    W = Hp + 1 + FLOW_SIZE
    prior = np.zeros((B, Rp, W), dtype=np.float32)
    trans = np.zeros((B, Rp, 6), dtype=np.float32)
    rlen = np.zeros(B, dtype=np.int32)
    hlen = np.zeros(B, dtype=np.int32)
    ks_cache = {}
    for b, (ri, hi) in enumerate(pairs):
        rd, hp = reads[ri], haps[hi]
        R, H = len(rd.key), len(hp.key)
        rlen[b], hlen[b] = R, H
        if ri not in ks_cache:
            iq, dq, gc = rd.key_space_quals()
            ks_cache[ri] = pm.qual_to_trans_probs(iq, dq, gc)
        trans[b, :R] = ks_cache[ri]
        prob = rd.prob_table(int(hp.key.max()) if H else 0)
        same = hp.flow_order_array[None, :] == rd.flow_order_array[:, None]
        # prior rows for DP rows i=F+1.. map to read flow i-F-1; columns j=F+1..
        prior[b, :R, 1 + FLOW_SIZE: 1 + FLOW_SIZE + H] = np.where(
            same, prob[:, hp.key], 0.0)
    return dict(prior=prior, trans=trans, rlen=rlen, hlen=hlen,
                hap_start=np.zeros(B, dtype=np.int32), W=W, Rp=Rp)


READ_PAD = 0xFF  # flow base of a read's padding rows: equals no haplotype flow base
HAP_PAD = 0xFE  # flow base of a haplotype's padding columns


def pack_flow_tables(haps, reads, device):
    """The per-read and per-haplotype tables `flow_prior` gathers from, on
    `device`: dict(tables (NR, Rp, hmax + 1) f32, row f of read r holding
    P(true hmer = h | flow f) for h = 0..hmax (the read's prob_table), rfo
    (NR, Rp) uint8 flow bases, trans (NR, Rp, 6) f32 transition rows,
    rlen (NR,) int32; hkey (NH, Hp) int32 keys, hfo (NH, Hp) uint8 flow bases,
    hlen (NH,) int32), with hmax the largest key of any haplotype. Rows past a
    read's flows and columns past a haplotype's carry flow bases that match
    nothing, so their priors are 0."""
    nr, nh = len(reads), len(haps)
    Rp = max(len(rd.key) for rd in reads)
    Hp = max(len(hp.key) for hp in haps)
    hmax = max((int(hp.key.max()) for hp in haps if len(hp.key)), default=0)
    tables = np.zeros((nr, Rp, hmax + 1), np.float32)
    rfo = np.full((nr, Rp), READ_PAD, np.uint8)
    trans = np.zeros((nr, Rp, 6), np.float32)
    rlen = np.zeros(nr, np.int32)
    for ri, rd in enumerate(reads):
        R = len(rd.key)
        rlen[ri] = R
        tables[ri, :R] = rd.prob_table(hmax)
        rfo[ri, :R] = rd.flow_order_array
        trans[ri, :R] = pm.qual_to_trans_probs(*rd.key_space_quals())
    hkey = np.zeros((nh, Hp), np.int32)
    hfo = np.full((nh, Hp), HAP_PAD, np.uint8)
    hlen = np.zeros(nh, np.int32)
    for hi, hp in enumerate(haps):
        H = len(hp.key)
        hlen[hi] = H
        hkey[hi, :H] = hp.key
        hfo[hi, :H] = hp.flow_order_array
    arrays = dict(tables=tables, rfo=rfo, trans=trans, rlen=rlen, hkey=hkey, hfo=hfo, hlen=hlen)
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


def flow_prior(tables, ri: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """(B, Rp, W) f32 prior of the pairs (read ri[b], haplotype hi[b]) of
    `tables` (pack_flow_tables), W = Hp + 1 + FLOW_SIZE, on the tables' device:
    row k, column FLOW_SIZE + 1 + j holds P(true hmer = key[j] | flow k) where
    the read's flow k and the haplotype's flow j read one nucleotide, else 0.
    Equal bit for bit to _pack_flow_batch's prior of the same pairs when Rp and
    Hp are the largest of those pairs."""
    B = ri.numel()
    Rp, Hp = tables["rfo"].shape[1], tables["hkey"].shape[1]
    keys = tables["hkey"][hi].long()
    vals = torch.gather(tables["tables"][ri], 2, keys[:, None, :].expand(B, Rp, Hp))
    same = tables["rfo"][ri][:, :, None] == tables["hfo"][hi][:, None, :]
    prior = torch.zeros((B, Rp, Hp + 1 + FLOW_SIZE), dtype=torch.float32, device=ri.device)
    prior[:, :, 1 + FLOW_SIZE:] = torch.where(same, vals, 0.0)
    return prior


def _shift(x, n):
    """x[:, j - n], zero for j < n."""
    return torch.nn.functional.pad(x, (n, 0))[:, : x.shape[1]]


def _affine_scan(b, dd):
    """x[:, g] = b[:, g] + dd * x[:, g - 1] along dim 1, from x[:, -1] = 0: an
    inclusive scan of the affine maps (dd, b), by doubling (log2 of the
    length steps). dd broadcasts to b."""
    A = dd.expand_as(b)
    s = 1
    while s < b.shape[1]:
        b = torch.cat([b[:, :s], b[:, s:] + A[:, s:] * b[:, :-s]], dim=1)
        A = torch.cat([A[:, :s], A[:, s:] * A[:, :-s]], dim=1)
        s *= 2
    return b


def _deletion_row(a, dd):
    """d[:, j] = a[:, j] + dd * d[:, j - 4] along each of the four stride-4
    chains, starting at 0. a (B, Wp), Wp a multiple of 4; dd (B, 1)."""
    B, Wp = a.shape
    return _affine_scan(a.view(B, Wp // FLOW_SIZE, FLOW_SIZE), dd[:, :, None]).reshape(B, Wp)


def final_rows(rlen: torch.Tensor, Rp: int) -> torch.Tensor:
    """The row whose sum is each pair's result: clip(rlen - 1, 0, Rp - 1)."""
    return (rlen.long() - 1).clamp(0, Rp - 1)


def flow_pairhmm_batch_plain(prior: torch.Tensor, trans: torch.Tensor, rlen: torch.Tensor,
                             hlen: torch.Tensor) -> torch.Tensor:
    """gatk_tpu's dense batched flow PairHMM in PyTorch, the CPU route of
    compute_flow_likelihood_matrix and the kernel's second oracle: (B,) f32
    log10 likelihoods from prior (B, Rp, W) f32 already masked to the coset
    (flow_prior), trans (B, Rp, 6) f32, rlen, hlen (B,) int. Every column of
    the batch's W is computed, the off-coset ones too.

    The steps of gatk_tpu's flow_pairhmm_batch_jax (:116-194) in its order,
    a loop over the read's flows k: a 4-row history of M and I, the previous
    D row (first 1/max(hlen, 1) over the W columns, 0 in the padding to a
    multiple of 4); each row's M and I elementwise, its D by the stride-4
    affine recurrence from 0; the row's M + I sum kept at k = clip(rlen - 1,
    0, Rp - 1); then the carried state divided by c = max(M, I, D) of the row
    (1 where c <= 0) and log10(c) added to a float32 offset. The result is
    log10(sum) plus the offset before that row, -inf where the sum is <= 0.
    The loop stops at the last row any pair needs."""
    B, Rp, W = prior.shape
    Wp = -(-W // FLOW_SIZE) * FLOW_SIZE
    pad = Wp - W
    dev = prior.device
    zeros = torch.zeros((B, Wp), dtype=torch.float32, device=dev)
    init = torch.ones((B, W), dtype=torch.float32, device=dev) / hlen.float().clamp(min=1.0)[:, None]
    d_prev = torch.nn.functional.pad(init, (0, pad))
    m_hist, i_hist = [zeros] * 4, [zeros] * 4
    acc = torch.zeros(B, dtype=torch.float32, device=dev)
    kf = final_rows(rlen, Rp)
    total = torch.zeros(B, dtype=torch.float32, device=dev)
    acc_at = torch.zeros(B, dtype=torch.float32, device=dev)
    MM, IM = pm.MATCH_TO_MATCH, pm.INDEL_TO_MATCH
    MI, II = pm.MATCH_TO_INSERTION, pm.INSERTION_TO_INSERTION
    MD, DD = pm.MATCH_TO_DELETION, pm.DELETION_TO_DELETION
    for k in range(int(kf.max()) + 1 if B else 0):
        prior_row = torch.nn.functional.pad(prior[:, k], (0, pad))
        t = trans[:, k]
        m_row = prior_row * (_shift(m_hist[3], 1) * t[:, MM:MM + 1]
                             + (_shift(i_hist[3], 1) + _shift(d_prev, 1)) * t[:, IM:IM + 1])
        i_row = m_hist[0] * t[:, MI:MI + 1] + i_hist[0] * t[:, II:II + 1]
        d_row = _deletion_row(_shift(m_row, FLOW_SIZE) * t[:, MD:MD + 1], t[:, DD:DD + 1])
        here = kf == k
        total = torch.where(here, m_row.sum(dim=1) + i_row.sum(dim=1), total)
        acc_at = torch.where(here, acc, acc_at)
        c = torch.maximum(torch.maximum(m_row.amax(dim=1), i_row.amax(dim=1)), d_row.amax(dim=1))
        c = torch.where(c > 0, c, torch.ones_like(c))
        inv = (1.0 / c)[:, None]
        m_hist = [m_hist[1] * inv, m_hist[2] * inv, m_hist[3] * inv, m_row * inv]
        i_hist = [i_hist[1] * inv, i_hist[2] * inv, i_hist[3] * inv, i_row * inv]
        d_prev = d_row * inv
        acc = acc + torch.log10(c)
    out = torch.where(total > 0, torch.log10(total.clamp(min=1e-38)),
                      torch.full_like(total, -math.inf))
    return out + acc_at


def _rows_breaking_rule(fo: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """(n,) bool: whether row r's flow bases fo[r, :lens[r]] break the coset
    rule: the bases repeat with period FLOW_SIZE over FLOW_SIZE distinct
    bases (TGCA, as HaplotypeCaller's --flow-order gives them), which confines
    every pair's nonzero DP cells to one (column - row) mod 4 coset."""
    n, L = fo.shape
    f = torch.arange(L, device=fo.device)
    inside = f[None, :] < lens[:, None]
    bad = (fo != fo[:, f % FLOW_SIZE]) & inside
    for a in range(1, min(FLOW_SIZE, L)):
        for b in range(a):
            bad[:, a] |= (fo[:, a] == fo[:, b]) & inside[:, a]
    return bad.any(dim=1)


def rule_broken_pairs(tab, ri: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """(B,) bool on the tables' device: the pairs whose read or haplotype
    breaks the coset rule (_rows_breaking_rule). The entry scores them by the
    dense route, the rest on the coset lattice."""
    reads = _rows_breaking_rule(tab["rfo"], tab["rlen"])
    haps = _rows_breaking_rule(tab["hfo"], tab["hlen"])
    return reads[ri.long()] | haps[hi.long()]


def coset_rule_breaks(tab, ri: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """(2,) int32 on the tables' device, the plain version of the coset
    kernel's flags: 1 + the largest index of a read of ri, and of a haplotype
    of hi, that breaks the coset rule (_rows_breaking_rule), 0 where none
    does."""
    out = []
    for fo, lens, pick in ((tab["rfo"], tab["rlen"], ri), (tab["hfo"], tab["hlen"], hi)):
        used = torch.zeros(fo.shape[0], dtype=torch.bool, device=fo.device)
        used[pick.long()] = True
        idx = torch.arange(1, fo.shape[0] + 1, dtype=torch.int32, device=fo.device)
        out.append((idx * (_rows_breaking_rule(fo, lens) & used)).max())
    return torch.stack(out).to(torch.int32)


def flow_pairhmm_dense_plain(tab, ri: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """gatk_tpu's dense scan of the pairs (read ri[b], haplotype hi[b]) of
    `tab`: flow_pairhmm_batch_plain on flow_prior, MAX_PRIOR_FLOATS of prior at
    a time (parts of whole pairs). The plain version of
    csrc/flow_pairhmm_dense.cu (which computes it lattice by lattice, as
    flow_pairhmm_live_plain does), and the CPU route of
    compute_flow_likelihood_matrix."""
    Rp, Hp = tab["rfo"].shape[1], tab["hkey"].shape[1]
    step = max(1, MAX_PRIOR_FLOATS // (Rp * (Hp + 1 + FLOW_SIZE)))
    outs = [torch.zeros(0, dtype=torch.float32, device=tab["tables"].device)]
    for lo in range(0, ri.numel(), step):
        r, h = ri[lo:lo + step], hi[lo:lo + step]
        outs.append(flow_pairhmm_batch_plain(flow_prior(tab, r, h), tab["trans"][r],
                                             tab["rlen"][r], tab["hlen"][h]))
    return torch.cat(outs)


def flow_pairhmm_pairs_plain(tab, ri: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of csrc/flow_pairhmm.cu: (B,) f32 log10
    likelihoods of the pairs (read ri[b], haplotype hi[b]) of `tab`
    (pack_flow_tables), on the coset lattice that GATK's loop and the kernel
    walk: flow_pairhmm_lattice_plain at s, the pair's _starting_point (the
    first of its haplotype's first four flows reading the read's first base,
    else 0). Where the flow bases keep the coset rule (coset_rule_breaks) the
    dense version's cells off this lattice are 0, and both give one log10
    likelihood up to float32 rounding; the kernel takes each row's c from M
    and I alone, which changes only the rounding too."""
    ri, hi = ri.long(), hi.long()
    Hp = tab["hfo"].shape[1]
    if ri.numel() == 0:
        return torch.zeros(0, dtype=torch.float32, device=tab["tables"].device)
    H = tab["hlen"][hi].long().clamp(0, Hp)
    first = torch.arange(min(FLOW_SIZE, Hp), device=ri.device)
    hits = ((tab["hfo"][hi][:, : len(first)] == tab["rfo"][ri][:, :1])
            & (first[None, :] < H[:, None]))
    s = torch.where(hits.any(dim=1), hits.int().argmax(dim=1), 0)
    return flow_pairhmm_lattice_plain(tab, ri, hi, s)


def flow_pairhmm_lattice_plain(tab, ri: torch.Tensor, hi: torch.Tensor,
                               s: torch.Tensor) -> torch.Tensor:
    """(B,) f32 log10 likelihoods of the tasks (read ri[b], haplotype hi[b],
    residue s[b]) of `tab`, each on one (column - row) mod 4 lattice of
    gatk_tpu's dense scan: the lattice csrc/flow_pairhmm.cu walks for a pair
    whose _starting_point is s.

    Row k of a task holds the cells g < G = ceil((hlen + 5) / 4), cell g at
    DP column 4 g + r_k, r_k = (5 + k + s) mod 4: haplotype flow
    j = 4 g + r_k - 5, prior tables[ri, k, hkey[hi, j]] where 0 <= j < hlen
    and the read's flow base at k is the haplotype's at j, else 0. M pulls
    cell g of row k - 1, or g - 1 where r_k = 0; I cell g of row k - 4; D
    cell g - 1 of its own row; D starts at 1 / max(hlen, 1) in every cell of
    row -1 and is 0 at cells >= G. The rest is flow_pairhmm_batch_plain's:
    the row's M + I sum kept at k = clip(rlen - 1, 0, Rp - 1), the carried
    rows divided by the row's maximum c (1 where c <= 0), log10(c) added to a
    float32 offset. A task whose rlen is outside [0, Rp] or hlen outside
    [0, Hp] gives NaN, as in the kernels."""
    ri, hi, s = ri.long(), hi.long(), s.long()
    B = ri.numel()
    dev = tab["tables"].device
    Rp, Hp = tab["rfo"].shape[1], tab["hfo"].shape[1]
    if B == 0:
        return torch.zeros(0, dtype=torch.float32, device=dev)
    R, H = tab["rlen"][ri].long(), tab["hlen"][hi].long()
    out_of_range = (R < 0) | (R > Rp) | (H < 0) | (H > Hp)
    H = H.clamp(0, Hp)
    kf = final_rows(R, Rp)
    G = (H + 1 + 2 * FLOW_SIZE - 1) // FLOW_SIZE
    g = torch.arange(int(G.max()), device=dev)
    inside = g[None, :] < G[:, None]
    rfo, hfo, hkey = tab["rfo"][ri], tab["hfo"][hi], tab["hkey"][hi].long()
    zeros = torch.zeros((B, len(g)), dtype=torch.float32, device=dev)
    d_prev = (1.0 / H.float().clamp(min=1.0))[:, None].expand(B, len(g))
    m_hist, i_hist = [zeros] * 4, [zeros] * 4
    acc = torch.zeros(B, dtype=torch.float32, device=dev)
    total = torch.zeros(B, dtype=torch.float32, device=dev)
    acc_at = torch.zeros(B, dtype=torch.float32, device=dev)
    MM, IM = pm.MATCH_TO_MATCH, pm.INDEL_TO_MATCH
    MI, II = pm.MATCH_TO_INSERTION, pm.INSERTION_TO_INSERTION
    MD, DD = pm.MATCH_TO_DELETION, pm.DELETION_TO_DELETION
    for k in range(int(kf.max()) + 1):
        r = (1 + FLOW_SIZE + k + s) % FLOW_SIZE
        j = FLOW_SIZE * g[None, :] + r[:, None] - 1 - FLOW_SIZE
        valid = (j >= 0) & (j < H[:, None])
        if Hp:
            jc = j.clamp(0, Hp - 1)
            key, base = torch.gather(hkey, 1, jc), torch.gather(hfo, 1, jc)
            vals = torch.gather(tab["tables"][ri, k], 1, key)
            prior = torch.where(valid & (base == rfo[:, k:k + 1]), vals, 0.0)
        else:
            prior = zeros
        t = tab["trans"][ri, k]
        q = m_hist[3] * t[:, MM:MM + 1] + (i_hist[3] + d_prev) * t[:, IM:IM + 1]
        m_row = prior * torch.where((r == 0)[:, None], _shift(q, 1), q)
        i_row = m_hist[0] * t[:, MI:MI + 1] + i_hist[0] * t[:, II:II + 1]
        d_row = _affine_scan(_shift(m_row, 1) * t[:, MD:MD + 1], t[:, DD:DD + 1])
        d_row = torch.where(inside, d_row, 0.0)
        here = kf == k
        total = torch.where(here, (m_row + i_row).sum(dim=1), total)
        acc_at = torch.where(here, acc, acc_at)
        c = torch.maximum(torch.maximum(m_row.amax(dim=1), i_row.amax(dim=1)), d_row.amax(dim=1))
        c = torch.where(c > 0, c, torch.ones_like(c))
        inv = (1.0 / c)[:, None]
        m_hist = [m_hist[1] * inv, m_hist[2] * inv, m_hist[3] * inv, m_row * inv]
        i_hist = [i_hist[1] * inv, i_hist[2] * inv, i_hist[3] * inv, i_row * inv]
        d_prev = d_row * inv
        acc = acc + torch.log10(c)
    out = torch.where(total > 0, torch.log10(total.clamp(min=1e-38)),
                      torch.full_like(total, -math.inf)) + acc_at
    return torch.where(out_of_range, torch.full_like(out, math.nan), out)


def live_residues(tab, ri: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """(B, FLOW_SIZE) bool: which (column - row) mod 4 lattices of pair b's
    dense scan are live. The dense recurrence never crosses a lattice (M
    pulls (k - 1, c - 1), I (k - 4, c), D (k, c - 4), row 0's M the initial
    D at (-1, c - 1)), and a lattice that row 0 does not seed stays exactly
    0. Row 0 seeds the lattice of residue s (flow_pairhmm_lattice_plain's s)
    where a haplotype flow f < hlen with f mod 4 = s reads the read's first
    flow base with a nonzero prior tables[ri, 0, hkey[f]]. Over all of the
    haplotype's flows: in TGCATGAC, C reads at flows 2 and 7."""
    ri, hi = ri.long(), hi.long()
    B = ri.numel()
    Hp, T1 = tab["hfo"].shape[1], tab["tables"].shape[2]
    key = tab["hkey"][hi].long()
    vals = torch.gather(tab["tables"][ri, 0], 1, key.clamp(0, T1 - 1))
    f = torch.arange(Hp, device=ri.device)
    seeds = ((f[None, :] < tab["hlen"][hi].long()[:, None])
             & (tab["hfo"][hi] == tab["rfo"][ri, :1]) & (key >= 0) & (key < T1) & (vals > 0))
    pad = -Hp % FLOW_SIZE
    return torch.nn.functional.pad(seeds, (0, pad)).view(B, -1, FLOW_SIZE).any(dim=1)


def flow_pairhmm_live_plain(tab, ri: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """gatk_tpu's dense scan of the pairs (read ri[b], haplotype hi[b]) of
    `tab` as the sum of its live lattices: the structural oracle of
    csrc/flow_pairhmm_dense.cu, on no route. Each live residue s of a pair
    (live_residues) is a task of flow_pairhmm_lattice_plain, and the pair's
    (B,) f32 result is A + log10 sum_s 10^(out_s - A), A = max_s out_s: the
    row scale of the dense scan is shared by the lattices and cancels, so each
    task keeps its own. -inf where no lattice is live; NaN where rlen is
    outside [0, Rp] or hlen outside [0, Hp]. Equal to
    flow_pairhmm_dense_plain up to float32 rounding."""
    ri, hi = ri.long(), hi.long()
    B = ri.numel()
    Rp, Hp = tab["rfo"].shape[1], tab["hfo"].shape[1]
    b, s = live_residues(tab, ri, hi).nonzero(as_tuple=True)
    per = torch.full((B, FLOW_SIZE), -math.inf, dtype=torch.float32, device=ri.device)
    if b.numel():
        per[b, s] = flow_pairhmm_lattice_plain(tab, ri[b], hi[b], s)
    top = per.amax(dim=1, keepdim=True)
    some = top > -math.inf
    out = torch.where(some, top + torch.log10(torch.pow(10.0, per - top).sum(1, keepdim=True)),
                      top).squeeze(1)
    R, H = tab["rlen"][ri].long(), tab["hlen"][hi].long()
    out_of_range = (R < 0) | (R > Rp) | (H < 0) | (H > Hp)
    return torch.where(out_of_range, torch.full_like(out, math.nan), out)


class _FlowEntry(_Counted):
    """`flow_pairhmm_pairs(tab, ri, hi)`: tables on a CUDA device launch the
    coset kernel (ops/_kernels.flow_pairhmm) over every pair and, where it
    flags a read or a haplotype that breaks the coset rule, the dense kernel
    (ops/_kernels.flow_pairhmm_dense) over the pairs that hold one
    (rule_broken_pairs), whose results replace the coset kernel's; reading the
    flags is the one host synchronisation of a call. Where the coset kernel's
    state would not fit shared memory (ops/_kernels.flow_pairhmm_smem of the
    tables' width Hp and columns T1 over FLOW_MAX_SMEM: Hp past 21,115 flows)
    the dense kernel alone scores every pair of the call, in one launch: for
    a pair that keeps the rule it walks the coset kernel's one lattice.
    Tables on the CPU run the plain versions on the split of the rule:
    flow_pairhmm_pairs_plain and flow_pairhmm_dense_plain. `launches` and
    `pairs` count the coset kernel's launches and the pairs they scored,
    `dense.launches` and `dense.pairs` the dense kernel's; the plain versions
    are not counted."""

    def __init__(self):
        super().__init__()
        self.dense = _Counted()

    def __call__(self, tab, ri: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
        if tab["tables"].device.type == "cpu":
            broken = rule_broken_pairs(tab, ri, hi)
            out = flow_pairhmm_pairs_plain(tab, ri, hi)
            if broken.any():
                out[broken] = flow_pairhmm_dense_plain(tab, ri[broken], hi[broken])
            return out
        from . import _kernels

        Hp, T1 = tab["hkey"].shape[1], tab["tables"].shape[2]
        if _kernels.flow_pairhmm_smem(Hp, T1) > _kernels.FLOW_MAX_SMEM:
            out = _kernels.flow_pairhmm_dense(tab, ri, hi)
            self.dense._count(ri.numel())
            return out
        out, bad = _kernels.flow_pairhmm(tab, ri, hi)
        self._count(ri.numel())
        if any(bad.tolist()):
            idx = rule_broken_pairs(tab, ri, hi).nonzero().squeeze(1)
            out[idx] = _kernels.flow_pairhmm_dense(tab, ri[idx], hi[idx])
            self.dense._count(idx.numel())
        return out


flow_pairhmm_pairs = _FlowEntry()


def compute_flow_likelihood_matrix(haps, reads, device=None) -> np.ndarray:
    """(n_reads, n_haps) float64 log10 matrix of every read with every
    haplotype on `device` (devices.resolve_device: the port's default unless
    given; raises for CUDA without a card). On a card: one launch of the
    coset kernel over the region (flow_pairhmm_pairs), and one of the dense
    kernel where a flow order breaks the coset rule; past the coset kernel's
    width, one launch of the dense kernel alone. On the CPU: gatk_tpu's
    dense scan (flow_pairhmm_dense_plain), so that the result is gatk_tpu's."""
    pairs = len(reads) * len(haps)
    if not pairs:
        return np.zeros((len(reads), len(haps)))
    dev = resolve_device(device)
    tab = pack_flow_tables(haps, reads, dev)
    nh = len(haps)
    idx = torch.arange(pairs, dtype=torch.int32, device=dev)
    ri_all, hi_all = idx // nh, idx % nh
    if dev.type != "cpu":
        out = flow_pairhmm_pairs(tab, ri_all, hi_all)
    else:
        out = flow_pairhmm_dense_plain(tab, ri_all, hi_all)
    return out.cpu().numpy().astype(np.float64).reshape(len(reads), len(haps))
