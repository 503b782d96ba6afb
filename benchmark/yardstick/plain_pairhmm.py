"""The plain PairHMM: log10 P(read | haplotype) for a batch of pairs.

Frozen copy of the recurrence of gatk_tpu_torch/ops/pairhmm_host.py with the
model of gatk_tpu_torch/ops/pairhmm_model.py (GATK's LoglessPairHMM,
LoglessPairHMM.java:48-70; priors :86-97), as of the port's first benchmark,
taken over a batch of pairs by anti-diagonals in plain PyTorch. Row i of a
pair uses the transitions of read position i - 1; row 0 holds the free start
deletions, D[0][j] = INITIAL / hapLen for j = 0..hapLen; the result is the sum
of M + I over the last row's columns 1..hapLen. An N on either side matches.
One departure: matchToMatch is 1 - min(1, 10^(-i/10) + 10^(-d/10)) exactly,
where GATK reads it from its Jacobian table (a difference far below 1e-6 in
log10 at the qualities the program feeds). It imports nothing of the program.

`dtype` float64 is the reference; a lower precision (bfloat16) is the
control, the same arithmetic one precision below the float32 that the
program's kernels state.
"""
from __future__ import annotations

import math

import torch

N_BASE = ord("N")
TRISTATE = 3.0


def _initial_log2(dtype):
    return 1020 if dtype == torch.float64 else 100


def log10_likelihoods(rb, rq, iq, dq, gcp, rlen, hb, hlen, dtype=torch.float64):
    """rb, rq, iq, dq, gcp: (P, R) uint8 read bases and phred qualities (base,
    insertion, deletion, gap continuation); rlen (P,); hb (P, H) uint8
    haplotype bases; hlen (P,). Returns (P,) float64 log10 likelihoods, -inf
    where the sum underflows. Runs on the device of the inputs."""
    P, R = rb.shape
    dev = rb.device
    if P == 0:
        return torch.empty(0, dtype=torch.float64, device=dev)
    f64 = torch.float64

    def prob(q):  # 10^(-q/10)
        return torch.pow(10.0, -q.to(f64) / 10.0)

    e_base, e_ins, e_del, e_gcp = prob(rq), prob(iq), prob(dq), prob(gcp)
    cast = lambda t: t.to(dtype)  # noqa: E731
    mm = cast(1.0 - torch.clamp(e_ins + e_del, max=1.0))
    gm = cast(1.0 - e_gcp)
    mi, ii, md, dd = cast(e_ins), cast(e_gcp), cast(e_del), cast(e_gcp)
    p_match, p_mis = cast(1.0 - e_base), cast(e_base / TRISTATE)
    rlen = rlen.to(torch.int64)
    hlen = hlen.to(torch.int64)
    H = int(hlen.max().item())
    hb = hb[:, :H].to(torch.int64) if H else hb.to(torch.int64)
    rb = rb.to(torch.int64)
    init = torch.pow(torch.tensor(2.0, dtype=f64, device=dev),
                     _initial_log2(dtype)) / hlen.clamp(min=1).to(f64)
    init = cast(init)

    i_rows = torch.arange(1, R + 1, device=dev)  # read rows 1..R
    row_ok = i_rows[None, :] <= rlen[:, None]  # (P, R)
    zero = torch.zeros((), dtype=dtype, device=dev)
    zeros = torch.zeros((P, R + 1), dtype=dtype, device=dev)
    m1, x1, y1 = zeros, zeros, zeros  # diagonal d - 1
    m2, x2, y2 = zeros, zeros, zeros  # diagonal d - 2
    # diagonal 0 is cell (0, 0): D = init; diagonal d's row 0 is D[0][d]
    y1 = y1.clone()
    y1[:, 0] = init
    acc = torch.zeros(P, dtype=dtype, device=dev)
    last = rlen.clamp(min=0)
    n_diag = int(rlen.max().item()) + H
    for d in range(1, n_diag + 1):
        j = d - i_rows  # (R,) column of row i on this diagonal
        col_ok = (j >= 1)[None, :] & (j[None, :] <= hlen[:, None]) & row_ok
        hidx = (j - 1).clamp(min=0, max=max(H - 1, 0))
        hbase = hb[:, hidx] if H else torch.zeros_like(rb)
        match = (rb == hbase) | (rb == N_BASE) | (hbase == N_BASE)
        prior = torch.where(match, p_match, p_mis)
        m_new = prior * (mm * m2[:, :-1] + gm * (x2[:, :-1] + y2[:, :-1]))
        x_new = mi * m1[:, :-1] + ii * x1[:, :-1]
        y_new = md * m1[:, 1:] + dd * y1[:, 1:]
        m_new = torch.where(col_ok, m_new, zero)
        x_new = torch.where(col_ok, x_new, zero)
        y_new = torch.where(col_ok, y_new, zero)
        row0 = torch.where(d <= hlen, init, zero)[:, None]
        m_d = torch.cat([torch.zeros_like(row0), m_new], dim=1)
        x_d = torch.cat([torch.zeros_like(row0), x_new], dim=1)
        y_d = torch.cat([row0, y_new], dim=1)
        # the last row's cell on this diagonal: (rlen, d - rlen)
        jl = d - last
        take = (jl >= 1) & (jl <= hlen) & (last >= 1)
        cell = (m_d.gather(1, last[:, None]) + x_d.gather(1, last[:, None]))[:, 0]
        acc = acc + torch.where(take, cell, zero)
        m2, x2, y2 = m1, x1, y1
        m1, x1, y1 = m_d, x_d, y_d
    return torch.log10(acc.to(f64)) - _initial_log2(dtype) * math.log10(2.0)


def in_blocks(pairs, dtype=torch.float64, block=2048, device=None):
    """log10_likelihoods over a dict of stacked pair tensors, `block` pairs at
    a time, so that the state fits; returns a (P,) float64 CPU tensor."""
    keys = ("rb", "rq", "iq", "dq", "gcp", "rlen", "hb", "hlen")
    P = pairs["rb"].shape[0]
    out = []
    for k in range(0, P, block):
        part = [pairs[key][k : k + block] for key in keys]
        if device is not None:
            part = [t.to(device) for t in part]
        out.append(log10_likelihoods(*part, dtype=dtype).cpu())
    return torch.cat(out) if out else torch.empty(0, dtype=torch.float64)
