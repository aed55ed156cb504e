"""Batched banded pairwise DP, score only (kernels K1 and K1f).

Counterpart of ``prrn_aln_tpu/ops/pairwise.py::wavefront_scores`` (the
plain version ``wavefront_scores_ref``) and of ``prrn_aln_tpu/ops/
pallas_pairwise.py::pallas_pairwise_scores`` (the dispatching wrapper
``pairwise_scores``).

Two routes compute the same score-only affine-gap (Gotoh) alignment
over a diagonal band:

* K1, the default (``csrc/pairwise.cu``): scanned along anti-diagonals;
  band slot k holds diagonal r = n - m = lw - 1 + k, and step d updates
  the slots whose parity matches d.
* K1f, chosen by ``PRRN_PW_FUSED=1`` for matrices of at most 32 codes
  and global scores (``csrc/pairwise_rows.cu``): the row sweep of
  ``pallas_pairwise.py::_kernel_rows_fused``.  Lane j of row m holds
  column n = m + lw0 + j; the horizontal gap is solved a row at a time
  as a running maximum, ``E = cummax_j(C + j*u) - j*u`` with
  ``C(j) = X(j-1) - v - u``.  Its plain version is ``row_scores_ref``.

Within a route the kernel and its plain version run the same float
operations, so their scores are equal bit for bit; between the routes
the running maximum reassociates the ``- u`` steps, so scores may
differ by a few f32 ulp.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import precision as P

NEG_SENT = -(2 ** 31 // 8) * 7.0    # reference NEG_INT
NEVSEL = -1.0e30


def wavefront_scores_ref(a_batch, b_batch, la, lb, lw, up, mtx, u, v, tgapf,
                         exg, *, nslot: int, nsteps: int,
                         local: bool = False) -> torch.Tensor:
    """Plain PyTorch wavefront scorer; returns (B,) f32 scores.

    a_batch (B, Ma) / b_batch (B, Mb) integer codes (0-padded); la, lb,
    lw, up (B,) integer lengths and band diagonals; mtx (dim, dim) f32;
    u, v, tgapf (B,) f32; exg (B, 4) bool free end gaps (a-left,
    a-right, b-left, b-right); ``local`` selects SWG local scores.
    """
    dev = a_batch.device
    f32 = P.F32
    dim = mtx.shape[0]
    flat = mtx.reshape(-1).to(f32)
    a_batch = a_batch.long()
    b_batch = b_batch.long()
    la, lb, lw, up = (x.long()[:, None] for x in (la, lb, lw, up))
    u, v, tgapf = (x.to(f32)[:, None] for x in (u, v, tgapf))
    exg = exg.bool()
    B = a_batch.shape[0]

    r_all = lw - 1 + torch.arange(nslot, device=dev)[None, :]     # (B, R)
    rf = r_all.to(f32)
    in_band = (r_all >= lw - 1) & (r_all <= up + 1)
    hh = torch.zeros((B, nslot), dtype=f32, device=dev)
    pen_pos = -(v + rf * u) * tgapf
    pen_neg = -(v - rf * u) * tgapf
    hh = torch.where((r_all > 0) & ~exg[:, 0:1], pen_pos, hh)
    hh = torch.where((r_all < 0) & ~exg[:, 2:3], pen_neg, hh)
    hh = torch.where((r_all == lw - 1) | (r_all == up + 1), NEG_SENT, hh)
    hh = torch.where(~in_band, NEG_SENT, hh)
    ff = torch.full((B, nslot), NEVSEL, dtype=f32, device=dev)
    gg = torch.full((B, nslot), NEVSEL, dtype=f32, device=dev)
    maxh = torch.full((B,), NEVSEL, dtype=f32, device=dev)
    neg_col = torch.full((B, 1), NEG_SENT, dtype=f32, device=dev)
    nev_col = torch.full((B, 1), NEVSEL, dtype=f32, device=dev)

    for d in range(nsteps):
        m_vec = (d - r_all) >> 1
        n_vec = d - m_vec
        valid = (((d - r_all) % 2 == 0)
                 & (m_vec >= 0) & (m_vec < la)
                 & (n_vec >= 0) & (n_vec < lb)
                 & (r_all >= lw) & (r_all <= up))
        mc = m_vec.clamp(0, a_batch.shape[1] - 1)
        nc = n_vec.clamp(0, b_batch.shape[1] - 1)
        s = flat[a_batch.gather(1, mc) * dim + b_batch.gather(1, nc)]

        h_lo = torch.cat([neg_col, hh[:, :-1]], 1)
        f_lo = torch.cat([nev_col, ff[:, :-1]], 1)
        h_hi = torch.cat([hh[:, 1:], neg_col], 1)
        g_hi = torch.cat([gg[:, 1:], nev_col], 1)

        f_new = torch.maximum(h_lo - v, f_lo) - u
        g_new = torch.maximum(h_hi - v, g_hi) - u
        h_new = torch.maximum(torch.maximum(hh + s, f_new), g_new)
        if local:
            h_new = h_new.clamp_min(0.0)
            maxh = torch.maximum(
                maxh, torch.where(valid, h_new, NEVSEL).amax(1))

        hh = torch.where(valid, h_new, hh)
        ff = torch.where(valid, f_new, ff)
        gg = torch.where(valid, g_new, gg)

    if local:
        return maxh

    # closed-form last row / last column maxima with terminal-gap factors
    r_end = lb - la
    best = torch.where(r_all == r_end, hh, NEVSEL).amax(1)
    f_b = torch.where(exg[:, 3:4], 0.0, tgapf)
    sel_b = (r_all > r_end) & (r_all <= torch.minimum(up + 1, lb))
    cand_b = hh - f_b * (v + (r_all - r_end).to(f32) * u)
    best_b = torch.where(sel_b, cand_b, NEVSEL).amax(1)
    best = torch.where(f_b[:, 0] < 1.0, torch.maximum(best, best_b), best)
    f_a = torch.where(exg[:, 1:2], 0.0, tgapf)
    sel_a = (r_all < r_end) & (r_all >= torch.maximum(lw - 1, -la + 1))
    cand_a = hh - f_a * (v + (r_end - r_all).to(f32) * u)
    best_a = torch.where(sel_a, cand_a, NEVSEL).amax(1)
    best = torch.where(f_a[:, 0] < 1.0, torch.maximum(best, best_a), best)
    return best


def _per_pair(x, B: int, dtype, device) -> torch.Tensor:
    t = torch.as_tensor(x, dtype=dtype, device=device)
    return t.expand(B).contiguous() if t.dim() == 0 else t


def pairwise_scores(a_batch: torch.Tensor, b_batch: torch.Tensor,
                    la, lb, mtx: torch.Tensor, u, v, lw, up) -> torch.Tensor:
    """Batched banded affine-gap scores of K1's plain version.

    a_batch (B, Ma) / b_batch (B, Mb) int32 codes (0-padded), mtx (dim,
    dim) f32; la, lb, lw, up (B,) lengths and band diagonals; u, v
    scalars.  Returns (B,) scores."""
    dev = a_batch.device
    B = a_batch.shape[0]
    la, lb, lw, up = (_per_pair(x, B, torch.int32, dev)
                      for x in (la, lb, lw, up))
    u = _per_pair(u, B, torch.float32, dev)
    v = _per_pair(v, B, torch.float32, dev)
    tgapf = _per_pair(1.0, B, torch.float32, dev)
    exg = torch.zeros((B, 4), dtype=torch.bool, device=dev)
    return wavefront_scores_ref(a_batch, b_batch, la, lb, lw, up, mtx, u, v,
                                tgapf, exg, nslot=int((up - lw).max()) + 3,
                                nsteps=int((la + lb).max()) - 1)
