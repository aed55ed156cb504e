"""Batched banded anti-diagonal wavefront DP, score only (kernel K1).

Counterpart of ``prrn_aln_tpu/ops/pairwise.py::wavefront_scores`` (the
plain version here) and ``prrn_aln_tpu/ops/pallas_pairwise.py::
pallas_pairwise_scores`` (the dispatching wrapper ``pairwise_scores``,
whose CUDA kernel ``csrc/pairwise.cu`` replaces the Pallas row sweep).

Score-only affine-gap (Gotoh) alignment over a diagonal band, scanned
along anti-diagonals: band slot k holds diagonal r = n - m = lw - 1 + k,
and step d updates the slots whose parity matches d.  Both versions run
the same float operations in the same order, so their scores are equal.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build

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
    f32 = torch.float32
    dim = mtx.shape[0]
    flat = mtx.reshape(-1)
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
                    la, lb, mtx: torch.Tensor, u, v, tgapf=1.0,
                    exg=None, lw=None, up=None,
                    local: bool = False) -> torch.Tensor:
    """Batched banded affine-gap scores (kernel K1).

    a_batch (B, Ma) / b_batch (B, Mb) int32 codes (0-padded) and mtx
    (dim, dim) f32 on one device; la, lb, lw, up (B,) lengths and band
    diagonals (default lw=-la, up=lb: the full rectangle); u, v, tgapf
    scalars or (B,); exg (B, 4) bool.  Returns (B,) f32 scores.  CPU
    tensors take the plain version; CUDA tensors launch the kernel.
    """
    dev = a_batch.device
    B = a_batch.shape[0]
    la = _per_pair(la, B, torch.int32, dev)
    lb = _per_pair(lb, B, torch.int32, dev)
    lw = -la if lw is None else _per_pair(lw, B, torch.int32, dev)
    up = lb if up is None else _per_pair(up, B, torch.int32, dev)
    u = _per_pair(u, B, torch.float32, dev)
    v = _per_pair(v, B, torch.float32, dev)
    tgapf = _per_pair(tgapf, B, torch.float32, dev)
    if exg is None:
        exg = torch.zeros((B, 4), dtype=torch.bool, device=dev)
    exg = torch.as_tensor(exg, device=dev).bool()
    run = _plain_pairwise if dev.type == "cpu" else _launch_pairwise
    return run(a_batch, b_batch, la, lb, lw, up, mtx, u, v, tgapf, exg, local)


def _plain_pairwise(a_batch, b_batch, la, lb, lw, up, mtx, u, v, tgapf,
                    exg, local):
    """The plain version on the arguments ``_launch_pairwise`` takes."""
    return wavefront_scores_ref(a_batch, b_batch, la, lb, lw, up, mtx, u, v,
                                tgapf, exg, nslot=int((up - lw).max()) + 3,
                                nsteps=int((la + lb).max()) - 1, local=local)


def _launch_pairwise(a_batch, b_batch, la, lb, lw, up, mtx, u, v, tgapf,
                     exg, local):
    dev = a_batch.device
    if dev.type != "cuda":
        raise ValueError(f"pairwise_scores: unsupported device {dev}")
    B, Ma = a_batch.shape
    Mb = b_batch.shape[1]
    dim = mtx.shape[0]
    exg_u8 = exg.to(torch.uint8).contiguous()
    for t, name, dtype, shape in (
            (a_batch, "a_batch", torch.int32, (B, Ma)),
            (b_batch, "b_batch", torch.int32, (B, Mb)),
            (la, "la", torch.int32, (B,)), (lb, "lb", torch.int32, (B,)),
            (lw, "lw", torch.int32, (B,)), (up, "up", torch.int32, (B,)),
            (u, "u", torch.float32, (B,)), (v, "v", torch.float32, (B,)),
            (tgapf, "tgapf", torch.float32, (B,)),
            (exg_u8, "exg", torch.uint8, (B, 4)),
            (mtx, "mtx", torch.float32, (dim, dim))):
        _build.require(t, name, dtype, shape, dev)
    out = torch.empty(B, dtype=torch.float32, device=dev)
    if B == 0:
        return out
    maxw = int((up - lw).max()) + 3
    lib = _build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.pairwise_scores_launch(
        a_batch.data_ptr(), b_batch.data_ptr(), la.data_ptr(),
        lb.data_ptr(), lw.data_ptr(), up.data_ptr(), u.data_ptr(),
        v.data_ptr(), tgapf.data_ptr(), exg_u8.data_ptr(), mtx.data_ptr(),
        out.data_ptr(), B, Ma, Mb, dim, int(local), maxw, stream)
    _build.check(err, "pairwise_scores_launch")
    _build.LAUNCHES["pairwise"] += 1
    return out


def band_cells(la: np.ndarray, lb: np.ndarray, lw: np.ndarray,
               up: np.ndarray) -> int:
    """Cells inside the band over a batch (the work a GCUPS rate counts)."""
    total = 0
    for a, b, lo, hi in zip(la, lb, lw, up):
        m = np.arange(int(a))
        lo_n = np.maximum(m + int(lo), 0)
        hi_n = np.minimum(m + int(hi), int(b) - 1)
        total += int(np.maximum(hi_n - lo_n + 1, 0).sum())
    return total
