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

import ctypes
import os

import numpy as np
import torch

from ..utils import trace
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


def row_scores_ref(a_batch, b_batch, la, lb, lw, up, mtx, u, v, tgapf,
                   exg, *, lw0: int, nlane: int, nrow: int) -> torch.Tensor:
    """Plain PyTorch row sweep; returns (B,) f32 global scores.

    A transcription of ``_kernel_rows_fused``'s row loop: arguments as
    ``wavefront_scores_ref``; ``lw0`` is the packing offset (lane j of
    row m is column m + lw0 + j), ``nlane`` the lanes swept (at least
    ``up.max() - lw0 + 1``) and ``nrow`` the rows (at least
    ``la.max()``).  ``j*u`` is rounded in f32, so the last bits of a
    score can depend on ``lw0``.  Columns outside ``b_batch`` score 0,
    as the TPU kernel's out-of-range code does.
    """
    dev = a_batch.device
    f32 = torch.float32
    dim = mtx.shape[0]
    Mb = b_batch.shape[1]
    flat = mtx.to(f32).reshape(-1)
    a_batch = a_batch.long()
    b_batch = b_batch.long()
    la, lb, lw, up = (x.to(f32)[:, None] for x in (la, lb, lw, up))
    u, v, tgapf = (x.to(f32)[:, None] for x in (u, v, tgapf))
    exg = exg.bool()
    fa_l, fa_r, fb_l, fb_r = (torch.where(exg[:, k:k + 1], 0.0, tgapf)
                              for k in range(4))
    B = a_batch.shape[0]

    lane = torch.arange(nlane, device=dev)
    j = lane.to(f32)[None, :]
    ju = j * u
    jband = (lw0 + j >= lw) & (lw0 + j <= up)
    neg_col = torch.full((B, 1), NEG_SENT, dtype=f32, device=dev)
    nev_col = torch.full((B, 1), NEVSEL, dtype=f32, device=dev)
    nev = torch.full((B, nlane), NEVSEL, dtype=f32, device=dev)

    # virtual boundary row m = -1: lane j holds n = -1 + lw0 + j
    nv = lw0 - 1.0 + j
    slot_ok = (nv + 1.0 >= lw) & (nv + 1.0 <= up)
    H = torch.where(nv == -1.0, 0.0,
                    torch.where((nv >= 0.0) & slot_ok,
                                -(v + (nv + 1.0) * u) * fa_l, NEG_SENT))
    Gv, LR, BC = nev, nev, nev

    for m in range(nrow):
        mf = float(m)
        n_idx = m + lw0 + lane
        inside = ((n_idx >= 0) & (n_idx < Mb))[None, :]
        codes = b_batch[:, n_idx.clamp(0, Mb - 1)]
        s_row = torch.where(inside, flat[a_batch[:, m:m + 1] * dim + codes],
                            0.0)
        n_vec = mf + lw0 + j
        colb = -(v + (mf + 1.0) * u) * fb_l        # H(m, -1)
        colb_ok = mf < -lw

        Hs = torch.cat([H[:, 1:], neg_col], 1)
        Gs = torch.cat([Gv[:, 1:], nev_col], 1)
        G0 = torch.maximum(Hs - v, Gs) - u
        X = torch.maximum(H + s_row, G0)
        X = torch.where(mf < la, X, NEG_SENT)
        valid = (n_vec >= 0.0) & (n_vec < lb) & jband
        virt = (n_vec == -1.0) & colb_ok

        C = (torch.cat([neg_col, X[:, :-1]], 1) - v) - u
        C = torch.where((n_vec == 0.0) & colb_ok, (colb - v) - u, C)
        E = torch.cummax(C + ju, dim=1).values - ju
        H0 = torch.maximum(X, E)
        H0 = torch.where(valid, H0, torch.where(virt, colb, NEG_SENT))

        LR = torch.where(mf == la - 1.0, H0, LR)
        kb = la - 1.0 - mf
        cand = torch.where((n_vec == lb - 1.0) & (kb > 0.0),
                           H0 - (v + kb * u) * fb_r, NEVSEL)
        BC = torch.maximum(BC, cand)
        H, Gv = H0, G0

    n_last = (la - 1.0) + lw0 + j
    corner = torch.where(n_last == lb - 1.0, LR, NEVSEL).amax(1)
    kfb = lb - 1.0 - n_last
    best_row = torch.where((kfb > 0.0) & (n_last >= 0.0),
                           LR - (v + kfb * u) * fa_r, NEVSEL).amax(1)
    best_col = BC.amax(1)
    score = corner
    score = torch.where(fa_r[:, 0] < 1.0, torch.maximum(score, best_row),
                        score)
    score = torch.where(fb_r[:, 0] < 1.0, torch.maximum(score, best_col),
                        score)
    return score


def _per_pair(x, B: int, dtype, device) -> torch.Tensor:
    t = torch.as_tensor(x, dtype=dtype, device=device)
    if not (isinstance(x, torch.Tensor) and x.device == t.device):
        trace.h2d(t)
    return t.expand(B).contiguous() if t.dim() == 0 else t


def _band_range(lw_in, up_in, la_in, lb_in, lw, up) -> tuple[int, int]:
    """The batch's smallest ``lw`` and largest ``up``: from the host values
    the caller gave (``lw_in``/``up_in`` None: ``-la``/``lb``), else in one
    device read of the packed ``lw`` and ``up``."""
    if lw.numel() == 0:
        return 0, 0
    raw = (la_in if lw_in is None else lw_in, lb_in if up_in is None else up_in)
    if any(isinstance(x, torch.Tensor) and x.device.type != "cpu"
           for x in raw):
        lo, hi = torch.stack([lw.min(), up.max()]).tolist()
        return int(lo), int(hi)
    lo_x, hi_x = (np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)
                  for x in raw)
    lo = -int(lo_x.max()) if lw_in is None else int(lo_x.min())
    return lo, int(hi_x.max())


def pairwise_scores(a_batch: torch.Tensor, b_batch: torch.Tensor,
                    la, lb, mtx: torch.Tensor, u, v, tgapf=1.0,
                    exg=None, lw=None, up=None,
                    local: bool = False, lossy: bool = False,
                    lw0: int | None = None,
                    fused: bool | None = None) -> torch.Tensor:
    """Batched banded affine-gap scores (kernel K1, or K1f).

    a_batch (B, Ma) / b_batch (B, Mb) int32 codes (0-padded) and mtx
    (dim, dim) f32 on one device; la, lb, lw, up (B,) lengths and band
    diagonals (default lw=-la, up=lb: the full rectangle); u, v, tgapf
    scalars or (B,); exg (B, 4) bool.  Returns (B,) f32 scores.  CPU
    tensors take the plain version; CUDA tensors launch the kernel.

    ``PRRN_PW_FUSED=1`` in the environment, read at the call as the JAX
    wrapper reads it, sends global scores over a matrix of at most 32
    codes to the row sweep (K1f) with the packing offset ``lw0``
    (default: the batch's smallest ``lw``, as in the JAX wrapper).
    ``lossy`` is the opt-in bf16 edge screen: the matrix is rounded to
    bf16 before K1's lookup; the row sweep ignores it, as the JAX
    wrapper's fused route does.  ``fused=False`` keeps K1 whatever the
    switch says, for callers whose JAX counterpart calls the scan scorer
    directly (``msa/shuffle``).
    """
    dev = a_batch.device
    B = a_batch.shape[0]
    lw_in, up_in, la_in, lb_in = lw, up, la, lb
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
    if fused is None:
        fused = os.environ.get("PRRN_PW_FUSED", "0") == "1"
    fused = fused and mtx.shape[0] <= 32 and not local
    if fused:
        lo, hi = _band_range(lw_in, up_in, la_in, lb_in, lw, up)
        if lw0 is None:
            lw0 = lo
        nlane = hi - lw0 + 1
        if lo < lw0 or nlane < 1:
            raise ValueError(f"pairwise_scores: lw0={lw0} does not cover the "
                             f"batch's bands")
        run = _plain_rows if dev.type == "cpu" else _launch_rows
        return run(a_batch, b_batch, la, lb, lw, up, mtx, u, v, tgapf, exg,
                   lw0, nlane)
    if lossy:
        mtx = mtx.to(torch.bfloat16).to(torch.float32)
    run = _plain_pairwise if dev.type == "cpu" else _launch_pairwise
    return run(a_batch, b_batch, la, lb, lw, up, mtx, u, v, tgapf, exg, local)


def _plain_pairwise(a_batch, b_batch, la, lb, lw, up, mtx, u, v, tgapf,
                    exg, local):
    """The plain version on the arguments ``_launch_pairwise`` takes."""
    return wavefront_scores_ref(a_batch, b_batch, la, lb, lw, up, mtx, u, v,
                                tgapf, exg, nslot=int((up - lw).max()) + 3,
                                nsteps=int((la + lb).max()) - 1, local=local)


def _plain_rows(a_batch, b_batch, la, lb, lw, up, mtx, u, v, tgapf, exg,
                lw0, nlane):
    """The plain version on the arguments ``_launch_rows`` takes."""
    return row_scores_ref(a_batch, b_batch, la, lb, lw, up, mtx, u, v, tgapf,
                          exg, lw0=lw0, nlane=nlane, nrow=int(la.max()))


def _checked_inputs(a_batch, b_batch, la, lb, lw, up, mtx, u, v, tgapf, exg):
    """Raise unless the tensors are what K1 and K1f take; returns the
    free-end-gap flags as bytes."""
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
    return exg_u8


def _launch_rows(a_batch, b_batch, la, lb, lw, up, mtx, u, v, tgapf, exg,
                 lw0, nlane, plan=None):
    """K1f on CUDA tensors: ``nlane`` lanes from the packing offset
    ``lw0``, which the caller checked to cover every pair's band
    (``pairwise_scores`` does, from host values or in one read); a pair
    outside them scores NaN.  Reads nothing back from the device."""
    exg_u8 = _checked_inputs(a_batch, b_batch, la, lb, lw, up, mtx, u, v,
                             tgapf, exg)
    dev = a_batch.device
    B, Ma = a_batch.shape
    Mb = b_batch.shape[1]
    dim = mtx.shape[0]
    out = torch.empty(B, dtype=torch.float32, device=dev)
    if B == 0:
        return out
    if plan is None:
        plan = rows_plan(nlane, B, dim, Ma, Mb)
    # the block variant's row and codes in device memory
    state = (torch.empty(B * rows_state_bytes(nlane, Ma, Mb),
                         dtype=torch.uint8, device=dev)
             if plan["state"] == "device" else None)
    lib = _build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.pairwise_rows_launch(
        a_batch.data_ptr(), b_batch.data_ptr(), la.data_ptr(),
        lb.data_ptr(), lw.data_ptr(), up.data_ptr(), u.data_ptr(),
        v.data_ptr(), tgapf.data_ptr(), exg_u8.data_ptr(), mtx.data_ptr(),
        out.data_ptr(), None if state is None else state.data_ptr(), B, Ma,
        Mb, dim, lw0, nlane,
        _K1F_VARIANTS[plan["variant"]], plan["lanes"], plan["threads"],
        plan["code_stride"], plan["smem_bytes"], plan["ctas"], stream)
    _build.check(err, "pairwise_rows_launch")
    _build.LAUNCHES["pairwise_rows"] += 1
    return out


# K1f's launch plans (rows_plan): lanes a thread the "warp" and "warps"
# variants are built for (the "cluster" variant takes the "warps" ones),
# the fewest lanes a thread the "warps" variant takes by default when the
# batch fills the card and the "cluster" variant always, their most warps
# a CTA, the most pairs a block of the "warp" variant (a power of two),
# the most CTAs of a cluster, and the card's SMs: a batch of fewer pairs
# spreads each pair over warps
K1F_WARP_LANES = (2, 4, 8, 12, 16, 20, 24, 28, 32)
K1F_WARPS_LANES = (4, 8, 12, 16)
K1F_WARPS_MIN_LANES = 8
K1F_MAX_WARPS = 16
K1F_WARP_PAIRS = 4
K1F_MAX_CTAS = 16
K1F_SMS = 132
_K1F_VARIANTS = {"block": 0, "warp": 1, "warps": 2, "cluster": 3}
# the cluster variant's words after the warps' slots: the slots the other
# CTAs push into, [2][20], and the CTAs' end maxima, [3][16]
_K1F_CLUSTER_WORDS = 40 + 48


def rows_cta_lanes() -> int:
    """The widest band one CTA of the "warps" variant holds."""
    return 32 * K1F_WARPS_LANES[-1] * K1F_MAX_WARPS


def rows_cluster_lanes() -> int:
    """The widest band one cluster of the "cluster" variant holds."""
    return K1F_MAX_CTAS * rows_cta_lanes()


def _rows_cluster_ctas(nlane: int, B: int) -> int:
    """The "cluster" variant's CTAs a pair by default: the fewest that hold
    the band, or more where the batch leaves SMs idle (the most, a power
    of two up to ``K1F_MAX_CTAS``, that keep the batch within two CTAs an
    SM; they pack the card's GPCs), as K1's cluster variant spreads."""
    fewest = -(-nlane // rows_cta_lanes())
    spread = K1F_MAX_CTAS
    while spread > 2 and B * spread > 2 * K1F_SMS:
        spread //= 2
    return max(fewest, spread)


def rows_plan(nlane: int, B: int, dim: int, Ma: int, Mb: int, *,
              variant: str | None = None, lanes: int | None = None,
              warps: int | None = None, pairs: int | None = None,
              ctas: int | None = None, state: str | None = None) -> dict:
    """K1f's variant for a batch of ``B`` pairs swept over ``nlane`` lanes.

    "warp": one warp a pair, ``pairs`` pairs a block (by default the
    largest power of two up to ``K1F_WARP_PAIRS`` that leaves a block for
    every SM), ``lanes`` lanes a thread in registers (32 * lanes >=
    nlane); "warps": ``warps`` warps a pair, one pair a block (32 * lanes
    * warps >= nlane); "cluster": ``ctas`` CTAs of ``warps`` warps a pair,
    CTA r on the r-th slice of 32 * lanes * warps lanes (32 * lanes *
    warps * ctas >= nlane); "block": one block of up to 1,024 threads a
    pair, the row and the codes in shared memory (``state`` "shared", the
    first design) or in device memory ("device", with the matrix in shared
    memory where it fits), so every band has a plan.  By default a batch
    of at least ``K1F_SMS`` pairs takes "warp" up to 32 * 32 lanes, and a
    smaller batch "warps" of 4 lanes a thread from 129 lanes on (each pair
    has an SM to itself, so its row's latency sets the pace); past that
    "warps" (at least ``K1F_WARPS_MIN_LANES`` lanes a thread for a full
    batch) up to ``rows_cta_lanes()`` lanes, "cluster" up to
    ``rows_cluster_lanes()`` (``_rows_cluster_ctas`` CTAs, each of the
    fewest warps that hold its slice at ``K1F_WARPS_MIN_LANES`` lanes a
    thread or more: fewer, wider warps shorten the row's fold over a
    CTA's warps, the chain that a cluster row waits on besides its
    barrier), "block" the rest, its row in device memory where shared
    memory does not hold it.  The register variants hold the codes as
    bytes in shared memory (``code_stride`` bytes a pair) beside the matrix
    and its zero column, so they need ``dim`` <= 255.  Every plan reports
    its CTAs a pair (``ctas``).  A plan the kernels cannot take raises.
    """
    if nlane < 1 or B < 0 or dim < 1:
        raise ValueError(f"rows_plan: {nlane} lanes, {B} pairs, dim {dim}")
    stride = -(-(Ma + Mb) // 16) * 16
    mtx_bytes = 4 * dim * (dim + 1)

    def smallest(choices, need):
        return next((n for n in choices if n >= need), None)

    def reg_smem(nwarps, npairs, cluster=False):
        return (mtx_bytes + 52 * nwarps + npairs * stride
                + (4 * _K1F_CLUSTER_WORDS if cluster else 0))

    spread = B < K1F_SMS and nlane > 32 * K1F_WARPS_LANES[0]
    if variant is None:
        if dim > 255 or reg_smem(1, 1) > SMEM_MAX:
            variant = "block"
        elif nlane <= 32 * K1F_WARP_LANES[-1] and not spread:
            variant = "warp"
        elif nlane <= rows_cta_lanes():
            variant = "warps"
        elif (nlane <= rows_cluster_lanes()
              and reg_smem(K1F_MAX_WARPS, 1, True) <= SMEM_MAX):
            variant = "cluster"
        else:
            variant = "block"
    if variant != "block" and state is not None:
        raise ValueError(f"rows_plan: the {variant} variant keeps its row "
                         f"in registers")
    if variant != "cluster" and ctas is not None:
        raise ValueError(f"rows_plan: the {variant} variant has no cluster")
    if variant == "block":
        if lanes is not None or warps is not None or pairs is not None:
            raise ValueError("rows_plan: the block variant takes no lanes, "
                             "warps or pairs")
        if dim > 256:
            raise ValueError(f"rows_plan: a {dim}-letter matrix")
        L = -(-nlane // 1024)
        smem = 4 * (dim * dim + 5 * nlane + 32) + Ma + Mb
        if state is None:
            state = "shared" if smem <= SMEM_MAX else "device"
        if state == "shared" and smem > SMEM_MAX:
            raise ValueError(f"rows_plan: a row of {nlane} lanes does not "
                             f"fit in shared memory")
        if state == "device":
            smem = 4 * (dim * dim + 32)
            if smem > SMEM_MAX:
                smem = 4 * 32
        elif state != "shared":
            raise ValueError(f"rows_plan: unknown state {state!r}")
        return {"variant": "block", "lanes": L, "warps": 0,
                "pairs_per_block": 1, "ctas": 1,
                "threads": (-(-nlane // L) + 31) // 32 * 32,
                "code_stride": 0, "smem_bytes": smem, "state": state}
    if variant not in ("warp", "warps", "cluster"):
        raise ValueError(f"rows_plan: unknown variant {variant!r}")
    if dim > 255:
        raise ValueError(f"rows_plan: codes of a {dim}-letter matrix and "
                         f"its zero column are not bytes")
    if variant == "warp":
        if warps not in (None, 1):
            raise ValueError("rows_plan: the warp variant has one warp a "
                             "pair")
        warps = 1
        if lanes is None:
            lanes = smallest(K1F_WARP_LANES, -(-nlane // 32))
        if lanes not in K1F_WARP_LANES:
            raise ValueError(f"rows_plan: {lanes} lanes a thread is not one "
                             f"of {K1F_WARP_LANES}")
        if pairs is None:
            pairs = K1F_WARP_PAIRS
            while pairs > 1 and (B < pairs * K1F_SMS
                                 or reg_smem(pairs, pairs) > SMEM_MAX):
                pairs //= 2
        if not 1 <= pairs <= K1F_WARP_PAIRS:
            raise ValueError(f"rows_plan: {pairs} pairs a block")
        nwarps = pairs
        ctas = 1
    else:
        if pairs not in (None, 1):
            raise ValueError(f"rows_plan: the {variant} variant has one "
                             f"pair a block")
        pairs = 1
        if variant == "warps":
            ctas = 1
        else:
            if ctas is None:
                ctas = _rows_cluster_ctas(nlane, B)
            if not 2 <= ctas <= K1F_MAX_CTAS:
                raise ValueError(f"rows_plan: {ctas} CTAs a cluster")
        # the lanes each CTA sweeps
        per_cta = -(-nlane // ctas)
        if lanes is None:
            need = -(-per_cta // (32 * (warps or K1F_MAX_WARPS)))
            least = (K1F_WARPS_LANES[0] if spread and variant == "warps"
                     else K1F_WARPS_MIN_LANES)
            lanes = smallest(K1F_WARPS_LANES,
                             need if warps else max(least, need))
            if lanes is None:
                raise ValueError(f"rows_plan: {ctas} CTAs do not hold "
                                 f"{nlane} lanes")
        if lanes not in K1F_WARPS_LANES:
            raise ValueError(f"rows_plan: {lanes} lanes a thread is not one "
                             f"of {K1F_WARPS_LANES}")
        if warps is None:
            warps = -(-per_cta // (32 * lanes))
        if not 1 <= warps <= K1F_MAX_WARPS:
            raise ValueError(f"rows_plan: {warps} warps a pair")
        nwarps = warps
    if 32 * lanes * warps * ctas < nlane:
        raise ValueError(f"rows_plan: {ctas} CTAs of {warps} warps of "
                         f"{lanes} lanes a thread do not hold {nlane} lanes")
    smem = reg_smem(nwarps, pairs, variant == "cluster")
    if smem > SMEM_MAX:
        raise ValueError(f"rows_plan: codes of {Ma} + {Mb} do not fit in "
                         f"shared memory")
    return {"variant": variant, "lanes": lanes, "warps": warps,
            "pairs_per_block": pairs, "ctas": ctas, "threads": 32 * nwarps,
            "code_stride": stride, "smem_bytes": smem, "state": "registers"}


def rows_state_bytes(nlane: int, Ma: int, Mb: int) -> int:
    """Bytes of a pair's row (five arrays of ``nlane`` f32) and codes in
    the device-memory block variant of K1f, 16-byte aligned."""
    return -(-(20 * nlane + Ma + Mb) // 16) * 16


def rows_attrs(plan: dict) -> dict:
    """Registers a thread and local (spilled) bytes of the kernel a K1f
    plan launches, as the card's loader reports them."""
    out = (ctypes.c_int * 2)()
    code = (4 if plan.get("state") == "device"
            else _K1F_VARIANTS[plan["variant"]])
    _build.check(_build.load().pairwise_rows_attrs(
        code, plan["lanes"], ctypes.addressof(out)), "pairwise_rows_attrs")
    return {"registers": out[0], "local_bytes": out[1]}


# K1's launch plans (pairwise_plan): slot pairs a lane the register-state
# variants are built for, pairs a block of the "warp" variant, the widest
# band the "warp" variant takes by default, slot pairs a lane the "warps"
# and "cluster" variants start from, their most warps a CTA, the most
# CTAs of a cluster, the ghost slots a side a cluster CTA aims at (and so
# the steps between its exchanges), the card's SMs and the block
# variant's threads
K1_LANES = (1, 2, 3, 4, 5, 6, 8, 10)
K1_WARP_PAIRS = 4
K1_WARP_MAX = 256
K1_WARPS_LANES = 2
K1_MAX_WARPS = 16
K1_MAX_CTAS = 16
K1_GHOST = 16
K1_SMS = 132
SMEM_MAX = 232448
K1_BLOCK_THREADS = 256


def _ghost_lanes(lanes: int) -> int:
    """Whole lanes a side that give a cluster CTA ``K1_GHOST`` ghost
    slots or more."""
    return -(-K1_GHOST // (2 * lanes))


def cluster_owned(lanes: int, warps: int, ghost: int) -> int:
    """Slots a cluster CTA owns: its window of 64 * lanes * warps slots
    less ``ghost`` lanes (2 * lanes slots each) a side."""
    return 2 * lanes * (32 * warps - 2 * ghost)


def cluster_max_slots() -> int:
    """The widest band one cluster of the default shape holds."""
    L = K1_LANES[-1]
    return K1_MAX_CTAS * cluster_owned(L, K1_MAX_WARPS, _ghost_lanes(L))


def _cluster_plan(maxw, B, mtx_bytes, stride, lanes, warps, ctas, ghost,
                  every) -> dict:
    """The "cluster" variant's plan (``pairwise_plan``'s arguments)."""
    def owned(L, W=K1_MAX_WARPS):
        return cluster_owned(L, W, _ghost_lanes(L) if ghost is None
                             else ghost)

    if ctas is None:
        fewest = -(-maxw // owned(K1_LANES[-1]))
        # a batch that leaves SMs idle spreads each pair wider: clusters
        # of a power of two CTAs (they pack the card's GPCs), at most two
        # CTAs an SM over the batch
        spread = K1_MAX_CTAS
        while spread > 2 and B * spread > 2 * K1_SMS:
            spread //= 2
        ctas = max(fewest, spread)
    if not 2 <= ctas <= K1_MAX_CTAS:
        raise ValueError(f"pairwise_plan: {ctas} CTAs a cluster")
    if lanes is None:
        lanes = next((n for n in K1_LANES if n >= K1_WARPS_LANES
                      and ctas * owned(n) >= maxw), None)
        if lanes is None:
            raise ValueError(f"pairwise_plan: a band of {maxw} slots does "
                             f"not fit in {ctas} CTAs")
    if lanes not in K1_LANES:
        raise ValueError(f"pairwise_plan: {lanes} slot pairs a lane is not "
                         f"one of {K1_LANES}")
    if ghost is None:
        ghost = _ghost_lanes(lanes)
    if warps is None:
        warps = next((w for w in range(1, K1_MAX_WARPS + 1)
                      if 32 * w >= 4 * ghost
                      and ctas * cluster_owned(lanes, w, ghost) >= maxw),
                     None)
        if warps is None:
            raise ValueError(f"pairwise_plan: {ctas} CTAs of {lanes} slot "
                             f"pairs a lane do not hold {maxw} slots")
    if every is None:
        every = 2 * lanes * ghost
    if not 1 <= warps <= K1_MAX_WARPS:
        raise ValueError(f"pairwise_plan: {warps} warps a CTA")
    if not 1 <= ghost <= 31 or 32 * warps < 4 * ghost:
        raise ValueError(f"pairwise_plan: {ghost} ghost lanes a side in "
                         f"{warps} warps")
    if not 1 <= every <= 2 * lanes * ghost:
        raise ValueError(f"pairwise_plan: an exchange every {every} steps "
                         f"with {2 * lanes * ghost} ghost slots")
    per_cta = cluster_owned(lanes, warps, ghost)
    if ctas * per_cta < maxw:
        raise ValueError(f"pairwise_plan: {ctas} CTAs of {per_cta} slots "
                         f"do not hold {maxw} slots")
    smem = mtx_bytes + 44 * warps + 4 * (24 * lanes * ghost + 48) + stride
    if smem > SMEM_MAX:
        raise ValueError(f"pairwise_plan: codes of a cluster CTA do not "
                         f"fit in shared memory")
    return {"variant": "cluster", "lanes": lanes, "warps": warps,
            "pairs_per_block": 1, "threads": 32 * warps,
            "code_stride": stride, "smem_bytes": smem, "ctas": ctas,
            "slots_per_cta": per_cta, "ghost": ghost, "every": every,
            "state": "registers"}


def pairwise_plan(maxw: int, B: int, dim: int, Ma: int, Mb: int, *,
                  variant: str | None = None, lanes: int | None = None,
                  warps: int | None = None, ctas: int | None = None,
                  ghost: int | None = None, every: int | None = None,
                  state: str | None = None) -> dict:
    """K1's variant for a batch whose widest band has ``maxw`` slots.

    "warp": one warp a pair, ``K1_WARP_PAIRS`` pairs a block, each lane
    holding ``lanes`` slot pairs in registers (64 * lanes >= maxw);
    "warps": ``warps`` warps a pair, one pair a block (64 * lanes * warps
    >= maxw); "cluster": ``ctas`` CTAs of ``warps`` warps a pair, each
    owning ``slots_per_cta`` slots of the band with ``ghost`` lanes a
    side of its neighbours' (``cluster_owned``) and exchanging them
    every ``every`` steps; "block": one block of 256 threads a pair with
    the band in shared memory (``state`` "shared", the earlier design) or
    in device memory ("device").  By default "warp" takes bands of up to
    ``K1_WARP_MAX`` slots, "warps" up to 64 * 10 * ``K1_MAX_WARPS``,
    "cluster" up to ``cluster_max_slots()`` (the fewest CTAs that hold
    the band, or more where the batch leaves SMs idle: the most CTAs, a
    power of two up to ``K1_MAX_CTAS``, that keep the batch within two
    CTAs an SM; 2 slot pairs a lane where those CTAs hold the band),
    "block" the rest, with its band in device memory where shared memory
    does not hold it (and the matrix too where it does not fit), so every
    band has a plan.  The register-state variants hold the codes as bytes
    in shared memory (``code_stride`` bytes a pair) beside the matrix, so
    they need ``dim`` <= 256.  Every plan reports its CTAs a pair
    (``ctas``) and slots a CTA (``slots_per_cta``).  A plan the kernels
    cannot take raises.
    """
    if maxw < 3 or B < 0 or dim < 1:
        raise ValueError(f"pairwise_plan: band of {maxw} slots, {B} pairs, "
                         f"dim {dim}")
    stride = -(-(Ma + Mb) // 16) * 16
    mtx_bytes = 4 * dim * dim

    def smallest_lanes(need):
        for n in K1_LANES:
            if n >= need:
                return n
        return None

    if variant is None:
        if dim > 256:
            variant = "block"
        elif maxw <= K1_WARP_MAX:
            variant = "warp"
        elif maxw <= 64 * K1_LANES[-1] * K1_MAX_WARPS:
            variant = "warps"
        elif maxw <= cluster_max_slots():
            variant = "cluster"
        else:
            variant = "block"
        fits = {"warp": mtx_bytes + 44 + stride,
                "warps": mtx_bytes + 44 + stride,
                "cluster": mtx_bytes + 44 + 4 * (24 * 12 + 48) + stride}
        if variant in fits and fits[variant] > SMEM_MAX:
            variant = "block"
    if variant != "cluster" and (ctas is not None or ghost is not None
                                 or every is not None):
        raise ValueError(f"pairwise_plan: the {variant} variant has no "
                         f"cluster")
    if variant != "block" and state is not None:
        raise ValueError(f"pairwise_plan: the {variant} variant keeps its "
                         f"band in registers")
    if variant == "block":
        if lanes is not None or warps is not None:
            raise ValueError("pairwise_plan: the block variant has no lanes")
        if dim > 256:
            raise ValueError(f"pairwise_plan: a {dim}-letter matrix")
        smem = 4 * (dim * dim + 3 * maxw + 32)
        if state is None:
            state = "shared" if smem <= SMEM_MAX else "device"
        if state == "shared" and smem > SMEM_MAX:
            raise ValueError(f"pairwise_plan: a band of {maxw} slots does "
                             f"not fit in shared memory")
        if state == "device":
            # the matrix in shared memory where it fits, else in device
            # memory beside the band
            smem = 4 * (dim * dim + 32)
            if smem > SMEM_MAX:
                smem = 4 * 32
        elif state != "shared":
            raise ValueError(f"pairwise_plan: unknown state {state!r}")
        return {"variant": "block", "lanes": 0, "warps": 0,
                "pairs_per_block": 1, "threads": K1_BLOCK_THREADS,
                "code_stride": 0, "smem_bytes": smem, "ctas": 1,
                "slots_per_cta": maxw, "ghost": 0, "every": 0,
                "state": state}
    if variant not in ("warp", "warps", "cluster"):
        raise ValueError(f"pairwise_plan: unknown variant {variant!r}")
    if dim > 256:
        raise ValueError(f"pairwise_plan: codes of a {dim}-letter matrix "
                         f"are not bytes")
    if variant == "cluster":
        return _cluster_plan(maxw, B, mtx_bytes, stride, lanes, warps, ctas,
                             ghost, every)
    if variant == "warp":
        if warps not in (None, 1):
            raise ValueError("pairwise_plan: the warp variant has one warp "
                             "a pair")
        warps = 1
        if lanes is None:
            lanes = smallest_lanes(-(-maxw // 64))
        pairs = K1_WARP_PAIRS
        while pairs > 1 and mtx_bytes + 44 * pairs + pairs * stride > SMEM_MAX:
            pairs -= 1
    else:
        if lanes is None and warps is None:
            lanes = smallest_lanes(max(K1_WARPS_LANES,
                                       -(-maxw // (64 * K1_MAX_WARPS))))
        if lanes is None:
            raise ValueError(f"pairwise_plan: a band of {maxw} slots is too "
                             f"wide for the warps variant")
        if warps is None:
            warps = -(-maxw // (64 * lanes))
        pairs = 1
    if lanes not in K1_LANES:
        raise ValueError(f"pairwise_plan: {lanes} slot pairs a lane is not "
                         f"one of {K1_LANES}")
    if 64 * lanes * warps < maxw:
        raise ValueError(f"pairwise_plan: {warps} warps of {lanes} slot "
                         f"pairs a lane do not hold {maxw} slots")
    if variant == "warps" and not 1 <= warps <= K1_MAX_WARPS:
        raise ValueError(f"pairwise_plan: {warps} warps a pair")
    nwarps = pairs if variant == "warp" else warps
    smem = mtx_bytes + 44 * nwarps + pairs * stride
    if smem > SMEM_MAX:
        raise ValueError(f"pairwise_plan: codes of {Ma} + {Mb} do not fit "
                         f"in shared memory")
    return {"variant": variant, "lanes": lanes, "warps": warps,
            "pairs_per_block": pairs, "threads": 32 * nwarps,
            "code_stride": stride, "smem_bytes": smem, "ctas": 1,
            "slots_per_cta": 64 * lanes * (1 if variant == "warp" else warps),
            "ghost": 0, "every": 0, "state": "registers"}


_K1_VARIANTS = {"block": 0, "warp": 1, "warps": 2, "cluster": 3}


def _launch_pairwise(a_batch, b_batch, la, lb, lw, up, mtx, u, v, tgapf,
                     exg, local, plan=None):
    exg_u8 = _checked_inputs(a_batch, b_batch, la, lb, lw, up, mtx, u, v,
                             tgapf, exg)
    dev = a_batch.device
    B, Ma = a_batch.shape
    Mb = b_batch.shape[1]
    dim = mtx.shape[0]
    out = torch.empty(B, dtype=torch.float32, device=dev)
    if B == 0:
        return out
    maxw = int((up - lw).max()) + 3
    if plan is None:
        plan = pairwise_plan(maxw, B, dim, Ma, Mb)
    # the block variant's band in device memory: H, F, G a pair
    state = (torch.empty((B, 3, maxw), dtype=torch.float32, device=dev)
             if plan["state"] == "device" else None)
    lib = _build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.pairwise_scores_launch(
        a_batch.data_ptr(), b_batch.data_ptr(), la.data_ptr(),
        lb.data_ptr(), lw.data_ptr(), up.data_ptr(), u.data_ptr(),
        v.data_ptr(), tgapf.data_ptr(), exg_u8.data_ptr(), mtx.data_ptr(),
        out.data_ptr(), None if state is None else state.data_ptr(), B, Ma,
        Mb, dim, int(local), maxw, _K1_VARIANTS[plan["variant"]],
        plan["lanes"], plan["threads"], plan["code_stride"],
        plan["smem_bytes"], plan["ctas"], plan["ghost"], plan["every"],
        stream)
    _build.check(err, "pairwise_scores_launch")
    _build.LAUNCHES["pairwise"] += 1
    return out


def pairwise_attrs(plan: dict, local: bool = False) -> dict:
    """Registers a thread and local (spilled) bytes of the kernel a K1
    plan launches, as the card's loader reports them."""
    out = (ctypes.c_int * 2)()
    code = (4 if plan.get("state") == "device"
            else _K1_VARIANTS[plan["variant"]])
    _build.check(_build.load().pairwise_scores_attrs(
        code, plan["lanes"], int(local), ctypes.addressof(out)),
        "pairwise_scores_attrs")
    return {"registers": out[0], "local_bytes": out[1]}


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
