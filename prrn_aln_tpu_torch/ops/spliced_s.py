"""Spliced DP of a cDNA against genomic DNA (fwd2s), the forward sweep
(kernel K5) and its host traceback.

Counterpart of ``prrn_aln_tpu/ops/spliced_jax.py``: ``spliced_align_device``
(host initS, the sweep, host lastS and the walk of the event planes) and
the scan engine ``_sweep``, transcribed here as the plain version
``sweep_s_ref``, whose CUDA replacement ``csrc/spliced_s_wave.cu`` the
wrapper ``sweep_s`` launches.

Cell (m, s) of band slot s (genome column n = m + lw + s - 1) reads the
row above at slots s and s + 1 and its own row's horizontal carry (the
f1 lane, the previous cell's record, the donor candidate list) from
slot s - 1, so all cells of a wave t = 2m + s are independent: the sweep
runs 2 * rows + W - 2 waves over (rows,) tensors.  It writes the JAX
engine's planes, ev (rows, W) (winner lane, vertical and horizontal
restarts, junction merges; -1 outside the band) and jdon (rows, W, 3)
(each lane's merged donor position), and the last row's H records, which
lastS reads.  The kernel and the plain version run the scan engine's f32
operations in its order; the intron penalty comes from a table by length
(``penalty_by_length``, built once on the host), so neither calls a
logarithm.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from . import _build
from .spliced_np import (NEVSEL, DEAD, DIAG, NEWD, VERT, HORI, SPIN, SPJCI,
                         DIR2NOD, NCAND_S, INTR, stdskl,
                         _IS_DIAG, _IS_VERT, _IS_HORI)

F32 = torch.float32
I32 = torch.int32
I64 = torch.int64

# event plane bit layout (spliced_jax.EV_*)
EV_WINNER = 0x3          # 0=h(diag) 1=f1(hori) 2=g(vert)
EV_VNEW = 1 << 2         # vertical lane restarted from H
EV_HNEW = 1 << 3         # horizontal lane restarted from H
EV_JXH = 1 << 4          # junction merged into h lane
EV_JXF = 1 << 5
EV_JXG = 1 << 6

_DIAG_MASK = [1 if _IS_DIAG[d] else 0 for d in range(16)]
_VERT_MASK = [1 if _IS_VERT[d] else 0 for d in range(16)]
_HORI_MASK = [1 if _IS_HORI[d] else 0 for d in range(16)]


@dataclasses.dataclass
class SweepInputsS:
    """Everything the sweep reads, on one device.

    a (la,) and b (lb,) i32 codes, mtx (K, K) f32 the DNA matrix; cano3,
    cano5, dinc5, dinc3 (lb + 1,) i32, sig5 and sss3 (lb + 1,) f32 over
    genome positions 0 ... lb; pair53 (16, 16) f32; pen (lb + 2,) f32 the
    intron penalty of every length 0 ... lb + 1; h0v, g0v (W + 2,) f32 and
    h0i, g0i (4, W + 2) i32 (D, GA, GB, J): the initS H and G records;
    fprm (2,) f32 (gop, gep).  The end flags: the sweep reads a_exgl and
    a_exgr, lastS and the traceback all four."""
    a: torch.Tensor
    b: torch.Tensor
    mtx: torch.Tensor
    cano3: torch.Tensor
    cano5: torch.Tensor
    sig5: torch.Tensor
    dinc5: torch.Tensor
    dinc3: torch.Tensor
    sss3: torch.Tensor
    pair53: torch.Tensor
    pen: torch.Tensor
    h0v: torch.Tensor
    h0i: torch.Tensor
    g0v: torch.Tensor
    g0i: torch.Tensor
    fprm: torch.Tensor
    la: int
    lb: int
    lw: int
    up: int
    a_exgl: bool
    a_exgr: bool
    b_exgl: bool
    b_exgr: bool

    @property
    def W(self) -> int:
        return self.up - self.lw + 1

    @property
    def m_start(self) -> int:
        return 1 if self.a_exgl else 0

    @property
    def rows(self) -> int:
        return self.la + 1 - self.m_start

    @property
    def waves(self) -> int:
        return max(2 * self.rows + self.W - 2, 0)

    @property
    def band_cells(self) -> int:
        """Valid (m, n) cells: the work a GCUPS rate counts."""
        m = np.arange(self.m_start, self.la + 1)
        lo = np.maximum(m + self.lw, 1)
        hi = np.minimum(m + self.up, self.lb)
        return int(np.maximum(hi - lo + 1, 0).sum())

    def to(self, device) -> "SweepInputsS":
        return dataclasses.replace(self, **{
            k: v.to(device) for k, v in vars(self).items()
            if isinstance(v, torch.Tensor)})


def _fma32(a, b, c):
    """f32 a * b + c rounded once, over arrays: the product is exact in
    f64, the sum is taken in f64 rounded to odd (TwoSum's error moves an
    inexact even result one ulp toward the exact one), so the rounding to
    f32 that follows is the only one."""
    p = a.astype(np.float64) * b.astype(np.float64)
    c = np.broadcast_to(np.asarray(c, np.float64), p.shape)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    adj = (err != 0) & ((s.view(np.int64) & 1) == 0)
    s = np.where(adj, np.nextafter(s, np.where(err > 0, np.inf, -np.inf)), s)
    return s.astype(np.float32)


def _log32(x: np.ndarray) -> np.ndarray:
    """f32 natural log of positive normal f32 values, with the float
    operations of the JAX package's compiled ``jnp.log`` on the CPU (the
    Cephes logf polynomial, its multiply-adds fused), so the intron
    penalty's tail equals the scan engine's bit for bit.  Torch's ``log``
    is correctly rounded almost everywhere and differs from it in the
    last bit for about 1 % of arguments."""
    f = np.float32
    x = np.asarray(x, f)
    bits = x.view(np.int32)
    e = ((bits >> 23) - 0x7F).astype(f) + f(1)
    xm = ((bits & ~0x7F800000) | f(0.5).view(np.int32)).view(f)
    lo = xm < f(0.707106781186547524)
    xm = np.where(lo, (xm - f(1)) + xm, xm - f(1)).astype(f)
    e = np.where(lo, e - f(1), e).astype(f)
    x2 = (xm * xm).astype(f)
    x3 = (x2 * xm).astype(f)
    p = [f(c) for c in (7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1,
                        -1.2420140846E-1, 1.4249322787E-1, -1.6668057665E-1,
                        2.0000714765E-1, -2.4999993993E-1, 3.3333331174E-1)]
    y = _fma32(_fma32(xm, p[0], p[1]), xm, p[2])
    y1 = _fma32(_fma32(xm, p[3], p[4]), xm, p[5])
    y2 = _fma32(_fma32(xm, p[6], p[7]), xm, p[8])
    y = _fma32(_fma32(y, x3, y1), x3, y2)
    y = _fma32(y, x3, (f(-2.12194440e-4) * e).astype(f))
    xm = (xm - (x2 * f(0.5)).astype(f)).astype(f)
    xm = (xm + y).astype(f)
    return (xm + (f(0.693359375) * e).astype(f)).astype(f)


def penalty_by_length(ipen, lb: int) -> np.ndarray:
    """IntronPenalty::Penalty of every length 0 ... lb + 1 (a donor and an
    acceptor both lie in [0, lb]) as the scan engine computes it
    (``spliced_jax._penalty``): the f32 table in [llmt, rlmt), the tail
    int_fx + int_ep * log(max(length - mu, 1)) from rlmt (one multiply-add),
    NEVSEL below llmt."""
    f = np.float32
    length = np.arange(lb + 2)
    table = np.asarray(ipen.table, f)
    tab = table[np.clip(length - int(ipen.llmt), 0, len(table) - 1)]
    arg = np.maximum(length.astype(f) - f(ipen.mu), f(1.0)).astype(f)
    tail = _fma32(np.full_like(arg, f(ipen.int_ep)), _log32(arg),
                  f(ipen.int_fx))
    out = np.where(length >= int(ipen.rlmt), tail, tab)
    return np.where(length < int(ipen.llmt), f(NEVSEL), out).astype(f)


def pack_sweep_s(a, b, signals, ipen, mtx, gop: float, gep: float,
                 lw: int, up: int, exga, exgb, H0: dict, G0: dict,
                 device) -> SweepInputsS:
    """The sweep's inputs (spliced_jax.spliced_align_device's packs) as
    tensors on ``device``."""
    la, lb = len(a), len(b)
    mtx = np.asarray(mtx, np.float32)
    if la == 0:
        mtx = np.zeros_like(mtx)     # the engine's S is zeros then
    codes = np.concatenate([np.asarray(a, np.int64),
                            np.asarray(b, np.int64)])
    if len(codes) and (codes.min() < 0 or codes.max() >= mtx.shape[0]):
        raise ValueError("a sequence code is out of the matrix's range")
    d5 = np.asarray(signals.dinc5)
    d3 = np.asarray(signals.dinc3)
    if d5.min() < 0 or d5.max() >= 16 or d3.min() < 0 or d3.max() >= 16:
        raise ValueError("a dinucleotide code is out of pair53's range")

    def dt(x, dtype):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                               device=device)

    def rec_i(rec):
        return np.stack([rec[f] for f in ("D", "GA", "GB", "J")])

    return SweepInputsS(
        a=dt(np.asarray(a, np.int64), I32), b=dt(np.asarray(b, np.int64), I32),
        mtx=dt(mtx, F32),
        cano3=dt(np.asarray(signals.cano3, np.int64), I32),
        cano5=dt(np.asarray(signals.cano5, np.int64), I32),
        sig5=dt(np.asarray(signals.sig5, np.float32), F32),
        dinc5=dt(d5, I32), dinc3=dt(d3, I32),
        sss3=dt(np.asarray(signals.sss3, np.float32), F32),
        pair53=dt(np.asarray(signals.pair53, np.float32), F32),
        pen=dt(penalty_by_length(ipen, lb), F32),
        h0v=dt(H0["V"], F32), h0i=dt(rec_i(H0), I32),
        g0v=dt(G0["V"], F32), g0i=dt(rec_i(G0), I32),
        fprm=dt(np.array([gop, gep], np.float32), F32),
        la=la, lb=lb, lw=int(lw), up=int(up), a_exgl=bool(exga[0]),
        a_exgr=bool(exga[1]), b_exgl=bool(exgb[0]), b_exgr=bool(exgb[1]))


class SweepS(NamedTuple):
    """The planes (row i = cDNA row m_start + i) and the final H band."""
    ev: torch.Tensor      # (rows, W) i32, -1 outside the band
    jdon: torch.Tensor    # (rows, W, 3) i32
    HV: torch.Tensor      # (W + 2,) f32
    Hi: torch.Tensor      # (4, W + 2) i32: D, GA, GB, J


def sweep_s_ref(ins: SweepInputsS) -> SweepS:
    """Plain PyTorch forward sweep: ``spliced_jax._sweep`` as a Python
    loop over waves t = 2i + s on (rows,) tensors (i the row's index,
    s its slot), with the scan engine's f32 operations in its order."""
    dev = ins.mtx.device
    la, lb, lw, up, W = ins.la, ins.lb, ins.lw, ins.up, ins.W
    R = ins.rows
    ev_pl = torch.full((max(R, 0), W), -1, dtype=I32, device=dev)
    jd_pl = torch.zeros((max(R, 0), W, 3), dtype=I32, device=dev)
    HVf = ins.h0v.clone()
    Hif = ins.h0i.clone()
    if R <= 0:
        return SweepS(ev_pl, jd_pl, HVf, Hif)
    gop, gep = ins.fprm[0], ins.fprm[1]
    zf = torch.zeros((), dtype=F32, device=dev)
    nevf = torch.tensor(NEVSEL, dtype=F32, device=dev)
    dmask = torch.tensor(_DIAG_MASK, dtype=torch.bool, device=dev)
    vmask = torch.tensor(_VERT_MASK, dtype=torch.bool, device=dev)
    hmask = torch.tensor(_HORI_MASK, dtype=torch.bool, device=dev)
    d2n = torch.tensor(DIR2NOD, dtype=I32, device=dev)
    iv = torch.arange(R, device=dev)
    m = iv + ins.m_start
    n_lo = torch.clamp_min(m + lw, 1)
    n_hi = torch.clamp_max(m + up, lb)
    internal = (m < la) if ins.a_exgr else torch.ones(R, dtype=torch.bool,
                                                      device=dev)
    pua = torch.where(internal, gep, zf)
    no_diag = m == 0
    # row m's matrix row (the engine's S[max(m - 1, 0)])
    srow = ins.mtx[ins.a[torch.clamp_min(m - 1, 0)].long()] if la else \
        ins.mtx[torch.zeros(R, dtype=I64, device=dev)]
    bl = ins.b.long()
    cano3, cano5 = ins.cano3, ins.cano5
    sig5, sss3 = ins.sig5, ins.sss3
    dinc5, dinc3 = ins.dinc5.long(), ins.dinc3.long()
    pair53 = ins.pair53.reshape(-1)
    pen = ins.pen
    L1 = lb                       # last index of the position tables
    P1 = lb + 1                   # last index of the penalty table
    h0 = [ins.h0v] + [ins.h0i[k] for k in range(4)]
    g0 = [ins.g0v] + [ins.g0i[k] for k in range(4)]
    zi = torch.zeros(R, dtype=I32, device=dev)
    j5 = torch.arange(NCAND_S + 1, device=dev)

    # the horizontal carry of every row (the engine's ic0)
    f1 = [torch.full((R,), NEVSEL, dtype=F32, device=dev), zi, zi, zi, zi]
    hlV = torch.full((R, NCAND_S + 1), NEVSEL, dtype=F32, device=dev)
    hlJ = torch.zeros((R, NCAND_S + 1), dtype=I32, device=dev)
    hlD = torch.zeros((R, NCAND_S + 1), dtype=I32, device=dev)
    nx = j5.repeat(R, 1)
    ncand = zi
    hp = [x[0].expand(R).clone() for x in h0]
    # each row's H and G records of the last two waves (G: V, GA, GB, J)
    Hprev = [[x[0].expand(R).clone() for x in h0] for _ in range(2)]
    Gprev = [[x[0].expand(R).clone() for x in (g0[0], *g0[2:])]
             for _ in range(2)]

    def above(recs, first, s):
        """Row i - 1's record (row 0: the init record at slot s; a slot
        past W: the init record at W + 1)."""
        sc = torch.clamp(s, 0, W + 1)
        out = []
        for x, x0 in zip(recs, first):
            sh = torch.roll(x, 1)
            out.append(torch.where((iv == 0) | (s > W), x0[sc], sh))
        return out

    def pick3(vals, k):
        return torch.where(k == 0, vals[0],
                           torch.where(k == 1, vals[1], vals[2]))

    for t in range(1, 2 * (R - 1) + W + 1):
        s = t - 2 * iv
        active = (s >= 1) & (s <= W)
        n = m + lw + s - 1
        nc = torch.clamp(n, 0, L1)
        valid = active & (n >= n_lo) & (n <= n_hi)
        # row i - 1 at slot s (wave t - 2) and at slot s + 1 (wave t - 1)
        dV, dD, dGA, dGB, dJ = above(Hprev[1], h0, s)
        uV, uD, uGA, uGB, uJ = above(Hprev[0], h0, s + 1)
        gdV, gdGA, gdGB, gdJ = above(Gprev[1], (g0[0], *g0[2:]), s)
        guV, guGA, guGB, guJ = above(Gprev[0], (g0[0], *g0[2:]), s + 1)
        bscr = srow.gather(1, bl[torch.clamp(n - 1, 0, lb - 1)][:, None])[:, 0]

        # ---- diagonal ----
        hV = dV + bscr
        hD = torch.where(dmask[dD & 15], DIAG, NEWD).to(I32)
        hJ = dJ
        hV = torch.where(no_diag, nevf, hV)
        hD = torch.where(no_diag, DEAD, hD).to(I32)

        # ---- vertical ----
        gopv = torch.where(uGA >= uGB, gop, zf)
        gnpv = torch.where(guGA >= guGB, gop, zf)
        vnew = ~vmask[uD & 15] & (uV + gopv > guV + gnpv)
        gV = torch.where(vnew, uV + gopv, guV + gnpv) + pua
        gJ = torch.where(vnew, uJ, guJ)
        gGB = torch.where(vnew, uGB, guGB) + 1
        gD = torch.full((R,), VERT, dtype=I32, device=dev)
        gV = torch.where(no_diag, nevf, gV)
        vnew = vnew & ~no_diag

        # ---- horizontal ----
        hpV, hpD, hpGA, hpGB, hpJ = hp
        f1V, f1D, f1GA, f1GB, f1J = f1
        goph = torch.where(hpGA <= hpGB, gop, zf)
        hnew = ~hmask[hpD & 15] & (hpV + goph > f1V)
        nf1V = torch.where(hnew, hpV + goph, f1V)
        nf1J = torch.where(hnew, hpJ, f1J)
        nf1GA = torch.where(hnew, hpGA, f1GA) + 1
        nf1V = nf1V + gep
        nf1D = (torch.where(hnew, hpD, f1D) & SPIN) + HORI

        # ---- running max (h -> g strict -> f1 ties) ----
        w = torch.where(gV > hV, 2, 0)
        mxV = torch.maximum(gV, hV)
        w = torch.where(nf1V >= mxV, 1, w)
        mxV = torch.maximum(nf1V, mxV)

        # ---- 3' acceptor: merge candidates ----
        is_acc = valid & internal & (cano3[nc] > 0)
        lv = [hV, nf1V, gV]
        jx = [torch.zeros(R, dtype=torch.bool, device=dev)] * 3
        jdon = [zi] * 3
        for l in range(NCAND_S):
            idx = nx[:, l:l + 1]
            act = is_acc & (l < ncand)
            cJ_ = hlJ.gather(1, idx)[:, 0]
            dlen = n - cJ_
            x = (hlV.gather(1, idx)[:, 0] + pen[torch.clamp(dlen, 0, P1)]
                 + pair53[16 * dinc5[torch.clamp(cJ_, 0, L1)] + dinc3[nc]]
                 + sss3[nc])
            lane = torch.clamp(hlD.gather(1, idx)[:, 0], 0, 2)
            better = act & (x > pick3(lv, lane))
            for k in range(3):
                bk = better & (lane == k)
                lv[k] = torch.where(bk, x, lv[k])
                jx[k] = jx[k] | bk
                jdon[k] = torch.where(bk, cJ_, jdon[k])
        hV, nf1V, gV = lv
        n32 = n.to(I32)
        hD = torch.where(jx[0], hD | SPJCI, hD)
        hJ = torch.where(jx[0], n32, hJ)
        nf1D = torch.where(jx[1], nf1D | SPJCI, nf1D)
        nf1J = torch.where(jx[1], n32, nf1J)
        gD = torch.where(jx[2], gD | SPJCI, gD)
        gJ = torch.where(jx[2], n32, gJ)
        # merged lanes contest the max strictly, in lane order
        mxV = pick3(lv, w)
        for k in range(3):
            upd = jx[k] & (lv[k] > mxV)
            w = torch.where(upd, k, w)
            mxV = torch.where(upd, lv[k], mxV)

        # ---- write the cell record (h <- mx) ----
        cV = pick3([hV, nf1V, gV], w)
        cD = pick3([hD, nf1D, gD], w)
        cGA = pick3([zi, nf1GA, zi], w)
        cGB = pick3([zi, zi, gGB], w)
        cJ = pick3([hJ, nf1J, gJ], w)

        # ---- 5' donor: push candidates ----
        is_don = valid & internal & (cano5[nc] > 0)
        hd = d2n[cD & 15]
        sj = sig5[nc]
        lvD = [cD, nf1D, gD]
        lvV = [cV, nf1V, gV]
        for k in range(3):
            ok = is_don
            if k == 0:
                ok = ok & (hd == 0)
            fD, fV = lvD[k], lvV[k]
            ok = ok & (fD != 0) & ((fD & SPIN) == 0)
            thr_on = (k != hd) & (hd >= 0) & (k != 0)
            y = mxV + torch.where((hd == 0) | (((k - hd) % 2) != 0),
                                  gop if k == 2 else zf, zf)
            ok = ok & torch.where(thr_on, fV > y, True)
            x = fV + sj
            # insertion sort over ranks (fwd2s.h:362 semantics)
            ncand_new = torch.where(ok, torch.clamp_max(ncand + 1, NCAND_S),
                                    ncand)
            l_start = torch.where(ncand < NCAND_S, ncand + 1, NCAND_S)
            pos = zi
            broken = ~ok
            nx2 = nx.clone()
            for l in range(NCAND_S - 1, -1, -1):
                active_l = (l < l_start) & ~broken
                a_, b_ = nx2[:, l].clone(), nx2[:, l + 1].clone()
                gt = x > hlV.gather(1, a_[:, None])[:, 0]
                do_swap = active_l & gt
                nx2[:, l] = torch.where(do_swap, b_, a_)
                nx2[:, l + 1] = torch.where(do_swap, a_, b_)
                stop = active_l & ~gt
                pos = torch.where(stop, l + 1, pos)
                broken = broken | stop
            accept = ok & (pos < INTR)
            slot = nx2.gather(1, torch.clamp(pos, 0, NCAND_S).long()[:, None])
            put = accept[:, None] & (j5[None, :] == slot)
            hlV = torch.where(put, x[:, None], hlV)
            hlJ = torch.where(put, n32[:, None], hlJ)
            hlD = torch.where(put, k, hlD).to(I32)
            nx = torch.where(ok[:, None], nx2, nx)
            ncand = torch.where(ok & ~accept, ncand_new - 1,
                                ncand_new).to(I32)

        ev = (w | torch.where(vnew, EV_VNEW, 0)
              | torch.where(hnew, EV_HNEW, 0)
              | torch.where(jx[0], EV_JXH, 0)
              | torch.where(jx[1], EV_JXF, 0)
              | torch.where(jx[2], EV_JXG, 0))

        # retain old values on invalid slots
        outH = [torch.where(valid, new, old) for new, old in
                zip((cV, cD, cGA, cGB, cJ), (dV, dD, dGA, dGB, dJ))]
        outG = [torch.where(valid, new, old) for new, old in
                zip((gV, zi, gGB, gJ), (gdV, gdGA, gdGB, gdJ))]
        hp = [torch.where(active, new, old) for new, old in zip(outH, hp)]
        f1 = [torch.where(valid, new, old) for new, old in
              zip((nf1V, nf1D, nf1GA, zi, nf1J), f1)]
        Hprev = [outH, Hprev[0]]
        Gprev = [outG, Gprev[0]]
        rows = iv[active]
        sl = s[active] - 1
        ev_pl[rows, sl] = torch.where(valid, ev, -1).to(I32)[active]
        for k in range(3):
            jd_pl[rows, sl, k] = jdon[k][active].to(I32)
        if bool(active[R - 1]):
            sf = int(s[R - 1])
            HVf[sf] = outH[0][R - 1]
            for k in range(4):
                Hif[k, sf] = outH[k + 1][R - 1].to(I32)
    return SweepS(ev_pl, jd_pl, HVf, Hif)


def sweep_s(ins: SweepInputsS) -> SweepS:
    """The forward sweep (kernel K5).  CPU tensors take the plain
    version; CUDA tensors launch ``csrc/spliced_s_wave.cu``."""
    if ins.mtx.device.type == "cpu":
        return sweep_s_ref(ins)
    return _launch_sweep_s(ins)


# K5's launch (csrc/spliced_s_wave.cu).  The cluster variant: one row a
# thread, at most K5_ROWS_MAX rows a CTA and K5_CLUSTER_MAX CTAs a cluster
# (the non-portable most); shared memory a CTA holds a ring of
# K5_RING_DEPTH waves of K5_BOUNDARY_WORDS words a warp, K5_POS_WORDS
# words of genome-position tables, the matrix, pair53 and, where it fits,
# the penalty table.  The chained variant: the cluster variant over
# several clusters of consecutive rows, each cluster's first row reading
# the last row of the one before through a column in device memory (one
# more ring a CTA stages it), its rows spread over as many clusters as
# the card holds at once, down to K5_CHAIN_ROWS rows a CTA (fewer warps
# an SM take a step sooner: tools/k5_bench.py; PERF.md §6).  The global
# variant: one block of at most K5_THREADS threads, rows spread
# over them (rows i, i + threads, ...); the matrix and pair53 in shared
# memory, then the rows' H and G rings (K5_RING_WORDS words a row) and
# the penalty table where they fit.  At most K5_SMEM_MAX bytes a CTA.
K5_ROWS_MAX = 256
K5_CLUSTER_MAX = 16
K5_RING_DEPTH = 16
K5_BOUNDARY_WORDS = 12
K5_POS_WORDS = 3 * 512
K5_THREADS = 1024
K5_RING_WORDS = 27
K5_SMEM_MAX = 232448
K5_CHAIN_ROWS = 64


def sweep_s_plan(rows: int, K: int, npen: int, *, variant: str | None = None,
                 ctas: int | None = None, pen_smem: bool | None = None,
                 cluster_max: int = K5_CLUSTER_MAX,
                 clusters: int | None = None, held: int | None = None,
                 per_pass: int | None = None) -> dict:
    """K5's launch for ``rows`` cDNA rows, a K x K matrix and a penalty
    table of ``npen`` lengths: the variant, clusters, CTAs a cluster, rows
    a CTA (its threads), rows a thread, clusters a launch and launches
    (passes), which of the rings and the penalty table sit in
    shared memory, and shared bytes a CTA.

    Up to ``cluster_max`` * K5_ROWS_MAX rows (the most CTAs a cluster the
    card holds, K5_CLUSTER_MAX at most) the cluster variant takes them,
    one row a thread, in slabs of whole warps: by default the smallest
    slab that ``cluster_max`` CTAs hold, over as few CTAs as that slab
    needs, and the penalty table in shared memory where it fits.  Past
    that (a matrix of at most 256 codes) the chained variant takes them
    on clusters of ``cluster_max`` CTAs: enough for K5_CHAIN_ROWS rows a
    CTA, but no more than ``held`` (what the card holds at once, unbounded
    if None) unless fewer cannot hold the rows; the rows spread evenly
    over the clusters' CTAs in whole warps, at most ``held`` clusters a
    launch.  The global variant takes the rows of a
    larger matrix in one block (``threads`` threads of ``rpt`` rows; its
    ``rows`` is all the rows).  ``variant``, ``ctas``, ``clusters``,
    ``per_pass`` and ``pen_smem`` ask for a plan, as the bench
    and the tests do; a plan the kernels cannot take raises."""
    cluster_max = min(cluster_max, K5_CLUSTER_MAX)
    if variant is None:
        variant = ("global" if K > 256 else "cluster"
                   if rows <= cluster_max * K5_ROWS_MAX else "chained")
    base = 4 * (K * K + 256)
    if variant in ("cluster", "chained"):
        chained = variant == "chained"
        if clusters is None and chained:
            least = max(-(-rows // (cluster_max * K5_ROWS_MAX)), 2)
            clusters = max(-(-rows // (cluster_max * K5_CHAIN_ROWS)), 2)
            if held is not None:
                clusters = max(min(clusters, held), least)
        elif clusters is None:
            clusters = 1
        if ctas is None:
            ctas = cluster_max
        if (not 1 <= ctas <= cluster_max or rows < 1 or K > 256
                or clusters < 1):
            raise ValueError(f"K5's {variant} variant cannot take {rows} "
                             f"rows over {clusters} x {ctas} CTAs")
        # the smallest slab in whole warps that the clusters' CTAs hold,
        # over as few CTAs and clusters as it needs: every cluster has rows
        rows_cta = (-(-rows // (clusters * ctas)) + 31) // 32 * 32
        cpc = -(-rows // (clusters * rows_cta))
        nclus = -(-rows // (cpc * rows_cta))
        if rows_cta > K5_ROWS_MAX or (nclus > 1) != chained:
            raise ValueError(f"K5's {variant} variant cannot take {rows} "
                             f"rows over {clusters} x {ctas} CTAs")
        if held is not None and held < 1:
            raise ValueError("the card holds no cluster of K5's plan")
        per = nclus if per_pass is None else per_pass
        if held is not None:
            per = min(per, held)
        if per < 1:
            raise ValueError(f"K5 cannot run {per_pass} clusters a launch")
        per = min(per, nclus)
        smem = base + 4 * ((rows_cta // 32 + chained) * K5_RING_DEPTH
                           * K5_BOUNDARY_WORDS + K5_POS_WORDS)
        if pen_smem is None:
            pen_smem = smem + 4 * npen <= K5_SMEM_MAX
        plan = {"variant": variant, "clusters": nclus, "ctas": cpc,
                "rows": rows_cta, "threads": rows_cta, "rpt": 1,
                "per_pass": per, "passes": -(-nclus // per),
                "ring_smem": False, "pen_smem": bool(pen_smem),
                "smem": smem + (4 * npen if pen_smem else 0)}
    elif variant == "global":
        if ctas not in (None, 1) or clusters not in (None, 1):
            raise ValueError("K5's global variant runs one block")
        rpt = max(-(-rows // K5_THREADS), 1)
        threads = (-(-rows // rpt) + 31) // 32 * 32
        smem = base
        ring_smem = smem + 4 * K5_RING_WORDS * rows <= K5_SMEM_MAX
        if ring_smem:
            smem += 4 * K5_RING_WORDS * rows
        if pen_smem is None:
            pen_smem = smem + 4 * npen <= K5_SMEM_MAX
        if pen_smem:
            smem += 4 * npen
        plan = {"variant": "global", "clusters": 1, "ctas": 1, "rows": rows,
                "threads": threads, "rpt": rpt, "per_pass": 1, "passes": 1,
                "ring_smem": ring_smem, "pen_smem": bool(pen_smem),
                "smem": smem}
    else:
        raise ValueError(f"unknown K5 variant {variant!r}")
    if plan["smem"] > K5_SMEM_MAX:
        raise ValueError(f"K5 needs {plan['smem']} bytes of shared memory")
    return plan


@functools.lru_cache(maxsize=None)
def _clusters_held(ctas: int, threads: int, smem: int, chain: bool) -> int:
    """Clusters of this shape (of the chained variant's kernel if
    ``chain``) the card holds at once."""
    out = (ctypes.c_int * 1)()
    _build.check(_build.load().spliced_s_wave_max_clusters(
        ctas, threads, smem, int(chain), ctypes.addressof(out)),
        "spliced_s_wave_max_clusters")
    return out[0]


def clusters_held(plan: dict) -> int:
    """Clusters of a cluster or chained plan's shape the card holds at
    once."""
    return _clusters_held(plan["ctas"], plan["threads"], plan["smem"],
                          plan["variant"] == "chained")


def launch_plan(rows: int, K: int, npen: int) -> dict:
    """``sweep_s_plan`` within what the card holds: the cluster size is
    cut until ``cudaOccupancyMaxActiveClusters`` finds room for one
    cluster of the plan (the chained variant takes the rows the smaller
    cluster cannot), and the chained variant runs at most as many
    clusters a launch as the card holds at once; raises if the card holds
    no cluster at all."""
    cmax = K5_CLUSTER_MAX
    while True:
        plan = sweep_s_plan(rows, K, npen, cluster_max=cmax)
        if plan["variant"] == "global":
            return plan
        held = clusters_held(plan)
        if held >= 1 and plan["variant"] == "chained":
            # a cap on clusters changes the CTAs' shape: hold that shape
            plan = sweep_s_plan(rows, K, npen, cluster_max=cmax, held=held)
            held = clusters_held(plan)
        if held >= plan["per_pass"]:
            return plan
        cmax = plan["ctas"] - 1
        if cmax < 1:
            raise RuntimeError("the card holds no cluster of K5's plan")


def _launch_sweep_s(ins: SweepInputsS, plan: dict | None = None) -> SweepS:
    dev = ins.mtx.device
    if dev.type != "cuda":
        raise ValueError(f"sweep_s: unsupported device {dev}")
    la, lb, W, R = ins.la, ins.lb, ins.W, ins.rows
    K = ins.mtx.shape[0]
    for t, name, dtype, shape in (
            (ins.a, "a", I32, (la,)), (ins.b, "b", I32, (lb,)),
            (ins.mtx, "mtx", F32, (K, K)),
            (ins.cano3, "cano3", I32, (lb + 1,)),
            (ins.cano5, "cano5", I32, (lb + 1,)),
            (ins.sig5, "sig5", F32, (lb + 1,)),
            (ins.dinc5, "dinc5", I32, (lb + 1,)),
            (ins.dinc3, "dinc3", I32, (lb + 1,)),
            (ins.sss3, "sss3", F32, (lb + 1,)),
            (ins.pair53, "pair53", F32, (16, 16)),
            (ins.pen, "pen", F32, (lb + 2,)),
            (ins.h0v, "h0v", F32, (W + 2,)), (ins.h0i, "h0i", I32, (4, W + 2)),
            (ins.g0v, "g0v", F32, (W + 2,)), (ins.g0i, "g0i", I32, (4, W + 2)),
            (ins.fprm, "fprm", F32, (2,))):
        _build.require(t, name, dtype, shape, dev)
    if lb < 1 or W < 1:
        raise ValueError(f"sweep_s: a genome of {lb} nt in {W} slots")
    if R * W * 3 >= 1 << 31:
        raise ValueError(f"sweep_s: {R} x {W} cells do not index in 32 bits")
    ev = torch.empty((max(R, 0), W), dtype=I32, device=dev)
    jdon = torch.empty((max(R, 0), W, 3), dtype=I32, device=dev)
    HV = ins.h0v.clone()
    Hi = ins.h0i.clone()
    if R <= 0:
        return SweepS(ev, jdon, HV, Hi)
    if plan is None:
        plan = launch_plan(R, K, lb + 2)
    lib = _build.load()
    cluster = plan["variant"] != "global"
    clusters = plan.get("clusters", 1)
    per_pass = plan.get("per_pass", clusters)
    scratch = None
    if not cluster:
        scratch = torch.empty((lib.spliced_s_wave_scratch_words(
            int(plan["ring_smem"]), int(plan["rpt"] > 1)) * R,),
            dtype=I32, device=dev)
    elif clusters > 1:
        words = lib.spliced_s_wave_chain_words(clusters, R, W)
        if words < 0:
            raise ValueError(f"sweep_s: {clusters} clusters' columns over "
                             f"{R} x {W} do not index in 32 bits")
        scratch = torch.zeros((words,), dtype=I32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.spliced_s_wave_launch(
        ins.a.data_ptr(), ins.b.data_ptr(), ins.mtx.data_ptr(),
        ins.cano3.data_ptr(), ins.cano5.data_ptr(), ins.sig5.data_ptr(),
        ins.dinc5.data_ptr(), ins.dinc3.data_ptr(), ins.sss3.data_ptr(),
        ins.pair53.data_ptr(), ins.pen.data_ptr(), ins.h0v.data_ptr(),
        ins.h0i.data_ptr(), ins.g0v.data_ptr(), ins.g0i.data_ptr(),
        ins.fprm.data_ptr(), None if scratch is None else scratch.data_ptr(),
        ev.data_ptr(), jdon.data_ptr(), HV.data_ptr(), Hi.data_ptr(), la, lb,
        ins.lw, ins.up, int(ins.a_exgl), int(ins.a_exgr), K, int(cluster),
        plan["ctas"], plan["threads"], plan["rpt"], int(plan["ring_smem"]),
        int(plan["pen_smem"]), plan["smem"], clusters, per_pass, stream)
    _build.check(err, "spliced_s_wave_launch")
    _build.LAUNCHES["spliced_s_wave"] += -(-clusters // per_pass)
    return SweepS(ev, jdon, HV, Hi)


def spliced_s_wave_attrs(variant: str, multi: bool = False) -> dict:
    """Registers a thread and local (spilled) bytes of one of K5's
    kernels, as the card's loader reports them: the cluster variant's,
    the chained variant's, or the global variant's one-row (``multi``
    False) or several-rows kernel."""
    which = {"cluster": 2, "chained": 3}.get(variant, int(multi))
    out = (ctypes.c_int * 2)()
    _build.check(_build.load().spliced_s_wave_attrs(
        which, ctypes.addressof(out)), "spliced_s_wave_attrs")
    return {"registers": out[0], "local_bytes": out[1]}


def spliced_align_device(a, b, signals, ipen, mtx, u=2.0, v=6.0,
                         lw=None, up=None,
                         exga=(True, True), exgb=(True, True), *, device):
    """forwardS: host initS, the sweep on ``device`` (K5 on a CUDA
    device, ``sweep_s_ref`` on the CPU), host lastS and traceback
    (``finish_s``); same contract as spliced_align_np: returns (score,
    skl)."""
    a = np.asarray(a)
    b = np.asarray(b)
    la, lb = len(a), len(b)
    if lw is None or up is None:
        from .window import stripe
        wdw = stripe(la, lb, 100)
        lw, up = wdw.lw, wdw.up
    W = up - lw + 1
    a_exgl, a_exgr = exga
    b_exgl, b_exgr = exgb
    gop_, gep_ = -float(v), -float(u)

    # ---------------- initS on host (fwd2s.h:126) ----------------------
    HV = np.full(W + 2, NEVSEL, np.float32)
    HD = np.zeros(W + 2, np.int32)
    HGA = np.zeros(W + 2, np.int32)
    HGB = np.zeros(W + 2, np.int32)
    HJ = np.zeros(W + 2, np.int32)
    GV = np.full(W + 2, NEVSEL, np.float32)
    GD = np.zeros(W + 2, np.int32)
    GGA = np.zeros(W + 2, np.int32)
    GGB = np.zeros(W + 2, np.int32)
    GJ = np.zeros(W + 2, np.int32)

    def idx(r):
        return r - lw + 1

    HV[idx(0)] = 0.0
    HD[idx(0)] = DEAD if a_exgl else DIAG
    if a_exgl:
        for r in range(1, min(up, lb) + 1):
            HV[idx(r)] = 0.0
            HD[idx(r)] = DIAG
            HJ[idx(r)] = r
            HGB[idx(r)] = r
    m = 0
    for r in range(-1, max(lw, -la) - 1, -1):
        m += 1
        i = idx(r)
        if b_exgl:
            HV[i] = 0.0
            HD[i] = DEAD
            HJ[i] = 0
        else:
            src = idx(r + 1)
            gnp = gop_ if HGA[src] >= HGB[src] else 0.0
            HV[i] = HV[src] + gnp + gep_
            HD[i] = VERT
            HJ[i] = HJ[src]
            HGA[i] = 0
            HGB[i] = HGB[src] + 1

    H0 = dict(V=HV, D=HD, GA=HGA, GB=HGB, J=HJ)
    G0 = dict(V=GV, D=GD, GA=GGA, GB=GGB, J=GJ)
    ins = pack_sweep_s(a, b, signals, ipen, mtx, gop_, gep_, lw, up,
                       (a_exgl, a_exgr), (b_exgl, b_exgr), H0, G0,
                       torch.device(device))
    return finish_s(ins, sweep_s(ins))


def finish_s(ins: SweepInputsS, sw: SweepS):
    """lastS and the traceback on the host (spliced_jax.py:387-411): the
    score and SKL from the sweep's final band and planes, copied back
    once."""
    la, lb, lw, up = ins.la, ins.lb, ins.lw, ins.up
    HVf = sw.HV.cpu().numpy()
    evs = sw.ev.cpu().numpy()
    jdons = sw.jdon.cpu().numpy()

    def idx(r):
        return r - lw + 1

    # ---------------- lastS on host (fwd2s.h:171) -----------------------
    r9 = lb - la
    mx_r = r9
    best = HVf[idx(r9)]
    if ins.b_exgr:
        for r in range(min(up, lb), r9, -1):
            if HVf[idx(r)] > best:
                best = HVf[idx(r)]
                mx_r = r
    if ins.a_exgr:
        for r in range(max(lw, -la), r9 + 1):
            if HVf[idx(r)] > best:
                best = HVf[idx(r)]
                mx_r = r
    i = mx_r - r9
    rf, rw_ = la, lb
    if i > 0:
        rf -= i
    if i < 0:
        rw_ += i

    knots = _traceback(evs, jdons, rf, rw_, la, lb, lw, up,
                       ins.a_exgl, ins.b_exgl, ins.m_start)
    knots.append((rf, rw_))
    return float(best), stdskl(knots)


def _traceback(evs, jdons, m0, n0, la, lb, lw, up, a_exgl, b_exgl,
               m_start):
    """Walk the event planes back from (m0, n0); returns knots in
    forward order (matching the oracle's reversed record chain)."""
    knots: list[tuple[int, int]] = []
    m, n = m0, n0
    state = 0          # 0 = cell record (H), 1 = f1 lane, 2 = g lane

    def ev_at(mm, nn):
        s = nn - mm - lw           # 0-based slot within the W planes
        mi = mm - m_start
        if mi < 0 or s < 0 or s >= evs.shape[1] or mi >= evs.shape[0]:
            return None
        e = int(evs[mi, s])
        return None if e < 0 else e

    def cls_at(mm, nn):
        """diag/hori/vert/dead class of the final record at a cell."""
        if mm == 0:
            # init row: origin DEAD when a_exgl else DIAG; others DIAG
            e = ev_at(0, nn)
            if e is None:
                if nn == 0:
                    return "dead" if a_exgl else "diag"
                return "diag" if a_exgl else "dead"
            return ("diag", "hori", "vert")[e & EV_WINNER]
        if nn <= 0 or nn - mm < lw:
            return "dead" if b_exgl else "vert"
        e = ev_at(mm, nn)
        if e is None:
            return "dead"
        return ("diag", "hori", "vert")[e & EV_WINNER]

    guard = 0
    while guard < 4 * (la + lb + 4):
        guard += 1
        if m <= 0 or n <= 0 or n - m < lw:
            break
        e = ev_at(m, n)
        if e is None:
            break
        s = n - m - lw
        mi = m - m_start
        if state == 0:
            w = e & EV_WINNER
            if w == 0:
                if e & EV_JXH:
                    j = int(jdons[mi, s, 0])
                    knots.append((m, n))
                    knots.append((m, j))
                    n = j
                    continue
                # diagonal: knot at source when its class isn't diag
                if cls_at(m - 1, n - 1) != "diag":
                    knots.append((m - 1, n - 1))
                m -= 1
                n -= 1
                continue
            state = w
            continue
        if state == 1:                    # f1 lane
            if e & EV_JXF:
                j = int(jdons[mi, s, 1])
                knots.append((m, n))
                knots.append((m, j))
                n = j
                continue
            if e & EV_HNEW:
                state = 0
            n -= 1
            continue
        # g lane
        if e & EV_JXG:
            j = int(jdons[mi, s, 2])
            knots.append((m, n))
            knots.append((m, j))
            n = j
            continue
        if e & EV_VNEW:
            state = 0
        m -= 1
        continue

    # initial record
    if m == 0:
        knots.append((0, n))
    elif n <= 0 or n - m < lw:
        if b_exgl:
            knots.append((m, max(n, 0)))      # add(m, 0, 0) init record
        else:
            knots.append((0, 0))              # chain ends at the origin
    else:
        knots.append((m, n))
    knots.reverse()
    return knots
