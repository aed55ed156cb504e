"""Spliced DP of a protein or protein profile against genomic DNA (fwd2h),
the forward sweep (kernel K4) and its traceback walk (kernel K4w).

Counterpart of ``prrn_aln_tpu/ops/spliced_h_jax.py`` (the scan engine
``_sweep_h``, transcribed here as the plain version ``sweep_h_ref``; the
host initH/lastH of ``forward_h_device``) and of
``prrn_aln_tpu/ops/pallas_spliced_h.py`` (the Pallas wave kernel, whose
CUDA replacement ``csrc/spliced_h_wave.cu`` the wrapper ``sweep_h``
launches, and the device walk ``_device_walk``, replaced by
``csrc/spliced_h_walk.cu`` behind ``walk_h``).

The sweep runs one wave t = 3m + n per step: every protein row m
advances one genome column, so row m at wave t reads row m - 1 only at
waves t - 3 ... t - 6 and all rows of a wave are independent.  It writes
per-wave planes ev (winner, vertical/horizontal source, junction and sj
bits), jd (the donor position of each lane's junction and the sj
source), V and D (the cell record's value and direction), which the
walk turns into the knot chain.  The kernel and the plain version run
the same float operations in the same order; the intron penalty is one
table by length (``pext``, built once on the host by
``spliced_s.penalty_by_length`` with the operations of the scan engine's
compiled ``spliced_jax._penalty``), which the plain version and both
kernel variants read, so none of them calls a logarithm.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import alphabet as ab
from ..splice import tron
from . import _build
from .spliced_np import NEVSEL, DEAD, DIAG, NEWD, VERT, HORI, SPIN, SPJCI
from .spliced_h_np import _IS_HORI, NCAND_H, INTR, HORI3
from .spliced_s import penalty_by_length

F32 = torch.float32
I32 = torch.int32
I64 = torch.int64

# event bit layout (spliced_h_jax.EVH_*): the winning lane in bits 0-1,
# the vertical source k in bits 3-4, the horizontal source k in bits 5-6
EVH_SJ = 1 << 2
EVH_JXH = 1 << 7
EVH_JXF = 1 << 8
EVH_JXG = 1 << 9
EVH_CSH = 1 << 10        # merged lane-0 candidate was crossspj

# columns of the per-position table: trn, sigE, phs5, phs3, sig5mix,
# dinc3, sss3, e3idx, A2[., 0..4]; positions outside [0, N + 2) read the
# fill (spliced_h_jax._sweep_h TABP and its padding)
TAB_FILL = (0.0, 0.0, -2.0, -2.0, 0.0, 0.0, 0.0, 4.0, 0.0, 0.0, 0.0, 0.0,
            0.0)
# float parameters, in the order csrc/spliced_h_wave.cu reads them
FPRM = ("gop", "gep", "gap_e1", "gap_e2", "gap_w1", "gap_w2", "fO", "e1V",
        "gap_wi")


def _codon_tables(b: np.ndarray):
    """Chimeric junction-codon tables (SpJunc/spliceTron semantics):
    A1[J, e3] = aa of codon (b[J-2], b[J-1], base-elem e3; e3=4 none);
    A2[nb, r1] = aa of codon (base-red r1; r1=4 none, b[nb], b[nb+1]);
    e3idx[n]/r1idx[n] index them by the partner position.  Vectorized
    (round 5): the python per-position loop cost 0.3 s of the spliced
    e2e on the 35 kb flagship case."""
    N = len(b)
    red = np.asarray(tron._RED, np.int64)
    elem = np.asarray(tron._ELEM, np.int64)
    gencode = np.asarray(tron.GENCODE, np.int64)
    # b padded so at(i) = bp[i + 2] with NIL outside [0, N)
    bp = np.full(N + 4, ab.NIL, np.int64)
    bp[2:2 + N] = np.asarray(b, np.int64)

    def aa_vec(c1r, c2, c3e):
        """codon_aa over arrays: c1 as reduced class (4 = none), c3 as
        element (4 = none)."""
        r2 = red[c2]
        r2c = np.clip(r2, 0, 3)
        c1c = np.clip(c1r, 0, 3)
        idx = 16 * c1c + 4 * r2c + np.where(c3e < 4, c3e, 0)
        a = gencode[idx]
        a = np.where((a == tron._A.SER) & (c2 == 5), tron.SER2,
                     np.where((a == tron.TRM) & (c2 == 5), tron.TRM2,
                              a))
        a = np.where(c1r >= 4, tron._MOST_ABUND[r2c], a)
        a = np.where(r2 >= 4, tron.AMB, a)
        a = np.where(c2 <= ab.GAP, tron.UNP, a)
        return a

    p = np.arange(N + 1)
    c1 = bp[p]                       # at(p-2)
    c2 = bp[p + 1]                   # at(p-1)
    r1 = np.where(c1 > ab.GAP, red[c1], 4)
    e3g = np.arange(5)
    A1 = aa_vec(r1[:, None], c2[:, None], e3g[None, :]) \
        .astype(np.int32)
    c2a = bp[p + 2]                  # at(p)
    c3a = bp[p + 3]                  # at(p+1)
    e3a = np.where(c3a > ab.GAP, elem[c3a], 4)
    rg = np.arange(5)
    A2 = aa_vec(rg[None, :], c2a[:, None], e3a[:, None]) \
        .astype(np.int32)
    e3idx = np.where(c2a > ab.GAP, elem[c2a], 4).astype(np.int32)
    r1idx = np.where(c2 > ab.GAP, red[c2], 4).astype(np.int32)
    return A1, A2, e3idx, r1idx


def _penalty(pext, gap_wi, length):
    """IntronPenalty::Penalty (spliced_jax._penalty) read from the table
    by length ``pext``: gap_wi for a negative length (a length is at
    most N: a donor and an acceptor lie in [0, N])."""
    li = torch.clamp(length, 0, pext.shape[0] - 1)
    return torch.where(length < 0, gap_wi, pext[li])


@dataclasses.dataclass
class SweepInputs:
    """Everything the sweep reads, on one device.

    tab (N + 2, 13) f32 per-position table (columns TAB_FILL); dinc5
    (N + 1,), r1idx (N + 1,) and A1 (N + 1, 5) i32, read at a donor
    candidate's position; pair53 (16, 16) f32; qprof (M + 2, 26) f32;
    api (3M + 4,) f32 intron-position bonus; pen f32 intron penalty
    table over [llmt, rlmt]; pext (N + 2,) f32 the penalty of every
    length 0 ... N + 1 (``spliced_s.penalty_by_length``); h0v (W + 6,)
    f32 and h0i (4, W + 6) i32 (D, GA, GB, J): the initH band records;
    e1i (4,) i32 the e1 pre-init record's D, GA, GB, J (its V is fprm's
    e1V); fprm (9,) f32 in FPRM order."""
    tab: torch.Tensor
    dinc5: torch.Tensor
    r1idx: torch.Tensor
    A1: torch.Tensor
    pair53: torch.Tensor
    qprof: torch.Tensor
    api: torch.Tensor
    pen: torch.Tensor
    pext: torch.Tensor
    h0v: torch.Tensor
    h0i: torch.Tensor
    e1i: torch.Tensor
    fprm: torch.Tensor
    M: int
    N: int
    lw: int
    up: int
    a_exgr: bool
    e1pre_t: int          # wave of the e1 pre-init record, -1 for none
    llmt: int
    rlmt: int

    @property
    def t_min(self) -> int:
        return 3 + max(3 + self.lw, 1)

    @property
    def t_max(self) -> int:
        return 3 * self.M + min(3 * self.M + self.up, self.N)

    @property
    def waves(self) -> int:
        return self.t_max - self.t_min + 1

    @property
    def band_cells(self) -> int:
        """Valid (m, n) cells, m >= 1: the work a GCUPS rate counts."""
        m = np.arange(1, self.M + 1)
        lo = np.maximum(3 * m + self.lw, 1)
        hi = np.minimum(3 * m + self.up, self.N)
        return int(np.maximum(hi - lo + 1, 0).sum())


def pack_sweep(qprof, b, exin, ipen, prm, lw: int, up: int, a_exgr: bool,
               h0: dict, api_arr: np.ndarray, e1pre, e1pre_t: int,
               device) -> SweepInputs:
    """Host tables of one sweep (spliced_h_jax.forward_h_device's pack)
    as tensors on ``device``."""
    M = qprof.shape[0] - 2
    N = len(b)
    TL = N + 2
    A1, A2, e3idx, r1idx = _codon_tables(b)
    tab = np.empty((TL, len(TAB_FILL)), np.float32)
    tab[:] = np.asarray(TAB_FILL, np.float32)
    cols = (exin.trn, exin.sigE, exin.phs5[:N + 1], exin.phs3[:N + 1],
            exin.sig.sig5, exin.sig.dinc3, exin.sig.sss3, e3idx,
            *(A2[:, k] for k in range(5)))
    for j, col in enumerate(cols):
        col = np.asarray(col).astype(np.float32)
        k = min(col.shape[0], TL)
        tab[:k, j] = col[:k]
    # the kernel and the plain version look qprof up by these codes
    for codes in (tab[:, 0], tab[:, 8:], A1):
        if codes.min() < 0 or codes.max() >= tron.TSIMD:
            raise ValueError("tron code out of the profile's range")
    # what K4's cluster variant packs: the pair53 row and column (4 bits
    # each), the A2 column and e3idx (3 bits), the phase marks (3 bits)
    dinc5 = np.asarray(exin.sig.dinc5)[:N + 1]
    if (dinc5.min() < 0 or dinc5.max() >= 16 or r1idx.max() >= 5
            or tab[:, 5].min() < 0 or tab[:, 5].max() >= 16
            or tab[:, 7].min() < 0 or tab[:, 7].max() >= 5
            or tab[:, 2:4].min() < -2 or tab[:, 2:4].max() > 2):
        raise ValueError("a splice-site table is out of its range")
    e1 = e1pre if e1pre is not None else (0.0, 0, 0, 0, 0)
    fvals = dict(gop=prm.gop, gep=prm.gep, gap_e1=prm.gap_e1,
                 gap_e2=prm.gap_e2, gap_w1=prm.gap_w1, gap_w2=prm.gap_w2,
                 fO=prm.fO, e1V=e1[0], gap_wi=ipen.gap_wi)

    def dt(x, dtype):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                               device=device)

    return SweepInputs(
        tab=dt(tab, F32),
        dinc5=dt(dinc5, I32),
        r1idx=dt(r1idx, I32), A1=dt(A1, I32),
        pair53=dt(np.asarray(exin.sig.pair53, np.float32), F32),
        qprof=dt(np.asarray(qprof, np.float32), F32),
        api=dt(np.asarray(api_arr, np.float32), F32),
        pen=dt(np.asarray(ipen.table, np.float32), F32),
        pext=dt(penalty_by_length(ipen, N), F32),
        h0v=dt(np.asarray(h0["V"], np.float32), F32),
        h0i=dt(np.stack([h0[f] for f in ("D", "GA", "GB", "J")]), I32),
        e1i=dt(np.asarray(e1[1:], np.int64), I32),
        fprm=dt(np.array([fvals[k] for k in FPRM], np.float32), F32),
        M=M, N=N, lw=int(lw), up=int(up), a_exgr=bool(a_exgr),
        e1pre_t=int(e1pre_t), llmt=int(ipen.llmt), rlmt=int(ipen.rlmt))


class Sweep(NamedTuple):
    """Wave-layout planes (row i = wave t_min + i) and the final band."""
    ev: torch.Tensor      # (T, M + 1) i32, -1 outside the band
    jd: torch.Tensor      # (T, 4, M + 1) i32
    V: torch.Tensor       # (T, M + 1) f32
    D: torch.Tensor       # (T, M + 1) i32
    bandV: torch.Tensor   # (W + 6,) f32
    bandD: torch.Tensor   # (W + 6,) i32


def _band(ins: SweepInputs, V, D):
    """Final band arrays from the per-wave planes (the scan engine's
    epilogue): slot r's last record was written at its last live row
    m_last(r) = min(M, (N - r) // 3), i.e. at wave 6 m_last + r."""
    M, N, lw, up = ins.M, ins.N, ins.lw, ins.up
    dev = V.device
    W = up - lw + 1
    r_sl = torch.arange(-3, W + 3, device=dev) + lw
    m_last = torch.clamp_max(torch.where(
        N >= r_sl, torch.div(N - r_sl, 3, rounding_mode="floor"), -1), M)
    m_first = torch.clamp_min(torch.where(
        r_sl >= 1, 1, torch.div(1 - r_sl + 2, 3, rounding_mode="floor")), 1)
    touched = (m_last >= m_first) & (r_sl >= lw) & (r_sl <= up)
    tw = torch.clamp(6 * m_last + r_sl - ins.t_min, 0, V.shape[0] - 1)
    mc = torch.clamp(m_last, 0, M)
    bandV = torch.where(touched, V[tw, mc], ins.h0v)
    bandD = torch.where(touched, D[tw, mc], ins.h0i[0])
    return bandV, bandD


def sweep_h_ref(ins: SweepInputs) -> Sweep:
    """Plain PyTorch forward sweep: ``spliced_h_jax._sweep_h`` as a
    Python loop over waves on (M + 1)-row tensors, with the scan
    engine's f32 operations in its order."""
    M, N, lw, up = ins.M, ins.N, ins.lw, ins.up
    dev = ins.tab.device
    MR = M + 1
    t_min, t_max = ins.t_min, ins.t_max
    T = ins.waves
    off0 = 3 - lw
    LL = off0
    r0_max = min(up, N)
    fp = {k: ins.fprm[i] for i, k in enumerate(FPRM)}
    nev = torch.tensor(NEVSEL, dtype=F32, device=dev)
    zf = torch.zeros((), dtype=F32, device=dev)
    gop, gep, fO = fp["gop"], fp["gep"], fp["fO"]
    gap_e1, gap_e2 = fp["gap_e1"], fp["gap_e2"]
    gap_w1, gap_w2 = fp["gap_w1"], fp["gap_w2"]

    mvec = torch.arange(MR, device=dev)
    zi = torch.zeros(MR, dtype=I64, device=dev)
    nevv = torch.full((MR,), NEVSEL, dtype=F32, device=dev)
    fb = torch.zeros(MR, dtype=torch.bool, device=dev)
    n_first = torch.clamp_min(3 * mvec + lw, 1)
    n_last = torch.clamp_max(3 * mvec + up, N)
    nf1 = torch.roll(n_first, 1)
    nl1 = torch.roll(n_last, 1)
    internal = (mvec < M) if ins.a_exgr else ~fb
    pua = torch.where(internal, gep, zf)
    is1 = mvec == 1
    ge2 = mvec >= 2

    # per-position table padded with its fill: row PADL + c = column c,
    # for c = t - 2 - 3m ... t + 1 over every wave and row
    TL = N + 2
    PADL = 3 * M + 8
    fill = torch.tensor(TAB_FILL, dtype=F32, device=dev)
    tabP = fill.repeat(PADL + TL + 3 * M + 8, 1)
    tabP[PADL:PADL + TL] = ins.tab
    tab_base = PADL - 2 - 3 * mvec
    dc4 = torch.arange(4, device=dev)
    # initH records: top row by column (guard rows at both ends) and the
    # left column by ii = 3m - n (zero rows outside [0, LL])
    h0 = torch.cat([ins.h0v[None, :], ins.h0i.to(F32)], 0).T     # (W+6, 5)
    guard = torch.tensor([NEVSEL, 0, 0, 0, 0], dtype=F32, device=dev)
    r0P = torch.cat([guard[None], h0[off0:off0 + r0_max + 1], guard[None]])
    zrow = torch.zeros((1, 5), dtype=F32, device=dev)
    leftP = torch.cat([zrow, h0[:off0 + 1].flip(0), zrow])

    def left_at(j):
        """(MR, 5) left-column records left[j] (zeros outside [0, LL])."""
        return leftP[torch.clamp(j, -1, LL + 1) + 1]

    def rec_i(rec):
        return (rec[..., 0], rec[..., 1].long(), rec[..., 2].long(),
                rec[..., 3].long(), rec[..., 4].long())

    qpM = ins.qprof[:MR]
    qp1M = ins.qprof[1:MR + 1]
    api = ins.api
    apiP = torch.cat([torch.zeros(1, dtype=F32, device=dev), api,
                      torch.zeros(2, dtype=F32, device=dev)])
    api_m1 = apiP[3 * mvec]            # api[3m - 1]
    api_0 = apiP[3 * mvec + 1]
    api_p1 = apiP[3 * mvec + 2]        # api[3m + 1]
    flat53 = ins.pair53.reshape(-1)
    dinc5 = ins.dinc5.long()
    r1idx = ins.r1idx.long()
    A1 = ins.A1.long()
    e1rec = (fp["e1V"], *(ins.e1i[k].long() for k in range(4)))

    def qrow(prof, aa):
        """Row m's profile score of code aa[m] (aa (MR,) or (MR, K))."""
        if aa.dim() == 1:
            return prof.gather(1, aa[:, None])[:, 0]
        return prof.gather(1, aa)

    def pick(vals, k):
        out = vals[0]
        for j in range(1, len(vals)):
            out = torch.where(k == j, vals[j], out)
        return out

    def first_max(cands):
        k = zi
        best = cands[0]
        for j in range(1, len(cands)):
            upd = cands[j] > best
            k = torch.where(upd, j, k)
            best = torch.where(upd, cands[j], best)
        return k, best

    def is_vert_d(x):
        x = x & 15
        return ((x >= 4) & (x <= 7)) | (x == 12)

    def is_hori_d(x):
        x = x & 15
        return ((x >= 8) & (x <= 11)) | (x == 13)

    def d2n_of(x):
        x = x & 15
        out = torch.full_like(x, -1)
        out = torch.where((x == DIAG) | (x == NEWD), 0, out)
        out = torch.where(((x >= 8) & (x <= 10)) | (x == 13), 1, out)
        out = torch.where(((x >= 4) & (x <= 6)) | (x == 12), 2, out)
        out = torch.where(x == 11, 3, out)
        return torch.where(x == 7, 4, out)

    def gapopen(ga, gb, d3):
        if d3 > 0:
            return torch.where(ga >= gb, gop, zf)
        return torch.where(ga <= gb, gop, zf)

    def same_row(rec, n, k, jleft):
        """(m, n-k) record; before the band, the left-column record."""
        nk = n - k
        use = nk >= n_first
        out = [torch.where(use, rec[0], nev)] \
            + [torch.where(use, x, 0) for x in rec[1:]]
        if jleft is not None:
            j = 3 * mvec - nk
            use_l = ~use & (nk <= 0) & (j >= 0) & (j <= LL)
            lv = rec_i(left_at(jleft))
            out = [torch.where(use_l, a, b) for a, b in zip(lv, out)]
        return out

    def row_below(rec_sh, n, off, r0rec, jleft):
        """(m-1, n-off) record from a ring record stored shifted down by
        one row; row 1 reads the top-row init record (or a guard)."""
        col = n - off
        ok = ge2 & (col >= nf1) & (col <= nl1)
        out = [torch.where(ok, rec_sh[0], nev)] \
            + [torch.where(ok, x, 0) for x in rec_sh[1:]]
        if jleft is not None:
            ii = 3 * (mvec - 1) - col
            use_l = ~ok & ge2 & (col <= 0) & (ii >= 0) & (ii <= LL)
            lv = rec_i(left_at(jleft))
            out = [torch.where(use_l, a, b) for a, b in zip(lv, out)]
        if r0rec is None:
            out = [torch.where(is1, nev, out[0])] \
                + [torch.where(is1, 0, x) for x in out[1:]]
        else:
            out = [torch.where(is1, r0rec[0], out[0])] \
                + [torch.where(is1, r0rec[i].long(), out[i])
                   for i in range(1, len(out))]
        return out

    def shd(x):
        return torch.roll(x, 1)

    rec0 = (nevv, zi, zi, zi, zi)
    Hh = [rec0] * 6          # H records at waves t-1 .. t-6
    Hs = [rec0] * 6          # the same, shifted down one row
    Ne = [rec0] * 3          # ne (horizontal lane) records, t-1 .. t-3
    Gs = [rec0] * 3          # G records shifted, t-1 .. t-3
    SJs = [(nevv, zi, zi, zi)] * 6   # sj shadow V, D, J, K shifted
    clV = torch.full((MR, 3, NCAND_H + 1), NEVSEL, dtype=F32, device=dev)
    clJ = torch.zeros((MR, 3, NCAND_H + 1), dtype=I64, device=dev)
    clD = torch.zeros_like(clJ)
    clCS = torch.zeros_like(clJ)
    nxs = torch.arange(NCAND_H + 1, device=dev).repeat(MR, 3, 1)
    ncands = torch.zeros((MR, 3), dtype=I64, device=dev)
    k4 = torch.arange(NCAND_H, device=dev)
    j5 = torch.arange(NCAND_H + 1, device=dev)
    l3 = torch.arange(3, device=dev)

    evw = torch.empty((T, MR), dtype=I32, device=dev)
    jdw = torch.empty((T, 4, MR), dtype=I32, device=dev)
    Vw = torch.empty((T, MR), dtype=F32, device=dev)
    Dw = torch.empty((T, MR), dtype=I32, device=dev)

    def lane3(arr, li):
        return arr.gather(1, li[:, None, None].expand(MR, 1, arr.shape[2])) \
            .squeeze(1)

    for t in range(t_min, t_max + 1):
        n = t - 3 * mvec
        valid = (mvec >= 1) & (n >= n_first) & (n <= n_last)
        TB = tabP[tab_base[None, :] + t + dc4[:, None]]     # (4, MR, 13)
        TBm2, TBm1, TB0, TBp1 = TB[0], TB[1], TB[2], TB[3]
        left = t <= 3 * M + 3       # a left-column read needs n <= 3
        jb = 6 * mvec - t
        r0 = [r0P[min(max(t - 6 + dc, -1), r0_max + 1) + 1]
              for dc in range(4)]

        hq = row_below(Hs[5], n, 3, r0[0], jb - 3 if left else None)
        f1 = row_below(Hs[4], n, 2, r0[1], jb - 2 if left else None)
        f2 = row_below(Hs[3], n, 1, r0[2], jb - 1 if left else None)
        f3 = row_below(Hs[2], n, 0, r0[3], jb if left else None)
        gdep = row_below(Gs[2], n, 0, None, None)
        sjV, sjDv, sjJ_, sjK_ = row_below(SJs[5], n, 3, None, None)
        b1 = same_row(Hh[0], n, 1, jb + 1 if left else None)
        b2 = same_row(Hh[1], n, 2, jb + 2 if left else None)
        b3 = same_row(Hh[2], n, 3, jb + 3 if left else None)
        eq = same_row(Ne[2], n, 3, None)
        if t == ins.e1pre_t:
            eq = [torch.where(is1, p, e) for e, p in zip(eq, e1rec)]

        hqV, hqD = hq[0], hq[1]
        sE = torch.where(n >= 2, TBm2[:, 1], zf)

        # ---- diagonal (or sj crossing) -----------------------------
        sj_used = (sjDv != 0) & (n > 2)
        dv = qrow(qpM, TBm2[:, 0].long()) + sE
        bad = n <= 2
        hV = torch.where(bad, nev, torch.where(sj_used, sjV, hqV + dv))
        hJ = torch.where(bad, 0, torch.where(sj_used, sjJ_, hq[4]))
        hDsrc = torch.where(sj_used, sjDv, hqD) & 15
        hD = torch.where(bad, 0, torch.where(
            (hDsrc == DIAG) | (hDsrc == NEWD), DIAG, NEWD))

        # ---- vertical + frameshift deletions -----------------------
        c0 = gdep[0] + gapopen(gdep[2], gdep[3], 3)
        c1 = f1[0] + torch.where(is_vert_d(f1[1]), gap_e1, gap_w1)
        c2 = f2[0] + torch.where(is_vert_d(f2[1]), gap_e2, gap_w2)
        c3 = f3[0] + gapopen(f3[2], f3[3], 3)
        vk, vbest = first_max([c0, c1, c2, c3])
        srcD = pick([gdep[1], f1[1], f2[1], f3[1]], vk)
        srcGB = pick([gdep[3], f1[3], f2[3], f3[3]], vk)
        srcJ = pick([gdep[4], f1[4], f2[4], f3[4]], vk)
        gV = vbest + pua
        gGB = srcGB + torch.where(vk == 0, 3, vk)
        gJ = srcJ
        gD = torch.where(vk == 1, 5, torch.where(vk == 2, 6, VERT)) \
            | (srcD & SPIN)

        # ---- horizontal + frameshift insertions --------------------
        hc0 = torch.where(n > 2, eq[0], nev)
        hc3 = torch.where(n > 2, b3[0] + gapopen(b3[2], b3[3], -3), nev)
        hc2 = torch.where(n > 1, b2[0] + torch.where(
            is_hori_d(b2[1]), gap_e2, gap_w2), nev)
        hc1 = b1[0] + torch.where(is_hori_d(b1[1]), gap_e1, gap_w1)
        hk, hbest = first_max([hc0, hc1, hc2, hc3])
        hsrcV = pick([eq[0], b1[0], b2[0], b3[0]], hk)
        hsrcD = pick([eq[1], b1[1], b2[1], b3[1]], hk)
        hsrcGA = pick([eq[2], b1[2], b2[2], b3[2]], hk)
        hsrcJ = pick([eq[4], b1[4], b2[4], b3[4]], hk)
        x = hbest - hsrcV + gep + sE
        neV = hsrcV + x
        neGA = hsrcGA + torch.where(hk == 0, 3, hk)
        neJ = hsrcJ
        neD = torch.where(hk == 1, 9, torch.where(hk == 2, 10, HORI)) \
            | (hsrcD & SPIN)

        # ---- running max -------------------------------------------
        w = torch.where(gV > hV, 2, zi)
        mxV = torch.maximum(gV, hV)
        w = torch.where(neV >= mxV, 1, w)
        mxV = torch.maximum(neV, mxV)

        # ---- 3' acceptor merges (per phase) ------------------------
        jx = [fb, fb, fb]
        jdon = [zi, zi, zi, zi]
        jcs0 = fb
        jnb = [zi, zi, zi]
        lvV = [hV, neV, gV]
        sj_nV, sj_nJ, sj_nK = nevv, zi, zi
        sj_set = fb
        sj_clr = fb
        p3 = TB0[:, 3].long()
        has_acc = valid & internal & (n < N) & (p3 != -2)
        nxt_aa = torch.where(n + 1 < N, TBp1[:, 0].long(), ab.AMB)
        qp1_nxt = qrow(qp1M, nxt_aa)
        for pi in range(2):
            if pi == 0:
                phs = torch.where(p3 == 2, -1, p3)
                ap = has_acc
            else:
                phs = torch.ones_like(p3)
                ap = has_acc & (p3 == 2)
            nb = n - phs
            is_p1 = phs == 1
            is_m1 = phs == -1
            VAR = torch.where(is_p1[:, None], TBm1,
                              torch.where(is_m1[:, None], TBp1, TB0))
            dinc3v = VAR[:, 5].long()
            sss3v = VAR[:, 6]
            e3v = VAR[:, 7].long()
            A2row = VAR[:, 8:13].long()
            sigJ = torch.where(is_p1, api_m1, torch.where(is_m1, api_p1,
                                                          api_0))
            li = torch.clamp(phs + 1, 0, 2)
            nxrow = lane3(nxs, li)[:, :NCAND_H]
            cV = lane3(clV, li).gather(1, nxrow)
            cJ = lane3(clJ, li).gather(1, nxrow)
            cD = lane3(clD, li).gather(1, nxrow)
            cCS = lane3(clCS, li).gather(1, nxrow)
            nc_li = ncands.gather(1, li[:, None]).squeeze(1)
            act = ap[:, None] & (k4[None, :] < nc_li[:, None])
            cJc = torch.clamp(cJ, 0, N)
            xm = cV + sigJ[:, None]
            xm = xm + _penalty(ins.pext, fp["gap_wi"], nb[:, None] - cJ)
            xm = xm + flat53[dinc5[cJc] * 16 + dinc3v[:, None]]
            xm = xm + sss3v[:, None]
            aa1 = A1[cJc, e3v[:, None]]
            pm1 = torch.where((aa1 == tron.TRM) | (aa1 == tron.TRM2), fO, zf)
            qa1 = qrow(qpM, aa1)
            xm = xm + torch.where((cD == 0) & is_p1[:, None], pm1 + qa1, zf)
            aa2 = A2row.gather(1, r1idx[cJc])
            pm2 = torch.where((aa2 == tron.TRM) | (aa2 == tron.TRM2), fO, zf)
            y = xm + pm2 + qrow(qp1M, aa2)
            # sj shadow: the last qualifying rank wins
            sj_q = (act & (cD == 0) & is_m1[:, None]
                    & (y > (mxV + qp1_nxt)[:, None]))
            any_sj = sj_q.any(1)
            last = torch.clamp((sj_q * (k4 + 1)).amax(1) - 1, 0)[:, None]
            sj_nV = torch.where(any_sj, y.gather(1, last)[:, 0], sj_nV)
            sj_nJ = torch.where(any_sj, nb, sj_nJ)
            sj_nK = torch.where(any_sj, cJ.gather(1, last)[:, 0] + phs,
                                sj_nK)
            sj_set = sj_set | any_sj
            # per-lane best candidate: the first rank reaching the max
            merged0 = fb
            for lane in range(3):
                inlane = act & (cD == lane)
                xmm = torch.where(inlane, xm, nev)
                best, bx = first_max([xmm[:, k] for k in range(NCAND_H)])
                better = inlane.any(1) & (bx > lvV[lane])
                lvV[lane] = torch.where(better, bx, lvV[lane])
                jx[lane] = jx[lane] | better
                bJ = cJ.gather(1, best[:, None])[:, 0]
                jdon[lane] = torch.where(better, bJ + phs, jdon[lane])
                jnb[lane] = torch.where(better, nb, jnb[lane])
                if lane == 0:
                    bCS = cCS.gather(1, best[:, None])[:, 0]
                    jcs0 = torch.where(better, bCS != 0, jcs0)
                    merged0 = better
            sj_clr = sj_clr | (ap & is_m1 & merged0)
            mxV = pick(lvV, w)
            for k in range(3):
                upd = jx[k] & (lvV[k] > mxV)
                w = torch.where(upd, k, w)
                mxV = torch.where(upd, lvV[k], mxV)
        hV, neV, gV = lvV
        hD = torch.where(jx[0], hD | SPJCI, hD)
        hJ = torch.where(jx[0], jnb[0], hJ)
        neD = torch.where(jx[1], neD | SPJCI, neD)
        neJ = torch.where(jx[1], jnb[1], neJ)
        gD = torch.where(jx[2], gD | SPJCI, gD)
        gJ = torch.where(jx[2], jnb[2], gJ)
        sj_on = sj_set & ~sj_clr

        # ---- the cell record ---------------------------------------
        cVx = pick([hV, neV, gV], w)
        cDx = pick([hD, neD, gD], w)
        cGAx = pick([zi, neGA, zi], w)
        cGBx = pick([zi, zi, gGB], w)
        cJx = pick([hJ, neJ, gJ], w)

        # ---- 5' donor pushes (per phase) ---------------------------
        p5 = TB0[:, 2].long()
        has_don = valid & internal & (n < N) & (p5 != -2)
        lvV2 = [cVx, neV, gV]
        lvD2 = [cDx, neD, gD]
        hd = d2n_of(cDx)
        for pi in range(2):
            if pi == 0:
                phs = torch.where(p5 == 2, -1, p5)
                dp = has_don
            else:
                phs = torch.ones_like(p5)
                dp = has_don & (p5 == 2)
            nb = n - phs
            is_p1 = phs == 1
            is_m1 = phs == -1
            sigJ = torch.where(is_p1, TBm1[:, 4],
                               torch.where(is_m1, TBp1[:, 4], TB0[:, 4]))
            li = torch.clamp(phs + 1, 0, 2)
            nxrow = lane3(nxs, li)
            laneV = lane3(clV, li)
            laneJ = lane3(clJ, li)
            laneD = lane3(clD, li)
            laneCS = lane3(clCS, li)
            ncl = ncands.gather(1, li[:, None]).squeeze(1)
            touched = fb
            for k in range(3):
                crossspj = is_p1 if k == 0 else fb
                ok = dp
                if k == 0:
                    ok = ok & ((hd == 0) | is_p1)
                fV = torch.where(crossspj, hqV, lvV2[k])
                fD = torch.where(crossspj, hqD, lvD2[k])
                ok = ok & (fD != 0) & ((fD & SPIN) == 0)
                thr_on = ~crossspj & (hd != k) & (hd >= 0)
                yk = mxV + torch.where(
                    (hd == 0) | ((k - hd) % 2 != 0),
                    gop if k == 2 else zf, zf)
                ok = ok & (~thr_on | (fV > yk))
                xp = fV + sigJ
                nc1 = torch.clamp_max(ncl + 1, NCAND_H)
                l_start = torch.where(ncl < NCAND_H, ncl + 1, NCAND_H)
                vals = laneV.gather(1, nxrow)
                pos = ((j5[None, :] < l_start[:, None])
                       & (vals >= xp[:, None])).sum(1)
                at_ls = nxrow.gather(1, l_start[:, None])
                shifted = torch.cat([nxrow[:, :1], nxrow[:, :-1]], 1)
                new_nx = torch.where(
                    j5 < pos[:, None], nxrow,
                    torch.where(j5 == pos[:, None], at_ls,
                                torch.where(j5 <= l_start[:, None],
                                            shifted, nxrow)))
                accept = ok & (pos < INTR)
                slot = (at_ls == j5) & accept[:, None]
                laneV = torch.where(slot, xp[:, None], laneV)
                laneJ = torch.where(slot, nb[:, None], laneJ)
                laneD = torch.where(slot, k, laneD)
                laneCS = torch.where(slot, crossspj.long()[:, None], laneCS)
                nxrow = torch.where(ok[:, None], new_nx, nxrow)
                ncl = torch.where(ok, torch.where(accept, nc1, nc1 - 1), ncl)
                touched = touched | ok
            wb = (li[:, None] == l3) & touched[:, None]
            clV = torch.where(wb[:, :, None], laneV[:, None, :], clV)
            clJ = torch.where(wb[:, :, None], laneJ[:, None, :], clJ)
            clD = torch.where(wb[:, :, None], laneD[:, None, :], clD)
            clCS = torch.where(wb[:, :, None], laneCS[:, None, :], clCS)
            nxs = torch.where(wb[:, :, None], nxrow[:, None, :], nxs)
            ncands = torch.where(wb, ncl[:, None], ncands)

        ev = (w | torch.where(sj_used, EVH_SJ, 0) | (vk << 3) | (hk << 5)
              | torch.where(jx[0], EVH_JXH, 0)
              | torch.where(jx[1], EVH_JXF, 0)
              | torch.where(jx[2], EVH_JXG, 0)
              | torch.where(jcs0, EVH_CSH, 0))
        i = t - t_min
        evw[i] = torch.where(valid, ev, -1)
        jdw[i] = torch.stack([jdon[0], jdon[1], jdon[2],
                              torch.where(sj_used, sjK_, 0)])
        Vw[i] = cVx
        Dw[i] = cDx

        newH = (cVx, cDx, cGAx, cGBx, cJx)
        Hh = [newH] + Hh[:5]
        Hs = [tuple(shd(x) for x in newH)] + Hs[:5]
        Ne = [(neV, neD, neGA, zi, neJ)] + Ne[:2]
        Gs = [tuple(shd(x) for x in (gV, gD, zi, gGB, gJ))] + Gs[:2]
        SJs = [(shd(torch.where(sj_on, sj_nV, nev)),
                shd(torch.where(sj_on, NEWD, 0)),
                shd(torch.where(sj_on, sj_nJ, 0)),
                shd(torch.where(sj_on, sj_nK, 0)))] + SJs[:5]

    bandV, bandD = _band(ins, Vw, Dw)
    return Sweep(evw, jdw, Vw, Dw, bandV, bandD)


def sweep_h(ins: SweepInputs) -> Sweep:
    """The forward sweep (kernel K4).  CPU tensors take the plain
    version; CUDA tensors launch ``csrc/spliced_h_wave.cu``."""
    if ins.tab.device.type == "cpu":
        return sweep_h_ref(ins)
    return _launch_sweep(ins)


# K4's launch (csrc/spliced_h_wave.cu): the cluster variant runs one row
# a thread, at most K4_ROWS_MAX rows a CTA and K4_CLUSTER_MAX CTAs (the
# portable cluster size), with K4_ROW_WORDS shared words a row (its rings
# and profile row) beside one more profile row, K4_POS_WORDS words of
# genome-position tables, the penalty table and pair53.  The chained
# variant runs clusters of that shape, up to K4_CHAIN_CLUSTER_MAX CTAs (a
# non-portable size), with K4_CHAIN_WORDS shared words more a CTA (the
# column's landing ring and stage); by default clusters of K4_CHAIN_CTAS
# CTAs, the rows spread over as many as K4_CHAIN_ROWS rows a CTA needs
# (tools/k4_bench.py --chained on the long proteins: 32 to 128 rows a CTA
# within 2 % of each other, 96 the fastest, 224 ~14 % slower; clusters
# of 11 to 16 CTAs no faster; PERF.md §6).  The global variant keeps the
# penalty table and pair53 in shared memory.  At most K4_SMEM_MAX bytes a
# CTA.
K4_ROWS_MAX = 256
K4_CLUSTER_MAX = 8
K4_CHAIN_CLUSTER_MAX = 16
K4_CHAIN_CTAS = 8
K4_CHAIN_ROWS = 96
K4_ROW_WORDS = 162
K4_POS_WORDS = 6 * 1024
K4_CHAIN_WORDS = 8 * 16 + 136     # 8 landing entries of 16, one row's rings
K4_SMEM_MAX = 232448


def rows_per_thread(MR: int) -> tuple[int, int]:
    """(rows per thread, threads) of K4's global variant for M + 1 rows:
    one row a thread up to 512 rows, then rows spread evenly over at
    most 512 threads."""
    rpt = -(-MR // 512)
    threads = -(-MR // rpt)
    return rpt, (threads + 31) // 32 * 32


def sweep_plan(MR: int, npen: int, *, variant: str | None = None,
               ctas: int | None = None, clusters: int | None = None,
               held: int | None = None) -> dict:
    """K4's launch for M + 1 rows and an intron-penalty table of ``npen``
    entries: the variant, clusters, CTAs a cluster, rows a CTA, rows a
    thread and shared bytes a CTA.

    Up to K4_CLUSTER_MAX * K4_ROWS_MAX rows the cluster variant takes
    them, one row a thread, in slabs of whole warps: by default the
    smallest slab that K4_CLUSTER_MAX CTAs hold, over as few CTAs as
    that slab needs.  Past that the chained variant takes them on
    clusters of K4_CHAIN_CTAS CTAs: enough for K4_CHAIN_ROWS rows a CTA,
    but no more than ``held`` (what the card holds at once, unbounded if
    None) unless fewer cannot hold the rows; the rows spread evenly over
    the clusters' CTAs in whole warps.  The global variant (one block,
    ``rows_per_thread``) runs only when asked for.  ``variant``, ``ctas``
    and ``clusters`` ask for a plan, as the bench and the tests do; a
    plan the kernel cannot take raises."""
    if variant is None:
        variant = ("cluster" if MR <= K4_CLUSTER_MAX * K4_ROWS_MAX
                   else "chained")
    if variant == "global":
        if ctas not in (None, 1) or clusters not in (None, 1):
            raise ValueError("K4's global variant runs one block")
        rpt, threads = rows_per_thread(MR)
        plan = {"variant": "global", "clusters": 1, "ctas": 1,
                "rows": threads, "rpt": rpt, "smem": 4 * (npen + 256)}
    elif variant == "cluster":
        if ctas is None:
            ctas = K4_CLUSTER_MAX
        rows = (-(-MR // max(ctas, 1)) + 31) // 32 * 32
        if (not 1 <= ctas <= K4_CLUSTER_MAX or rows > K4_ROWS_MAX
                or clusters not in (None, 1)):
            raise ValueError(f"K4's cluster variant cannot take {MR} rows "
                             f"over {ctas} CTAs (at most {K4_CLUSTER_MAX} "
                             f"CTAs of {K4_ROWS_MAX} rows)")
        plan = {"variant": "cluster", "clusters": 1, "ctas": -(-MR // rows),
                "rows": rows, "rpt": 1,
                "smem": 4 * (K4_ROW_WORDS * rows + tron.TSIMD + K4_POS_WORDS
                             + npen + 256)}
    elif variant == "chained":
        if ctas is None:
            ctas = K4_CHAIN_CTAS
        if not 1 <= ctas <= K4_CHAIN_CLUSTER_MAX:
            raise ValueError(f"K4's chained variant takes clusters of 1 to "
                             f"{K4_CHAIN_CLUSTER_MAX} CTAs, not {ctas}")
        if held is not None and held < 1:
            raise ValueError("the card holds no cluster of K4's plan")
        if clusters is None:
            least = max(-(-MR // (ctas * K4_ROWS_MAX)), 2)
            clusters = max(-(-MR // (ctas * K4_CHAIN_ROWS)), 2)
            if held is not None:
                clusters = max(min(clusters, held), least)
        # the smallest slab in whole warps that the clusters' CTAs hold,
        # over as few CTAs and clusters as it needs: every cluster has rows
        rows = (-(-MR // (max(clusters, 1) * ctas)) + 31) // 32 * 32
        cpc = -(-MR // (max(clusters, 1) * rows))
        nclus = -(-MR // (cpc * rows))
        if clusters < 2 or rows > K4_ROWS_MAX or nclus < 2:
            raise ValueError(f"K4's chained variant cannot take {MR} rows "
                             f"over {clusters} clusters of {ctas} CTAs (two "
                             f"clusters or more, at most {K4_ROWS_MAX} rows "
                             f"a CTA)")
        if held is not None and nclus > held:
            raise ValueError(f"K4's chained variant needs {nclus} clusters "
                             f"of {cpc} CTAs on the card at once for {MR} "
                             f"rows; it holds {held} "
                             f"(cudaOccupancyMaxActiveClusters)")
        plan = {"variant": "chained", "clusters": nclus, "ctas": cpc,
                "rows": rows, "rpt": 1,
                "smem": 4 * (K4_CHAIN_WORDS + K4_ROW_WORDS * rows
                             + tron.TSIMD + K4_POS_WORDS + npen + 256)}
    else:
        raise ValueError(f"unknown K4 variant {variant!r}")
    if plan["smem"] > K4_SMEM_MAX:
        raise ValueError(f"K4 needs {plan['smem']} bytes of shared memory, "
                         f"more than the {K4_SMEM_MAX} a CTA can have")
    return plan


@functools.lru_cache(maxsize=None)
def _clusters_held(ctas: int, rows: int, npen: int, chain: bool) -> int:
    out = (ctypes.c_int * 1)()
    _build.check(_build.load().spliced_h_wave_max_clusters(
        ctas, rows, npen, int(chain), ctypes.addressof(out)),
        "spliced_h_wave_max_clusters")
    return out[0]


def clusters_held(plan: dict, npen: int) -> int:
    """Clusters of a cluster or chained plan's shape (with a penalty
    table of ``npen`` entries) the card holds at once
    (cudaOccupancyMaxActiveClusters)."""
    return _clusters_held(plan["ctas"], plan["rows"], npen,
                          plan["variant"] == "chained")


def launch_plan(MR: int, npen: int) -> dict:
    """``sweep_plan`` within what the card holds: a chained plan of more
    clusters than the card holds at once is made again with that cap
    (more rows a CTA); raises ValueError if the card cannot hold it."""
    plan = sweep_plan(MR, npen)
    if plan["variant"] == "chained":
        held = clusters_held(plan, npen)
        if plan["clusters"] > held:
            plan = sweep_plan(MR, npen, held=held)
    return plan


def _launch_sweep(ins: SweepInputs, plan: dict | None = None) -> Sweep:
    dev = ins.tab.device
    if dev.type != "cuda":
        raise ValueError(f"sweep_h: unsupported device {dev}")
    M, N = ins.M, ins.N
    MR = M + 1
    W = ins.up - ins.lw + 1
    npen = ins.rlmt - ins.llmt + 1
    if plan is None:
        plan = launch_plan(MR, npen)
    for t, name, dtype, shape in (
            (ins.tab, "tab", F32, (N + 2, len(TAB_FILL))),
            (ins.dinc5, "dinc5", I32, (N + 1,)),
            (ins.r1idx, "r1idx", I32, (N + 1,)),
            (ins.A1, "A1", I32, (N + 1, 5)),
            (ins.pair53, "pair53", F32, (16, 16)),
            (ins.qprof, "qprof", F32, (M + 2, tron.TSIMD)),
            (ins.api, "api", F32, (3 * M + 4,)),
            (ins.pen, "pen", F32, (npen,)),
            (ins.pext, "pext", F32, (N + 2,)),
            (ins.h0v, "h0v", F32, (W + 6,)),
            (ins.h0i, "h0i", I32, (4, W + 6)),
            (ins.e1i, "e1i", I32, (4,)),
            (ins.fprm, "fprm", F32, (len(FPRM),))):
        _build.require(t, name, dtype, shape, dev)
    T = ins.waves
    lib = _build.load()
    variant = plan["variant"]
    clusters = plan["clusters"]
    ring = tabT = A1T = None
    if variant == "chained":
        held = clusters_held(plan, npen)
        if clusters > held:
            raise ValueError(f"K4's chained plan needs {clusters} clusters "
                             f"of {plan['ctas']} CTAs on the card at once; "
                             f"it holds {held} "
                             f"(cudaOccupancyMaxActiveClusters)")
        words = lib.spliced_h_wave_chain_words(clusters, T)
        if words < 0:
            raise ValueError(f"sweep_h: {clusters} clusters' columns over "
                             f"{T} waves do not index in 32 bits")
        ring = torch.zeros((words,), dtype=I32, device=dev)
    if variant == "global":
        ring = torch.empty((lib.spliced_h_wave_scratch_words() * MR,),
                           dtype=I32, device=dev)
    else:
        tabT = ins.tab.t().contiguous()
        A1T = ins.A1.t().contiguous()
    ev = torch.empty((T, MR), dtype=I32, device=dev)
    jd = torch.empty((T, 4, MR), dtype=I32, device=dev)
    V = torch.empty((T, MR), dtype=F32, device=dev)
    D = torch.empty((T, MR), dtype=I32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.spliced_h_wave_launch(
        ins.tab.data_ptr(), ins.dinc5.data_ptr(), ins.r1idx.data_ptr(),
        ins.A1.data_ptr(), ins.pair53.data_ptr(), ins.qprof.data_ptr(),
        ins.api.data_ptr(), ins.pen.data_ptr(), ins.h0v.data_ptr(),
        ins.h0i.data_ptr(), ins.e1i.data_ptr(), ins.fprm.data_ptr(),
        ins.pext.data_ptr(),
        *(None if x is None else x.data_ptr() for x in (tabT, A1T, ring)),
        ev.data_ptr(),
        jd.data_ptr(), V.data_ptr(), D.data_ptr(), M, N, ins.lw, ins.up,
        int(ins.a_exgr), ins.e1pre_t, ins.llmt, ins.rlmt, tron.TRM,
        tron.TRM2, ab.AMB, int(variant != "global"), plan["ctas"],
        plan["rows"], plan["rpt"], clusters, stream)
    _build.check(err, "spliced_h_wave_launch")
    _build.LAUNCHES["spliced_h_wave"] += 1
    bandV, bandD = _band(ins, V, D)
    return Sweep(ev, jd, V, D, bandV, bandD)


def spliced_h_wave_attrs(variant: str) -> dict:
    """Registers a thread and local (spilled) bytes of one of K4's
    variants (global, cluster, chained), as the card's loader reports
    them."""
    out = (ctypes.c_int * 2)()
    _build.check(_build.load().spliced_h_wave_attrs(
        {"global": 0, "cluster": 1, "chained": 2}[variant],
        ctypes.addressof(out)), "spliced_h_wave_attrs")
    return {"registers": out[0], "local_bytes": out[1]}


# --------------------------------------------------------------------
# traceback walk over the planes (pallas_spliced_h._device_walk)
# --------------------------------------------------------------------

def walk_steps(M: int, N: int) -> int:
    """The walk's step bound (MAXIT); each step appends at most 3 knots."""
    return 6 * (M + N + 8)


class Walk(NamedTuple):
    knots: list           # (m, n) in backward order
    m: int                # the cell the walk stopped at
    n: int
    steps: int            # steps taken


def walk_h_ref(ev, jd, t_min: int, M: int, N: int, om: int,
               on: int) -> Walk:
    """Plain version of the walk: ``_device_walk`` as a scalar Python
    loop over CPU copies of the planes."""
    ev = ev.cpu().numpy()
    jd = jd.cpu().numpy()
    T, MR = ev.shape

    def ev_at(mm, nn):
        ti = 3 * mm + nn - t_min
        if mm < 1 or mm >= MR or ti < 0 or ti >= T:
            return -1
        return int(ev[ti, mm])

    def notdiag(mm, nn):
        e2 = ev_at(mm, nn)
        return mm <= 0 or e2 < 0 or (e2 & 3) != 0

    knots = []
    m, n, st = om, on, 0
    steps = 0
    while steps < walk_steps(M, N):
        e = ev_at(m, n)
        if m <= 0 or e < 0:
            break
        w = e & 3
        jxh = (e & EVH_JXH) != 0
        csh = (e & EVH_CSH) != 0
        b_jxh = st == 0 and w == 0 and jxh
        b_sj = st == 0 and w == 0 and not jxh and (e & EVH_SJ) != 0
        b_dg = st == 0 and w == 0 and not jxh and not b_sj
        b_jxf = st == 1 and (e & EVH_JXF) != 0
        b_h = st == 1 and not b_jxf
        b_jxg = st == 2 and (e & EVH_JXG) != 0
        b_v = st == 2 and not b_jxg
        k = 0 if b_jxh else 3 if b_sj else 1 if b_jxf else 2
        jdv = int(jd[min(max(3 * m + n - t_min, 0), T - 1), k,
                     min(max(m, 0), MR - 1)])
        hk = (e >> 5) & 3
        vk = (e >> 3) & 3
        if b_jxh or b_jxf or b_jxg or b_sj or (b_dg
                                                and notdiag(m - 1, n - 3)):
            knots.append((m - 1 if b_sj or b_dg else m,
                          jdv if b_sj else n - 3 if b_dg else n))
        if b_jxh or b_jxf or b_jxg:
            knots.append((m, jdv))
        if b_jxh and csh and notdiag(m - 1, jdv - 3):
            knots.append((m - 1, jdv - 3))
        if b_jxh:
            m, n, st = (m - 1, jdv - 3, 0) if csh else (m, jdv, 0)
        elif b_sj:
            m, n, st = m - 1, jdv, 0
        elif b_dg:
            m, n, st = m - 1, n - 3, 0
        elif st == 0:
            st = w
        elif b_jxf:
            n, st = jdv, 1
        elif b_jxg:
            n, st = jdv, 2
        elif b_h:
            n, st = (n - 3, 1) if hk == 0 else (n - (1, 1, 2, 3)[hk], 0)
        elif b_v:
            m, n, st = (m - 1, n, 2) if vk == 0 else \
                (m - 1, n - (0, 2, 1, 0)[vk], 0)
        else:
            st = 0
        steps += 1
    return Walk(knots, m, n, steps)


def walk_h(ev, jd, t_min: int, M: int, N: int, om: int, on: int) -> Walk:
    """The traceback walk (kernel K4w).  CPU tensors take the plain
    version; CUDA tensors launch ``csrc/spliced_h_walk.cu``, and only
    the counters and the knot list come back to the host."""
    if ev.device.type == "cpu":
        return walk_h_ref(ev, jd, t_min, M, N, om, on)
    return _launch_walk(ev, jd, t_min, M, N, om, on)


# K4w's launch (walk_plan): the ring's waves by default, its bounds, the
# staging warps beside the walker (csrc/spliced_h_walk.cu's kStagers), and
# the knots that come back with the counters in one copy
K4W_DEPTH = 128
K4W_DEPTH_MIN = 8
K4W_STAGERS = 4
K4W_KNOTS_AHEAD = 256
K4W_HEAD = 16
K4W_HEAD_WORDS = 8
# the last walk's reads of ev from the ring and from device memory
WALK_READS = {"ring": 0, "device": 0}


def walk_plan(T: int, MR: int, *, depth: int | None = None) -> dict:
    """K4w's launch for planes of ``T`` waves by ``MR`` rows: a ring of
    ``depth`` waves (a power of two, at least K4W_DEPTH_MIN) in shared
    memory, each slot ``rows`` = ceil(depth / 3) + 2 rows of ev rounded
    out to 16 bytes (``slot_words`` words), staged by K4W_STAGERS warps
    ahead of one walker thread.  A plan the kernel cannot take raises:
    a depth that is not a power of two, a ring past shared memory, or
    planes of 2**31 words or more (the kernel indexes ev in 32 bits)."""
    if T < 1 or MR < 1:
        raise ValueError(f"walk_plan: planes of {T} waves x {MR} rows")
    if T * MR >= 1 << 31:
        raise ValueError(f"walk_plan: {T} x {MR} words of ev do not index "
                         f"in 32 bits")
    if depth is None:
        depth = K4W_DEPTH
    if depth < K4W_DEPTH_MIN or depth & (depth - 1):
        raise ValueError(f"walk_plan: a ring of {depth} waves is not a "
                         f"power of two of at least {K4W_DEPTH_MIN}")
    rows = -(-depth // 3) + 2
    slot_words = -(-(rows + 3) // 4) * 4
    smem = K4W_HEAD + 8 * depth + 4 * depth * slot_words
    if smem > K4_SMEM_MAX:
        raise ValueError(f"walk_plan: a ring of {depth} waves needs {smem} "
                         f"bytes of shared memory")
    return {"variant": "staged", "depth": depth, "rows": rows,
            "slot_words": slot_words, "stagers": K4W_STAGERS,
            "threads": 32 * (1 + K4W_STAGERS), "smem_bytes": smem}


def _enqueue_walk(ev, jd, t_min, M, N, om, on, plan=None) -> torch.Tensor:
    """Launch K4w on the current stream and return its output buffer on
    the card: the counters (knots, m, n, steps, ring and device reads),
    then 3 knots a step at most.  Waits for nothing."""
    dev = ev.device
    if dev.type != "cuda":
        raise ValueError(f"walk_h: unsupported device {dev}")
    T, MR = ev.shape
    _build.require(ev, "ev", I32, (T, MR), dev)
    _build.require(jd, "jd", I32, (T, 4, MR), dev)
    if plan is None:
        plan = walk_plan(T, MR)
    steps = walk_steps(M, N)
    buf = torch.empty(K4W_HEAD_WORDS + 6 * steps, dtype=I32, device=dev)
    lib = _build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.spliced_h_walk_launch(
        ev.data_ptr(), jd.data_ptr(), buf.data_ptr(), T, MR, t_min, om, on,
        steps, plan["depth"], plan["rows"], plan["slot_words"],
        plan["smem_bytes"], stream)
    _build.check(err, "spliced_h_walk_launch")
    _build.LAUNCHES["spliced_h_walk"] += 1
    return buf


def _launch_walk(ev, jd, t_min, M, N, om, on, plan=None):
    buf = _enqueue_walk(ev, jd, t_min, M, N, om, on, plan)
    # one copy brings the counters and the first knots; a second only for
    # a walk of more knots
    h = K4W_HEAD_WORDS
    head = buf[:h + 2 * K4W_KNOTS_AHEAD].cpu().numpy()
    cnt, m, n, taken, ring, device = (int(x) for x in head[:6])
    kn = head[h:h + 2 * min(cnt, K4W_KNOTS_AHEAD)]
    if cnt > K4W_KNOTS_AHEAD:
        kn = np.concatenate(
            [kn, buf[h + 2 * K4W_KNOTS_AHEAD:h + 2 * cnt].cpu().numpy()])
    kn = kn.reshape(-1, 2)
    WALK_READS.update(ring=ring, device=device)
    return Walk([(int(a), int(b)) for a, b in kn], m, n, taken)


def spliced_h_walk_attrs() -> dict:
    """Registers a thread and local (spilled) bytes of K4w's kernel, as
    the card's loader reports them."""
    out = (ctypes.c_int * 2)()
    _build.check(_build.load().spliced_h_walk_attrs(ctypes.addressof(out)),
                 "spliced_h_walk_attrs")
    return {"registers": out[0], "local_bytes": out[1]}


def _init_tail(m, n, N, init0_k, initc, idx):
    """The knot of the init record the walk stopped at
    (pallas_spliced_h.walk_h_device's host tail)."""
    if m == 0:
        # follow the init-row chain to its DEAD record
        nn = n
        for _ in range(N + 8):
            i = idx(nn)
            if not (0 <= i < len(init0_k)):
                break
            k = int(init0_k[i])
            if k > 0:
                nn -= k
                continue
            break
        return (0, nn)
    rec = initc.get(n - 3 * m)
    return rec if rec is not None else (m, max(n, 0))


# --------------------------------------------------------------------
# forwardH: host initH, the sweep, host lastH and the walk
# --------------------------------------------------------------------

def forward_h_device(qprof, b, exin, ipen, prm, lw, up, *, device,
                     exga=(True, True), exgb=(True, True), api=None,
                     lcl=15):
    """forwardH: host initH, the sweep and the walk on ``device``, host
    lastH; same contract as spliced_h_np.forward_h: returns (score,
    knots)."""
    M = qprof.shape[0] - 2
    N = len(b)
    W = up - lw + 1
    a_exgl, a_exgr = exga
    b_exgl, b_exgr = exgb

    def idx(r):
        return r - lw + 3

    HV = np.full(W + 6, NEVSEL, np.float32)
    HD = np.zeros(W + 6, np.int32)
    HGA = np.zeros(W + 6, np.int32)
    HGB = np.zeros(W + 6, np.int32)
    HJ = np.zeros(W + 6, np.int32)

    def sigS_at(nn):
        if exin.sigS is not None and 0 <= nn < N:
            return float(exin.sigS[nn])
        return 0.0

    def upd_init(i, src, gop, d3):
        HV[i] = HV[src] + gop
        HJ[i] = HJ[src]
        if d3 == 0:
            HGA[i] = HGB[i] = 0
        elif d3 > 0:
            HGA[i], HGB[i] = 0, HGB[src] + d3
        else:
            HGA[i], HGB[i] = HGA[src] - d3, 0

    # ---------------- initH (fwd2h.h:131-200) --------------------------
    # init0_k[slot]: walk bookkeeping for row 0: -1 = own record (DEAD),
    # 1..3 = chained from slot-k, 0 = untouched
    init0_k = np.zeros(W + 6, np.int8)
    HV[idx(0)] = max(sigS_at(1), 0.0)
    HD[idx(0)] = DEAD if a_exgl else DIAG
    init0_k[idx(0)] = -1
    rr = min(up, N)
    if a_exgl:
        for n in range(1, rr + 1):
            i = idx(n)
            if n < 3:
                HV[i] = max(sigS_at(n + 1), 0.0)
                HD[i] = DEAD
                HJ[i] = n
                init0_k[i] = -1
                continue
            x = 0.0
            if lcl & 1:
                x = max(x, sigS_at(n + 1))
            if (lcl & 4) and n < N:
                x = max(x, float(exin.sig3[n]))
            cand = [x,
                    HV[idx(n - 1)] + (prm.gap_w1),
                    HV[idx(n - 2)] + (prm.gap_w2),
                    HV[idx(n - 3)]
                    + prm.term_gap_ext3(n - HJ[idx(n - 3)])
                    + (float(exin.sigE[n - 2]) if n >= 2 else 0.0)]
            k = 0
            if cand[1] > cand[0]:
                k = 1
            if cand[2] > cand[k]:
                k = 2
            if cand[3] > cand[k]:
                k = 3
            if k:
                upd_init(i, idx(n - k), cand[k] - HV[idx(n - k)], -k)
                HD[i] = HORI3[k]
                init0_k[i] = k
            else:
                HV[i] = x
                HD[i] = DEAD
                HJ[i] = n
                HGA[i] = HGB[i] = 0
                init0_k[i] = -1
    # left column
    rr = max(lw, -3 * M)
    m = 0
    initc = {}              # (m, n) -> record knot for b_exgl inits
    for ii in range(1, -rr + 1):
        r = -ii
        i = idx(r)
        if b_exgl:
            HV[i] = 0.0
            HD[i] = DEAD
            HJ[i] = ii % 3
            initc[r] = (m, ii % 3)
        elif ii < 3:
            upd_init(i, idx(r + ii),
                     prm.gap_w1 if ii == 1 else prm.gap_w2, ii)
            HD[i] = VERT + ii
        else:
            src = idx(r + 3)
            gnp = prm.gop if HGA[src] >= HGB[src] else 0.0
            upd_init(i, src, gnp + prm.unp, 3)
            HD[i] = VERT
        if ii % 3 == 0:
            m += 1

    # ---------------- the sweep ----------------------------------------
    if api is not None and not isinstance(api, np.ndarray):
        api_arr = np.array([float(api(pt)) for pt in range(3 * M + 4)],
                           np.float32)
    elif api is not None:
        api_arr = np.asarray(api, np.float32)
    else:
        api_arr = np.zeros(3 * M + 4, np.float32)
    if not b_exgl:
        n0_ = max(3 + lw - 1, 0)
        s_pre = min(max(n0_ + 1 - 3 - lw + 3, 0), W + 5)
        e1pre = (prm.gap_w3, HD[s_pre], HGA[s_pre], HGB[s_pre], HJ[s_pre])
        e1pre_t = int(max(n0_ + 1, 1) + 2 + 3)
    else:
        e1pre, e1pre_t = None, -1
    ins = pack_sweep(qprof, b, exin, ipen, prm, lw, up, a_exgr,
                     dict(V=HV, D=HD, GA=HGA, GB=HGB, J=HJ), api_arr,
                     e1pre, e1pre_t, torch.device(device))
    sw = sweep_h(ins)
    fHV = sw.bandV.cpu().numpy().astype(np.float64)
    fHD = sw.bandD.cpu().numpy()

    def walker(om, on):
        wk = walk_h(sw.ev, sw.jd, ins.t_min, M, N, om, on)
        return wk.knots + [_init_tail(wk.m, wk.n, N, init0_k, initc, idx)]

    return _finish_h(fHV, fHD, M, N, lw, up, exga, exgb, lcl, exin, prm,
                     idx, walker)


def _finish_h(fHV, fHD, M, N, lw, up, exga, exgb, lcl, exin, prm, idx,
              walker):
    """Host lastH (fwd2h.h:203-268) over the final band, then the walk
    from the best end cell."""
    a_exgr = exga[1]
    b_exgr = exgb[1]

    def sigT_at(nn):
        if exin.sigT is not None and 0 <= nn < N:
            return float(exin.sigT[nn])
        return NEVSEL

    m3 = 3 * M
    rw = max(lw, -m3)
    r9 = N - m3
    # origin cell of the record currently held at each slot
    orig = {}
    for r in range(rw, min(up, N) + 1):
        if r <= r9:
            orig[r] = (M, m3 + r)
        else:
            mm = (N - r) // 3
            orig[r] = (mm, 3 * mm + r)
    extra = {}            # slot r -> extra lastH knot (sigT records)
    lV = fHV.copy()
    lD = fHD.copy()
    glen = [0, 0, 0]
    best_r = r9
    best_val = lV[idx(r9)]
    if a_exgr:
        p = 0
        rf = rw
        while rf <= r9:
            hh = idx(rf)
            if p == 3:
                p = 0
            glen[p] += 3
            nn = rf + m3
            cand = [lV[hh], NEVSEL, NEVSEL]
            if rf - rw >= 3 and lD[hh - 3] != DEAD:
                cand[1] = (lV[hh - 3]
                           + (float(exin.sigE[nn - 2]) if nn >= 2 else 0)
                           + prm.term_gap_ext3(glen[p]))
                if (lcl & 2) and not (lD[hh] & SPIN):
                    cand[2] = lV[hh - 3] + sigT_at(nn - 2)
            k = 0
            if cand[1] > cand[0]:
                k = 1
            if cand[2] > cand[k]:
                k = 2
            if k:
                lV[hh] = cand[k]
                lD[hh] = lD[hh - 3]
                orig[rf] = orig[rf - 3]
                extra[rf] = extra.get(rf - 3)
            elif not _IS_HORI[int(lD[hh]) & 15]:
                glen[p] = 0
            if k == 2:
                lD[hh] = DEAD
                if lV[hh] > best_val:
                    best_val = lV[hh]
                    best_r = rf
                    extra[rf] = (M, nn - 3)
            else:
                if k:
                    lD[hh] = HORI
                if cand[k] > best_val:
                    best_val = cand[k]
                    best_r = rf
            rf += 1
            p += 1
    if b_exgr:
        for r in range(min(up, N), r9, -1):
            x = fHV[idx(r)] + (prm.extra_gop if r % 3 else 0.0)
            if x > best_val:
                best_val = x
                best_r = r
    pdel = best_r - r9
    rf, rwn = M, N
    if pdel > 0:
        rf -= (pdel + 2) // 3
        pp = pdel % 3
        if pp:
            rwn -= (3 - pp)
    elif pdel < 0:
        rwn += pdel

    knots = [(rf, rwn)]
    ex = extra.get(best_r)
    if ex is not None:
        knots.append(ex)
    om, on = orig.get(best_r, (M, m3 + best_r))
    knots.extend(walker(om, on))
    knots.reverse()
    return float(best_val), knots
