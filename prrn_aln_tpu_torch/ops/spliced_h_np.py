"""Spliced alignment DP: protein (a) vs genomic DNA (b), codon-stepped
with frameshifts and 3-phase intron states — gene prediction from a
protein query ("Algorithm H").

NumPy/Python oracle of the reference recurrence (src/fwd2h.h:270-583
forwardH with the RVPDJ_nv record, src/fwd2h.cc:38-77 gapopen/update),
validated cell-by-cell against an instrumented (F2DEBUG) reference
build:

* band r = n - 3m over (protein row m, genome column n), stripe31;
* diagonal consumes 1 residue + 3 nt, scored qprof[tron(n-2)] +
  sigE(n-2); 1/2-nt frameshift deletions/insertions with
  GapE1/GapE2/GapW1/GapW2 (= BasicGEP/GOP + ExtraGOP combinations,
  aln2.cc:126-133);
* horizontal lanes are a 3-deep ring (one per codon phase, NQUE=3);
* per-phase donor candidate lists (NCAND_H=4, fresh inserts at the top
  INTR=2 ranks); acceptors merge candidates back with
  IntronPenalty(len) + sig53 + the GSA intron-position bonus;
  phase-1/-2 junctions score the chimeric junction codon
  (SpJunc/spliceTron) with a premature-stop penalty;
* the sj shadow row carries the phase-2 acceptor into the next
  diagonal cell.

Cell (m, n) = consumed residue/nt counts (0-based positions n-2 =
center of the last consumed codon).
"""

from __future__ import annotations

import numpy as np

from .. import alphabet as ab
from ..splice import tron
from ..splice.exin import Exin

NEVSEL = -8.9e30

# TraceBackDir (aln.h:47-52)
DEAD, RSRV, DIAG, NEWD, VERT = 0, 1, 2, 3, 4
SLA1, SLA2, VERL, HORI, HOR1, HOR2, HORL, NEWV, NEWH = \
    5, 6, 7, 8, 9, 10, 11, 12, 13
SPIN, SPJC = 16, 32
SPJCI = SPIN + SPJC

_IS_DIAG = [False] * 16
_IS_DIAG[DIAG] = _IS_DIAG[NEWD] = True
_IS_VERT = [False] * 16
for _d in (VERT, SLA1, SLA2, VERL, NEWV):
    _IS_VERT[_d] = True
_IS_HORI = [False] * 16
for _d in (HORI, HOR1, HOR2, HORL, NEWH):
    _IS_HORI[_d] = True

# dir -> lane index in hf[] = {h, eq1, g} (aln.h:42 dir2nod, Nod=3)
DIR2NOD = [-1, -1, 0, 0, 2, 2, 2, 4, 1, 1, 1, 3, 2, 1, -1, -1]

NCAND_H = 4
INTR = 2
HORI3 = [HORI, HOR1, HOR2, HORI]
VERT3 = [VERT, SLA1, SLA2, VERT]

# record fields
V, D, P, J, GA, GB = range(6)


def _new():
    return [NEVSEL, 0, 0, 0, 0, 0]


class HParams:
    """Scoring constants (PwdB A-vs-G block, aln2.cc:124-137)."""

    def __init__(self, u=2.0, v=9.0, x=30.0, termk1=45,
                 intron_llmt=30):
        self.gep = -u          # BasicGEP
        self.gop = -v          # BasicGOP
        self.extra_gop = -x    # ExtraGOP (frameshift)
        self.gap_e1 = self.gep + self.extra_gop
        self.gap_e2 = self.gap_e1 + self.gep
        self.gap_w1 = self.gap_e1 + self.gop
        self.gap_w2 = self.gap_e2 + self.gop
        self.gap_w3 = self.gop + self.gep
        self.unp = self.gep               # unpaired residue cost
        # (pwd->unpa for single x single is -u, not -3u: the
        # vertical lane charges one extension per residue)
        self.termk1 = termk1
        self.fO = -30.0                   # Premat fO = -o (single pair)

    def term_gap_ext3(self, i):
        return 0.0 if i < self.termk1 else self.gep


def forward_h(qprof, b, exin: Exin, ipen, prm: HParams,
              lw, up, exga=(True, True), exgb=(True, True),
              api=None, trace=None, lcl=15):
    """qprof: (M+2, 26) per-residue score rows (1-based rows 1..M; row
    M+1 duplicates M for the sj lookahead); b: genome codes; exin:
    signal arrays; ipen: IntronPenalty; api: optional (M+1, ) per-
    boundary intron-position bonus callable api(pos_tron) -> float.

    Returns (score, skl, records) where skl knots are (m, n) cell
    coordinates and intron segments appear as same-m jumps flagged in
    the record chain.
    """
    M = qprof.shape[0] - 2
    N = len(b)
    trn = exin.trn
    a_exgl, a_exgr = exga
    b_exgl, b_exgr = exgb
    W = up - lw + 1

    def idx(r):
        return r - lw + 3

    H = [_new() for _ in range(W + 6)]
    G = [_new() for _ in range(W + 6)]
    SJ = [_new() for _ in range(W + 6)]

    recs = [(0, 0, 0)]

    def add(m, n, prev):
        recs.append((m, n, prev))
        return len(recs) - 1

    def gapopen(rcd, d3):
        if (rcd[GA] >= rcd[GB] and d3 > 0) or \
           (rcd[GA] <= rcd[GB] and d3 < 0):
            return prm.gop
        return 0.0

    def update(dst, src, gop, d3):
        if d3 == 0:
            ga, gb = 0, 0
        elif d3 > 0:
            ga, gb = 0, src[GB] + d3
        else:
            ga, gb = src[GA] - d3, 0
        dst[V] = src[V] + gop
        dst[P] = src[P]
        dst[J] = src[J]
        dst[GA] = ga
        dst[GB] = gb

    # ---------------- initH (fwd2h.h:131-200) -------------------------
    def sigS_at(nn):
        if exin.sigS is not None and 0 <= nn < N:
            return float(exin.sigS[nn])
        return 0.0

    def sigT_at(nn):
        if exin.sigT is not None and 0 <= nn < N:
            return float(exin.sigT[nn])
        return NEVSEL

    r0 = 0
    rr = min(up, N)
    h = H[idx(r0)]
    h[V] = max(sigS_at(1), 0.0)
    h[D] = DEAD if a_exgl else DIAG
    h[P] = add(0, 0, 0)
    h[J] = 0
    for i in range(1, rr + 1):
        n = i
        h = H[idx(n)]
        if a_exgl and i < 3:
            h[V] = max(sigS_at(n + 1), 0.0)
            h[D] = DEAD
            h[P] = add(0, n, 0)
            h[J] = n
        elif a_exgl:
            cand = [0.0, H[idx(n - 1)][V] + prm.gap_w1,
                    H[idx(n - 2)][V] + prm.gap_w2,
                    H[idx(n - 3)][V]
                    + prm.term_gap_ext3(n - H[idx(n - 3)][J])
                    + (exin.sigE[n - 2] if n >= 2 else 0.0)]
            x = 0.0
            if (lcl & 1) and sigS_at(n + 1) > x:
                x = sigS_at(n + 1)
            if (lcl & 4) and n < N and exin.sig3[n] > x:
                x = float(exin.sig3[n])
            cand[0] = x
            k = int(np.argmax(cand))
            if k:
                src = H[idx(n - k)]
                update(h, src, cand[k] - src[V], -k)
                h[D] = HORI3[k]
            else:
                h[:] = _new()
                h[V] = x
                h[P] = add(0, n, 0)
                h[D] = DEAD
                h[J] = n
        else:
            break
    # left column
    rr = max(lw, -3 * M)
    m = 0
    for i in range(1, -rr + 1):
        r = -i
        h = H[idx(r)]
        if b_exgl:
            h[V] = 0.0
            h[D] = DEAD
            h[J] = i % 3
            h[P] = add(m, h[J], 0)
        elif i < 3:
            src = H[idx(r + i)]
            update(h, src, prm.gap_w1 if i == 1 else prm.gap_w2, i)
            h[D] = VERT + i
        else:
            src = H[idx(r + 3)]
            gnp = gapopen(src, 3)
            update(h, src, gnp + prm.unp, 3)
            h[D] = VERT
        if i % 3 == 0:
            m += 1

    # ---------------- main sweep --------------------------------------
    e1 = [_new() for _ in range(3)]
    hl = [[_new() for _ in range(NCAND_H + 1)] for _ in range(3)]
    nx = [list(range(NCAND_H + 1)) for _ in range(3)]
    ncand = [0, 0, 0]
    hq = _new()

    m_start = 1
    for m in range(m_start, M + 1):
        internal = (not a_exgr) or m < M
        n1 = 3 * m + lw
        n2 = 3 * m + up
        n0 = max(n1 - 1, 0)
        n9 = min(n2, N)
        qp = qprof[m]
        qp1 = qprof[m + 1]
        for p in range(3):
            e1[p][:] = _new()
            for l in range(NCAND_H + 1):
                hl[p][l][:] = _new()
                nx[p][l] = l
            ncand[p] = 0
        if not b_exgl and m == 1:
            r = n0 + 1 - 3 * m
            if lw <= r <= up:
                e1[2][:] = list(H[idx(r)])
                e1[2][V] = prm.gap_w3
        pua = prm.unp if internal else 0.0
        q = 0
        for n in range(n0 + 1, n9 + 1):
            r = n - 3 * m
            i = idx(r)
            h = H[i]
            g = G[i]
            sj = SJ[i]
            eq1 = e1[q]
            hq[:] = list(h)
            sigE = float(exin.sigE[n - 2]) if n >= 2 else 0.0
            mx = h

            # ---- diagonal -------------------------------------------
            if n > 2:
                if sj[D]:
                    h[:] = list(sj)
                    sj[D] = 0
                else:
                    dv = qp[trn[n - 2]] + sigE
                    update(h, h, dv, 0)
                h[D] = DIAG if _IS_DIAG[h[D] & 15] else NEWD
            else:
                h[:] = _new()

            # ---- vertical (+ frameshift deletions) ------------------
            cand0 = G[i + 3][V] + gapopen(G[i + 3], 3)
            f1 = H[i + 1]
            cand1 = f1[V] + (prm.gap_e1 if _IS_VERT[f1[D] & 15]
                             else prm.gap_w1)
            f2 = H[i + 2]
            cand2 = f2[V] + (prm.gap_e2 if _IS_VERT[f2[D] & 15]
                             else prm.gap_w2)
            f3 = H[i + 3]
            gop = gapopen(f3, 3)
            cand3 = f3[V] + gop
            cands = [cand0, cand1, cand2, cand3]
            k = int(np.argmax(cands))
            src = (G[i + 3], f1, f2, f3)[k]
            update(g, src, cands[k] - src[V] + pua, k if k else 3)
            g[D] = VERT3[k] | (src[D] & SPIN)
            if g[V] > mx[V]:
                mx = g

            # ---- horizontal (+ frameshift insertions) ---------------
            frm3 = H[i - 3]
            if n > 2:
                gop = gapopen(frm3, -3)
                cand0 = eq1[V]
                cand3 = frm3[V] + gop
            else:
                cand0 = cand3 = NEVSEL
            f2 = H[i - 2]
            cand2 = (f2[V] + (prm.gap_e2 if _IS_HORI[f2[D] & 15]
                              else prm.gap_w2)) if n > 1 else NEVSEL
            f1 = H[i - 1]
            cand1 = f1[V] + (prm.gap_e1 if _IS_HORI[f1[D] & 15]
                             else prm.gap_w1)
            cands = [cand0, cand1, cand2, cand3]
            k = int(np.argmax(cands))
            src = (eq1, f1, f2, frm3)[k]
            x = cands[k] - src[V] + prm.gep
            # sigE guard is SPF2 (the dagp HORL lane flag, never set
            # with Noll=2), NOT SPIN: intron-state lanes still collect
            # coding potential (fwd2h.h:432 "if (!(src->dir & SPF2))")
            x += sigE
            spin = src[D] & SPIN
            update(eq1, src, x, -(k if k else 3))
            eq1[D] = HORI3[k] | spin
            if eq1[V] >= mx[V]:
                mx = eq1
            q += 1
            if q == 3:
                q = 0

            hf = (h, eq1, g)

            # ---- 3' boundary: acceptor merges -----------------------
            if internal and n < N and exin.phs3[n] != -2:
                phs_list = [-1 if exin.phs3[n] == 2 else
                            int(exin.phs3[n])]
                if exin.phs3[n] == 2:
                    phs_list.append(1)
                for phs in phs_list:
                    nb = n - phs
                    sigJ = api(3 * m - phs) if api else 0.0
                    pl = hl[phs + 1]
                    pnl = nx[phs + 1]
                    maxphl = [None, None, None, None]
                    for l in range(ncand[phs + 1]):
                        phl = pl[pnl[l]]
                        x = (phl[V] + sigJ
                             + ipen.penalty(nb - phl[J])
                             + exin.sig53_at(phl[J], nb))
                        if phl[D] == 0 and phs:
                            aa1, aa2 = tron.spliced_codons(b, phl[J], nb)
                            if phs == 1:
                                pm = prm.fO if aa1 in (tron.TRM,
                                                       tron.TRM2) else 0.0
                                x += pm + qp[aa1]
                            else:
                                pm = prm.fO if aa2 in (tron.TRM,
                                                       tron.TRM2) else 0.0
                                y = x + pm + qp1[aa2] + gapopen(phl, 0)
                                nxt_aa = trn[n + 1] if n + 1 < N else \
                                    ab.AMB
                                if y > mx[V] + qp1[nxt_aa]:
                                    sj[V] = y
                                    maxphl[3] = phl
                        frm = hf[phl[D]]
                        if x > frm[V]:
                            frm[V] = x
                            maxphl[phl[D]] = phl
                    if phs == -1:
                        if maxphl[0] is not None:
                            sj[D] = 0
                        elif maxphl[3] is not None:
                            phl = maxphl[3]
                            sj[D] = NEWD
                            sj[P] = add(m, phl[J] + phs, phl[P])
                            sj[J] = nb
                            sj[GA] = sj[GB] = 0
                    for dd in range(3):
                        phl = maxphl[dd]
                        if phl is None:
                            continue
                        frm = hf[dd]
                        frm[P] = add(m, n, add(m, phl[J] + phs, phl[P]))
                        frm[D] |= SPJCI
                        frm[J] = nb
                        if frm[V] > mx[V]:
                            mx = frm

            # ---- find optimal path ----------------------------------
            if mx is not h:
                h[:] = list(mx)
            elif h[D] == NEWD:
                h[P] = add(m - 1, n - 3, h[P])

            # ---- 5' boundary: donor pushes --------------------------
            if internal and n < N and exin.phs5[n] != -2:
                phs_list = [-1 if exin.phs5[n] == 2 else
                            int(exin.phs5[n])]
                if exin.phs5[n] == 2:
                    phs_list.append(1)
                for phs in phs_list:
                    nb = n - phs
                    sigJ = exin.sig5_at(nb)
                    hd = DIR2NOD[mx[D] & 15]
                    k0 = 0 if (hd == 0 or phs == 1) else 1
                    for k in range(k0, 3):
                        crossspj = (phs == 1 and k == 0)
                        frm = hq if crossspj else hf[k]
                        if (not frm[D]) or (frm[D] & SPIN):
                            continue
                        if not crossspj and k != hd and hd >= 0:
                            yv = mx[V]
                            if hd == 0 or (k - hd) % 2:
                                yv += (0.0, prm.gop)[k // 2]
                            if frm[V] <= yv:
                                continue
                        x = frm[V] + sigJ
                        pl = hl[phs + 1]
                        pnl = nx[phs + 1]
                        nc = ncand[phs + 1]
                        l = nc + 1 if nc < NCAND_H else NCAND_H
                        if nc < NCAND_H:
                            ncand[phs + 1] += 1
                        while l > 0:
                            l -= 1
                            if x > pl[pnl[l]][V]:
                                pnl[l], pnl[l + 1] = pnl[l + 1], pnl[l]
                            else:
                                l += 1
                                break
                        if l < INTR:
                            phl = pl[pnl[l]]
                            ptr = frm[P]
                            if crossspj and not _IS_DIAG[frm[D] & 15]:
                                ptr = add(m - 1, n - 3, frm[P])
                            phl[:] = list(frm)
                            phl[V] = x
                            phl[J] = nb
                            phl[D] = k
                            phl[P] = ptr
                        else:
                            ncand[phs + 1] -= 1

            if trace is not None:
                trace(m, n, h, eq1, g, hl)

    # ---------------- lastH (fwd2h.h:203-268) --------------------------
    m3 = 3 * M
    rw = max(lw, -m3)
    r9 = N - m3
    glen = [0, 0, 0]
    best_r = r9
    best_val = H[idx(r9)][V]
    best = H[idx(r9)]
    if a_exgr:
        p = 0
        rf = rw
        hh = idx(rw)
        while rf <= r9:
            h = H[hh]
            if p == 3:
                p = 0
            glen[p] += 3
            nn = rf + m3
            cand = [h[V], NEVSEL, NEVSEL]
            if rf - rw >= 3 and H[hh - 3][D] != DEAD:
                cand[1] = (H[hh - 3][V]
                           + (float(exin.sigE[nn - 2]) if nn >= 2 else 0)
                           + prm.term_gap_ext3(glen[p]))
                if (lcl & 2) and not (h[D] & SPIN):
                    cand[2] = H[hh - 3][V] + sigT_at(nn - 2)
            k = int(np.argmax(cand))
            if k:
                src3 = list(H[hh - 3])
                h[:] = src3
                h[V] = cand[k]
            elif not _IS_HORI[h[D] & 15]:
                glen[p] = 0
            if k == 2:
                h[D] = DEAD
                if h[V] > best_val:
                    best = h
                    best_r = rf
                    best_val = h[V]
                    h[P] = add(M, nn - 3, h[P])
            else:
                if k:
                    h[D] = HORI
                if cand[k] > best_val:
                    best = h
                    best_r = rf
                    best_val = cand[k]
            rf += 1
            hh += 1
            p += 1
    if b_exgr:
        rwu = min(up, N)
        for r in range(rwu, r9, -1):
            x = H[idx(r)][V] + (prm.extra_gop if r % 3 else 0.0)
            if x > best_val:
                best = H[idx(r)]
                best_r = r
                best_val = x
    pdel = best_r - r9
    rf, rwn = M, N
    if pdel > 0:
        rf -= (pdel + 2) // 3
        pp = pdel % 3
        if pp:
            rwn -= (3 - pp)
    elif pdel < 0:
        rwn += pdel
    ptr = add(rf, rwn, best[P])
    score = best_val

    # ---------------- traceback ----------------------------------------
    knots = []
    while ptr:
        mm, nn, prev = recs[ptr]
        knots.append((mm, nn))
        ptr = prev
    knots.reverse()
    return float(score), knots


def stdskl_h(knots):
    """Normalise knots for the codon-stepped grid (keep order, drop
    duplicates)."""
    out = []
    for k in knots:
        if not out or out[-1] != k:
            out.append(k)
    return out
