"""Spliced alignment DP: cDNA (a) vs genomic DNA (b) with intron states.

NumPy/Python oracle implementation of the reference recurrence
(src/fwd2s.h forwardS/globalS with the RVPDJ_nv record type,
src/fwd2s.cc gapopen/update):

* banded affine-gap Gotoh sweep over the (cDNA row, genome column)
  grid, band r = n - m in [wdw.lw, wdw.up];
* per-row donor candidate lists (NCAND_S=4 slots, fresh inserts only at
  the top INTR=2 ranks) holding lane snapshots taken at donor sites;
* acceptor columns merge candidates back into their lane with
  IntronPenalty(length) + sig53 pair/donor signals;
* traceback through a sparse record chain (reference Vmf) written at
  diagonal restarts, junction ends and boundary cells.

Cell convention: (m, n) = consumed residue counts, matching the rest of
this package (see ops/group_np.py).
"""

from __future__ import annotations

import numpy as np

NEVSEL = -8.9e30

# TraceBackDir (reference aln.h:47)
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

# lane indices (reference hf[] layout): 0=DIA, 1=HORI, 2=VERT
DIR2NOD = [-1, -1, 0, 0, 2, 2, 2, 4, 1, 1, 1, 3, 2, 1, -1, -1]

NCAND_S = 4
INTR = 2

# record field indices
V, D, P, J, GA, GB = range(6)


def _new_rec():
    return [NEVSEL, 0, 0, 0, 0, 0]


def spliced_align_np(a, b, signals, ipen, mtx, u=2.0, v=6.0,
                     lw=None, up=None,
                     exga=(True, True), exgb=(True, True)):
    """Returns (score, skl) where skl is a list of (m, n) knots.

    a: cDNA codes, b: genome codes; signals: SpliceSignals over b;
    ipen: IntronPenalty; mtx: DNA substitution matrix.
    """
    a = np.asarray(a)
    b = np.asarray(b)
    la, lb = len(a), len(b)
    if lw is None or up is None:
        from .window import stripe
        w = stripe(la, lb, 100)
        lw, up = w.lw, w.up
    W = up - lw + 1
    gop_ = -float(v)          # BasicGOP
    gep_ = -float(u)          # BasicGEP

    def idx(r):
        return r - lw + 1     # +1 pad slot on each side

    # band lanes: H (diag) and G (vert); pad slot at each end
    H = [_new_rec() for _ in range(W + 2)]
    G = [_new_rec() for _ in range(W + 2)]

    recs = [(0, 0, 0)]        # index 0 = chain-end sentinel

    def add(m, n, prev):
        recs.append((m, n, prev))
        return len(recs) - 1

    a_exgl, a_exgr = exga
    b_exgl, b_exgr = exgb

    # ---------------- initS (fwd2s.h:126) ----------------
    r0 = 0 - 0                # b.left - a.left with left = 0
    h = H[idx(r0)]
    h[V] = 0.0
    h[D] = DEAD if a_exgl else DIAG
    h[P] = add(0, 0, 0)
    h[J] = 0
    if a_exgl:
        rr = min(up, lb)
        for r in range(r0 + 1, rr + 1):
            h = H[idx(r)]
            h[V] = 0.0
            h[D] = DIAG
            h[J] = h[GB] = r
            h[P] = add(0, r, 0)
    rr = max(lw, -la)
    m = 0
    for r in range(r0 - 1, rr - 1, -1):
        m += 1
        h = H[idx(r)]
        if b_exgl:
            h[V] = 0.0
            h[D] = DEAD
            h[J] = 0
            h[P] = add(m, 0, 0)
        else:
            src = H[idx(r + 1)]
            gnp = gop_ if src[GA] >= src[GB] else 0.0
            h[V] = src[V] + gnp + gep_
            h[D] = VERT
            h[P] = src[P]
            h[J] = src[J]
            h[GA] = 0
            h[GB] = src[GB] + 1

    # ---------------- forwardS main sweep ----------------
    f1 = _new_rec()
    hl = [_new_rec() for _ in range(NCAND_S + 1)]
    nx = list(range(NCAND_S + 1))

    mtx_a = mtx[a.astype(np.int64)]        # (la, dim) score rows

    m_start = 1 if a_exgl else 0           # global: first pass row a.left
    for m in range(m_start, la + 1):
        first_row = (m == 0)
        internal = (not a_exgr) or m < la
        n_start = max(m + lw - 1, 0)       # n1 before ++n
        n9 = min(m + up, lb)
        for r in range(NCAND_S + 1):
            hl[r][:] = _new_rec()
            nx[r] = r
        f1[:] = _new_rec()
        ncand = 0
        pua = gep_ if internal else 0.0
        qprof = mtx_a[m - 1]

        for n in range(n_start + 1, n9 + 1):
            r = n - m
            i = idx(r)
            h = H[i]
            g = G[i]
            mx = h
            bscr = float(qprof[b[n - 1]])

            if not first_row:
                # Diagonal (h currently holds cell (m-1, n-1))
                h[V] = h[V] + bscr
                h[GA] = h[GB] = 0
                h[D] = DIAG if _IS_DIAG[h[D] & 15] else NEWD

                # Vertical: from = H[r+1] = cell (m-1, n)
                frm = H[i + 1]
                gv = G[i + 1]
                gopv = gop_ if frm[GA] >= frm[GB] else 0.0
                gnpv = gop_ if gv[GA] >= gv[GB] else 0.0
                if (not _IS_VERT[frm[D] & 15]) and \
                        frm[V] + gopv > gv[V] + gnpv:
                    g[V] = frm[V] + gopv
                    g[P] = frm[P]
                    g[J] = frm[J]
                    g[GA] = 0
                    g[GB] = frm[GB] + 1
                else:
                    g[V] = gv[V] + gnpv
                    g[P] = gv[P]
                    g[J] = gv[J]
                    g[GA] = 0
                    g[GB] = gv[GB] + 1
                g[V] += pua
                g[D] = VERT
                if g[V] > mx[V]:
                    mx = g

            # Horizontal: from = H[r-1] = cell (m, n-1)
            frm = H[i - 1]
            goph = gop_ if frm[GA] <= frm[GB] else 0.0
            if (not _IS_HORI[frm[D] & 15]) and frm[V] + goph > f1[V]:
                f1[V] = frm[V] + goph
                f1[P] = frm[P]
                f1[J] = frm[J]
                f1[GA] = frm[GA] + 1
                f1[GB] = 0
            else:
                f1[GA] += 1
                f1[GB] = 0
            f1[V] += gep_
            f1[D] = (f1[D] & SPIN) + HORI
            if f1[V] >= mx[V]:
                mx = f1

            # 3' boundary: merge donor candidates (fwd2s.h:319)
            if internal and signals.cano3[n]:
                maxphl = [None, None, None]
                for l in range(ncand):
                    phl = hl[nx[l]]
                    x = phl[V] + ipen.penalty(n - phl[J]) \
                        + signals.sig53_pair(phl[J], n)
                    lane = phl[D]
                    frm = (h, f1, g)[lane]
                    if x > frm[V]:
                        frm[V] = x
                        maxphl[lane] = phl
                for dlane in range(3):
                    phl = maxphl[dlane]
                    if phl is None:
                        continue
                    frm = (h, f1, g)[dlane]
                    frm[P] = add(m, n, add(m, phl[J], phl[P]))
                    frm[J] = n
                    frm[D] |= SPJCI
                    if frm[V] > mx[V]:
                        mx = frm

            # Find optimal path
            if mx is not h:
                h[:] = mx[:]
            if h[D] == NEWD:
                h[P] = add(m - 1, n - 1, h[P])

            # 5' boundary: push donor candidates (fwd2s.h:362)
            if internal and signals.cano5[n]:
                sigj = float(signals.sig5[n])
                hd = DIR2NOD[mx[D] & 15]
                for k in range(0 if hd == 0 else 1, 3):
                    frm = (h, f1, g)[k]
                    if (not frm[D]) or (frm[D] & SPIN):
                        continue
                    if k != hd and hd >= 0:
                        y = mx[V]
                        if hd == 0 or (k - hd) % 2:
                            y += (0.0, gop_)[k // 2]
                        if frm[V] <= y:
                            continue
                    x = frm[V] + sigj
                    if ncand < NCAND_S:
                        ncand += 1
                        l = ncand
                    else:
                        l = NCAND_S
                    pos = 0           # landing rank if all ranks shift
                    while l > 0:
                        l -= 1
                        if x > hl[nx[l]][V]:
                            nx[l], nx[l + 1] = nx[l + 1], nx[l]
                        else:
                            pos = l + 1
                            break
                    if pos < INTR:
                        phl = hl[nx[pos]]
                        phl[:] = list(frm)
                        phl[V] = x
                        phl[J] = n
                        phl[D] = k
                    else:
                        ncand -= 1

    # ---------------- lastS (fwd2s.h:171) ----------------
    r9 = lb - la
    mx_r = r9
    best = H[idx(r9)][V]
    if b_exgr:
        rw = min(up, lb)
        for r in range(rw, r9, -1):
            if H[idx(r)][V] > best:
                best = H[idx(r)][V]
                mx_r = r
    if a_exgr:
        rw = max(lw, -la)
        for r in range(rw, r9 + 1):
            if H[idx(r)][V] > best:
                best = H[idx(r)][V]
                mx_r = r
    mx = H[idx(mx_r)]
    i = mx_r - r9
    rf, rw_ = la, lb
    if i > 0:
        rf -= i
    if i < 0:
        rw_ += i
    ptr = add(rf, rw_, mx[P])
    score = mx[V]

    # ---------------- traceback ----------------
    knots = []
    while ptr:
        mm, nn, prev = recs[ptr]
        knots.append((mm, nn))
        ptr = prev
    knots.reverse()
    return float(score), stdskl(knots)


def stdskl(knots):
    """Normalise a knot list: sort, drop no-ops, interpolate the
    diagonal-first bend inside mixed segments (reference gaps.cc:139)."""
    if len(knots) < 2:
        return list(knots)
    knots = sorted(knots)
    out = []
    pr = 2
    prv = knots[0]
    for cur in knots[1:]:
        dm = cur[0] - prv[0]
        dn = cur[1] - prv[1]
        if dm == 0 and dn == 0:
            continue
        if dm < 0 or dn < 0:
            continue
        dd = min(dm, dn)
        df = dn - dm
        df = (1 if df > 0 else -1) if df else 0
        if dd and df:
            if pr:
                out.append(prv)
            out.append((prv[0] + dd, prv[1] + dd))
        elif df != pr or dm == 0:
            out.append(prv)
        pr = df
        prv = cur
    out.append(prv)
    return out
