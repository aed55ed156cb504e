"""Smith-Waterman-Gotoh local alignment "colonies" (aln -Ls).

Reference: src/fwd2c.h Fwd2c::forwardC with the SwgDPunit record
(src/dpunit.h:53, src/fwd2c.cc:256-298) and the Colonies container
(src/aln.h:199, src/aln2.cc:352-430).  One banded local sweep finds all
high-scoring regions ("colonies"); each colony is then re-aligned
restricted to its bounding box (swg2ndC, fwd2c.h:680).
"""

from __future__ import annotations

import numpy as np

from .window import stripe

NEVSEL = -8.9e30
POS_INT = 2**30
NEG_INT = -(2**30)

DEAD, DIAG, NEWD, VERT, HORI = 0, 2, 3, 4, 8
_IS_DIAG = {DIAG, NEWD}
_IS_VERT = {VERT}
_IS_HORI = {HORI}

# record fields
V, D, LWR, UPR, MLB, NLB, CL = range(7)


def _black():
    return [NEVSEL, 0, POS_INT, NEG_INT, 0, 0, 0]


def _blank():
    return [0.0, 0, POS_INT, NEG_INT, 0, 0, 0]


class Colony:
    __slots__ = ("val", "lwr", "upr", "mlb", "nlb", "mrb", "nrb",
                 "clno", "mark")

    def __init__(self, clno=0):
        self.val = 0.0
        self.lwr = self.upr = 0
        self.mlb = self.nlb = self.mrb = self.nrb = 0
        self.clno = clno
        self.mark = 0


def swg_colonies(a, b, mtx, u=2.0, v=6.0, sh=-50, thr=35.0,
                 mlt=1, no_out=512, allowed_overlap=5):
    """forwardC: returns colonies sorted by score (best first).

    For mlt == 1 only the single best local region (colony 0) is
    tracked; for mlt >= 2 every region reaching ``thr`` becomes its own
    colony and overlapping colonies are pruned (mlt == 2).
    """
    a = np.asarray(a)
    b = np.asarray(b)
    la, lb = len(a), len(b)
    w = stripe(la, lb, sh)
    lw, up = w.lw, w.up
    W = up - lw + 1
    gop_ = -float(v)
    gep_ = -float(u)

    def idx(r):
        return r - lw + 1

    H = [_black() for _ in range(W + 2)]
    G = [_black() for _ in range(W + 2)]

    colonies = [Colony(0)]
    cc0 = colonies[0]

    # initC (fwd2c.h:179): zero boundary with DEAD direction
    for r in range(0, min(up, lb) + 1):
        h = H[idx(r)]
        h[:] = [0.0, DEAD, r, r, 0, r, 0]
    m = 0
    for r in range(-1, max(lw, -la) - 1, -1):
        m += 1
        h = H[idx(r)]
        h[:] = [0.0, DEAD, r, r, m, 0, 0]

    mtx_a = mtx[a.astype(np.int64)]
    f1 = _black()

    for m in range(la):
        n1 = m + lw
        n2 = m + up + 1
        n0 = max(n1, 0)
        n9 = min(n2, lb)
        f1[:] = _black()
        qprof = mtx_a[m]
        for n in range(n0, n9):
            r = n - m
            i = idx(r)
            h = H[i]
            g = G[i]
            diag = h[V]
            dab = float(qprof[b[n]])
            # diagonal: gapopen(d3=0) == 0 for SwgDPunit
            h[V] = h[V] + dab
            h[D] = DIAG if (h[D] & 15) in _IS_DIAG else NEWD
            mx = g
            if m > 0:
                # vertical
                frm = H[i + 1]
                gv = G[i + 1]
                gnp = gop_ if (gv[D] & 15) in _IS_DIAG else 0.0
                gop = gop_ if (frm[D] & 15) in _IS_DIAG else 0.0
                if (frm[D] & 15) not in _IS_VERT and \
                        frm[V] + gop > gv[V] + gnp:
                    g[:] = frm[:]
                    g[V] += gop
                else:
                    src = gv
                    g[:] = src[:]
                    g[V] += gnp
                g[D] = VERT
                if r < g[LWR]:
                    g[LWR] = r
                g[V] += gep_
            if n > 0:
                # horizontal
                frm = H[i - 1]
                gnp = gop_ if (f1[D] & 15) in _IS_DIAG else 0.0
                gop = gop_ if (frm[D] & 15) in _IS_DIAG else 0.0
                if (frm[D] & 15) not in _IS_HORI and \
                        frm[V] + gop > f1[V] + gnp:
                    f1[:] = frm[:]
                    f1[V] += gop
                else:
                    f1[V] += gnp
                f1[D] = HORI
                if r > f1[UPR]:
                    f1[UPR] = r
                f1[V] += gep_
                if f1[V] >= mx[V]:
                    mx = f1

            # find optimal path (fwd2c.h:577)
            if mx[V] > h[V]:
                h[:] = mx[:]
                if h[LWR] > r:
                    h[LWR] = r
                if h[UPR] < r:
                    h[UPR] = r
            elif h[V] > diag:
                if diag == 0:               # new local start
                    h[UPR] = h[LWR] = r
                    h[MLB] = m
                    h[NLB] = n
                if h[V] > cc0.val:          # global best tracker
                    cc0.val = h[V]
                    cc0.mrb = m + 1
                    cc0.nrb = n + 1
                    cc0.lwr = h[LWR]
                    cc0.upr = h[UPR]
                    cc0.mlb = h[MLB]
                    cc0.nlb = h[NLB]
            if h[V] < 0:                    # reset to blank
                # (reference clears f1 twice and leaves g: fwd2c.h:603)
                h[:] = _blank()
                f1[:] = _blank()
                h[CL] = 0
            if mlt > 1 and h[V] >= thr and not h[CL]:
                if len(colonies) - 1 < no_out:
                    colonies.append(Colony(len(colonies)))
                    h[CL] = len(colonies) - 1
            cl = h[CL]
            if cl:
                cc = colonies[cl]
                if h[V] > cc.val:
                    cc.val = h[V]
                    cc.mrb = m + 1
                    cc.nrb = n + 1
                    cc.lwr = h[LWR]
                    cc.upr = h[UPR]
                    cc.mlb = h[MLB]
                    cc.nlb = h[NLB]
                elif h[V] <= cc.val - thr:  # X-drop
                    h[:] = _blank()
                    f1[:] = _blank()
                    g[:] = _blank()
                    h[CL] = 0

    if mlt == 2:
        _remove_overlap(colonies, allowed_overlap)
    # sortcolonies (aln2.cc:368): by score desc; cc0 participates when
    # no other colony exists
    live = [c for c in colonies[1:] if c.val > 0]
    if not live:
        live = [cc0] if cc0.val > 0 else []
    live.sort(key=lambda c: -c.val)
    return live


def _remove_overlap(colonies, allowed=5):
    """detectoverlap/removeoverlap (aln2.cc:352-394)."""
    live = sorted((c for c in colonies[1:] if c.val > 0),
                  key=lambda c: c.mrb)
    for i in range(len(live) - 1, 0, -1):
        cc = live[i]
        if cc.mark < 0:
            continue
        for j in range(i - 1, -1, -1):
            cw = live[j]
            if cw.mrb <= cc.mlb + allowed:
                break
            if cw.mark < 0:
                continue
            if (cc.mrb - cw.mlb > allowed and
                    cc.nrb - cw.nlb > allowed and
                    cw.nrb - cc.nlb > allowed):
                if cc.val < cw.val:
                    cc.mark = -1
                else:
                    cw.mark = -1
    for c in live:
        if c.mark < 0:
            c.val = 0.0
