"""NumPy reference implementation of the banded group-to-group DP.

Implements the "naive exact" gap-accounting tier: every cell carries the
current gap-run length of each member (``gla``/``glb``), and gap-open costs
count, for every member pair, whether the move opens a new gap —
weighted by sequence weights and terminal-gap densities.  This reproduces
the reference's ``DPunit_nv`` algebra (reference: src/fwd2c.cc:106-148,
src/maln2.cc crg22w/crg22i and friends) which the reference itself treats
as exact; its GFREQ profile tiers compute the same quantity faster for
wide MSAs (SURVEY.md A.2).

The scan is the reference's banded row scan (src/fwd2c.h:358-487
forwardB), including boundary initialization by marching the top row /
left column with the same gap machinery (initB) and the exact tie-breaking
order (diag beats non-diag ties; horizontal beats vertical ties), so
traceback paths are bit-identical.

Grid convention: cell (m', n') for m' in [0, La], n' in [0, Lb] is the
state after consuming m' columns of A and n' of B; column-indexed arrays
use index m'-1 with a boundary row at -1.
"""

from __future__ import annotations

import numpy as np

from ..msa.msa import Msa
from .window import Window

NEVSEL = -1.0e30

# lane codes for traceback
DIAG, VERT, HORI, VERT2, HORI2 = 0, 1, 2, 3, 4


def _col_arrays(msa: Msa):
    """Per-column member arrays with a boundary row prepended (index 0 =
    column -1): residue mask, gap density, post-gap density."""
    eff = msa.eff_codes
    L, many = msa.length, msa.many
    na = np.zeros((L + 1, many))
    na[1:] = (eff > 1).T
    gd = np.zeros((L + 1, many))
    gd[1:] = msa.gdens
    pg = np.ones((L + 1, many))
    pg[1:] = msa.pgdens
    # boundary column -1: sentinel written by exg_seq is gap (global) or
    # nil; gapdensity(gap)=1; postgapdensity at -1 = exgl? 0: tgapf if the
    # sentinel is nil (free/discount) else 1
    gl = msa.exgl or msa.tgapf < 1.0
    gd[0] = (0.0 if msa.exgl else msa.tgapf) if gl else 1.0
    pg[0] = (0.0 if msa.exgl else msa.tgapf) if gl else 1.0
    return na, gd, pg


def group_align_np(A: Msa, B: Msa, mtx: np.ndarray, u: float, v: float,
                   wdw: Window, scale: float = 1.0,
                   ls: int = 1, u1: float = 0.6, k1: int = 7,
                   spb: float = 0.0):
    """Banded group alignment.  Returns (score, skl) with skl a list of
    (m, n) path vertices from (0,0) to (La, Lb).

    ``ls=3`` enables the double-affine (long-gap) lane pair with slope u1
    and flex point k1 (reference PwdB LongGOP/LongGEP, aln.h:267-280,
    and the g2/f2 lanes of fwd2c.h forwardB)."""
    La, Lb = A.length, B.length
    an, bn = A.many, B.many
    wa = (A.weight if A.weight is not None else np.ones(an)).astype(np.float64)
    wb = (B.weight if B.weight is not None else np.ones(bn)).astype(np.float64)
    GOP = -scale * v           # Basic_GOP
    double_affine = ls >= 3
    # long-gap scalings (aln2.cc PwdB ctor): LongGOP/BasicGOP, LongGEP/BasicGEP
    v2divv1 = (v + (u - u1) * k1) / v if double_affine else 0.0
    u2divu1 = (u1 / u) if double_affine else 0.0
    codonk1 = k1 if double_affine else 10 ** 9
    lw, up = wdw.lw, wdw.up

    # column score table S[m', n'] for consumed columns (1-based)
    S = np.einsum("mc,cd,nd->mn", A.freq.astype(np.float64),
                  mtx.astype(np.float64), B.freq.astype(np.float64))

    # intron-position match bonus (fwd2c.h:306-312, gsinfo.h:221-229):
    # BD[m,n] = SpbFact * sum_p EA[m,p]*EB[n,p] added to the diagonal
    # candidate at cell (m+1,n+1); B0 (phase 0 only) to the winning gap
    # lane.  EA/EB are the per-codon-column junction densities.
    BD = B0 = None
    if spb > 0 and A.eijdns is not None and B.eijdns is not None:
        EA = A.eijdns[:La]
        EB = B.eijdns[:Lb]
        BD = scale * spb * (EA @ EB.T)
        B0 = scale * spb * np.outer(EA[:, 0], EB[:, 0])

    na, gda, pga = _col_arrays(A)     # index by m' (0 = boundary)
    nb, gdb, pgb = _col_arrays(B)
    # thickness with boundary: cfq/efq arrays index by consumed col (0=bdy)
    cfa, efa = A.cfq[:La + 1], A.efq[:La + 1]
    cfb, efb = B.cfq[:Lb + 1], B.efq[:Lb + 1]

    nslot = up - lw + 3
    off = -(lw - 1)

    def new_state():
        return {
            "val": np.full(nslot, NEVSEL),
            "dir": np.zeros(nslot, np.int8),       # 0 dead,1 diag,2 vert,3 hori
            "gla": np.zeros((nslot, an), np.int32),
            "glb": np.zeros((nslot, bn), np.int32),
        }

    H = new_state()
    G = new_state()
    G2 = new_state() if double_affine else None

    D_DIAG, D_VERT, D_HORI = 1, 2, 3

    def crg(gla, glb, mcol, ncol, d3):
        """Weighted new-gap count * GOP (crg22w semantics):
        a pair (i, j) opens a gap when the growing side's run length
        reaches the other's."""
        ge = gla[:, None] >= glb[None, :]          # (an, bn)
        if d3 == 0:
            le = glb[None, :] >= gla[:, None]
            t1 = ((wa * na[mcol])[:, None] * ge *
                  (wb * gdb[ncol])[None, :]).sum()
            t2 = ((wa * gda[mcol])[:, None] * le *
                  (wb * nb[ncol])[None, :]).sum()
            return (t1 + t2) * GOP
        if d3 > 0:    # vertical: gap grows in b
            return ((wa * na[mcol])[:, None] * ge *
                    (wb * pgb[ncol])[None, :]).sum() * GOP
        le = glb[None, :] >= gla[:, None]
        return ((wa * pga[mcol])[:, None] * le *
                (wb * nb[ncol])[None, :]).sum() * GOP

    agap = ~(na[:, :].astype(bool))   # per column m': True where member gap
    bgap = ~(nb[:, :].astype(bool))

    # traceback stores
    hsrc = np.zeros((La + 1, Lb + 1), np.int8)   # which lane won H
    gsrc = np.zeros((La + 1, Lb + 1), np.int8)   # 1 = opened from H
    fsrc = np.zeros((La + 1, Lb + 1), np.int8)
    g2src = np.zeros((La + 1, Lb + 1), np.int8)
    f2src = np.zeros((La + 1, Lb + 1), np.int8)

    # ---------------- boundary (initB) --------------------------------
    H["val"][off + 0] = 0.0
    H["dir"][off + 0] = D_DIAG
    # top row: grid (0, n'), r = n'
    rr = min(up, Lb)
    gla_run = np.zeros(an, np.int32)
    glb_run = np.zeros(bn, np.int32)
    prev_val, prev_dir = 0.0, D_DIAG
    prev_gla, prev_glb = gla_run.copy(), glb_run.copy()
    for npr in range(1, rr + 1):
        pub = cfb[npr] * efa[0] * -u
        gnp = crg(prev_gla, prev_glb, 0, npr, -1)
        if npr >= codonk1:
            val = prev_val + v2divv1 * gnp + u2divu1 * pub
        else:
            val = prev_val + gnp + pub
        gla_new = prev_gla + 1
        glb_new = np.where(bgap[npr], prev_glb + 1, 0)
        i = off + npr
        H["val"][i] = val
        H["dir"][i] = D_HORI
        H["gla"][i] = gla_new
        H["glb"][i] = glb_new
        hsrc[0, npr] = HORI
        prev_val, prev_gla, prev_glb = val, gla_new, glb_new
    # left column: grid (m', 0), r = -m'
    rr = max(lw, -La)
    prev_val = 0.0
    prev_gla, prev_glb = np.zeros(an, np.int32), np.zeros(bn, np.int32)
    for mpr in range(1, -rr + 1):
        pua = cfa[mpr] * efb[0] * -u
        gnp = crg(prev_gla, prev_glb, mpr, 0, +1)
        if mpr >= codonk1:
            val = prev_val + v2divv1 * gnp + u2divu1 * pua
        else:
            val = prev_val + gnp + pua
        gla_new = np.where(agap[mpr], prev_gla + 1, 0)
        glb_new = prev_glb + 1
        i = off - mpr
        H["val"][i] = val
        H["dir"][i] = D_VERT
        H["gla"][i] = gla_new
        H["glb"][i] = glb_new
        hsrc[mpr, 0] = VERT
        prev_val, prev_gla, prev_glb = val, gla_new, glb_new

    # ---------------- main row scan (forwardB) -------------------------
    for m in range(La):           # consuming a column m (grid row m+1)
        n_lo = max(m + 1 + lw, 1)     # n' range for this grid row
        n_hi = min(m + 1 + up, Lb)
        if n_lo > n_hi:
            continue
        mcol = m + 1
        f_val = NEVSEL
        f_dir = 0
        f_gla = np.zeros(an, np.int32)
        f_glb = np.zeros(bn, np.int32)
        f2_val = NEVSEL
        f2_gla = np.zeros(an, np.int32)
        f2_glb = np.zeros(bn, np.int32)
        for npr in range(n_lo, n_hi + 1):
            ncol = npr
            r = npr - mcol
            i = off + r
            # --- diagonal from H[i] (holds grid (m, npr-1)) -------------
            hp_val = H["val"][i]
            hp_dir = H["dir"][i]
            s = S[m, npr - 1]
            gop = crg(H["gla"][i], H["glb"][i], mcol, ncol, 0)
            d_val = hp_val + s + gop
            d_gla = np.where(agap[mcol], H["gla"][i] + 1, 0)
            d_glb = np.where(bgap[ncol], H["glb"][i] + 1, 0)
            d_dir = D_DIAG

            # --- vertical lane (skip on first grid row) ----------------
            best_lane = None
            if mcol > 1 and i + 1 < nslot:
                pua = cfa[mcol] * efb[ncol] * -u
                gnp = crg(G["gla"][i + 1], G["glb"][i + 1], mcol, ncol, +1)
                gop_v = crg(H["gla"][i + 1], H["glb"][i + 1], mcol, ncol, +1)
                open_ok = H["dir"][i + 1] != D_VERT
                if open_ok and (H["val"][i + 1] + gop_v >
                                G["val"][i + 1] + gnp):
                    g_val = H["val"][i + 1] + gop_v
                    g_gla = np.where(agap[mcol], H["gla"][i + 1] + 1, 0)
                    g_glb = H["glb"][i + 1] + 1
                    g_open = 1
                else:
                    g_val = G["val"][i + 1] + gnp
                    g_gla = np.where(agap[mcol], G["gla"][i + 1] + 1, 0)
                    g_glb = G["glb"][i + 1] + 1
                    g_open = 0
                g_val += pua
            else:
                g_val, g_gla, g_glb, g_open = NEVSEL, f_gla * 0, f_glb * 0, 0
            G["val"][i] = g_val
            G["dir"][i] = D_VERT
            G["gla"][i] = g_gla
            G["glb"][i] = g_glb
            gsrc[mcol, ncol] = g_open
            mx_val, mx_lane = g_val, VERT
            mx_gla, mx_glb = g_gla, g_glb

            # --- long vertical lane (g2) -------------------------------
            if G2 is not None and mcol > 1 and i + 1 < nslot:
                pua = cfa[mcol] * efb[ncol] * -u
                gnp2 = v2divv1 * crg(G2["gla"][i + 1], G2["glb"][i + 1],
                                     mcol, ncol, +1)
                gop2 = v2divv1 * crg(H["gla"][i + 1], H["glb"][i + 1],
                                    mcol, ncol, +1)
                open_ok = H["dir"][i + 1] != D_VERT
                if open_ok and (H["val"][i + 1] + gop2 >
                                G2["val"][i + 1] + gnp2):
                    g2_val = H["val"][i + 1] + gop2
                    g2_gla = np.where(agap[mcol], H["gla"][i + 1] + 1, 0)
                    g2_glb = H["glb"][i + 1] + 1
                    g2_open = 1
                else:
                    g2_val = G2["val"][i + 1] + gnp2
                    g2_gla = np.where(agap[mcol], G2["gla"][i + 1] + 1, 0)
                    g2_glb = G2["glb"][i + 1] + 1
                    g2_open = 0
                g2_val += u2divu1 * pua
                G2["val"][i] = g2_val
                G2["gla"][i] = g2_gla
                G2["glb"][i] = g2_glb
                g2src[mcol, ncol] = g2_open
                if g2_val > mx_val:
                    mx_val, mx_lane = g2_val, VERT2
                    mx_gla, mx_glb = g2_gla, g2_glb
            elif G2 is not None:
                G2["val"][i] = NEVSEL

            # --- horizontal lane (skip on first grid column) -----------
            if ncol > 1:
                pub = cfb[ncol] * efa[mcol] * -u
                gnp = crg(f_gla, f_glb, mcol, ncol, -1)
                # h[-1] = this row's previous H cell = grid (mcol, npr-1)
                # (or the left-boundary / sentinel slot at the row start)
                hm_val = H["val"][i - 1]
                hm_dir = H["dir"][i - 1]
                hm_gla = H["gla"][i - 1]
                hm_glb = H["glb"][i - 1]
                gop_h = crg(hm_gla, hm_glb, mcol, ncol, -1)
                open_ok = hm_dir != D_HORI
                if open_ok and (hm_val + gop_h > f_val + gnp):
                    f_val = hm_val + gop_h
                    f_gla = hm_gla + 1
                    f_glb = np.where(bgap[ncol], hm_glb + 1, 0)
                    f_open = 1
                else:
                    f_val = f_val + gnp
                    f_gla = f_gla + 1
                    f_glb = np.where(bgap[ncol], f_glb + 1, 0)
                    f_open = 0
                f_val += pub
                f_dir = D_HORI
                fsrc[mcol, ncol] = f_open
                if f_val >= mx_val:
                    mx_val, mx_lane = f_val, HORI
                    mx_gla, mx_glb = f_gla, f_glb

                # --- long horizontal lane (f2) -------------------------
                if G2 is not None:
                    gnp2 = v2divv1 * crg(f2_gla, f2_glb, mcol, ncol, -1)
                    gop2 = v2divv1 * crg(hm_gla, hm_glb, mcol, ncol, -1)
                    open_ok2 = hm_dir != D_HORI
                    if open_ok2 and (hm_val + gop2 > f2_val + gnp2):
                        f2_val = hm_val + gop2
                        f2_gla = hm_gla + 1
                        f2_glb = np.where(bgap[ncol], hm_glb + 1, 0)
                        f2_open = 1
                    else:
                        f2_val = f2_val + gnp2
                        f2_gla = f2_gla + 1
                        f2_glb = np.where(bgap[ncol], f2_glb + 1, 0)
                        f2_open = 0
                    f2_val += u2divu1 * pub
                    f2src[mcol, ncol] = f2_open
                    if f2_val >= mx_val:
                        mx_val, mx_lane = f2_val, HORI2
                        mx_gla, mx_glb = f2_gla, f2_glb

            # --- intron-position bonus (fwd2c.h:306-312): full-phase to
            # the diagonal candidate, phase-0 to the winning gap lane;
            # the reference mutates the lane record through its mx
            # pointer, so the gap-lane bonus persists into extensions.
            if BD is not None:
                bd = BD[m, npr - 1]
                if bd:
                    d_val += bd
                b0 = B0[m, npr - 1]
                if b0 and mx_val > NEVSEL / 2:
                    mx_val += b0
                    if mx_lane == VERT:
                        G["val"][i] += b0
                    elif mx_lane == VERT2:
                        G2["val"][i] += b0
                    elif mx_lane == HORI:
                        f_val += b0
                    else:
                        f2_val += b0

            # --- select -------------------------------------------------
            if mx_val > d_val:
                H["val"][i] = mx_val
                H["dir"][i] = (D_VERT if mx_lane in (VERT, VERT2)
                               else D_HORI)
                H["gla"][i] = mx_gla
                H["glb"][i] = mx_glb
                hsrc[mcol, ncol] = mx_lane
            else:
                H["val"][i] = d_val
                H["dir"][i] = d_dir
                H["gla"][i] = d_gla
                H["glb"][i] = d_glb
                hsrc[mcol, ncol] = DIAG

    score = H["val"][off + (Lb - La)]
    skl = _traceback(hsrc, gsrc, fsrc, La, Lb, g2src, f2src)
    return float(score), skl


def _traceback(hsrc, gsrc, fsrc, La, Lb, g2src=None, f2src=None):
    """Walk lanes back from (La, Lb); emit vertices at direction changes."""
    m, n = La, Lb
    moves = []          # list of lane codes walked (reversed)
    lane = "H"
    while m > 0 or n > 0:
        if lane == "H":
            src = hsrc[m, n]
            if src == DIAG:
                moves.append(DIAG)
                m, n = m - 1, n - 1
            elif src == VERT:
                lane = "G"
            elif src == VERT2:
                lane = "G2"
            elif src == HORI2:
                lane = "F2"
            else:
                lane = "F"
        elif lane in ("G", "G2"):
            opened = (gsrc if lane == "G" else g2src)[m, n]
            moves.append(VERT)
            m -= 1
            if opened or m == 0:
                lane = "H"
        else:
            opened = (fsrc if lane == "F" else f2src)[m, n]
            moves.append(HORI)
            n -= 1
            if opened or n == 0:
                lane = "H"
    moves.reverse()
    # compress runs into SKL vertices
    skl = [(0, 0)]
    m = n = 0
    prev = None
    for mv in moves:
        if mv != prev and prev is not None:
            skl.append((m, n))
        if mv == DIAG:
            m += 1
            n += 1
        elif mv == VERT:
            m += 1
        else:
            n += 1
        prev = mv
    skl.append((La, Lb))
    return skl
