"""NumPy reference implementation of the banded anti-diagonal wavefront DP.

Score-only affine-gap (Gotoh) pairwise alignment, scanned in anti-diagonal
order exactly as the compute kernel does on TPU.  This is the numerical
oracle for the JAX/Pallas kernels; its arithmetic reproduces the reference's
wavefront scorer (reference: src/fwd2d1.cc:57-161 forwardD/swgforwardD and
lastD) cell for cell.

State is three band vectors H/F/G indexed by diagonal r = n - m over slots
[lw-1, up+1] (two sentinel slots).  Each anti-diagonal step updates the
slots whose parity matches d; untouched slots carry either the permanent
sentinels or the boundary-condition values laid down at initialization,
which is exactly when they are consumed.
"""

from __future__ import annotations

import numpy as np

from .window import Window

NEG_SENT = np.float32(-(2 ** 31 // 8) * 7)   # reference NEG_INT
NEVSEL = np.float32(-1.0e30)                 # "never selected"


def pairwise_score_np(
    a: np.ndarray,
    b: np.ndarray,
    mtx: np.ndarray,
    u: float,
    v: float,
    wdw: Window,
    tgapf: float = 1.0,
    exgl_a: bool = False,
    exgr_a: bool = False,
    exgl_b: bool = False,
    exgr_b: bool = False,
    local: bool = False,
) -> float:
    """Score two encoded sequences (full ranges, 0-based).

    ``exg*`` free terminal gaps per side mirror ``algmode.lcl`` bits 0-3;
    ``local`` mirrors bit 4 (SWG).
    """
    la, lb = len(a), len(b)
    lw, up = wdw.lw, wdw.up
    nslot = up - lw + 3                    # r in [lw-1, up+1]
    off = -(lw - 1)                        # slot index of r

    r_all = np.arange(lw - 1, up + 2)
    hh = np.zeros(nslot, dtype=np.float32)
    ff = np.full(nslot, NEVSEL, dtype=np.float32)
    gg = np.full(nslot, NEVSEL, dtype=np.float32)

    # --- boundary conditions (fwd2d1.cc:66-89) -----------------------------
    # positive r side = leading gap in a (b runs ahead)
    if not exgl_a:
        pos = r_all > 0
        hh[pos] = -(v + r_all[pos] * u) * tgapf
    # negative r side = leading gap in b
    if not exgl_b:
        neg = r_all < 0
        hh[neg] = -(v - r_all[neg] * u) * tgapf
    hh[0] = 0.0
    hh[off + lw - 1] = NEG_SENT
    hh[off + up + 1] = NEG_SENT

    uu = np.float32(u)
    vv = np.float32(v)
    maxh = NEVSEL

    for d in range(la + lb - 1):
        m_vec = (d - r_all) >> 1
        n_vec = d - m_vec
        valid = (
            ((d - r_all) % 2 == 0)
            & (m_vec >= 0) & (m_vec < la)
            & (n_vec >= 0) & (n_vec < lb)
            & (r_all >= lw) & (r_all <= up)
        )
        mc = np.clip(m_vec, 0, la - 1)
        nc = np.clip(n_vec, 0, lb - 1)
        s = mtx[a[mc], b[nc]].astype(np.float32)

        h_lo = np.concatenate(([NEG_SENT], hh[:-1]))   # hh[r-1]
        f_lo = np.concatenate(([NEVSEL], ff[:-1]))     # ff[r-1]
        h_hi = np.concatenate((hh[1:], [NEG_SENT]))    # hh[r+1]
        g_hi = np.concatenate((gg[1:], [NEVSEL]))      # gg[r+1]

        f_new = np.maximum(h_lo - vv, f_lo) - uu
        g_new = np.maximum(h_hi - vv, g_hi) - uu
        h_new = np.maximum(np.maximum(hh + s, f_new), g_new)
        if local:
            h_new = np.maximum(h_new, 0.0)

        hh = np.where(valid, h_new, hh)
        ff = np.where(valid, f_new, ff)
        gg = np.where(valid, g_new, gg)
        if local:
            m = np.max(np.where(valid, h_new, NEVSEL))
            maxh = max(maxh, m)

    if local:
        return float(maxh)
    return float(_last_d(hh, r_all, la, lb, u, v, tgapf, exgr_a, exgr_b))


def _last_d(hh, r_all, la, lb, u, v, tgapf, exgr_a, exgr_b):
    """Terminal-gap discounting along the final row/column in closed form:
    ending the path early at the last column/row adds a discounted trailing
    gap -(v + k*u) * f, so each side contributes candidates
    hh[r'] - (v + |r' - r_end| * u) * f over its range.

    Mirrors lastB_ng (fwd2b1.cc:100-143), which walks the last anti-diagonal
    accumulating GapPenalty(1)/GapExtPen per step; the wavefront scorer's
    own lastD (fwd2d1.cc:96-135) carries a sign quirk (positive gpn) that is
    unreachable with the shipped defaults (tgapf == 1 skips the pass,
    exgr forces f == 0), so the sensible sign is used here.
    """
    r_end = lb - la
    best = hh[np.searchsorted(r_all, r_end)]
    # trailing gap in b: path ends on the last column (r > r_end, r <= lb)
    f = 0.0 if exgr_b else tgapf
    if f < 1.0:
        sel = (r_all > r_end) & (r_all <= min(r_all[-1], lb))
        if sel.any():
            k = r_all[sel] - r_end
            cand = hh[sel] - (np.float32(f) * (v + k * u)).astype(np.float32)
            best = max(best, float(np.max(cand)))
    # trailing gap in a: path ends on the last row (r < r_end, r >= -la)
    f = 0.0 if exgr_a else tgapf
    if f < 1.0:
        sel = (r_all < r_end) & (r_all >= max(r_all[0], -la + 1))
        if sel.any():
            k = r_end - r_all[sel]
            cand = hh[sel] - (np.float32(f) * (v + k * u)).astype(np.float32)
            best = max(best, float(np.max(cand)))
    return best
