"""Local alignment driver + display (aln -Ls).

Reference flow (aln.cc:288-314): swg1st finds colonies, each colony is
re-aligned inside its bounding box (swg2ndC) and printed with the
3-row pairwise display (two sequences + merged/consensus row,
sqpr.cc print2 with Row_Last).
"""

from __future__ import annotations

import numpy as np

from .. import alphabet as ab
from ..ops.local_np import swg_colonies
from ..ops.group_np import group_align_np
from ..ops.window import stripe
from .msa import Msa


def swg_align(a_codes, b_codes, mtx, u=2.0, v=6.0, sh=-50, thr=35.0,
              mlt=1, molc=ab.DNA):
    """Returns a list of (colony, score, skl) with skl in full-sequence
    coordinates."""
    out = []
    for c in swg_colonies(a_codes, b_codes, mtx, u=u, v=v, sh=sh,
                          thr=thr, mlt=mlt):
        A = Msa(codes=a_codes[None, c.mlb: c.mrb].copy(), molc=molc,
                names=["a"], exgl=True, exgr=True)
        B = Msa(codes=b_codes[None, c.nlb: c.nrb].copy(), molc=molc,
                names=["b"], exgl=True, exgr=True)
        w = stripe(A.length, B.length, sh)
        scr, skl = group_align_np(A.prepare(mtx.shape[0]),
                                  B.prepare(mtx.shape[0]), mtx, u, v, w)
        skl = [(m + c.mlb, n + c.nlb) for m, n in skl]
        out.append((c, scr, skl))
    return out


def _consensus_char(x: str, y: str, molc: int) -> str:
    if x == y:
        return x
    if x == " " or y == " ":
        return " "
    if molc == ab.DNA:
        cx = ab.encode(x if x != "-" else "-", ab.DNA)[0]
        cy = ab.encode(y if y != "-" else "-", ab.DNA)[0]
        union = ((int(cx) - 1) | (int(cy) - 1)) + 1
        return ab.NUCL_DECODE[union].lower()
    return x.lower()


def local_alignment_text(a_str, b_str, names, scr, skl, molc=ab.DNA,
                         u=2.0, v=6.0, match=2.0, mism=-4.0,
                         lpw=60) -> str:
    """One colony's 3-row blocked display (sqpr.cc print2, Row_Last)."""
    # build aligned rows (diagonal-first, like skl2gaps)
    ra, rb = [], []
    m, n = skl[0]
    for wm, wn in skl[1:]:
        dm, dn = wm - m, wn - n
        d = min(dm, dn)
        ra.append(a_str[m: m + d])
        rb.append(b_str[n: n + d])
        m += d
        n += d
        if dm > d:
            ra.append(a_str[m: wm])
            rb.append("-" * (dm - d))
        elif dn > d:
            ra.append("-" * (dn - d))
            rb.append(b_str[n: wn])
        m, n = wm, wn
    rowa = "".join(ra)
    rowb = "".join(rb)

    mch = sum(1 for x, y in zip(rowa, rowb)
              if x == y and x != "-")
    mmc = sum(1 for x, y in zip(rowa, rowb)
              if x != y and x != "-" and y != "-")
    unp = sum(1 for x, y in zip(rowa, rowb) if x == "-" or y == "-")
    runs = 0
    for row in (rowa, rowb):
        ing = False
        for ch in row:
            if ch == "-" and not ing:
                runs += 1
                ing = True
            elif ch != "-":
                ing = False
    span = mch + mmc + unp
    pct = 100.0 * mch / span if span else 0.0

    la, lb = len(a_str), len(b_str)
    out = ["", f">{names[0]} [1:{la}]  ( 1 - {la} ) - "
               f">{names[1]} [1:{lb}]  ( 1 - {lb} ) - > [0:0]  ( 1 - 0 )"]
    out.append("s[=] (%.1f), s[#] (%.1f), u = %.1f, v = %.1f"
               % (match, mism, u, v))
    out.append("Score = %5.1f (%5.1f), %.1f (=), %.1f (#), %.1f (g), "
               "%.1f (u), (%5.2f %%)"
               % (scr, scr, float(mch), float(mmc), float(runs),
                  float(unp), pct))
    out.append("ALIGNMENT   1 / 1")
    text = "\n".join(out) + "\n"

    na, nb = skl[0][0], skl[0][1]
    for z in range(0, len(rowa), lpw):
        sega = rowa[z: z + lpw]
        segb = rowb[z: z + lpw]
        cons = "".join(_consensus_char(x, y, molc)
                       for x, y in zip(sega, segb))
        text += "\n"
        text += "%8d %s| %s\n" % (na + 1, sega.ljust(lpw), names[0])
        text += "%8d %s| %s\n" % (nb + 1, segb.ljust(lpw), names[1])
        text += "\t %s\n" % cons.ljust(lpw)
        na += sum(1 for c in sega if c != "-")
        nb += sum(1 for c in segb if c != "-")
    text += "\n\n"
    return text
