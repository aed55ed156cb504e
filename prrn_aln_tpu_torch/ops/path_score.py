"""Score a fixed alignment path (SKL) under the group DP cost model.

The analog of the reference's ``PreSpScore::calcSpScore``
(src/fspscore.cc:544-622): walk the path applying the same similarity,
unpaired-extension and pairwise gap-open terms as the DP cells, without
realigning.  Used to evaluate delta-WSP during refinement and to verify
that two tie-equivalent DP paths score identically.

Also accumulates FSTAT-style match/mismatch/gap/unpaired counts
(reference stt22 family, maln2.cc:624-760).
"""

from __future__ import annotations

import numpy as np

from ..msa.msa import Msa
from ..utils import trace
from .group_np import _col_arrays


def skl_to_moves(skl):
    """Expand SKL vertices into per-step moves: 0=diag, 1=vert, 2=hori."""
    moves = []
    for (m0, n0), (m1, n1) in zip(skl[:-1], skl[1:]):
        dm, dn = m1 - m0, n1 - n0
        if dm and dn:
            if dm != dn:
                raise ValueError(f"bad skl segment {(m0, n0)}->{(m1, n1)}")
            moves += [0] * dm
        elif dm:
            moves += [1] * dm
        elif dn:
            moves += [2] * dn
    return moves


def score_path(A: Msa, B: Msa, mtx: np.ndarray, skl, u: float, v: float,
               scale: float = 1.0) -> float:
    """DP-model score of the alignment defined by ``skl``."""
    with trace.span("prrn.score_path"):
        an, bn = A.many, B.many
        wa = (A.weight if A.weight is not None
              else np.ones(an)).astype(np.float64)
        wb = (B.weight if B.weight is not None
              else np.ones(bn)).astype(np.float64)
        GOP = -scale * v

        # the profile products at the path's diagonal moves alone, in path
        # order, by the whole La x Lb image's three-operand einsum (no
        # optimize, no factoring), so that each sums over (c, d) in the
        # image's order: the refinement accepts a candidate on this
        # score, and one ulp would change the alignment
        moves = skl_to_moves(skl)
        steps = np.asarray(moves, np.int64)
        advm, advn = steps != 2, steps != 1
        diag = steps == 0
        dm = (np.cumsum(advm) - advm)[diag]
        dn = (np.cumsum(advn) - advn)[diag]
        sdiag = np.einsum("kc,cd,kd->k", A.freq[dm].astype(np.float64),
                          mtx.astype(np.float64),
                          B.freq[dn].astype(np.float64))
        trace.COUNTS["score_path.cells"] += len(sdiag)

        na, gda, pga = _col_arrays(A)
        nb, gdb, pgb = _col_arrays(B)
        cfa, efa = A.cfq[:A.length + 1], A.efq[:A.length + 1]
        cfb, efb = B.cfq[:B.length + 1], B.efq[:B.length + 1]

        gla = np.zeros(an, np.int64)
        glb = np.zeros(bn, np.int64)
        agap = ~(na.astype(bool))
        bgap = ~(nb.astype(bool))

        def crg(mcol, ncol, d3):
            ge = gla[:, None] >= glb[None, :]
            if d3 == 0:
                le = glb[None, :] >= gla[:, None]
                t1 = ((wa * na[mcol])[:, None] * ge *
                      (wb * gdb[ncol])[None, :]).sum()
                t2 = ((wa * gda[mcol])[:, None] * le *
                      (wb * nb[ncol])[None, :]).sum()
                return (t1 + t2) * GOP
            if d3 > 0:
                return ((wa * na[mcol])[:, None] * ge *
                        (wb * pgb[ncol])[None, :]).sum() * GOP
            le = glb[None, :] >= gla[:, None]
            return ((wa * pga[mcol])[:, None] * le *
                    (wb * nb[ncol])[None, :]).sum() * GOP

        total = 0.0
        m = n = j = 0
        for mv in moves:
            if mv == 0:
                mcol, ncol = m + 1, n + 1
                total += sdiag[j] + crg(mcol, ncol, 0)
                j += 1
                gla = np.where(agap[mcol], gla + 1, 0)
                glb = np.where(bgap[ncol], glb + 1, 0)
                m, n = m + 1, n + 1
            elif mv == 1:
                mcol, ncol = m + 1, n
                total += crg(mcol, ncol, +1) + cfa[mcol] * efb[ncol] * -u
                gla = np.where(agap[mcol], gla + 1, 0)
                glb = glb + 1
                m += 1
            else:
                mcol, ncol = m, n + 1
                total += crg(mcol, ncol, -1) + cfb[ncol] * efa[mcol] * -u
                gla = gla + 1
                glb = np.where(bgap[ncol], glb + 1, 0)
                n += 1
        return float(total)
