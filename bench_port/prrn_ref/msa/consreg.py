"""Conserved/variable region segmentation (Gotoh 1993 GIW).

For every tree-edge bipartition of the MSA, scan the columns with a
local-alignment-style running score of the cross-group column similarity
(local params u=3, v=10, thr=35); keep maximal "conserved islands" whose
score exceeds thr * weight.  Columns conserved under EVERY bipartition
stay frozen; the complement — the "attack ranges" — are re-aligned during
refinement (reference: src/consreg.cc Conserved2/constwo :175-230,
Ssrel::consreg :484-517).

The column scores are pure per-column vector work (profile dot products
plus the pairwise gap-open term) — one device pass per bipartition; the
island scan is a cheap host loop.
"""

from __future__ import annotations

import numpy as np

from .. import alphabet as ab
from .msa import Msa
from .tree import Tree
from .refine import leaves_under

# local alignment parameters (consreg.cc:39-40 localprm, prrn5 defaults
# set via set_localprm(3, 10, 35); prrn5.cc:61-63)
LOCAL_U = 3.0
LOCAL_V = 10.0
LOCAL_THR = 35.0


def _column_scores(joint: np.ndarray, rows_a, rows_b, mtx, wa, wb,
                   u: float, v: float) -> np.ndarray:
    """Cross-group column scores s[c] = freq_a[c]' M freq_b[c] + gap-open
    correction, the cons2 column term."""
    L = joint.shape[1]
    dim = mtx.shape[0]
    A = joint[rows_a]
    B = joint[rows_b]
    fa = np.zeros((L, dim))
    fb = np.zeros((L, dim))
    for i, w in zip(range(A.shape[0]), wa):
        np.add.at(fa, (np.arange(L), A[i].astype(np.int64)), w)
    for i, w in zip(range(B.shape[0]), wb):
        np.add.at(fb, (np.arange(L), B[i].astype(np.int64)), w)
    sim = np.einsum("lc,cd,ld->l", fa, mtx.astype(np.float64), fb)

    # pairwise gap-open term along columns (crg d3=0 with running gla/glb)
    ga = np.zeros(A.shape[0], np.int64)
    gb = np.zeros(B.shape[0], np.int64)
    gop = np.zeros(L)
    agap = A <= ab.GAP
    bgap = B <= ab.GAP
    for c in range(L):
        ag = agap[:, c]
        bg = bgap[:, c]
        ge = ga[:, None] >= gb[None, :]
        le = gb[None, :] >= ga[:, None]
        t1 = ((wa * ~ag)[:, None] * ge * (wb * bg)[None, :]).sum()
        t2 = ((wa * ag)[:, None] * le * (wb * ~bg)[None, :]).sum()
        gop[c] = -(t1 + t2) * v
        ga = np.where(ag, ga + 1, 0)
        gb = np.where(bg, gb + 1, 0)
    return sim + gop


def conserved_islands(scores: np.ndarray, vthr: float) -> list[tuple[int, int]]:
    """Running-score island scan (consreg.cc cons2_* inner loop)."""
    scr = mxv = 0.0
    left = right = 0
    out = []
    for i, s in enumerate(scores):
        if scr == 0 and s > 0:
            left = i
        scr += s
        if scr < 0:
            scr = 0.0
        elif scr >= vthr and scr > mxv:
            mxv = scr
            right = i + 1
        if mxv > 0 and (scr <= 0 or scr < mxv - vthr):
            out.append((left, right))
            mxv = scr = 0.0
    if scr >= vthr and mxv > 0:
        out.append((left, right))
    return out


from .css import cmnrng as _intersect


def _complement(full: tuple[int, int], ranges: list[tuple[int, int]]):
    from .css import complerng
    return complerng(full, ranges)


def attack_ranges(msa: Msa, tree: Tree, mtx,
                  u: float = LOCAL_U, v: float = LOCAL_V,
                  thr: float = LOCAL_THR) -> list[tuple[int, int]]:
    """Dissimilar column ranges to re-align (Ssrel::consreg with DISSIM)."""
    n = msa.many
    joint = msa.codes
    w = (msa.weight if msa.weight is not None else np.ones(n))
    sumwt = float(w.sum())
    L = msa.length
    united: list[tuple[int, int]] | None = None
    for tid in range(2 * n - 3):
        side1 = leaves_under(tree, tid)
        side0 = [k for k in range(n) if k not in set(side1)]
        if not side0 or not side1:
            continue
        wa = w[side0]
        wb = w[side1]
        s = _column_scores(joint, side0, side1, mtx, wa, wb, u, v)
        vthr = thr * float(wa.sum()) * float(wb.sum())
        isl = conserved_islands(s, vthr)
        united = isl if united is None else _intersect(united, isl)
        if not united:
            break
    if united is None:
        united = []
    return _complement((0, L), united)
