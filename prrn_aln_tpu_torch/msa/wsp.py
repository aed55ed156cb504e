"""Weighted sum-of-pairs (WSP) MSA scoring.

The refinement objective: sum over sequence pairs of the induced pairwise
alignment score (substitution matrix + affine gap penalties), weighted by
three-point pair weights (reference: src/fspscore.cc pairsum_ss/calcscore
family).  Columns where both members are gaps are skipped; unpaired
residues pick up the extension penalty through the matrix gap row
(mtx[x][gap] = -u) and each maximal gap run is charged one gap-open -v.

Host/NumPy implementation used as the comparison metric between candidate
alignments; the hot-path delta-WSP during refinement uses the path scorer
(ops/path_score) instead.
"""

from __future__ import annotations

import numpy as np

from .. import alphabet as ab
from .msa import Msa
from .distance import condensed_index


def pair_score(mtx: np.ndarray, row_a: np.ndarray, row_b: np.ndarray,
               v: float) -> float:
    """Score of the pairwise alignment induced by two MSA rows."""
    both_gap = (row_a <= ab.GAP) & (row_b <= ab.GAP)
    a = row_a[~both_gap]
    b = row_b[~both_gap]
    s = float(mtx[a, b].sum())
    # gap opens: maximal runs of gap in each row of the projection
    for r in (a, b):
        isg = r <= ab.GAP
        opens = int(isg[0]) + int((isg[1:] & ~isg[:-1]).sum()) if len(r) else 0
        s -= v * opens
    return s


def wsp_score(msa: Msa, mtx: np.ndarray, v: float,
              pairwt: np.ndarray | None = None,
              spb: float = 0.0) -> float:
    n = msa.many
    total = 0.0
    for j in range(1, n):
        for i in range(j):
            w = (pairwt[condensed_index(i, j)]
                 if pairwt is not None else 1.0)
            total += w * pair_score(mtx, msa.codes[i], msa.codes[j], v)
    if spb > 0 and msa.eij is not None:
        # intron-position bonus (gsinfo.cc:1147-1183 spSigII)
        from .sigii import sp_sigii
        total += sp_sigii(msa.codes, msa.eij, pairwt, spb, msa.step)
    return total
