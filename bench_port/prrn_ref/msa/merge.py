"""Merging alignments along a DP path (reference syntheseq/aggregate,
maln2.cc:2027-2046, mgaps.cc:282-384)."""

from __future__ import annotations

import numpy as np

from .. import alphabet as ab
from .msa import Msa


def merge_msas(A: Msa, B: Msa, skl) -> Msa:
    """Build the joint MSA of A and B along the SKL path: diagonal steps
    take a column from each side; vertical steps pad B with gaps,
    horizontal steps pad A."""
    from ..ops.path_score import skl_to_moves
    moves = skl_to_moves(skl)
    L = len(moves)
    many = A.many + B.many
    out = np.full((many, L), ab.GAP, np.int8)
    m = n = 0
    for c, mv in enumerate(moves):
        if mv == 0:
            out[:A.many, c] = A.codes[:, m]
            out[A.many:, c] = B.codes[:, n]
            m += 1
            n += 1
        elif mv == 1:
            out[:A.many, c] = A.codes[:, m]
            m += 1
        else:
            out[A.many:, c] = B.codes[:, n]
            n += 1
    names = list(A.names) + list(B.names)
    weight = None
    if A.weight is not None and B.weight is not None:
        weight = np.concatenate([A.weight, B.weight])
    eij = None
    if A.eij is not None or B.eij is not None:
        eij = list(A.eij or [None] * A.many) + list(B.eij or [None] * B.many)
    return Msa(codes=out, molc=A.molc, names=names, weight=weight,
               tgapf=A.tgapf, eij=eij)


def group_pair_fstat(codes, an: int, gap: int):
    """Cross-group FSTAT of a merged two-group alignment: weighted-pair
    identity statistics the reference prints on its `Score =` line
    (maln2.cc stt22i per-column counts, fspscore.cc newgap opens,
    PwdM::rescale normalization by Vab = an*bn).

    codes: (an+bn, L) merged rows; returns dict with mch/mmc/unp/gap
    (already divided by Vab) and vab."""
    import numpy as np
    A = codes[:an]
    B = codes[an:]
    bn = B.shape[0]
    resA = A > gap
    resB = B > gap
    gapA = ~resA
    gapB = ~resB
    # column-pair counts (stt22i): for each non-gap b residue, compare
    # against every a row; one-sided gaps count as unpaired
    eq = A[:, None, :] == B[None, :, :]
    mch = float((eq & resB[None, :, :] & resA[:, None, :]).sum())
    mmc = float(((~eq) & resB[None, :, :] & resA[:, None, :]).sum())
    unp = float((gapA[:, None, :] & resB[None, :, :]).sum()
                + (resA[:, None, :] & gapB[None, :, :]).sum())
    # gap opens per cross pair on the pair-projected alignment
    opens = 0
    for i in range(an):
        for j in range(bn):
            keep = resA[i] | resB[j]
            sa = gapA[i][keep]
            sb = gapB[j][keep]
            for s in (sa, sb):
                if len(s):
                    opens += int(s[0]) + int((s[1:] & ~s[:-1]).sum())
    vab = an * bn
    return dict(mch=mch / vab, mmc=mmc / vab, unp=unp / vab,
                gap=float(opens) / vab, vab=vab)
