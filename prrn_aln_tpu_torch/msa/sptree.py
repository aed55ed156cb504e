"""Tree-structured weighted sum-of-pairs scoring (Sptree).

Reference: ``Sptree::sptree`` / ``calcscore_grp`` (src/fspscore.cc:
624-659, 783-860) — instead of scoring all N(N-1)/2 row pairs
independently, walk the guide tree once: every internal node scores its
left subtree against its right subtree in one vectorized column pass,
with member weights rescaled by the node's volume.  Three-point pair
weights factorize exactly over the LCA (``pwt[i,j] =
wheight[i]*wheight[j] / vol[lca]^2``, phyl.cc:703-786), so the result
equals the naive ``wsp.wsp_score(pairwt=...)`` to float precision while
replacing the per-pair Python loop with per-node einsums (the
substitution term is one frequency-profile contraction per node — MXU
shaped) and a broadcast gap-run comparison (the ``crg`` counting of
maln2.cc:510-530 evaluated on precomputed per-row gap-run lengths).

The reference validates the same equivalence with its built-in
TST_PS_ALG harness (fspscore.cc:924-991); tests/test_sptree.py mirrors
that comparison.
"""

from __future__ import annotations

import numpy as np

from .. import alphabet as ab
from .msa import Msa
from .tree import Tree, upgma, calc_pair_weights
from .distance import msa_distance_matrix


def _run_lengths(gap: np.ndarray) -> np.ndarray:
    """gl[i, c] = length of row i's gap run ending at column c-1
    (0 at c=0; reset after each residue).  Vectorized: run length at c
    = c - (last residue column <= c)."""
    n, L = gap.shape
    idx = np.arange(L)
    last_res = np.maximum.accumulate(
        np.where(~gap, idx[None, :], -1), axis=1)
    run_incl = (idx[None, :] - last_res).astype(np.int32)
    gl = np.zeros((n, L), np.int32)
    gl[:, 1:] = run_incl[:, :-1]
    return gl


def sptree_wsp(msa: Msa, mtx: np.ndarray, v: float,
               tree: Tree | None = None, spb: float = 0.0,
               col_chunk: int = 512):
    """Exact WSP with three-point pair weights, computed tree-wise.
    Returns (score, pairwt) so callers can reuse the weights."""
    n = msa.many
    codes = msa.codes
    L = msa.length
    if tree is None:
        d = msa_distance_matrix(codes)
        tree = upgma(d, n)
    pairwt, wheight, vol, cur = calc_pair_weights(tree, full=True)

    gap = codes <= ab.GAP
    res = ~gap
    gapf = gap.astype(np.float32)
    resf = res.astype(np.float32)
    gl = _run_lengths(gap)                      # (n, L) entering state
    dim = mtx.shape[0]
    gg = float(mtx[ab.GAP, ab.GAP])
    # one-hot row images, built once: OH[i] = (L, dim)
    OH = np.eye(dim, dtype=np.float32)[codes]
    mtx32 = mtx.astype(np.float32)

    def leaves_under(node):
        out, stack = [], [node]
        while stack:
            k = stack.pop()
            if tree.is_leaf(k):
                out.append(k)
            else:
                stack.append(tree.left[k])
                stack.append(tree.right[k])
        return out

    total = 0.0
    stack = [tree.root]
    order = []
    while stack:
        k = stack.pop()
        if not tree.is_leaf(k):
            order.append(k)
            stack.append(tree.left[k])
            stack.append(tree.right[k])

    for node in order:
        ll = leaves_under(tree.left[node])
        rr = leaves_under(tree.right[node])
        fl = wheight[ll] / vol[node]
        fr = wheight[rr] / vol[node]

        # substitution term: per-column weighted frequency contraction
        fl32 = fl.astype(np.float32)
        fr32 = fr.astype(np.float32)
        FL = np.tensordot(fl32, OH[ll], axes=(0, 0))     # (L, dim)
        FR = np.tensordot(fr32, OH[rr], axes=(0, 0))
        sub = float(np.einsum("lc,cd,ld->", FL, mtx32, FR))
        if gg != 0.0:
            # remove the both-gap pairs the projection drops
            wgl = fl32 @ gapf[ll]
            wgr = fr32 @ gapf[rr]
            sub -= gg * float(wgl @ wgr)

        # gap opens (crg counting): pair (i gap, j res) opens at c iff
        # gl_j >= gl_i entering c (the whole of i's run so far was
        # dropped as both-gap)
        # gap opens (crg counting): pair (i gap, j res) opens at c iff
        # glR_j >= glL_i entering c; pair (i res, j gap) opens iff
        # glR_j <= glL_i.  Bucketing members by run-length value turns
        # the (nl, nr, L) comparison cube into O(#distinct-runlen)
        # column passes — the gfq "hetero" economy of fspscore.cc
        wgapL = fl32[:, None] * gapf[ll]
        wresL = fl32[:, None] * resf[ll]
        wgapR = fr32[:, None] * gapf[rr]
        wresR = fr32[:, None] * resf[rr]
        glL = gl[ll]
        glR = gl[rr]
        vals = np.unique(np.concatenate([glL.ravel(), glR.ravel()]))
        nv = len(vals)
        colL = np.broadcast_to(np.arange(L), glL.shape)
        colR = np.broadcast_to(np.arange(L), glR.shape)
        rkL = np.searchsorted(vals, glL)
        rkR = np.searchsorted(vals, glR)

        def hist(rk, col, w):
            flat = np.bincount((rk * L + col).ravel(),
                               weights=w.ravel().astype(np.float64),
                               minlength=nv * L)
            return flat.reshape(nv, L).astype(np.float32)

        HgL = hist(rkL, colL, wgapL)          # sum wgapL [glL == v]
        HrL = hist(rkL, colL, wresL)
        HgR = hist(rkR, colR, wgapR)
        HrR = hist(rkR, colR, wresR)
        # reverse-cum over v: sum wresR [glR >= v]; forward-cum:
        # sum wgapR [glR <= v]
        ge = np.cumsum(HrR[::-1], axis=0)[::-1]
        le = np.cumsum(HgR, axis=0)
        opensA = float(np.sum(HgL * ge))
        opensB = float(np.sum(HrL * le))
        sub -= v * (opensA + opensB)
        total += sub

    if spb > 0 and msa.eij is not None:
        from .sigii import sp_sigii
        total += sp_sigii(codes, msa.eij, pairwt, spb, msa.step)
    return total, pairwt
