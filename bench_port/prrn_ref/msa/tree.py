"""Guide trees and tree-derived sequence weights.

UPGMA clustering with electrical-network "resistance" bookkeeping, plus the
Gotoh (1995) three-point weights: per-sequence weights from a current-flow
(Kirchhoff) pass and pair weights from a recursive flow split.  Host-side
NumPy — guide trees are tiny next to the DP work.

Reference semantics: src/phyl.cc upg_method (:943-1027), kirchhof
(:637-650), calcwt (:691-701), pairwt/calcpw (:703-786,813-827).
The scan order of the reference's nearest-neighbour bookkeeping is
reproduced so tie-breaking (and hence tree topology) matches exactly.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .distance import condensed_index

FEPS = 1e-7


@dataclasses.dataclass
class Tree:
    """Array-of-nodes binary tree; nodes [0, n) are leaves, the last node
    is the root.  Mirrors the reference's Knode fields."""
    n_leaves: int
    left: np.ndarray       # (2n-1,) child index or -1
    right: np.ndarray
    parent: np.ndarray     # (2n-1,) parent index or -1
    height: np.ndarray     # (2n-1,) f64
    length: np.ndarray     # branch length to parent
    res: np.ndarray        # subtree "resistance"
    ndesc: np.ndarray      # number of leaf descendants

    @property
    def root(self) -> int:
        return 2 * self.n_leaves - 2

    def is_leaf(self, i: int) -> bool:
        return self.left[i] < 0

    def postorder(self):
        """Iterative postorder from the root (children before parents)."""
        stack, out = [self.root], []
        while stack:
            i = stack.pop()
            out.append(i)
            if self.left[i] >= 0:
                stack.append(self.left[i])
                stack.append(self.right[i])
        return out[::-1]


def upgma(dist: np.ndarray, n: int,
          leaf_height: np.ndarray | None = None,
          leaf_res: np.ndarray | None = None,
          leaf_ndesc: np.ndarray | None = None) -> Tree:
    """UPGMA tree from a condensed distance array.

    ``leaf_*`` seed heights/resistances/sizes for leaves that are
    themselves profiles (reference: Ktree(msd, ss, UPG, lead) with
    preloaded lead nodes, prrn5.cc:344-375).
    """
    total = 2 * n - 1
    left = np.full(total, -1, np.int64)
    right = np.full(total, -1, np.int64)
    parent = np.full(total, -1, np.int64)
    height = np.zeros(total)
    length = np.zeros(total)
    res = np.zeros(total)
    ndesc = np.ones(total, np.int64)
    if leaf_height is not None:
        height[:n] = leaf_height
    if leaf_res is not None:
        res[:n] = leaf_res
    if leaf_ndesc is not None:
        ndesc[:n] = leaf_ndesc

    # full working distance matrix indexed by slot (original leaf index)
    D = np.full((n, n), np.inf)
    for j in range(1, n):
        for i in range(j):
            D[i, j] = D[j, i] = dist[condensed_index(i, j)]

    nodes = list(range(n))         # slot -> current node index
    row = list(range(n))           # active slots in reference scan order
    # nearest-neighbour init (phyl.cc:947-961)
    nnbr = [0] * n
    nnbr[0] = 1
    for m in range(n):
        for nn_ in range(m):
            if D[m, nn_] < D[m, nnbr[m]]:
                nnbr[m] = nn_
            if D[nn_, m] < D[nn_, nnbr[nn_]]:
                nnbr[nn_] = m

    m_new = n
    for nact in range(n - 1, 0, -1):
        # dminidx: first slot in row order with minimal D[ii, nnbr[ii]]
        ii = row[0]
        dmin = D[ii, nnbr[ii]]
        for k in range(1, nact + 1):
            jj_ = row[k]
            dij = D[jj_, nnbr[jj_]]
            if dij < dmin:
                ii, dmin = jj_, dij
        jj = nnbr[ii]

        root = m_new
        lnode, rnode = nodes[ii], nodes[jj]
        left[root], right[root] = lnode, rnode
        height[root] = dmin / 2.0
        length[lnode] = max(height[root] - height[lnode], 0.0)
        length[rnode] = max(height[root] - height[rnode], 0.0)
        rl = res[lnode] + height[root] - height[lnode]
        rr = res[rnode] + height[root] - height[rnode]
        res[root] = (rl * rr) / (rl + rr) if (rl > FEPS and rr > FEPS) else FEPS
        ndesc[root] = ndesc[lnode] + ndesc[rnode]
        parent[lnode] = parent[rnode] = root

        # UPGMA distance update + nnbr invalidation (phyl.cc:981-1015)
        nl, nr = ndesc[lnode], ndesc[rnode]
        jpos = 0
        nnbr[ii] = -1
        for k in range(nact + 1):
            kk = row[k]
            if kk == ii:
                continue
            if kk == jj:
                jpos = k
                continue
            x = (D[kk, ii] * nl + D[kk, jj] * nr) / (nl + nr)
            D[kk, ii] = D[ii, kk] = x
            if nnbr[kk] == ii or nnbr[kk] == jj:
                nnbr[kk] = -1
        nodes[ii] = root
        row[jpos] = row[nact]
        row.pop()
        D[jj, :] = np.inf
        D[:, jj] = np.inf
        for k in range(nact):
            kk = row[k]
            if nnbr[kk] < 0:
                # dminrow: rescan actives in row order
                best, bj = np.inf, kk
                for k2 in range(nact):
                    k2k = row[k2]
                    if k2k == kk:
                        continue
                    if D[kk, k2k] < best:
                        best, bj = D[kk, k2k], k2k
                nnbr[kk] = bj
        m_new += 1

    t = Tree(n, left, right, parent, height, length, res, ndesc)
    _teachparent(t)
    return t


def calc_seq_weights(tree: Tree) -> np.ndarray:
    """Per-leaf weights by the Kirchhoff current-flow pass
    (phyl.cc:637-650,691-701): wt_i = N * current_i."""
    total = 2 * tree.n_leaves - 1
    cur = np.zeros(total)
    vol = np.zeros(total)
    r = tree.root
    vol[r] = tree.res[r]
    cur[r] = 1.0
    for i in reversed(tree.postorder()):
        if i == r:
            pass
        else:
            p = tree.parent[i]
            pres = tree.res[i] + tree.length[i]
            cur[i] = vol[p] / pres if pres > 0 else cur[p] / 2.0
            vol[i] = vol[p] - tree.length[i] * cur[i]
    n = tree.n_leaves
    return tree.ndesc[r] * cur[:n]


def calc_pair_weights(tree: Tree, full: bool = False):
    """Three-point pair weights (Gotoh 1995; phyl.cc:703-786 pairwt with
    wfact=0/cfact semantics).  Returns (pairwt condensed, leaf weights =
    vol per leaf); with ``full=True`` additionally the per-node (vol, cur)
    arrays needed by the refinement partition weighting (calcfact)."""
    total = 2 * tree.n_leaves - 1
    n = tree.n_leaves
    cur = np.ones(total)
    vol = np.zeros(total)
    ros = np.zeros(total)
    wheight = np.zeros(n)
    pwt = np.zeros(n * (n - 1) // 2)
    root = tree.root
    vol[root] = 1.0

    def rec(node: int, ros_: float) -> list[int]:
        ros[node] = ros_
        if tree.is_leaf(node):
            vol[node] = vol[tree.parent[node]] * cur[node]
            wheight[node] = vol[node]          # + ndesc*bwt with bwt=0
            return [node]
        lc, rc = tree.left[node], tree.right[node]
        a = tree.res[lc] + tree.length[lc]
        b = tree.res[rc] + tree.length[rc]
        if node == root:
            cur[node] = cur[lc] = cur[rc] = 1.0
        elif ros_ <= FEPS or a + b <= FEPS:
            a = b = 0.0
            cur[lc] = cur[rc] = 0.5
            vol[node] = cur[node] * vol[tree.parent[node]]
        else:
            if a <= 0.0:
                b += a
                a = FEPS
            if b <= 0.0:
                a += b
                b = FEPS
            c = tree.length[node] + ros_
            wab = a * b / (a + b)
            wbc = a * (b + c)
            wfa = 1.0 + a * ros_ / ((wab + c) * (a + c))
            wfb = 1.0 + b * ros_ / ((wab + c) * (b + c))
            wab = wbc + b * c
            wbc = a * (b + c) / (wab * wfb)
            wac = b * (a + c) / (wab * wfa)
            wab = c * (a + b) / wab
            a *= ros_ / (a + ros_)
            b *= ros_ / (b + ros_)
            cur[node] *= np.sqrt(wac * wbc / wab)
            vol[node] = cur[node] * vol[tree.parent[node]]
            cur[lc] = np.sqrt(wab * wac / wbc)
            cur[rc] = np.sqrt(wab * wbc / wac)
        lleaves = rec(lc, b)
        rleaves = rec(rc, a)
        w2 = 1.0 / (vol[node] * vol[node])
        for li in lleaves:
            for ri in rleaves:
                pwt[condensed_index(li, ri)] = w2 * wheight[li] * wheight[ri]
        return lleaves + rleaves

    import sys
    rec_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(rec_limit, 10 * total + 100))
    try:
        rec(root, np.inf)
    finally:
        sys.setrecursionlimit(rec_limit)
    if full:
        return pwt, vol[:n].copy(), vol, cur
    return pwt, vol[:n].copy()


def _teachparent(t: Tree) -> None:
    """Canonicalize child order: subtree holding the smaller minimum leaf
    tid becomes the left child (phyl.cc Knode::teachparent), and refresh
    parent links / descendant counts."""
    def rec(i: int) -> int:
        if t.is_leaf(i):
            return i
        t.parent[t.left[i]] = i
        t.parent[t.right[i]] = i
        l = rec(t.left[i])
        r = rec(t.right[i])
        t.ndesc[i] = t.ndesc[t.left[i]] + t.ndesc[t.right[i]]
        if l > r:
            t.left[i], t.right[i] = t.right[i], t.left[i]
            return r
        return l
    import sys
    lim = sys.getrecursionlimit()
    sys.setrecursionlimit(max(lim, 10 * t.n_leaves + 100))
    try:
        rec(t.root)
    finally:
        sys.setrecursionlimit(lim)
    t.parent[t.root] = -1


