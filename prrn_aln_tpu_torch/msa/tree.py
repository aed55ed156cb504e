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


def neighbor_joining(dist: np.ndarray, n: int) -> Tree:
    """Neighbor-joining tree (Saitou-Nei / Studier-Keppler) with the
    reference's re-rooting and height normalization
    (phyl.cc:1112-1176 nj_method, :585-619 findroot, :1030-1060 recalhi,
    :570-577 calres)."""
    total = 2 * n - 1
    left = np.full(total, -1, np.int64)
    right = np.full(total, -1, np.int64)
    parent = np.full(total, -1, np.int64)
    height = np.zeros(total)
    length = np.zeros(total)
    res = np.zeros(total)
    ndesc = np.ones(total, np.int64)

    D = np.zeros((n, n))
    for j in range(1, n):
        for i in range(j):
            D[i, j] = D[j, i] = dist[condensed_index(i, j)]
    D = D.copy()
    ssum = D.sum(axis=1)
    nodes = list(range(n))
    m_new = n
    nn = n
    while nn >= 3:
        if nn > 3:
            # mins: minimize D[i,j]*(nn-2) - sum[i] - sum[j], i < j scan order
            best = None
            bi = bj = 0
            for j in range(1, nn):
                for i in range(j):
                    t = D[i, j] * (nn - 2) - ssum[i] - ssum[j]
                    if best is None or t < best:
                        best, bi, bj = t, i, j
            i, j = bi, bj
        else:
            # minh: maximize 2*height + sum - dist (phyl.cc:1095-1110)
            hmax = 2 * height[nodes[2]] + ssum[2] - D[0, 1]
            i, j = 0, 1
            cand = [(2 * height[nodes[1]] + ssum[1] - D[0, 2], 0, 2),
                    (2 * height[nodes[0]] + ssum[0] - D[1, 2], 1, 2)]
            for t, ci, cj in cand:
                if t > hmax:
                    hmax, i, j = t, ci, cj
        dd = (ssum[i] - ssum[j]) / (nn - 2)
        dij = D[i, j]
        hl = (dij + dd) / 2.0
        hr = (dij - dd) / 2.0
        ssum[i] = (ssum[i] + ssum[j] - nn * dij) / 2.0
        rt = m_new
        m_new += 1
        left[rt], right[rt] = nodes[i], nodes[j]
        length[nodes[i]] = hl
        length[nodes[j]] = hr
        ndesc[rt] = ndesc[nodes[i]] + ndesc[nodes[j]]
        height[rt] = max(hl + height[nodes[i]], hr + height[nodes[j]])
        parent[nodes[i]] = parent[nodes[j]] = rt
        nodes[i] = rt
        for k in range(nn):
            if k in (i, j):
                continue
            dd2 = D[k, i] + D[k, j]
            D[k, i] = D[i, k] = (dd2 - dij) / 2.0
            ssum[k] -= (dd2 + dij) / 2.0
        nn -= 1
        if j != nn:
            ssum[j] = ssum[nn]
            nodes[j] = nodes[nn]
            for k in range(nn):
                if k != j:
                    D[k, j] = D[j, k] = D[k, nn]

    rt = m_new
    left[rt], right[rt] = nodes[0], nodes[1]
    length[rt] = 0.0
    ndesc[rt] = n
    parent[nodes[0]] = parent[nodes[1]] = rt
    t = Tree(n, left, right, parent, height, length, res, ndesc)

    # reference passes the *updated* working distance between the two
    # remaining nodes (nj destroys dist in place; phyl.cc:1167)
    _findroot(t, rt, D[0, 1])
    t.parent[:] = -1
    for i in range(total):
        if t.left[i] >= 0:
            t.parent[t.left[i]] = i
            t.parent[t.right[i]] = i
    _teachparent(t)
    lw = _recalhi(t, t.root, t.height[t.root])
    if lw < 0.0:
        _recalhi(t, t.root, t.height[t.root] - lw)
    _calres(t, t.root)
    return t


def _findroot(t: Tree, node: int, brl: float) -> None:
    """Re-root at the balance point (phyl.cc:585-619 findroot)."""
    while True:
        lc, rc = t.left[node], t.right[node]
        t.height[node] = (t.height[lc] + t.height[rc] + brl) / 2.0
        t.length[lc] = t.height[node] - t.height[lc]
        t.length[rc] = t.height[node] - t.height[rc]
        if t.length[lc] < 0.0:
            chng, keep = lc, rc
        elif t.length[rc] < 0.0:
            chng, keep = rc, lc
        else:
            return
        t.length[keep] = brl
        cl, cr = t.left[chng], t.right[chng]
        if t.height[cl] + t.length[cl] > t.height[cr] + t.length[cr]:
            t.left[node] = cl
            t.left[chng] = cr
        else:
            t.left[node] = cr
        brl = t.length[t.left[node]]
        t.right[chng] = keep
        t.right[node] = chng
        cl, cr = t.left[chng], t.right[chng]
        t.height[chng] = max(t.height[cl] + t.length[cl],
                             t.height[cr] + t.length[cr])


def _recalhi(t: Tree, node: int, hi: float) -> float:
    """Top-down height assignment (phyl.cc:1030-1056 lowesthi/recalhi)."""
    lwhi = [0.0]
    first = [True]

    def walk(i, h):
        h = h - t.length[i]
        t.height[i] = h
        if first[0] or h < lwhi[0]:
            lwhi[0] = min(lwhi[0], h)
        first[0] = False
        if t.left[i] >= 0:
            walk(t.left[i], h)
            walk(t.right[i], h)

    lwhi[0] = float("inf")
    walk(node, hi)
    return lwhi[0]


def _calres(t: Tree, node: int) -> float:
    if t.left[node] < 0:
        t.res[node] = 0.0
        return 0.0
    rr = _calres(t, t.left[node]) + t.length[t.left[node]]
    rl = _calres(t, t.right[node]) + t.length[t.right[node]]
    t.res[node] = rr * rl / (rr + rl) if (rr > 0.0 and rl > 0.0) else 0.0
    return t.res[node]


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


def to_newick(t: Tree, names: list[str]) -> str:
    """Newick serialization with branch lengths."""
    def rec(i: int) -> str:
        if t.is_leaf(i):
            return f"{names[i]}:{t.length[i]:.5f}"
        return (f"({rec(t.left[i])},{rec(t.right[i])})"
                + (f":{t.length[i]:.5f}" if i != t.root else ""))
    return rec(t.root) + ";"


def parse_newick(text: str) -> tuple[Tree, list[str]]:
    """Parse a (binary) Newick tree into the array Tree plus leaf names.

    Multifurcations are resolved left-to-right into a binary caterpillar,
    matching the reference's binary Btree reader (phyl.h:144-389).
    """
    text = text.strip().rstrip(";").strip()
    pos = [0]

    def parse_node():
        children = []
        name = ""
        length = 0.0
        if text[pos[0]] == "(":
            pos[0] += 1
            children.append(parse_node())
            while text[pos[0]] == ",":
                pos[0] += 1
                children.append(parse_node())
            assert text[pos[0]] == ")", f"bad newick at {pos[0]}"
            pos[0] += 1
        # optional label
        start = pos[0]
        while pos[0] < len(text) and text[pos[0]] not in ",():;":
            pos[0] += 1
        label = text[start:pos[0]]
        if ":" in label:
            pass
        if pos[0] < len(text) and text[pos[0]] == ":":
            pos[0] += 1
            start = pos[0]
            while pos[0] < len(text) and text[pos[0]] not in ",()":
                pos[0] += 1
            length = float(text[start:pos[0]])
        name = label
        return {"children": children, "name": name, "length": length}

    root = parse_node()

    leaves: list[dict] = []

    def collect(nd):
        if not nd["children"]:
            leaves.append(nd)
        for c in nd["children"]:
            collect(c)

    collect(root)
    n = len(leaves)
    total = 2 * n - 1
    left = np.full(total, -1, np.int64)
    right = np.full(total, -1, np.int64)
    parent = np.full(total, -1, np.int64)
    height = np.zeros(total)
    length = np.zeros(total)
    res = np.zeros(total)
    ndesc = np.ones(total, np.int64)
    names = [lf["name"] for lf in leaves]
    next_id = [n]
    leaf_iter = iter(range(n))

    def build(nd) -> int:
        if not nd["children"]:
            i = next(leaf_iter)
            length[i] = nd["length"]
            return i
        kids = [build(c) for c in nd["children"]]
        cur = kids[0]
        for k in kids[1:]:
            i = next_id[0]
            next_id[0] += 1
            left[i], right[i] = cur, k
            parent[cur] = parent[k] = i
            ndesc[i] = ndesc[cur] + ndesc[k]
            cur = i
        length[cur] = nd["length"]
        return cur

    rt = build(root)
    # ensure root is the last node id (array convention)
    assert rt == total - 1, "newick tree must be binary-resolvable"
    t = Tree(n, left, right, parent, height, length, res, ndesc)
    # heights from lengths (leaves at 0 where consistent)
    for i in t.postorder():
        if t.left[i] >= 0:
            height[i] = max(height[t.left[i]] + length[t.left[i]],
                            height[t.right[i]] + length[t.right[i]])
    _calres(t, t.root)
    return t, names
