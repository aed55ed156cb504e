"""Single-linkage forest scale-out path (de-novo MSA for many sequences).

Counterpart of ``prrn_aln_tpu/msa/slforest.py``.  The forest
bookkeeping (``Edge``, ``SlNode``, ``build_forest``, ``slnode_to_tree``,
``split_oversized``) is host code, copied unchanged; ``candidate_edges``
scores its pairs with one call of ``ops.pairwise.pairwise_scores`` (in
``distance.all_pairs_scores``) on an explicit ``device``: kernel K1, or
K1f under ``PRRN_PW_FUSED=1``, split over the ranks of a
``torch.distributed`` ``group`` when one is given.

Reference flow (src/adjmat.cc + src/sltree.cc): build a sparse distance
graph (candidate pairs from a k-mer selectivity filter, scored with the
wavefront DP distance), then Kruskal single-linkage clustering with
subtree-size caps; each subtree is aligned independently (progressive
along its join tree + refinement) and the subtree profiles are combined,
with leftover singletons cut in at the end.  The reference's
genome-block search (blksrc) is replaced by the k-mer nearest-neighbour
filter: forest-level parity, not hit-list parity.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from . import distance as dmod
from . import kmer as kmod
from .tree import Tree

INT_MAX = 2 ** 31 - 1


@dataclasses.dataclass
class Edge:
    u: int
    v: int
    dist: float


def candidate_edges(seqs: list[np.ndarray], molc: int, mtx, u: float,
                    v: float, sh: int, thr: float,
                    m_nearest: int = 8, group=None, *,
                    device) -> list[Edge]:
    """Sparse edge list: k-mer nearest candidates scored by DP distance."""
    n = len(seqs)
    knn_thr = int(os.environ.get("PRRN_KNN_THRESHOLD", "2048"))
    if n > knn_thr:
        # sub-quadratic candidate discovery (MinHash-LSH, kmer.py;
        # reference role blksrc.cc:3260 block-index M-nearest): no
        # O(N^2) matrix is ever built
        pairs, _ = kmod.kmer_knn_candidates(seqs, molc,
                                            m_nearest=m_nearest)
    else:
        kd = kmod.kmer_distance_matrix(seqs, molc, device=device)

        def kdist(i, j):
            return kd[dmod.condensed_index(i, j)]

        cand: set[tuple[int, int]] = set()
        for i in range(n):
            others = sorted((kdist(i, j), j)
                            for j in range(n) if j != i)
            for _, j in others[:m_nearest]:
                cand.add((min(i, j), max(i, j)))
        pairs = sorted(cand)

    # one batched DP-distance launch over the candidate pairs;
    # PRRN_EDGE_SCREEN=bf16 opts into the bf16 score screen (edge
    # selection is soft; the groups the forest later aligns are scored
    # exactly)
    scores = dmod.all_pairs_scores(
        seqs, mtx, u, v, sh, group, pairs=pairs, device=device,
        lossy=os.environ.get("PRRN_EDGE_SCREEN") == "bf16")
    lens = [len(s) for s in seqs]
    selfs = np.array([float(mtx[s, s].sum()) for s in seqs])
    edges = []
    for k, (i, j) in enumerate(pairs):
        denome = np.sqrt(selfs[i] * selfs[j])
        scr = scores[k] + u * abs(lens[i] - lens[j]) / 2.0
        d = 100.0 * (1.0 - scr / denome)
        if d < thr:
            edges.append(Edge(i, j, float(d)))
    return edges


@dataclasses.dataclass
class SlNode:
    tid: int                   # leaf id or -1
    left: "SlNode | None" = None
    right: "SlNode | None" = None
    ndesc: int = 1
    dist: float = 0.0

    def leaves(self) -> list[int]:
        if self.tid >= 0 and self.left is None:
            return [self.tid]
        return self.left.leaves() + self.right.leaves()


def build_forest(n: int, edges: list[Edge], thr: float,
                 max_memb: int = INT_MAX,
                 min_memb: int = 2) -> tuple[list[SlNode], list[int]]:
    """Kruskal single-linkage forest with subtree caps
    (sltree.cc:59-72 FindUnion::merge, :155-196 sltree).
    Returns (trees sorted by size desc, leftover singleton ids)."""
    dad = list(range(n))
    npr = [1] * n
    graduated: set[int] = set()      # retired roots (size-capped)
    root: list[SlNode | None] = [SlNode(i) for i in range(n)]

    def find(x):
        while dad[x] != x:
            dad[x] = dad[dad[x]]
            x = dad[x]
        return x

    order = sorted(range(len(edges)), key=lambda k: edges[k].dist)
    for k in order:
        e = edges[k]
        if e.dist > thr:
            break
        x, y = find(e.u), find(e.v)
        if x in graduated or y in graduated or x == y:
            continue
        if npr[x] < npr[y]:
            x, y = y, x
        if npr[x] + npr[y] > max_memb and npr[y] >= min_memb:
            graduated.add(x)
            graduated.add(y)
            continue
        npr[x] += npr[y]
        dad[y] = x
        joined = SlNode(-1, root[x], root[y],
                        root[x].ndesc + root[y].ndesc, e.dist)
        root[x] = joined
        root[y] = None

    trees = [r for r in root if r is not None and r.ndesc >= min_memb]
    if max_memb < INT_MAX:
        trees = split_oversized(trees, max_memb, min_memb=1)
        trees = [t for t in trees if t.ndesc >= min_memb]
    singles = ([r.tid for r in root if r is not None and r.ndesc < min_memb]
               + [t.tid for t in trees if t.ndesc < min_memb])
    trees.sort(key=lambda t: -t.ndesc)
    return trees, singles


def slnode_to_tree(node: SlNode) -> tuple[Tree, list[int]]:
    """Convert an SlNode join tree into the array Tree form for the
    progressive aligner; returns (tree, leaf ids in leaf-slot order)."""
    leaves: list[SlNode] = []

    def collect(nd):
        if nd.left is None:
            leaves.append(nd)
        else:
            collect(nd.left)
            collect(nd.right)

    collect(node)
    n = len(leaves)
    total = 2 * n - 1
    left = np.full(total, -1, np.int64)
    right = np.full(total, -1, np.int64)
    parent = np.full(total, -1, np.int64)
    ndesc = np.ones(total, np.int64)
    nxt = [n]
    slot_of: dict[int, int] = {}
    for i, lf in enumerate(leaves):
        slot_of[id(lf)] = i

    def build(nd) -> int:
        if nd.left is None:
            return slot_of[id(nd)]
        a = build(nd.left)
        b = build(nd.right)
        i = nxt[0]
        nxt[0] += 1
        left[i], right[i] = a, b
        parent[a] = parent[b] = i
        ndesc[i] = ndesc[a] + ndesc[b]
        return i

    rt = build(node)
    assert rt == total - 1
    t = Tree(n, left, right, parent, np.zeros(total), np.zeros(total),
             np.zeros(total), ndesc)
    return t, [lf.tid for lf in leaves]


def _graft(node: SlNode, swp: bool) -> None:
    """Rebalance: promote the heavier grandchild (sltree.cc:74-90)."""
    a = node.right if swp else node.left
    b = node.left if swp else node.right
    inner_swp = a.right.ndesc > a.left.ndesc
    c = a.right if inner_swp else a.left
    d = a.left if inner_swp else a.right
    if swp:
        node.right, node.left = c, a
    else:
        node.left, node.right = c, a
    a.left, a.right = d, b
    a.ndesc = d.ndesc + b.ndesc


def _unpacked(node: SlNode, max_memb: int, min_memb: int) -> SlNode | None:
    """Find the split point of an oversized subtree (sltree.cc:92-104)."""
    while True:
        if node.ndesc <= max_memb:
            return None
        major, minor = node.left.ndesc, node.right.ndesc
        swp = minor > major
        if swp:
            major, minor = minor, major
        if minor > min_memb:
            return node
        if major <= max_memb:
            return None
        _graft(node, swp)


def split_oversized(trees: list[SlNode], max_memb: int,
                    min_memb: int = 2) -> list[SlNode]:
    """divsltree / cruck: recursively split subtrees larger than
    max_memb (sltree.cc:106-117, 221-236)."""
    out: list[SlNode] = []

    def div(node: SlNode):
        up = _unpacked(node, max_memb, min_memb)
        if up is not None:
            div(up.left)
            div(up.right)
        else:
            out.append(node)

    for t in trees:
        if t.ndesc > max_memb:
            div(t)
        else:
            out.append(t)
    out.sort(key=lambda t: -t.ndesc)
    return out
