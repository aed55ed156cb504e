"""``tree_family``: protein families shaped as BAliBASE 3.0 Reference 1
(RV12: equidistant families at 20-40 % identity).

An ancestor drawn from background amino-acid frequencies, then
descendants along a random binary tree whose internal nodes all lie
near the root (equidistant leaves), with substitutions and short
indels; the family's target identity is drawn from the configuration's
band, and a family is drawn again until its mean pairwise identity (over
the true alignment) and every length fall inside the configuration's
ranges.
"""

from __future__ import annotations

import numpy as np

from harness.families import AMINO, AMINO_FREQ, Family


def _random_tree(rng, n: int, lo: float):
    """A random binary tree over leaves 0..n-1 as (node, children,
    height) joins, heights from the leaves (0) to the root (1); every
    internal node at a height in [lo, 1], the root at 1."""
    live = list(range(n))
    heights = {i: 0.0 for i in range(n)}
    joins = []
    inner = np.sort(rng.uniform(lo, 1.0, n - 2)).tolist() + [1.0]
    nxt = n
    for h in inner:
        i, j = sorted(rng.choice(len(live), 2, replace=False))[::-1]
        a, b = live.pop(i), live.pop(j)
        joins.append((nxt, a, b, h))
        heights[nxt] = h
        live.append(nxt)
        nxt += 1
    return joins, heights


def _evolve(rng, res, ids, t: float, prm: dict, next_id):
    """Residues ``res`` with ancestral ids ``ids`` (inserted residues
    get fresh negative ids) along an edge of ``t`` expected
    substitutions a site."""
    res, ids = res.copy(), ids.copy()
    for _ in range(int(rng.poisson(prm["indel_rate"] * t * len(res)))):
        size = int(rng.integers(1, prm["indel_max"] + 1))
        p = int(rng.integers(0, len(res)))
        if rng.random() < 0.5:
            res = np.delete(res, np.s_[p:p + size])
            ids = np.delete(ids, np.s_[p:p + size])
        else:
            res = np.insert(res, p, rng.choice(20, size, p=AMINO_FREQ))
            new = np.arange(next_id[0], next_id[0] - size, -1)
            next_id[0] -= size
            ids = np.insert(ids, p, new)
    hit = rng.random(len(res)) < -np.expm1(-t)
    res[hit] = rng.choice(20, int(hit.sum()), p=AMINO_FREQ)
    return res, ids


def pairwise_identity(a_res, a_ids, b_res, b_ids) -> float:
    """Identity over the columns the two share in the true alignment."""
    common, ia, ib = np.intersect1d(a_ids[a_ids >= 0], b_ids[b_ids >= 0],
                                    return_indices=True)
    pa = np.flatnonzero(a_ids >= 0)[ia]
    pb = np.flatnonzero(b_ids >= 0)[ib]
    return float((a_res[pa] == b_res[pb]).mean()) if len(common) else 0.0


def make(rng, n: int, length: int, prm: dict) -> Family:
    """``n`` proteins from an ancestor of ``length`` along a random tree
    (see the module's docstring), redrawn until the family meets the
    configuration's identity band and length spread."""
    q = float((AMINO_FREQ ** 2).sum())
    id_lo, id_hi = prm["identity"]
    spread = prm["length_spread"]
    while True:
        ident = rng.uniform(id_lo, id_hi)
        # leaves whose common ancestor is the root differ by 2 * depth
        depth = -np.log((ident - q) / (1 - q)) / 2
        joins, heights = _random_tree(rng, n, prm["inner_height"])
        root = joins[-1][0]
        seq = {root: (rng.choice(20, length, p=AMINO_FREQ),
                      np.arange(length))}
        next_id = [-1]
        for node, a, b, h in reversed(joins):
            for child in (a, b):
                t = (h - heights[child]) * depth
                seq[child] = _evolve(rng, *seq[node], t, prm, next_id)
        leaves = [seq[i] for i in range(n)]
        lens = np.array([len(r) for r, _ in leaves])
        if (lens < (1 - spread) * length).any() or (
                lens > (1 + spread) * length).any():
            continue
        mean = float(np.mean([pairwise_identity(*leaves[i], *leaves[j])
                              for j in range(1, n) for i in range(j)]))
        if id_lo <= mean <= id_hi:
            return Family([f"p{i}" for i in range(n)],
                          ["".join(AMINO[c] for c in r) for r, _ in leaves],
                          mean)
