"""Doubly-nested randomized iterative refinement (the prrn core).

Reproduces the reference's refinement cycle (reference: src/prrn5.cc
rir/onecycle/divideseq :413-666, Prrn ctor :688-781, preprrn :786-839):

* guide tree + three-point weights over the current MSA (phyl_pwt)
* tree-edge bipartitions visited in mixed-congruential order (randiv)
* per partition: split the MSA into two groups, drop each side's common
  gap columns, re-score the existing mutual path, realign the two group
  profiles with partition-relative weights (calcfact), and accept iff the
  weighted score improves
* stop after a full cycle (2N-3 partitions) without improvement, capped
  at ``maxitr`` cycles

Counterpart of ``prrn_aln_tpu/msa/refine.py`` (``refine_msa`` and
``refine_with_consreg``): each candidate realignment is one group-DP
launch on an explicit ``device``, and the speculative best-of-n fan-out
(``nbatch > 1``) is one ``group_align_batch``, split over the ranks of
a ``torch.distributed`` ``group`` when one is given.  The random draws
use the copied ``GlibcRand``/``McRand`` generators, seeded as in the JAX
package, so both draw the same partitions.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .. import alphabet as ab
from .msa import Msa
from .tree import Tree, upgma, calc_pair_weights
from .distance import msa_distance_matrix
from .progressive import select_swap
from ..ops.window import stripe
from ..ops.group import group_align
from ..ops.path_score import score_path, skl_to_moves
from ..utils import trace
from ..utils.crand import GlibcRand, McRand

FEPS = 1e-7


def flt(a: float, b: float) -> bool:
    """Reference fuzzy less-than (cmn.h:61 lt)."""
    return a < b - FEPS * max(1.0, abs(b))


def leaves_under(tree: Tree, node: int) -> list[int]:
    out, stack = [], [node]
    while stack:
        i = stack.pop()
        if tree.is_leaf(i):
            out.append(i)
        else:
            stack.append(tree.left[i])
            stack.append(tree.right[i])
    return sorted(out)


def calcfact(tree: Tree, vol: np.ndarray, cur: np.ndarray,
             node: int) -> tuple[float, np.ndarray]:
    """Partition weight and partition-relative member weights
    (prrn5.cc:414-440 childfact/calcfact)."""
    n = tree.n_leaves
    w = np.zeros(n)

    def childfact(nd: int, fact: float):
        stack = [nd]
        while stack:
            i = stack.pop()
            if tree.is_leaf(i):
                w[i] = vol[i] * fact
            else:
                stack.append(tree.left[i])
                stack.append(tree.right[i])

    pwt = cur[node]
    childfact(node, 1.0 / vol[node])
    fact = 1.0
    nd = node
    while tree.parent[nd] >= 0:
        father = tree.parent[nd]
        sib = tree.right[father] if tree.left[father] == nd else tree.left[father]
        childfact(sib, fact / vol[father])
        nd = father
        fact *= cur[father]
    return float(pwt), w


def _tree_partitions(tree: Tree) -> list[list[int]]:
    """Leaf sets for tids 0..2n-4 (randiv.cc fill_tree_tab/TREEDIV)."""
    n = tree.n_leaves
    return [leaves_under(tree, t) for t in range(2 * n - 3)]


def _side_msa(joint: np.ndarray, rows: list[int], weights: np.ndarray,
              names: list[str], molc: int, tgapf: float, eij=None):
    """Extract side rows, drop the side's all-gap columns; returns the
    side Msa plus the joint-column occupancy mask."""
    sub = joint[rows]
    keep = (sub > ab.GAP).any(axis=0)
    m = Msa(codes=sub[:, keep].copy(), molc=molc,
            names=[names[r] for r in rows],
            weight=weights.copy(), tgapf=tgapf,
            eij=None if eij is None else [eij[r] for r in rows])
    return m, keep


def _paths_from_masks(keep0: np.ndarray, keep1: np.ndarray):
    """Current mutual path between the two sides (gap2skl semantics):
    per joint column, diag if both occupied, vert if only side0, hori if
    only side1; columns empty on both sides are dropped."""
    moves = []
    for a, b in zip(keep0, keep1):
        if a and b:
            moves.append(0)
        elif a:
            moves.append(1)
        elif b:
            moves.append(2)
    return moves


def moves_to_skl(moves):
    skl = [(0, 0)]
    m = n = 0
    prev = None
    for mv in moves:
        if prev is not None and mv != prev:
            skl.append((m, n))
        if mv == 0:
            m += 1
            n += 1
        elif mv == 1:
            m += 1
        else:
            n += 1
        prev = mv
    skl.append((m, n))
    return skl


@dataclasses.dataclass
class RefineResult:
    msa: Msa
    initial_sp: float | None
    improvements: int
    iterations: int


def refine_msa(msa: Msa, mtx: np.ndarray, u: float, v: float, sh: int,
               maxitr: int = 10, randseed: int = 1,
               crand: GlibcRand | None = None,
               accept_ties: bool = True,
               tree_data=None, col_range=None,
               nbatch: int = 1, spb: float = 20.0, group=None,
               subset=None, divmode: str = "tree", *,
               device) -> RefineResult:
    """One Prrn pass over a flat MSA (every sequence its own group).

    ``tree_data`` = (tree, vol, cur, leaf_vol) reuses a precomputed guide
    tree (the consreg flow refines column ranges under one global tree);
    ``col_range`` restricts realignment to columns [lo, hi) of the MSA,
    splicing the result back (preprrn per-attack-range Prrn)."""
    n = msa.many
    if n <= 2:
        return RefineResult(msa, None, 0, 0)
    if crand is None:
        crand = GlibcRand(1)
    import os as _os
    import time as _time
    _prog = _os.environ.get("PRRN_PROGRESS") == "1"
    _t0 = _time.time()
    _refined = 0.0

    m2u = None
    nu = n
    if subset is not None and 2 < subset.num < n:
        # -G grouping (Subset, sets.h:27-45): the tree and the randomized
        # bipartitions run over units (member groups held intact), with
        # unit-unit distances averaged over cross-group member pairs
        nu = subset.num
        from .distance import condensed_index
        with trace.span("prrn.refine.tree"):
            dc = msa_distance_matrix(msa.codes)
            du = np.empty(nu * (nu - 1) // 2, np.float64)
            for j in range(1, nu):
                for i in range(j):
                    acc = [dc[condensed_index(min(a, b), max(a, b))]
                           for a in subset.groups[i]
                           for b in subset.groups[j]]
                    du[condensed_index(i, j)] = float(np.mean(acc))
            t = upgma(du, nu)
            pairwt, unit_vol, vol, cur = calc_pair_weights(t, full=True)
        m2u = np.asarray(subset.member_to_group())
        leaf_vol = unit_vol[m2u]
    elif tree_data is None:
        # phyl_pwt: tree + weights from in-MSA divergences
        with trace.span("prrn.refine.tree"):
            d = msa_distance_matrix(msa.codes)
            t = upgma(d, n)
            pairwt, leaf_vol, vol, cur = calc_pair_weights(t, full=True)
    else:
        t, vol, cur, leaf_vol = tree_data
    full_eij = msa.eij
    msa = Msa(codes=msa.codes.copy(), molc=msa.molc, names=list(msa.names),
              weight=leaf_vol, tgapf=msa.tgapf, eij=full_eij)

    full_codes = msa.codes
    if col_range is not None:
        lo, hi = col_range
        from .sigii import slice_eij
        msa = Msa(codes=full_codes[:, lo:hi].copy(), molc=msa.molc,
                  names=msa.names, weight=leaf_vol, tgapf=msa.tgapf,
                  eij=slice_eij(full_codes, full_eij, lo, hi, msa.step)
                  if full_eij is not None else None)

    # division modes (Randiv, randiv.cc:142-239): TREEDIV = 2n-3 tree-edge
    # bipartitions; ONE_DIV = leave-one-out; ALL_DIV = every bipartition
    # as a bitmask; PARTDIV = random member subsets via libc rand()
    parts = _tree_partitions(t)
    if m2u is not None:
        parts = [[m for m in range(n) if int(m2u[m]) in set(p)]
                 for p in parts]
    if divmode == "one":
        parts = parts[:nu]
        cycle = nu
    elif divmode == "all":
        cycle = (1 << (nu - 1)) - 1 if nu <= 60 else nu * nu
    elif divmode == "part":
        cycle = nu * nu // 2
    else:
        cycle = 2 * nu - 3
    p = 0
    x = 1
    while x < cycle:
        p += 1
        x <<= 1
    if divmode == "all" and nu <= 60:
        p = nu - 1
    mcr = McRand(p, randseed, crand)

    def _expand_units(units_sel):
        if m2u is None:
            return sorted(units_sel)
        us = set(units_sel)
        return [m for m in range(n) if int(m2u[m]) in us]

    def draw():
        """Next partition: (tree-node id or None, member rows)."""
        if divmode == "all":
            while True:
                rnbr = mcr.mcrand()
                if rnbr:
                    break
            mask = int(rnbr) + int(cycle)
            return None, _expand_units(
                [k for k in range(nu) if (mask >> k) & 1])
        if divmode == "part":
            bit = crand.rand() % max(nu // 2, 1) + 1
            sel = {crand.rand() % nu for _ in range(bit)}
            return None, _expand_units(sorted(sel))
        while True:
            rnbr = mcr.mcrand()
            if rnbr < cycle:
                break
        return int(rnbr), parts[rnbr]

    joint = msa.codes.copy()
    names = msa.names
    dim = mtx.shape[0]

    def prepare_sides(pwt, lst0, lst1, wf0, wf1):
        """The sides of rows lst0 | lst1 on the current joint, each
        without its all-gap columns, their old mutual path and its score;
        None (skipped) when neither side drops a column."""
        S0, keep0 = _side_msa(joint, lst0, wf0, names, msa.molc, msa.tgapf,
                              msa.eij)
        S1, keep1 = _side_msa(joint, lst1, wf1, names, msa.molc, msa.tgapf,
                              msa.eij)
        if not ((~keep0).any() or (~keep1).any()):
            trace.COUNTS["refine.skipped"] += 1
            return None
        swapped = select_swap(S0, S1)
        A, B = (S1, S0) if swapped else (S0, S1)
        A.prepare(dim)
        B.prepare(dim)
        old_moves = _paths_from_masks(keep0, keep1)
        if swapped:
            old_moves = [(0 if m == 0 else 3 - m) for m in old_moves]
        old_skl = moves_to_skl(old_moves)
        sps_old = score_path(A, B, mtx, old_skl, u=u, v=v)
        return dict(pwt=pwt, lst0=lst0, lst1=lst1, A=A, B=B,
                    swapped=swapped, old_skl=old_skl, sps_old=sps_old)

    def prepare_candidate_like(cand):
        """Re-derive a candidate from its row partition on the CURRENT
        joint (used when replaying batched candidates)."""
        S0, S1 = ((cand["B"], cand["A"]) if cand["swapped"]
                  else (cand["A"], cand["B"]))
        with trace.span("prrn.refine.prepare"):
            return prepare_sides(cand["pwt"], cand["lst0"], cand["lst1"],
                                 S0.weight, S1.weight)

    def prepare_candidate(rnbr, members=None):
        """divideseq: sides, weights, old path for one partition.
        Returns None when the partition is skipped."""
        with trace.span("prrn.refine.prepare"):
            if members is None:
                members = parts[rnbr]
            if rnbr is None:
                # ALL_DIV/PARTDIV bitmask partitions carry no tree factor
                pwt, wfact = 1.0, np.asarray(leaf_vol, np.float64)
            else:
                pwt, wfact = calcfact(t, vol, cur, rnbr)
                if m2u is not None:
                    wfact = wfact[m2u]
            lst1 = members                      # bit==1 side (under node)
            lst0 = [k for k in range(n) if k not in set(members)]
            if not lst0 or not lst1:
                trace.COUNTS["refine.skipped"] += 1
                return None
            if len(lst0) < len(lst1):
                lst0, lst1 = lst1, lst0
            return prepare_sides(pwt, lst0, lst1, wfact[lst0], wfact[lst1])

    def evaluate(cand, score_new, new_skl):
        changed = new_skl != cand["old_skl"]
        delta = cand["pwt"] * (score_new - cand["sps_old"]) if changed else 0.0
        # the reference evaluates the old path and the realignment with
        # two differently-ordered f32 summations, so equal-score
        # alternative paths surface as tiny positive deltas it accepts
        # (prrn5.cc:645); deterministically accept score-preserving path
        # changes to explore the same tie-equivalent neighbourhood
        accept = flt(0.0, delta) or (
            changed and accept_ties
            and delta >= -FEPS * max(1.0, abs(cand["sps_old"])))
        return accept, delta

    def apply_candidate(cand, new_skl):
        nonlocal joint
        trace.COUNTS["refine.accepted"] += 1
        with trace.span("prrn.refine.apply"):
            A, B = cand["A"], cand["B"]
            moves = skl_to_moves(new_skl)
            L = len(moves)
            new_joint = np.full((n, L), ab.GAP, np.int8)
            rows_a = cand["lst1"] if cand["swapped"] else cand["lst0"]
            rows_b = cand["lst0"] if cand["swapped"] else cand["lst1"]
            ma = nb_ = 0
            for c, mv in enumerate(moves):
                if mv in (0, 1):
                    new_joint[rows_a, c] = A.codes[:, ma]
                    ma += 1
                if mv in (0, 2):
                    new_joint[rows_b, c] = B.codes[:, nb_]
                    nb_ += 1
            joint = new_joint

    nrep = 0
    improvements = 0
    i = 0
    maxi = maxitr * cycle
    pads = (n, joint.shape[1] + 32)
    while i < maxi:
        if nbatch > 1:
            # best-of-n speculative fan-out (reference P3) as one batch
            cands = []
            while len(cands) < nbatch and i < maxi:
                i += 1
                rnbr, members = draw()
                c = prepare_candidate(rnbr, members)
                if c is None:
                    nrep += 1
                else:
                    cands.append(c)
                if nrep >= cycle:
                    break
            if not cands:
                if nrep >= cycle:
                    break
                continue
            from ..ops.group import group_align_batch
            trace.COUNTS["refine.attempted"] += len(cands)
            results = group_align_batch(
                [(c["A"], c["B"]) for c in cands], mtx, u=u, v=v, sh=sh,
                pads=pads, spb=spb, group=group, device=device)
            scored = []
            for c, (s_new, skl_new) in zip(cands, results):
                acc, delta = evaluate(c, s_new, skl_new)
                scored.append((delta, acc, c, skl_new))
            scored.sort(key=lambda x: -x[0])
            applied = False
            for k, (delta, acc, c, skl_new) in enumerate(scored):
                if not acc:
                    break
                if not applied:
                    apply_candidate(c, skl_new)
                    applied = True
                    improvements += 1
                    _refined += max(delta, 0.0)
                    nrep = 1
                else:
                    # replay against the updated state (rir serial replay)
                    c2 = prepare_candidate_like(c)
                    if c2 is None:
                        continue
                    wdw = stripe(c2["A"].length, c2["B"].length, sh)
                    trace.COUNTS["refine.attempted"] += 1
                    s2, skl2 = group_align(c2["A"], c2["B"], mtx, u=u, v=v,
                                           wdw=wdw, pads=pads, spb=spb,
                                           device=device)
                    acc2, d2 = evaluate(c2, s2, skl2)
                    if acc2:
                        apply_candidate(c2, skl2)
                        improvements += 1
                        _refined += max(d2, 0.0)
                        nrep = 1
            if not applied:
                nrep += len(cands)
            if nrep >= cycle:
                break
            continue

        i += 1
        rnbr, members = draw()
        cand = prepare_candidate(rnbr, members)
        if cand is None:
            nrep += 1
            if nrep >= cycle:
                break
            continue
        A, B = cand["A"], cand["B"]
        wdw = stripe(A.length, B.length, sh)
        trace.COUNTS["refine.attempted"] += 1
        score_new, new_skl = group_align(A, B, mtx, u=u, v=v, wdw=wdw,
                                         pads=pads, spb=spb, device=device)
        accept, delta = evaluate(cand, score_new, new_skl)
        if accept:
            apply_candidate(cand, new_skl)
            improvements += 1
            _refined += max(delta, 0.0)
            nrep = 1
        else:
            nrep += 1
        if nrep >= cycle:
            break

    # drop all-gap columns
    keep = (joint > ab.GAP).any(axis=0)
    joint = joint[:, keep]
    if col_range is not None:
        lo, hi = col_range
        joint = np.concatenate(
            [full_codes[:, :lo], joint, full_codes[:, hi:]], axis=1)
    out = Msa(codes=joint, molc=msa.molc, names=names, weight=leaf_vol,
              tgapf=msa.tgapf, eij=full_eij)
    if _prog:
        # per-pass WSP progress line (reference MONIT prompt,
        # prrn5.cc:772-780: "newsp <-- oldsp, N grp, reps, secs")
        import sys as _sys
        from . import wsp as _wsp
        out.prepare(mtx.shape[0])
        newsp = _wsp.wsp_score(out, mtx, v=v)
        print("%s [ %d ] %d" % (names[0], out.many, out.length),
              file=_sys.stderr)
        print("  %8.1f <-- %8.1f, %2d grp, %4d rep, %2d sec"
              % (newsp, newsp - _refined, nu, i,
                 int(_time.time() - _t0)), file=_sys.stderr)
    return RefineResult(out, None, improvements, i)


def refine_with_consreg(msa: Msa, mtx: np.ndarray, u: float, v: float,
                        sh: int, maxitr: int = 10, randseed: int = 1,
                        crand: GlibcRand | None = None,
                        spb: float = 20.0, nbatch: int = 1, group=None,
                        divmode: str = "tree", *,
                        device) -> RefineResult:
    """preprrn with conserved-region segmentation (prrn5.cc:786-839):
    one global tree/weighting, then per-attack-range Prrn passes, walked
    from the last range to the first so indices stay valid."""
    from .consreg import attack_ranges

    n = msa.many
    if n <= 2:
        return RefineResult(msa, None, 0, 0)
    if crand is None:
        crand = GlibcRand(1)
    with trace.span("prrn.refine.tree"):
        d = msa_distance_matrix(msa.codes)
        t = upgma(d, n)
        pairwt, leaf_vol, vol, cur = calc_pair_weights(t, full=True)
        work = Msa(codes=msa.codes.copy(), molc=msa.molc,
                   names=list(msa.names), weight=leaf_vol, tgapf=msa.tgapf,
                   eij=msa.eij)
        ranges = attack_ranges(work, t, mtx)
    improvements = iterations = 0
    for lo, hi in reversed(ranges):
        if hi - lo < 2:
            continue
        res = refine_msa(work, mtx, u=u, v=v, sh=sh, maxitr=maxitr,
                         randseed=randseed, crand=crand,
                         tree_data=(t, vol, cur, leaf_vol),
                         col_range=(lo, hi), spb=spb, nbatch=nbatch,
                         group=group, divmode=divmode, device=device)
        work = res.msa
        improvements += res.improvements
        iterations += res.iterations
    return RefineResult(work, None, improvements, iterations)
