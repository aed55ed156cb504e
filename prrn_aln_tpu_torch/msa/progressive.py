"""Progressive MSA construction over a guide tree.

Counterpart of ``prrn_aln_tpu/msa/progressive.py`` (``select_swap``,
``align_pair``, ``progressive_msa_forest``, ``progressive_msa``); the
group alignments run on an explicit ``device``.

Mirrors the reference's ProgMsa::prog_up (prrn5.h:85-105): post-order walk
of the guide tree, aligning the two child group alignments at each
internal node (unweighted during the progressive phase).
"""

from __future__ import annotations

import numpy as np
import torch

from .msa import Msa
from .merge import merge_msas
from .tree import Tree
from ..ops.window import stripe
from ..ops.group_np import group_align_np
from ..ops.group import group_align, group_align_batch


def select_swap(A: Msa, B: Msa) -> bool:
    """Operand-swap rule of PwdM::selAlnMode (maln2.cc:81-154) so that
    tie-breaking in the DP matches the reference's operand order."""
    an, bn = A.many, B.many
    # advised_sim2 (maln2.cc:43-60)
    i = 1 if an < bn else 0
    ni = (B.many if i else A.many)
    nj = (A.many if i else B.many)
    nt = 2 * nj + ni
    abgfq = nt >= 8
    if abgfq:
        apf = nt >= 14 or nj == 1
        bpf = False
        if i:
            apf, bpf = bpf, apf
        aprof, bprof = apf, bpf
    else:
        aprof = bprof = False
    agfq = A.has_internal_gaps()
    bgfq = B.has_internal_gaps()
    if not agfq and not bgfq:
        mode = "NGP"
    elif not abgfq:
        mode = "NTV"
    elif not agfq:
        mode = "RHF"
    elif not bgfq:
        mode = "HLF"
    else:
        mode = "GPF"
    if mode == "HLF":
        return False
    if mode == "RHF":
        return True
    if mode == "GPF":
        return (not aprof) and bprof
    if mode == "NTV":
        return A.length < B.length
    return False          # NGP: swp = a->inex.intr (no splice yet)


def align_pair(A: Msa, B: Msa, mtx: np.ndarray, u: float, v: float,
               sh: int, tgapf: float = 1.0, pads=None, spb: float = 20.0,
               ls: int = 1, *, device):
    """Align two prepared groups; returns (score, skl, swapped).
    ``ls=3`` selects the double-affine long-gap lanes (-yl3)."""
    swapped = select_swap(A, B)
    if swapped:
        A, B = B, A
    if A.freq is None:
        A.prepare(mtx.shape[0])
    if B.freq is None:
        B.prepare(mtx.shape[0])
    wdw = stripe(A.length, B.length, sh)
    if pads is not None:
        score, skl = group_align(A, B, mtx, u=u, v=v, wdw=wdw, pads=pads,
                                 spb=spb, ls=ls, device=device)
    elif ls >= 3:
        if torch.device(device).type == "cpu":
            score, skl = group_align_np(A, B, mtx, u=u, v=v, wdw=wdw,
                                        spb=spb, ls=ls)
        else:
            score, skl = group_align(A, B, mtx, u=u, v=v, wdw=wdw,
                                     spb=spb, ls=ls, device=device)
    else:
        score, skl = group_align_np(A, B, mtx, u=u, v=v, wdw=wdw, spb=spb)
    return score, skl, swapped


def progressive_msa_forest(trees: list, leaves_list: list, mtx: np.ndarray,
                           u: float, v: float, sh: int, spb: float = 20.0,
                           *, device) -> list[Msa]:
    """Level-synchronous progressive alignment over a FOREST: every
    merge whose children are both built, across all trees and across
    independent subtrees within one tree, runs in one
    ``group_align_batch`` launch on ``device``.

    This is the reference's per-subtree thread fan-out
    (prrn5.cc:1151-1155) recast as device batching: the wall-clock per
    round is one batched DP instead of one DP per merge.  Results are
    identical to per-tree ``progressive_msa`` (same merges, same
    order-independent padding buckets).
    """
    total = max(sum(s.many for s in ls) for ls in leaves_list)
    maxlen = max(max(s.length for s in ls) for ls in leaves_list)
    pads = (total, 2 * maxlen)

    built = []                       # per-tree node -> Msa
    pending = []                     # per-tree list of unmerged internals
    for tree, seqs in zip(trees, leaves_list):
        b = {}
        for node in tree.postorder():
            if tree.is_leaf(node):
                m = seqs[node]
                if m.freq is None:
                    m.prepare(mtx.shape[0])
                b[node] = m
        built.append(b)
        pending.append([n for n in tree.postorder()
                        if not tree.is_leaf(n)])

    while any(pending):
        jobs = []                    # (tree_idx, node, A, B, swapped)
        for ti, tree in enumerate(trees):
            for node in pending[ti]:
                lc, rc = tree.left[node], tree.right[node]
                if lc in built[ti] and rc in built[ti]:
                    A, B = built[ti][lc], built[ti][rc]
                    swapped = select_swap(A, B)
                    if swapped:
                        A, B = B, A
                    jobs.append((ti, node, A, B, swapped))
        assert jobs, "forest merge deadlock"
        results = group_align_batch([(A, B) for _, _, A, B, _ in jobs],
                                    mtx, u=u, v=v, sh=sh, pads=pads,
                                    spb=spb, device=device)
        for (ti, node, A, B, swapped), (_, skl) in zip(jobs, results):
            merged = merge_msas(A, B, skl)
            merged.prepare(mtx.shape[0])
            built[ti].pop(trees[ti].left[node])
            built[ti].pop(trees[ti].right[node])
            built[ti][node] = merged
            pending[ti].remove(node)
    return [built[ti][tree.root] for ti, tree in enumerate(trees)]


def progressive_msa(seqs: list[Msa], tree: Tree, mtx: np.ndarray,
                    u: float, v: float, sh: int, pads=None,
                    spb: float = 20.0, *, device) -> Msa:
    """Post-order progressive alignment; ``seqs[i]`` is the leaf group for
    tree leaf i."""
    if pads is None:
        total = sum(s.many for s in seqs)
        maxlen = max(s.length for s in seqs)
        pads = (total, 2 * maxlen)
    built: dict[int, Msa] = {}
    for node in tree.postorder():
        if tree.is_leaf(node):
            m = seqs[node]
            if m.freq is None:
                m.prepare(mtx.shape[0])
            built[node] = m
        else:
            A = built.pop(tree.left[node])
            B = built.pop(tree.right[node])
            _, skl, swapped = align_pair(A, B, mtx, u, v, sh, pads=pads,
                                         spb=spb, device=device)
            if swapped:
                A, B = B, A
            merged = merge_msas(A, B, skl)
            merged.prepare(mtx.shape[0])
            built[node] = merged
    return built[tree.root]
