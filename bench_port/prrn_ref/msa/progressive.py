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
from ..ops.group import group_align


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
    if pads is None or ls >= 3:
        raise ValueError("align_pair: the reference takes the padded "
                         "single-affine merges of progressive_msa only")
    score, skl = group_align(A, B, mtx, u=u, v=v, wdw=wdw, pads=pads,
                             spb=spb, ls=ls, device=device)
    return score, skl, swapped


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
