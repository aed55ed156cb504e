"""End-to-end MSA pipeline (the prrn flagship path).

Counterpart of ``prrn_aln_tpu/pipeline.py``, all on an explicit
``device``.  ``build_msa`` for fewer than 16 sequences: unaligned
sequences -> all-pairs wavefront distances (kernel K1) -> UPGMA tree
(host) -> progressive profile alignment and randomized iterative
refinement (kernels K2 and K3) (reference flow: prrn5.cc makemsa
:961-987 + IterMsa::msa :909-917).  From 16 sequences on,
``build_msa_denovo_large``: a sparse k-mer-filtered DP distance graph
(K1, or K1f under ``PRRN_PW_FUSED=1``), a single-linkage forest, the
subtrees aligned in batched launches (K2, K3) and refined, then combined
by ``update_msa`` and ``cut_in`` (host group alignments, as in the JAX
package) and refined once more.  ``build_msa_guided`` (``prrn -b``,
``aln -b``) aligns along a user's Newick tree (K2, K3); ``update_msa``
combines pre-aligned inputs (``prrn -U``).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from . import alphabet as ab
from . import scoring
from .config import AlnParams, default_params
from .io import SeqRecord, sniff_and_read, write_native_block
from .msa.msa import Msa, single
from .msa import distance, slforest, tree
from .msa.merge import merge_msas
from .msa.progressive import (align_pair, progressive_msa,
                              progressive_msa_forest)
from .msa.refine import refine_msa, refine_with_consreg
from .msa.sigii import eij_from_exons
from .utils import trace
from .utils.crand import GlibcRand
from .utils.runstat import runstat

# prrn5's min_seqs: from this many sequences on, the JAX package builds
# the MSA over a single-linkage forest (pipeline.py:42)
FOREST_MIN_SEQS = 16


def build_msa(records: list[SeqRecord], params: AlnParams | None = None,
              molc: int | None = None, maxitr: int = 10,
              randseed: int = 1, refine: bool = True,
              local_thr: float = 35.0, group=None, nbatch: int = 1,
              divmode: str = "tree", *, device) -> Msa:
    if molc is None:
        molc = ab.infer_molc(records[0].seq)
    if params is None:
        params = default_params(molc, "prrn")
    mtx, _ = scoring.build_matrix(molc, params)

    seqs = [ab.encode(r.seq.replace("-", ""), molc) for r in records]
    names = [r.name for r in records]
    step = 3 if molc == ab.PROTEIN else 1
    exlist = [eij_from_exons(r.exons, step) for r in records]

    if len(seqs) == 1:
        return single(seqs[0], molc, names[0], eij=exlist[0])
    if len(seqs) >= FOREST_MIN_SEQS:      # sl-forest scale-out
        return build_msa_denovo_large(records, params, molc, maxitr=maxitr,
                                      randseed=randseed, refine=refine,
                                      group=group, nbatch=nbatch,
                                      divmode=divmode, device=device)

    with trace.span("prrn.distance"):
        d = distance.distance_matrix(seqs, mtx, u=params.u, v=params.v,
                                     sh=params.sh, group=group, device=device)
    t = tree.upgma(d, len(seqs))

    leaves = [single(s, molc, n, eij=e)
              for s, n, e in zip(seqs, names, exlist)]
    with trace.span("prrn.progressive"):
        msa = progressive_msa(leaves, t, mtx, u=params.u, v=params.v,
                              sh=params.sh, spb=params.spb, device=device)
    if refine and msa.many > 2:
        crand = GlibcRand(1)
        with trace.span("prrn.refine"):
            if local_thr > 0:
                res = refine_with_consreg(msa, mtx, u=params.u, v=params.v,
                                          sh=params.sh, maxitr=maxitr,
                                          randseed=randseed, crand=crand,
                                          spb=params.spb, nbatch=nbatch,
                                          group=group, divmode=divmode,
                                          device=device)
            else:
                res = refine_msa(msa, mtx, u=params.u, v=params.v,
                                 sh=params.sh, maxitr=maxitr,
                                 randseed=randseed, crand=crand,
                                 spb=params.spb, nbatch=nbatch, group=group,
                                 divmode=divmode, device=device)
        msa = res.msa
    return msa


def _ensure_weights(m: Msa) -> Msa:
    """calcweight: tree-derived sequence weights (phyl.cc:835-846)."""
    if m.weight is not None:
        return m
    if m.many == 1:
        m.weight = np.ones(1)
    elif m.many == 2:
        m.weight = np.array([0.5, 0.5])
    else:
        d = distance.msa_distance_matrix(m.codes)
        t = tree.upgma(d, m.many)
        m.weight = tree.calc_seq_weights(t)
    return m


def cut_in(mom: Msa, dau: Msa, mtx, params: AlnParams, *, device) -> Msa:
    """Insert a single sequence (or small group) into an MSA
    (prrn5.cc cut_in): weighted host vs unit-weight guest."""
    _ensure_weights(mom)
    dau = Msa(codes=dau.codes, molc=dau.molc, names=list(dau.names),
              weight=np.ones(dau.many))
    mom.prepare(mtx.shape[0])
    dau.prepare(mtx.shape[0])
    _, skl, swapped = align_pair(mom, dau, mtx, u=params.u, v=params.v,
                                 sh=params.sh, device=device)
    A, B = (dau, mom) if swapped else (mom, dau)
    merged = merge_msas(A, B, skl)
    if swapped:
        # restore host-first row order
        order = list(range(dau.many, dau.many + mom.many)) + \
            list(range(dau.many))
        merged = Msa(codes=merged.codes[order], molc=merged.molc,
                     names=[merged.names[i] for i in order],
                     weight=np.concatenate([mom.weight, dau.weight]))
    return merged


def update_msa(groups: list[Msa], params: AlnParams | None = None,
               molc: int | None = None, maxitr: int = 10, randseed: int = 1,
               refine: bool = False, nbatch: int = 1, group=None,
               divmode: str = "tree", *, device) -> Msa:
    """Combine pre-aligned host MSAs and single-sequence guests
    (prrn5.cc:1529-1605 update_prrn): hosts merged by group alignment,
    guests cut in one by one, optional flat refinement."""
    if molc is None:
        molc = groups[0].molc
    if params is None:
        params = default_params(molc, "prrn")
    mtx, _ = scoring.build_matrix(molc, params)

    hosts = [g for g in groups if g.many >= 2]
    guests = [g for g in groups if g.many < 2]
    if not hosts:
        raise ValueError("update_msa requires at least one aligned host")

    msd = hosts[0]
    for other in hosts[1:]:
        msd.prepare(mtx.shape[0])
        other.prepare(mtx.shape[0])
        _, skl, swapped = align_pair(msd, other, mtx, u=params.u,
                                     v=params.v, sh=params.sh, device=device)
        A, B = (other, msd) if swapped else (msd, other)
        msd = merge_msas(A, B, skl)
    for g in guests:
        msd = cut_in(msd, g, mtx, params, device=device)

    if refine and msd.many > 2:
        msd.weight = None
        res = refine_msa(msd, mtx, u=params.u, v=params.v, sh=params.sh,
                         maxitr=maxitr, randseed=randseed,
                         crand=GlibcRand(1), nbatch=nbatch, group=group,
                         divmode=divmode, device=device)
        msd = res.msa
    return msd


def build_msa_guided(treefile: str, params: AlnParams | None = None,
                     maxitr: int = 10, randseed: int = 1,
                     refine: bool = True, *, device) -> Msa:
    """Progressive MSA along a user guide tree whose leaf labels are
    sequence file names (prrn5.cc:1834-1849 guidetree mode), followed by
    the update-path refinement.  A leaf file resolves as given, else
    beside the tree file."""
    text = Path(treefile).read_text()
    t, leaf_files = tree.parse_newick(text)
    base = Path(treefile).parent
    leaves = []
    molc = None
    for f in leaf_files:
        p = Path(f)
        if not p.exists():
            p = base / f
        recs = sniff_and_read(p)
        if molc is None:
            molc = ab.infer_molc(recs[0].seq)
        leaves.append(single(ab.encode(recs[0].seq.replace("-", ""), molc),
                             molc, recs[0].name))
    if params is None:
        params = default_params(molc, "prrn")
    mtx, _ = scoring.build_matrix(molc, params)
    msa = progressive_msa(leaves, t, mtx, u=params.u, v=params.v,
                          sh=params.sh, device=device)
    if refine and msa.many > 2:
        res = refine_msa(msa, mtx, u=params.u, v=params.v, sh=params.sh,
                         maxitr=maxitr, randseed=randseed,
                         crand=GlibcRand(1), device=device)
        msa = res.msa
    return msa


def build_msa_denovo_large(records, params: AlnParams, molc: int,
                           maxitr: int = 10, randseed: int = 1,
                           refine: bool = True, m_nearest: int = 8,
                           max_memb: int = 2 ** 31 - 1, group=None,
                           nbatch: int = 1, divmode: str = "tree",
                           dump_prefix: str | None = None, *,
                           device) -> Msa:
    """De-novo MSA for many sequences via the single-linkage forest
    (reference de_novo_prrn, prrn5.cc:1300-1332 + SlfPrrn::make_msa
    :1174-1260): sparse k-mer-filtered DP distance graph, Kruskal forest,
    per-subtree progressive + refinement, profile combination, leftover
    singletons cut in, final refinement.  With ``dump_prefix`` (``-e``)
    each sub-MSA is written to ``PREFIX.k`` instead of being merged, and
    the first is returned."""
    mtx, _ = scoring.build_matrix(molc, params)
    seqs = [ab.encode(r.seq.replace("-", ""), molc) for r in records]
    names = [r.name for r in records]
    n = len(seqs)

    edges = slforest.candidate_edges(
        seqs, molc, mtx, u=params.u, v=params.v, sh=params.sh,
        thr=params.thr, m_nearest=m_nearest, group=group, device=device)
    runstat.stamp(len(edges))         # edges built (prrn5.cc:1317)
    trees, singles = slforest.build_forest(n, edges, thr=params.thr,
                                           max_memb=max_memb)
    crand = GlibcRand(1)
    # the per-subtree progressive merges of the whole forest run as
    # level-synchronous group_align_batch launches (reference thread
    # fan-out, prrn5.cc:1151-1155)
    ts, leaves_lists = [], []
    for t_node in trees:
        t, leaf_ids = slforest.slnode_to_tree(t_node)
        ts.append(t)
        leaves_lists.append([single(seqs[i], molc, names[i])
                             for i in leaf_ids])
    sub_msas = []
    if ts:
        for m in progressive_msa_forest(ts, leaves_lists, mtx, u=params.u,
                                        v=params.v, sh=params.sh,
                                        group=group, device=device):
            if refine and m.many > 2:
                res = refine_msa(m, mtx, u=params.u, v=params.v,
                                 sh=params.sh, maxitr=maxitr,
                                 randseed=randseed, crand=crand,
                                 nbatch=nbatch, group=group,
                                 divmode=divmode, device=device)
                m = res.msa
            sub_msas.append(m)
    runstat.stamp(len(sub_msas))      # subtrees aligned (prrn5.cc:1149)

    if dump_prefix is not None and sub_msas:
        # -e: write each sub-MSA to PREFIX.N instead of merging
        # (prrn5.cc:1099-1107,1162-1172 piecewise workflow)
        for k, m in enumerate(sub_msas):
            write_native_block(m, f"{dump_prefix}.{k}")
        return sub_msas[0]

    if not sub_msas:
        # no edges below threshold: all-by-all, as the JAX package has it
        return build_msa(records, params=params, molc=molc, maxitr=maxitr,
                         randseed=randseed, refine=refine, group=group,
                         device=device)

    msd = sub_msas[0]
    for other in sub_msas[1:]:
        msd = update_msa([msd, other], params=params, molc=molc,
                         refine=False, device=device)
    for sid in singles:
        msd = cut_in(msd, single(seqs[sid], molc, names[sid]), mtx, params,
                     device=device)
    if refine and msd.many > 2 and (len(sub_msas) > 1 or singles):
        msd.weight = None
        res = refine_msa(msd, mtx, u=params.u, v=params.v, sh=params.sh,
                         maxitr=maxitr, randseed=randseed, crand=crand,
                         nbatch=nbatch, group=group, divmode=divmode,
                         device=device)
        msd = res.msa
    return msd
