"""End-to-end MSA pipeline (the prrn flagship path).

Counterpart of ``prrn_aln_tpu/pipeline.py::build_msa`` for fewer than 16
sequences: unaligned sequences -> all-pairs wavefront distances (kernel
K1) -> UPGMA guide tree (host) -> progressive profile alignment and
randomized iterative refinement (kernels K2 and K3), all on an explicit
``device`` (reference flow: prrn5.cc makemsa :961-987 + IterMsa::msa
:909-917).  The single-linkage forest for 16 or more sequences, and
``cut_in``, ``update_msa`` and ``build_msa_guided``, are not ported yet.
"""

from __future__ import annotations

from . import alphabet as ab
from . import scoring
from .config import AlnParams, default_params
from .io import SeqRecord
from .msa.msa import Msa, single
from .msa import distance, tree
from .msa.progressive import progressive_msa
from .msa.refine import refine_msa, refine_with_consreg
from .msa.sigii import eij_from_exons
from .utils.crand import GlibcRand

# prrn5's min_seqs: from this many sequences on, the JAX package builds
# the MSA over a single-linkage forest (pipeline.py:42)
FOREST_MIN_SEQS = 16


def build_msa(records: list[SeqRecord], params: AlnParams | None = None,
              molc: int | None = None, maxitr: int = 10,
              randseed: int = 1, refine: bool = True,
              local_thr: float = 35.0, nbatch: int = 1,
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
    if len(seqs) >= FOREST_MIN_SEQS:
        raise NotImplementedError(
            f"{len(seqs)} sequences: the single-linkage forest path "
            f"(N >= {FOREST_MIN_SEQS}) is not ported yet; see ROADMAP.md, "
            "queue A, item 7")

    d = distance.distance_matrix(seqs, mtx, u=params.u, v=params.v,
                                 sh=params.sh, device=device)
    t = tree.upgma(d, len(seqs))

    leaves = [single(s, molc, n, eij=e)
              for s, n, e in zip(seqs, names, exlist)]
    msa = progressive_msa(leaves, t, mtx, u=params.u, v=params.v,
                          sh=params.sh, spb=params.spb, device=device)
    if refine and msa.many > 2:
        crand = GlibcRand(1)
        if local_thr > 0:
            res = refine_with_consreg(msa, mtx, u=params.u, v=params.v,
                                      sh=params.sh, maxitr=maxitr,
                                      randseed=randseed, crand=crand,
                                      spb=params.spb, nbatch=nbatch,
                                      divmode=divmode, device=device)
        else:
            res = refine_msa(msa, mtx, u=params.u, v=params.v, sh=params.sh,
                             maxitr=maxitr, randseed=randseed, crand=crand,
                             spb=params.spb, nbatch=nbatch,
                             divmode=divmode, device=device)
        msa = res.msa
    return msa
