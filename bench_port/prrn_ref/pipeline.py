"""``prrn -R 0`` as the command line runs it on fewer than 16
sequences (``pipeline.build_msa`` with the command line's defaults:
``-S 10``, ``-YH 35``, ``-r 1``, ``-J 2``), on the plain kernels."""

from __future__ import annotations

from . import alphabet as ab
from . import scoring
from .config import default_params
from .msa import distance, tree
from .msa.msa import single
from .msa.progressive import progressive_msa
from .msa.refine import refine_with_consreg
from .utils.crand import GlibcRand

FOREST_MIN_SEQS = 16
HOST = "cpu"       # the reference runs on the host alone


def align_family(names: list[str], seqs: list[str]) -> list[tuple[str, str]]:
    """The final alignment of unaligned ``seqs`` as (name, aligned row)
    in output order."""
    if not 2 < len(seqs) < FOREST_MIN_SEQS:
        raise ValueError(f"align_family: {len(seqs)} sequences; the "
                         f"reference covers 3 to {FOREST_MIN_SEQS - 1}")
    molc = ab.infer_molc(seqs[0])
    params = default_params(molc, "prrn")
    mtx, _ = scoring.build_matrix(molc, params)
    codes = [ab.encode(s, molc) for s in seqs]
    d = distance.distance_matrix(codes, mtx, u=params.u, v=params.v,
                                 sh=params.sh, device=HOST)
    t = tree.upgma(d, len(codes))
    leaves = [single(c, molc, n) for c, n in zip(codes, names)]
    msa = progressive_msa(leaves, t, mtx, u=params.u, v=params.v,
                          sh=params.sh, spb=params.spb, device=HOST)
    msa = refine_with_consreg(msa, mtx, u=params.u, v=params.v,
                              sh=params.sh, maxitr=10, randseed=0,
                              crand=GlibcRand(1), spb=params.spb, nbatch=1,
                              divmode="tree", device=HOST).msa
    return [(msa.names[i], ab.decode(msa.codes[i], msa.molc))
            for i in range(msa.many)]
