"""Concerted gene-structure refinement (L6 pipeline, perl/refgs.pl).

The reference drives ``aln -yl2 -L`` + ``prrn5 -KP -U`` as subprocesses
(refgs.pl:466-524 ``onecycle`` / 619-702 ``conf``): each member of a
gene-structure-annotated MSA has its gene structure re-predicted by a
spliced alignment of its genomic region against a profile of the OTHER
members (M1 "minus one" mode), the family MSA is rebuilt, and the cycle
repeats until every member is unchanged or -I iterations are spent;
Dixon's outlier test flags suspect members (refgs.pl msa2ref /
Dixon.pm).  Here the whole loop is in-process: the spliced profile DP
is the fwd2h device kernel and the MSA rebuild is the prrn pipeline.

Counterpart of ``prrn_aln_tpu/refgs.py``: the spliced DP (kernels K4
and K4w) and the MSA rebuild (K1 to K3) run on an explicit ``device``.

Member status codes mirror conf()'s returns: "ok" (structure
unchanged), "changed" (re-predicted differently), "skip" (no genomic
source / not refinable).
"""

from __future__ import annotations

import dataclasses

import sys

import numpy as np

from . import alphabet as ab
from . import io
from .io import SeqRecord
from .msa import distance as dmod, tree as tmod
from .utils.seqtools import translate

AVE_EXON = 100          # refgs.pl $ave: margin pad around the gene


@dataclasses.dataclass
class RefgsResult:
    records: list            # refined SeqRecords (exons updated)
    msa: object              # rebuilt Msa (None if <2 members refined)
    status: dict             # name -> "ok" | "changed" | "skip"
    iters: int
    outliers: list           # Dixon-flagged member names


def _avg_intron(exons) -> int:
    """avrintlen (refgs.pl): mean intron length of the old structure."""
    if not exons or len(exons) < 2:
        return AVE_EXON
    gaps = [abs(b0[1] - b1[0]) for b0, b1 in zip(exons, exons[1:])]
    return int(sum(gaps) / len(gaps)) if gaps else AVE_EXON


def _profile_of(others: list[SeqRecord], dim: int):
    """Pair-weighted profile of the reference members (reCalcWt=2)."""
    msa = io.records_to_msa(others, ab.PROTEIN)
    if msa.many > 2:
        d = dmod.msa_distance_matrix(msa.codes)
        t = tmod.upgma(d, msa.many)
        msa.weight = tmod.calc_seq_weights(t)
    return msa.prepare(dim)


def refine_member(rec: SeqRecord, others: list[SeqRecord], genome: str,
                  offset: int = 0, species: str | None = None,
                  yj: float | None = None, sh: int = -50,
                  margin: int | None = None, *, device):
    """conf() for one member: re-predict its structure against the
    profile of the others inside the old-structure window +- margin
    (refgs.pl:630-645 margins from the average intron length)."""
    from .splice.hapi import spliced_align_h
    from . import scoring
    from .config import default_params

    prm = default_params(ab.PROTEIN, "aln")
    mtx, _ = scoring.build_matrix(ab.PROTEIN, prm)
    prof = _profile_of(others, mtx.shape[0])
    if margin is None:
        margin = _avg_intron(rec.exons) + AVE_EXON
    if rec.exons:
        left = max(0, min(min(e) for e in rec.exons) - 1 - margin)
        right = min(len(genome), max(max(e) for e in rec.exons) + margin)
        if left >= len(genome) or right <= left:
            # stale/foreign coordinates: fall back to the whole genome
            left, right = 0, len(genome)
    else:
        left, right = 0, len(genome)
    window = genome[left:right]
    res = spliced_align_h(window, None, gname="gene", qname=rec.name,
                          msa=prof, sh=sh, yj=yj, species=species,
                          device=device)
    new_exons = [(a + left + offset, b + left + offset)
                 for a, b in res.exons]
    cds = "".join(window[a - 1:b] for a, b in res.exons)
    aa = translate(ab.encode(cds.upper(), ab.DNA))
    if aa.endswith("*"):
        aa = aa[:-1]
    return new_exons, aa, res


def refgs_family(records: list[SeqRecord], genome_of, iters: int = 1,
                 species: str | None = None, yj: float | None = None,
                 sh: int = -50, quiet: bool = True,
                 rebuild: bool = True, *, device) -> RefgsResult:
    """The onecycle x -I loop over a family.

    ``genome_of(name)`` -> (genome_str, absolute_offset) or None for
    members without a genomic source (skipped, like refgs.pl's missing
    -n entries).
    """
    recs = [dataclasses.replace(r) for r in records]
    status = {r.name: "skip" for r in recs}
    it = 0
    for it in range(1, iters + 1):
        changed = False
        for i, rec in enumerate(recs):
            src = genome_of(rec.name)
            if src is None:
                status[rec.name] = "skip"
                continue
            genome, offset = src
            others = [r for j, r in enumerate(recs) if j != i]
            new_exons, aa, _ = refine_member(
                rec, others, genome, offset=offset, species=species,
                yj=yj, sh=sh, device=device)
            if rec.exons and list(map(tuple, rec.exons)) == new_exons \
                    and rec.seq.replace("-", "") == aa:
                status[rec.name] = "ok"
                if not quiet:
                    print(f"{rec.name}\tis OK", file=sys.stderr)
            else:
                status[rec.name] = "changed"
                changed = True
                if not quiet:
                    print(f"{rec.name}\trevised: {new_exons}",
                          file=sys.stderr)
                recs[i] = dataclasses.replace(rec, seq=aa,
                                              exons=new_exons, eij=None)
        if not changed:
            break

    msa = None
    outliers = []
    if rebuild and len(recs) > 1:
        from .pipeline import build_msa
        msa = build_msa(recs, maxitr=2, device=device)
        if msa.many > 3:
            from .msa.outliers import find_outliers
            from .config import default_params as _dp
            from . import scoring as _sc
            mtx, _ = _sc.build_matrix(msa.molc, _dp(msa.molc, "prrn"))
            d = dmod.msa_distance_matrix(msa.codes)
            t = tmod.upgma(d, msa.many)
            try:
                outs = find_outliers(msa, t, mtx)
                outliers = [msa.names[k] for k, o in enumerate(outs)
                            if o.flagged]
            except Exception:
                outliers = []
    return RefgsResult(records=recs, msa=msa, status=status, iters=it,
                       outliers=outliers)
