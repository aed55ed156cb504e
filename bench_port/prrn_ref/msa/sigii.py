"""Intron-position signals (SigII) for gene-structure-annotated MSAs.

The reference attaches to each sequence a list of exon-intron junction
positions in "tron" coordinates (3 units per protein residue, 1 per
nucleotide; reference: src/gsinfo.h:41-99 SigII, src/seq.h:905-1040
where ``;C`` exon coordinates are reduced to cumulative CDS offsets).
Junctions shared between groups earn a bonus SpbFact*dnsA*dnsB during
group DP (src/fwd2c.h:306-312 via PfqItr::match_score, gsinfo.h:221-229),
and the MSA-level WSP adds SpbFact * sum of pair weights over members
sharing a junction column (src/gsinfo.cc:1147-1183 spSigII).

Design difference from the reference (TPU-first): positions are stored
per member in *ungapped* member-local tron coordinates, which are
invariant under every alignment operation; alignment-column projections
and per-column phase density arrays are derived on demand.  The
reference instead rewrites gapped positions through every merge
(unfoldPfq / SigII(slist,...) with gap-play fusion); the invariant form
computes the same quantities without any bookkeeping during refinement.
"""

from __future__ import annotations

import numpy as np

from .. import alphabet as ab


def eij_from_exons(exons: list[tuple[int, int]] | None,
                   step: int = 3) -> np.ndarray | None:
    """Junction positions from ``;C`` exon ranges: cumulative exon
    lengths in nt, excluding the final total (the reference's num=0
    sentinel; seq.h:920-1040, prrn5.cc:1503-1516 mksigii).

    Exon (a, b) 1-based inclusive has length b-a+1 (the reference parses
    left-1/right and takes right-left; seq.cc:1244-1262 onecds)."""
    if not exons or len(exons) < 2:
        return None
    lens = [abs(b - (a - 1)) for a, b in exons]
    return np.cumsum(lens[:-1]).astype(np.int64)


def aln_positions(row: np.ndarray, eij: np.ndarray,
                  step: int = 3) -> np.ndarray:
    """Project member-local junction positions onto the (gapped) row.

    A junction at cumulative CDS offset ``pos`` anchors to residue
    ``a = (pos+1)//step`` (1-based; the residue whose codon contains or
    immediately precedes the junction — derived from the trigger
    condition ``cds < nres+2`` in seq.h:976) and shifts right by
    ``step`` per gap before that residue."""
    if eij is None or len(eij) == 0:
        return np.zeros(0, np.int64)
    res_cols = np.nonzero(row > ab.GAP)[0]
    nres = len(res_cols)
    if step == 3:
        anchor = (eij + 1) // 3
    else:
        anchor = eij.copy()
    anchor = np.clip(anchor, 0, nres)
    gaps_before = np.where(
        anchor > 0,
        res_cols[np.clip(anchor, 1, max(nres, 1)) - 1] - (anchor - 1),
        0) if nres else np.zeros_like(anchor)
    return eij + step * gaps_before


def eij_density(codes: np.ndarray, eij_list, weight: np.ndarray | None,
                step: int = 3) -> np.ndarray | None:
    """Per-codon-column phase density E[q, p] = sum of weights of members
    with a junction at tron position step*q+p — the dns field of the
    merged SigII pfq list (gsinfo.cc:127-215).  Returns None when no
    member carries signals."""
    if eij_list is None or not any(
            e is not None and len(e) for e in eij_list):
        return None
    many, L = codes.shape
    w = weight if weight is not None else np.ones(many)
    E = np.zeros((L + 1, 3))
    for m, e in enumerate(eij_list):
        if e is None or len(e) == 0:
            continue
        pos = aln_positions(codes[m], np.asarray(e, np.int64), step)
        q = np.clip(pos // step, 0, L)
        p = pos % step if step == 3 else np.zeros_like(pos)
        np.add.at(E, (q, p), w[m])
    return E


def merged_pfq(codes: np.ndarray, eij_list, weight: np.ndarray | None,
               step: int = 3):
    """Merged junction list over all members, grouped by exact projected
    tron position: [(pos, [members...], dns)] sorted by pos — the
    equivalent of SigII(slist, gsrc, wtlst) (gsinfo.cc:127-215) used for
    ;B output and the WSP intron term."""
    if eij_list is None:
        return []
    many = codes.shape[0]
    w = weight if weight is not None else np.ones(many)
    buckets: dict[int, list[int]] = {}
    for m, e in enumerate(eij_list):
        if e is None or len(e) == 0:
            continue
        for pos in aln_positions(codes[m], np.asarray(e, np.int64), step):
            buckets.setdefault(int(pos), []).append(m)
    out = []
    for pos in sorted(buckets):
        mems = buckets[pos]
        out.append((pos, mems, float(sum(w[m] for m in mems))))
    return out


def sp_sigii(codes: np.ndarray, eij_list, pairwt: np.ndarray | None,
             spb_fact: float, step: int = 3) -> float:
    """WSP intron-position term (gsinfo.cc:1147-1183 spSigII):
    SpbFact * sum over junction columns of sum_{i<j sharing} pairwt[i,j]
    (or C(num,2) unweighted)."""
    if spb_fact <= 0:
        return 0.0
    from .distance import condensed_index
    total = 0.0
    for _, mems, _ in merged_pfq(codes, eij_list, None, step):
        if len(mems) < 2:
            continue
        for jj in range(1, len(mems)):
            for ii in range(jj):
                if pairwt is not None:
                    total += pairwt[condensed_index(mems[ii], mems[jj])]
                else:
                    total += 1.0
    return spb_fact * total


def slice_eij(codes: np.ndarray, eij_list, lo: int, hi: int,
              step: int = 3):
    """Member-local junction lists for the column slice [lo, hi): shift
    by the residues before lo and keep junctions anchored inside."""
    if eij_list is None:
        return None
    out = []
    for m, e in enumerate(eij_list):
        if e is None or len(e) == 0:
            out.append(None)
            continue
        row = codes[m]
        r_lo = int((row[:lo] > ab.GAP).sum())
        r_hi = r_lo + int((row[lo:hi] > ab.GAP).sum())
        e = np.asarray(e, np.int64)
        anchor = (e + 1) // step if step == 3 else e
        keep = (anchor > r_lo) & (anchor <= r_hi)
        out.append(e[keep] - step * r_lo if keep.any() else None)
    return out
