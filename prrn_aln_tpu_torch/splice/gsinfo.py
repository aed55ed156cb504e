"""Gene-structure info: re-walk a spliced-alignment path and produce
per-exon records, per-intron scores and aggregate statistics.

Reference: src/fwd2s.h Fwd2s::verify and src/gsinfo.cc Eijnc
bookkeeping.  The walk re-scores the skl path, deciding for each long
horizontal run whether it is an intron (signal + length penalty beats
the affine gap penalty) and emitting EISCR-equivalent exon records.

Replicated reference quirks (single-sequence path):
* diagonal runs do not reset the gla/glb gap-run state (the a->many==1
  branch of verify has no update() call);
* the deletion branch counts no match/unpaired statistics (stt2 with
  the thickness-only iterator is a no-op);
* near-junction window statistics use a jneibr-length rolling queue of
  FSTAT snapshots, so "last-10-columns" counts span 9 residues.
"""

from __future__ import annotations

import dataclasses

import numpy as np

NEVSEL = -8.9e30
JNEIBR = 10              # alprm2.jneibr default
IP_EQU_K = 3             # codepot.h:184 — gap length equiv. to IntronPenalty


@dataclasses.dataclass
class ExonRecord:
    left: int = 0        # genome start boundary of the exon
    right: int = 0       # genome end boundary
    rleft: int = 0       # transcript start
    rright: int = 0      # transcript end
    mch: int = 0
    mmc: int = 0
    gap: int = 0
    unp: int = 0
    mch5: int = 0        # stats over the first jneibr columns
    mmc5: int = 0
    gap5: int = 0
    unp5: int = 0
    mch3: int = 0        # stats over the trailing jneibr-window
    mmc3: int = 0
    gap3: int = 0
    unp3: int = 0
    escr: float = 0.0    # exon score incl. trailing donor signal
    iscr: float = NEVSEL  # score of the following intron (0 for last)
    sig3: float = 0.0    # acceptor signal at exon start
    sig5: float = 0.0    # donor signal at exon end
    phs: int = 0


@dataclasses.dataclass
class GeneStructure:
    score: float         # verify re-score (reference fstat.val)
    exons: list
    mch: float = 0.0
    mmc: float = 0.0
    gap: float = 0.0
    unp: float = 0.0
    cigar: list = dataclasses.field(default_factory=list)
    vulgar: list = dataclasses.field(default_factory=list)
    samops: list = dataclasses.field(default_factory=list)

    @property
    def introns(self):
        out = []
        for e0, e1 in zip(self.exons, self.exons[1:]):
            out.append((e0.right, e1.left, e0.iscr, e0.sig5, e1.sig3))
        return out

    def reported_score(self, v: float = 6.0, u: float = 2.0,
                       dp_score: float | None = None) -> float:
        """Displayed total: DP score minus GapPenalty(Ip_equ_k) per
        intron (reference maln2.cc:1941)."""
        base = self.score if dp_score is None else dp_score
        gp = -(v + IP_EQU_K * u)
        return base - gp * (len(self.exons) - 1)


class _Fstat:
    __slots__ = ("mch", "mmc", "gap", "unp")

    def __init__(self, src=None):
        for f in self.__slots__:
            setattr(self, f, getattr(src, f) if src else 0.0)


class _OpList:
    """Run-length op collector (reference Cigar/Vulgar push)."""

    def __init__(self):
        self.rec = []

    def push(self, op, n, n2=None):
        if n == 0 and n2 in (None, 0) and op not in "53E":
            return
        if self.rec and self.rec[-1][0] == op and n2 is None:
            self.rec[-1] = (op, self.rec[-1][1] + n)
        elif n2 is None:
            self.rec.append((op, n))
        else:
            self.rec.append((op, n, n2))


def gene_structure(a, b, skl, signals, ipen, mtx, u=2.0, v=6.0,
                   exga=(True, True)) -> GeneStructure:
    """verify(): walk skl, score exons/introns, build ExonRecords."""
    a = np.asarray(a)
    b = np.asarray(b)
    la, lb = len(a), len(b)
    gop_ = -float(v)
    gep_ = -float(u)

    def unp_penalty(d):
        return d * gep_

    def gap_penalty(i):
        return gop_ + i * gep_ if i else 0.0

    def dullend(n):
        return n <= 0 or n >= lb

    hval = 0.0
    hgla = hglb = 0
    hi_val = None
    hi_gla = hi_glb = 0
    ha = hb = 0.0
    sig5 = sig3 = 0.0
    insert = deletn = intlen = preint = 0

    m, n = skl[0]
    fst = _Fstat()
    pst = _Fstat()
    fstque = [_Fstat() for _ in range(JNEIBR)]
    q = 0

    cigar = _OpList()
    vlgar = _OpList()
    samop = _OpList()
    if m:
        cigar.push("H", m)
        samop.push("H", m)

    exons: list[ExonRecord] = []
    rbuf = ExonRecord(left=n, rleft=m)

    def set_counts(nearjnc):
        rbuf.mch = int(fst.mch - pst.mch)
        rbuf.mmc = int(fst.mmc - pst.mmc)
        rbuf.gap = int(fst.gap - pst.gap)
        rbuf.unp = int(fst.unp - pst.unp)
        if nearjnc:
            rbuf.mch5, rbuf.mmc5 = rbuf.mch, rbuf.mmc
            rbuf.gap5, rbuf.unp5 = rbuf.gap, rbuf.unp
        rbuf.mch3 = int(fst.mch - fstque[q].mch)
        rbuf.mmc3 = int(fst.mmc - fstque[q].mmc)
        rbuf.unp3 = int(fst.unp - fstque[q].unp)
        rbuf.gap3 = int(fst.gap - fstque[q].gap)

    def store(nearjnc):
        nonlocal q
        set_counts(nearjnc)
        q = 0
        for fq in fstque:
            fq.mch = fq.mmc = fq.gap = fq.unp = 0.0

    def shift(nearjnc):
        nonlocal q
        if nearjnc:
            rbuf.mch5 = int(fst.mch - pst.mch)
            rbuf.mmc5 = int(fst.mmc - pst.mmc)
            rbuf.unp5 = int(fst.unp - pst.unp)
            rbuf.gap5 = int(fst.gap - pst.gap)
        fstque[q].__init__(fst)
        q = (q + 1) % JNEIBR

    for wm, wn in skl[1:]:
        mi = wm - m
        if insert and mi:                     # end of insertion run
            hval += unp_penalty(insert)
            if hi_val is not None and insert > intlen:
                hi_val += unp_penalty(insert - intlen)
            if hi_val is not None and hi_val >= hval:   # intron
                if preint:
                    cigar.push("D", preint)
                    samop.push("D", preint)
                    vlgar.push("G", 0, preint)
                cigar.push("N", intlen)
                samop.push("N", intlen)
                vlgar.push("5", 0, 2)
                vlgar.push("I", 0, intlen - 4)
                vlgar.push("3", 0, 2)
                hb = ha
                if rbuf.right - rbuf.left > 1:
                    exons.append(dataclasses.replace(rbuf))
                rbuf.left = rbuf.right + intlen
                rbuf.rleft = m
                rbuf.sig3 = sig3
                rbuf.iscr = NEVSEL
                hval, hgla, hglb = hi_val, hi_gla, hi_glb
                hi_val = None
                insert -= (preint + intlen)
            if insert:
                cigar.push("D", insert)
                samop.push("D", insert)
                vlgar.push("G", 0, insert)
                insert = intlen = preint = 0
        ni = wn - n
        if ni and deletn:
            vlgar.push("G", deletn, 0)
            deletn = 0
        i = mi - ni
        d = ni if i >= 0 else mi
        if d:                                  # diagonal run
            cigar.push("M", d)
            vlgar.push("M", d, d)
            nearjnc = (n + d) - rbuf.left == JNEIBR
            run = 0
            for _ in range(d):
                hval += float(mtx[a[m], b[n]])
                if a[m] == b[n]:
                    fst.mch += 1
                    if run < 0:
                        samop.push("X", -run)
                        run = 0
                    run += 1
                else:
                    fst.mmc += 1
                    if run > 0:
                        samop.push("=", run)
                        run = 0
                    run -= 1
                m += 1
                n += 1
                shift(nearjnc)
            if run > 0:
                samop.push("=", run)
            elif run < 0:
                samop.push("X", -run)
        if i > 0:                              # deletion (gap in genome)
            for _ in range(i):
                gop = 0.0 if dullend(n) else \
                    (gop_ if hgla >= hglb else 0.0)
                fst.gap += gop
                hval += gop + gep_
                hgla = 0
                hglb += 1
            deletn += i
            cigar.push("I", i)
            samop.push("I", i)
            vlgar.push("G", i, 0)
        elif i < 0:                            # insertion (gap in cDNA)
            i = -i
            n3 = n + i
            xi = NEVSEL
            if hi_val is None and i >= ipen.llmt:
                sig5 = float(signals.sig5[n])
                sig3 = float(signals.sig3[n3])
                xi = sig5 + signals.sig53_pair(n, n3) \
                    + ipen.penalty(i)
            if xi > gap_penalty(i) and xi > rbuf.iscr:
                preint = insert
                intlen = i
                rbuf.right = n
                rbuf.rright = m
                rbuf.iscr = xi
                rbuf.escr = hval + sig5 - hb
                rbuf.sig5 = sig5
                hi_val, hi_gla, hi_glb = hval + xi, hgla, hglb
                ha = hval + xi - sig3
                store(n - rbuf.left < JNEIBR)
                pst = _Fstat(fst)
            elif not (exga[0] and m == 0):
                gop = 0.0 if dullend(n) else \
                    (gop_ if hgla <= hglb else 0.0)
                fst.gap += gop
                fst.unp += i
                hval += gop
                hgla += i
                hglb = 0
            insert += i
        m, n = wm, wn

    if insert and not (exga[1] and m == la):
        cigar.push("D", insert)
        samop.push("D", insert)
        vlgar.push("G", 0, insert)
    if deletn:
        vlgar.push("G", deletn, 0)

    rbuf.escr = hval + fst.gap - hb
    rbuf.iscr = 0.0
    rbuf.sig5 = sig5
    rbuf.right = n
    rbuf.rright = m
    rbuf.mch = int(fst.mch - pst.mch)
    rbuf.mmc = int(fst.mmc - pst.mmc)
    rbuf.gap = int((fst.gap - pst.gap) / float(v))
    rbuf.unp = int(fst.unp - pst.unp)
    exons.append(dataclasses.replace(rbuf))

    if m < la:
        samop.push("H", la - m)

    return GeneStructure(
        score=hval, exons=exons,
        mch=fst.mch, mmc=fst.mmc,
        gap=fst.gap / gop_ if gop_ else 0.0,
        unp=fst.unp,
        cigar=cigar.rec, vulgar=vlgar.rec, samops=samop.rec)
