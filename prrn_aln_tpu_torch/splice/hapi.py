"""High-level protein x genomic-DNA spliced alignment: the reference's
`aln -yl2 -L <genome> <protein>` gene-prediction mode ("Algorithm H",
src/fwd2h.h, dispatched from src/maln2.cc:1891,1911-1916).

Drives ops/spliced_h.forward_h_device (the K4 sweep and K4w walk on
the card, their plain versions on the CPU), re-walks the path into per-exon
records (the skl_rngH/verify equivalent, src/fwd2h.h:585-760), and
renders the reference's gene-structure output modes (-O0..-O5,
src/sqpr.cc Gff3Form/BedForm/ExonForm/IntronForm + the codon-spaced
alignment printout of PrintAln for tron rows).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .. import alphabet as ab
from .. import scoring
from ..config import default_params
from ..ops.spliced_h import forward_h_device
from ..ops.spliced_h_np import HParams
from .exin import Exin, build_exin
from .gsinfo import ExonRecord, GeneStructure, NEVSEL
from .penalty import IntronPenalty
from . import tron
from . import output as fmt

IP_EQU_K = 3                  # codepot.h:184
ALN_DEF_SH = -50              # aln.cc:573


def stripe31(M: int, N: int, sh: int):
    """Codon-stepped band over r = n - 3m (aln2.cc:176-196 stripe31)."""
    if sh < 0:
        shld = 3 * ((-sh) * min(M, N // 3) // 100)
    else:
        shld = 3 * sh
    lw = max(-shld, -3 * M)
    up = min(N - 3 * M + shld, N)
    return lw, up


def build_qprof(a: np.ndarray, tm: np.ndarray) -> np.ndarray:
    """Per-residue tron score rows; row M+1 duplicates M for the sj
    lookahead (mseq profile layout, single-sequence case)."""
    M = len(a)
    qprof = np.zeros((M + 2, tron.TSIMD))
    for m in range(1, M + 1):
        qprof[m] = tm[a[m - 1]]
    qprof[M + 1] = qprof[M]
    return qprof


def _fold(code: int) -> int:
    if code == tron.SER2:
        return ab.SER
    return code


def trim_terminal(knots):
    """Drop terminal-gap knots (fwd2h lastH extensions past the last
    aligned codon; reference exons end at the last aligned nt)."""
    out = list(knots)
    while len(out) >= 2 and out[-1][0] == out[-2][0] \
            and out[-1][1] - out[-2][1] < 20:
        out.pop()
    while len(out) >= 2 and out[0][0] == out[1][0] \
            and 0 < out[1][1] - out[0][1] < 20:
        out.pop(0)
    return out


def gene_structure_h(a, b, knots, exin: Exin, ipen: IntronPenalty,
                     qprof, prm: HParams, codes=None, weight=None,
                     api=None) -> GeneStructure:
    """Re-walk the forward_h knot chain into ExonRecords (genome
    coordinates in nt, query coordinates in residues) — the skl_rngH /
    verify equivalent (src/fwd2h.h:585-760).

    Intron jumps are same-m knot pairs of length >= ipen.llmt (the DP
    only records such jumps at spliceable donor/acceptor pairs); the
    knot coordinates carry the acceptor-phase shift, so the true
    junction (nb, n3) is re-derived from the exin phase marks exactly
    as the reference verify does (fwd2h.h:745-790): phs5/phs3 taken at
    the jump ends with the ==2 crossing rule, boundary = knot - phs3,
    split codons re-scored with the chimeric junction codon
    (SpJunc::spjseq).  ``codes``/``weight``: optional member residue
    rows + normalized weights for weighted match statistics (profile
    query); falls back to the consensus ``a``."""
    trn = exin.trn
    knots = trim_terminal(knots)
    exons: list[ExonRecord] = []
    m, n = knots[0]
    hval = 0.0
    mch = mmc = unp = 0.0
    ngaps = 0
    rbuf = ExonRecord(left=n, rleft=m, iscr=NEVSEL)
    e_start_val = 0.0
    last_hvl = 0.0               # last diagonal codon's contribution
    pend_cs = None               # chimeric codon for next diag codon
    if codes is not None:
        wvec = np.asarray(weight, float) if weight is not None else \
            np.ones(codes.shape[0])
        wvec = wvec / wvec.sum()

    last_cnt = [0.0, 0.0, 0.0]   # last codon's (mch, mmc, unp) delta

    def count(mi, aa):
        """Weighted match statistics of query column mi vs tron aa."""
        nonlocal mch, mmc, unp
        fa = _fold(int(aa))
        if codes is not None:
            col = codes[:, mi - 1]
            gapm = col <= ab.GAP
            eqm = np.array([_fold(int(c)) == fa for c in col]) & ~gapm
            dm_ = float(wvec[eqm].sum())
            dmm = float(wvec[~eqm & ~gapm].sum())
            du = float(wvec[gapm].sum())
        elif fa == _fold(int(a[mi - 1])):
            dm_, dmm, du = 1.0, 0.0, 0.0
        else:
            dm_, dmm, du = 0.0, 1.0, 0.0
        last_cnt[:] = [dm_, dmm, du]
        mch += dm_
        mmc += dmm
        unp += du
        rbuf.mch += dm_
        rbuf.mmc += dmm
        rbuf.unp += du

    def diag(mm, nn, k):
        """Score/count one codon at residue mm+1+k, start nt nn+3k."""
        nonlocal hval, last_hvl, pend_cs
        mi = mm + 1 + k
        c = nn + 3 * k + 1          # codon center (0-based)
        if pend_cs is not None:
            # first codon after a phase!=0 acceptor: chimeric junction
            # codon, no sigE (verify `if (cs)` branch, fwd2h.h:701-706)
            aa = pend_cs
            pend_cs = None
            pm = prm.fO if aa in (tron.TRM, tron.TRM2) else 0.0
            last_hvl = float(qprof[mi][aa]) + pm
        else:
            aa = int(trn[c])
            last_hvl = float(qprof[mi][aa]) \
                + (float(exin.sigE[c]) if c >= 0 else 0.0)
        hval += last_hvl
        count(mi, aa)

    for wm, wn in knots[1:]:
        dm, dn = wm - m, wn - n
        if dm == 0 and dn == 0:
            continue
        if dm == 0 and dn >= ipen.llmt:
            # intron: re-derive the junction phase from the exin marks
            # (verify, fwd2h.h:745-765)
            p5 = int(exin.phs5[n]) if n < len(exin.phs5) else -2
            p3 = int(exin.phs3[wn]) if wn < len(exin.phs3) else -2
            phs5 = p3 if p5 == 2 else p5
            phs3 = p5 if p3 == 2 else p3
            xi_alt = NEVSEL
            if p5 == 2 and p3 == 2:      # GTGT....AGAG both phases
                nb_a = n + 1
                n3_a = nb_a + dn
                xi_alt = float(exin.sig5_at(nb_a)) \
                    + float(exin.sig53_at(nb_a, n3_a))
                if api:
                    xi_alt += api(3 * m + 1)
                phs3 = phs5 = 1
            if phs3 not in (-1, 0, 1):
                phs3 = 0
            nb = n - phs3
            n3 = nb + dn
            sig5 = float(exin.sig5_at(nb))
            sig3 = exin.sig3_at(n3)
            xi = sig5 + float(exin.sig53_at(nb, n3))
            if api:
                xi += api(3 * m - phs3)
            cs = None
            if phs3 != 0:
                aa1, aa2 = tron.spliced_codons(b, nb, n3)
                if phs3 == -1:
                    # split codon completes after the acceptor: score
                    # it as the chimeric codon (fwd2h.h:789 keeps cs
                    # only for phs3 == -1)
                    cs = aa2
                elif phs3 == 1:
                    # re-score the straddling pre-junction codon with
                    # the chimeric codon (fwd2h.h:768-774); its match
                    # statistics are reverted and not recounted
                    # (verify's `*fst = lst`)
                    pm = prm.fO if aa1 in (tron.TRM, tron.TRM2) \
                        else 0.0
                    xi += float(qprof[m][aa1]) + pm - last_hvl
                    mch -= last_cnt[0]
                    mmc -= last_cnt[1]
                    unp -= last_cnt[2]
                    rbuf.mch -= last_cnt[0]
                    rbuf.mmc -= last_cnt[1]
                    rbuf.unp -= last_cnt[2]
            if xi_alt > xi:
                phs3 = -1
                nb = n + 1
                n3 = nb + dn
                sig5 = float(exin.sig5_at(nb))
                sig3 = exin.sig3_at(n3)
                xi = xi_alt
                aa1, aa2 = tron.spliced_codons(b, nb, n3)
                cs = aa2
            xi += float(ipen.penalty(dn))
            pend_cs = cs
            rbuf.right = nb
            rbuf.rright = m
            rbuf.iscr = xi
            rbuf.phs = phs3      # 5'-side record carries the phase
            rbuf.sig5 = sig5
            rbuf.escr = hval + sig5 - e_start_val
            rbuf.mch3, rbuf.mmc3, rbuf.unp3 = rbuf.mch, rbuf.mmc, \
                rbuf.unp
            exons.append(dataclasses.replace(rbuf))
            hval += xi
            e_start_val = hval - sig3
            rbuf = ExonRecord(left=n3, rleft=m, sig3=sig3, iscr=NEVSEL)
            rbuf.mch = rbuf.mmc = rbuf.unp = 0
        elif dm > 0 and dn == 3 * dm:
            for k in range(dm):
                diag(m, n, k)
        elif dn == 0:
            # vertical: unpaired query residues
            unp += dm
            rbuf.unp += dm
            ngaps += 1
            hval += prm.gop + dm * prm.unp
        else:
            # mixed run: diagonal codons first, then the gap remainder
            # (fwd2h's record chain stores bends lazily; a mixed jump
            # is diag-then-gap by construction of the lanes)
            d = min(dm, dn // 3)
            for k in range(d):
                diag(m, n, k)
            rest = dn - 3 * d
            if rest:
                ngaps += 1
                if rest % 3 == 0:
                    # codon-unit genome-only advance = unpaired codons
                    unp += rest // 3
                    rbuf.unp += rest // 3
                    hval += prm.gop + (rest // 3) * prm.unp
                else:
                    hval += prm.gop + rest * prm.gep + prm.extra_gop
            if dm - d > 0:
                unp += dm - d
                rbuf.unp += dm - d
                ngaps += 1
                hval += prm.gop + (dm - d) * prm.unp
        m, n = wm, wn

    rbuf.right = n
    rbuf.rright = m
    rbuf.iscr = 0.0
    rbuf.escr = hval - e_start_val
    rbuf.mch3, rbuf.mmc3, rbuf.unp3 = rbuf.mch, rbuf.mmc, rbuf.unp
    exons.append(dataclasses.replace(rbuf))

    # terminal signals fold into the flanking exon scores (EijPat
    # sigS/sigT; ExonForm's Sig3/I and Sig5/T columns)
    if exin.sigS is not None and exons:
        first = exons[0]
        s = first.left + 1
        if 0 <= s < len(exin.sigS):
            first.sig3 = float(exin.sigS[s])
            first.escr += first.sig3
            hval += first.sig3
    if exin.sigT is not None and exons:
        last = exons[-1]
        if 0 <= last.right + 1 < len(exin.sigT):
            last.sig5 = float(exin.sigT[last.right + 1])
            last.escr += last.sig5
            hval += last.sig5

    return GeneStructure(score=hval, exons=exons, mch=mch, mmc=mmc,
                         gap=ngaps, unp=unp)


@dataclasses.dataclass
class SplicedResultH:
    score: float              # DP score (forward_h)
    knots: list
    gs: GeneStructure
    gname: str
    qname: str
    genome: str
    protein: str
    u: float
    v: float
    pam: int
    exin: Exin
    raw_knots: list = None     # untrimmed chain (terminal runs kept)
    msa: object = None         # query group (GSA multi-row display)

    @property
    def reported_score(self) -> float:
        """maln2.cc:1941: DP score minus GapPenalty(Ip_equ_k) per
        intron (gap penalty is negative, so this adds)."""
        gp = -(self.v + IP_EQU_K * self.u)
        return self.gs.score - gp * (len(self.gs.exons) - 1)

    @property
    def exons(self):
        return [(e.left + 1, e.right) for e in self.gs.exons]

    def render(self, mode: int = 1, markeij: int = 0) -> str:
        rep = self.reported_score
        glen = len(self.genome)
        qlen = len(self.protein)
        if mode in (0, 8):
            return fmt.gff3_gene(self.gs, self.gname, glen, self.qname,
                                 rep, feature="cds")
        if mode == 2:
            return fmt.gff3_match(self.gs, self.knots, self.gname, glen,
                                  self.qname,
                                  feature="nucleotide_to_protein_match",
                                  mstep=3)
        if mode == 3:
            return fmt.bed_line(self.gs, self.gname, self.qname, rep)
        if mode == 4:
            return fmt.exon_table(self.gs, self.genome, self.gname,
                                  self.qname, qlen, rep)
        if mode == 5:
            return fmt.intron_table(self.gs, self.genome, self.gname,
                                    self.qname, qlen)
        return spliced_alignment_text_h(
            self.gs, self.raw_knots or self.knots, self.genome,
            self.protein, self.exin, self.gname, self.qname, rep,
            u=self.u, v=self.v, pam=self.pam, msa=self.msa,
            markeij=markeij)


def profile_qprof(codes: np.ndarray, weight, tm: np.ndarray
                  ) -> np.ndarray:
    """MSA-profile query rows: weighted average of member tron-score
    rows (mseq VECPRO over the Hmtx, gap rows contribute the unp
    column; reference profile_p mseq.cc:413-435)."""
    many, M = codes.shape
    w = np.asarray(weight, float) if weight is not None else \
        np.ones(many)
    if w.ndim == 0:
        w = np.full(many, float(w))
    if w.sum():
        w = w / w.sum()
    qprof = np.zeros((M + 2, tron.TSIMD))
    for i in range(many):
        qprof[1:M + 1] += w[i] * tm[codes[i]]
    qprof[M + 1] = qprof[M]
    return qprof


def spliced_align_h(genome: str, protein, gname: str = "genome",
                    qname: str = "query", sh: int = ALN_DEF_SH,
                    u: float | None = None, v: float | None = None,
                    pam: int | None = None, yj: float | None = None,
                    intron_pos=None, msa=None,
                    species: str | None = None, *,
                    device) -> SplicedResultH:
    """Gene prediction: align a protein query to genomic DNA with
    introns (aln -yl2 -L).  intron_pos: optional sorted array of known
    tron-scale intron positions of the query (the -yJ GSA bonus).
    msa: optional Msa of the query group — the DP then runs against the
    weighted profile, with `protein` its consensus for display.
    device: torch device of the forward sweep and its walk."""
    genome = genome.upper()
    prm = default_params(ab.PROTEIN, "aln")
    if pam is None:
        pam = 150               # aln DNAxAA default (aln2.cc:124)
    if u is None:
        u = prm.u
    if v is None:
        v = prm.v
    pmtx, _ = scoring.protein_matrix(
        dataclasses.replace(prm, pam=pam, u=u, v=v))
    tm = tron.tron_matrix(pmtx, u=u, o=30.0)
    b = ab.encode(genome, ab.DNA)
    if msa is not None:
        a = np.where(msa.codes[0] > ab.GAP, msa.codes[0],
                     ab.AMB).astype(np.int64)
        protein = ab.decode(a, ab.PROTEIN)
        qprof = profile_qprof(msa.codes, msa.weight, tm)
    else:
        protein = protein.upper()
        a = ab.encode(protein, ab.PROTEIN)
        qprof = build_qprof(a, tm)
    tabs, ipkw = None, {}
    if species:
        from .species import load_species, ipen_kwargs
        sp = load_species(species)
        tabs = sp["tabs"] or None
        ipkw = ipen_kwargs(sp)
    exin = build_exin(b, tabs=tabs)
    ipen = IntronPenalty.build(f=1.0, y=8.0, sss=0.5, u=u, v=v,
                               ip=15.0, fact=8.0, **ipkw)
    hprm = HParams(u=u, v=v)
    lw, up = stripe31(len(a), len(b), sh)
    api = None
    bonus = 20.0 if yj is None else yj
    if intron_pos is None and msa is not None and msa.eij is not None:
        # GSA profile: the -yJ bonus at each annotated junction is
        # SpbFact * dns (weighted member share, gsinfo.h:215
        # PfqItr::match_score; dns = sum of fitted weights of sharing
        # members, gsinfo.h:120) — at our normalized scale,
        # bonus * sum(w_share)/sum(w)
        from ..msa.sigii import merged_pfq
        w = msa.weight if msa.weight is not None else \
            np.ones(msa.many)
        pfq = merged_pfq(msa.codes, msa.eij, w, step=3)
        if pfq:
            dns = {pos: d / float(np.sum(w)) for pos, _, d in pfq}

            def api(pt):
                return bonus * dns.get(int(pt), 0.0)
    elif intron_pos is not None and len(intron_pos):
        pos = np.asarray(intron_pos)

        def api(pt):
            return bonus if np.any(pos == pt) else 0.0

    score, raw = forward_h_device(qprof, b, exin, ipen, hprm, lw, up,
                                  api=api, device=device)
    knots = trim_terminal(raw)
    gs = gene_structure_h(a, b, knots, exin, ipen, qprof, hprm,
                          codes=(msa.codes if msa is not None else None),
                          weight=(msa.weight if msa is not None
                                  else None), api=api)
    return SplicedResultH(score=score, knots=knots, gs=gs, gname=gname,
                          qname=qname, genome=genome, protein=protein,
                          u=u, v=v, pam=pam, exin=exin, raw_knots=raw,
                          msa=msa)


def spliced_alignment_text_h(gs: GeneStructure, knots, genome: str,
                             protein: str, exin: Exin, gname: str,
                             qname: str, reported: float, u: float,
                             v: float, pam: int, lpw: int = 60,
                             margin: int = 10,
                             raw: float | None = None,
                             msa=None, markeij: int = 0) -> str:
    """Default -O1 printout: codon-spaced rows — translated genome on
    top, genome nt (introns lowercase) in the middle, query residues on
    the bottom (sqpr.cc PrintAln over tron sequences).  With ``msa``
    every member of the query group is printed (GSA display,
    sqpr.cc:1686 fphseq over all rows); ``markeij`` colors each
    member's intron-position residues like the prrn -pi/-ph modes
    (sqpr.cc:2133-2142 markiis) and suppresses the score block, like
    the reference's -pi output."""
    many = msa.many if msa is not None else 1
    dispname = msa.names[0] if msa is not None else qname
    hdr = [""]
    hdr.append(f">{gname} [1:{len(genome)}]  ( 1 - {len(genome)} ) - "
               f">{dispname} [{many}:{len(protein)}]"
               f"  ( 1 - {len(protein)} )"
               if msa is not None else
               f">{gname} [1:{len(genome)}]  ( 1 - {len(genome)} ) - "
               f">{qname} [1:{len(protein)}]  ( 1 - {len(protein)} )")
    hdr.extend(fmt.cjoin_wrapped(gs))
    if not markeij:
        hdr.append("PAM = %d, BIAS = 0.0, u = %.1f, v = %.1f"
                   % (pam, u, v))
        denom = gs.mch + gs.mmc + gs.unp
        pct = 100.0 * gs.mch / denom if denom else 0.0
        hdr.append("Score = %5.1f (%5.1f), %.1f (=), %.1f (#), "
                   "%.1f (g), %.1f (u), (%5.2f %%)"
                   % (reported, gs.score if raw is None else raw,
                      gs.mch, gs.mmc, gs.gap, gs.unp, pct))
        if msa is not None and msa.weight is not None:
            wl = ""
            for k in range(many):
                wl += " %14.7e" % msa.weight[k]
                if (k + 1) % 5 == 0 and k + 1 < many:
                    wl += "\n%"
            hdr.append("%" + wl)
        hdr.append("ALIGNMENT   1 / 1")
    text = "\n".join(hdr) + "\n"

    introns = [(e0.right, e1.left) for e0, e1 in
               zip(gs.exons, gs.exons[1:])]

    def in_intron(g):
        return any(s <= g < e for s, e in introns)

    trn = exin.trn
    timg, gimg, pimg = [], [], []
    gpos, ppos = [], []
    m, n = knots[0]
    for wm, wn in knots[1:]:
        dm, dn = wm - m, wn - n
        if dm == 0 and dn == 0:
            continue
        if dm > 0 and dn == 3 * dm:
            for k in range(dm):
                c = n + 3 * k + 1
                aa = tron.TRON_LETTERS[int(trn[c])]
                qa = protein[m + k]
                for j in range(3):
                    gpos.append(n + 3 * k + j)
                    ppos.append(m + k)
                    gimg.append(genome[n + 3 * k + j])
                    timg.append(aa if j == 1 else " ")
                    pimg.append(qa if j == 1 else " ")
        elif dm == 0:
            intr = dn >= 20 or in_intron(n)
            term = m == 0 or m == len(protein)
            if intr or term:
                for k in range(dn):
                    gpos.append(n + k)
                    ppos.append(m)
                    gimg.append(genome[n + k].lower())
                    timg.append(" ")
                    pimg.append(" ")
            elif dn % 3 == 0:
                # codon-unit genome-only gap: keep the codon cells
                for k in range(dn // 3):
                    c = n + 3 * k + 1
                    aa = tron.TRON_LETTERS[int(trn[c])]
                    for j in range(3):
                        gpos.append(n + 3 * k + j)
                        ppos.append(m)
                        gimg.append(genome[n + 3 * k + j])
                        timg.append(aa if j == 1 else " ")
                        pimg.append("-" if j == 1 else " ")
            else:
                for k in range(dn):
                    gpos.append(n + k)
                    ppos.append(m)
                    gimg.append(genome[n + k])
                    timg.append(" ")
                    pimg.append("-")
        else:
            d = min(dm, dn // 3) if dn else 0
            for k in range(d):
                c = n + 3 * k + 1
                aa = tron.TRON_LETTERS[int(trn[c])]
                qa = protein[m + k]
                for j in range(3):
                    gpos.append(n + 3 * k + j)
                    ppos.append(m + k)
                    gimg.append(genome[n + 3 * k + j])
                    timg.append(aa if j == 1 else " ")
                    pimg.append(qa if j == 1 else " ")
            rest = dn - 3 * d
            if rest % 3 == 0:
                for k in range(rest // 3):
                    c = n + 3 * d + 3 * k + 1
                    aa = tron.TRON_LETTERS[int(trn[c])]
                    for j in range(3):
                        gpos.append(n + 3 * d + 3 * k + j)
                        ppos.append(m + d)
                        gimg.append(genome[n + 3 * d + 3 * k + j])
                        timg.append(aa if j == 1 else " ")
                        pimg.append("-" if j == 1 else " ")
            else:
                for k in range(rest):
                    gpos.append(n + 3 * d + k)
                    ppos.append(m + d)
                    gimg.append(genome[n + 3 * d + k])
                    timg.append(" ")
                    pimg.append("-")
            for k in range(dm - d):
                qa = protein[m + d + k]
                for j in range(3):
                    gpos.append(n + dn)
                    ppos.append(m + d + k)
                    gimg.append("-")
                    timg.append("-" if j == 1 else " ")
                    pimg.append(qa if j == 1 else " ")
        m, n = wm, wn

    ncol = len(gimg)
    # case folding strictly by the FINAL gene structure (reference toCDS
    # semantics): exon bases uppercase, everything else (introns incl.
    # phase-split junction-codon bases, terminal skips) lowercase —
    # the raw knot segmentation can disagree by the acceptor/donor
    # phase shift
    exr = [( _e.left, _e.right) for _e in gs.exons]

    def in_exon(g):
        return any(l0 <= g < r0 for l0, r0 in exr)

    for j in range(ncol):
        if gimg[j] != "-":
            gimg[j] = (gimg[j].upper() if in_exon(gpos[j])
                       else gimg[j].lower())
    # member display rows: every letter cell in pimg shows member i's
    # character at the same profile column (GSA multi-row display)
    if msa is not None:
        from .. import alphabet as _ab
        mchr = [_ab.decode(msa.codes[i], msa.molc)
                for i in range(many)]
        mrows = []
        for i in range(many):
            row = []
            for j in range(ncol):
                ch = pimg[j]
                if ch not in (" ", "-"):
                    c = ppos[j]
                    ch = mchr[i][c] if c < len(mchr[i]) else " "
                row.append(ch)
            mrows.append(row)
        # residue numbering prefix per member
        pref = [np.cumsum([0] + [1 if c != "-" else 0
                                 for c in mchr[i]])
                for i in range(many)]
        marks = {}
        if markeij and msa.eij is not None:
            from ..io import _eij_marks
            marks = _eij_marks(msa)
    # translated-row junction-codon marks (PrintAln reij, sqpr.cc:2266-
    # 2272): the aa letter of the codon at each intron junction is
    # colored by the junction's coding phase p = (coding length so
    # far) % 3 -- the letter sits at the codon's center base, which
    # lands on the donor side for p == 2 (exon last base) and on the
    # acceptor side otherwise (p == 0: first acceptor codon center;
    # p == 1 split codon: first acceptor base).
    tmarks = {}
    if markeij and gs is not None and len(gs.exons) > 1:
        cum = 0
        for k in range(len(gs.exons) - 1):
            ex = gs.exons[k]
            nx = gs.exons[k + 1]
            cum += ex.right - ex.left
            ph = cum % 3
            if ph == 0:
                tmarks[nx.left + 1] = 41
            elif ph == 2:
                tmarks[ex.right - 1] = 44
            else:
                tmarks[nx.left] = 42
    z = 0
    while z < ncol:
        # long all-intron stretches get skipped like the cDNA printer
        if gimg[z].islower():
            e = z
            while e < ncol and gimg[e].islower():
                e += 1
            if e - z > lpw + 2 * margin:
                skip = (e - z - 2 * margin) // lpw * lpw
                if skip > 0:
                    text += "\n;; skip %d nt's\n" % skip
                    z += skip
                    continue
        text += "\n"
        tcells = list("".join(timg[z: z + lpw]).ljust(lpw))
        if tmarks:
            for kk in range(z, min(z + lpw, ncol)):
                bg = tmarks.get(int(gpos[kk]))
                if bg is not None and tcells[kk - z].strip():
                    if markeij == 2:
                        col = {41: "red", 42: "green",
                               44: "blue"}[bg]
                        tcells[kk - z] = ('<b><font color="white" '
                                          'style="background-color:'
                                          f'{col}">{tcells[kk - z]}'
                                          "</font></b>")
                    else:
                        tcells[kk - z] = (f"\x1b[37;{bg};1m"
                                          f"{tcells[kk - z]}\x1b[0m")
        tseg = "".join(tcells)
        gseg = "".join(gimg[z: z + lpw]).ljust(lpw)
        text += "         %s\n" % tseg
        text += "%8d %s| %s\n" % (gpos[z] + 1, gseg, gname)
        if msa is None:
            pseg = "".join(pimg[z: z + lpw]).ljust(lpw)
            # the query number is the first residue whose letter (codon
            # center) falls inside this block
            qnum = ppos[z] + 1
            for j in range(z, min(z + lpw, ncol)):
                if pimg[j] not in (" ", "-"):
                    qnum = ppos[j] + 1
                    break
            text += "%8d %s| %s\n" % (qnum, pseg, qname)
        else:
            for i in range(many):
                cells = mrows[i][z: z + lpw]
                qnum = None
                for j in range(z, min(z + lpw, ncol)):
                    ch = mrows[i][j]
                    if ch not in (" ", "-") and pimg[j] not in (" ", "-"):
                        qnum = int(pref[i][ppos[j]]) + 1
                        break
                if qnum is None:
                    qnum = int(pref[i][min(ppos[z], len(mchr[i]) - 1)]) + 1
                if marks:
                    cells = list(cells)
                    for j in range(z, min(z + lpw, ncol)):
                        if pimg[j] in (" ", "-"):
                            continue
                        bg = marks.get((i, ppos[j]))
                        if bg is not None:
                            if markeij == 2:
                                # HTML variant (-ph, iolib.cc:769-791)
                                col = {41: "red", 42: "green",
                                       44: "blue"}[bg]
                                cells[j - z] = (
                                    '<b><font color="white" '
                                    'style="background-color:'
                                    f'{col}">{cells[j - z]}'
                                    "</font></b>")
                            else:
                                cells[j - z] = (f"\x1b[37;{bg};1m"
                                                f"{cells[j - z]}"
                                                "\x1b[0m")
                pseg = "".join(cells)
                pad = lpw - min(z + lpw, ncol) + z
                text += "%8d %s| %s\n" % (qnum, pseg + " " * pad,
                                           msa.names[i])
        z += lpw
    text += "\n\n"
    if markeij == 2:
        # -ph wraps the whole printout like the reference's
        # HtmlCharCtl (iolib.cc:769-791)
        text = (f"<html>\n<head>\n<title>Prrn: {dispname}</title>\n"
                "</head>\n<body>\n<p>\n<pre>\n" + text
                + "</pre>\n</p>\n</body>\n")
    return text
