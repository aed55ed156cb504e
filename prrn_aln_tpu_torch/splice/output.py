"""Gene-structure output formats (reference: src/sqpr.cc).

Implemented: GFF3 gene/exon (-O0), GFF3 cDNA_match with Gap= (-O2),
UCSC BED (-O3), exon table (-O4), intron table (-O5), CIGAR, VULGAR and
SAM lines, plus the ;C join(...) extended-FASTA annotation used by the
alignment printouts.
"""

from __future__ import annotations

from .gsinfo import GeneStructure, NEVSEL


def _site(x: int) -> int:
    return x + 1                  # SiteNo: 1-based position


def cjoin_wrapped(gs: GeneStructure, width: int = 57) -> list:
    """;C join(...) wrapped over continuation lines like the reference
    writer (seq.cc putcds: parts split after commas near ``width``)."""
    parts = [f"{_site(e.left)}..{e.right}" for e in gs.exons]
    lines = []
    cur = ";C join("
    for k, p in enumerate(parts):
        tok = p + ("," if k + 1 < len(parts) else ")")
        if len(cur) + len(tok) > width + 3 and cur not in (";C ",
                                                          ";C join("):
            lines.append(cur)
            cur = ";C "
        cur += tok
    lines.append(cur)
    return lines


def cjoin_line(gs: GeneStructure) -> str:
    parts = [f"{_site(e.left)}..{e.right}" for e in gs.exons]
    return ";C join(" + ",".join(parts) + ")"


def gff3_gene(gs: GeneStructure, gname: str, glen: int, qname: str,
              reported: float, mid: int = 1,
              feature: str = "exon") -> str:
    """-O0: gene/mRNA/exon records (sqpr.cc Gff3Form); protein queries
    emit `cds` features with a frame column instead of `exon`."""
    out = []
    first = gs.exons[0]
    last = gs.exons[-1]
    mname = f"{gname}_{(_site(first.left) + last.right) // 2000}"
    if mid == 1:
        out.append("##gff-version\t3")
    out.append(f"##sequence-region\t{gname} 1 {glen}")
    l, r = _site(first.left), last.right
    scr = int(reported)
    out.append(f"{gname}\tALN\tgene\t{l}\t{r}\t{scr}\t+\t.\t"
               f"ID=gene{mid:05d};Name={mname}")
    out.append(f"{gname}\tALN\tmRNA\t{l}\t{r}\t{scr}\t+\t.\t"
               f"ID=mRNA{mid:05d};Parent=gene{mid:05d};Name={mname}")
    for i, e in enumerate(gs.exons, 1):
        frame = str(e.phs) if feature == "cds" else "."
        out.append(f"{gname}\tALN\t{feature}\t{_site(e.left)}\t{e.right}"
                   f"\t{int(e.escr)}\t+\t{frame}\t"
                   f"ID={feature}{i:05d};Parent=mRNA{mid:05d};"
                   f"Name={mname};"
                   f"Target={qname} {_site(e.rleft)} {e.rright} +")
    return "\n".join(out) + "\n"


def gff3_match(gs: GeneStructure, skl, gname: str, glen: int,
               qname: str, mid: int = 1, feature: str = "cDNA_match",
               mstep: int = 1) -> str:
    """-O2: cDNA_match records with Gap= attributes (sqpr.cc Gff3PWA).

    The Gap attribute walks the skl knots that fall inside each exon,
    skipping the intron jumps themselves.
    """
    out = []
    first = gs.exons[0]
    last = gs.exons[-1]
    mname = f"{gname}_{(_site(first.left) + last.right) // 2000}"
    if mid == 1:
        out.append("##gff-version\t3")
    out.append(f"##sequence-region\t{gname} 1 {glen}")

    # walk the skl knots per exon: m = transcript, n = genome
    w = 1
    prv = skl[0]
    donor = False
    for e in gs.exons:
        gap_ops = []
        while w < len(skl) and skl[w][1] <= e.right + 1:
            dm = skl[w][0] - prv[0]          # transcript advance
            dn = skl[w][1] - prv[1]          # genome advance
            racc = e.left - skl[w][1]
            if dm == 0 and donor and -1 <= racc <= 1:
                prv = skl[w]
                w += 1
                continue                     # the intron jump itself
            donor = -1 <= (e.right - skl[w][1]) <= 1
            if dm == 0 and dn == 0:
                pass
            elif dn == 0:
                gap_ops.append(f"I{dm}")
            elif dm == 0:
                # genome-only advance: deletion vs the query, in query
                # units (codons) for protein matches
                gap_ops.append((f"D{dn // 3}" if mstep == 3
                                else f"D{dn}"))
            elif mstep == 3 and dn != mstep * dm:
                # codon-stepped mixed run: aligned codons then a
                # codon-unit genome-only remainder
                d = min(dm, dn // 3)
                if d:
                    gap_ops.append(f"M{d}")
                if dn - 3 * d:
                    gap_ops.append(f"D{(dn - 3 * d) // 3}")
                if dm - d:
                    gap_ops.append(f"I{dm - d}")
            else:
                gap_ops.append(f"M{dm}")
            prv = skl[w]
            w += 1
        out.append(f"{gname}\tALN\t{feature}\t{_site(e.left)}\t{e.right}"
                   f"\t{int(e.escr)}\t+\t.\t"
                   f"ID=match{mid:05d};Name={mname};"
                   f"Target={qname} {_site(e.rleft)} {e.rright} +;"
                   f"Gap=" + " ".join(gap_ops) + " ")
    return "\n".join(out) + "\n"


def bed_line(gs: GeneStructure, gname: str, qname: str,
             reported: float, header: bool = True) -> str:
    """-O3 (sqpr.cc BedForm)."""
    out = []
    if header:
        out.append(f'track name=Spaln description="{qname}" useScore=1')
    gstart = gs.exons[0].left
    gend = gs.exons[-1].right
    sizes = ",".join(str(e.right - e.left) for e in gs.exons) + ","
    starts = ",".join(str(e.left - gstart) for e in gs.exons)
    out.append(f"{gname}\t{gstart}\t{gend}\t{qname}\t"
               f"{min(1000, int(reported))}\t+\t{gstart}\t{gend}\t"
               f"255,0,0\t{len(gs.exons)}\t{sizes}\t{starts}")
    return "\n".join(out) + "\n"


_EXN_HDR = ("# rID\t  gID\t   %id\t  ExonL\t MisMch\t Unpair\t "
            "ref_l\t  ref_r\t  tgt_l\t  tgt_r\t eScore\t IntrnL\t "
            "iScore\t Sig3/I\t Sig5/T  # -  X P DiNuc\n")


def exon_table(gs: GeneStructure, genome: str, gname: str, qname: str,
               qlen: int, reported: float, header: bool = True) -> str:
    """-O4 (sqpr.cc ExonForm)."""
    out = _EXN_HDR if header else ""
    fmt = ("%s\t%s\t%7.2f\t%7d\t%7d\t%7d\t%7d\t%7d\t%7d\t"
           "%7d\t%7.1f\t%7d\t%7.1f\t%7.2f\t%7.2f %2d %d %2d %d %s\n")
    iscr = 0.0
    ilen = 0
    miss = 0
    phase = 0
    cds = 0
    mch_t = 0
    mmc_t = unp_t = bmmc = bunp = 0
    intends = "  .  "
    prv = None
    for e in gs.exons:
        if prv is not None:
            bmmc_e = prv.mmc3 + e.mch5 * 0 + e.mmc5
            bunp_e = prv.unp3 + e.unp5
        else:
            bmmc_e = e.mmc5
            bunp_e = e.unp5
        exon = e.right - e.left
        rlen = (e.rright - e.rleft) + e.unp
        cds += exon
        mch_t += e.mch
        mmc_t += e.mmc
        unp_t += e.unp
        if prv is not None:
            bmmc += prv.mmc3 + e.mmc5
            bunp += prv.unp3 + e.unp5
        pmatch = 100.0 * e.mch / rlen if rlen else 0.0
        out += fmt % (qname, gname, pmatch, exon, e.mmc, e.unp,
                      _site(e.rleft), e.rright, _site(e.left), e.right,
                      e.escr, ilen, iscr, e.sig3, e.sig5,
                      bmmc_e, bunp_e, miss, phase, intends)
        iscr = e.iscr if e.iscr > NEVSEL else 0.0
        if e is not gs.exons[-1]:
            nxt = gs.exons[gs.exons.index(e) + 1]
            ilen = nxt.left - e.right
            phase = cds % 3
            intends = (genome[e.right] + genome[e.right + 1] + "."
                       + genome[nxt.left - 2] + genome[nxt.left - 1])
        prv = e
    first, last = gs.exons[0], gs.exons[-1]
    pmch = 100.0 * mch_t / qlen
    pcov = 100.0 * (mch_t + mmc_t) / qlen
    out += ("@ %s %c ( %d %d ) %s [%d:%d] ( %d %d ) S: %.1f =: %.1f "
            "C: %.1f T#: %d T-: %d B#: %d B-: %d X: %d Nexn: %d\n"
            % (gname, "+", _site(first.left), last.right, qname, 1, qlen,
               1, qlen, reported, pmch, pcov,
               mmc_t, unp_t, bmmc, bunp, 0, len(gs.exons)))
    return out


_ITN_HDR = ("# gID\tdir   Donor  Acceptor Phs     tgt_5     tgt_3\t"
            "refID\t  ref_l\t  ref_r\t  Match\tMisMach\t Unpair\t"
            "IntronL\tIntronEnd\n")


def intron_table(gs: GeneStructure, genome: str, gname: str,
                 qname: str, qlen: int, header: bool = True) -> str:
    """-O5 (sqpr.cc IntronForm)."""
    out = _ITN_HDR if header else ""
    fmt = "%s\t%c %9d %9d  %d  %9d %9d\t%s\t%7d\t%7d\t%7d\t%7d\t%7d\t%7d\t %s\n"
    cds = gs.exons[0].right - gs.exons[0].left
    for prv, wkr in zip(gs.exons, gs.exons[1:]):
        ie = (genome[prv.right - 1].lower() + genome[prv.right]
              + genome[prv.right + 1] + ".." + genome[wkr.left - 2]
              + genome[wkr.left - 1] + genome[wkr.left].lower())
        intv = wkr.left - prv.right
        mch = prv.mch3 + wkr.mch5
        mmc = prv.mmc3 + wkr.mmc5
        unp = prv.unp3 + wkr.unp5
        if prv.iscr > NEVSEL:
            out += fmt % (gname, "+", _site(prv.right), wkr.left,
                          cds % 3, _site(prv.left), wkr.right, qname,
                          _site(prv.rleft), wkr.rright, mch, mmc, unp,
                          intv, ie)
        cds += wkr.right - wkr.left
    first, last = gs.exons[0], gs.exons[-1]
    out += ("@ %s %c ( %d %d ) %s [%d:%d] ( %d %d )\n"
            % (gname, "+", _site(first.left), last.right, qname, 1,
               qlen, 1, qlen))
    return out


def cigar_line(gs: GeneStructure, gname: str, qname: str, skl) -> str:
    fst, lst = skl[0], skl[-1]
    parts = [f"{op} {ln}" for op, ln in gs.cigar]
    return (f"cigar: {qname} {fst[0]} {lst[0]} + {gname} {fst[1]} "
            f"{lst[1]} + {int(gs.score)} " + " ".join(parts) + "\n")


def vulgar_line(gs: GeneStructure, gname: str, qname: str, skl) -> str:
    fst, lst = skl[0], skl[-1]
    parts = [f"{t[0]} {t[1]} {t[2] if len(t) > 2 else t[1]}"
             for t in gs.vulgar]
    return (f"vulgar: {qname} {fst[0]} {lst[0]} + {gname} {fst[1]} "
            f"{lst[1]} + {int(gs.score)} " + " ".join(parts) + "\n")


def sam_line(gs: GeneStructure, gname: str, qname: str, skl,
             qseq: str, qlen: int) -> str:
    pos = _site(skl[0][1])
    mapq = 30 + int(100 * (gs.mmc + gs.unp) / qlen)
    cig = "".join(f"{ln}{op}" for op, ln in gs.samops)
    return (f"{qname}\t0\t{gname}\t{pos}\t{mapq}\t{cig}\t*\t0\t0\t"
            f"{qseq}\t*\n")


def spliced_alignment_text(gs: GeneStructure, skl, genome: str, cdna: str,
                           gname: str, qname: str, reported: float,
                           u: float = 2.0, v: float = 6.0,
                           match: float = 2.0, mism: float = -4.0,
                           lpw: int = 60, margin: int = 10) -> str:
    """Default aln output: headers + blocked alignment with lowercase
    introns, blanked transcript rows and ';; skip N nt's' markers
    (reference sqpr.cc print2/PrintAln::printaln with SkipLongGap)."""
    hdr = [""]
    hdr.append(f">{gname} [1:{len(genome)}]  ( 1 - {len(genome)} ) - "
               f">{qname} [1:{len(cdna)}]  ( 1 - {len(cdna)} )")
    hdr.append(cjoin_line(gs))
    hdr.append("s[=] (%.1f), s[#] (%.1f), u = %.1f, v = %.1f"
               % (match, mism, u, v))
    denom = gs.mch + gs.mmc + gs.unp
    pct = 100.0 * gs.mch / denom if denom else 0.0
    hdr.append("Score = %5.1f (%5.1f), %.1f (=), %.1f (#), %.1f (g), "
               "%.1f (u), (%5.2f %%)"
               % (reported, gs.score, gs.mch, gs.mmc, gs.gap, gs.unp, pct))
    hdr.append("ALIGNMENT   1 / 1")
    text = "\n".join(hdr) + "\n"

    introns = [(e0.right, e1.left) for e0, e1 in
               zip(gs.exons, gs.exons[1:])]

    def in_intron(g):
        return any(s <= g < e for s, e in introns)

    # build alignment columns, diagonal-first per skl segment
    gimg, cimg = [], []
    gpos, cpos = [], []            # consumed counts before each column
    m, n = skl[0]
    for wm, wn in skl[1:]:
        dm, dn = wm - m, wn - n
        d = min(dm, dn)
        for _ in range(d):
            gpos.append(n)
            cpos.append(m)
            gimg.append(genome[n])
            cimg.append(cdna[m])
            m += 1
            n += 1
        for _ in range(dm - d):    # insertion in transcript
            gpos.append(n)
            cpos.append(m)
            gimg.append("-")
            cimg.append(cdna[m])
            m += 1
        for _ in range(dn - d):    # gap in transcript: intron or deletion
            gpos.append(n)
            cpos.append(m)
            if in_intron(n):
                gimg.append(genome[n].lower())
                cimg.append(" ")
            else:
                gimg.append(genome[n])
                cimg.append("-")
            n += 1

    ncol = len(gimg)
    gapset = {"-", " "}

    def gap_run(img, z):
        if img[z] not in gapset:
            return None
        s = z
        while s > 0 and img[s - 1] in gapset:
            s -= 1
        e = z
        while e < ncol and img[e] in gapset:
            e += 1
        return s, e

    z = 0
    while z < ncol:
        runs = [r for r in (gap_run(gimg, z), gap_run(cimg, z)) if r]
        if runs:
            s, e = min(runs, key=lambda r: r[1])
            upr = (e - z - margin) // lpw * lpw
            if z - s > margin and upr > 0:
                text += "\n;; skip %d nt's\n" % upr
                z += upr
                continue
        text += "\n"
        for img, pos, name in ((gimg, gpos, gname), (cimg, cpos, qname)):
            seg = "".join(img[z: z + lpw]).ljust(lpw)
            text += "%8d %s| %s\n" % (pos[z] + 1, seg, name)
        z += lpw
    text += "\n\n"
    return text
