"""Sequence / alignment file I/O.

Readers for the formats the reference suite consumes on its main paths
(multi-FASTA incl. the ``;C`` extended gene-structure comments, and the
native interleaved MSA format with a ``count length name`` header line;
reference: src/seq.cc fgetseq and format readers, seq.h:453-591), and
writers for native block, FASTA and CLUSTAL outputs (reference:
src/sqpr.cc).
"""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path

import numpy as np

from . import alphabet as ab
from .msa.msa import Msa


@dataclasses.dataclass
class SeqRecord:
    name: str
    seq: str                      # residue characters, may contain gaps
    comments: list[str] = dataclasses.field(default_factory=list)
    exons: list[tuple[int, int]] | None = None   # from ;C annotations
    eij: "np.ndarray | None" = None  # member-local tron junctions (;B)
    weight: float | None = None      # ``%`` line weight (native MSA)


_COORD_RE = re.compile(r"(\d+)\.\.(\d+)")


def _parse_exons(comments: list[str]) -> list[tuple[int, int]] | None:
    """Parse ``;C`` extended-FASTA exon coordinates (reference seq.h:594,
    README.md:30-79): join(...) / complement(join(...)) ranges, returned
    in transcription order (reversed for complement; seq.h:682-683)."""
    text = " ".join(c[2:].strip() for c in comments if c.startswith(";C"))
    if not text:
        return None
    exons = [(int(a), int(b)) for a, b in _COORD_RE.findall(text)]
    if "complement" in text and len(exons) > 1 and exons[0][0] < exons[-1][0]:
        exons.reverse()
    return exons


def read_fasta(path: str | Path) -> list[SeqRecord]:
    recs: list[SeqRecord] = []
    name, lines, comments = None, [], []
    ended = False            # `//` ends the entry (fgetseq); trailing
    for raw in Path(path).read_text().splitlines():   # report tables
        if raw.startswith(">"):                       # are skipped
            if name is not None:
                recs.append(SeqRecord(name, "".join(lines), comments,
                                      _parse_exons(comments)))
            name = raw[1:].split()[0] if len(raw) > 1 else "seq"
            lines, comments = [], []
            ended = False
        elif raw.startswith("//"):
            ended = True
        elif raw.startswith(";"):
            comments.append(raw)
        elif raw.strip() and name is not None and not ended:
            lines.append(re.sub(r"[\s\d]", "", raw))
    if name is not None:
        recs.append(SeqRecord(name, "".join(lines), comments,
                              _parse_exons(comments)))
    return recs


def _native_header_many(line: str) -> int:
    """Member count declared by a native-MSA ``>name [many:len]`` header
    (seq_NandL "native mfa?" scan, seq.h:484-490: sum of the numbers
    after every '[')."""
    return sum(int(m) for m in re.findall(r"\[(\d+)", line))


def read_native(path: str | Path) -> list[SeqRecord]:
    """Native interleaved/serial MSA: either a ``many len`` header line
    (Phylip-like, seq.h:463-470) or a ``>name [many:len]`` header
    (NATIVE_MF, seq.h:484-490), then interleaved ``pos SEQ| name``
    blocks or serial ``>name`` entries.  ``%`` weight lines are parsed
    and rescaled to sum to ``many`` (Seq::header_nat_aln,
    seq.cc:1470-1486); ``;b/;m`` intron-position blocks (put_SigII
    output) are converted back to per-member local junction
    coordinates."""
    lines = Path(path).read_text().splitlines()
    recs: list[SeqRecord] = []
    name, buf = None, []
    bpairs: list[tuple[int, int]] = []    # (pos, num) from ;b
    mlist: list[int] = []                 # 1-based members from ;m
    weights: list[float] = []             # % lines (_WGHT, seq.h:736-744)
    inter: dict[str, list[str]] = {}      # interleaved-block rows
    inter_order: list[str] = []
    blk = re.compile(r"\s*\d+ (.*)\| (\S+)\s*$")
    body = lines
    if lines and not lines[0].startswith(">"):
        body = lines[1:]                  # skip `many len` header
    for raw in body:
        bm = blk.match(raw)
        if bm:
            body, nm = bm.group(1), bm.group(2)
            if nm not in inter:
                inter[nm] = []
                inter_order.append(nm)
            inter[nm].append(re.sub(r"[\s\d]", "", body))
        elif raw.startswith(">"):
            if name is not None:
                recs.append(SeqRecord(name, "".join(buf)))
            name = raw[1:].split()[0] if len(raw) > 1 else "seq"
            buf = []
        elif raw.strip() == "/":
            continue
        elif raw.startswith(";b"):
            toks = raw[2:].replace(",", " ").split()
            bpairs += [(int(toks[k]), int(toks[k + 1]))
                       for k in range(0, len(toks) - 1, 2)]
        elif raw.startswith(";m"):
            mlist += [int(t) for t in raw[2:].split()]
        elif raw.startswith("%"):
            try:
                weights += [float(t) for t in raw[1:].split()]
            except ValueError:
                pass
        elif raw.startswith((";", "#")) or not raw.strip():
            continue
        elif name is not None:
            buf.append(re.sub(r"[\s\d]", "", raw))
    if inter:
        recs = [SeqRecord(nm, "".join(inter[nm])) for nm in inter_order]
    elif name is not None:
        recs.append(SeqRecord(name, "".join(buf)))
    if weights and recs:
        # rescale so the weights sum to `many` (header_nat_aln,
        # seq.cc:1477-1482); short/zero weight lists fall back to equal
        w = np.ones(len(recs)) if len(weights) < len(recs) else \
            np.asarray(weights[:len(recs)], float)
        f = w.sum() / len(recs)
        w = np.ones(len(recs)) if f < 1e-7 else w / f
        for r, wi in zip(recs, w):
            r.weight = float(wi)
    if bpairs and recs:
        step = 3 if ab.infer_molc(recs[0].seq) == ab.PROTEIN else 1
        per: dict[int, list[int]] = {}
        k = 0
        for pos, num in bpairs:
            mems = (mlist[k:k + num] if mlist
                    else [1] * 0)             # ;m absent: skip
            k += num
            for m in mems:
                # invert the alignment projection: local pos =
                # step*(residues before column pos//step) + phase
                row = recs[m - 1].seq
                col = pos // step if step == 3 else pos
                nres = sum(1 for c in row[:col] if c not in "- ")
                per.setdefault(m - 1, []).append(
                    step * nres + (pos % step if step == 3 else 0))
        for m, plist in per.items():
            recs[m].eij = np.asarray(sorted(plist), np.int64)
    return recs


def _sniff_body(line: str):
    """Map a record's first line to its reader (reference whichdb over
    the SeqDb descriptor table, dbs.cc; seq_NandL seq.h:453-505)."""
    if line.startswith(">"):
        return read_fasta
    if line.startswith("LOCUS"):
        return read_genbank
    if line.startswith("ID"):
        return read_embl
    if line.startswith("ENTRY"):
        return read_pir
    if line.startswith(("#", "%")):
        return read_gde
    if "MSF:" in line or line.startswith("!!"):
        return read_msf
    return None


def sniff_and_read(path: str | Path) -> list[SeqRecord]:
    lines = []
    with open(path) as f:
        for line in f:
            if line.strip():
                lines.append(line)
            if len(lines) >= 2:
                break
    if not lines:
        return []
    first = lines[0]
    if first.startswith(">") and _native_header_many(first) > 1:
        # `>name [many:len]` native-MSA header (NATIVE_MF,
        # seq.h:484-490) — NOT plain FASTA
        return read_native(path)
    rd = _sniff_body(first)
    if rd is not None:
        return rd(path)
    toks = first.split()
    if len(toks) >= 2 and toks[0].isdigit() and toks[1].isdigit():
        # `num len [name]` header (seq_NandL, seq.h:462-470): the body
        # may be native interleaved/serial or a foreign format repeated
        # num times (e.g. sample/pas/GDE_A = header + GenBank entries).
        body = _sniff_body(lines[1]) if len(lines) > 1 else None
        if body is not None and body is not read_fasta:
            text = Path(path).read_text()
            rest = text.split("\n", 1)[1] if "\n" in text else ""
            import tempfile
            with tempfile.NamedTemporaryFile("w", suffix=".seq",
                                             delete=False) as tf:
                tf.write(rest)
            return body(tf.name)
        return read_native(path)
    # no recognizable header at all: bare sequence (seq.h:505 single)
    return read_bare(path)


def records_to_msa(recs: list[SeqRecord], molc: int | None = None) -> Msa:
    if molc is None:
        molc = ab.infer_molc(recs[0].seq)
    rows = [r.seq for r in recs]
    L = max(len(r) for r in rows)
    rows = [r.ljust(L, "-") for r in rows]
    codes = np.stack([ab.encode(r, molc) for r in rows])
    eij = None
    if any(r.exons for r in recs) or any(r.eij is not None for r in recs):
        from .msa.sigii import eij_from_exons
        step = 3 if molc == ab.PROTEIN else 1
        eij = [r.eij if r.eij is not None else eij_from_exons(r.exons, step)
               for r in recs]
    weight = None
    if any(r.weight is not None for r in recs):
        weight = np.asarray([1.0 if r.weight is None else r.weight
                             for r in recs])
    return Msa(codes=codes, molc=molc, names=[r.name for r in recs],
               eij=eij, weight=weight)


# ---------------------------------------------------------------------------
# writers

def decode_row(msa: Msa, i: int) -> str:
    return ab.decode(msa.codes[i], msa.molc)


def write_fasta(msa: Msa, path=None) -> str:
    out = []
    for i, name in enumerate(msa.names):
        out.append(f">{name}")
        row = decode_row(msa, i)
        out += [row[j:j + 60] for j in range(0, len(row), 60)]
    text = "\n".join(out) + "\n"
    if path:
        Path(path).write_text(text)
    return text


def write_clustal(msa: Msa, path=None) -> str:
    out = ["CLUSTAL W (prrn_aln_tpu)", ""]
    rows = [decode_row(msa, i) for i in range(msa.many)]
    width = max(len(n) for n in msa.names) + 2
    for start in range(0, msa.length, 60):
        for name, row in zip(msa.names, rows):
            out.append(name.ljust(width) + row[start:start + 60])
        out.append("")
    text = "\n".join(out) + "\n"
    if path:
        Path(path).write_text(text)
    return text


def _sigii_lines(msa: Msa, width: int = 60) -> list[str]:
    """``;B/;b/;m`` intron-position block (sqpr.cc:2315-2351 put_SigII):
    merged junction positions in alignment tron coordinates with member
    counts, then 1-based member indices, wrapped at width-4 columns."""
    from .msa.sigii import merged_pfq
    pfq = merged_pfq(msa.codes, msa.eij, msa.weight, msa.step)
    if not pfq:
        return [";B 0 0"]
    lstnum = sum(len(mems) for _, mems, _ in pfq)
    out = [f";B {len(pfq)} {lstnum}"]
    lwd = width - 4 if width >= 10 else 56

    def wrap(tag, items, last):
        lines, buf = [], ""
        for it in items:
            buf += it
            if len(buf) > lwd:
                lines.append(tag + buf)
                buf = ""
        lines.append(tag + buf + last)
        return lines

    out += wrap(";b", [f" {p} {len(m)}," for p, m, _ in pfq[:-1]],
                f" {pfq[-1][0]} {len(pfq[-1][1])}")
    mems = [m + 1 for _, ms, _ in pfq for m in ms]
    out += wrap(";m", [f" {m}" for m in mems[:-1]], f" {mems[-1]}")
    return out


def _eij_marks(msa: Msa) -> dict[tuple[int, int], int]:
    """(member, column) -> ANSI background color for -pi intron marking
    (sqpr.cc:2133-2142 markiis: column pos//step, color by phase)."""
    from .msa.sigii import merged_pfq
    marks = {}
    for pos, mems, _ in merged_pfq(msa.codes, msa.eij, None, msa.step):
        if msa.step == 3:
            col, ccd = pos // 3, pos % 3 + 1
        else:
            col, ccd = pos, (pos - 1) % 3 + 1
        # iis_color: 1=red 2=green 3=blue (sqpr.cc:1917)
        bg = {1: 41, 2: 42, 3: 44}[ccd]
        for m in mems:
            marks[(m, col)] = bg
    return marks


# per-residue-code chemical classes for the consensus row
# (sqpr.cc:1388-1412 AaProp/proch; chemcode " .+_@C$.jo")
_PROCH0 = [0, 0, 0, 1, 2, 3, 3, 7, 3, 3, 1, 2, 4, 4, 2, 4, 6, 1, 1, 1,
           6, 6, 4, 3, 3]
_PROCH1 = [0, 0, 0, 7, 8, 8, 8, 9, 8, 8, 7, 8, 9, 9, 8, 9, 9, 7, 7, 7,
           9, 9, 9, 8, 8]
_CHEMCODE = " .+_@C$.jo"


def _csym_row(msa: Msa, start: int, width: int) -> str:
    """Per-block consensus/conservation row (sqpr.cc:1390-1475
    csym/chempro/logonuc, printed by calc_mrk after the member rows)."""
    out = []
    for c in range(start, min(start + width, msa.length)):
        col = msa.codes[:, c]
        vals, cnts = np.unique(col, return_counts=True)
        if (vals == 0).any():                    # BLANK present
            out.append(" ")
            continue
        ii = int(vals[int(np.argmax(cnts))])     # ties -> lowest code
        if len(vals) == 1:                       # conserved (incl. gap)
            out.append(ab.decode(np.array([ii]), msa.molc))
            continue
        if msa.molc == ab.PROTEIN:
            pres = [int(v) for v in vals if v >= ab.ALA]
            p, s = _PROCH0[ii], _PROCH1[ii]
            if all(_PROCH0[v] == p for v in pres):
                out.append(_CHEMCODE[p])
            elif all(_PROCH1[v] == s for v in pres):
                out.append(_CHEMCODE[s])
            else:
                out.append(" ")
        else:                                    # logonuc
            if ii <= ab.GAP:
                out.append(" ")
                continue
            bits = 0
            for v in vals:
                if 2 <= int(v) <= 16:
                    bits |= int(v) - 1
            n = (1 if (vals == ab.GAP).any() else 0) \
                + bin(bits & 0b1111).count("1")
            if n == 1:
                out.append(ab.decode(np.array([bits]), msa.molc))
            elif n == 2:
                out.append(ab.decode(np.array([bits + 1]),
                                     msa.molc).lower())
            else:
                out.append(" ")
    return "\t " + "".join(out).ljust(width)


def write_native_block(msa: Msa, path=None, width: int = 60,
                       markeij: int = 0, header_lines=None,
                       trailer: str = "", csym_min: int = 3) -> str:
    """Reference-style block output: header, then 60-column blocks with
    1-based residue start positions and '| name' trailers
    (sqpr.cc native print mode).  ``markeij=1`` colors intron-position
    residues with ANSI escapes instead of emitting the ;B block (the
    reference's -pi mode); ``markeij=2`` emits the HTML variant
    (reference -ph: HtmlCharCtl, iolib.cc:769-791, wraps the output in
    <html><body><pre> and marks junctions with <font> tags)."""
    rows = [decode_row(msa, i) for i in range(msa.many)]
    pos = [1] * msa.many
    first = msa.names[0] if msa.names else "msa"
    marks = (_eij_marks(msa) if markeij and msa.eij is not None else {})
    if header_lines is not None:
        # caller-framed output (e.g. the aln group-pair print2 header,
        # sqpr.cc:1133-1196)
        out = list(header_lines) + [""]
    elif markeij:
        out = [f">{first}", ""]
    else:
        out = ["",
               f">{first} [{msa.many}:{msa.length}]  ( 1 - {msa.length} )"]
        if msa.eij is not None:
            out += _sigii_lines(msa, width)
        out.append("")
    for start in range(0, msa.length, width):
        for i, row in enumerate(rows):
            seg = row[start:start + width]
            disp = seg.ljust(width)
            if marks:
                chars = list(disp)
                for c in range(start, min(start + width, msa.length)):
                    bg = marks.get((i, c))
                    if bg is not None:
                        k = c - start
                        if markeij == 2:
                            col = {41: "red", 42: "green",
                                   44: "blue"}[bg]
                            chars[k] = ('<b><font color="white" '
                                        'style="background-'
                                        f'color:{col}">{chars[k]}'
                                        "</font></b>")
                        else:
                            chars[k] = (f"\x1b[37;{bg};1m{chars[k]}"
                                        "\x1b[0m")
                disp = "".join(chars)
            out.append(f"{pos[i]:8d} {disp}| {msa.names[i]}")
            pos[i] += sum(1 for c in seg if c not in "- ")
        if msa.many >= csym_min:
            out.append(_csym_row(msa, start, width))
        out.append("")
    if out and out[-1] == "" and msa.many >= csym_min:
        out.pop()                     # reference ends after the last row
    text = "\n".join(out) + "\n" + trailer
    if markeij == 2:
        text = (f"<html>\n<head>\n<title>Prrn: {first}</title>\n"
                "</head>\n"
                "<body>\n<p>\n<pre>\n" + text
                + "</pre>\n</p>\n</body>\n")
    if path:
        Path(path).write_text(text)
    return text


def read_genbank(path: str | Path) -> list[SeqRecord]:
    """Minimal GenBank flat-file reader (LOCUS/ORIGIN records)."""
    recs = []
    name, seq, in_seq = None, [], False
    for line in Path(path).read_text().splitlines():
        if line.startswith("LOCUS"):
            if name:
                recs.append(SeqRecord(name, "".join(seq)))
            name = line.split()[1]
            seq, in_seq = [], False
        elif line.startswith("ORIGIN"):
            in_seq = True
        elif line.startswith("//"):
            in_seq = False
        elif in_seq:
            seq.append(re.sub(r"[\s\d]", "", line))
    if name:
        recs.append(SeqRecord(name, "".join(seq)))
    return recs


def read_embl(path: str | Path) -> list[SeqRecord]:
    """Minimal EMBL/SwissProt reader (ID/SQ records)."""
    recs = []
    name, seq, in_seq = None, [], False
    for line in Path(path).read_text().splitlines():
        if line.startswith("ID"):
            if name:
                recs.append(SeqRecord(name, "".join(seq)))
            name = line.split()[1].rstrip(";")
            seq, in_seq = [], False
        elif line.startswith("SQ"):
            in_seq = True
        elif line.startswith("//"):
            in_seq = False
        elif in_seq:
            seq.append(re.sub(r"[\s\d]", "", line))
    if name:
        recs.append(SeqRecord(name, "".join(seq)))
    return recs


def read_pir(path: str | Path) -> list[SeqRecord]:
    """PIR/CODATA reader (ENTRY ... SEQUENCE ... ///; reference SeqDb
    PIR descriptor, sample/pas/Codata).  Also accepts the ``>P1;name``
    NBRF variant."""
    text = Path(path).read_text()
    recs: list[SeqRecord] = []
    if text.lstrip().startswith(">"):          # NBRF: >P1;name / title / seq*
        name, seq, skip_title = None, [], False
        for line in text.splitlines():
            if line.startswith(">"):
                if name:
                    recs.append(SeqRecord(name, "".join(seq).rstrip("*")))
                name = line.split(";", 1)[-1].split()[0]
                seq, skip_title = [], True
            elif skip_title:
                skip_title = False
            elif name:
                seq.append(re.sub(r"[\s\d]", "", line))
        if name:
            recs.append(SeqRecord(name, "".join(seq).rstrip("*")))
        return recs
    name, seq, in_seq = None, [], False
    for line in text.splitlines():
        if line.startswith("ENTRY"):
            if name:
                recs.append(SeqRecord(name, "".join(seq)))
            name = line.split()[1] if len(line.split()) > 1 else "seq"
            seq, in_seq = [], False
        elif line.startswith("SEQUENCE"):
            in_seq = True
        elif line.startswith("///"):
            in_seq = False
        elif in_seq:
            body = re.sub(r"[\s\d]", "", line)
            # column-ruler lines ("5 10 15 ...") reduce to empty
            seq.append(body)
    if name:
        recs.append(SeqRecord(name, "".join(seq)))
    return recs


def read_gde(path: str | Path) -> list[SeqRecord]:
    """GDE flat-file reader: records start with ``#name`` (DNA) or
    ``%name`` (protein) followed by sequence lines (reference SeqDb GDE
    descriptor; mirror of write_gde)."""
    recs: list[SeqRecord] = []
    name, seq = None, []
    for line in Path(path).read_text().splitlines():
        if line.startswith(("#", "%")):
            if name:
                recs.append(SeqRecord(name, "".join(seq)))
            name = line[1:].split()[0] if len(line) > 1 else "seq"
            seq = []
        elif name is not None:
            seq.append(re.sub(r"[\s\d]", "", line))
    if name:
        recs.append(SeqRecord(name, "".join(seq)))
    return recs


def read_msf(path: str | Path) -> list[SeqRecord]:
    """GCG MSF interleaved reader (reference get_msf_aln, seq.h:577)."""
    lines = Path(path).read_text().splitlines()
    order: list[str] = []
    body: dict[str, list[str]] = {}
    seen_sep = False
    for line in lines:
        if line.strip().startswith("//"):
            seen_sep = True
            continue
        if not seen_sep:
            m = re.search(r"Name:\s+(\S+)", line)
            if m and m.group(1) not in body:
                order.append(m.group(1))
                body[m.group(1)] = []
            continue
        toks = line.split()
        if toks and toks[0] in body:
            body[toks[0]].append(re.sub(r"[\s\d]", "",
                                        "".join(toks[1:])).replace(".", "-"))
    return [SeqRecord(nm, "".join(body[nm])) for nm in order]


def read_bare(path: str | Path) -> list[SeqRecord]:
    """Bare sequence text with no header (sample/nas/Bare): the whole
    file is one sequence; digits/whitespace stripped."""
    seq = re.sub(r"[\s\d]", "", Path(path).read_text())
    name = Path(path).name
    return [SeqRecord(name, seq)] if seq else []


def write_phylip(msa: Msa, path=None) -> str:
    rows = [decode_row(msa, i) for i in range(msa.many)]
    out = [f" {msa.many} {msa.length}"]
    for name, row in zip(msa.names, rows):
        out.append(f"{name[:10]:<10}{row[:50]}")
    pos = 50
    while pos < msa.length:
        out.append("")
        for row in rows:
            out.append(" " * 10 + row[pos:pos + 50])
        pos += 50
    text = "\n".join(out) + "\n"
    if path:
        Path(path).write_text(text)
    return text


def write_msf(msa: Msa, path=None) -> str:
    """GCG MSF interleaved output."""
    rows = [decode_row(msa, i).replace("-", ".") for i in range(msa.many)]
    width = max(len(n) for n in msa.names) + 2
    out = [f"  MSA  MSF: {msa.length}  Type: "
           f"{'P' if msa.molc == 1 else 'N'}  Check: 0  ..", ""]
    for name in msa.names:
        out.append(f" Name: {name:<{width}} Len: {msa.length}  Check: 0  "
                   f"Weight: 1.00")
    out += ["", "//", ""]
    for start in range(0, msa.length, 50):
        for name, row in zip(msa.names, rows):
            seg = row[start:start + 50]
            blocks = " ".join(seg[i:i + 10] for i in range(0, len(seg), 10))
            out.append(f"{name:<{width}} {blocks}")
        out.append("")
    text = "\n".join(out) + "\n"
    if path:
        Path(path).write_text(text)
    return text


def write_nexus(msa: Msa, path=None) -> str:
    """NEXUS data block (reference NEXUS print mode, seq.h:100-103)."""
    rows = [decode_row(msa, i) for i in range(msa.many)]
    dt = "protein" if msa.molc == 1 else "dna"
    width = max(len(n) for n in msa.names) + 2
    out = ["#NEXUS", "", "begin data;",
           f"  dimensions ntax={msa.many} nchar={msa.length};",
           f"  format datatype={dt} gap=- interleave;", "  matrix"]
    for start in range(0, msa.length, 60):
        for name, row in zip(msa.names, rows):
            out.append(f"  {name:<{width}}{row[start:start + 60]}")
        out.append("")
    out += ["  ;", "end;"]
    text = "\n".join(out) + "\n"
    if path:
        Path(path).write_text(text)
    return text


def write_gde(msa: Msa, path=None) -> str:
    out = []
    for i, name in enumerate(msa.names):
        out.append(f"{'%' if msa.molc == 1 else '#'}{name}")
        row = decode_row(msa, i)
        out += [row[j:j + 60] for j in range(0, len(row), 60)]
    text = "\n".join(out) + "\n"
    if path:
        Path(path).write_text(text)
    return text


def write_gaps_list(msa: Msa, path=None) -> str:
    """Per-member gap-structure snapshot in the reference GapsList
    format (mgaps.cc:31 ``Gaps structure: %d`` + folded " gps gln"
    pairs per member; prrn5.cc:287 IterMsa::prntgap).  Folded records
    carry the member's ungapped residue position of each gap run; the
    first pair is the record-count header, the last the terminator
    (gln = -1, the reference's gaps_end sentinel)."""
    lines = [f"Gaps structure: {msa.many}"]
    for i in range(msa.many):
        row = msa.codes[i]
        runs = []
        pos = 0           # ungapped position
        run = 0
        for c in row:
            if c <= ab.GAP:
                run += 1
            else:
                if run:
                    runs.append((pos, run))
                    run = 0
                pos += 1
        if run:
            runs.append((pos, run))
        rec = [(0, len(runs) + 2)] + runs + [(pos, -1)]
        lines.append("".join(f" {g} {l}" for g, l in rec))
    text = "\n".join(lines) + "\n"
    if path:
        Path(path).write_text(text)
    return text


def read_gaps_list(path) -> list[list[tuple[int, int]]]:
    """Parse a GapsList snapshot (write_gaps_list / reference
    GapsList(FILE*), mgaps.cc); returns per-member folded gap runs
    [(ungapped_pos, len), ...] without header/terminator."""
    toks = Path(path).read_text().split("\n", 1)
    if not toks[0].startswith("Gaps structure:"):
        raise ValueError("not a gaps structure file")
    num = int(toks[0].split(":")[1])
    out = []
    for line in toks[1].splitlines()[:num]:
        vals = [int(x) for x in line.split()]
        nrec = vals[1]
        pairs = [(vals[2 * k], vals[2 * k + 1]) for k in range(1, nrec - 1)]
        out.append(pairs)
    return out


def apply_gaps_list(msa: Msa, glist) -> Msa:
    """Rebuild aligned rows from ungapped member sequences + a gap
    snapshot (prrn5.cc:294 IterMsa::readgap): every member's gaps are
    re-inserted at the recorded ungapped positions."""
    rows = []
    for i in range(msa.many):
        seq = msa.codes[i][msa.codes[i] > ab.GAP]
        out = []
        k = 0
        runs = dict(glist[i]) if i < len(glist) else {}
        for p, c in enumerate(seq):
            if p in runs:
                out.extend([ab.GAP] * runs[p])
            out.append(int(c))
        if len(seq) in runs:
            out.extend([ab.GAP] * runs[len(seq)])
        rows.append(out)
    L = max(len(r) for r in rows)
    codes = np.full((msa.many, L), ab.GAP, np.int64)
    for i, r in enumerate(rows):
        codes[i, :len(r)] = r
    out = Msa(codes=codes, molc=msa.molc, names=list(msa.names),
              weight=msa.weight, tgapf=msa.tgapf, eij=msa.eij)
    return out


def tree_sorted(msa: Msa) -> Msa:
    """Row order by guide-tree leaf traversal (reference -ps output
    order: Msa::phylsort, prrn5.cc:1607-1618 lstodr over the Ssrel
    ktree)."""
    from .msa import distance as _dmod, tree as _tmod
    if msa.many <= 2:
        return msa
    d = _dmod.msa_distance_matrix(msa.codes)
    t = _tmod.upgma(d, msa.many)
    order = []

    def lstodr(i):
        if t.left[i] < 0:
            order.append(int(i))
        else:
            lstodr(int(t.left[i]))
            lstodr(int(t.right[i]))

    lstodr(2 * msa.many - 2)
    w = msa.weight[order] if msa.weight is not None else None
    eij = ([msa.eij[k] for k in order]
           if isinstance(msa.eij, list) else msa.eij)
    return Msa(codes=msa.codes[order], molc=msa.molc,
               names=[msa.names[k] for k in order], weight=w,
               tgapf=msa.tgapf, eij=eij)
