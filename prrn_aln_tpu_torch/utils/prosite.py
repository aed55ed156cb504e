"""PROSITE pattern machinery (reference src/prs.cc / pattern.cc
complexpat).

The reference's utp reads a user-supplied PROSITE distribution
(prosite.dat/.doc + index files built by `utp makdbs`-style tooling);
no data ships with it, so the parity surface is the pattern language
and the search:

    [AC]-x-V-x(4)-{ED}-A(2,4)-B.
    <  anchored at N-terminus, > at C-terminus
    [..] residue set, {..} negated set, x any, (n) / (n,m) repeats

`compile_pattern` turns one PROSITE pattern into a Python regex over
the plain residue-letter string; `scan` returns 0-based (start, end)
matches; `parse_dat` iterates (id, accession, pattern) records of a
prosite.dat-format file.
"""

from __future__ import annotations

import re

_AA = "ACDEFGHIKLMNPQRSTVWYBZX"


def compile_pattern(pat: str) -> re.Pattern:
    pat = pat.strip().rstrip(".")
    anchored_l = pat.startswith("<")
    anchored_r = pat.endswith(">")
    pat = pat.lstrip("<").rstrip(">")
    out = []
    for el in pat.split("-"):
        el = el.strip()
        if not el:
            continue
        m = re.fullmatch(r"(?P<core>\[[A-Za-z]+\]|\{[A-Za-z]+\}|[A-Za-z])"
                         r"(?:\((?P<lo>\d+)(?:,(?P<hi>\d+))?\))?", el)
        if not m:
            raise ValueError(f"bad PROSITE element: {el!r}")
        core = m.group("core")
        if core.startswith("["):
            rx = "[" + core[1:-1].upper() + "]"
        elif core.startswith("{"):
            rx = "[^" + core[1:-1].upper() + "]"
        elif core.upper() == "X":
            rx = "."
        else:
            rx = core.upper()
        if m.group("lo"):
            lo = m.group("lo")
            hi = m.group("hi")
            rx += f"{{{lo},{hi}}}" if hi else f"{{{lo}}}"
        out.append(rx)
    rx = "".join(out)
    if anchored_l:
        rx = "^" + rx
    if anchored_r:
        rx = rx + "$"
    return re.compile(rx)


def scan(seq: str, pattern: str | re.Pattern) -> list[tuple[int, int]]:
    """All (overlapping) 0-based [start, end) matches of a PROSITE
    pattern in a residue string."""
    rx = (compile_pattern(pattern) if isinstance(pattern, str)
          else pattern)
    seq = seq.upper().replace("-", "")
    out = []
    pos = 0
    while True:
        m = rx.search(seq, pos)
        if not m:
            break
        out.append((m.start(), m.end()))
        pos = m.start() + 1
    return out


def parse_dat(path: str):
    """Yield (id, accession, pattern) from a prosite.dat-format file
    (ID/AC/PA lines, ``//`` record separator; prs.cc FN_DAT)."""
    pid = acc = ""
    pat: list[str] = []
    with open(path) as fh:
        for ln in fh:
            if ln.startswith("ID"):
                pid = ln[2:].strip().rstrip(";").split(";")[0].strip()
            elif ln.startswith("AC"):
                acc = ln[2:].strip().rstrip(";")
            elif ln.startswith("PA"):
                pat.append(ln[2:].strip())
            elif ln.startswith("//"):
                if pid and pat:
                    yield pid, acc, "".join(pat)
                pid = acc = ""
                pat = []
    if pid and pat:
        yield pid, acc, "".join(pat)
