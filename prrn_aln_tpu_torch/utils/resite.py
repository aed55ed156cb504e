"""Restriction-enzyme site search (reference src/resite.cc + the
``renzyme`` table, and the IUPAC pattern matcher of src/pattern.cc
simplepat/match).

The bundled ``prrn_aln_tpu/data/renzyme.txt`` is the reference's table
(name, IUPAC recognition pattern, cut offset[, rct]); an ``ALN_TAB`` copy
overrides it.  Matching is forward-strand degenerate-subset matching
(pattern char bits must cover the residue bits), positions are
0-based starts (printed 1-based like Seq::SiteNo).

Note: the reference binary only exposes this through the interactive
menu (utn_main's batch dispatch has no ``case 'r'`` and falls through
to usage()); our ``utn -z`` makes the same computation scriptable.
"""

from __future__ import annotations

import dataclasses
import os

# IUPAC nucleotide bit codes (A=1 C=2 G=4 T/U=8)
_IUPAC = {
    "A": 1, "C": 2, "G": 4, "T": 8, "U": 8,
    "R": 1 | 4, "Y": 2 | 8, "M": 1 | 2, "K": 4 | 8,
    "S": 2 | 4, "W": 1 | 8,
    "B": 2 | 4 | 8, "D": 1 | 4 | 8, "H": 1 | 2 | 8, "V": 1 | 2 | 4,
    "N": 15, "X": 15,
}


@dataclasses.dataclass
class Resite:
    name: str
    pattern: str          # IUPAC recognition sequence
    cut: int              # cut offset within the pattern
    rct: int = 0


def _table_path() -> str:
    root = os.environ.get("ALN_TAB")
    if root:
        p = os.path.join(root, "renzyme")
        if os.path.exists(p):
            return p
    # the table is read from the JAX package's data directory, not copied
    return os.path.join(os.path.dirname(__file__), "..", "..",
                        "prrn_aln_tpu", "data", "renzyme.txt")


def load_enzymes(path: str | None = None) -> list[Resite]:
    out = []
    with open(path or _table_path()) as fh:
        for ln in fh:
            parts = ln.split()
            if len(parts) < 3:
                continue
            out.append(Resite(parts[0], parts[1].upper(), int(parts[2]),
                              int(parts[3]) if len(parts) > 3 else 0))
    return out


def find_enzyme(name: str, enzymes: list[Resite] | None = None):
    """Case-insensitive prefix-exact lookup (resite.cc recogseq)."""
    for e in enzymes if enzymes is not None else load_enzymes():
        if e.name.lower() == name.lower():
            return e
    return None


def pattern_positions(seq: str, pattern: str) -> list[int]:
    """0-based start positions where the IUPAC ``pattern`` covers the
    sequence (simplepat semantics: every residue's possibility bits
    must be a subset of the pattern char's)."""
    sbits = [_IUPAC.get(c, 0) for c in seq.upper()]
    pbits = [_IUPAC.get(c, 15) for c in pattern.upper()]
    m = len(pbits)
    out = []
    for i in range(len(sbits) - m + 1):
        ok = True
        for j in range(m):
            sb = sbits[i + j]
            if sb == 0 or (sb & ~pbits[j]):
                ok = False
                break
        if ok:
            out.append(i)
    return out


def respos(seq: str, enz: Resite) -> list[int]:
    return pattern_positions(seq, enz.pattern)


def format_loc(locs: list[int]) -> str:
    """putloc layout (pattern.cc:356-366): tab + 10 per line, 1-based."""
    lines = []
    for i in range(0, len(locs), 10):
        lines.append("\t" + " ".join(f"{p + 1:5d}"
                                     for p in locs[i:i + 10]) + " ")
    return "\n".join(lines)


def all_sites(seq: str, min_n: int = 1, max_n: int = 2 ** 31 - 1,
              enzymes: list[Resite] | None = None):
    """allezm: every enzyme whose site count is in [min_n, max_n];
    duplicate consecutive recognition patterns are skipped
    (utn.cc:1310-1318)."""
    prev = None
    out = []
    for e in enzymes if enzymes is not None else load_enzymes():
        if e.pattern == prev:
            continue
        locs = respos(seq, e)
        if min_n <= len(locs) <= max_n:
            out.append((e, locs))
            prev = e.pattern
    return out
