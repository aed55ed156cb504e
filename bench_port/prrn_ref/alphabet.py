"""Residue alphabets and integer encodings.

The framework uses the same integer code layout as the reference suite so
that substitution matrices, profiles and outputs are directly comparable
(reference: src/cmn.h:109-112, src/seq.cc:28-80):

* code 0 (``NIL``)  — padding / out-of-sequence sentinel
* code 1 (``GAP``)  — an alignment gap ('-')
* protein: 2=AMB('X'), 3..22 = the 20 amino acids in the order
  A R N D C Q E G H I L K M F P S T W Y V, 23=ASX('B'), 24=SEC/GLX('U'/'Z')
* nucleotide: 2..16 = the 15 IUPAC codes in "bit-set" order: each code's
  low 4 bits are the set of elementary bases {A=bit0, C=bit1, G=bit2, T=bit3}
  shifted so that code = bitset + 1:  A=2, C=3, M=4, G=5, R=6, S=7, V=8,
  T=9, W=10, Y=11, H=12, K=13, D=14, B=15, N=16.

Encoding is host-side NumPy (cheap, one pass per input); everything after
encoding is int8 arrays ready for device transfer.
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# molecule kinds
UNKNOWN, PROTEIN, DNA, RNA, TRON, GENOME = 0, 1, 2, 3, 4, 5

NIL = 0
GAP = 1

# protein codes (cmn.h:111)
AMB = 2
(ALA, ARG, ASN, ASP, CYS, GLN, GLU, GLY, HIS, ILE, LEU, LYS, MET, PHE,
 PRO, SER, THR, TRP, TYR, VAL) = range(3, 23)
ASX = 23
GLX = 24  # shares a code with SEC in the reference
SEC = 24
AAS = 24           # number of aa-ish codes counted from GAP (reference AAS)
ASIMD = AAS + 1    # protein matrix dimension (25)

# nucleotide codes (cmn.h:110): code = base-bitset + 1, N = 16
NTS = 16
NSIMD = NTS + 1    # DNA matrix dimension (17)

# ---------------------------------------------------------------------------
# char -> code tables

# 'A'..'Z' for protein (seq.cc:45 aacode); ZZZ/unknown -> AMB
_AA_OF_LETTER = {
    "A": ALA, "B": ASX, "C": CYS, "D": ASP, "E": GLU, "F": PHE, "G": GLY,
    "H": HIS, "I": ILE, "K": LYS, "L": LEU, "M": MET, "N": ASN, "O": AMB,
    "P": PRO, "Q": GLN, "R": ARG, "S": SER, "T": THR, "U": SEC, "V": VAL,
    "W": TRP, "X": AMB, "Y": TYR, "Z": GLX, "J": AMB,
}

# 'A'..'Z' for nucleotides (seq.cc:43 nccode); bitset order, U == T
_NT_OF_LETTER = {
    "A": 2, "C": 3, "M": 4, "G": 5, "R": 6, "S": 7, "V": 8, "T": 9,
    "U": 9, "W": 10, "Y": 11, "H": 12, "K": 13, "D": 14, "B": 15,
    "N": 16, "X": 16, "I": 16, "E": 16, "F": 16, "J": 16, "L": 16,
    "O": 16, "P": 16, "Q": 16, "Z": 16,
}

# decode strings (seq.cc:54-56)
NUCL_DECODE = "--ACMGRSVTWYHKDBN"
AMINO_DECODE = "--XARNDCQEGHILKMFPSTWYVBU"


def _make_table(mapping: dict[str, int]) -> np.ndarray:
    tab = np.zeros(256, dtype=np.int8)
    for ch, code in mapping.items():
        tab[ord(ch)] = code
        tab[ord(ch.lower())] = code
    tab[ord("-")] = GAP
    tab[ord(".")] = GAP
    tab[ord("*")] = GAP  # termination char scores as gap-ish; refined later
    return tab


_AA_TABLE = _make_table(_AA_OF_LETTER)
_NT_TABLE = _make_table(_NT_OF_LETTER)


def encode(seq: str, molc: int) -> np.ndarray:
    """Encode a residue string into int8 codes (no gaps removed)."""
    raw = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    tab = _AA_TABLE if molc == PROTEIN else _NT_TABLE
    return tab[raw]


def decode(codes: np.ndarray, molc: int) -> str:
    dec = AMINO_DECODE if molc == PROTEIN else NUCL_DECODE
    return "".join(dec[c] if 0 <= c < len(dec) else "?" for c in codes)


def infer_molc(seq: str) -> int:
    """Guess molecule type from residue composition (reference: seq.cc
    findseqtype semantics, simplified: >=75% ACGTUN -> nucleotide)."""
    letters = [c for c in seq.upper() if c.isalpha()]
    if not letters:
        return UNKNOWN
    nuc = sum(1 for c in letters if c in "ACGTUN")
    return DNA if nuc * 100 >= len(letters) * 75 else PROTEIN


def complement_codes() -> np.ndarray:
    """DNA complement in code space: bitset reversal (seq.cc:72 complcod)."""
    comp = np.zeros(NSIMD, dtype=np.int8)
    comp[NIL] = NIL
    comp[GAP] = GAP
    for code in range(2, NSIMD):
        bits = code - 1
        rev = (((bits & 1) << 3) | ((bits & 2) << 1) |
               ((bits & 4) >> 1) | ((bits & 8) >> 3))
        comp[code] = rev + 1
    return comp
