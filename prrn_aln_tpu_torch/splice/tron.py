"""TRON representation: codon-translated genomic DNA for protein x DNA
spliced alignment.

The reference converts a genomic sequence in place so that position i
holds the amino acid of the codon *centered* at i (src/seq.cc:706-731
nuc2tron / src/utilseq.cc:203-224 nuc2tron3), with two extra codes:
SER2 (serine from an AGy codon, =23 sharing ASX's slot) and TRM2 (TGA
stop, =24 sharing SEC/GLX's slot); TRM (TAA/TAG) = 25.  The protein x
tron substitution matrix is the protein matrix extended to 26 columns
(src/simmtx.cc:447-480 Simmtx::Hmtx).
"""

from __future__ import annotations

import numpy as np

from .. import alphabet as ab

SER2 = 23
TRM2 = 24
TRM = 25
TSIMD = 26
UNP = ab.GAP
AMB = ab.AMB

# reduced nucleotide code (A,C,G,T -> 0..3; ambiguous -> 4) over the
# bitset+1 DNA codes
_RED = np.full(ab.NSIMD + 1, 4, np.int8)
for _c, _r in ((2, 0), (3, 1), (5, 2), (9, 3)):   # A C G T
    _RED[_c] = _r

# element table: lowest set bit of the base bitset (reference ncelements)
_ELEM = np.zeros(ab.NSIMD + 1, np.int8)
for _c in range(2, ab.NSIMD + 1):
    _bits = _c - 1
    for _k in range(4):
        if _bits & (1 << _k):
            _ELEM[_c] = _k
            break

_A = ab
# genetic code, index = 16*c1 + 4*c2 + c3 over A,C,G,T = 0..3
# (src/utilseq.cc:36-41 gencode)
GENCODE = np.array([
    _A.LYS, _A.ASN, _A.LYS, _A.ASN, _A.THR, _A.THR, _A.THR, _A.THR,
    _A.ARG, _A.SER, _A.ARG, _A.SER, _A.ILE, _A.ILE, _A.MET, _A.ILE,
    _A.GLN, _A.HIS, _A.GLN, _A.HIS, _A.PRO, _A.PRO, _A.PRO, _A.PRO,
    _A.ARG, _A.ARG, _A.ARG, _A.ARG, _A.LEU, _A.LEU, _A.LEU, _A.LEU,
    _A.GLU, _A.ASP, _A.GLU, _A.ASP, _A.ALA, _A.ALA, _A.ALA, _A.ALA,
    _A.GLY, _A.GLY, _A.GLY, _A.GLY, _A.VAL, _A.VAL, _A.VAL, _A.VAL,
    TRM, _A.TYR, TRM, _A.TYR, _A.SER, _A.SER, _A.SER, _A.SER,
    TRM2, _A.CYS, _A.TRP, _A.CYS, _A.LEU, _A.PHE, _A.LEU, _A.PHE,
], np.int8)

# first-base-ambiguous fallback by middle base (utilseq.cc most_abund)
_MOST_ABUND = np.array([_A.LYS, _A.ALA, _A.GLY, _A.LEU], np.int8)

# tron code -> display letter (seq.cc:57 acodon; index-2 = residue)
TRON_LETTERS = "--XARNDCQEGHILKMFPSTWYVJUO"


def codon_aa(c1: int, c2: int, c3: int) -> int:
    """Translate one codon of DNA codes (nuc2tron3 semantics)."""
    if c2 <= ab.GAP:
        return UNP
    r2 = int(_RED[c2])
    if r2 >= 4:
        return AMB
    r1 = int(_RED[c1]) if c1 > ab.GAP else 4
    if r1 >= 4:
        return int(_MOST_ABUND[r2])
    aa = int(GENCODE[16 * r1 + 4 * r2 + int(_ELEM[c3]) if c3 > ab.GAP
             else 16 * r1 + 4 * r2])
    if aa == _A.SER and c2 == 5:      # middle G: AGy serine
        aa = SER2
    elif aa == TRM and c2 == 5:       # TGA handled by gencode already
        aa = TRM2
    return aa


def nuc2tron(codes: np.ndarray) -> np.ndarray:
    """Vectorised centered-codon translation: tron[i] = aa of codon
    (i-1, i, i+1) (seq.cc:706-731).  Boundaries mirror the reference's
    guard-byte behavior: position 0 translates with an ambiguous first
    base (most_abund fallback), position L-1 with an 'A' third base."""
    b = np.asarray(codes, np.int64)
    L = len(b)
    out = np.full(L, AMB, np.int8)
    if L < 3:
        return out
    c1 = np.concatenate([[0], b[:-1]])     # nil guard before 0
    c2 = b
    c3 = np.concatenate([b[1:], [0]])      # nil guard after L-1
    r1, r2 = _RED[c1], _RED[c2]
    e3 = _ELEM[c3]
    idx = 16 * np.clip(r1, 0, 3).astype(np.int64) + \
        4 * np.clip(r2, 0, 3).astype(np.int64) + e3
    aa = GENCODE[idx].astype(np.int8)
    aa = np.where((aa == _A.SER) & (c2 == 5), SER2, aa)
    aa = np.where(r1 >= 4, _MOST_ABUND[np.clip(r2, 0, 3)], aa)
    aa = np.where(r2 >= 4, AMB, aa)
    aa = np.where(c2 <= ab.GAP, UNP, aa)
    out[:] = aa
    return out


def tron_matrix(pm: np.ndarray, u: float, o: float = 30.0,
                scale: float = 1.0) -> np.ndarray:
    """Protein x tron substitution matrix (Simmtx::Hmtx,
    simmtx.cc:447-480): protein matrix extended with SER2 = SER,
    TRM/TRM2 columns = -scale*o, UNP row/col = -scale*u."""
    tm = np.zeros((TSIMD, TSIMD))
    tm[:SER2, :SER2] = pm[:SER2, :SER2]
    for i in range(TSIMD):
        tm[i, SER2] = tm[SER2, i] = tm[_A.SER, i]
    unp_aas = -scale * u
    trm_aas = -scale * o
    for i in range(AMB, TSIMD):
        tm[UNP, i] = tm[i, UNP] = unp_aas
        tm[TRM2, i] = tm[i, TRM2] = trm_aas
        tm[TRM, i] = tm[i, TRM] = trm_aas
    tm[UNP, UNP] = 0.0
    tm[TRM2, TRM2] = tm[_A.CYS, _A.CYS]
    tm[ab.NIL, :] = tm[:, ab.NIL] = 0.0
    return tm


def spliced_codons(b: np.ndarray, n5: int, n3: int) -> tuple[int, int]:
    """The two junction-spanning codons of intron (n5, n3): exon ends
    before n5, resumes at n3 (SpJunc::spjseq + spliceTron,
    codepot.cc:88-120, seq.cc:691-705).  Returns (aa_phase1, aa_phase2):
    phase1 codon = (n5-2, n5-1, n3), phase2 = (n5-1, n3, n3+1)."""
    L = len(b)

    def at(i):
        return int(b[i]) if 0 <= i < L else ab.NIL

    aa1 = codon_aa(at(n5 - 2), at(n5 - 1), at(n3))
    aa2 = codon_aa(at(n5 - 1), at(n3), at(n3 + 1))
    return aa1, aa2
