"""Sequence/MSA utilities: the rdn / utn / utp capability set.

Reference: src/rdn.cc (MSA member extraction, duplicate removal, common-
gap elimination), src/utn.cc / src/utp.cc (composition, translation, ORF
finding, reverse complement).
"""

from __future__ import annotations

import numpy as np

from .. import alphabet as ab
from ..msa.msa import Msa

# standard genetic code, TCAG-ordered (codon = 16*b1 + 4*b2 + b3)
_TCAG_TABLE = ("FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRR"
               "IIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG")
_TCAG_IDX = {"T": 0, "C": 1, "A": 2, "G": 3}
_AA_OF_CODON = {
    (b1, b2, b3): _TCAG_TABLE[16 * _TCAG_IDX[b1] + 4 * _TCAG_IDX[b2]
                              + _TCAG_IDX[b3]]
    for b1 in "TCAG" for b2 in "TCAG" for b3 in "TCAG"
}


def _nt_letter(code: int) -> str | None:
    return {2: "A", 3: "C", 5: "G", 9: "T"}.get(int(code))


def composition(codes: np.ndarray, molc: int) -> dict[str, int]:
    decode = ab.AMINO_DECODE if molc == ab.PROTEIN else ab.NUCL_DECODE
    out: dict[str, int] = {}
    vals, counts = np.unique(codes[codes > ab.GAP], return_counts=True)
    for v, c in zip(vals, counts):
        ch = decode[v] if v < len(decode) else "?"
        out[ch] = out.get(ch, 0) + int(c)
    return out


def reverse_complement(codes: np.ndarray) -> np.ndarray:
    comp = ab.complement_codes()
    return comp[codes[::-1]]


def translate(codes: np.ndarray, frame: int = 0) -> str:
    """DNA codes -> protein string ('X' on ambiguity, '*' stops)."""
    out = []
    for i in range(frame, len(codes) - 2, 3):
        tri = tuple(_nt_letter(codes[i + k]) for k in range(3))
        out.append("X" if None in tri else _AA_OF_CODON[tri])
    return "".join(out)


def find_orfs(codes: np.ndarray, min_aa: int = 30):
    """(start, end, frame) of open reading frames on the given strand."""
    orfs = []
    for frame in range(3):
        aa = translate(codes, frame)
        start = None
        for i, ch in enumerate(aa):
            if ch == "M" and start is None:
                start = i
            elif ch == "*" and start is not None:
                if i - start >= min_aa:
                    orfs.append((frame + 3 * start, frame + 3 * (i + 1),
                                 frame))
                start = None
        if start is not None and len(aa) - start >= min_aa:
            orfs.append((frame + 3 * start, frame + 3 * len(aa), frame))
    return orfs


# ---------------------------------------------------------------------------
# rdn-style MSA editing

def extract_members(msa: Msa, keep: list[int]) -> Msa:
    return Msa(codes=msa.codes[keep].copy(), molc=msa.molc,
               names=[msa.names[i] for i in keep],
               weight=(msa.weight[keep] if msa.weight is not None else None))


def delete_common_gaps(msa: Msa) -> Msa:
    keep = (msa.codes > ab.GAP).any(axis=0)
    return Msa(codes=msa.codes[:, keep].copy(), molc=msa.molc,
               names=list(msa.names), weight=msa.weight)


def remove_duplicates(msa: Msa) -> Msa:
    seen = set()
    keep = []
    for i in range(msa.many):
        key = bytes(msa.codes[i][msa.codes[i] > ab.GAP])
        if key not in seen:
            seen.add(key)
            keep.append(i)
    return extract_members(msa, keep)


def justify(msa: Msa, left: bool = True) -> Msa:
    """Push residues of each row to one side (rdn -j)."""
    out = np.full_like(msa.codes, ab.GAP)
    for i in range(msa.many):
        res = msa.codes[i][msa.codes[i] > ab.GAP]
        if left:
            out[i, :len(res)] = res
        else:
            out[i, msa.length - len(res):] = res
    return Msa(codes=out, molc=msa.molc, names=list(msa.names),
               weight=msa.weight)
