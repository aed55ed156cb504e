"""Substitution-matrix construction.

Builds the same numerical matrices as the reference's ``Simmtx`` layer
(reference: src/simmtx.cc:143-334) from the extracted PAM series asset:

* protein: PAM log-odds interpolated on a 10-PAM grid from the mutation-data
  series (``Pmtx``), dimension 25 (codes 0..24)
* DNA/RNA: IUPAC bitset match/mismatch grid (``Nmtx``), dimension 17

Matrices are plain float32 NumPy arrays; callers move them to device once.
"""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np

from . import alphabet as ab
from .config import AlnParams

# the PAM series asset, copied beside the reference
_DATA = Path(__file__).resolve().parent / "data"

PAMSTEP = 10
MAXPAM = 300
AAS = 24
AASCMB = AAS * (AAS + 1) // 2


@functools.lru_cache(maxsize=1)
def _mdm_series():
    z = np.load(_DATA / "mdm_series.npz")
    return z["tri"], z["nrmlf"], z["avtrc"]


def _tri_to_square(tri: np.ndarray) -> np.ndarray:
    """Lower-triangle (codes 1..24) -> full 25x25 symmetric matrix."""
    m = np.zeros((ab.ASIMD, ab.ASIMD), dtype=np.float64)
    k = 0
    for i in range(AAS):
        for j in range(i + 1):
            m[i + 1, j + 1] = m[j + 1, i + 1] = tri[k]
            k += 1
    return m


def protein_matrix(params: AlnParams) -> tuple[np.ndarray, dict]:
    """PAM mutation-data matrix, reference Pmtx (simmtx.cc:282-334)."""
    tri, nrmlf_s, avtrc_s = _mdm_series()
    fscl = params.scale / 10.0
    fbias = 10.0 * params.bias
    level = (params.pam + PAMSTEP - 1) // PAMSTEP
    if not 1 <= level <= MAXPAM // PAMSTEP:
        raise ValueError(f"pam {params.pam} out of range")
    m = _tri_to_square((tri[level] + fbias) * fscl)
    unp = -params.scale * params.u
    m[ab.AMB:, ab.GAP] = m[ab.GAP, ab.AMB:] = unp
    # selenocysteine scores as cysteine (simmtx.cc:326-328)
    m[:, ab.SEC] = m[:, ab.CYS]
    m[ab.SEC, :] = m[ab.CYS, :]
    m[ab.SEC, ab.GAP] = m[ab.GAP, ab.SEC] = unp
    m[ab.SEC, ab.SEC] = m[ab.CYS, ab.CYS]
    m[ab.GAP, ab.GAP] = 0.0
    m[:, ab.NIL] = m[ab.NIL, :] = 0.0
    info = {
        "pam": level * PAMSTEP,
        "nrmlf": (nrmlf_s[level] + fbias) * fscl,
        "avtrc": (avtrc_s[level] + fbias) * fscl,
        "minscr": m[ab.TRP, ab.CYS],
        "drange": m[ab.TRP, ab.TRP] - m[ab.TRP, ab.CYS],
    }
    return m.astype(np.float32), info


def _countbit(x: int) -> int:
    return bin(x).count("1")


def dna_matrix(params: AlnParams) -> tuple[np.ndarray, dict]:
    """IUPAC match/mismatch matrix, reference Nmtx (simmtx.cc:143-166).

    Score levels smn[0..4] with smn[0]=match, smn[4]=mismatch and midpoints
    interpolated (simmtx.cc:566-571 setNpam); pair level from shared bitset
    fraction with C integer division (simmtx.cc:31).
    """
    smn = [params.n_match, 0.0, 0.0, 0.0, params.n_mismatch]
    smn[1] = (smn[0] + smn[2]) / 2.0
    smn[3] = (smn[2] + smn[4]) / 2.0
    m = np.zeros((ab.NSIMD, ab.NSIMD), dtype=np.float64)
    unp = -params.scale * params.u
    for i in range(1, 16):          # bitsets
        ii = i + 1                  # codes 2..16
        for j in range(1, i):
            jj = j + 1
            lv = 4 - (9 * _countbit(i & j)) // _countbit(i) // _countbit(j) // 2
            m[ii, jj] = m[jj, ii] = params.scale * smn[lv]
        lv = 4 - (9 * _countbit(i)) // _countbit(i) // _countbit(i) // 2
        m[ii, ii] = params.scale * smn[lv]
        m[ab.GAP, ii] = m[ii, ab.GAP] = unp
        m[ab.NIL, ii] = m[ii, ab.NIL] = 0.0
    avtrc = (m[2, 2] + m[3, 3] + m[5, 5] + m[9, 9]) / 4.0  # A,C,G,T
    info = {"nrmlf": avtrc, "avtrc": avtrc,
            "minscr": m[2, 3], "drange": m[2, 2] - m[2, 3]}
    return m.astype(np.float32), info


def build_matrix(molc: int, params: AlnParams) -> tuple[np.ndarray, dict]:
    if molc == ab.PROTEIN:
        return protein_matrix(params)
    return dna_matrix(params)


def self_score(codes: np.ndarray, mtx: np.ndarray) -> float:
    """Sum of diagonal matrix entries over residues (aln2.cc:50-63
    selfAlnScr with many=1)."""
    return float(mtx[codes, codes].sum())


