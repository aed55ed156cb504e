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

# the tables are read from the JAX package's data directory, not copied
_DATA = Path(__file__).resolve().parent.parent / "prrn_aln_tpu" / "data"

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


# Concurrent matrix slots (reference simmtx.h:31,65-81 Simmtxes /
# defPprm, simmtx.cc:58-59): slot 0 is the display/distance default,
# slot 1 the alignment matrix, slot 2 (WlnPamNo) the reduced-score
# matrix for Wilbur-Lipman HSP seeding (aln.cc:35,581 WlpPam=50).
# Note (DEVIATIONS.md #8): in the shipped prrn5 the slot bookkeeping
# collapses so the one PwdM is built from an effective pam150/u2/v9
# matrix -- which is exactly PRRN_DEFAULTS; the slots only diverge for
# aln's HSP tier and explicit -yp/-yq overrides.
DEF_PPRM = {0: dict(pam=100, u=4.0, v=10.0),
            1: dict(pam=150, u=2.0, v=9.0),
            2: dict(pam=250, u=2.0, v=9.0)}
WLN_PAM_NO = 2
WLP_PAM = 50


def slot_params(slot: int, base: AlnParams | None = None,
                pam: int | None = None) -> AlnParams:
    """AlnParams for matrix slot ``slot`` (reference defPprm defaults),
    optionally overriding the PAM level (setpam, simmtx.cc:551-553)."""
    import dataclasses
    d = dict(DEF_PPRM.get(slot, DEF_PPRM[0]))
    if pam is not None:
        d["pam"] = pam
    if base is None:
        base = AlnParams()
    return dataclasses.replace(base, pam=d["pam"], u=d["u"], v=d["v"],
                               mtx_no=slot)


def slot_matrix(molc: int, slot: int, base: AlnParams | None = None,
                pam: int | None = None) -> tuple[np.ndarray, dict]:
    """Build the substitution matrix for a slot (getSimmtx equivalent)."""
    return build_matrix(molc, slot_params(slot, base, pam))


def self_score(codes: np.ndarray, mtx: np.ndarray) -> float:
    """Sum of diagonal matrix entries over residues (aln2.cc:50-63
    selfAlnScr with many=1)."""
    return float(mtx[codes, codes].sum())


def read_matrix_file(path) -> np.ndarray:
    """Named text substitution matrix (BLAST layout: header row of
    residue letters, then one labelled row per residue), e.g.
    table/vtml200 or table/blosum62 — the reference's ``-mS`` named-
    matrix loading (Simmtx::Simmtx(file), simmtx.cc).  Returns a full
    (ASIMD, ASIMD) matrix in our protein code space."""
    from pathlib import Path
    import os
    p = Path(path)
    if not p.exists():
        root = os.environ.get("ALN_TAB")
        if root and (Path(root) / path).exists():
            p = Path(root) / path
        else:
            raise FileNotFoundError(f"matrix file '{path}' not found "
                                    "(set ALN_TAB)")
    header = None
    rows = {}
    for ln in p.read_text().splitlines():
        if not ln.strip() or ln.lstrip().startswith("#"):
            continue
        toks = ln.split()
        if header is None:
            header = toks
            continue
        rows[toks[0]] = [float(x) for x in toks[1:1 + len(header)]]
    m = np.zeros((ab.ASIMD, ab.ASIMD), np.float64)
    code = {c: ab.encode(c, ab.PROTEIN)[0] for c in
            "ARNDCQEGHILKMFPSTWYVBZX"}
    for ra, vals in rows.items():
        ia = code.get(ra)
        if ia is None:
            continue
        for rb, val in zip(header, vals):
            ib = code.get(rb)
            if ib is not None:
                m[ia, ib] = m[ib, ia] = val
    # gap/unlisted rows follow the PAM-matrix conventions
    unp = -2.0
    m[ab.AMB:, ab.GAP] = m[ab.GAP, ab.AMB:] = unp
    m[:, ab.SEC] = m[:, ab.CYS]
    m[ab.SEC, :] = m[ab.CYS, :]
    m[ab.SEC, ab.GAP] = m[ab.GAP, ab.SEC] = unp
    m[ab.SEC, ab.SEC] = m[ab.CYS, ab.CYS]
    m[ab.GAP, ab.GAP] = 0.0
    m[:, ab.NIL] = m[ab.NIL, :] = 0.0
    return m.astype(np.float32)
