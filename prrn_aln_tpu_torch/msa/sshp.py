"""Secondary-structure / hydrophobicity propensity profiles (ssp).

Reference: src/ssp.h, src/ssp.cc (SsHpPrm, table ``sshp.data``) and
src/mseq.cc:864-1060 (ssprof/hyprof/hmprof/makesshpprof).  The profile
is a per-column vector of up to six standardized propensities

    [helix, sheet, coil] (GOR3 17-residue windows, ``-ys``)
    [hydrophobicity]     (Kyte-Doolittle +-hpwing window, ``-yh``)
    [hm100, hm180]       (hydrophobic-moment magnitudes, ``-yr``)

and alignment scoring adds  sum_e fact_e * a_prof[m,e] * b_prof[n,e]
to each DP cell (src/maln2.cc:1778-1792 sim2_sshp) — on TPU that term
is one small matmul folded into the substitution image
(ops/group.py::group_align).

Windows advance over *residues* (gap columns are transparent:
mseq.cc:883 ``if (IsGap(*sp)) continue``), non-AA residues consume a
window slot without contributing, and members accumulate with their
tree weights (mean-1 normalized) or 1/many when unweighted.  Profiles
are only built for sequences of at least SSWIDTH residues
(mseq.cc:1026).
"""

from __future__ import annotations

import dataclasses
import os
import struct

import numpy as np

from .. import alphabet as ab

NOSS = 3
SSWING = 8
SSWIDTH = 17
HMWING = 4

_AA_LO, _AA_HI = ab.ALA, ab.VAL      # inclusive code range of the 20 AAs


@dataclasses.dataclass
class SsHpPrm:
    """Parsed sshp.data plus the active-state configuration."""
    phptbl: np.ndarray        # (4, 20) hydrophobicity scales
    psstbl: np.ndarray        # (3, 17, 20) GOR3 propensities
    sshpav: np.ndarray        # (6,) means
    sshpsd: np.ndarray        # (6,) standard deviations
    sincrv: np.ndarray        # (2, 5) sin curves (angles 100, 180)
    coscrv: np.ndarray        # (2, 5)
    hps: int                  # hydrophobicity scale index (params[0])
    hms: int                  # moment scale index (params[1])
    # factors / active states (ssp.cc:222-230 initSsHpPrm)
    scnd: float = 0.0
    hydr: float = 0.0
    hpmt: float = 0.0
    hpwing: int = 3
    no_angle: int = 0

    @property
    def sndstates(self) -> int:
        return NOSS if self.scnd > 0 else 0

    @property
    def hphstates(self) -> int:
        return 1 if self.hydr > 0 else 0

    @property
    def hmtstates(self) -> int:
        return self.no_angle

    @property
    def nelems(self) -> int:
        return self.sndstates + self.hphstates + self.hmtstates

    @property
    def hpwidth(self) -> int:
        return 2 * self.hpwing + 1

    @property
    def factors(self) -> np.ndarray:
        """Per-element score factors, ordered like the profile."""
        return np.array([self.scnd] * self.sndstates
                        + [self.hydr] * self.hphstates
                        + [self.hpmt] * self.hmtstates, np.float32)


def _table_path() -> str | None:
    root = os.environ.get("ALN_TAB") or None
    if root is None:
        return None
    p = os.path.join(root, "sshp.data")
    return p if os.path.exists(p) else None


def load_sshp(path: str | None = None) -> SsHpPrm:
    """Load the propensity tables: an ALN_TAB ``sshp.data`` override if
    present (binary ssp.cc:37-48 layout), else the bundled npz asset
    (tools/extract_sshp.py)."""
    if path is None:
        path = _table_path()
    if path is None:
        z = np.load(os.path.join(os.path.dirname(__file__), "..", "..",
                                 "prrn_aln_tpu", "data", "sshp.npz"))
        return SsHpPrm(phptbl=z["phptbl"], psstbl=z["psstbl"],
                       sshpav=z["sshpav"].copy(), sshpsd=z["sshpsd"].copy(),
                       sincrv=z["sincrv"], coscrv=z["coscrv"],
                       hps=int(z["params"][0]), hms=int(z["params"][1]))
    raw = open(path, "rb").read()
    p0, p1 = struct.unpack_from("<2i", raw, 0)
    off = 8
    phptbl = np.frombuffer(raw, np.float32, 4 * 20, off).reshape(4, 20)
    off += 4 * 20 * 4
    psstbl = np.frombuffer(raw, np.float32, NOSS * SSWIDTH * 20,
                           off).reshape(NOSS, SSWIDTH, 20)
    off += NOSS * SSWIDTH * 20 * 4
    sshpav = np.frombuffer(raw, np.float32, 6, off).copy()
    off += 24
    sshpsd = np.frombuffer(raw, np.float32, 6, off).copy()
    off += 24
    sincrv = np.frombuffer(raw, np.float32, 10, off).reshape(2, 5)
    off += 40
    coscrv = np.frombuffer(raw, np.float32, 10, off).reshape(2, 5)
    return SsHpPrm(phptbl=phptbl, psstbl=psstbl, sshpav=sshpav,
                   sshpsd=sshpsd, sincrv=sincrv, coscrv=coscrv,
                   hps=p0, hms=p1)


_active: SsHpPrm | None = None


def activate(scnd: float = 0.0, hydr: float = 0.0, hpmt: float = 0.0,
             hpwing: int = 3, no_angle: int = 0,
             path: str | None = None) -> SsHpPrm | None:
    """Configure the global ssp term (mirrors initSsHpPrm,
    ssp.cc:222-230); returns None (and deactivates) if all factors
    are zero."""
    global _active
    if scnd == 0.0 and hydr == 0.0 and hpmt == 0.0:
        _active = None
        return None
    if hpmt > 0.0 and not no_angle:
        no_angle = 1
    if no_angle and hpmt == 0.0:
        hpmt = hydr
    prm = load_sshp(path)
    prm.scnd, prm.hydr, prm.hpmt = scnd, hydr, hpmt
    prm.hpwing, prm.no_angle = hpwing, no_angle
    # ssp.cc:57: the hydrophobicity spread is per-window-mean when the
    # secondary-structure states are also active
    if prm.sndstates:
        prm.sshpsd = prm.sshpsd.copy()
        prm.sshpsd[NOSS] /= np.sqrt(prm.hpwidth)
    _active = prm
    return prm


def deactivate() -> None:
    global _active
    _active = None


def active() -> SsHpPrm | None:
    return _active


def _member_windows(res: np.ndarray, tbl: np.ndarray, wing: int,
                    signed_sin: np.ndarray | None = None,
                    cos: np.ndarray | None = None):
    """Windowed sums over a degapped residue-code row.

    res (K,) int codes.  For plain tables tbl (W, 20) with
    W = 2*wing+1 returns (K,) sums of tbl[wing+dj, aa[k+dj]] over
    dj in [-wing, wing] (window clipped at the ends, non-AA residues
    contribute 0).  With signed_sin/cos (length wing+1) returns the
    (K, 2) moment components instead (mseq.cc:957-995 hmprof)."""
    K = len(res)
    aa = res.astype(np.int64) - _AA_LO
    isaa = (res >= _AA_LO) & (res <= _AA_HI)
    aac = np.clip(aa, 0, 19)
    out = None
    for dj in range(-wing, wing + 1):
        ks = np.arange(K) + dj
        ok = (ks >= 0) & (ks < K)
        ksc = np.clip(ks, 0, K - 1)
        val_ok = ok & isaa[ksc]
        if signed_sin is None:
            contrib = np.where(val_ok, tbl[wing + dj, aac[ksc]], 0.0)
            out = contrib if out is None else out + contrib
        else:
            t = np.where(val_ok, tbl[aac[ksc]], 0.0)
            sgn = np.sign(dj)
            s = sgn * signed_sin[abs(dj)] * t
            c = cos[abs(dj)] * t
            pair = np.stack([s, c], axis=1)
            out = pair if out is None else out + pair
    return out


def msa_profile(codes: np.ndarray, weight: np.ndarray | None,
                prm: SsHpPrm | None = None) -> np.ndarray | None:
    """Per-column standardized profile (L, nelems) of an MSA
    (makesshpprof; None when inactive or shorter than SSWIDTH)."""
    if prm is None:
        prm = _active
    if prm is None or prm.nelems == 0:
        return None
    many, L = codes.shape
    if L < SSWIDTH:
        return None
    w = (np.asarray(weight, np.float64) if weight is not None
         else np.full(many, 1.0 / many))
    E = prm.nelems
    prof = np.zeros((L, E), np.float64)
    for i in range(many):
        row = codes[i]
        nongap = row > ab.GAP
        cols = np.nonzero(nongap)[0]
        if len(cols) == 0:
            continue
        res = row[cols]
        e = 0
        if prm.sndstates:
            for s in range(NOSS):
                ss = _member_windows(res, prm.psstbl[s], SSWING)
                prof[cols, e] += w[i] * ss
                e += 1
        if prm.hphstates:
            hh = _member_windows(res, np.tile(
                prm.phptbl[prm.hps][None, :], (prm.hpwidth, 1)),
                prm.hpwing)
            prof[cols, e] += w[i] * hh
            e += 1
    # moment states: the (sin, cos) components accumulate across
    # members FIRST, the magnitude is per column (mseq.cc:996-1000
    # hhp[] then sqrt) — so they need a separate two-component pass.
    e0 = prm.sndstates + prm.hphstates
    if prm.hmtstates:
        for aid in range(prm.hmtstates):
            acc = np.zeros((L, 2), np.float64)
            for i in range(many):
                row = codes[i]
                cols = np.nonzero(row > ab.GAP)[0]
                if len(cols) == 0:
                    continue
                res = row[cols]
                hm = _member_windows(res, prm.phptbl[prm.hms], HMWING,
                                     signed_sin=prm.sincrv[aid],
                                     cos=prm.coscrv[aid])
                acc[cols] += w[i] * hm
            prof[:, e0 + aid] = np.sqrt((acc ** 2).sum(axis=1))
    # standardize
    e = 0
    for s in range(prm.sndstates):
        prof[:, e] = (prof[:, e] - prm.sshpav[s]) / prm.sshpsd[s]
        e += 1
    if prm.hphstates:
        prof[:, e] = prof[:, e] / prm.hpwidth
        prof[:, e] = (prof[:, e] - prm.sshpav[NOSS]) / prm.sshpsd[NOSS]
        e += 1
    for aid in range(prm.hmtstates):
        prof[:, e] = ((prof[:, e] - prm.sshpav[NOSS + 1 + aid])
                      / prm.sshpsd[NOSS + 1 + aid])
        e += 1
    return prof.astype(np.float32)


def score_image(prof_a: np.ndarray | None, prof_b: np.ndarray | None,
                prm: SsHpPrm | None = None) -> np.ndarray | None:
    """Additive DP score image  sum_e fact_e a[m,e] b[n,e]
    (sim2_sshp as one MXU-shaped matmul)."""
    if prm is None:
        prm = _active
    if prm is None or prof_a is None or prof_b is None:
        return None
    return (prof_a * prm.factors[None, :]) @ prof_b.T


def pair_channels(A, B, prm: SsHpPrm | None = None):
    """Low-rank factors of ``pair_image``: returns (pa*facts, pb) so the
    (La, Lb) image can be built on device as one small matmul channel
    block, or None when the term is inactive (same gating as
    pair_image / maln2.cc:487)."""
    if prm is None:
        prm = _active
    if prm is None or prm.nelems == 0:
        return None
    if A.molc != ab.PROTEIN or B.molc != ab.PROTEIN:
        return None
    pa = msa_profile(A.codes, A.weight, prm)
    pb = msa_profile(B.codes, B.weight, prm)
    if pa is None or pb is None:
        return None
    return ((pa * prm.factors[None, :]).astype(np.float32),
            pb.astype(np.float32))


def pair_image(A, B, prm: SsHpPrm | None = None) -> np.ndarray | None:
    """ssp DP score image (La, Lb) for two prepared protein Msa groups;
    None when inactive, non-protein, or either side is shorter than
    SSWIDTH residues (maln2.cc:487 sim2_sshp dispatch)."""
    if prm is None:
        prm = _active
    if prm is None or prm.nelems == 0:
        return None
    if A.molc != ab.PROTEIN or B.molc != ab.PROTEIN:
        return None
    pa = msa_profile(A.codes, A.weight, prm)
    pb = msa_profile(B.codes, B.weight, prm)
    img = score_image(pa, pb, prm)
    return None if img is None else img.astype(np.float32)
