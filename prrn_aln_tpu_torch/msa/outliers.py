"""Outlier detection (Dixon's Q test) over refinement attack ranges.

Per dissimilar region, flag sequences whose residue counts (insertions /
deletions) or divergence ratios are statistical outliers (reference:
src/clib.cc:619-764 Dixon, src/prrn5.cc:1637-1725 Msa::findoutliers),
reported by the -O2 output mode.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from .. import alphabet as ab
from .msa import Msa

_TABLE = np.load(Path(__file__).resolve().parent.parent.parent
                 / "prrn_aln_tpu" / "data" / "dixon_critical.npz")["table"]
_PVALS = [0.30, 0.20, 0.10, 0.05, 0.02, 0.01, 0.005]


class Dixon:
    """Dixon's Q test with the reference's range-adapted ratios
    (clib.cc:729-764; the broken upper-ratio branch for n in [8, 10] is
    implemented per the evident textbook intent, see DEVIATIONS.md)."""

    def __init__(self, alpha: float = 0.1):
        elt = 0
        for elt in range(7):
            if alpha > _PVALS[elt]:
                break
        self.elt = max(elt - 1, 0)

    def test(self, data: np.ndarray, min_deno: float = 0.0) -> list[int]:
        """Returns outlier indices: i for high outliers, -i-1 for low."""
        order = np.argsort(data, kind="stable")
        return self._rec(data, list(order), min_deno)

    def _rec(self, data, odr, min_deno) -> list[int]:
        num = len(odr)
        if num < 3:
            return []
        dtmax = data[odr[-1]]
        dtmin = data[odr[0]]
        rs = rl = 0.0
        if num <= 7:
            deno = dtmax - dtmin
            if deno > min_deno:
                rs = (data[odr[1]] - dtmin) / deno
                rl = (dtmax - data[odr[-2]]) / deno
        elif num <= 10:
            deno = data[odr[-2]] - dtmin
            if deno > min_deno:
                rs = (data[odr[1]] - dtmin) / deno
            deno = dtmax - data[odr[1]]
            if deno > min_deno:
                rl = (dtmax - data[odr[-2]]) / deno
        else:
            deno = data[odr[-1]] - dtmin
            if deno > min_deno:
                rs = (data[odr[2]] - dtmin) / deno
            deno = dtmax - data[odr[1]]
            if deno > min_deno:
                rl = (dtmax - data[odr[-2]]) / deno
        nn = min(num, 100)
        thr = _TABLE[nn - 3][self.elt]
        out = []
        if rl >= thr:
            out.append(int(odr[-1]))
            odr = odr[:-1]
        if rs >= thr:
            out.append(-int(odr[0]) - 1)
            odr = odr[1:]
        if out:
            out += self._rec(data, odr, min_deno)
        return out


@dataclasses.dataclass
class Outlier:
    match: int = 0
    ins_f: int = 0
    del_f: int = 0
    ins_m: int = 0
    del_m: int = 0
    ins_l: int = 0
    del_l: int = 0
    eij: int = 0

    @property
    def flagged(self) -> bool:
        return bool(self.match or self.ins_f or self.del_f or self.ins_m
                    or self.del_m or self.ins_l or self.del_l)


def _divseq2(msa_codes: np.ndarray, i: int, j: int):
    """Pairwise in-MSA stats (phyl.cc divseq2)."""
    a = msa_codes[i]
    b = msa_codes[j]
    ga = gb = mch = mmc = unp = gap = 0
    for x, y in zip(a, b):
        xg = x <= ab.GAP
        yg = y <= ab.GAP
        if not xg:
            if not yg:
                ga = gb = 0
                if x == y:
                    mch += 1
                else:
                    mmc += 1
            else:
                if ga >= gb:
                    gap += 1
                ga = 0
                gb += 1
                unp += 1
        else:
            if not yg:
                if ga <= gb:
                    gap += 1
                gb = 0
                ga += 1
                unp += 1
            else:
                ga += 1
                gb += 1
    return mch, mmc, gap, unp


def _distsum(codes: np.ndarray) -> np.ndarray:
    """Per-sequence summed divergences (phyl.cc:419-448 calcdistsum with
    default linear pamcorrect)."""
    n = codes.shape[0]
    out = np.zeros(n)
    for j in range(1, n):
        for i in range(j):
            mch, mmc, gap, unp = _divseq2(codes, i, j)
            fd = mmc + 0.5 * gap + 0.5 * unp
            fn = fd + mch
            d = 100.0 * (fd / fn) if fn > 0 else 0.0
            out[i] += d
            out[j] += d
    return out


def find_outliers(msa: Msa, tree, mtx, alpha: float = 0.1,
                  olr_thr: float = 20.0) -> list[Outlier]:
    """Flag outlier members per attack range (prrn5.cc findoutliers)."""
    from .consreg import attack_ranges

    n = msa.many
    out = [Outlier() for _ in range(n)]
    if n < 3:
        return out
    ranges = attack_ranges(msa, tree, mtx, thr=olr_thr)
    glbsod = _distsum(msa.codes)
    glbsod[glbsod == 0] = 1.0
    dxn = Dixon(alpha)
    last = len(ranges) - 1
    for ridx, (lo, hi) in enumerate(ranges):
        sub = msa.codes[:, lo:hi]
        flen = (sub > ab.GAP).sum(axis=1).astype(float)
        for o in dxn.test(flen, min_deno=2.0):
            hit, low = (o, False) if o >= 0 else (-o - 1, True)
            tgt = out[hit]
            if ridx == 0:
                key = "del_f" if low else "ins_f"
            elif ridx == last:
                key = "del_l" if low else "ins_l"
            else:
                key = "del_m" if low else "ins_m"
            setattr(tgt, key, getattr(tgt, key) + 1)
        # unusually divergent members within the range
        lclsod = _distsum(sub)
        ratio = lclsod / glbsod
        for o in dxn.test(ratio):
            if o >= 0:
                out[o].match += 1
    return out


def outlier_report(msa: Msa, outliers: list[Outlier]) -> str:
    width = max(len(n) for n in msa.names)
    lines = []
    for i, (name, o) in enumerate(zip(msa.names, outliers)):
        lines.append(
            f"{i + 1:5d} {name:<{width}}\t{int(o.flagged):3d} {o.eij:2d} "
            f"{o.match} {o.ins_f} {o.del_f} {o.ins_m} {o.del_m} "
            f"{o.ins_l} {o.del_l}")
    return "\n".join(lines) + "\n"
