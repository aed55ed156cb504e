"""Splice-site signal model for a genomic sequence.

Builds, from encoded genome codes, the per-boundary donor/acceptor
signal arrays used by the spliced DP:

* dinc5[n] — dinucleotide (4*first+second, ACGT=0123) of bases
  (n, n+1); dinc3[n] — of bases (n-2, n-1).  A boundary n means "n
  residues consumed": an intron spanning [d, a) has its GT at
  (d, d+1) = dinc5[d] and its AG at (a-2, a-1) = dinc3[a].
  (reference: src/codepot.cc Intron53N)
* cano5/cano3 — canonicity levels (GT=3, GC=3, AT=2 donors; AG=3,
  AC=2 acceptors with default algmode.any=0); nonzero = usable site.
* sig5/sig3 — mixed signal scores: (1-sss) * dinucleotide table +
  sss * context-PWM score, both scaled by fS = y * f
  (reference: src/codepot.cc Exinon::sig53, Intron53).

The context PWMs are 2nd-order Markov models evaluated per
PatMat::calcPatMat (src/utilseq.cc:882, Mrkv==2 branch), including its
boundary conventions: windows overhanging the right end score the
floor value `cols * min(mtx)`, left overhangs score partially with the
feature rows shifted past the overhang.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .. import alphabet as ab
from .tables import load_tables

# alprm2 defaults for DNA/DNA spliced alignment (reference simmtx.cc:48
# with crs=1 slot defaults: y=4 via defprm2, sss=defSss[1]=0.5)
DEF_Y = 4.0
DEF_SSS = 0.5

_BAD = 4


def _reduced_table() -> np.ndarray:
    red = np.full(ab.NSIMD + 1, _BAD, np.int8)
    red[ab.encode("A", ab.DNA)[0]] = 0
    red[ab.encode("C", ab.DNA)[0]] = 1
    red[ab.encode("G", ab.DNA)[0]] = 2
    red[ab.encode("T", ab.DNA)[0]] = 3
    return red


_RED = _reduced_table()


def pwm_fit(red: np.ndarray, mtx: np.ndarray, offset: int) -> np.ndarray:
    """calcPatMat (Mrkv=2, single sequence): fit[p] scores the window
    starting at sequence position p - offset; p in 0..len-1.

    Vectorized: the reference's q counter ends up nonzero exactly when
    the window overruns the right end or contains any ambiguous base
    (overlapping triples cover the whole window), and then the fit is
    minval regardless of the accumulated terms — so the sum can be
    taken ungated and overridden, with a next-bad-index array deciding
    the override."""
    L = len(red)
    cols = mtx.shape[0]
    minval = cols * float(mtx.min())

    bad = red >= _BAD
    r0 = np.where(bad, 0, red).astype(np.int64)
    FB = np.full(L + 1, L, np.int64)
    if L:
        tmp = np.where(bad, np.arange(L, dtype=np.int64), L)
        FB[:L] = np.minimum.accumulate(tmp[::-1])[::-1]
    k2 = np.zeros(L, np.int64)
    k3 = np.zeros(L, np.int64)
    if L > 1:
        k2[:L - 1] = 4 * r0[:L - 1] + r0[1:] + 4
    if L > 2:
        k3[:L - 2] = 16 * r0[:L - 2] + 4 * r0[1:L - 1] + r0[2:] + 20

    p = np.arange(L, dtype=np.int64)
    n = p - offset
    s0 = np.maximum(n, 0)
    stop = np.minimum(n + cols, L - 2)
    overrun = n + cols >= L
    run = s0 < stop
    anybad = FB[np.clip(s0, 0, L)] <= np.minimum(stop + 1, L - 1)
    q = overrun | (run & anybad)

    out = np.zeros(L, np.float64)
    row0 = s0 - n
    f0 = run & (row0 < cols)
    out[f0] = (mtx[row0[f0], r0[s0[f0]]]
               + mtx[row0[f0], k2[s0[f0]]])
    for row in range(cols):
        s = n + row
        ok = run & (s >= s0) & (s < stop)
        out[ok] += mtx[row, k3[s[ok]]]
    out[q] = minval
    return out



# canonicity levels per dinucleotide, algmode.any == 0, forward strand
# (reference codepot.cc Intron53N switch; jlevelac[0] = jlevelgt[0] = 0)
_CANO5 = np.zeros(16, np.int8)
_CANO3 = np.zeros(16, np.int8)
_DIN = {a + b: 4 * i + j for i, a in enumerate("ACGT")
        for j, b in enumerate("ACGT")}
_CANO5[_DIN["GT"]] = 3
_CANO5[_DIN["GC"]] = 3
_CANO5[_DIN["AT"]] = 2
_CANO3[_DIN["AG"]] = 3
_CANO3[_DIN["AC"]] = 2


@dataclasses.dataclass
class SpliceSignals:
    """Per-boundary splice signals for one genomic sequence."""
    length: int
    dinc5: np.ndarray        # (L+1,) dinucleotide at (n, n+1)
    dinc3: np.ndarray        # (L+1,) dinucleotide at (n-2, n-1)
    cano5: np.ndarray        # (L+1,) donor canonicity level
    cano3: np.ndarray        # (L+1,) acceptor canonicity level
    sig5: np.ndarray         # (L+1,) mixed donor signal at boundary n
    sig3: np.ndarray         # (L+1,) mixed acceptor signal at boundary n
    pair53: np.ndarray       # (16,16) scaled (1-sss)*fS*pair table
    sss3: np.ndarray         # (L+1,) sss-weighted PWM part of sig3
    sss: float
    fS: float

    @classmethod
    def build(cls, codes: np.ndarray, f: float = 1.0, y: float = DEF_Y,
              sss: float = DEF_SSS,
              tabs: dict | None = None) -> "SpliceSignals":
        t = dict(load_tables())
        if tabs:
            t.update(tabs)          # species -T PWM overrides
        L = len(codes)
        red = _RED[np.asarray(codes, np.int64)]
        fS = y * f

        # dinucleotides with ambiguity folded to 'C' and a virtual
        # leading 'C' (reference: nc = 1 initial state)
        dred = np.where(red >= _BAD, 1, red).astype(np.int64)
        prev = np.concatenate([[1], dred[:-1]])
        nc = 4 * prev + dred              # nc[i] = dinuc of (i-1, i)

        dinc5 = np.zeros(L + 1, np.int64)
        dinc3 = np.zeros(L + 1, np.int64)
        dinc5[: L - 1] = nc[1:]           # dinc5[p] = dinuc(p, p+1)
        dinc3[1: L + 1] = nc              # dinc3[p] = dinuc(p-2, p-1)
        cano5 = np.zeros(L + 1, np.int8)
        cano3 = np.zeros(L + 1, np.int8)
        cano5[: L - 1] = _CANO5[dinc5[: L - 1]]
        cano3[2: L + 1] = _CANO3[dinc3[2: L + 1]]

        pwm5 = pwm_fit(red, t["splice5_mtx"], int(t["splice5_offset"]))
        pwm3 = pwm_fit(red, t["splice3_mtx"], int(t["splice3_offset"]))

        sig5 = np.zeros(L + 1)
        sig3 = np.zeros(L + 1)
        sss3 = np.zeros(L + 1)
        sss3[:L] = sss * fS * pwm3
        sig5[:L] = (1.0 - sss) * fS * t["i5tab"][dinc5[:L]] \
            + sss * fS * pwm5
        sig3[:L] = (1.0 - sss) * fS * t["i3tab"][dinc3[:L]] + sss3[:L]
        # boundary L: EXIN data cleared to zero (reference Exinon::clear)
        sig5[L] = (1.0 - sss) * fS * t["i5tab"][dinc5[L]]
        sig3[L] = (1.0 - sss) * fS * t["i3tab"][dinc3[L]]

        pair53 = (1.0 - sss) * fS * t["i53tab"].reshape(16, 16)
        return cls(L, dinc5, dinc3, cano5, cano3, sig5, sig3, pair53,
                   sss3, sss, fS)

    def sig53_pair(self, m: int, n: int) -> float:
        """sig53(m, n, IE53): donor at m, acceptor at n."""
        return float(self.pair53[self.dinc5[m], self.dinc3[n]]
                     + self.sss3[n])

    def is_donor(self, n: int) -> bool:
        return bool(self.cano5[n])

    def is_accpt(self, n: int) -> bool:
        return bool(self.cano3[n])


def pwm_fit_mrkv1(red: np.ndarray, mtx: np.ndarray,
                  offset: int) -> np.ndarray:
    """calcPatMat (Mrkv=1, single sequence; utilseq.cc:899-925): first-
    order nucleotide Markov PWM (rows = 4 + 16 features per position);
    fit[p] scores the window starting at p - offset.

    Vectorized over positions: contributions stop at the first
    ambiguous base in the window (the reference's q counter), so each
    term is gated by "no bad base in [window start, s+1]" — a
    next-bad-index array turns the whole fit into `cols` masked
    vector adds."""
    L = len(red)
    cols = mtx.shape[0]
    bad = red >= _BAD
    r0 = np.where(bad, 0, red).astype(np.int64)
    FB = np.full(L + 1, L, np.int64)
    if L:
        tmp = np.where(bad, np.arange(L, dtype=np.int64), L)
        FB[:L] = np.minimum.accumulate(tmp[::-1])[::-1]
    k2 = np.empty(L, np.int64)
    k2[:L - 1] = 4 * r0[:L - 1] + r0[1:] + 4
    k2[L - 1] = 4 * r0[L - 1] + 4

    p = np.arange(L, dtype=np.int64)
    n = p - offset
    s0 = np.maximum(n, 0)
    open_w = n + cols < L                  # q starts at 0
    stop = np.minimum(n + cols, L - 1)
    fb0 = FB[np.clip(s0, 0, L)]
    out = np.zeros(L, np.float64)
    m0ok = open_w & (n >= 0) & (n < stop) & (fb0 > n)
    out[m0ok] = mtx[0, r0[n[m0ok]]]
    for m in range(cols):
        s = n + m
        ok = open_w & (s >= s0) & (s < stop) & (fb0 > s + 1)
        out[ok] += mtx[m, k2[s[ok]]]
    return out
