"""EXIN signal arrays over a genomic sequence for protein x DNA spliced
alignment (reference: src/codepot.cc Intron53/Intron53N building the
per-position EXIN records {phs5, phs3, sig5, sig3, sigE}).

All arrays are validated position-for-position against an instrumented
reference build (F2DEBUG cell dumps):

* sigE[p]   coding potential at p: fE * (T2[6mer(p-2..p+3)] +
            T0[6mer(p-1..p+4)] + T1[6mer(p..p+5)]) from the 5th-order
            Markov CodePotTab (utilseq.cc:1130-1200 calc5MMCodePot),
            with stop-codon adjustments: +fO when the codon centered at
            p is a stop, zeroed when the codon centered at p+3 is
            (codepot.cc:536-542); fE = z*ff (z=2, aln.h:40), fO = -o*ff.
* sig5/sig3 pure context-PWM site signals fS*pwm (codepot.cc:545-546);
            the canonical dinucleotide tables enter only through
            sig53() at junction time weighted by (1-sss)
            (codepot.cc:414-443 Exinon::sig53).
* phs5/phs3 splice-phase marks: 0 at a canonical site, 1 at the next
            position, -1 (or 2 when overlapping) at the previous
            (codepot.cc:602-618).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from .. import alphabet as ab
from . import tron
from .signals import SpliceSignals

_CP = None
# the tables are read from the JAX package's data directory, not copied
_DATA = Path(__file__).resolve().parent.parent.parent / "prrn_aln_tpu" / "data"


def _codepot():
    global _CP
    if _CP is None:
        _CP = np.load(_DATA / "codepot.npz")["codepot"].astype(np.float64)
    return _CP


@dataclasses.dataclass
class Exin:
    length: int
    trn: np.ndarray       # (L,) tron codes (centered-codon translation)
    sigE: np.ndarray      # (L,) coding potential
    sig5: np.ndarray      # (L+1,) pure PWM donor signal (bb->sig5)
    sig3: np.ndarray      # (L+1,) pure PWM acceptor signal (bb->sig3)
    phs5: np.ndarray      # (L+2,) donor phase mark (-2 = none)
    phs3: np.ndarray      # (L+2,) acceptor phase mark
    sig: SpliceSignals    # junction-time mixed signals
    sss: float
    sigS: np.ndarray | None = None   # (L,) start-codon signal fT*prefS
    sigT: np.ndarray | None = None   # (L,) stop-codon signal fT*prefT

    def sig5_at(self, nb: int) -> float:
        """sig53(nb, 0, IE5): donor-site signal at junction time — the
        (1-sss)-weighted dinucleotide table + sss-weighted PWM, which is
        exactly the mixed sig5 of SpliceSignals."""
        return float(self.sig.sig5[nb])

    def sig3_at(self, n: int) -> float:
        """sig53(.., n, IE53): acceptor-site signal at junction time —
        the mixed dinucleotide + PWM acceptor signal."""
        return float(self.sig.sig3[n]) if n < len(self.sig.sig3) else 0.0

    def sig53_at(self, m: int, n: int) -> float:
        """sig53(m, n, IE53): donor m paired with acceptor n."""
        return self.sig.sig53_pair(m, n)


def _mkphs(cano: np.ndarray, L: int) -> np.ndarray:
    phs = np.full(L + 2, -2, np.int64)
    for p in range(L):
        if cano[p]:
            phs[p] = 0
            if cano[p] > 1:
                phs[p + 1] = 1
                phs[p - 1] = 2 if phs[p - 1] == 1 else -1
    return phs


_TI = None


def _transit():
    global _TI
    if _TI is None:
        _TI = np.load(_DATA / "transit.npz")
    return _TI


def build_exin(codes: np.ndarray, ff: float = 1.0, y: float = 8.0,
               z: float = 2.0, o: float = 30.0,
               sss: float = 0.5, bti: float = 8.0,
               tabs: dict | None = None) -> Exin:
    b = np.asarray(codes, np.int64)
    L = len(b)
    trn = tron.nuc2tron(b)
    cp = _codepot()

    # rolling 6-mers over central-nucleotide reduced codes, reset on
    # ambiguity (tnredctab semantics: tron AMB/UNP/NIL also reset).
    # Vectorized: the window value is a sliding base-4 dot product and
    # the ambiguity reset is a modulus by 4^run_length (garbage digits
    # are always higher-order than the run).
    red = tron._RED[b].astype(np.int64)
    inval = red >= 4
    w = np.where(inval, 0, red)
    idx = np.arange(L, dtype=np.int64)
    last_inv = np.maximum.accumulate(np.where(inval, idx, -1))
    valid = idx - last_inv
    full = np.zeros(L, np.int64)
    for k in range(6):                     # 6 shifted adds, not L steps
        full[k:] += w[:L - k] << (2 * k)
    six = full % (1 << (2 * np.minimum(valid, 6)))

    fE = z * ff
    fO = -o * ff
    sigE = np.zeros(L)
    if L > 5:
        p = np.arange(L - 5)
        ok = valid[p + 5] >= 6
        sigE[:L - 5] = np.where(
            ok, fE * (cp[2][six[p + 3]] + cp[0][six[p + 4]]
                      + cp[1][six[p + 5]]), 0.0)
    is_stop = (trn == tron.TRM) | (trn == tron.TRM2)
    nxt = np.zeros(L, bool)
    nxt[:L - 3] = is_stop[3:]
    sigE = np.where(is_stop, sigE + fO, np.where(nxt, 0.0, sigE))

    # mixed junction-time signals; per-position arrays are pure PWM
    sig = SpliceSignals.build(b, f=ff, y=y, sss=sss, tabs=tabs)
    pure = SpliceSignals.build(b, f=ff, y=y, sss=1.0, tabs=tabs)
    phs5 = _mkphs(sig.cano5, L)
    phs3 = _mkphs(sig.cano3, L)

    # start/termination codon signals (EijPat patternI/patternT,
    # codepot.cc:535-536; fT = bti * ff)
    from .signals import pwm_fit, pwm_fit_mrkv1
    ti = _transit()
    fT = bti * ff
    sigS = fT * (pwm_fit_mrkv1(red, ti["transinit_mtx"],
                               int(ti["transinit_offset"]))
                 + float(ti["transinit_tonic"]))
    sigT = fT * (pwm_fit(red, ti["transterm_mtx"],
                         int(ti["transterm_offset"]))
                 + float(ti["transterm_tonic"]))
    return Exin(L, trn, sigE, pure.sig5, pure.sig3, phs5, phs3, sig, sss,
                sigS, sigT)
