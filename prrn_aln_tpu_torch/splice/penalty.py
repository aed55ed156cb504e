"""Intron length penalty: Frechet-mixture log-density table.

Reference: src/codepot.cc IntronPenalty::IntronPenalty / Penalty and
the INTRONPEN defaults (codepot.cc:38).  For DNA/DNA the scale factor
f = Vab, fY = f * fact, fy = f * y; the expected-signal offset expsig
uses avrsig53 (codepot.cc:67) and the PWM header means (zero for the
default tables, whose headers carry only the min field).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

SHRT_MIN = -32768.0

# INTRONPEN defaults (reference codepot.cc:38-43); ip/fact resolve to
# the DNA (dvsp=0) values via FQUERY -> defprm2[0]
DEF_IP = 12.0
DEF_FACT = 4.0
DEF_MEAN = -2.767
DEF_LLMT = 20
DEF_RLMT = 825
A1, M1, T1, K1 = 0.2767, -22.80, 83.35, 5.488
M2, T2, K2 = 21.870, 223.95, 0.7882
AVRSIG53 = (2.446, 4.807)


def _prob_dist(i: float, mu: float, th: float, kk: float) -> float:
    if i <= mu:
        return 0.0
    z = th / (i - mu)
    zz = z ** kk
    return kk / th * z * zz * math.exp(-zz)


@dataclasses.dataclass
class IntronPenalty:
    table: np.ndarray        # Penalty(n) for n in [llmt, rlmt]
    llmt: int
    rlmt: int
    mu: int
    int_ep: float
    int_fx: float
    gap_wi: float
    avr_sig: float
    minl: int
    mode: int
    # closed-form parameters of the table region (Frechet mixture;
    # codepot.cc IntronPenalty ctor): (fY, int_pen,
    # ((a1,m1,t1,k1), (a2_,m2,t2,k2), (a3,m3,t3,k3))) -- lets device
    # kernels evaluate Penalty(n) without a table gather
    closed: tuple = ()

    @classmethod
    def build(cls, f: float = 1.0, y: float = 4.0, sss: float = 0.5,
              u: float = 2.0, v: float = 6.0,
              ip: float = DEF_IP, fact: float = DEF_FACT,
              mean: float = DEF_MEAN, llmt: int = DEF_LLMT,
              rlmt: int = DEF_RLMT,
              a1: float = A1, m1: float = M1, t1: float = T1,
              k1: float = K1, m2: float = M2, t2: float = T2,
              k2: float = K2, a2: float | None = None,
              m3: float = 0.0, t3: float = 1.0,
              k3: float = 1.0) -> "IntronPenalty":
        fy = f * y
        fY = f * fact
        # expsig: canonical-table mean + species-PWM means (zero for the
        # default Splice5/Splice3 headers)
        expsig = fy * (1.0 - sss) * AVRSIG53[0]
        avr_sig = expsig
        int_pen = expsig + fY * mean + f * ip
        gap_wi = fY * mean - int_pen

        table = np.empty(rlmt - llmt + 1, np.float64)
        # species -yI vectors (simmtx.cc:676-684): up to 3 Frechet
        # components with weights a1, (1-a1-a2), a2
        a3 = a2 if a2 is not None else 0.0
        a2_ = 1.0 - a1 - a3
        gep = f * u
        gappen = -(f * v + llmt * gep)
        minl = 0
        optip = SHRT_MIN
        mode = llmt
        for i in range(llmt, rlmt + 1):
            z = a1 * _prob_dist(i, m1, t1, k1) \
                + a2_ * _prob_dist(i, m2, t2, k2) \
                + (a3 * _prob_dist(i, m3, t3, k3) if a3 else 0.0)
            gp = fY * math.log10(z) - int_pen if z > 0 else SHRT_MIN
            table[i - llmt] = gp
            if gp > optip:
                optip = gp
                mode = i
            if not minl:
                if gp > gappen:
                    minl = i
                else:
                    gappen -= gep
        if not minl:
            minl = llmt

        # tail: dominant component at rlmt sets the log-slope
        z1 = _prob_dist(rlmt, m1, t1, k1)
        z2 = _prob_dist(rlmt, m2, t2, k2)
        if z2 > z1:
            mu, kk = int(m2), k2
        else:
            mu, kk = int(m1), k1
        int_ep = -(kk + 1.0) * fY / math.log(10.0)
        int_fx = table[-1] - int_ep * math.log(rlmt - mu)
        closed = (float(fY), float(int_pen),
                  ((float(a1), float(m1), float(t1), float(k1)),
                   (float(a2_), float(m2), float(t2), float(k2)),
                   (float(a3), float(m3), float(t3), float(k3))))
        return cls(table, llmt, rlmt, mu, int_ep, int_fx, gap_wi,
                   avr_sig, minl, mode, closed)

    def penalty(self, n: int) -> float:
        """Reference IntronPenalty::Penalty(int)."""
        if n < 0:
            return self.gap_wi
        if n < self.llmt:
            return SHRT_MIN
        if n >= self.rlmt:
            return self.int_fx + self.int_ep * math.log(n - self.mu)
        return float(self.table[n - self.llmt])
