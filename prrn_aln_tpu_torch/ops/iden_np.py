"""Identity comparison of two closely related sequences (iden).

Reference: src/iden.cc — a banded minimum-cost alignment (mismatch 1,
gap open v+u, gap extend u; defaults u=v=1, band shoulder sh=2) whose
output shows only the 60-column blocks that contain a difference.
"""

from __future__ import annotations

import numpy as np

from .window import stripe

NEVSELP = 8.9e30


def iden_align(a, b, u: float = 1.0, v: float = 1.0, sh: int = 2):
    """forwardA (iden.cc:363): returns (distance, skl knots)."""
    a = np.asarray(a)
    b = np.asarray(b)
    la, lb = len(a), len(b)
    w = stripe(la, lb, sh)
    lw, up = w.lw, w.up
    W = up - lw + 1

    def idx(r):
        return r - lw + 1

    dval = np.full(W + 2, NEVSELP)
    dptr = np.zeros(W + 2, np.int64)
    gval = np.full(W + 2, NEVSELP)
    gptr = np.zeros(W + 2, np.int64)
    ee = np.zeros(W + 2, np.int8)

    recs = [(0, 0, 0)]

    def add(m, n, prev):
        recs.append((m, n, prev))
        return len(recs) - 1

    # InitInfMtx (iden.cc:305): global corners (exg off by default)
    origin = add(0, 0, 0)
    r0 = 0
    dval[idx(r0)] = 0.0
    dptr[idx(r0)] = origin
    g = v
    for r in range(r0 + 1, up):
        dval[idx(r)] = g = g + u
        dptr[idx(r)] = origin
    if up <= W + lw:
        dval[idx(up)] = NEVSELP
    g = v
    for r in range(r0 - 1, lw, -1):
        dval[idx(r)] = g = g + u
        dptr[idx(r)] = origin
    dval[idx(lw)] = NEVSELP

    for m in range(la):
        n1 = m + lw + 1
        n2 = m + up
        n = max(n1, 0)
        n9 = min(n2, lb)
        fval, fptr = NEVSELP, 0
        for n in range(n, n9):
            r = n - m
            i = idx(r)
            x = dval[i - 1] + v
            if x < fval:
                fval = x
                fptr = dptr[i - 1]
            fval += u
            x = dval[i + 1] + v
            if x < gval[i + 1]:
                gval[i] = x
                gptr[i] = dptr[i + 1]
            else:
                gval[i] = gval[i + 1]
                gptr[i] = gptr[i + 1]
            gval[i] += u
            if fval < gval[i]:
                nv, np_ = fval, fptr
            else:
                nv, np_ = gval[i], gptr[i]
            dval[i] += float(a[m] != b[n])
            if nv < dval[i]:
                dval[i] = nv
                dptr[i] = np_
                ee[i] = 0
            elif not ee[i]:
                dptr[i] = add(m, n, dptr[i])
                ee[i] = 1

    # FinitInfMtx (iden.cc:333): global right corner
    rr = lb - la
    dist = dval[idx(rr)]
    ptr = add(la, lb, dptr[idx(rr)])

    knots = []
    while ptr:
        mm, nn, prev = recs[ptr]
        knots.append((mm, nn))
        ptr = prev
    knots.reverse()
    skl = []
    for k in knots:
        if not skl or skl[-1] != k:
            skl.append(k)
    return float(dist) / u, skl


def path_stats(a, b, skl):
    """mch/mmc/gap-run/gap-char counts along the path (diag-first)."""
    mch = mmc = runs = unp = 0
    m, n = skl[0]
    for wm, wn in skl[1:]:
        dm, dn = wm - m, wn - n
        d = min(dm, dn)
        for _ in range(d):
            if a[m] == b[n]:
                mch += 1
            else:
                mmc += 1
            m += 1
            n += 1
        if dm > d:
            runs += 1
            unp += dm - d
            m = wm
        if dn > d:
            runs += 1
            unp += dn - d
            n = wn
    return mch, mmc, runs, unp


def alignment_columns(a_str: str, b_str: str, skl):
    """Aligned character rows (diagonal-first, '-' gaps)."""
    ra, rb = [], []
    m, n = skl[0]
    for wm, wn in skl[1:]:
        dm, dn = wm - m, wn - n
        d = min(dm, dn)
        ra.append(a_str[m: m + d])
        rb.append(b_str[n: n + d])
        m += d
        n += d
        if dm > d:
            ra.append(a_str[m: wm])
            rb.append("-" * (dm - d))
        elif dn > d:
            ra.append("-" * (dn - d))
            rb.append(b_str[n: wn])
        m, n = wm, wn
    return "".join(ra), "".join(rb)
