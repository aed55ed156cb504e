"""Column-range set algebra over alignment coordinate ranges.

Reference: src/css.{h,cc} — RANGE lists with union / intersection /
complement / folding through gap lists, used by the conserved-region
machinery and alignment-consistency checks.  Ranges here are half-open
``(lo, hi)`` tuples in sorted, non-overlapping order.
"""

from __future__ import annotations


def normalize(ranges):
    """Sort and merge overlapping/adjacent ranges."""
    out: list[tuple[int, int]] = []
    for lo, hi in sorted(r for r in ranges if r[0] < r[1]):
        if out and lo <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return out


def cmnrng(a, b):
    """Intersection (reference cmnrng, css.cc)."""
    out = []
    i = j = 0
    a, b = normalize(a), normalize(b)
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if lo < hi:
            out.append((lo, hi))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def uniterng(a, b):
    """Union (reference uniterng)."""
    return normalize(list(a) + list(b))


def complerng(full, ranges):
    """Complement of ``ranges`` within ``full = (lo, hi)``
    (reference complerng)."""
    out = []
    pos = full[0]
    for lo, hi in normalize(ranges):
        if lo > pos:
            out.append((pos, min(lo, full[1])))
        pos = max(pos, hi)
    if pos < full[1]:
        out.append((pos, full[1]))
    return out


def sumrng(ranges) -> int:
    """Total covered length (reference sumrng)."""
    return sum(hi - lo for lo, hi in normalize(ranges))


def getrng(text: str):
    """Parse 'lo..hi,lo..hi' / 'lo-hi' strings (reference getrng)."""
    out = []
    for part in text.replace(" ", "").split(","):
        if not part:
            continue
        sep = ".." if ".." in part else "-"
        lo, hi = part.split(sep)
        out.append((int(lo), int(hi)))
    return normalize(out)


def foldrng(ranges, gaps):
    """Map ungapped-sequence ranges into alignment columns through a
    gap list ``gaps`` = [(pos, len), ...] with pos in sequence coords
    (reference foldrng semantics)."""
    out = []
    for lo, hi in ranges:
        off_lo = sum(g for p, g in gaps if p <= lo)
        off_hi = sum(g for p, g in gaps if p <= hi)
        out.append((lo + off_lo, hi + off_hi))
    return normalize(out)


def unfoldrng(ranges, gaps):
    """Inverse of foldrng: alignment columns -> sequence coords."""
    out = []
    for lo, hi in ranges:
        off_lo = sum(g for p, g in gaps if p + g <= lo)
        off_hi = sum(g for p, g in gaps if p + g <= hi)
        out.append((lo - off_lo, hi - off_hi))
    return normalize(out)
