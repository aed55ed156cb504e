"""Band-window ("stripe") computation.

Mirrors the reference's diagonal stripe: the band spans the two corner
diagonals of the (sub-)rectangle widened by a shoulder ``sh``; negative
``sh`` means percent of the shorter sequence (reference: src/aln2.cc:156-174).
"""

from __future__ import annotations

from typing import NamedTuple


class Window(NamedTuple):
    lw: int      # lowest diagonal r = n - m in band
    up: int      # highest diagonal in band
    width: int   # up - lw + 3 (includes the two sentinel slots)


def stripe(la: int, lb: int, sh: int) -> Window:
    """Band window for an ``la`` x ``lb`` problem (0-based full ranges)."""
    if sh < 0:
        sh = -sh * min(la, lb) // 100
    up = lb - la
    lw = 0
    if up < lw:
        lw, up = up, lw
    up += sh
    lw -= sh
    up = min(up, lb)       # b.right - a.left
    lw = max(lw, -la)      # b.left - a.right
    return Window(lw, up, up - lw + 3)
