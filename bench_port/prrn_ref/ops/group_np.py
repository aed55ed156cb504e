"""NumPy reference implementation of the banded group-to-group DP.

Implements the "naive exact" gap-accounting tier: every cell carries the
current gap-run length of each member (``gla``/``glb``), and gap-open costs
count, for every member pair, whether the move opens a new gap —
weighted by sequence weights and terminal-gap densities.  This reproduces
the reference's ``DPunit_nv`` algebra (reference: src/fwd2c.cc:106-148,
src/maln2.cc crg22w/crg22i and friends) which the reference itself treats
as exact; its GFREQ profile tiers compute the same quantity faster for
wide MSAs (SURVEY.md A.2).

The scan is the reference's banded row scan (src/fwd2c.h:358-487
forwardB), including boundary initialization by marching the top row /
left column with the same gap machinery (initB) and the exact tie-breaking
order (diag beats non-diag ties; horizontal beats vertical ties), so
traceback paths are bit-identical.

Grid convention: cell (m', n') for m' in [0, La], n' in [0, Lb] is the
state after consuming m' columns of A and n' of B; column-indexed arrays
use index m'-1 with a boundary row at -1.
"""

from __future__ import annotations

import numpy as np

from ..msa.msa import Msa
from .window import Window

NEVSEL = -1.0e30

# lane codes for traceback
DIAG, VERT, HORI, VERT2, HORI2 = 0, 1, 2, 3, 4


def _col_arrays(msa: Msa):
    """Per-column member arrays with a boundary row prepended (index 0 =
    column -1): residue mask, gap density, post-gap density."""
    eff = msa.eff_codes
    L, many = msa.length, msa.many
    na = np.zeros((L + 1, many))
    na[1:] = (eff > 1).T
    gd = np.zeros((L + 1, many))
    gd[1:] = msa.gdens
    pg = np.ones((L + 1, many))
    pg[1:] = msa.pgdens
    # boundary column -1: sentinel written by exg_seq is gap (global) or
    # nil; gapdensity(gap)=1; postgapdensity at -1 = exgl? 0: tgapf if the
    # sentinel is nil (free/discount) else 1
    gl = msa.exgl or msa.tgapf < 1.0
    gd[0] = (0.0 if msa.exgl else msa.tgapf) if gl else 1.0
    pg[0] = (0.0 if msa.exgl else msa.tgapf) if gl else 1.0
    return na, gd, pg


