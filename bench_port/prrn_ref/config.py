"""Typed alignment-parameter configuration.

Replaces the reference's global mutable parameter structs (``ALPRM``/
``ALPRM2``/``ALGMODE``; reference: src/seq.h:27-31, src/clib.h:37-55,
defaults src/simmtx.cc:44-58) with an immutable dataclass.  User-visible
parameter names (u, v, pam, thr, sh, tgapf ...) are kept so CLI flags and
documentation stay compatible.
"""

from __future__ import annotations

import dataclasses
from . import alphabet


@dataclasses.dataclass(frozen=True)
class AlnParams:
    """Scoring / gap parameters (reference ALPRM + DefPrm)."""

    # gap costs (positive numbers; penalties applied as negative)
    u: float = 2.0        # basic gap extension
    v: float = 9.0        # basic gap open
    u0: float = 0.0       # background ("ether") gap extension
    u1: float = 0.6       # long-gap extension (double affine 2nd slope)
    v0: float = 0.0       # background gap open
    k1: int = 7           # flex point where long-gap slope takes over
    ls: int = 1           # number of affine pieces (1 = single affine)

    tgapf: float = 1.0    # terminal-gap discount factor
    thr: float = 35.0     # score threshold (distance edge cutoff in prrn)
    scale: float = 1.0    # overall score scale
    gamma: float = 0.5
    maxsp: float = 8.0    # traceback arena cap (reference Vmf); unused here

    sh: int = 100         # band shoulder; negative = percent of shorter seq
    mtx_no: int = 0       # which substitution matrix slot

    # protein matrix selection (reference DefPrm)
    pam: int = 250
    bias: float = 0.0
    # DNA match/mismatch
    n_match: float = 2.0
    n_mismatch: float = -6.0

    # end-gap mode bits, reference algmode.lcl: bit0/1 = a left/right free,
    # bit2/3 = b left/right free, bit4 = SWG local
    lcl: int = 0

    # intron-position match bonus -yJ (reference alprm2.spb, default 20
    # simmtx.cc:48; SpbFact = scale*spb, gsinfo.cc:35)
    spb: float = 20.0

    def scaled_u(self) -> float:
        return self.u * self.scale

    def scaled_v(self) -> float:
        return self.v * self.scale


# Program defaults. The reference's nominal defaults (setdefPprm(250,2,9),
# setdefNprm(-2,2,4)) land in matrix slot 0, but algmode.crs is truthy by
# default so setSimmtxes swaps slots 0/1 (simmtx.cc:705-711): the PRIMARY
# matrix actually used is slot 1 — protein PAM 150 (u=2, v=9), DNA
# match=2/mismatch=-4 (u=2, v=6).  Confirmed by the reference's own output
# header ("PAM = 150") and matched golden scores.
ALN_DEFAULTS = AlnParams(pam=150, sh=-50)
PRRN_DEFAULTS = AlnParams(pam=150, sh=-60, thr=70.0)
PRRN_DNA_DEFAULTS = AlnParams(u=2.0, v=6.0, n_match=2.0, n_mismatch=-4.0,
                              sh=-60, thr=70.0)
ALN_DNA_DEFAULTS = AlnParams(u=2.0, v=6.0, n_match=2.0, n_mismatch=-4.0,
                             sh=-50)


def default_params(molc: int, program: str = "prrn") -> AlnParams:
    if molc == alphabet.PROTEIN:
        return PRRN_DEFAULTS if program == "prrn" else ALN_DEFAULTS
    return PRRN_DNA_DEFAULTS if program == "prrn" else ALN_DNA_DEFAULTS
