"""State carried across from the JAX package.

This system has no weights.  What both packages must share is the
parameters (``AlnParams``), the substitution matrix ``mtx`` (a numpy
array both take as is) and the alignment state (``Msa``: codes,
weights, names and intron positions ``eij``).  The tests hand identical
state to both packages through these functions, including an ``Msa``
taken in the middle of a refinement.
"""

from __future__ import annotations

import numpy as np

from .config import AlnParams
from .msa.msa import Msa


def params_from_numpy(fields: dict) -> AlnParams:
    """The port's ``AlnParams`` from the JAX package's fields
    (``dataclasses.asdict`` of its ``AlnParams``)."""
    return AlnParams(**fields)


def msa_from_numpy(codes, weight, names, molc: int, eij=None) -> Msa:
    """The port's ``Msa`` from the JAX package's ``Msa`` fields given as
    numpy arrays and lists; derived arrays are rebuilt by ``prepare``."""
    return Msa(codes=np.array(codes, dtype=np.int8, copy=True),
               molc=int(molc), names=list(names),
               weight=None if weight is None else np.array(weight,
                                                           np.float64),
               eij=None if eij is None else [
                   None if e is None else np.array(e, copy=True) for e in eij])
