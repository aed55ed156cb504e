"""State carried across from the JAX package.

This system has no weights.  What both packages must share is the
parameters (``AlnParams``), the substitution matrix ``mtx`` (a numpy
array both take as is) and the alignment state (``Msa``: codes,
weights, names and intron positions ``eij``).  The tests hand identical
state to both packages through these functions, including an ``Msa``
taken in the middle of a refinement, and the group wavefront's carry
between two chunks of steps (``carry_from_jax``, ``carry_to_jax``).
"""

from __future__ import annotations

import numpy as np
import torch

from .config import AlnParams
from .msa.msa import Msa
from .ops.group import Carry


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


# the JAX kernel's gap-run parts, in its order (``pallas_group._kernel``):
# [Hgla Hglb Ggla Gglb Fgla Fglb G2gla G2glb F2gla F2glb], part 2 * lane
# + side for the lanes GH, GG, GF, GG2, GF2 of the port's carry
_JAX_PARTS = 10


def carry_from_jax(st, gl, *, an: int, bn: int, ls3: bool,
                   device="cpu") -> Carry:
    """The port's ``Carry`` from the JAX kernel's carry: ``st`` (B, 8,
    nslot) f32, rows H, G, F, G2, F2, Hdir (as f32), 0, 0; ``gl`` (B, 10 *
    R, nslot) f32, ten parts of R rows each.  The port keeps the first
    ``an`` rows of A's parts and ``bn`` of B's (its real members), the
    lanes GH, GG, GF (and GG2, GF2 with ``ls3``), as int32 between two
    zero columns."""
    st = np.asarray(st, np.float32)
    gl = np.asarray(gl, np.float32)
    Bn, _, nslot = st.shape
    R = gl.shape[1] // _JAX_PARTS
    if gl.shape != (Bn, _JAX_PARTS * R, nslot) or max(an, bn) > R:
        raise ValueError(f"carry_from_jax: gl {gl.shape} for st {st.shape}, "
                         f"{an} + {bn} members")
    parts = gl.reshape(Bn, _JAX_PARTS, R, nslot)
    nl = 5 if ls3 else 3
    rows = ([parts[:, 2 * ln, :an] for ln in range(nl)]
            + [parts[:, 2 * ln + 1, :bn] for ln in range(nl)])
    runs = np.zeros((Bn, nl * (an + bn), nslot + 2), np.int32)
    runs[:, :, 1:nslot + 1] = np.concatenate(rows, 1).astype(np.int32)
    return Carry(torch.as_tensor(st[:, :5].copy(), device=device),
                 torch.as_tensor(st[:, 5].astype(np.int8), device=device),
                 torch.as_tensor(runs, device=device))


def carry_to_jax(carry: Carry, *, an: int,
                 ls3: bool) -> tuple[np.ndarray, np.ndarray]:
    """The JAX kernel's (st, gl) from the port's ``Carry`` with ``an``
    member rows of A (and the rest of B): parts of the larger side's
    rows, the rows past a side's own and the lanes GG2 and GF2 without
    ``ls3`` left 0, as the JAX kernel's cold start has them."""
    vals = carry.vals.cpu().numpy()
    runs = carry.runs.cpu().numpy()[:, :, 1:-1]
    Bn, _, nslot = vals.shape
    nl = 5 if ls3 else 3
    bn = runs.shape[1] // nl - an
    R = max(an, bn)
    if bn < 0 or runs.shape[1] != nl * (an + bn):
        raise ValueError(f"carry_to_jax: {runs.shape[1]} run rows, "
                         f"{an} of A")
    st = np.zeros((Bn, 8, nslot), np.float32)
    st[:, :5] = vals
    st[:, 5] = carry.hdir.cpu().numpy()
    parts = np.zeros((Bn, _JAX_PARTS, R, nslot), np.float32)
    for ln in range(nl):
        parts[:, 2 * ln, :an] = runs[:, ln * an:(ln + 1) * an]
        parts[:, 2 * ln + 1, :bn] = runs[:, nl * an + ln * bn:
                                         nl * an + (ln + 1) * bn]
    return st, parts.reshape(Bn, _JAX_PARTS * R, nslot)
