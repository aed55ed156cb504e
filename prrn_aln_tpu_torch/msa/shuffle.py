"""Shuffle significance test (aln -R): Z-score of the real alignment
score against residue-shuffled versions (reference: autocomp.h:170-195
ShuffleServer, calcserv.h:694-704 fpavsd).

Counterpart of ``prrn_aln_tpu/msa/shuffle.py``.  All shuffles are scored
in ONE batched launch of kernel K1 on ``device`` (its plain version on
the CPU): the reference's serial jumble loop becomes a batch axis.  The
JAX function calls the scan scorer directly, so the row sweep (K1f) is
never taken here, whatever ``PRRN_PW_FUSED`` says.  The permutations
are drawn on the host, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.window import stripe
from ..ops.pairwise import pairwise_scores


def shuffle_test(a: np.ndarray, b: np.ndarray, mtx, u: float, v: float,
                 sh: int, njumble: int = 10, which: int = 3,
                 seed: int = 1, *, device) -> dict:
    """Returns {score, mean, sd, dev, njumble}."""
    rng = np.random.default_rng(seed)
    A = [a]
    B = [b]
    for _ in range(njumble):
        A.append(rng.permutation(a) if which & 1 else a)
        B.append(rng.permutation(b) if which & 2 else b)
    Bn = len(A)
    ma, mb = len(a), len(b)
    wdw = stripe(ma, mb, sh)

    def put(x):
        return torch.as_tensor(np.ascontiguousarray(x), device=device)

    scores = pairwise_scores(
        put(np.stack(A).astype(np.int32)), put(np.stack(B).astype(np.int32)),
        np.full(Bn, ma, np.int32), np.full(Bn, mb, np.int32),
        put(np.asarray(mtx, np.float32)), u, v,
        lw=np.full(Bn, wdw.lw, np.int32), up=np.full(Bn, wdw.up, np.int32),
        fused=False).cpu().numpy()
    real = float(scores[0])
    sample = scores[1:]
    mean = float(sample.mean())
    sd = float(sample.std())
    dev = (real - mean) / sd if sd > 0 else 0.0
    return {"score": real, "mean": mean, "sd": sd, "dev": dev,
            "njumble": njumble}
