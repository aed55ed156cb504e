"""Port seeded aligner (``ops/seeded.py``) vs the JAX package.

test_seeded.py's four cases, on the CPU: the k-mer anchors and their
chain equal the JAX package's; ``seeded_align`` gives the JAX package's
SKL, and a score within that file's tolerances of the JAX package's
seeded and full-DP scores.
"""

import numpy as np
import pytest
import torch

from prrn_aln_tpu import alphabet as jab, scoring as jscoring
from prrn_aln_tpu.config import default_params as jdefault_params
from prrn_aln_tpu.msa.msa import Msa as JMsa
from prrn_aln_tpu.ops import group as jg, seeded as jseeded
from prrn_aln_tpu.ops.window import stripe as jstripe
from prrn_aln_tpu_torch import convert
from prrn_aln_tpu_torch.ops import group as tg, seeded as tseeded
from prrn_aln_tpu_torch.ops.window import stripe

# one intra-op thread: the suite runs several worker processes at once
torch.set_num_threads(1)

MTX, _ = jscoring.build_matrix(jab.DNA, jdefault_params(jab.DNA, "prrn"))


def _mk(arr):
    s = "".join("ACGT"[c] for c in arr)
    m = JMsa(codes=jab.encode(s, jab.DNA)[None, :], molc=jab.DNA,
             names=["g"])
    m.prepare(MTX.shape[0])
    return m


def _port(m):
    p = convert.msa_from_numpy(m.codes, m.weight, m.names, m.molc, m.eij)
    p.prepare(MTX.shape[0])
    return p


def _mutate(rng, base, sub=0.03, indels=2):
    """test_seeded.py's mutant: substitutions and short indels."""
    mut = list(base)
    for _ in range(indels):
        p = int(rng.integers(200, len(mut) - 200))
        if rng.random() < 0.5:
            del mut[p:p + int(rng.integers(1, 4))]
        else:
            mut[p:p] = list(rng.integers(0, 4, int(rng.integers(1, 4))))
    mut = np.array(mut)
    m = rng.random(len(mut)) < sub
    mut[m] = rng.integers(0, 4, int(m.sum()))
    return mut


def test_hsp_chain_matches_jax():
    rng = np.random.default_rng(2)
    base = rng.integers(0, 4, 3000)
    mut = _mutate(rng, base)
    want = jseeded.chain_hsps(jseeded.find_hsps(base, mut, k=12))
    got = tseeded.chain_hsps(tseeded.find_hsps(base, mut, k=12))
    assert want
    assert [(h.ai, h.bi, h.length) for h in got] == [
        (h.ai, h.bi, h.length) for h in want]
    assert sum(h.length for h in got) > 0.3 * len(base)


def _both(A, B, full_wdw, ls=1, **kw):
    """JAX full DP, JAX seeded, port seeded and port full DP."""
    s0, k0 = jg.group_align(A, B, MTX, u=2.0, v=9.0, wdw=full_wdw, ls=ls)
    s1, k1 = jseeded.seeded_align(A, B, MTX, u=2.0, v=9.0, ls=ls, **kw)
    s2, k2 = tseeded.seeded_align(_port(A), _port(B), MTX, u=2.0, v=9.0,
                                  ls=ls, device="cpu", **kw)
    return (s0, k0), (s1, k1), (s2, k2)


def test_seeded_matches_full_dp():
    rng = np.random.default_rng(3)
    base = rng.integers(0, 4, 2000)
    mut = _mutate(rng, base, sub=0.02, indels=2)
    A, B = _mk(base), _mk(mut)
    full, jseed, (s2, k2) = _both(A, B, jstripe(A.length, B.length, -60))
    assert k2 == jseed[1] == full[1]
    assert s2 == pytest.approx(jseed[0], rel=1e-5, abs=1e-2)
    assert s2 == pytest.approx(full[0], rel=1e-5, abs=1e-2)


def test_seeded_dissimilar_falls_back():
    """No anchor: the port's group_align on the whole pair."""
    rng = np.random.default_rng(4)
    A = _mk(rng.integers(0, 4, 300))
    B = _mk(rng.integers(0, 4, 310))
    full, jseed, (s2, k2) = _both(A, B, jstripe(A.length, B.length, -60),
                                  sh=-60)
    assert k2 == jseed[1] == full[1]
    assert s2 == pytest.approx(full[0], rel=1e-5, abs=1e-2)
    s3, k3 = tg.group_align(_port(A), _port(B), MTX, u=2.0, v=9.0,
                            wdw=stripe(A.length, B.length, -60),
                            device="cpu")
    assert (s3, k3) == (s2, k2)


def test_seeded_ls3_matches_full():
    """Double-affine stitches: piecewise within test_seeded.py's bound of
    the full ls3 DP, and the JAX package's SKL."""
    rng = np.random.default_rng(7)
    base = rng.integers(3, 7, 1500).astype(np.int64)
    a = base.copy()
    b = np.concatenate([base[:700], base[760:]])    # 60-nt deletion
    mut = rng.integers(0, len(b), 20)
    b[mut] = ((b[mut] - 3 + 1) % 4) + 3
    A, B = _mk(a - 3), _mk(b - 3)
    full, jseed, (s2, k2) = _both(A, B, jstripe(A.length, B.length, -200),
                                  ls=3, sh=-200)
    assert k2 == jseed[1]
    assert s2 == pytest.approx(jseed[0], rel=1e-5, abs=1e-2)
    assert abs(s2 - full[0]) <= 1e-3 * max(1.0, abs(full[0]))
