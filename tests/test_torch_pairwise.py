"""Port pairwise DP (plain version of kernel K1) vs the JAX package.

The plain PyTorch scorer must match the JAX scan scorer within 2 f32
ulp (XLA on the CPU may fuse a multiply-add that PyTorch rounds twice)
and the Pallas row sweep, run in interpret mode, within 4 ulp (its
E-scan reassociates, pallas_pairwise.py:27-31).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from prrn_aln_tpu import scoring as jscoring
from prrn_aln_tpu.config import AlnParams as JParams
from prrn_aln_tpu.ops.pairwise import wavefront_scores
from prrn_aln_tpu.ops.pallas_pairwise import pallas_pairwise_scores
from prrn_aln_tpu_torch.ops import pairwise as tpw
from prrn_aln_tpu_torch.ops.window import stripe

# one intra-op thread: the suite runs several worker processes at once,
# and PyTorch's OpenMP threads spin against each other when oversubscribed
torch.set_num_threads(1)

FIX = Path(__file__).parent / "fixtures"
FIXTURE = json.loads((FIX / "pairwise_fixtures.json").read_text())
PROT, _ = jscoring.protein_matrix(JParams(pam=FIXTURE["matrices"]["protein_pam"]))
DNA, _ = jscoring.dna_matrix(JParams(u=FIXTURE["matrices"]["dna_u"],
                                     n_mismatch=FIXTURE["matrices"]["dna_mismatch"]))


def _batch(items):
    """items: (a codes, b codes, sh, u, v, tgapf, lcl) -> padded arrays."""
    n = len(items)
    A = np.zeros((n, max(len(i[0]) for i in items)), np.int32)
    B = np.zeros((n, max(len(i[1]) for i in items)), np.int32)
    out = {k: np.zeros(n, t) for k, t in
           (("la", np.int32), ("lb", np.int32), ("lw", np.int32),
            ("up", np.int32), ("u", np.float32), ("v", np.float32),
            ("tg", np.float32))}
    exg = np.zeros((n, 4), bool)
    for k, (a, b, sh, u, v, tg, lcl) in enumerate(items):
        A[k, :len(a)] = a
        B[k, :len(b)] = b
        w = stripe(len(a), len(b), sh)
        out["la"][k], out["lb"][k] = len(a), len(b)
        out["lw"][k], out["up"][k] = w.lw, w.up
        out["u"][k], out["v"][k], out["tg"][k] = u, v, tg
        exg[k] = [lcl & 1, lcl & 2, lcl & 4, lcl & 8]
    out.update(A=A, B=B, exg=exg,
               nslot=int((out["up"] - out["lw"]).max()) + 3,
               nsteps=int((out["la"] + out["lb"]).max()) - 1)
    return out


def _jax(x, mtx, local):
    return np.asarray(wavefront_scores(
        x["A"], x["B"], x["la"], x["lb"], x["lw"], x["up"], mtx, x["u"],
        x["v"], x["tg"], x["exg"], nslot=x["nslot"], nsteps=x["nsteps"],
        dim=mtx.shape[0], local=local))


def _port(x, mtx, local):
    t = {k: torch.as_tensor(x[k]) for k in
         ("A", "B", "la", "lb", "lw", "up", "u", "v", "tg", "exg")}
    return tpw.wavefront_scores_ref(
        t["A"], t["B"], t["la"], t["lb"], t["lw"], t["up"],
        torch.as_tensor(mtx), t["u"], t["v"], t["tg"], t["exg"],
        nslot=x["nslot"], nsteps=x["nsteps"], local=local).numpy()


def check_fixture_cases(molc, local):
    """Fixture cases of one alphabet and mode: port vs JAX within 2 ulp,
    and vs the reference scores at test_pairwise_jax.py's tolerance."""
    seqs = FIXTURE["seqs"]
    items = [(seqs[c["a"]]["codes"], seqs[c["b"]]["codes"], c["sh"], c["u"],
              c["v"], c["tgapf"], c["lcl"]) for c in FIXTURE["cases"]
             if seqs[c["a"]]["molc"] == molc and bool(c["lcl"] & 16) == local]
    assert items
    mtx = PROT if molc == 1 else DNA
    x = _batch(items)
    got = _port(x, mtx, local)
    np.testing.assert_array_max_ulp(got, _jax(x, mtx, local), maxulp=2)
    want = np.array([c["score"] for c in FIXTURE["cases"]
                     if seqs[c["a"]]["molc"] == molc
                     and bool(c["lcl"] & 16) == local])
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=0.05)


@pytest.mark.parametrize("local", [False, True])
def test_protein_fixture_cases_match_jax(local):
    check_fixture_cases(1, local)


@pytest.mark.parametrize("seed", [0, 1])
def test_random_banded_batch_matches_jax(seed):
    rng = np.random.default_rng(seed)
    items = []
    for _ in range(12):
        la, lb = rng.integers(20, 90, 2)
        items.append((rng.integers(3, 23, la), rng.integers(3, 23, lb),
                      int(rng.choice([-60, -30, 5, 20])), 2.0, 9.0,
                      float(rng.choice([1.0, 0.5])), int(rng.integers(0, 16))))
    x = _batch(items)
    for local in (False, True):
        np.testing.assert_array_max_ulp(_port(x, PROT, local),
                                        _jax(x, PROT, local), maxulp=2)


def test_dispatch_matches_pallas_interpret():
    """The wrapper on CPU tensors (plain version) against the Pallas row
    kernel in interpret mode."""
    rng = np.random.default_rng(7)
    items = [(rng.integers(3, 23, int(rng.integers(30, 70))),
              rng.integers(3, 23, int(rng.integers(30, 70))), -60, 2.0, 9.0,
              1.0, 0) for _ in range(6)]
    x = _batch(items)
    want = np.asarray(pallas_pairwise_scores(
        x["A"], x["B"], x["la"], x["lb"], PROT, 2.0, 9.0, lw=x["lw"],
        up=x["up"]))
    t = {k: torch.as_tensor(x[k]) for k in ("A", "B", "la", "lb", "lw", "up")}
    got = tpw.pairwise_scores(t["A"], t["B"], t["la"], t["lb"],
                              torch.as_tensor(PROT), 2.0, 9.0,
                              lw=t["lw"], up=t["up"]).numpy()
    np.testing.assert_array_max_ulp(got, want, maxulp=4)


def test_band_cells_counts_the_stripe():
    la, lb, lw, up = 7, 9, -2, 4
    m = np.arange(la)[:, None]
    n = np.arange(lb)[None, :]
    want = int((((n - m) >= lw) & ((n - m) <= up)).sum())
    assert tpw.band_cells(np.array([la]), np.array([lb]), np.array([lw]),
                          np.array([up])) == want
