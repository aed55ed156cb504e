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


@pytest.mark.parametrize("maxw,B,want", [
    (3, 21, ("warp", 1, 1)),
    (64, 21, ("warp", 1, 1)),
    (65, 21, ("warp", 2, 1)),
    (128, 21, ("warp", 2, 1)),
    (129, 21, ("warp", 3, 1)),
    (256, 512, ("warp", 4, 1)),       # the widest band of one warp a pair
    (257, 21, ("warps", 2, 3)),
    (627, 21, ("warps", 2, 5)),       # ce13a17's distance pass
    (627, 101, ("warps", 2, 5)),      # fam19's edge batch
    (617, 512, ("warps", 2, 5)),      # the 512 x 512 bench at sh=-60
    (2048, 21, ("warps", 2, 16)),
    (2049, 21, ("warps", 3, 11)),     # past 16 warps of 2 slot pairs
    (10240, 21, ("warps", 10, 16)),
    (10241, 21, ("block", 0, 0)),
])
def test_pairwise_plan_rule(maxw, B, want):
    """K1's variant by band width: one warp a pair up to 4 x 64 slots,
    then warps of 2 slot pairs a lane up to 16 warps (more slot pairs a
    lane past that), then one block a pair with the band in shared
    memory; the batch's size does not change it."""
    plan = tpw.pairwise_plan(maxw, B, 23, 520, 520)
    assert (plan["variant"], plan["lanes"], plan["warps"]) == want
    assert plan["smem_bytes"] <= tpw.SMEM_MAX
    if plan["variant"] == "block":
        assert plan["smem_bytes"] == 4 * (23 * 23 + 3 * maxw + 32)
        return
    assert 64 * plan["lanes"] * plan["warps"] >= maxw
    pairs = plan["pairs_per_block"]
    assert pairs == (tpw.K1_WARP_PAIRS if plan["variant"] == "warp" else 1)
    assert plan["threads"] == 32 * (pairs if plan["variant"] == "warp"
                                    else plan["warps"])
    assert plan["code_stride"] == 1040
    nwarps = plan["threads"] // 32
    assert plan["smem_bytes"] == 4 * 23 * 23 + 44 * nwarps + pairs * 1040


@pytest.mark.parametrize("kw", [
    {"variant": "warp", "lanes": 2},               # 128 slots < 300
    {"variant": "warp", "lanes": 7},               # not built
    {"variant": "warp", "warps": 2},
    {"variant": "warps", "lanes": 1, "warps": 4},  # 256 slots < 300
    {"variant": "warps", "lanes": 1, "warps": 17},
    {"variant": "block", "lanes": 2},
    {"variant": "rows"},
])
def test_pairwise_plan_refuses(kw):
    with pytest.raises(ValueError):
        tpw.pairwise_plan(300, 8, 23, 200, 200, **kw)


def test_pairwise_plan_limits():
    # codes as bytes: no register-state variant past 256 letters, and the
    # block variant's matrix does not fit either
    for variant in (None, "warp", "warps", "block"):
        with pytest.raises(ValueError):
            tpw.pairwise_plan(200, 4, 300, 200, 200, variant=variant)
    # codes past shared memory take the block variant
    assert tpw.pairwise_plan(200, 4, 23, 120000, 120000)["variant"] == "block"
    # fewer pairs a block where four pairs' codes do not fit
    plan = tpw.pairwise_plan(200, 4, 23, 40000, 40000)
    assert (plan["variant"], plan["pairs_per_block"]) == ("warp", 2)
    # a band past the block variant's shared memory
    with pytest.raises(ValueError):
        tpw.pairwise_plan(20000, 4, 23, 200, 200)
