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

from prrn_aln_tpu import alphabet as jab, scoring as jscoring
from prrn_aln_tpu.config import AlnParams as JParams
from prrn_aln_tpu.config import default_params as jdefault
from prrn_aln_tpu.msa import distance as jdistance
from prrn_aln_tpu.ops.pairwise import wavefront_scores
from prrn_aln_tpu.ops.pallas_pairwise import pallas_pairwise_scores
from prrn_aln_tpu_torch.msa import distance as tdistance
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
    (10241, 21, ("cluster", 2, 11)),  # past one CTA: 8 CTAs of 11 warps
])
def test_pairwise_plan_rule(maxw, B, want):
    """K1's variant by band width: one warp a pair up to 4 x 64 slots,
    then warps of 2 slot pairs a lane up to 16 warps (more slot pairs a
    lane past that), then a thread-block cluster of such CTAs a pair; up
    to one CTA the batch's size does not change it."""
    plan = tpw.pairwise_plan(maxw, B, 23, 520, 520)
    assert (plan["variant"], plan["lanes"], plan["warps"]) == want
    assert plan["smem_bytes"] <= tpw.SMEM_MAX
    if plan["variant"] == "cluster":
        assert plan["ctas"] * plan["slots_per_cta"] >= maxw
        assert plan["threads"] == 32 * plan["warps"]
        assert plan["smem_bytes"] == (4 * 23 * 23 + 44 * plan["warps"]
                                      + 4 * (24 * plan["lanes"]
                                             * plan["ghost"] + 48) + 1040)
        return
    assert plan["ctas"] == 1
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
    # a band past the block variant's shared memory: a cluster of CTAs
    plan = tpw.pairwise_plan(20000, 4, 23, 200, 200)
    assert plan["variant"] == "cluster"
    assert plan["ctas"] * plan["slots_per_cta"] >= 20000


@pytest.mark.parametrize("maxw", [10843, 19243, 24043, 48043])
@pytest.mark.parametrize("B", [1, 10, 100])
def test_pairwise_plan_cluster(maxw, B):
    """Past one CTA's 10,240 slots a cluster of at most 16 CTAs whose
    owned slots cover the band (a DNA family's distance pass at 9, 16, 20
    and 40 kb a side), every CTA's window its owned slots and a ghost of
    whole lanes a side, an exchange at most every ghost's slots."""
    plan = tpw.pairwise_plan(maxw, B, 17, 20000, 20000)
    assert plan["variant"] == "cluster"
    assert 2 <= plan["ctas"] <= tpw.K1_MAX_CTAS
    assert plan["ctas"] * plan["slots_per_cta"] >= maxw
    assert plan["slots_per_cta"] == tpw.cluster_owned(
        plan["lanes"], plan["warps"], plan["ghost"])
    assert plan["lanes"] in tpw.K1_LANES and plan["lanes"] >= 2
    assert 1 <= plan["warps"] <= tpw.K1_MAX_WARPS
    assert 2 * plan["lanes"] * plan["ghost"] >= tpw.K1_GHOST
    assert 1 <= plan["every"] <= 2 * plan["lanes"] * plan["ghost"]
    assert 32 * plan["warps"] >= 4 * plan["ghost"]
    assert plan["smem_bytes"] <= tpw.SMEM_MAX
    # the fewest lanes a thread for those CTAs
    smaller = [n for n in tpw.K1_LANES if 2 <= n < plan["lanes"]]
    for n in smaller:
        assert plan["ctas"] * tpw.cluster_owned(
            n, tpw.K1_MAX_WARPS, tpw._ghost_lanes(n)) < maxw
    # a batch that leaves SMs idle spreads over 16 CTAs (1 and 10 pairs,
    # measured fastest on the card), 100 pairs over the fewest that hold
    # the band
    fewest = -(-maxw // tpw.cluster_owned(10, 16, 1))
    assert plan["ctas"] == (16 if B <= 16 else max(fewest, 2))


def test_pairwise_plan_one_cluster_and_past_it():
    """The widest band one cluster holds takes 16 CTAs of 16 warps of
    10 slot pairs a lane; a slot more, and 163,840 and 200,000 slots,
    take the block variant with its band in device memory."""
    top = tpw.cluster_max_slots()
    assert top == 16 * tpw.cluster_owned(10, 16, 1) == 163200
    plan = tpw.pairwise_plan(top, 1, 17, 20000, 20000)
    assert (plan["variant"], plan["ctas"], plan["warps"], plan["lanes"]) == (
        "cluster", 16, 16, 10)
    for maxw in (top + 1, 163840, 200000):
        plan = tpw.pairwise_plan(maxw, 4, 17, 20000, 20000)
        assert (plan["variant"], plan["state"]) == ("block", "device")
        assert plan["smem_bytes"] == 4 * (17 * 17 + 32)
    # the band in shared memory is kept wherever it fits, and can be
    # asked for in device memory
    assert tpw.pairwise_plan(200, 4, 23, 120000, 120000)["state"] == "shared"
    plan = tpw.pairwise_plan(300, 8, 23, 200, 200, variant="block",
                             state="device")
    assert (plan["state"], plan["smem_bytes"]) == ("device",
                                                   4 * (23 * 23 + 32))


@pytest.mark.parametrize("dim", [17, 23, 256])
@pytest.mark.parametrize("codes", [200, 20000])
def test_pairwise_plan_every_band(dim, codes):
    """A plan for every band width with ``dim`` <= 256 (the JAX scan
    takes any band): 3 to 200,000 slots, 200-residue and 20 kb codes."""
    widths = sorted({3, 256, 257, 10240, 10241, 24043, 163200, 163201,
                     200000, *np.unique(np.geomspace(3, 200000, 60)
                                        .astype(int)).tolist()})
    for maxw in widths:
        for B in (1, 10, 512):
            plan = tpw.pairwise_plan(maxw, B, dim, codes, codes)
            assert plan["smem_bytes"] <= tpw.SMEM_MAX
            assert plan["ctas"] * plan["slots_per_cta"] >= maxw
    # the matrix of 256 letters does not fit in shared memory: in device
    # memory beside the band
    plan = tpw.pairwise_plan(24043, 10, 256, codes, codes)
    assert (plan["variant"], plan["state"], plan["smem_bytes"]) == (
        "block", "device", 128)


@pytest.mark.parametrize("kw", [
    {"variant": "cluster", "ctas": 1},
    {"variant": "cluster", "ctas": 17},
    {"variant": "cluster", "ctas": 2, "lanes": 7},      # not built
    {"variant": "cluster", "ctas": 2, "lanes": 2, "warps": 17},
    {"variant": "cluster", "ctas": 2, "lanes": 2, "warps": 1},  # < the band
    {"variant": "cluster", "ctas": 2, "ghost": 0},
    {"variant": "cluster", "ctas": 2, "ghost": 32},
    {"variant": "cluster", "ctas": 2, "lanes": 2, "ghost": 4, "every": 17},
    {"variant": "cluster", "ctas": 2, "every": 0},
    {"variant": "cluster", "ctas": 3, "lanes": 1, "warps": 1, "ghost": 8},
    {"variant": "warps", "ctas": 2},
    {"variant": "block", "ghost": 1},
    {"variant": "warps", "state": "device"},
    {"variant": "block", "state": "cache"},
])
def test_pairwise_plan_cluster_refuses(kw):
    """An asked variant, cluster or state the kernel cannot take."""
    with pytest.raises(ValueError):
        tpw.pairwise_plan(3000, 8, 23, 200, 200, **kw)


def _dna_family(rng, nt, subs, indels=3):
    """A seeded DNA sequence and its mutants (substitutions and short
    indels), as codes of the DNA alphabet."""
    base = rng.integers(0, 4, nt)
    out = [base]
    for sub in subs:
        mut = list(base)
        for _ in range(indels):
            p = int(rng.integers(200, len(mut) - 200))
            if rng.random() < 0.5:
                del mut[p:p + int(rng.integers(1, 4))]
            else:
                mut[p:p] = list(rng.integers(0, 4, int(rng.integers(1, 4))))
        mut = np.array(mut)
        hit = rng.random(len(mut)) < sub
        mut[hit] = rng.integers(0, 4, int(hit.sum()))
        out.append(mut)
    return [jab.encode("".join("ACGT"[c] for c in s), jab.DNA)
            .astype(np.int32) for s in out]


def test_distance_pass_past_one_cta_matches_jax_scan():
    """The port's distance pass (``msa/distance.all_pairs_scores``) on a
    seeded three-member DNA family of ~9 kb, whose bands pass one CTA's
    10,240 slots (the cluster variant's shapes on the card), against the
    JAX package's scan scorer, within 2 f32 ulp."""
    params = jdefault(jab.DNA, "prrn")
    mtx, _ = jscoring.build_matrix(jab.DNA, params)
    seqs = _dna_family(np.random.default_rng(17), 9000, (0.03, 0.08))
    widths = [stripe(len(a), len(b), params.sh).width
              for j, b in enumerate(seqs) for a in seqs[:j]]
    assert min(widths) > 10240
    want = jdistance.all_pairs_scores(seqs, mtx, params.u, params.v,
                                      params.sh, backend="scan")
    got = tdistance.all_pairs_scores(seqs, mtx, params.u, params.v,
                                     params.sh, device="cpu")
    np.testing.assert_array_max_ulp(got, want, maxulp=2)
