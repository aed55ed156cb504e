"""Port row-sweep pairwise DP (plain version of kernel K1f) vs the JAX
package's fused Pallas row kernel.

The same seeded numpy inputs go through ``pallas_pairwise_scores`` under
``PRRN_PW_FUSED=1`` (``_kernel_rows_fused``, in interpret mode off the
TPU) and through the port's ``pairwise_scores`` on CPU tensors under the
same switch (``row_scores_ref``).  The limit is 4 f32 ulp; what is
reached on every batch here is bit equality (``REACHED_ULP`` = 0): the
plain version runs the fused kernel's float operations in its order.
Against the anti-diagonal scorer (K1's plain version) the running
maximum reassociates the ``- u`` steps.  The limit there is 4 ulp at the
DP's scale: a score is a difference of row values as large as the
boundary penalty ``v + u * max(la, lb)``, so a score near 0 carries the
rounding of those values, which is many ulp of the score itself.
"""

import re
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from prrn_aln_tpu import scoring as jscoring
from prrn_aln_tpu.config import AlnParams as JParams
from prrn_aln_tpu.ops.pallas_pairwise import pallas_pairwise_scores
from prrn_aln_tpu_torch.ops import _build, pairwise as tpw
from prrn_aln_tpu_torch.ops.window import stripe

# one intra-op thread: the suite runs several worker processes at once
torch.set_num_threads(1)

PROT, _ = jscoring.protein_matrix(JParams(pam=150))
DNA, _ = jscoring.dna_matrix(JParams(u=2.0, n_mismatch=-6.0))
REACHED_ULP = 0


def _long_pair(seed, la, lb):
    """One DNA pair of ``la`` x ``lb`` (b a copy of a with substitutions,
    then random bases), the full rectangle: la + lb + 1 lanes."""
    rng = np.random.default_rng(seed)
    a = rng.integers(3, 7, la).astype(np.int32)
    b = rng.integers(3, 7, lb).astype(np.int32)
    b[:la] = np.where(rng.random(la) < 0.1, b[:la], a)
    return dict(A=a[None], B=b[None], la=np.array([la], np.int32),
                lb=np.array([lb], np.int32))


def _pairs(seed, n, lo, hi, ncode, sh):
    """n seeded pairs of lengths in [lo, hi); sh None = full rectangle."""
    rng = np.random.default_rng(seed)
    la = rng.integers(lo, hi, n).astype(np.int32)
    lb = rng.integers(lo, hi, n).astype(np.int32)
    A = np.zeros((n, int(la.max())), np.int32)
    B = np.zeros((n, int(lb.max())), np.int32)
    for k in range(n):
        A[k, :la[k]] = rng.integers(3, 3 + ncode, la[k])
        B[k, :lb[k]] = rng.integers(3, 3 + ncode, lb[k])
    x = dict(A=A, B=B, la=la, lb=lb)
    if sh is not None:
        wd = [stripe(int(p), int(q), sh) for p, q in zip(la, lb)]
        x["lw"] = np.array([w.lw for w in wd], np.int32)
        x["up"] = np.array([w.up for w in wd], np.int32)
    return x


def _jax(x, mtx, tgapf=1.0, exg=None):
    return np.asarray(pallas_pairwise_scores(
        x["A"], x["B"], x["la"], x["lb"], mtx, 2.0, 9.0, tgapf=tgapf,
        exg=exg, lw=x.get("lw"), up=x.get("up")))


def _port(x, mtx, tgapf=1.0, exg=None):
    t = {k: torch.as_tensor(v) for k, v in x.items()}
    return tpw.pairwise_scores(
        t["A"], t["B"], t["la"], t["lb"], torch.as_tensor(mtx), 2.0, 9.0,
        tgapf=tgapf, exg=None if exg is None else torch.as_tensor(exg),
        lw=t.get("lw"), up=t.get("up")).numpy()


CASES = {
    "banded_protein": dict(x=_pairs(7, 7, 30, 70, 20, -60), mtx=PROT),
    "full_rectangle": dict(x=_pairs(8, 5, 12, 48, 20, None), mtx=PROT),
    "exg_tgapf": dict(x=_pairs(9, 6, 25, 60, 20, -40), mtx=PROT, tgapf=0.5,
                      exg=np.random.default_rng(9).random((6, 4)) < 0.4),
    "dna": dict(x=_pairs(10, 6, 30, 80, 4, -50), mtx=DNA),
    # a band past 8,192 lanes (8,209: K1f's cluster variant on the card)
    # of the fewest rows the fused kernel takes (8): it unrolls its rows
    # and each row's 128-lane tiles when traced, so its time here grows
    # with rows x lanes (~80 s at 8 rows, ~15 min at 300)
    "dna_past_8192": dict(x=_long_pair(11, 8, 8200), mtx=DNA),
}


@pytest.mark.parametrize("name", list(CASES))
def test_row_sweep_matches_fused_pallas_kernel(name, monkeypatch):
    monkeypatch.setenv("PRRN_PW_FUSED", "1")
    c = CASES[name]
    kw = dict(tgapf=c.get("tgapf", 1.0), exg=c.get("exg"))
    got = _port(c["x"], c["mtx"], **kw)
    want = _jax(c["x"], c["mtx"], **kw)
    assert np.isfinite(got).all() and (got > -1e8).all()
    np.testing.assert_array_max_ulp(got, want, maxulp=4)
    ulp = np.abs(got.view(np.int32).astype(np.int64)
                 - want.view(np.int32).astype(np.int64)).max()
    assert ulp <= REACHED_ULP, f"{name}: {ulp} ulp"


def _ref_args(x, tgapf=1.0, exg=None):
    n = len(x["la"])
    t = {k: torch.as_tensor(v) for k, v in x.items()}
    lw = t.get("lw", -t["la"])
    up = t.get("up", t["lb"])
    full = lambda val: torch.full((n,), val, dtype=torch.float32)  # noqa
    e = torch.zeros((n, 4), dtype=torch.bool) if exg is None \
        else torch.as_tensor(exg)
    return (t["A"], t["B"], t["la"], t["lb"], lw, up), \
        (full(2.0), full(9.0), full(tgapf), e)


def _ulp_at_dp_scale(got, want, x, u=2.0, v=9.0):
    """Largest difference in f32 ulp of the larger of the score and the
    pair's boundary penalty v + u * max(la, lb)."""
    pen = v + u * np.maximum(x["la"], x["lb"])
    scale = np.maximum(np.maximum(np.abs(got), np.abs(want)), pen)
    return float((np.abs(got.astype(np.float64) - want)
                  / np.spacing(scale.astype(np.float32))).max())


@pytest.mark.parametrize("name", list(CASES))
def test_row_sweep_matches_wavefront_within_4_ulp(name):
    c = CASES[name]
    seqs, prm = _ref_args(c["x"], c.get("tgapf", 1.0), c.get("exg"))
    lw, up = seqs[4], seqs[5]
    mtx = torch.as_tensor(c["mtx"])
    rows = tpw.row_scores_ref(*seqs, mtx, *prm, lw0=int(lw.min()),
                              nlane=int(up.max() - lw.min()) + 1,
                              nrow=int(seqs[2].max()))
    wave = tpw.wavefront_scores_ref(*seqs, mtx, *prm,
                                    nslot=int((up - lw).max()) + 3,
                                    nsteps=int((seqs[2] + seqs[3]).max()) - 1)
    assert _ulp_at_dp_scale(rows.numpy(), wave.numpy(), c["x"]) <= 4
    if name != "exg_tgapf":          # no score near 0 in these batches
        np.testing.assert_array_max_ulp(rows.numpy(), wave.numpy(), maxulp=4)


def test_extra_lanes_and_rows_change_nothing():
    """Lanes past the widest band and rows past the longest sequence (the
    TPU kernel's padding) leave every score as it is."""
    x = CASES["banded_protein"]["x"]
    seqs, prm = _ref_args(x)
    lw, up = seqs[4], seqs[5]
    mtx = torch.as_tensor(PROT)
    lw0 = int(lw.min())
    tight = tpw.row_scores_ref(*seqs, mtx, *prm, lw0=lw0,
                               nlane=int(up.max()) - lw0 + 1,
                               nrow=int(seqs[2].max()))
    padded = tpw.row_scores_ref(*seqs, mtx, *prm, lw0=lw0, nlane=256,
                                nrow=x["A"].shape[1])
    assert torch.equal(tight, padded)


def test_switch_off_takes_the_wavefront_route(monkeypatch):
    """Without the switch, with ``local`` or with a matrix of more than 32
    codes the wrapper runs K1's plain version; with it, the row sweep."""
    x = CASES["banded_protein"]["x"]
    calls = []
    real_rows, real_wave = tpw._plain_rows, tpw._plain_pairwise
    monkeypatch.setattr(tpw, "_plain_rows", lambda *a: (
        calls.append("rows"), real_rows(*a))[1])
    monkeypatch.setattr(tpw, "_plain_pairwise", lambda *a: (
        calls.append("wave"), real_wave(*a))[1])
    t = {k: torch.as_tensor(v) for k, v in x.items()}
    args = (t["A"], t["B"], t["la"], t["lb"], torch.as_tensor(PROT), 2.0, 9.0)
    kw = dict(lw=t["lw"], up=t["up"])

    monkeypatch.delenv("PRRN_PW_FUSED", raising=False)
    off = tpw.pairwise_scores(*args, **kw)
    monkeypatch.setenv("PRRN_PW_FUSED", "1")
    on = tpw.pairwise_scores(*args, **kw)
    tpw.pairwise_scores(*args, local=True, **kw)
    big = torch.zeros((33, 33))
    big[:PROT.shape[0], :PROT.shape[1]] = torch.as_tensor(PROT)
    wide = tpw.pairwise_scores(*args[:4], big, 2.0, 9.0, **kw)
    assert calls == ["wave", "rows", "wave", "wave"]
    assert _ulp_at_dp_scale(on.numpy(), off.numpy(), x) <= 4
    assert torch.equal(wide, off)
    assert "pairwise_rows" not in _build.LAUNCHES


def test_lossy_screen_rounds_the_matrix_to_bf16(monkeypatch):
    """The bf16 edge screen equals K1's route on a matrix rounded
    beforehand, and the row sweep ignores it."""
    monkeypatch.delenv("PRRN_PW_FUSED", raising=False)
    x = CASES["banded_protein"]["x"]
    t = {k: torch.as_tensor(v) for k, v in x.items()}
    mtx = torch.as_tensor(PROT) * 1.003          # not bf16-exact
    rounded = mtx.to(torch.bfloat16).to(torch.float32)
    assert not torch.equal(mtx, rounded)
    args = (t["A"], t["B"], t["la"], t["lb"])
    kw = dict(lw=t["lw"], up=t["up"])
    lossy = tpw.pairwise_scores(*args, mtx, 2.0, 9.0, lossy=True, **kw)
    want = tpw.pairwise_scores(*args, rounded, 2.0, 9.0, **kw)
    exact = tpw.pairwise_scores(*args, mtx, 2.0, 9.0, **kw)
    assert torch.equal(lossy, want) and not torch.equal(lossy, exact)
    monkeypatch.setenv("PRRN_PW_FUSED", "1")
    assert torch.equal(
        tpw.pairwise_scores(*args, mtx, 2.0, 9.0, lossy=True, **kw),
        tpw.pairwise_scores(*args, mtx, 2.0, 9.0, **kw))


def test_lw0_is_part_of_the_function(monkeypatch):
    """A given ``lw0`` shifts the packing; the default is the batch's
    smallest ``lw``."""
    monkeypatch.setenv("PRRN_PW_FUSED", "1")
    x = CASES["banded_protein"]["x"]
    t = {k: torch.as_tensor(v) for k, v in x.items()}
    args = (t["A"], t["B"], t["la"], t["lb"], torch.as_tensor(PROT), 2.0, 9.0)
    kw = dict(lw=t["lw"], up=t["up"])
    default = tpw.pairwise_scores(*args, **kw)
    same = tpw.pairwise_scores(*args, lw0=int(x["lw"].min()), **kw)
    shifted = tpw.pairwise_scores(*args, lw0=int(x["lw"].min()) - 5, **kw)
    assert torch.equal(default, same)
    assert _ulp_at_dp_scale(shifted.numpy(), default.numpy(), x) <= 4


# ---------------------------------------------------------------------
# K1f's launch plan (csrc/pairwise_rows.cu reads it; pure Python)

# (lanes, pairs) -> variant, lanes a thread, warps a pair, pairs a block
ROWS_PLANS = {
    (20, 512): ("warp", 2, 1, 2),
    (615, 512): ("warp", 20, 1, 2),       # the 512 x 512 bench at sh=-60
    (615, 528): ("warp", 20, 1, 4),       # four pairs a block from 528 pairs
    (1024, 132): ("warp", 32, 1, 1),      # the widest band of one warp
    (1025, 132): ("warps", 8, 5, 1),
    (128, 21): ("warp", 4, 1, 1),         # a small batch: one warp still
    (129, 21): ("warps", 4, 2, 1),        # then four lanes a thread
    (777, 101): ("warps", 4, 7, 1),       # fam19's edge batch
    (2048, 8): ("warps", 4, 16, 1),
    (2049, 8): ("warps", 8, 9, 1),
    (4096, 512): ("warps", 8, 16, 1),
    (4097, 512): ("warps", 12, 11, 1),
    (8192, 2): ("warps", 16, 16, 1),      # the widest band of the warps
    (8193, 2): ("cluster", 8, 3, 1),      # then a cluster (of 16 CTAs)
}


@pytest.mark.parametrize("nlane, B", list(ROWS_PLANS))
def test_rows_plan_rule(nlane, B):
    """K1f's variant by band width and batch: one warp a pair (lanes in
    registers) up to 1,024 lanes for a batch that fills the card's SMs,
    several warps a pair for a smaller batch and up to 8,192 lanes, a
    cluster of CTAs of several warps past that."""
    plan = tpw.rows_plan(nlane, B, 25, 520, 520)
    assert (plan["variant"], plan["lanes"], plan["warps"],
            plan["pairs_per_block"]) == ROWS_PLANS[(nlane, B)]
    assert plan["smem_bytes"] <= tpw.SMEM_MAX
    if plan["variant"] == "block":
        assert plan["smem_bytes"] == 4 * (25 * 25 + 5 * nlane + 32) + 1040
        assert plan["threads"] * plan["lanes"] >= nlane
        return
    assert 32 * plan["lanes"] * plan["warps"] * plan["ctas"] >= nlane
    if plan["variant"] != "cluster":
        assert plan["ctas"] == 1
    nwarps = plan["threads"] // 32
    assert nwarps == (plan["pairs_per_block"] if plan["variant"] == "warp"
                      else plan["warps"])
    assert plan["code_stride"] == 1040
    assert plan["smem_bytes"] == (
        4 * 25 * 26 + 52 * nwarps + plan["pairs_per_block"] * 1040
        + (4 * (40 + 48) if plan["variant"] == "cluster" else 0))


# (lanes, pairs) -> variant, lanes a thread, warps a CTA, CTAs a pair:
# past 8,192 lanes a cluster of a power of two CTAs up to 16 while the
# batch keeps within two CTAs an SM (the fewest that hold the band where
# that is more), at least 8 lanes a thread, the fewest warps that hold a
# CTA's slice; past one cluster (16 x 8,192 lanes) the block variant
CLUSTER_PLANS = {
    (8192, 1): ("warps", 16, 16, 1),
    (8193, 1): ("cluster", 8, 3, 16),
    (8193, 10): ("cluster", 8, 3, 16),
    (8193, 16): ("cluster", 8, 3, 16),     # 256 CTAs: within two an SM
    (8193, 17): ("cluster", 8, 5, 8),      # 272 would not be
    (8193, 132): ("cluster", 12, 11, 2),   # 4,097 lanes a CTA: 12 a thread
    (8193, 600): ("cluster", 12, 11, 2),
    (10800, 10): ("cluster", 8, 3, 16),    # the 9 kb family's batch
    (24043, 10): ("cluster", 8, 6, 16),    # the 20 kb family's
    (24043, 1): ("cluster", 8, 6, 16),
    (20000, 200): ("cluster", 16, 14, 3),  # the fewest CTAs that hold it
    (131071, 132): ("cluster", 16, 16, 16),
    (131072, 1): ("cluster", 16, 16, 16),  # the widest band of a cluster
    (131073, 1): ("block", 129, 0, 1),     # then the block variant
    (131073, 10): ("block", 129, 0, 1),
}


@pytest.mark.parametrize("nlane, B", list(CLUSTER_PLANS))
def test_rows_plan_cluster_rule(nlane, B):
    """K1f past one CTA's 8,192 lanes: the cluster variant up to one
    cluster's limit, the block variant (its row in device memory) past
    it, on 20 kb codes."""
    plan = tpw.rows_plan(nlane, B, 17, 20100, 20100)
    assert (plan["variant"], plan["lanes"], plan["warps"],
            plan["ctas"]) == CLUSTER_PLANS[(nlane, B)]
    assert plan["smem_bytes"] <= tpw.SMEM_MAX
    if plan["variant"] == "block":
        assert plan["state"] == "device"
        assert plan["threads"] * plan["lanes"] >= nlane
        return
    assert plan["state"] == "registers" and plan["pairs_per_block"] == 1
    held = 32 * plan["lanes"] * plan["warps"]        # lanes a CTA
    assert held * plan["ctas"] >= nlane
    if plan["variant"] == "cluster":
        assert 2 <= plan["ctas"] <= tpw.K1F_MAX_CTAS
        # a CTA holds what no fewer warps would
        assert 32 * plan["lanes"] * (plan["warps"] - 1) < -(
            -nlane // plan["ctas"])
    assert plan["threads"] == 32 * plan["warps"]
    assert plan["code_stride"] == 40208
    assert plan["smem_bytes"] == (4 * 17 * 18 + 52 * plan["warps"] + 40208
                                  + (4 * 88 if plan["variant"] == "cluster"
                                     else 0))


@pytest.mark.parametrize("kw", [
    {"ctas": 1},                                   # a cluster has 2+
    {"ctas": 17},
    {"ctas": 2, "lanes": 4, "warps": 1},           # 256 lanes < 300
    {"ctas": 2, "lanes": 2},                       # not built
    {"ctas": 2, "warps": 17},
    {"ctas": 2, "pairs": 2},
    {"ctas": 2, "state": "device"},
])
def test_rows_plan_cluster_refuses(kw):
    with pytest.raises(ValueError):
        tpw.rows_plan(300, 8, 25, 200, 200, variant="cluster", **kw)


def test_rows_plan_cluster_limits():
    """Asked for, the cluster variant takes any band it holds (a forced
    size of 2, 3 or 16 CTAs); CTAs are only for the cluster; a matrix
    past 240 letters or codes past shared memory leave the default on the
    block variant."""
    assert tpw.rows_cluster_lanes() == 131072 == 16 * tpw.rows_cta_lanes()
    for ctas, want in ((2, (8, 1)), (3, (8, 1)), (16, (8, 1))):
        plan = tpw.rows_plan(200, 1, 25, 200, 200, variant="cluster",
                             ctas=ctas)
        assert (plan["ctas"], plan["lanes"], plan["warps"]) == (ctas, *want)
    # 3 CTAs of 2,731 lanes: 8 lanes a thread, 11 warps
    plan = tpw.rows_plan(8193, 1, 25, 200, 200, variant="cluster", ctas=3)
    assert (plan["lanes"], plan["warps"]) == (8, 11)
    for variant in ("warp", "warps", "block"):
        with pytest.raises(ValueError):
            tpw.rows_plan(300, 8, 25, 200, 200, variant=variant, ctas=2)
    with pytest.raises(ValueError):
        tpw.rows_plan(9000, 1, 256, 200, 200, variant="cluster")
    assert tpw.rows_plan(9000, 1, 241, 200, 200)["variant"] == "block"
    # codes of 2 x 116,000 do not fit beside the matrix: block, device
    plan = tpw.rows_plan(9000, 1, 17, 116000, 116000)
    assert (plan["variant"], plan["state"]) == ("block", "device")
    with pytest.raises(ValueError):
        tpw.rows_plan(9000, 1, 17, 116000, 116000, variant="cluster")


@pytest.mark.parametrize("kw", [
    {"variant": "warp", "lanes": 8},               # 256 lanes < 300
    {"variant": "warp", "lanes": 6},               # not built
    {"variant": "warp", "warps": 2},
    {"variant": "warp", "lanes": 16, "pairs": 8},
    {"variant": "warps", "lanes": 2},              # not built for warps
    {"variant": "warps", "lanes": 4, "warps": 2},  # 256 lanes < 300
    {"variant": "warps", "lanes": 4, "warps": 17},
    {"variant": "warps", "lanes": 16, "pairs": 2},
    {"variant": "block", "lanes": 2},
    {"variant": "rows"},
])
def test_rows_plan_refuses(kw):
    with pytest.raises(ValueError):
        tpw.rows_plan(300, 8, 25, 200, 200, **kw)


def test_rows_plan_limits():
    # the matrix and its zero column in shared memory: 240 letters fit,
    # 241 fit no register variant; the block variant keeps its row and
    # the matrix in device memory instead
    assert tpw.rows_plan(200, 4, 240, 200, 200)["variant"] == "warps"
    for variant in ("warp", "warps"):
        with pytest.raises(ValueError):
            tpw.rows_plan(200, 4, 241, 200, 200, variant=variant)
    for variant in (None, "block"):
        plan = tpw.rows_plan(200, 4, 241, 200, 200, variant=variant)
        assert (plan["variant"], plan["state"], plan["smem_bytes"]) == (
            "block", "device", 128)
    # codes are bytes: no register variant past 255 letters
    with pytest.raises(ValueError):
        tpw.rows_plan(200, 4, 256, 20, 20, variant="warp")
    # a row past the block variant's shared memory: on a cluster up to
    # 131,072 lanes, past that the block variant in device memory
    plan = tpw.rows_plan(12000, 4, 25, 200, 200)
    assert (plan["variant"], plan["ctas"], plan["lanes"]) == (
        "cluster", 16, 8)
    plan = tpw.rows_plan(140000, 4, 25, 200, 200)
    assert (plan["variant"], plan["state"], plan["lanes"]) == (
        "block", "device", 137)
    assert plan["smem_bytes"] == 4 * (25 * 25 + 32)
    # fewer pairs a block where four pairs' codes do not fit
    plan = tpw.rows_plan(300, 600, 25, 40000, 40000)
    assert (plan["variant"], plan["pairs_per_block"]) == ("warp", 2)
    with pytest.raises(ValueError):
        tpw.rows_plan(0, 4, 25, 200, 200)


def test_band_range_reads_host_values_first():
    """``pairwise_scores`` takes the packing's range from host values
    where the caller gave them (no device read); on tensors it reads the
    packed ``lw`` and ``up`` once.  Both give the batch's bounds."""
    x = CASES["banded_protein"]["x"]
    lw_t, up_t = torch.as_tensor(x["lw"]), torch.as_tensor(x["up"])
    want = (int(x["lw"].min()), int(x["up"].max()))
    assert tpw._band_range(x["lw"], x["up"], x["la"], x["lb"], lw_t,
                           up_t) == want
    assert tpw._band_range(lw_t, up_t, None, None, lw_t, up_t) == want
    la, lb = torch.as_tensor(x["la"]), torch.as_tensor(x["lb"])
    assert tpw._band_range(None, None, x["la"], x["lb"], -la, lb) == (
        -int(x["la"].max()), int(x["lb"].max()))
    assert tpw._band_range(None, None, 30, 40, -la[:1], lb[:1]) == (-30, 40)


@pytest.mark.parametrize("nlane", [8193, 11000, 12000, 24043, 200000])
@pytest.mark.parametrize("codes", [200, 20000])
def test_rows_plan_device_row(nlane, codes):
    """Past 8,192 lanes the default is the cluster variant up to one
    cluster's 131,072 lanes, the block variant past it.  The block
    variant, asked for where the cluster takes the band: its row and
    codes in shared memory where they fit (the first design, unchanged),
    else in device memory, so ``PRRN_PW_FUSED=1`` refuses no band; a
    thread holds ceil(nlane / 1024) adjacent lanes."""
    default = tpw.rows_plan(nlane, 10, 17, codes, codes)["variant"]
    assert default == ("cluster" if nlane <= tpw.rows_cluster_lanes()
                       else "block")
    plan = tpw.rows_plan(nlane, 10, 17, codes, codes, variant="block")
    assert plan["variant"] == "block"
    shared = 4 * (17 * 17 + 5 * nlane + 32) + 2 * codes
    assert plan["state"] == ("shared" if shared <= tpw.SMEM_MAX
                             else "device")
    assert plan["smem_bytes"] == (shared if plan["state"] == "shared"
                                  else 4 * (17 * 17 + 32))
    assert plan["lanes"] == -(-nlane // 1024)
    assert plan["threads"] * plan["lanes"] >= nlane
    assert plan["threads"] <= 1024 and plan["threads"] % 32 == 0
    assert tpw.rows_state_bytes(nlane, codes, codes) % 16 == 0
    assert tpw.rows_state_bytes(nlane, codes, codes) >= 20 * nlane + 2 * codes


@pytest.mark.parametrize("dim", [17, 25, 255, 256])
def test_rows_plan_every_band(dim):
    """A plan for every band width with ``dim`` <= 256, with 200-residue
    and 20 kb codes, that holds the band."""
    widths = sorted({1, 1024, 1025, 8192, 8193, 11000, 24043, 131072,
                     131073, 200000, *np.unique(np.geomspace(1, 200000, 50)
                                                .astype(int)).tolist()})
    for codes in (200, 20000):
        for nlane in widths:
            for B in (1, 10, 512):
                plan = tpw.rows_plan(nlane, B, dim, codes, codes)
                assert plan["smem_bytes"] <= tpw.SMEM_MAX
                held = (plan["threads"] * plan["lanes"]
                        if plan["variant"] == "block"
                        else 32 * plan["lanes"] * plan["warps"]
                        * plan["ctas"])
                assert held >= nlane


@pytest.mark.parametrize("kw", [
    {"variant": "warps", "state": "device"},
    {"variant": "warp", "state": "shared"},
    {"variant": "block", "state": "cache"},
    {"variant": "block", "state": "shared", "lanes": 1},
])
def test_rows_plan_state_refuses(kw):
    with pytest.raises(ValueError):
        tpw.rows_plan(300, 8, 25, 200, 200, **kw)
    # a row that shared memory does not hold cannot be asked there
    with pytest.raises(ValueError):
        tpw.rows_plan(12000, 4, 25, 200, 200, variant="block",
                      state="shared")


# ---------------------------------------------------------------------
# The kernels' build: one header for the cluster-fit query (pure Python)

def test_library_name_hashes_the_headers(tmp_path, monkeypatch):
    """The library's name changes with a header the sources include, so
    an edited ``csrc/*.cuh`` is rebuilt, and the package ships the
    headers; K1, K1f and K2 include the one cluster-fit query and define
    none of their own."""
    root = Path(_build._CSRC)
    for name in ("pairwise.cu", "pairwise_rows.cu", "group_wavefront.cu"):
        text = (root / name).read_text()
        assert '#include "cluster_fits.cuh"' in text
        assert "prrn_kernels::cluster_fits(" in text
        assert "cudaError_t cluster_fits(" not in text
    includes = {inc for src in _build._sources()
                for inc in re.findall(r'#include "([^"]+)"', src.read_text())}
    assert includes and includes <= {h.name for h in _build._headers()}
    pyproject = (root.parent.parent / "pyproject.toml").read_text()
    assert '"csrc/*.cuh"' in pyproject
    csrc = tmp_path / "csrc"
    shutil.copytree(root, csrc)
    monkeypatch.setattr(_build, "_CSRC", csrc)
    before = _build.library_path()
    assert _build.library_path() == before
    header = csrc / "cluster_fits.cuh"
    header.write_text(header.read_text() + "// edited\n")
    assert _build.library_path() != before
