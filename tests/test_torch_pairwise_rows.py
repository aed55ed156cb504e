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
