"""The port's CUDA kernels against their plain PyTorch versions on the
card.  They need a CUDA device and skip without one; this file imports
no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from prrn_aln_tpu_torch import alphabet as ab, io as tio, scoring
from prrn_aln_tpu_torch.config import AlnParams
from prrn_aln_tpu_torch.msa.msa import Msa
from prrn_aln_tpu_torch.ops import group as tg, pairwise as tpw
from prrn_aln_tpu_torch.ops import spliced_h as tsh
from prrn_aln_tpu_torch.ops.window import stripe
from prrn_aln_tpu_torch.splice.hapi import spliced_align_h

MTX, _ = scoring.protein_matrix(AlnParams(pam=150))
FIX = Path(__file__).parent / "fixtures"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("local", [False, True])
def test_pairwise_kernel_matches_plain(cuda_device, local):
    rng = np.random.default_rng(3)
    B, M = 32, 200
    la = rng.integers(40, M, B).astype(np.int32)
    lb = rng.integers(40, M, B).astype(np.int32)
    A = np.zeros((B, M), np.int32)
    Bm = np.zeros((B, M), np.int32)
    for i in range(B):
        A[i, :la[i]] = rng.integers(3, 23, la[i])
        Bm[i, :lb[i]] = rng.integers(3, 23, lb[i])
    wd = [stripe(int(x), int(y), -60) for x, y in zip(la, lb)]
    arrs = dict(A=A, B=Bm, la=la, lb=lb,
                lw=np.array([w.lw for w in wd], np.int32),
                up=np.array([w.up for w in wd], np.int32),
                u=np.full(B, 2.0, np.float32), v=np.full(B, 9.0, np.float32),
                tg=np.where(rng.random(B) < 0.5, 1.0, 0.5).astype(np.float32),
                exg=rng.random((B, 4)) < 0.3)
    t = {k: torch.as_tensor(x, device=cuda_device) for k, x in arrs.items()}
    mtx = torch.as_tensor(MTX, device=cuda_device)
    got = tpw.pairwise_scores(t["A"], t["B"], t["la"], t["lb"], mtx, t["u"],
                              t["v"], t["tg"], t["exg"], t["lw"], t["up"],
                              local=local)
    ref = tpw.wavefront_scores_ref(
        t["A"], t["B"], t["la"], t["lb"], t["lw"], t["up"], mtx, t["u"],
        t["v"], t["tg"], t["exg"],
        nslot=int((arrs["up"] - arrs["lw"]).max()) + 3,
        nsteps=int((la + lb).max()) - 1, local=local)
    assert torch.equal(got, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("lo, hi, n", [(40, 200, 32), (1400, 1600, 4)])
def test_pairwise_rows_kernel_matches_plain(cuda_device, lo, hi, n):
    """K1f against ``row_scores_ref``, bit for bit: a lane a thread, and
    bands past 1,024 lanes (two lanes a thread)."""
    rng = np.random.default_rng(5)
    la = rng.integers(lo, hi, n).astype(np.int32)
    lb = rng.integers(lo, hi, n).astype(np.int32)
    A = np.zeros((n, hi), np.int32)
    Bm = np.zeros((n, hi), np.int32)
    for i in range(n):
        A[i, :la[i]] = rng.integers(3, 23, la[i])
        Bm[i, :lb[i]] = rng.integers(3, 23, lb[i])
    wd = [stripe(int(x), int(y), -60) for x, y in zip(la, lb)]
    arrs = [A, Bm, la, lb, np.array([w.lw for w in wd], np.int32),
            np.array([w.up for w in wd], np.int32), MTX.astype(np.float32),
            np.full(n, 2.0, np.float32), np.full(n, 9.0, np.float32),
            np.where(rng.random(n) < 0.5, 1.0, 0.5).astype(np.float32),
            rng.random((n, 4)) < 0.3]
    args = [torch.as_tensor(x, device=cuda_device) for x in arrs]
    lw0 = int(arrs[4].min())
    got = tpw._launch_rows(*args, lw0)
    ref = tpw._plain_rows(*args, lw0)
    assert torch.equal(got, ref)
    assert tpw._build.LAUNCHES["pairwise_rows"] >= 1


def _rand_msa(rng, many, L):
    codes = (rng.integers(0, 20, size=(many, L)) + ab.ALA).astype(np.int8)
    codes[rng.random((many, L)) < 0.08] = ab.GAP
    codes[:, 0] = ab.ALA + rng.integers(0, 20)
    m = Msa(codes=codes, molc=ab.PROTEIN,
            names=[f"s{i}" for i in range(many)],
            weight=rng.random(many) + 0.5)
    m.prepare(MTX.shape[0])
    return m


@pytest.mark.gpu
@pytest.mark.parametrize("ls3", [False, True])
def test_group_kernels_match_plain(cuda_device, ls3):
    rng = np.random.default_rng(31)
    pairs = [(_rand_msa(rng, 5, 120), _rand_msa(rng, 4, 130))
             for _ in range(4)]
    wd = [stripe(A.length, B.length, -60) for A, B in pairs]
    items = [tg._pack_inputs(A, B, MTX, 2.0, 9.0, w, 5, 5, 192, 192,
                             ls=3 if ls3 else 1)
             for (A, B), w in zip(pairs, wd)]
    ins = tg.stack_inputs(items, cuda_device)
    kw = dict(nslot=256, nsteps=512, ls3=ls3)
    sk, dk, ok = tg.group_wavefront(ins, **kw)
    sr, dr, orf = tg.group_wavefront_ref(ins, **kw)
    assert torch.equal(dk, dr) and torch.equal(ok, orf)
    assert torch.equal(sk, sr)
    tb = (dk, ok, ins["la"], ins["lb"], ins["lw"])
    mk, ck = tg.traceback(*tb, max_iters=772)
    mr, cr = tg.traceback_ref(*tb, max_iters=772)
    assert torch.equal(mk, mr) and torch.equal(ck, cr)


@pytest.mark.gpu
def test_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    a = torch.zeros((2, 8), dtype=torch.int64, device=cuda_device)
    mtx = torch.as_tensor(MTX, device=cuda_device)
    with pytest.raises(ValueError, match="dtype"):
        tpw.pairwise_scores(a, a, 8, 8, mtx, 2.0, 9.0)


def _spliced_calls(genome, protein, device):
    """Gene prediction on the card with recorders at K4's and K4w's
    launch points; returns each kernel's (arguments, output)."""
    calls = {}
    real_s, real_w = tsh._launch_sweep, tsh._launch_walk

    def rec_s(ins):
        calls["sweep"] = (ins, real_s(ins))
        return calls["sweep"][1]

    def rec_w(*args):
        calls["walk"] = (args, real_w(*args))
        return calls["walk"][1]

    tsh._launch_sweep, tsh._launch_walk = rec_s, rec_w
    try:
        spliced_align_h(genome, protein, device=device)
    finally:
        tsh._launch_sweep, tsh._launch_walk = real_s, real_w
    return calls


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["mini", "random"])
def test_spliced_kernels_match_plain(cuda_device, case):
    """K4's planes and final band, and K4w's knots, against the plain
    versions on the same inputs on the card."""
    if case == "mini":
        g = tio.sniff_and_read(FIX / "mini_gen.fa")[0].seq
        p = tio.sniff_and_read(FIX / "mini_pro.fa")[0].seq
    else:
        rng = np.random.default_rng(11)
        g = "".join(np.array(list("ACGT"))[rng.integers(0, 4, 600)])
        p = "".join(np.array(list("ACDEFGHIKLMNPQRSTVWY"))[
            rng.integers(0, 20, 120)])
    calls = _spliced_calls(g, p, cuda_device)
    ins, sw = calls["sweep"]
    ref = tsh.sweep_h_ref(ins)
    for field in tsh.Sweep._fields:
        assert torch.equal(getattr(sw, field), getattr(ref, field)), field
    wargs, wk = calls["walk"]
    assert tsh.walk_h_ref(*wargs) == wk
