"""The port's CUDA kernels against their plain PyTorch versions on the
card.  They need a CUDA device and skip without one; this file imports
no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py
"""

import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from prrn_aln_tpu_torch import alphabet as ab, io as tio, scoring
from prrn_aln_tpu_torch.config import AlnParams, default_params
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
    nlane = int(arrs[5].max()) - lw0 + 1
    got = tpw._launch_rows(*args, lw0, nlane)
    ref = tpw._plain_rows(*args, lw0, nlane)
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
    sk, dk, ok, _ = tg.group_wavefront(ins, **kw)
    sr, dr, orf, _ = tg.group_wavefront_ref(ins, **kw)
    assert torch.equal(dk, dr) and torch.equal(ok, orf)
    assert torch.equal(sk, sr)
    tb = (dk, ok, ins["la"], ins["lb"], ins["lw"])
    mk, ck = tg.traceback(*tb, max_iters=772)
    mr, cr = tg.traceback_ref(*tb, max_iters=772)
    assert torch.equal(mk, mr) and torch.equal(ck, cr)


def _k2_case(case):
    """Packed K2 inputs of one of the shapes the redesign must hold:
    mixed real member counts padded to 7 and to 19, a gap-free side that
    collapses to one member, ls3, and members enough for the global
    variant (57 + 2 at nslot 640: the runs alone take 227,256 bytes)."""
    rng = np.random.default_rng(37)
    ls3 = case == "ls3"
    counts, pad, L = {
        "mixed7": ([(1, 7), (7, 1), (3, 4), (2, 2), (6, 5)], 7, 120),
        "mixed19": ([(1, 18), (9, 10), (18, 1)], 19, 150),
        "collapse": ([(4, 3), (5, 2)], 7, 130),
        "ls3": ([(1, 6), (4, 3), (5, 5)], 7, 120),
        "global": ([(57, 2), (30, 1)], 57, 300)}[case]
    pairs = []
    for a, b in counts:
        A = _rand_msa(rng, a, L + int(rng.integers(0, 20)))
        B = _rand_msa(rng, b, L + int(rng.integers(0, 20)))
        if case == "collapse":      # a gap-free, weighted A side
            A.codes[A.codes == ab.GAP] = ab.ALA
            A.prepare(MTX.shape[0])
        pairs.append((A, B))
    la_max = lb_max = tg._bucket(max(max(A.length, B.length)
                                     for A, B in pairs))
    sh = -300 if case == "global" else -60
    wd = [stripe(A.length, B.length, sh) for A, B in pairs]
    nslot = tg._bucket(max(w.up - w.lw + 3 for w in wd), 128)
    nsteps = tg._bucket(max(A.length + B.length + 1 for A, B in pairs), 256)
    items = [tg._pack_inputs(A, B, MTX, 2.0, 9.0, w, pad, pad, la_max,
                             lb_max, spb=20.0, ls=3 if ls3 else 1)
             for (A, B), w in zip(pairs, wd)]
    return items, dict(nslot=nslot, nsteps=nsteps, ls3=ls3)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["mixed7", "mixed19", "collapse", "ls3",
                                  "global"])
def test_group_wavefront_bit_equal_per_shape(cuda_device, case):
    """K2 against ``group_wavefront_ref``, bit for bit on the planes and
    the scores, and the variant the wrapper picks by size."""
    items, kw = _k2_case(case)
    ins = tg.stack_inputs(items, cuda_device)
    plan = tg.wavefront_plan(ins, nslot=kw["nslot"], ls3=kw["ls3"])
    assert plan["variant"] == ("global" if case == "global" else "shared")
    if case == "collapse":
        assert plan["an_b"].tolist() == [1, 1]
    sk, dk, ok, _ = tg.group_wavefront(ins, **kw)
    sr, dr, orf, _ = tg.group_wavefront_ref(ins, **kw)
    assert torch.equal(dk, dr) and torch.equal(ok, orf)
    assert torch.equal(sk.view(torch.int32), sr.view(torch.int32))


def _same(a, b):
    """Two outputs of K2 (score, dirs, opens, carry) bit for bit."""
    return (torch.equal(a[0].view(torch.int32), b[0].view(torch.int32))
            and torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])
            and tg.carry_equal(a[3], b[3]))


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["shared", "global", "wide"])
@pytest.mark.parametrize("ls3", [False, True])
def test_group_wavefront_carries_match_plain(cuda_device, variant, ls3):
    """Each variant of K2 resumed from a carry: three chunks (the second
    at an odd step), each from the kernel's own carry, against the plain
    version from the same carry: planes, score and the stored carry."""
    items, kw = _k2_case("ls3" if ls3 else "mixed7")
    ins = tg.stack_inputs(items, cuda_device)
    kw = dict(nslot=kw["nslot"], ls3=ls3)
    carry = None
    for d0, n in ((0, 64), (64, 37), (101, 160)):
        got = tg.group_wavefront(ins, nsteps=n, d0=d0, carry=carry,
                                 variant=variant, **kw)
        ref = tg.group_wavefront_ref(ins, nsteps=n, d0=d0, carry=carry, **kw)
        assert _same(got, ref), (variant, d0)
        carry = got[3]
    whole = tg.group_wavefront(ins, nsteps=261, variant=variant, **kw)
    assert tg.carry_equal(whole[3], carry)


def _dna_pair(L, seed=0):
    """A random DNA sequence of L nt and a mutant (3 % substitutions, two
    short indels), as packed K2 inputs at the default window."""
    mtx, _ = scoring.build_matrix(ab.DNA, default_params(ab.DNA, "prrn"))
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 4, L)
    mut = list(base)
    for _ in range(2):
        p = int(rng.integers(200, len(mut) - 200))
        if rng.random() < 0.5:
            del mut[p:p + int(rng.integers(1, 4))]
        else:
            mut[p:p] = list(rng.integers(0, 4, int(rng.integers(1, 4))))
    mut = np.array(mut)
    hit = rng.random(len(mut)) < 0.03
    mut[hit] = rng.integers(0, 4, int(hit.sum()))

    def msa(arr):
        m = Msa(codes=ab.encode("".join("ACGT"[c] for c in arr),
                                ab.DNA)[None, :], molc=ab.DNA, names=["g"])
        m.prepare(mtx.shape[0])
        return m
    return msa(base), msa(mut), mtx


@pytest.mark.gpu
def test_group_wavefront_wide_band(cuda_device):
    """The wide variant on a band past shared memory (5.3 kb a side at
    the default window: 6,400 slots), the first chunk and a later one at
    an odd step, against the plain version from the same carry."""
    A, B, mtx = _dna_pair(5300)
    w = stripe(A.length, B.length, -60)
    nslot = tg._bucket(w.up - w.lw + 3, 128)
    assert nslot >= 6400
    ins = tg.stack_inputs([tg._pack_inputs(
        A, B, mtx, 2.0, 9.0, w, 1, 1, tg._bucket(A.length),
        tg._bucket(B.length), uniform=False)], cuda_device)
    assert tg.wavefront_plan(ins, nslot=nslot)["variant"] == "wide"
    first = tg.group_wavefront(ins, nslot=nslot, nsteps=128)
    assert _same(first, tg.group_wavefront_ref(ins, nslot=nslot, nsteps=128))
    _, _, _, carry = tg.group_wavefront(ins, nslot=nslot, nsteps=5001)
    later = tg.group_wavefront(ins, nslot=nslot, nsteps=128, d0=5001,
                               carry=carry)
    assert _same(later, tg.group_wavefront_ref(ins, nslot=nslot, nsteps=128,
                                               d0=5001, carry=carry))


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["staged", "global"])
def test_traceback_range_matches_plain(cuda_device, variant):
    """K3's range walk on K2's planes of a chunk, from starts on the
    chunk's top rows, in each lane, and from above the chunk, against
    ``traceback_range_ref``."""
    items, kw = _k2_case("mixed7")
    ins = tg.stack_inputs(items, cuda_device)
    nslot = kw["nslot"]
    _, _, _, carry = tg.group_wavefront(ins, nslot=nslot, nsteps=101)
    _, dirs, opens, _ = tg.group_wavefront(ins, nslot=nslot, nsteps=64,
                                           d0=101, carry=carry)
    rng = np.random.default_rng(53)
    Bn = dirs.shape[0]
    plan = tg.traceback_plan(64, nslot, 136, variant=variant)
    for top in (164, 150, 175):
        m0 = rng.integers(top // 3, 2 * top // 3, Bn)
        args = [torch.as_tensor(x.astype(np.int32), device=cuda_device)
                for x in (m0, top - m0, rng.integers(0, 5, Bn),
                          np.full(Bn, 101))]
        got = tg.traceback_range(dirs, opens, *args, ins["lw"],
                                 max_iters=136, plan=plan)
        ref = tg.traceback_range_ref(dirs, opens, *args, ins["lw"],
                                     max_iters=136)
        for g, r in zip(got, ref):
            assert torch.equal(g, r), (variant, top)


@pytest.mark.gpu
def test_linear_equals_standard_on_card(cuda_device):
    """group_align_linear (chunks of 64 steps, five of them) equals
    group_align on the card: score bits and SKL."""
    rng = np.random.default_rng(59)
    A, B = _rand_msa(rng, 3, 140), _rand_msa(rng, 3, 150)
    s0, k0 = tg.group_align(A, B, MTX, 2.0, 9.0, device=cuda_device)
    n0 = tg._build.LAUNCHES["traceback_range"]
    s1, k1 = tg.group_align_linear(A, B, MTX, 2.0, 9.0, chunk=64,
                                   device=cuda_device)
    assert tg._build.LAUNCHES["traceback_range"] - n0 >= 3
    assert k1 == k0
    assert np.float32(s1).view(np.int32) == np.float32(s0).view(np.int32)


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


def _rich_pair(seed, L, P, share):
    """A random genome of L nt in which a ``share`` of the draws are
    splice-like motifs (GT, AG, GTAAGT, TTTCAG), and a random protein of
    P residues (as tools/k4_bench.py draws them)."""
    rng = np.random.default_rng(seed)
    parts, size = [], 0
    while size < L:
        if rng.random() < share:
            part = ("GT", "AG", "GTAAGT", "TTTCAG")[rng.integers(0, 4)]
        else:
            part = "ACGT"[rng.integers(0, 4)]
        parts.append(part)
        size += len(part)
    prot = "".join(np.array(list("ACDEFGHIKLMNPQRSTVWY"))[
        rng.integers(0, 20, P)])
    return "".join(parts)[:L], prot


# K4's cases, each with the plan (variant, CTAs, clusters) the wrapper
# picks or, for the names ending in _one_cta, _global and _chained, the
# plan the test asks for (the chained ones: every CTA has rows)
_K4_CASES = {
    "mini": ("cluster", 6, 1),
    "random": ("cluster", 4, 1),
    "random_one_cta": ("cluster", 1, 1),
    "random_global": ("global", 1, 1),
    "random_chained": ("chained", 1, 2),
    "rich": ("cluster", 5, 1),
    "rich_chained": ("chained", 1, 3),
    "rows527": ("cluster", 6, 1),
    "rows527_chained": ("chained", 2, 3),
    "rows1100": ("cluster", 7, 1),
    "long_introns": ("cluster", 6, 1),
    "long_introns_global": ("global", 1, 1),
    "long_introns_chained": ("chained", 3, 2),
}


_K4_PLAIN = {}


def _k4_pair(case):
    if case == "mini":
        return (tio.sniff_and_read(FIX / "mini_gen.fa")[0].seq,
                tio.sniff_and_read(FIX / "mini_pro.fa")[0].seq)
    if case.startswith("random"):
        rng = np.random.default_rng(11)
        g = "".join(np.array(list("ACGT"))[rng.integers(0, 4, 600)])
        p = "".join(np.array(list("ACDEFGHIKLMNPQRSTVWY"))[
            rng.integers(0, 20, 120)])
        return g, p
    if case == "rich":
        return _rich_pair(5, 900, 150, 0.3)
    if case.startswith("long"):
        sys.path.insert(0, str(FIX.parent.parent))
        from chip_smoke import long_intron_gene
        return long_intron_gene()
    if case == "rows527":
        return _rich_pair(7, 1650, 526, 0.1)
    return _rich_pair(3, 3360, 1100, 0.1)


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(_K4_CASES))
def test_spliced_kernels_match_plain(cuda_device, case):
    """K4's planes and final band, and K4w's knots, against the plain
    versions on the same inputs on the card, for each of K4's launch
    plans: the cluster variant at 173 rows (mini, 6 CTAs of 32 rows),
    121 rows (4 CTAs, and one CTA when asked), 151 rows of a genome rich
    in GT and AG, so that the donor candidate lists fill and evict
    (5 CTAs), 527 rows (6 CTAs of 96) and 1,101 rows (7 CTAs of 160); and
    the global variant, asked for at 121 rows; the chained variant, asked
    for as 2 clusters of one CTA at 121 rows, 3 of one at 151, 3 of 2 at
    527 and 2 of 3 on the long-intron gene.  Each case's time is
    mostly the plain sweep's, about 12 ms a wave on one H100 (PERF.md
    §6): some 12 s for the 957 waves of the random cases (the plain sweep
    runs once for the four), 17 s for mini's 1,414, 16 s for rich's
    1,347, 38 s for the 3,225 waves at 527 rows and 75 s for the 6,657 at
    1,101.  The long-intron gene (introns of 879 and 1,187 nt, 181 rows,
    3,743 waves) holds the three variants to the plain version where the
    intron penalty comes from its table by length."""
    base = case.split("_")[0]
    calls = _spliced_calls(*_k4_pair(base), cuda_device)
    ins, sw = calls["sweep"]
    MR, npen = ins.M + 1, ins.rlmt - ins.llmt + 1
    variant, ctas, clusters = _K4_CASES[case]
    if case.endswith(("_one_cta", "_global", "_chained")):
        kw = {"clusters": clusters} if variant == "chained" else {}
        plan = tsh.sweep_plan(MR, npen, variant=variant, ctas=ctas, **kw)
        sw = tsh._launch_sweep(ins, plan)
    else:
        plan = tsh.sweep_plan(MR, npen)
    assert (plan["variant"], plan["ctas"], plan["clusters"]) == \
        (variant, ctas, clusters)
    if variant == "chained":       # every CTA has rows
        assert (plan["clusters"] * plan["ctas"] - 1) * plan["rows"] < MR
    if base not in _K4_PLAIN:     # the same inputs: one plain sweep a base
        _K4_PLAIN[base] = tsh.sweep_h_ref(ins)
    ref = _K4_PLAIN[base]
    for field in tsh.Sweep._fields:
        assert torch.equal(getattr(sw, field), getattr(ref, field)), field
    wargs, wk = calls["walk"]
    assert tsh.walk_h_ref(*wargs) == wk


def _long_protein():
    return tuple(tio.sniff_and_read(FIX / f"long_protein_{k}.fa")[0].seq
                 for k in ("gen", "pro"))


@pytest.mark.gpu
def test_spliced_k4_chained_default_plan(cuda_device):
    """Past 2,048 rows K4's wrapper picks the chained variant: on lp2100
    (``tests/fixtures/long_protein_*.fa``, 2,101 rows, ~14,800 waves) its
    planes and final band equal the global variant's on the card bit for
    bit, and K4w's knots the plain walk's.  The plain sweep would take
    some 3 minutes here; the chained variant is held to it under forced
    plans in test_spliced_kernels_match_plain."""
    from prrn_aln_tpu_torch.ops import _build
    _build.LAUNCHES.clear()
    calls = _spliced_calls(*_long_protein(), cuda_device)
    assert _build.LAUNCHES["spliced_h_wave"] == 1
    ins, sw = calls["sweep"]
    MR, npen = ins.M + 1, ins.rlmt - ins.llmt + 1
    plan = tsh.launch_plan(MR, npen)
    assert MR == 2101 and plan["variant"] == "chained"
    assert plan == tsh.sweep_plan(MR, npen)
    glob = tsh._launch_sweep(ins, tsh.sweep_plan(MR, npen, variant="global"))
    for field in tsh.Sweep._fields:
        assert torch.equal(getattr(sw, field), getattr(glob, field)), field
    del glob
    wargs, wk = calls["walk"]
    assert tsh.walk_h_ref(*wargs) == wk


# a copy of K4's source whose column writer never releases its counter,
# with the reader's stall budget cut to 2**31 cycles (~1 s): a chained
# launch must then fail with a CUDA error, not hang
_K4_STALL = (("if (writer) st_release(cnt_out, t);", ""),
             ("if (writer) st_release(cnt_out, kDone);", ""),
             ("constexpr long long kStall = 1LL << 35;",
              "constexpr long long kStall = 1LL << 31;"))
_K4_STALL_RUN = """
import ctypes, sys, time, torch
sys.path.insert(0, sys.argv[2])
from prrn_aln_tpu_torch.ops import _build, spliced_h as tsh
from prrn_aln_tpu_torch.splice.hapi import spliced_align_h
lib = ctypes.CDLL(sys.argv[1])
for name, argtypes in _build._SIGNATURES.items():
    if name.startswith("spliced_h_wave"):
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
_build._lib = lib
tsh.launch_plan = lambda MR, npen: tsh.sweep_plan(
    MR, npen, variant="chained", clusters=2, ctas=1)
rng = __import__("numpy").random.default_rng(11)
g = "".join("ACGT"[k] for k in rng.integers(0, 4, 600))
p = "".join("ACDEFGHIKLMNPQRSTVWY"[k] for k in rng.integers(0, 20, 120))
t0 = time.perf_counter()
try:
    spliced_align_h(g, p, device="cuda")
    torch.cuda.synchronize()
except Exception as e:
    print(f"FAILED after {time.perf_counter() - t0:.2f} s: {e}")
    sys.exit(3)
print("RAN")
"""


@pytest.mark.gpu
def test_spliced_k4_chained_stall_traps(cuda_device, tmp_path):
    """A chained launch whose writer never comes fails fast with a CUDA
    error instead of hanging: a copy of the source without the counter's
    releases and with a 2**31-cycle stall budget, built apart and run in
    a process of its own (a trap ends its CUDA context)."""
    from prrn_aln_tpu_torch.ops import _build
    import subprocess
    src = (_build._CSRC / "spliced_h_wave.cu").read_text()
    for old, new in _K4_STALL:
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    (tmp_path / "stall.cu").write_text(src)
    lib = tmp_path / "libstall.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                    str(lib), str(tmp_path / "stall.cu")], check=True,
                   capture_output=True, timeout=600)
    run = subprocess.run([sys.executable, "-c", _K4_STALL_RUN, str(lib),
                          str(FIX.parent.parent)], capture_output=True,
                         text=True, timeout=300)
    assert run.returncode == 3, (run.stdout, run.stderr[-2000:])
    secs = float(run.stdout.split("FAILED after ")[1].split(" s")[0])
    assert "CUDA error" in run.stdout and secs < 60, run.stdout


def _k3_planes(seed, B, nsteps, nslot, device, offset=0, pdiag=0.7,
               popen=0.2):
    """Random direction planes: DIAG with probability ``pdiag``, else a
    gap or lane code; open bits with probability ``popen`` each, so gap
    runs last a few steps.  ``offset`` bytes ahead of the planes in their
    allocation leave them unaligned."""
    rng = np.random.default_rng(seed)
    dirs = np.where(rng.random((B, nsteps, nslot)) < pdiag, 0,
                    rng.integers(-1, 5, (B, nsteps, nslot))).astype(np.int8)
    bits = (rng.random((B, nsteps, nslot, 4)) < popen).astype(np.int8)
    opens = (bits * np.array([1, 2, 4, 8], np.int8)).sum(-1).astype(np.int8)
    out = []
    for x in (dirs, opens):
        flat = torch.empty(x.size + offset, dtype=torch.int8, device=device)
        t = flat[offset:].view(B, nsteps, nslot)
        t.copy_(torch.as_tensor(x))
        out.append(t)
    return out


def _visited(moves, cnt, La, Lb):
    """The (m, n) cells of a walk from (La, Lb), from its moves."""
    m, n, cells = La, Lb, [(La, Lb)]
    for mv in moves[:cnt]:
        m -= mv in (0, 1)
        n -= mv in (0, 2)
        cells.append((m, n))
    return cells


# K3's cases: B, nsteps, nslot, max_iters (None: the main path's 2 (La +
# Lb) + 4 of the largest), the planes' offset from an aligned address, the
# plan asked for, and the variant and tile rows the plan must give
_K3_CASES = {
    "staged_640": (1, 1280, 640, None, 0, {}, ("staged", 51)),
    "tiles_16": (1, 1280, 640, None, 0, {"tile_rows": 16}, ("staged", 16)),
    "unaligned_640": (1, 1280, 640, None, 3, {}, ("staged", 51)),
    "odd_nslot": (3, 301, 100, None, 3, {"tile_rows": 9}, ("staged", 9)),
    "short_walk": (2, 1024, 128, None, 0, {}, ("staged", 256)),
    "wrap_clamp": (2, 200, 40, 60, 0, {"tile_rows": 8}, ("staged", 8)),
    "b1_one_tile": (1, 256, 128, None, 0, {}, ("staged", 255)),
    "b32": (32, 768, 384, None, 0, {}, ("staged", 85)),
    "b32_global": (32, 768, 384, None, 0, {"variant": "global"},
                   ("global", 0)),
    "rows1": (2, 120, 48, None, 5, {"tile_rows": 1}, ("staged", 1)),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(_K3_CASES))
def test_traceback_kernel_matches_plain(cuda_device, case):
    """K3 against ``traceback_ref``, moves and counts bit for bit, in the
    plan each case asks for: walks over many tiles whose gap runs cross a
    tile edge, planes 3 bytes past an aligned address (every pair's
    offset unaligned, the first and last tiles clipped) with nslot 640
    and 100, walks from La + Lb far below nsteps - 1, walks past the slot
    wrap and clamp whose count passes max_iters, one pair in one tile, 32
    pairs in each variant, and tiles of one row."""
    B, nsteps, nslot, mi, offset, ask, want = _K3_CASES[case]
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    args = _k3_planes(int(rng.integers(1 << 30)), B, nsteps, nslot,
                      cuda_device, offset)
    if case == "short_walk":
        La = rng.integers(40, 60, B)
        Lb = rng.integers(40, 60, B)
    else:
        La = rng.integers((nsteps - 1) // 3, (nsteps - 1) // 2, B)
        Lb = nsteps - 1 - La - rng.integers(0, 3, B)
    wrap = case == "wrap_clamp"
    lw = -La
    if wrap:    # the first slot at -5 (wrapped) and at nslot + 3 (clamped)
        lw = Lb - La + 1 + np.array([5, -nslot - 3])
    lw = lw.astype(np.int32)
    mi = mi or 2 * int((La + Lb).max()) + 4
    plan = tg.traceback_plan(nsteps, nslot, mi, **ask)
    assert (plan["variant"], plan["tile_rows"]) == want
    if offset:
        assert args[0].data_ptr() % 16 != 0
    args += [torch.as_tensor(x.astype(np.int32), device=cuda_device)
             for x in (La, Lb, lw)]
    mk, ck = tg.traceback(*args, max_iters=mi, plan=plan)
    mr, cr = tg.traceback_ref(*args, max_iters=mi)
    assert torch.equal(mk, mr) and torch.equal(ck, cr)
    moves, cnts = mr.cpu().numpy(), cr.cpu().numpy()
    if case in ("staged_640", "tiles_16"):
        # a gap run crosses a tile edge: rows top - j * T .. stay in tile j
        T = plan["tile_rows"]
        top = min(int(La[0] + Lb[0]), nsteps - 1)
        tile = [(top - m - n) // T if m + n >= 1 else -1
                for m, n in _visited(moves[0], cnts[0], int(La[0]),
                                     int(Lb[0]))]
        gaps = [k for k in range(1, cnts[0])
                if moves[0, k] == moves[0, k - 1] and moves[0, k] in (1, 2)
                and tile[k] != tile[k + 1]]
        assert len(gaps) > 0 and len(set(tile)) > 10
    if wrap:
        slots = [int(1 - lw[b] + n - m) for b in range(B)
                 for m, n in _visited(moves[b], min(cnts[b], mi - 1),
                                      int(La[b]), int(Lb[b]))
                 if 0 < m + n < nsteps]
        assert min(slots) < 0 and max(slots) >= nslot and max(cnts) == mi
    if case == "short_walk":
        assert int((La + Lb).max()) < nsteps // 8


@pytest.mark.gpu
def test_traceback_kernel_on_k2_planes(cuda_device):
    """K3 on planes K2 made on the card, one pair and 32 pairs, in both
    variants, against ``traceback_ref``."""
    rng = np.random.default_rng(47)
    pairs = [(_rand_msa(rng, 4, 150 + int(rng.integers(0, 60))),
              _rand_msa(rng, 3, 140 + int(rng.integers(0, 60))))
             for _ in range(32)]
    wd = [stripe(A.length, B.length, -60) for A, B in pairs]
    items = [tg._pack_inputs(A, B, MTX, 2.0, 9.0, w, 4, 4, 256, 256)
             for (A, B), w in zip(pairs, wd)]
    for sel in (slice(0, 1), slice(0, 32)):
        ins = tg.stack_inputs(items[sel], cuda_device)
        _, dirs, opens, _ = tg.group_wavefront(ins, nslot=384, nsteps=512)
        tb = (dirs, opens, ins["la"], ins["lb"], ins["lw"])
        mr, cr = tg.traceback_ref(*tb, max_iters=1028)
        for variant in ("staged", "global"):
            plan = tg.traceback_plan(512, 384, 1028, variant=variant)
            mk, ck = tg.traceback(*tb, max_iters=1028, plan=plan)
            assert torch.equal(mk, mr) and torch.equal(ck, cr), variant


def _k1_batch(seed, lens, sh, dna=False, exg=None, tg_half=True):
    """K1's launch arguments for pairs of the given (la, lb) lengths at
    shoulder ``sh``, with random codes and gap settings from ``seed``."""
    rng = np.random.default_rng(seed)
    mtx = scoring.dna_matrix(AlnParams())[0] if dna else MTX
    dim = mtx.shape[0]
    la = np.array([a for a, _ in lens], np.int32)
    lb = np.array([b for _, b in lens], np.int32)
    B = len(lens)
    A = np.zeros((B, int(la.max()) + 5), np.int32)
    Bm = np.zeros((B, int(lb.max())), np.int32)
    for i in range(B):
        A[i, :la[i]] = rng.integers(0, dim, la[i])
        Bm[i, :lb[i]] = rng.integers(0, dim, lb[i])
        k = min(la[i], lb[i]) // 2       # a shared stretch: the path bends
        Bm[i, :k] = A[i, :k]
    wd = [stripe(int(x), int(y), sh) for x, y in zip(la, lb)]
    if exg is None:
        exg = rng.random((B, 4)) < 0.3
    tg_ = (np.where(rng.random(B) < 0.5, 1.0, 0.5) if tg_half
           else np.ones(B)).astype(np.float32)
    arrs = [A, Bm, la, lb, np.array([w.lw for w in wd], np.int32),
            np.array([w.up for w in wd], np.int32), mtx.astype(np.float32),
            np.full(B, 2.0, np.float32), np.full(B, 9.0, np.float32), tg_,
            np.broadcast_to(exg, (B, 4)).copy()]
    return arrs


def _rand_lens(seed, n, lo, hi):
    rng = np.random.default_rng(seed)
    return [tuple(int(x) for x in rng.integers(lo, hi, 2)) for _ in range(n)]


# K1's cases: the batch (lengths, shoulder, DNA, free end gaps), local,
# the plan asked for, and the variant, lanes and warps it must give
_K1_CASES = {
    "warp": (_rand_lens(1, 32, 100, 200), -20, False, None, False, {},
             ("warp", 3, 1)),
    "warp_local": (_rand_lens(2, 32, 100, 200), -20, False, None, True, {},
                   ("warp", 3, 1)),
    "warp_wide": (_rand_lens(3, 9, 150, 200), -60, False, None, False, {},
                  ("warp", 4, 1)),
    "warps": ([(520, 515), (518, 517), (515, 520)], -60, False, None, False,
              {}, ("warps", 2, 5)),
    "warps_local": ([(520, 515), (300, 515)], -60, False, None, True, {},
                    ("warps", 2, 5)),
    "warps_1x10": ([(520, 515), (518, 517), (515, 520)], -60, False, None,
                   False, {"variant": "warps", "lanes": 1}, ("warps", 1, 10)),
    "odd_w": ([(300, 240), (250, 260)], -50, False, None, False, {},
              ("warps", 2, 3)),
    "exg0": ([(200, 300)] * 2, -60, False, [1, 0, 0, 0], False, {},
             ("warps", 2, 3)),
    "exg1": ([(200, 300)] * 2, -60, False, [0, 1, 0, 0], False, {},
             ("warps", 2, 3)),
    "exg2": ([(300, 200)] * 2, -60, False, [0, 0, 1, 0], False, {},
             ("warps", 2, 3)),
    "exg3": ([(300, 200)] * 2, -60, False, [0, 0, 0, 1], False, {},
             ("warps", 2, 3)),
    "dna": (_rand_lens(4, 8, 300, 420), -30, True, None, False, {},
            ("warps", 2, 3)),
    "dna_local": (_rand_lens(5, 8, 100, 120), -30, True, None, True, {},
                  ("warp", 2, 1)),
    "full_width": ([(700, 650), (640, 700)], -100, False, None, False, {},
                   ("warps", 2, 11)),
    "mixed": ([(150, 520), (518, 515), (145, 157), (520, 157), (516, 519),
               (157, 150)], -60, False, None, False, {}, ("warps", 2, 5)),
    "ask_warp_10": ([(520, 515), (515, 520)], -60, False, None, False,
                    {"variant": "warp", "lanes": 10}, ("warp", 10, 1)),
    "ask_warps_4x3": ([(520, 515), (515, 520)], -60, False, None, False,
                      {"variant": "warps", "lanes": 4, "warps": 3},
                      ("warps", 4, 3)),
    "ask_block": ([(520, 515), (150, 520)], -60, False, None, True,
                  {"variant": "block"}, ("block", 0, 0)),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(_K1_CASES))
def test_pairwise_kernel_plans_match_plain(cuda_device, case):
    """K1 against ``wavefront_scores_ref``, bit for bit, in each plan:
    one warp a pair (bands of 81 to 231 slots), several warps a pair
    (ce13a17's 626-slot band, of one and of two slot pairs a lane, an
    odd width, full-width bands), local scores, each free end gap alone,
    the DNA matrix, a batch mixing 145- and 520-residue sequences, and
    the plans asked for (one warp of 10 slot pairs a lane, 3 warps of 4,
    the block variant)."""
    lens, sh, dna, exg, local, ask, want = _K1_CASES[case]
    arrs = _k1_batch(zlib.crc32(case.encode()), lens, sh, dna=dna,
                     exg=None if exg is None else np.array(exg, bool))
    args = [torch.as_tensor(x, device=cuda_device) for x in arrs]
    maxw = int((arrs[5] - arrs[4]).max()) + 3
    if case == "odd_w":
        assert maxw % 2 == 1
    plan = tpw.pairwise_plan(maxw, len(lens), arrs[6].shape[0],
                             arrs[0].shape[1], arrs[1].shape[1], **ask)
    assert (plan["variant"], plan["lanes"], plan["warps"]) == want
    got = tpw._launch_pairwise(*args, local, plan)
    ref = tpw._plain_pairwise(*args, local)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


def _k1f_batch(seed, lens, nlane=None, sh=-60, dna=False, exg=None,
               u=2.0):
    """K1f's launch arguments for pairs of the given (la, lb) lengths: the
    band of ``stripe`` at shoulder ``sh``, or, with ``nlane``, bands that
    together span exactly ``nlane`` lanes from lw0 = min(lw)."""
    arrs = _k1_batch(seed, lens, sh, dna=dna, exg=exg)
    if nlane is not None:
        la = arrs[2]
        lw = -(la // 2).astype(np.int32)
        lw[0] = lw.min()
        up = np.minimum(lw + int(la.min()), lw[0] + nlane - 1)
        up[0] = lw[0] + nlane - 1
        arrs[4], arrs[5] = lw, up.astype(np.int32)
        assert int(up.max()) - int(lw.min()) + 1 == nlane
    arrs[7] = np.full(len(lens), u, np.float32)
    return arrs


# K1f's cases: the batch (seed, lengths, lanes or None for sh=-60, DNA,
# free end gaps, u), the plan asked for, and the variant, lanes a thread,
# warps a pair and pairs a block it must give
_K1F_CASES = {
    "warp_1024": ((1, _rand_lens(1, 132, 300, 400), 1024, False, None, 2.0),
                  {}, ("warp", 32, 1, 1)),
    "warps_1025": ((2, _rand_lens(2, 132, 300, 400), 1025, False, None,
                    2.0), {}, ("warps", 8, 5, 1)),
    "small_128": ((3, _rand_lens(3, 4, 150, 200), 128, False, None, 2.0),
                  {}, ("warp", 4, 1, 1)),
    "small_129": ((4, _rand_lens(4, 4, 150, 200), 129, False, None, 2.0),
                  {}, ("warps", 4, 2, 1)),
    "warps_8192": ((5, [(300, 320), (310, 290)], 8192, False, None, 2.0),
                   {}, ("warps", 16, 16, 1)),
    "block_8193": ((6, [(300, 320), (310, 290)], 8193, False, None, 2.0),
                   {}, ("block", 9, 0, 1)),
    "pairs4_mixed": ((7, _rand_lens(7, 528, 40, 300), None, False, None,
                      2.0), {}, ("warp", 20, 1, 4)),
    "pairs2_mixed": ((8, _rand_lens(8, 264, 40, 300), None, False, None,
                      2.0), {}, ("warp", 20, 1, 2)),
    "exg0_warp": ((9, [(200, 300)] * 140, None, False, [1, 0, 0, 0], 2.0),
                  {}, ("warp", 12, 1, 1)),
    "exg1_warp": ((10, [(200, 300)] * 140, None, False, [0, 1, 0, 0], 2.0),
                  {}, ("warp", 12, 1, 1)),
    "exg2_warps": ((11, [(300, 200)] * 3, None, False, [0, 0, 1, 0], 2.0),
                   {}, ("warps", 4, 3, 1)),
    "exg3_warps": ((12, [(300, 200)] * 3, None, False, [0, 0, 0, 1], 2.0),
                   {}, ("warps", 4, 3, 1)),
    "dna_warps": ((13, _rand_lens(13, 8, 300, 420), None, True, None, 2.0),
                  {}, ("warps", 4, 5, 1)),
    "dna_warp": ((14, _rand_lens(14, 8, 100, 150), None, True, None, 2.0),
                 {"variant": "warp"}, ("warp", 8, 1, 1)),
    "ask_warp_2": ((15, _rand_lens(15, 6, 20, 30), None, False, None, 2.0),
                   {"variant": "warp", "lanes": 2}, ("warp", 2, 1, 1)),
    "ask_warps_16x2": ((16, [(520, 515), (515, 520)], None, False, None,
                        2.0), {"variant": "warps", "lanes": 16, "warps": 2},
                       ("warps", 16, 2, 1)),
    "ask_warps_12": ((17, [(520, 515), (150, 520)], None, False, None, 2.0),
                     {"variant": "warps", "lanes": 12}, ("warps", 12, 3, 1)),
    "ask_block": ((18, [(520, 515), (150, 520)], None, False, None, 2.0),
                  {"variant": "block"}, ("block", 1, 0, 1)),
    "negative_u": ((19, _rand_lens(19, 4, 150, 200), None, False, None,
                    -0.5), {"variant": "warp"}, ("warp", 12, 1, 1)),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(_K1F_CASES))
def test_pairwise_rows_plans_match_plain(cuda_device, case):
    """K1f against ``row_scores_ref``, bit for bit, in each plan: one warp
    a pair at its limit of 1,024 lanes and several warps past it, a small
    batch on either side of 128 lanes, the warps variant at its limit of
    8,192 lanes and the block variant past it, four and two pairs a block
    of mixed lengths, each free end gap alone in both register variants,
    the DNA matrix, plans asked for, and a negative gap extension (the
    lanes past the batch's width then keep their G masked)."""
    (seed, lens, nlane, dna, exg, u), ask, want = _K1F_CASES[case]
    arrs = _k1f_batch(seed, lens, nlane, dna=dna,
                      exg=None if exg is None else np.array(exg, bool), u=u)
    args = [torch.as_tensor(x, device=cuda_device) for x in arrs]
    lw0 = int(arrs[4].min())
    width = int(arrs[5].max()) - lw0 + 1
    plan = tpw.rows_plan(width, len(lens), arrs[6].shape[0],
                         arrs[0].shape[1], arrs[1].shape[1], **ask)
    assert (plan["variant"], plan["lanes"], plan["warps"],
            plan["pairs_per_block"]) == want
    got = tpw._launch_rows(*args, lw0, width, plan)
    ref = tpw._plain_rows(*args, lw0, width)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    assert torch.isfinite(got).all()


def _walk_planes(seed, T, MR, device, offset=0, pjump=0.002, pgap=0.1,
                 drop=(30, 700), loop_at_start=False):
    """Seeded ev and jd planes for K4w: mostly plain diagonal cells, gap
    states with probability ``pgap``, each jump flag with ``pjump``, jd
    targets ``drop`` waves down (many past the ring), a few dead cells;
    ``offset`` words ahead of ev in its allocation leave it off 16-byte
    alignment.  Returns the planes, t_min and the start cell."""
    rng = np.random.default_rng(seed)
    t_min = int(rng.integers(-50, 50))
    w = np.where(rng.random((T, MR)) < pgap, rng.integers(1, 3, (T, MR)), 0)
    flags = np.zeros((T, MR), np.int64)
    for bit in (tsh.EVH_JXH, tsh.EVH_SJ, tsh.EVH_JXF, tsh.EVH_JXG):
        flags |= np.where(rng.random((T, MR)) < pjump, bit, 0)
    flags |= np.where(rng.random((T, MR)) < 0.5, tsh.EVH_CSH, 0)
    ev = (w | flags | (rng.integers(0, 16, (T, MR)) << 3)).astype(np.int32)
    ev[rng.random((T, MR)) < 0.002] = -1
    ti = np.arange(T)[:, None, None]
    mm = np.arange(MR)[None, None, :]
    jd = (ti + t_min - 3 * mm
          - rng.integers(drop[0], drop[1], (T, 4, MR))).astype(np.int32)
    om = MR - 1
    on = T - 1 + t_min - 3 * om
    if loop_at_start:                # w = 3: state 0 -> 3 -> 0, no move
        ev[T - 1, om] = 3
    flat = torch.empty(T * MR + offset, dtype=torch.int32, device=device)
    evd = flat[offset:].view(T, MR)
    evd.copy_(torch.as_tensor(ev))
    return evd, torch.as_tensor(jd, device=device), t_min, om, on


# K4w's cases on seeded planes: T, MR, offset in words, jump probability,
# gap probability, the ring depth asked for (None: the default)
_K4W_CASES = {
    "ring8_crossed": (3000, 300, 0, 0.002, 0.1, 8),
    "ring32": (3000, 300, 0, 0.002, 0.1, 32),
    "default_527": (3875, 527, 0, 0.0005, 0.05, None),
    "jumps_past_ring": (4000, 200, 0, 0.02, 0.1, 64),
    "offset_1_word": (3000, 300, 1, 0.002, 0.1, None),
    "offset_3_words": (3000, 300, 3, 0.002, 0.1, 16),
    "rows_clipped_40": (2500, 40, 3, 0.002, 0.3, 128),
    "ring256": (3000, 300, 0, 0.002, 0.1, 256),
    "flagship_shape": (36475, 527, 0, 0.0002, 0.05, None),
    "walk_steps_cap": (900, 120, 0, 0.0, 0.0, None),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(_K4W_CASES))
def test_walk_kernel_matches_plain(cuda_device, case):
    """K4w against ``walk_h_ref`` on seeded planes: the same knots, stop
    cell and steps, in the plan each case asks for.  Walks that cross a
    ring of 8 and 32 waves many times, junction jumps that land past the
    ring, ev 1 and 3 words past a 16-byte boundary (every window's first
    chunk read word by word), 40 rows (windows clipped at row 1 and past
    row MR - 1 reach into the neighbouring waves), a ring of 256, the
    flagship's 36,475 waves, and a walk that runs into ``walk_steps``."""
    T, MR, offset, pjump, pgap, depth = _K4W_CASES[case]
    cap = case == "walk_steps_cap"
    ev, jd, t_min, om, on = _walk_planes(zlib.crc32(case.encode()), T, MR,
                                         cuda_device, offset, pjump, pgap,
                                         loop_at_start=cap)
    M, N = MR - 1, on + 10
    plan = tsh.walk_plan(T, MR, depth=depth)
    assert plan["depth"] == (depth or tsh.K4W_DEPTH)
    if offset:
        assert ev.data_ptr() % 16 != 0
    got = tsh._launch_walk(ev, jd, t_min, M, N, om, on, plan)
    ref = tsh.walk_h_ref(ev, jd, t_min, M, N, om, on)
    assert got == ref
    reads = tsh.WALK_READS
    assert reads["ring"] + reads["device"] >= ref.steps
    if cap:
        assert ref.steps == tsh.walk_steps(M, N) and not ref.knots
    else:
        assert ref.steps > 50 and len(ref.knots) > 3


@pytest.mark.gpu
@pytest.mark.parametrize("depth", [8, 32, 128, 256])
def test_walk_kernel_on_k4_planes(cuda_device, depth):
    """K4w on the planes K4 made on the card for the GT/AG-rich genome of
    ``test_spliced_kernels_match_plain`` and for mini, at each ring
    depth, against ``walk_h_ref``; the knots come back in one copy or,
    past K4W_KNOTS_AHEAD, two."""
    for genome, protein in (_k4_pair("rich"), _k4_pair("mini")):
        calls = _spliced_calls(genome, protein, cuda_device)
        wargs, wk = calls["walk"]
        ev, jd, t_min, M, N, om, on = wargs
        plan = tsh.walk_plan(*ev.shape, depth=depth)
        got = tsh._launch_walk(*wargs, plan)
        assert got == tsh.walk_h_ref(*wargs) == wk


def _mk_gene(rng, nexon=3, exon=(20, 60), intron=(25, 120)):
    """tests/test_spliced_jax.py's random gene: exons joined by GT..AG
    introns (that file imports JAX; this one does not)."""
    bases = "ACGT"
    genome = []
    cdna = []
    for k in range(nexon):
        ex = "".join(rng.choice(list(bases))
                     for _ in range(rng.integers(*exon)))
        genome.append(ex)
        cdna.append(ex)
        if k < nexon - 1:
            ilen = int(rng.integers(*intron))
            mid = "".join(rng.choice(list(bases))
                          for _ in range(max(ilen - 4, 1)))
            genome.append("GT" + mid + "AG")
    return "".join(genome), "".join(cdna)


_ENDS = ((True, True), (True, True))


def _k5_sized_gene(rows, seed, rich=0.0):
    """A gene whose cDNA has ``rows`` nt (``rows`` rows of K5 with the
    default ends): three exons joined by GT...AG introns of 100-300 nt
    in 60-nt flanks; ``rich`` is the share of draws in the genome's
    random parts that are splice-like motifs (GT, AG, GTAAGT, TTTCAG)."""
    rng = np.random.default_rng(seed)

    def rand(k):
        parts, size = [], 0
        while size < k:
            if rng.random() < rich:
                part = ("GT", "AG", "GTAAGT", "TTTCAG")[rng.integers(0, 4)]
            else:
                part = "ACGT"[rng.integers(0, 4)]
            parts.append(part)
            size += len(part)
        return "".join(parts)[:k]

    cuts = sorted(rng.choice(np.arange(1, rows), 2, replace=False)) \
        if rows >= 3 else [rows, rows]
    cdna = rand(rows)
    exons = [cdna[:cuts[0]], cdna[cuts[0]:cuts[1]], cdna[cuts[1]:]]
    genome = rand(60)
    for k, ex in enumerate(exons):
        genome += ex
        if k < 2 and ex:
            genome += "GT" + rand(int(rng.integers(100, 300))) + "AG"
    return genome + rand(60), cdna, *_ENDS


def _k5_gene(case):
    """K5's cases: tests/test_torch_spliced_s.py's (seeds 0-3, global
    ends, mismatches, gen1, gen2, introns past 825 nt), a cDNA of 1,100
    nt (1,105 rows), cDNAs of 1, 255, 256, 257, 512, 4,096, 4,097 and
    6,000 nt, a genome rich in GT and AG (many donor pushes and acceptor
    merges), and ``chip_smoke.GENES``' medium gene (621 rows)."""
    if case.startswith("seed"):
        return (*_mk_gene(np.random.default_rng(int(case[4:]))), *_ENDS)
    if case == "global_ends":
        return (*_mk_gene(np.random.default_rng(7), nexon=2),
                (False, False), (False, False))
    if case == "mismatches":
        rng = np.random.default_rng(11)
        gen, cdna = _mk_gene(rng)
        c = list(cdna)
        for p in rng.integers(0, len(c), 6):
            c[p] = "ACGT"[rng.integers(0, 4)]
        del c[10:13]
        return gen, "".join(c), *_ENDS
    if case in ("gen1", "gen2"):
        return (tio.sniff_and_read(FIX / f"{case}.fa")[0].seq,
                tio.sniff_and_read(FIX / f"cdna{case[-1]}.fa")[0].seq,
                *_ENDS)
    if case == "long_introns":
        return (*_mk_gene(np.random.default_rng(5), exon=(60, 120),
                          intron=(900, 1300)), *_ENDS)
    if case == "rich":
        return _k5_sized_gene(300, 17, rich=0.35)
    if case == "medium":
        from chip_smoke import spliced_gene
        return (*spliced_gene("medium")[:2], *_ENDS)
    if case.startswith("rows") and case != "rows1100":
        return _k5_sized_gene(int(case[4:]), int(case[4:]))
    return (*_mk_gene(np.random.default_rng(13), nexon=4, exon=(270, 290),
                      intron=(100, 300)), *_ENDS)


# K5's cases and the plan the wrapper picks for each (variant, CTAs, rows
# a CTA): the cluster variant up to 4,096 rows
_K5_CASES = {
    "seed0": ("cluster", 4, 32), "seed1": ("cluster", 5, 32),
    "seed2": ("cluster", 6, 32), "seed3": ("cluster", 5, 32),
    "global_ends": ("cluster", 4, 32), "mismatches": ("cluster", 4, 32),
    "gen1": ("cluster", 11, 32), "gen2": ("cluster", 10, 32),
    "long_introns": ("cluster", 8, 32), "rows1100": ("cluster", 12, 96),
    "rows1": ("cluster", 1, 32), "rows255": ("cluster", 8, 32),
    "rows256": ("cluster", 8, 32), "rows257": ("cluster", 9, 32),
    "rows512": ("cluster", 16, 32), "rich": ("cluster", 10, 32),
}
_K5_RUNS = {}


def _k5_run(case, device):
    """``spliced_align_device`` of the case on ``device`` with a recorder
    at K5's launch point: ((score, skl), K5's inputs and output)."""
    from prrn_aln_tpu_torch.ops import spliced_s as tss
    from prrn_aln_tpu_torch.splice.penalty import IntronPenalty
    from prrn_aln_tpu_torch.splice.signals import SpliceSignals
    gen, cdna, exga, exgb = _k5_gene(case)
    bg, ac = ab.encode(gen.upper(), ab.DNA), ab.encode(cdna.upper(), ab.DNA)
    mtx, _ = scoring.dna_matrix(default_params(ab.DNA, "aln"))
    w = stripe(len(ac), len(bg), -50)
    calls = []
    real = tss._launch_sweep_s

    def rec(ins, plan=None):
        calls.append((ins, real(ins, plan)))
        return calls[-1][1]

    tss._launch_sweep_s = rec
    try:
        res = tss.spliced_align_device(
            ac, bg, SpliceSignals.build(bg), IntronPenalty.build(), mtx,
            lw=w.lw, up=w.up, exga=exga, exgb=exgb, device=device)
    finally:
        tss._launch_sweep_s = real
    return res, calls


def _k5_same(sw, ref):
    from prrn_aln_tpu_torch.ops import spliced_s as tss
    for field in tss.SweepS._fields:
        got, want = getattr(sw, field).cpu(), getattr(ref, field).cpu()
        if got.dtype == torch.float32:
            got, want = got.view(torch.int32), want.view(torch.int32)
        assert torch.equal(got, want), field


def _k5_case(case, device):
    """The case's K5 inputs on the card and the plain sweep's output on a
    CPU copy of them (run once a case)."""
    from prrn_aln_tpu_torch.ops import spliced_s as tss
    if case not in _K5_RUNS:
        _, ((ins, _),) = _k5_run(case, device)
        _K5_RUNS[case] = (ins, tss.sweep_s_ref(ins.to("cpu")))
    return _K5_RUNS[case]


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(_K5_CASES))
def test_spliced_s_kernel_matches_plain(cuda_device, case):
    """K5's planes and final H band, bit for bit, against ``sweep_s_ref``
    on a CPU copy of its inputs (the penalty table is one of them), and
    the aligner's score and knots on the card against the CPU's, through
    the plan the wrapper picks (asserted).  The plain sweep takes about 4
    ms a wave on the CPU: some 16 s for the 3,900 waves at 1,101 rows."""
    from prrn_aln_tpu_torch.ops import spliced_s as tss
    (score, skl), calls = _k5_run(case, cuda_device)
    (ins, sw), = calls
    plan = tss.launch_plan(ins.rows, ins.mtx.shape[0], ins.lb + 2)
    assert (plan["variant"], plan["ctas"], plan["rows"]) == _K5_CASES[case]
    assert plan["rpt"] == 1 and plan["pen_smem"]
    ref = tss.sweep_s_ref(ins.to("cpu"))
    _K5_RUNS[case] = (ins, ref)
    _k5_same(sw, ref)
    if case != "rows1100":
        (cscore, cskl), _ = _k5_run(case, "cpu")
        assert np.float32(score) == np.float32(cscore) and skl == cskl


@pytest.mark.gpu
@pytest.mark.parametrize("case, kw, want", [
    ("rows255", dict(ctas=1), (1, 256)),
    ("rows256", dict(ctas=1), (1, 256)),
    ("rows257", dict(ctas=2), (2, 160)),
    ("gen1", dict(ctas=2), (2, 192)),
    ("gen1", dict(ctas=3), (3, 128)),
    ("gen1", dict(pen_smem=False), (11, 32)),
    ("long_introns", dict(pen_smem=False), (8, 32)),
    ("long_introns", dict(ctas=2), (2, 128)),
    ("rich", dict(ctas=2), (2, 160)),
    ("rows1100", dict(ctas=5, pen_smem=False), (5, 224)),
    ("rows1100", dict(ctas=16), (12, 96))])
def test_spliced_s_cluster_plans(cuda_device, case, kw, want):
    """K5's cluster variant under the plans the bench asks for: one CTA
    of a slab's 256 rows (255 and 256 rows; 257 take two CTAs), several
    cluster sizes, and the penalty table in device memory rather than
    shared memory; each against the plain version."""
    from prrn_aln_tpu_torch.ops import spliced_s as tss
    ins, ref = _k5_case(case, cuda_device)
    plan = tss.sweep_s_plan(ins.rows, ins.mtx.shape[0], ins.lb + 2,
                            variant="cluster", **kw)
    assert (plan["ctas"], plan["rows"]) == want
    assert plan["pen_smem"] == kw.get("pen_smem", True)
    _k5_same(tss._launch_sweep_s(ins, plan), ref)


@pytest.mark.gpu
def test_spliced_s_cluster_most_rows(cuda_device):
    """4,096 rows, 16 CTAs of 256 (the most the cluster variant takes),
    against the global variant on the card (held to the plain version in
    the tests above), and 4,097 rows planned onto the chained variant."""
    from prrn_aln_tpu_torch.ops import spliced_s as tss
    (_, _), ((ins, sw),) = _k5_run("rows4096", cuda_device)
    K = ins.mtx.shape[0]
    plan = tss.launch_plan(ins.rows, K, ins.lb + 2)
    assert (plan["variant"], plan["ctas"], plan["rows"]) == \
        ("cluster", 16, 256)
    glob = tss._launch_sweep_s(ins, tss.sweep_s_plan(
        ins.rows, K, ins.lb + 2, variant="global"))
    _k5_same(sw, glob)
    assert tss.sweep_s_plan(4097, K, ins.lb + 2)["variant"] == "chained"


@pytest.mark.gpu
@pytest.mark.parametrize("case, want", [
    ("rows4097", (5, 13, 64)), ("rows6000", (6, 16, 64))])
def test_spliced_s_chained_default_plan(cuda_device, case, want):
    """Past 4,096 rows the wrapper's plan is the chained variant (clusters,
    CTAs a cluster, rows a CTA asserted: 64 rows a CTA, every cluster
    in one launch); its planes and final band equal the global variant's on
    the card bit for bit, and the aligner's score and knots equal the
    global variant's.  The plain version would take minutes here on the
    card; the chained variant is held to it on the medium gene below."""
    from prrn_aln_tpu_torch.ops import _build
    from prrn_aln_tpu_torch.ops import spliced_s as tss
    _build.LAUNCHES.clear()
    (score, skl), ((ins, sw),) = _k5_run(case, cuda_device)
    assert _build.LAUNCHES["spliced_s_wave"] == 1
    K = ins.mtx.shape[0]
    plan = tss.launch_plan(ins.rows, K, ins.lb + 2)
    assert plan["variant"] == "chained"
    assert (plan["clusters"], plan["ctas"], plan["rows"]) == want
    assert plan["passes"] == 1 and plan["pen_smem"]
    glob = tss._launch_sweep_s(ins, tss.sweep_s_plan(
        ins.rows, K, ins.lb + 2, variant="global"))
    _k5_same(sw, glob)
    assert tss.finish_s(ins, glob) == (score, skl)


@pytest.mark.gpu
@pytest.mark.parametrize("case, kw, want", [
    ("medium", dict(ctas=2, clusters=5), (5, 2, 64, 1)),
    ("medium", dict(ctas=2, clusters=5, per_pass=2), (5, 2, 64, 3)),
    ("medium", dict(ctas=1, clusters=3), (3, 1, 224, 1)),
    ("medium", dict(ctas=3, clusters=2, pen_smem=False), (2, 3, 128, 1)),
    ("gen1", dict(ctas=1, clusters=11, per_pass=1), (11, 1, 32, 11)),
    ("rich", dict(ctas=2, clusters=3), (3, 2, 64, 1)),
    ("long_introns", dict(ctas=4, clusters=2), (2, 4, 32, 1))])
def test_spliced_s_chained_plans(cuda_device, case, kw, want):
    """K5's chained variant under forced small plans (clusters, CTAs a
    cluster, rows a CTA, launches): the medium gene's 621 rows as 5
    clusters of 2 CTAs of 64 rows in one launch and in passes of 2, other
    splits, one cluster a launch, the penalty
    table in device memory; each against the plain version, bit for
    bit."""
    from prrn_aln_tpu_torch.ops import _build
    from prrn_aln_tpu_torch.ops import spliced_s as tss
    ins, ref = _k5_case(case, cuda_device)
    plan = tss.sweep_s_plan(ins.rows, ins.mtx.shape[0], ins.lb + 2,
                            variant="chained", **kw)
    assert (plan["clusters"], plan["ctas"], plan["rows"],
            plan["passes"]) == want
    _build.LAUNCHES.clear()
    sw = tss._launch_sweep_s(ins, plan)
    assert _build.LAUNCHES["spliced_s_wave"] == plan["passes"]
    _k5_same(sw, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("rings, pen, rpt", [
    (False, True, 1), (True, False, 1), (False, False, 1), (True, True, 2),
    (False, False, 3)])
def test_spliced_s_kernel_plans(cuda_device, rings, pen, rpt):
    """K5's global variant on gen1 and the long-intron gene under each
    placement of its rings and penalty table (shared or device memory)
    and with several rows a thread, against the plain version."""
    from prrn_aln_tpu_torch.ops import spliced_s as tss
    for case in ("gen1", "long_introns"):
        ins, ref = _k5_case(case, cuda_device)
        K = ins.mtx.shape[0]
        threads = (-(-ins.rows // rpt) + 31) // 32 * 32
        smem = 4 * (K * K + 256 + (tss.K5_RING_WORDS * ins.rows if rings
                                   else 0) + (ins.lb + 2 if pen else 0))
        plan = {"variant": "global", "ctas": 1, "rows": ins.rows,
                "threads": threads, "rpt": rpt, "ring_smem": rings,
                "pen_smem": pen, "smem": smem}
        _k5_same(tss._launch_sweep_s(ins, plan), ref)


@pytest.mark.gpu
def test_spliced_s_wrapper_rejects_what_k5_does_not_take(cuda_device):
    from prrn_aln_tpu_torch.ops import spliced_s as tss
    ins = _k5_case("seed0", cuda_device)[0]
    import dataclasses
    bad = dataclasses.replace(ins, pen=ins.pen[:-1].contiguous())
    with pytest.raises(ValueError, match="shape"):
        tss._launch_sweep_s(bad)
    for variant, kw in (("cluster", {}), ("global", {}),
                        ("chained", dict(ctas=1, clusters=2))):
        plan = tss.sweep_s_plan(ins.rows, ins.mtx.shape[0], ins.lb + 2,
                                variant=variant, **kw)
        with pytest.raises(RuntimeError, match="CUDA error"):
            tss._launch_sweep_s(ins, {**plan, "smem": plan["smem"] + 4})
    # a chained plan with an empty cluster
    plan = tss.sweep_s_plan(ins.rows, ins.mtx.shape[0], ins.lb + 2,
                            variant="chained", ctas=1, clusters=2)
    with pytest.raises(RuntimeError, match="CUDA error"):
        tss._launch_sweep_s(ins, {**plan, "clusters": plan["clusters"] + 1})
    plan = tss.sweep_s_plan(ins.rows, ins.mtx.shape[0], ins.lb + 2)
    with pytest.raises(RuntimeError, match="CUDA error"):
        tss._launch_sweep_s(ins, {**plan, "ctas": 17})


def _frontier_row_case(Wl, device, rows=12, seed=0):
    """A sweep of ``rows`` row steps on one rank's shard of ``Wl`` lanes
    (the second shard: j0 = Wl), with random H, G, codes, matrix and
    received values, u and v inexact in binary, the left column crossing
    lanes 5 .. 0 in rows 0 .. 5, columns past the pair's end, and padding
    lanes past W in the shard."""
    rng = np.random.default_rng(seed)
    j0 = Wl
    lw = -(j0 + 5)
    lb = j0 + lw + rows + Wl
    kw = dict(j0=j0, lw=lw, W=j0 + max(1, Wl - 3), u=0.7111, v=3.3)

    def t(x):
        return torch.as_tensor(x, device=device)
    H, G = (t(rng.normal(0, 20, Wl).astype(np.float32)) for _ in range(2))
    band = (t(rng.integers(0, 24, rows).astype(np.int32)),
            t(rng.integers(0, 24, lb).astype(np.int32)),
            t(rng.normal(0, 2, (26, 26)).astype(np.float32)))
    recv = [tuple(float(x) for x in rng.normal(0, 20, 4).astype(np.float32))
            for _ in range(rows)]
    return H, G, band, recv, kw


def _same_bits(x, y):
    return torch.equal(x.view(torch.int32), y.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("Wl", [1, 31, 32, 1024, 1025, 3000])
def test_frontier_row_kernel_matches_plain(cuda_device, Wl):
    """K6r against ``frontier_row_ref`` on ``band_rows``' scores, bit for
    bit (H0, G0 and the four values the row sends), row after row of a
    sweep: one launch a row."""
    from prrn_aln_tpu_torch.ops import _build, frontier as tfr
    H, G, band, recv, kw = _frontier_row_case(Wl, cuda_device)
    a, b, mtx = band
    s_rows = torch.as_tensor(tfr.band_rows(a.cpu(), b.cpu(), kw["lw"],
                                           mtx.cpu(), Wl, kw["j0"]),
                             device=cuda_device)
    Hr, Gr = H.clone(), G.clone()
    before = _build.LAUNCHES["frontier_row"]
    for m in range(a.shape[0]):
        H, G, sends = tfr.frontier_row(H, G, a, b, mtx, recv[m], m=m, **kw)
        Hr, Gr, want = tfr.frontier_row_ref(Hr, Gr, s_rows[m], recv[m], m=m,
                                            lb=b.shape[0], **kw)
        assert _same_bits(H, Hr), m
        assert _same_bits(G, Gr), m
        assert _same_bits(sends, want), m
    assert _build.LAUNCHES["frontier_row"] - before == a.shape[0]


# (u, v, matrix shift) of tests/test_torch_distributed.py's frontier pairs
K6S_PAIRS = {"test_frontier": (2.0, 9.0, 0.0), "inexact": (0.7111, 3.3, 0.0),
             "negative": (0.377, 5.123, -60.0)}


def _k6s_case(Wl, name, device, la=48, seed=3):
    """One rank's band of ``Wl`` lanes (W = Wl - 3: padding lanes past
    W) on a seeded pair of ``la`` rows whose left column crosses the band
    and whose right end leaves it; the virtual row's H and G, the codes
    and the matrix on ``device``."""
    u, v, shift = K6S_PAIRS[name]
    rng = np.random.default_rng(seed)
    lb = la + Wl // 2 + 5
    W = max(1, Wl - 3)
    lw = -min(la // 2, Wl // 2 + 2)
    kw = dict(lw=lw, W=W, u=u, v=v)

    def t(x):
        return torch.as_tensor(x, device=device)
    band = (t(rng.integers(0, 24, la).astype(np.int32)),
            t(rng.integers(0, 24, lb).astype(np.int32)),
            t((rng.normal(0, 2, (26, 26)) + shift).astype(np.float32)))
    from prrn_aln_tpu_torch.ops import frontier as tfr
    H, G = tfr.row_init(0, Wl, lw, lw + W - 1, u, v, device)
    return H, G, band, kw


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(K6S_PAIRS))
@pytest.mark.parametrize("Wl", [1, 31, 32, 257, 520, 1025, 3000, 8192])
def test_frontier_sweep_kernel_matches_plain(cuda_device, Wl, name):
    """K6s against ``frontier_sweep_ref`` on the card: the last row's H
    and G bit for bit, in one launch (1, 2, 4 and 8 lanes a thread, up to
    the widest band K6s takes)."""
    from prrn_aln_tpu_torch.ops import _build, frontier as tfr
    H, G, band, kw = _k6s_case(Wl, name, cuda_device)
    before = _build.LAUNCHES["frontier_sweep"]
    got = tfr.frontier_sweep(H, G, *band, **kw)
    assert _build.LAUNCHES["frontier_sweep"] - before == 1
    want = tfr.frontier_sweep_ref(H, G, *band, **kw)
    assert _same_bits(got[0], want[0]) and _same_bits(got[1], want[1])
    assert tfr.sweep_plan(Wl)["kernel"] == "sweep"


@pytest.mark.gpu
def test_frontier_plan_takes_k6r_past_k6s(cuda_device):
    """One lane past the widest band K6s holds, the plan takes K6r, one
    launch a row, and the rows equal the plain sweep bit for bit."""
    from prrn_aln_tpu_torch.ops import _build, frontier as tfr
    Wl = tfr.K6S_MAX_LANES + 1
    assert tfr.sweep_plan(Wl - 1)["kernel"] == "sweep"
    assert tfr.sweep_plan(Wl)["kernel"] == "row"
    H, G, band, kw = _k6s_case(Wl, "inexact", cuda_device, la=24)
    up = kw["lw"] + kw["W"] - 1
    _build.LAUNCHES.clear()
    got = tfr._rows(H, G, *band, None, j0=0, up=up, **kw)
    assert dict(_build.LAUNCHES) == {"frontier_row": band[0].shape[0]}
    want = tfr.frontier_sweep_ref(H, G, *band, **kw)[0]
    assert _same_bits(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("la, lb, lw, up, u, v", [
    (96, 96, -40, 40, 2.0, 9.0), (300, 280, -150, 90, 0.7111, 3.3)])
def test_frontier_score_on_card_equals_cpu(cuda_device, la, lb, lw, up, u, v):
    """The whole score at world 1 (no exchange): K6s on the card, in one
    launch, the plain version on the CPU, the same bits."""
    from prrn_aln_tpu_torch.ops import _build, frontier as tfr
    rng = np.random.default_rng(9)
    a = rng.integers(0, 24, la).astype(np.int32)
    b = rng.integers(0, 24, lb).astype(np.int32)
    mtx = rng.normal(0, 2, (26, 26)).astype(np.float32)
    _build.LAUNCHES.clear()
    got = tfr.frontier_pairwise_score(a, b, lw, up, u, v, mtx,
                                      device=cuda_device)
    assert dict(_build.LAUNCHES) == {"frontier_sweep": 1}
    want = tfr.frontier_pairwise_score(a, b, lw, up, u, v, mtx, device="cpu")
    assert np.float32(got).view(np.int32) == np.float32(want).view(np.int32)


@pytest.mark.gpu
def test_frontier_wrapper_rejects_what_k6_does_not_take(cuda_device):
    from prrn_aln_tpu_torch.ops import frontier as tfr
    H, G, (a, b, mtx), kw = _k6s_case(64, "inexact", cuda_device)
    with pytest.raises(ValueError, match="dtype"):
        tfr.frontier_sweep(H.double(), G, a, b, mtx, **kw)
    with pytest.raises(ValueError, match="dtype"):
        tfr.frontier_row(H, G, a.long(), b, mtx, (0.0,) * 4, m=0, j0=0, **kw)
    with pytest.raises(ValueError, match="shape"):
        tfr.frontier_row(H, G[:32].contiguous(), a, b, mtx, (0.0,) * 4, m=0,
                         j0=0, **kw)
    with pytest.raises(ValueError, match="row"):
        tfr.frontier_row(H, G, a, b, mtx, (0.0,) * 4, m=a.shape[0], j0=0,
                         **kw)
    with pytest.raises(ValueError, match="K6s holds"):
        tfr.frontier_sweep(H, G, a, b, mtx, plan=tfr.sweep_plan(64, 2), **kw)
    with pytest.raises(RuntimeError, match="CUDA error"):
        tfr.frontier_sweep(H, G, a, b, mtx,
                           plan={"kernel": "sweep", "k": 1, "threads": 32},
                           **kw)
    with pytest.raises(RuntimeError, match="CUDA error"):
        tfr.frontier_sweep(H, G, a, b, mtx,
                           plan={"kernel": "sweep", "k": 3, "threads": 64},
                           **kw)
