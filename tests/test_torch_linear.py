"""Port linear-space aligner (K2's carries, the range walk) vs the JAX package.

Chunk by chunk, the port's plain K2 (``group_wavefront`` on CPU tensors)
resumes from its own carry and the JAX Pallas kernel (interpret mode, as
tests/test_linear_space.py runs it) from its ``st``/``gl``: planes and
the carries' runs and Hdir (converted with ``convert.carry_from_jax``)
must be identical, the lane values too without ls3, and scores (and ls3
lane values) within rel 1e-5 / abs 1e-3 (test_torch_group.py's
tolerance).  The
plain range walk must equal ``_traceback_device_range`` exactly, and
``group_align_linear`` the JAX package's on test_linear_space.py's cases
(SKL exact, score within that file's rel 1e-6 / abs 1e-3).
"""

import numpy as np
import pytest
import torch

from prrn_aln_tpu import alphabet as jab, scoring as jscoring
from prrn_aln_tpu.config import AlnParams as JParams
from prrn_aln_tpu.msa.msa import Msa as JMsa
from prrn_aln_tpu.ops import group as jg, pallas_group as pg
from prrn_aln_tpu.ops.window import stripe as jstripe
from prrn_aln_tpu_torch import convert
from prrn_aln_tpu_torch.ops import group as tg
from prrn_aln_tpu_torch.ops.window import stripe

# one intra-op thread: the suite runs several worker processes at once
torch.set_num_threads(1)

MTX, _ = jscoring.protein_matrix(JParams(pam=150))


def _mk(rng, many, L, gap=0.06):
    """test_linear_space.py's groups."""
    codes = (rng.integers(0, 20, size=(many, L)) + jab.ALA).astype(np.int8)
    codes[rng.random((many, L)) < gap] = jab.GAP
    codes[:, 0] = jab.ALA
    m = JMsa(codes=codes, molc=jab.PROTEIN,
             names=[f"s{i}" for i in range(many)])
    m.prepare(MTX.shape[0])
    return m


def _port(m):
    p = convert.msa_from_numpy(m.codes, m.weight, m.names, m.molc, m.eij)
    p.prepare(MTX.shape[0])
    return p


def _pair(seed, many, L, extra=17):
    rng = np.random.default_rng(seed)
    return _mk(rng, many, L), _mk(rng, many, L + extra)


@pytest.fixture
def _pallas():
    jg.USE_PALLAS_GROUP = True
    yield
    jg.USE_PALLAS_GROUP = None


def _jax_chunks(A, B, chunk, ls, u=2.0, v=9.0, u1=0.6, k1=7):
    """The JAX kernel's launch state as group_align_linear builds it."""
    La, Lb = A.length, B.length
    wdw = jstripe(La, Lb, -60)
    la_max, lb_max = jg._bucket(La), jg._bucket(Lb)
    nslot = jg._bucket(wdw.up - wdw.lw + 3, 128)
    nsteps_total = jg._bucket(La + Lb + 1, pg.DSTEP)
    chunk = max(pg.DSTEP, min(jg._bucket(chunk, pg.DSTEP), nsteps_total))
    CA, CB, ea0, eb0 = jg._pack_profiles(A, B, MTX, la_max, lb_max)
    cols = jg._pack_cols(A, B, A.many, B.many, la_max, lb_max)
    ls3 = ls >= 3
    prm1, FA, FB = pg.pack_pair(
        CA, CB, ea0, eb0, cols, La, Lb, wdw, u, -v,
        (v + (u - u1) * k1) / v if ls3 else 0.0, (u1 / u) if ls3 else 0.0,
        k1 if ls3 else 10 ** 9)
    kw = dict(an=A.many, bn=B.many, Cp=pg._pad_to(CA.shape[1], 8),
              nslot=nslot, nsteps=chunk, la_max=la_max, lb_max=lb_max,
              ls3=ls3, interpret=True)
    return wdw, prm1, FA[None], FB[None], kw, -(-nsteps_total // chunk)


@pytest.mark.parametrize("many,L,chunk,ls", [(1, 150, 128, 1),
                                             (3, 120, 64, 1),
                                             (3, 120, 64, 3)])
def test_chunk_carries_match_pallas(many, L, chunk, ls):
    """Each chunk: the port from its own carry, the Pallas kernel from its
    own; the planes, the final carries and the scores agree."""
    A, B = _pair(31 + many, many, L)
    wdw, prm1, FA, FB, kw, nchunks = _jax_chunks(A, B, chunk, ls)
    PA, PB = _port(A), _port(B)
    w = stripe(A.length, B.length, -60)
    item = tg._pack_inputs(PA, PB, MTX, 2.0, 9.0, w, many, many,
                           kw["la_max"], kw["lb_max"], ls=ls, uniform=False)
    ins = tg.stack_inputs([item], "cpu")
    st_, gl_ = pg.init_state(wdw.lw, kw["nslot"], many)
    st, gl = st_[None], gl_[None]
    carry = tg.init_carry([w.lw], kw["nslot"], many, many, ls >= 3)
    assert tg.carry_equal(carry, convert.carry_from_jax(
        st, gl, an=many, bn=many, ls3=ls >= 3))
    for c in range(nchunks):
        prm = np.array(prm1)
        prm[9] = c * kw["nsteps"]
        js, jd, jo, st, gl = pg._launch(prm[None], FA, FB, st, gl, **kw)
        ts, td, to, carry = tg.group_wavefront(
            ins, nslot=kw["nslot"], nsteps=kw["nsteps"], ls3=ls >= 3,
            d0=c * kw["nsteps"], carry=carry)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
        got = convert.carry_from_jax(st, gl, an=many, bn=many, ls3=ls >= 3)
        assert torch.equal(carry.hdir, got.hdir)
        assert torch.equal(carry.runs, got.runs)
        if ls < 3:
            np.testing.assert_array_equal(carry.vals.numpy(),
                                          got.vals.numpy())
        else:
            # the Pallas kernel sums the ls3 long-gap terms in another
            # order than the scan engine, which the port follows bit for
            # bit (test_torch_group.py): the lane values, like the scores,
            # agree to the score tolerance
            np.testing.assert_allclose(carry.vals.numpy(), got.vals.numpy(),
                                       rtol=1e-5, atol=1e-3)
        assert float(ts[0]) == pytest.approx(float(js[0]), rel=1e-5,
                                             abs=1e-3)
        # the JAX layout back from the converted carry, bit for bit
        st2, gl2 = convert.carry_to_jax(got, an=many, ls3=ls >= 3)
        np.testing.assert_array_equal(st2, np.asarray(st))
        np.testing.assert_array_equal(gl2, np.asarray(gl))


def test_odd_offset_chunks_equal_one_launch():
    """A carry taken after an odd number of steps resumes exactly: chunks
    of 37 steps give the planes, score and final carry of one launch."""
    A, B = _pair(7, 2, 70)
    PA, PB = _port(A), _port(B)
    w = stripe(A.length, B.length, -60)
    nslot = tg._bucket(w.up - w.lw + 3, 128)
    nsteps = tg._bucket(A.length + B.length + 1, 64)
    ins = tg.stack_inputs([tg._pack_inputs(
        PA, PB, MTX, 2.0, 9.0, w, 2, 2, tg._bucket(A.length),
        tg._bucket(B.length), ls=3, uniform=False)], "cpu")
    s0, d0, o0, c0 = tg.group_wavefront(ins, nslot=nslot, nsteps=nsteps,
                                        ls3=True)
    carry, planes = None, []
    for d in range(0, nsteps, 37):
        s1, d1, o1, carry = tg.group_wavefront(
            ins, nslot=nslot, nsteps=min(37, nsteps - d), ls3=True, d0=d,
            carry=carry)
        planes.append((d1, o1))
    assert torch.equal(torch.cat([p[0] for p in planes], 1), d0)
    assert torch.equal(torch.cat([p[1] for p in planes], 1), o0)
    assert tg.carry_equal(carry, c0)
    assert torch.equal(s1.view(torch.int32), s0.view(torch.int32))


def test_carry_rows_past_real_members_pass_through():
    """A pair's run rows past its real members come out as they went in;
    its real rows move on."""
    rng = np.random.default_rng(41)
    pairs = []
    for a, b in ((1, 3), (3, 2)):
        A, B = _mk(rng, a, 50), _mk(rng, b, 56)
        A.weight, B.weight = np.ones(a), np.ones(b)
        pairs.append((_port(A), _port(B)))
    wd = [stripe(A.length, B.length, -60) for A, B in pairs]
    nslot = tg._bucket(max(w.up - w.lw + 3 for w in wd), 128)
    items = [tg._pack_inputs(A, B, MTX, 2.0, 9.0, w, 3, 3, 64, 64)
             for (A, B), w in zip(pairs, wd)]
    ins = tg.stack_inputs(items, "cpu")
    carry = tg.init_carry([w.lw for w in wd], nslot, 3, 3)
    carry.runs[:, :, 1:-1] = 7          # every row, real or not
    _, _, _, out = tg.group_wavefront(ins, nslot=nslot, nsteps=64, d0=40,
                                      carry=carry)
    # pair 0 has 1 | 3 real members: A's rows 1, 2 of each lane untouched
    for lane in range(3):
        for i in (1, 2):
            assert torch.equal(out.runs[0, lane * 3 + i],
                               carry.runs[0, lane * 3 + i])
    # pair 1 (3 | 2): B's row 2 of each lane untouched
    for lane in range(3):
        row = 9 + lane * 3 + 2
        assert torch.equal(out.runs[1, row], carry.runs[1, row])
    assert not torch.equal(out.runs[1, 9], carry.runs[1, 9])


def _range_cases():
    """(planes, start) of the backward pass of the JAX linear aligner on
    test_linear_space.py's 3 x 120 case, chunk 64."""
    A, B = _pair(34, 3, 120)
    wdw, prm1, FA, FB, kw, nchunks = _jax_chunks(A, B, 64, 1)
    st_, gl_ = pg.init_state(wdw.lw, kw["nslot"], 3)
    st, gl = st_[None], gl_[None]
    ckpts = []
    for c in range(nchunks):
        ckpts.append((st, gl))
        prm = np.array(prm1)
        prm[9] = c * 64
        _, _, _, st, gl = pg._launch(prm[None], FA, FB, st, gl, **kw)
    return A, B, wdw, prm1, FA, FB, kw, nchunks, ckpts


def test_range_walk_matches_jax():
    """The backward pass, chunk by chunk: the plain range walk from where
    the JAX walk stood equals ``_traceback_device_range``; then the same
    planes from other starts (odd steps, gap lanes, a start above the
    chunk, slots that wrap)."""
    A, B, wdw, prm1, FA, FB, kw, nchunks, ckpts = _range_cases()
    mi = 2 * 64 + 8
    m, n, lane = A.length, B.length, 0
    walked = 0
    rng = np.random.default_rng(5)
    for c in reversed(range(nchunks)):
        d_lo = c * 64
        if (m == 0 and n == 0) or d_lo > m + n:
            continue
        prm = np.array(prm1)
        prm[9] = d_lo
        _, jd, jo, _, _ = pg._launch(prm[None], FA, FB, *ckpts[c], **kw)
        dirs, opens = np.asarray(jd[0]), np.asarray(jo[0])
        starts = [(m, n, lane)]
        for _ in range(4):
            d = int(rng.integers(d_lo + 1, d_lo + 70))
            mm = int(rng.integers(0, d + 1))
            starts.append((mm, d - mm, int(rng.integers(0, 5))))
        for k, (m0, n0, l0) in enumerate(starts):
            want = jg._traceback_device_range(
                dirs, opens, np.int32(m0), np.int32(n0), np.int32(l0),
                np.int32(d_lo), np.int32(wdw.lw), max_iters=mi)
            got = tg.traceback_range_ref(
                torch.tensor(dirs[None]), torch.tensor(opens[None]),
                [m0], [n0], [l0], [d_lo], [wdw.lw], max_iters=mi)
            for g, wnt in zip(got[:3], want[:3]):
                assert int(g[0]) == int(wnt)
            np.testing.assert_array_equal(got[3][0].numpy(),
                                          np.asarray(want[3]))
            assert int(got[4][0]) == int(want[4])
            if k == 0:
                m, n, lane = (int(x) for x in want[:3])
                walked += int(want[4])
    assert m == 0 and n == 0 and walked >= max(A.length, B.length)


def test_traceback_is_the_range_walk_from_the_end():
    """K3's walk from (La, Lb) is the range walk at d_lo = 0 and lane 0 on
    a DP's planes (it differs only where a walk of corrupt planes runs
    past the corner)."""
    rng = np.random.default_rng(9)
    pairs = [(_port(_mk(rng, 2, 60)), _port(_mk(rng, 3, 70)))
             for _ in range(2)]
    wd = [stripe(A.length, B.length, -60) for A, B in pairs]
    nslot = tg._bucket(max(w.up - w.lw + 3 for w in wd), 128)
    ins = tg.stack_inputs([tg._pack_inputs(A, B, MTX, 2.0, 9.0, w, 3, 3,
                                           128, 128)
                           for (A, B), w in zip(pairs, wd)], "cpu")
    _, dirs, opens, _ = tg.group_wavefront(ins, nslot=nslot, nsteps=192)
    moves, cnts = tg.traceback_ref(dirs, opens, ins["la"], ins["lb"],
                                   ins["lw"], max_iters=400)
    m, n, lane, rmoves, rcnts = tg.traceback_range_ref(
        dirs, opens, ins["la"], ins["lb"], [0, 0], [0, 0], ins["lw"],
        max_iters=400)
    assert torch.equal(moves, rmoves) and torch.equal(cnts, rcnts)
    assert (m == 0).all() and (n == 0).all()


@pytest.mark.parametrize("many,L,chunk,sh,seed", [(1, 150, 128, -60, 32),
                                                  (3, 120, 64, -60, 34),
                                                  (2, 40, 4096, -100, 5)])
def test_linear_matches_jax(_pallas, many, L, chunk, sh, seed):
    """test_linear_space.py's three cases: the port's group_align_linear on
    the CPU against the JAX package's, and against the port's
    group_align bit for bit."""
    rng = np.random.default_rng(seed)
    if many == 2:
        A, B = _mk(rng, 2, 40), _mk(rng, 2, 44)
    else:
        A, B = _mk(rng, many, L), _mk(rng, many, L + 17)
    wdw = jstripe(A.length, B.length, sh)
    s0, k0 = jg.group_align_linear(A, B, MTX, u=2.0, v=9.0, wdw=wdw,
                                   chunk=chunk)
    PA, PB = _port(A), _port(B)
    w = stripe(A.length, B.length, sh)
    s1, k1 = tg.group_align_linear(PA, PB, MTX, u=2.0, v=9.0, wdw=w,
                                   chunk=chunk, device="cpu")
    assert k1 == k0
    assert s1 == pytest.approx(s0, rel=1e-6, abs=1e-3)
    s2, k2 = tg.group_align(PA, PB, MTX, u=2.0, v=9.0, wdw=w, device="cpu")
    assert k2 == k1
    assert np.float32(s2).view(np.int32) == np.float32(s1).view(np.int32)


@pytest.mark.parametrize("a,b", [(2, 3), (1, 2)])
def test_unequal_member_counts_raise_in_both(_pallas, a, b):
    """The JAX aligner's carry holds A.many rows a side, so unequal member
    counts fail there (a TypeError); the port names the limit."""
    rng = np.random.default_rng(3)
    A, B = _mk(rng, a, 40), _mk(rng, b, 44)
    with pytest.raises(TypeError):
        jg.group_align_linear(A, B, MTX, u=2.0, v=9.0, chunk=64)
    with pytest.raises(ValueError, match="equal member counts"):
        tg.group_align_linear(_port(A), _port(B), MTX, u=2.0, v=9.0,
                              chunk=64, device="cpu")
