"""The host modules this slice copied or ported, against the JAX
package's on seeded NumPy inputs: ``msa/sets`` (``-G``), ``msa/outliers``
(``-O 2``), ``msa/sptree`` (``-O 4``), ``ops/local_np`` (``-L s``),
``utils/seqtools`` (``-M``), and ``msa/shuffle`` (``-R``), whose scores
come from K1's plain version here and from the JAX scan scorer there:
within 2 f32 ulp (ROADMAP C), and the mean and SD with them."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from prrn_aln_tpu import alphabet as jab, scoring as jscoring
from prrn_aln_tpu.config import default_params as jdefault_params
from prrn_aln_tpu.msa import distance as jdistance, tree as jtree
from prrn_aln_tpu.msa.msa import msa_from_strings as jmsa_from_strings
from prrn_aln_tpu.msa.outliers import (Dixon as JDixon,
                                       find_outliers as jfind_outliers,
                                       outlier_report as joutlier_report)
from prrn_aln_tpu.msa.sets import Subset as JSubset
from prrn_aln_tpu.msa.shuffle import shuffle_test as jshuffle_test
from prrn_aln_tpu.msa.sptree import sptree_wsp as jsptree_wsp
from prrn_aln_tpu.ops.local_np import swg_colonies as jswg_colonies
from prrn_aln_tpu.utils import seqtools as jseqtools
from prrn_aln_tpu_torch import alphabet as ab, scoring
from prrn_aln_tpu_torch.config import default_params
from prrn_aln_tpu_torch.msa import distance, tree
from prrn_aln_tpu_torch.msa.msa import msa_from_strings
from prrn_aln_tpu_torch.msa.outliers import Dixon, find_outliers, \
    outlier_report
from prrn_aln_tpu_torch.msa.sets import Subset
from prrn_aln_tpu_torch.msa.shuffle import shuffle_test
from prrn_aln_tpu_torch.msa.sptree import sptree_wsp
from prrn_aln_tpu_torch.ops.local_np import swg_colonies
from prrn_aln_tpu_torch.utils import seqtools

# one intra-op thread: the suite runs several worker processes at once
torch.set_num_threads(1)

FIX = Path(__file__).parent / "fixtures"
AA = "ARNDCQEGHILKMFPSTWYV"


@pytest.mark.parametrize("n, text", [
    (6, "1 2/3-5/6"), (5, "2-4"), (4, "1-/4"), (5, "1-4/5"),
    (4, "1 2 2/3"), (9, "3 1/7-9"), (7, ""),
])
def test_subset_matches_jax(n, text):
    got, want = Subset.from_string(n, text), JSubset.from_string(n, text)
    assert got.groups == want.groups
    assert (got.num, got.elms) == (want.num, want.elms)
    assert got.member_to_group() == want.member_to_group()


def _random_rows(rng, n, L, gap_p=0.15, indel_member=None):
    base = [AA[rng.integers(0, 20)] for _ in range(L)]
    rows = []
    for i in range(n):
        row = [c if rng.random() > 0.2 else AA[rng.integers(0, 20)]
               for c in base]
        row = [("-" if rng.random() < gap_p else c) for c in row]
        if i == indel_member:
            row[L // 3: L // 3 + 8] = "-" * 8
        rows.append(row)
    cols = np.array(rows)
    keep = ~(cols == "-").all(axis=0)
    return ["".join(r) for r in cols[:, keep]]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dixon_matches_jax(seed):
    data = np.random.default_rng(seed).normal(size=9)
    data[seed] += 6.0
    for alpha in (0.05, 0.1, 0.2):
        assert Dixon(alpha).test(data) == JDixon(alpha).test(data)


@pytest.mark.parametrize("seed, n, L", [(0, 6, 80), (1, 9, 120)])
def test_outliers_match_jax(seed, n, L):
    rows = _random_rows(np.random.default_rng(seed), n, L,
                        indel_member=n - 1)
    names = [f"s{i}" for i in range(n)]
    res = []
    for mk, dmod, tmod, sc, prm in (
            (msa_from_strings, distance, tree, scoring, default_params),
            (jmsa_from_strings, jdistance, jtree, jscoring,
             jdefault_params)):
        m = mk(rows, ab.PROTEIN, names)
        t = tmod.upgma(dmod.msa_distance_matrix(m.codes), n)
        m.weight = tmod.calc_seq_weights(t)
        mtx, _ = sc.build_matrix(ab.PROTEIN, prm(ab.PROTEIN, "prrn"))
        res.append((m, t, mtx))
    (m, t, mtx), (jm, jt, jmtx) = res
    got, want = find_outliers(m, t, mtx), jfind_outliers(jm, jt, jmtx)
    assert [vars(o) for o in got] == [vars(o) for o in want]
    assert outlier_report(m, got) == joutlier_report(jm, want)


@pytest.mark.parametrize("seed, n, L", [(0, 5, 60), (1, 10, 120),
                                        (2, 16, 80)])
def test_sptree_matches_jax(seed, n, L):
    rows = _random_rows(np.random.default_rng(seed), n, L)
    names = [f"s{i}" for i in range(n)]
    params = default_params(ab.PROTEIN, "prrn")
    mtx, _ = scoring.build_matrix(ab.PROTEIN, params)
    m = msa_from_strings(rows, ab.PROTEIN, names)
    jm = jmsa_from_strings(rows, jab.PROTEIN, names)
    t = tree.upgma(distance.msa_distance_matrix(m.codes), n)
    jt = jtree.upgma(jdistance.msa_distance_matrix(jm.codes), n)
    got, gpw = sptree_wsp(m, mtx, v=params.v, tree=t)
    want, wpw = jsptree_wsp(jm, mtx, v=params.v, tree=jt)
    assert got == want
    np.testing.assert_array_equal(gpw, wpw)


def _dna(rng, n):
    return rng.integers(1, 5, n).astype(np.int64)


@pytest.mark.parametrize("mlt, sh", [(1, -50), (2, 300)])
def test_swg_colonies_match_jax_and_oracle(mlt, sh):
    """On loc_a x loc_b (also against the reference's colonies in
    swg1.json and swg2.json) and on a seeded pair with two shared
    segments."""
    seqs = ["".join(ln.strip() for ln in (FIX / f).read_text().splitlines()
                    if not ln.startswith(">"))
            for f in ("loc_a.fa", "loc_b.fa")]
    ca, cb = (ab.encode(s, ab.DNA) for s in seqs)
    mtx, _ = scoring.dna_matrix(default_params(ab.DNA, "aln"))
    rng = np.random.default_rng(mlt)
    core = [_dna(rng, 60), _dna(rng, 45)]
    sa = np.concatenate([_dna(rng, 50), core[0], _dna(rng, 40), core[1]])
    sb = np.concatenate([core[1], _dna(rng, 30), core[0], _dna(rng, 20)])

    def key(cols):
        return [(c.val, c.mlb, c.mrb, c.nlb, c.nrb) for c in cols]

    for a, b in ((ca, cb), (sa, sb)):
        got = key(swg_colonies(a, b, mtx, mlt=mlt, sh=sh))
        assert got == key(jswg_colonies(a, b, mtx, mlt=mlt, sh=sh))
    ref = json.loads((FIX / f"swg{mlt}.json").read_text())["colonies"]
    assert key(swg_colonies(ca, cb, mtx, mlt=mlt, sh=sh)) == \
        [(r["val"], r["mlb"], r["mrb"], r["nlb"], r["nrb"]) for r in ref]


def test_seqtools_match_jax():
    rng = np.random.default_rng(7)
    s = _dna(rng, 200)
    np.testing.assert_array_equal(seqtools.reverse_complement(s),
                                  jseqtools.reverse_complement(s))
    assert seqtools.translate(s, 1) == jseqtools.translate(s, 1)
    assert seqtools.composition(s, ab.DNA) == jseqtools.composition(s,
                                                                    ab.DNA)


def _ulps(a, b):
    a, b = np.float32(a), np.float32(b)
    return abs(int(a.view(np.int32)) - int(b.view(np.int32)))


def _batches(a, b, njumble, which, seed):
    """The shuffle test's pairs, drawn as both packages draw them."""
    rng = np.random.default_rng(seed)
    A, B = [a], [b]
    for _ in range(njumble):
        A.append(rng.permutation(a) if which & 1 else a)
        B.append(rng.permutation(b) if which & 2 else b)
    return np.stack(A), np.stack(B)


@pytest.mark.parametrize("seed, la, lb, which", [
    (0, 120, 114, 3), (1, 64, 90, 1), (2, 150, 150, 2)])
def test_shuffle_matches_jax_within_2_ulp(seed, la, lb, which):
    """Every score within 2 f32 ulp of the JAX scan scorer's (K1's plain
    version here, the same permutations), and the mean, SD and Z-score
    within what that allows."""
    from prrn_aln_tpu.ops.pairwise import wavefront_scores
    from prrn_aln_tpu_torch.ops.pairwise import pairwise_scores
    from prrn_aln_tpu_torch.ops.window import stripe
    rng = np.random.default_rng(seed)
    a = rng.integers(2, 22, la).astype(np.int32)
    b = (a[:lb].copy() if lb <= la
         else rng.integers(2, 22, lb).astype(np.int32))
    b[rng.random(lb) < 0.3] = rng.integers(2, 22, 1)[0]
    params = default_params(ab.PROTEIN, "aln")
    mtx, _ = scoring.build_matrix(ab.PROTEIN, params)
    kw = dict(u=params.u, v=params.v, sh=params.sh, njumble=12,
              which=which, seed=seed + 1)
    got = shuffle_test(a, b, mtx, device="cpu", **kw)
    want = jshuffle_test(a, b, mtx, **kw)
    A, B = _batches(a, b, 12, which, seed + 1)
    n, w = len(A), stripe(la, lb, params.sh)
    mine = pairwise_scores(
        torch.from_numpy(A), torch.from_numpy(B), la, lb,
        torch.from_numpy(mtx.astype(np.float32)), params.u, params.v,
        lw=w.lw, up=w.up, fused=False).numpy()
    theirs = np.asarray(wavefront_scores(
        A, B, np.full(n, la, np.int32), np.full(n, lb, np.int32),
        np.full(n, w.lw, np.int32), np.full(n, w.up, np.int32), mtx,
        np.full(n, params.u, np.float32), np.full(n, params.v, np.float32),
        np.ones(n, np.float32), np.zeros((n, 4), bool), nslot=w.width,
        nsteps=la + lb - 1, dim=mtx.shape[0], local=False))
    assert max(_ulps(x, y) for x, y in zip(mine, theirs)) <= 2
    assert got["score"] == float(mine[0]) and want["score"] == float(
        theirs[0])
    assert got["njumble"] == want["njumble"] == 12
    # 2 ulp of the largest score, and as much again for f32 sums
    tol = 4 * float(np.spacing(np.float32(np.abs(theirs).max())))
    assert abs(got["mean"] - want["mean"]) <= tol
    assert abs(got["sd"] - want["sd"]) <= 2 * tol
    assert got["dev"] == pytest.approx(want["dev"],
                                       abs=4 * tol / want["sd"] + 1e-12)
