"""The port's single-linkage forest path (N >= 16) on the CPU, module by
module against the JAX package on the same seeded inputs: the k-mer
filter (host and device routes), candidate edges, the forest, the
batched progressive merges, ``cut_in``/``update_msa`` and the whole
``build_msa_denovo_large``.  Integer and row results must be equal; DP
distances agree to 1e-4 (the two scorers round within 2 f32 ulp of each
other, tests/test_torch_pairwise.py)."""

import copy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from prrn_aln_tpu import alphabet as jab, io as jio
from prrn_aln_tpu import pipeline as jpipe
from prrn_aln_tpu.config import default_params as jdefault_params
from prrn_aln_tpu.io import SeqRecord as JSeqRecord
from prrn_aln_tpu.msa import kmer as jkmer, slforest as jslforest
from prrn_aln_tpu.msa import tree as jtree
from prrn_aln_tpu.msa.msa import Msa as JMsa, single as jsingle
from prrn_aln_tpu.msa.progressive import (
    progressive_msa_forest as jprogressive_forest)
from prrn_aln_tpu_torch import alphabet as ab, io as tio, scoring
from prrn_aln_tpu_torch import native, pipeline as tpipe
from prrn_aln_tpu_torch.config import default_params
from prrn_aln_tpu_torch.io import SeqRecord
from prrn_aln_tpu_torch.msa import kmer, slforest, tree as ttree
from prrn_aln_tpu_torch.msa.msa import Msa, single
from prrn_aln_tpu_torch.msa.progressive import (progressive_msa,
                                                progressive_msa_forest)

# one intra-op thread: the suite runs several worker processes at once
torch.set_num_threads(1)

FIX = Path(__file__).parent / "fixtures"
AA = np.array(list("ACDEFGHIKLMNPQRSTVWY"))
PARAMS = default_params(ab.PROTEIN, "prrn")
MTX, _ = scoring.build_matrix(ab.PROTEIN, PARAMS)


def _mutate(rng, seq, sub, indel):
    out = []
    for ch in seq:
        r = rng.random()
        if r < indel:
            continue
        if r < 2 * indel:
            out.append(ch)
            out.append(AA[rng.integers(0, 20)])
        elif r < 2 * indel + sub:
            out.append(AA[rng.integers(0, 20)])
        else:
            out.append(ch)
    return "".join(out)


def _families(seed, sizes, length, sub=0.12, indel=0.01):
    """Seeded protein families: (name, sequence) pairs, one random
    ancestor per family and mutated descendants."""
    rng = np.random.default_rng(seed)
    recs = []
    for f, size in enumerate(sizes):
        anc = "".join(AA[rng.integers(0, 20, length + 7 * f)])
        for i in range(size):
            recs.append((f"f{f}s{i}", _mutate(rng, anc, sub, indel)))
    return recs


def _codes(recs):
    return [ab.encode(s, ab.PROTEIN) for _, s in recs]


def _rows(m, mod):
    return [(m.names[i], mod.decode_row(m, i)) for i in range(m.many)]


def _fam19():
    recs = tio.read_fasta(FIX / "fam19.fa")
    return [ab.encode(r.seq.replace("-", ""), ab.PROTEIN) for r in recs]


def test_native_counts_equal_jax_package():
    from prrn_aln_tpu import native as jnative
    rng = np.random.default_rng(0)
    red = rng.integers(-1, 18, 300).astype(np.int8)
    for seed_pat in kmer.PROT_SEEDS + ("1111",):
        got, tot = native.kmer_count(red, seed_pat, 18)
        want, wtot = jnative.kmer_count(red, seed_pat, 18)
        assert tot == wtot and np.array_equal(got, want)
    ca, _ = native.kmer_count(red, "11011", 18)
    cb, _ = native.kmer_count(red[::-1].copy(), "11011", 18)
    for ma, mb in ((1, 1), (2, 3)):
        assert (native.kmer_min_overlap(ca, cb, ma, mb)
                == jnative.kmer_min_overlap(ca, cb, ma, mb))
    assert native.kmer_count(red[:3], "11011", 18)[1] == 0


def test_kmer_distance_matrix_host_route_equals_jax():
    seqs = _fam19()
    assert len(seqs) < kmer.DEVICE_MIN_SEQS
    got = kmer.kmer_distance_matrix(seqs, ab.PROTEIN, device="cpu")
    want = jkmer.kmer_distance_matrix(seqs, jab.PROTEIN)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("molc", [ab.PROTEIN, ab.DNA])
def test_kmer_distance_matrix_device_route_equals_jax(molc):
    """48 or more sequences: the overlap pass as tensors (here on the
    CPU), with one low-complexity sequence past the level cap so that
    the host residual runs too."""
    rng = np.random.default_rng(3)
    if molc == ab.PROTEIN:
        recs = _families(3, [10] * 5, 60)
        recs[7] = (recs[7][0], "ACDE" * 30)
        seqs = _codes(recs)
    else:
        nt = np.array(list("ACGT"))
        seqs = []
        for f in range(7):
            anc = nt[rng.integers(0, 4, 90)]
            for _ in range(7):
                s = anc.copy()
                hit = rng.random(90) < 0.08
                s[hit] = nt[rng.integers(0, 4, hit.sum())]
                seqs.append(ab.encode("".join(s), ab.DNA))
        seqs[5] = ab.encode("ACGTACGTAC" * 25, ab.DNA)
    assert len(seqs) >= kmer.DEVICE_MIN_SEQS
    got = kmer.kmer_distance_matrix(seqs, molc, device="cpu")
    want = jkmer.kmer_distance_matrix(seqs, molc)
    assert np.array_equal(got, want)
    assert 0 < np.count_nonzero(got < 60.0) < len(got)


def test_kmer_knn_candidates_equal_jax():
    seqs = _codes(_families(4, [6, 6, 6, 6, 6], 70))
    got_pairs, got_dist = kmer.kmer_knn_candidates(seqs, ab.PROTEIN,
                                                   m_nearest=4)
    want_pairs, want_dist = jkmer.kmer_knn_candidates(seqs, jab.PROTEIN,
                                                      m_nearest=4)
    assert got_pairs == want_pairs and got_pairs
    assert got_dist == want_dist


def test_candidate_edges_fam19_equal_jax():
    seqs = _fam19()
    kw = dict(u=PARAMS.u, v=PARAMS.v, sh=PARAMS.sh, thr=PARAMS.thr)
    got = slforest.candidate_edges(seqs, ab.PROTEIN, MTX, device="cpu", **kw)
    want = jslforest.candidate_edges(seqs, jab.PROTEIN, MTX, **kw)
    assert len(got) == 27
    assert [(e.u, e.v) for e in got] == [(e.u, e.v) for e in want]
    np.testing.assert_allclose([e.dist for e in got],
                               [e.dist for e in want], rtol=0, atol=1e-4)
    trees, singles = slforest.build_forest(len(seqs), got, thr=PARAMS.thr)
    assert [t.ndesc for t in trees] == [7, 2, 2, 2, 2, 2, 2] and not singles


def _shape(node):
    if node.left is None:
        return node.tid
    return (_shape(node.left), _shape(node.right), node.ndesc,
            round(node.dist, 9))


@pytest.mark.parametrize("max_memb", [2 ** 31 - 1, 4, 3])
def test_build_forest_and_split_equal_jax(max_memb):
    rng = np.random.default_rng(6)
    n = 30
    pairs = sorted({tuple(sorted(rng.choice(n, 2, replace=False)))
                    for _ in range(70)})
    dist = rng.random(len(pairs)) * 100.0
    got_t, got_s = slforest.build_forest(
        n, [slforest.Edge(int(i), int(j), float(d))
            for (i, j), d in zip(pairs, dist)], thr=70.0, max_memb=max_memb)
    want_t, want_s = jslforest.build_forest(
        n, [jslforest.Edge(int(i), int(j), float(d))
            for (i, j), d in zip(pairs, dist)], thr=70.0, max_memb=max_memb)
    assert [_shape(t) for t in got_t] == [_shape(t) for t in want_t]
    assert got_s == want_s and got_t
    assert sum(t.ndesc for t in got_t) + len(got_s) <= n
    for g, w in zip(got_t, want_t):
        gt, gl = slforest.slnode_to_tree(g)
        wt, wl = jslforest.slnode_to_tree(w)
        assert gl == wl
        assert np.array_equal(gt.left, wt.left)
        assert np.array_equal(gt.right, wt.right)


def _small_forest(seed=11, ntrees=3, nseq=4, length=48):
    """Seeded trees and leaves, as plain data for either package."""
    rng = np.random.default_rng(seed)
    out = []
    for t in range(ntrees):
        anc = (rng.integers(0, 20, length + 5 * t) + ab.ALA).astype(np.int8)
        fam = []
        for _ in range(nseq - (t == 2)):
            r = anc.copy()
            mut = rng.random(len(r)) < 0.15
            r[mut] = rng.integers(0, 20, mut.sum()) + ab.ALA
            fam.append(np.delete(r, rng.integers(0, len(r), 2)))
        cond = [float((a[:40] != b[:40]).mean())
                for i, a in enumerate(fam) for b in fam[i + 1:]]
        out.append((np.array(cond), fam, [f"t{t}s{i}"
                                          for i in range(len(fam))]))
    return out


def test_progressive_forest_equals_per_tree_and_jax():
    data = _small_forest()
    trees = [ttree.upgma(c, len(f)) for c, f, _ in data]
    leaves = [[single(s, ab.PROTEIN, n) for s, n in zip(f, names)]
              for _, f, names in data]
    kw = dict(u=2.0, v=9.0, sh=-60)
    serial = [progressive_msa(copy.deepcopy(ls), t, MTX, device="cpu", **kw)
              for t, ls in zip(trees, leaves)]
    got = progressive_msa_forest(trees, leaves, MTX, device="cpu", **kw)
    jtrees = [jtree.upgma(c, len(f)) for c, f, _ in data]
    jleaves = [[jsingle(s, jab.PROTEIN, n) for s, n in zip(f, names)]
               for _, f, names in data]
    want = jprogressive_forest(jtrees, jleaves, MTX, **kw)
    assert len(got) == len(serial) == len(want) == 3
    for g, s, w in zip(got, serial, want):
        assert _rows(g, tio) == _rows(s, tio) == _rows(w, jio)
        assert g.many >= 3


def _msa_pair(cls, single_fn, molc):
    """Two small aligned hosts and one unrelated single sequence."""
    rng = np.random.default_rng(21)
    anc = (rng.integers(0, 20, 50) + ab.ALA).astype(np.int8)

    def host(k, names):
        rows = np.repeat(anc[None, :], k, 0).copy()
        mut = rng.random(rows.shape) < 0.15
        rows[mut] = rng.integers(0, 20, mut.sum()) + ab.ALA
        rows[0, 10:13] = ab.GAP
        rows[k - 1, 30:32] = ab.GAP
        return cls(codes=rows, molc=molc, names=names)

    a = host(3, ["a0", "a1", "a2"])
    b = host(2, ["b0", "b1"])
    b.codes = b.codes[:, 4:]
    lone = single_fn((rng.integers(0, 20, 37) + ab.ALA).astype(np.int8),
                     molc, "lone")
    return a, b, lone


def test_cut_in_and_update_msa_equal_jax():
    a, b, lone = _msa_pair(Msa, single, ab.PROTEIN)
    ja, jb, jlone = _msa_pair(JMsa, jsingle, jab.PROTEIN)
    got = tpipe.update_msa([a, b, lone], params=PARAMS, device="cpu")
    want = jpipe.update_msa([ja, jb, jlone],
                            params=jdefault_params(jab.PROTEIN, "prrn"))
    assert _rows(got, tio) == _rows(want, jio)
    assert got.many == 6 and got.names[-1] == "lone"
    np.testing.assert_array_equal(got.weight, want.weight)

    a2, _, lone2 = _msa_pair(Msa, single, ab.PROTEIN)
    ja2, _, jlone2 = _msa_pair(JMsa, jsingle, jab.PROTEIN)
    got = tpipe.cut_in(a2, lone2, MTX, PARAMS, device="cpu")
    want = jpipe.cut_in(ja2, jlone2, MTX,
                        jdefault_params(jab.PROTEIN, "prrn"))
    assert _rows(got, tio) == _rows(want, jio)
    with pytest.raises(ValueError, match="aligned host"):
        tpipe.update_msa([lone], params=PARAMS, device="cpu")


def test_denovo_large_equals_jax_live():
    """18 short sequences: three families and one unrelated sequence,
    which the forest leaves as a singleton to cut in."""
    recs = _families(8, [7, 6, 4], 56) + _families(9, [1], 50)
    recs[-1] = ("lone", recs[-1][1])
    assert len(recs) == 18
    got = tpipe.build_msa([SeqRecord(n, s) for n, s in recs], randseed=0,
                          maxitr=2, device="cpu")
    want = jpipe.build_msa([JSeqRecord(n, s) for n, s in recs], randseed=0,
                           maxitr=2)
    assert _rows(got, tio) == _rows(want, jio)
    assert got.many == 18
    originals = dict(recs)
    for name, row in _rows(got, tio):
        assert row.replace("-", "") == originals[name]
    seqs = _codes(recs)
    edges = slforest.candidate_edges(seqs, ab.PROTEIN, MTX, u=PARAMS.u,
                                     v=PARAMS.v, sh=PARAMS.sh,
                                     thr=PARAMS.thr, device="cpu")
    trees, singles = slforest.build_forest(len(seqs), edges, thr=PARAMS.thr)
    assert sorted(t.ndesc for t in trees) == [4, 6, 7] and singles == [17]


def test_no_edge_under_threshold_recurses_like_jax():
    """16 unrelated sequences give no edge under ``thr``; the JAX package
    then calls ``build_msa``, which calls the forest path back, until
    Python's recursion limit.  The port mirrors it (ROADMAP.md D)."""
    rng = np.random.default_rng(5)
    recs = [(f"s{i}", "".join(AA[rng.integers(0, 20, 40)]))
            for i in range(16)]
    limit = sys.getrecursionlimit()
    sys.setrecursionlimit(150)
    try:
        with pytest.raises(RecursionError):
            jpipe.build_msa([JSeqRecord(n, s) for n, s in recs], randseed=0,
                            maxitr=1)
        with pytest.raises(RecursionError):
            tpipe.build_msa([SeqRecord(n, s) for n, s in recs], randseed=0,
                            maxitr=1, device="cpu")
    finally:
        sys.setrecursionlimit(limit)
