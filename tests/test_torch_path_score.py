"""The port's ``score_path`` (``prrn_aln_tpu_torch/ops/path_score.py``)
against the JAX package's, with ``==`` on the float: the port computes
the profile products at the path's diagonal moves alone, the JAX
package the whole La x Lb image, and the refinement accepts a candidate
on this score, so one ulp would change an alignment.  Cases: every call
``prrn -R 0`` makes on a small family, seeded sides of the benchmark
cell's widths with seeded paths, and edge cases; and the counter
``score_path.cells``, the products a call computes."""

import collections
import copy
from pathlib import Path

import numpy as np
import pytest
import torch

from prrn_aln_tpu.ops import path_score as jax_path_score
from prrn_aln_tpu_torch import alphabet as ab, io, scoring
from prrn_aln_tpu_torch.cli import prrn_main
from prrn_aln_tpu_torch.config import AlnParams
from prrn_aln_tpu_torch.msa import refine
from prrn_aln_tpu_torch.msa.msa import Msa
from prrn_aln_tpu_torch.ops.path_score import score_path, skl_to_moves
from prrn_aln_tpu_torch.utils import trace

# one intra-op thread: the suite runs several worker processes at once
torch.set_num_threads(1)

FIX = Path(__file__).parent / "fixtures"
MTX, _ = scoring.protein_matrix(AlnParams(pam=150))


def _side(rng, many, length, weighted=True, **kw):
    """A prepared side of ``many`` members and ``length`` columns, about
    one cell in eight a gap."""
    codes = (rng.integers(0, 20, size=(many, length)) + ab.ALA).astype(
        np.int8)
    codes[rng.random((many, length)) < 0.12] = ab.GAP
    codes[:, 0] = ab.ALA
    weight = rng.uniform(0.2, 2.0, many) if weighted else None
    m = Msa(codes=codes, molc=ab.PROTEIN, weight=weight,
            names=[f"s{i}" for i in range(many)], **kw)
    m.prepare(MTX.shape[0])
    return m


def _path(rng, La, Lb, share=0.9):
    """A seeded path from (0, 0) to (La, Lb), ``share`` of the shorter
    side's length in diagonal moves."""
    d = int(share * min(La, Lb))
    moves = np.array([0] * d + [1] * (La - d) + [2] * (Lb - d))
    rng.shuffle(moves)
    return refine.moves_to_skl([int(mv) for mv in moves])


def _both(A, B, skl, u=2.0, v=9.0, mtx=MTX):
    return (score_path(A, B, mtx, skl, u=u, v=v),
            jax_path_score.score_path(A, B, mtx, skl, u=u, v=v))


@pytest.fixture(scope="module")
def captured_calls(tmp_path_factory):
    """The arguments of every ``score_path`` call of ``prrn -R 0`` on
    five members of ce13a17 (their first 60 residues)."""
    tmp = tmp_path_factory.mktemp("path_score")
    recs = io.sniff_and_read(FIX / "ce13a17_clean.fa")[:5]
    fasta = tmp / "five.fa"
    fasta.write_text("".join(f">{r.name}\n{r.seq.replace('-', '')[:60]}\n"
                             for r in recs))
    calls = []

    def capture(A, B, mtx, skl, **kw):
        calls.append(copy.deepcopy((A, B, mtx, skl, kw)))
        return score_path(A, B, mtx, skl, **kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(refine, "score_path", capture)
    try:
        assert prrn_main(["-R", "0", "--device", "cpu", "-o",
                          str(tmp / "out.txt"), str(fasta)]) == 0
    finally:
        mp.undo()
    return calls


def test_every_call_of_prrn_equals_the_jax_package(captured_calls):
    assert len(captured_calls) >= 5
    assert any(0 in skl_to_moves(c[3]) for c in captured_calls)
    for k, (A, B, mtx, skl, kw) in enumerate(captured_calls):
        got = score_path(A, B, mtx, skl, **kw)
        want = jax_path_score.score_path(A, B, mtx, skl, **kw)
        assert got == want, (k, got, want)


# (many A, many B, La, Lb, weighted): the cell's 6-15 members of
# 150-300 columns, its widest pair (6 x 300) first
CELL_WIDTHS = [(6, 6, 300, 300, True), (6, 6, 300, 287, False),
               (15, 8, 160, 165, True), (11, 13, 200, 180, True),
               (9, 9, 230, 226, False), (8, 12, 260, 244, True),
               (7, 15, 212, 158, True), (13, 6, 181, 299, False),
               (10, 10, 250, 250, True), (14, 9, 163, 231, True),
               (12, 7, 276, 205, False), (6, 14, 150, 152, True)]


@pytest.mark.parametrize("case", range(len(CELL_WIDTHS)))
def test_cell_widths_equal_the_jax_package(case):
    ma, mb, La, Lb, weighted = CELL_WIDTHS[case]
    rng = np.random.default_rng(2200 + case)
    A = _side(rng, ma, La, weighted)
    B = _side(rng, mb, Lb, weighted)
    skl = _path(rng, La, Lb, share=rng.uniform(0.6, 0.98))
    got, want = _both(A, B, skl)
    assert got == want


def _edge(name):
    rng = np.random.default_rng(7)
    if name == "one_member":
        return _side(rng, 1, 40), _side(rng, 5, 37), None
    if name == "weights_none":
        return _side(rng, 4, 40, False), _side(rng, 3, 37, False), None
    if name == "exgl":
        return _side(rng, 4, 40, exgl=True), _side(rng, 3, 37), None
    if name == "tgapf":
        return _side(rng, 4, 40), _side(rng, 3, 37, tgapf=0.5), None
    A, B = _side(rng, 4, 40), _side(rng, 3, 37)
    if name == "no_diagonal":
        return A, B, [(0, 0), (40, 0), (40, 37)]
    if name == "one_diagonal":
        return A, B, [(0, 0), (0, 20), (1, 21), (40, 21), (40, 37)]
    raise KeyError(name)


EDGES = ["no_diagonal", "one_diagonal", "weights_none", "one_member",
         "exgl", "tgapf"]


@pytest.mark.parametrize("name", EDGES)
def test_edge_cases_equal_the_jax_package(name):
    A, B, skl = _edge(name)
    if skl is None:
        skl = _path(np.random.default_rng(8), A.length, B.length)
    got, want = _both(A, B, skl)
    assert got == want


@pytest.mark.parametrize("name", ["seeded", "no_diagonal", "one_diagonal"])
def test_cells_count_the_diagonal_moves(name):
    if name == "seeded":
        rng = np.random.default_rng(9)
        A, B = _side(rng, 6, 150), _side(rng, 8, 160)
        skl = _path(rng, 150, 160)
    else:
        A, B, skl = _edge(name)
    before = collections.Counter(trace.COUNTS)
    score_path(A, B, MTX, skl, u=2.0, v=9.0)
    got = (trace.COUNTS - before)["score_path.cells"]
    assert got == skl_to_moves(skl).count(0)
    assert got == {"seeded": 135, "no_diagonal": 0, "one_diagonal": 1}[name]
