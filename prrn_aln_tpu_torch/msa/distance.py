"""Pairwise distance matrices.

Counterpart of ``prrn_aln_tpu/msa/distance.py``: ``all_pairs_scores``
and ``distance_matrix`` run on ``ops.pairwise.pairwise_scores`` (kernel
K1, or K1f under ``PRRN_PW_FUSED=1``, on a CUDA device; the plain
versions on the CPU); ``condensed_index``,
``scores_to_dist`` and the MSA divergences (``pairdvn``,
``msa_distance_matrix``) are host NumPy, copied unchanged.  With a
``torch.distributed`` ``group`` (the JAX package's ``mesh``) each rank
scores its block of the pairs and the blocks are gathered
(``ops/frontier.py``).

Distance semantics follow the reference's score-based mode (``DynScr``):

    d(i,j) = 100 * (1 - (score_ij + u*|la-lb|/2) / sqrt(self_i * self_j))

with self_i the matrix-diagonal self score (reference: src/aln2.cc:289-335
alnscore2dist, src/phyl.cc:221-259 dpscore/selfscr; the 100x scaling at
src/phyl.cc:250).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.window import stripe
from ..ops.frontier import gather_blocks, shard_block
from ..ops.pairwise import pairwise_scores
from ..utils import trace


def condensed_index(i: int, j: int) -> int:
    """Index into the condensed pair array (reference clib elem())."""
    if i > j:
        i, j = j, i
    return j * (j - 1) // 2 + i


def all_pairs_scores(seqs: list[np.ndarray], mtx: np.ndarray,
                     u: float, v: float, sh: int, group=None,
                     pairs: list[tuple[int, int]] | None = None,
                     lossy: bool = False, *,
                     device: torch.device | str) -> np.ndarray:
    """Banded wavefront scores of ``pairs`` in one batch; by default all
    N*(N-1)/2 pairs.

    Returns the score array in the order of ``pairs``; the default is
    the condensed order of the reference's elem(i,j) = j*(j-1)/2 + i
    (i < j).  ``lossy`` is the bf16 score screen of ``pairwise_scores``.
    With ``group`` each rank scores its block of the pairs on ``device``
    with the whole batch's packing offset (K1f's lanes start at the
    batch's smallest ``lw``; K1's scores do not depend on the batch), so
    every score is bit-equal to the run without a group.
    """
    n = len(seqs)
    if pairs is None:
        pairs = [(i, j) for j in range(1, n) for i in range(j)]
    lens = [len(s) for s in seqs]
    ma = max(lens)
    padded = np.zeros((n, ma), np.int32)
    for k, s in enumerate(seqs):
        padded[k, :len(s)] = s

    ai = np.array([p[0] for p in pairs], np.int64)
    bi = np.array([p[1] for p in pairs], np.int64)
    wdws = [stripe(lens[i], lens[j], sh) for i, j in pairs]
    lw = np.array([w.lw for w in wdws], np.int32)
    up = np.array([w.up for w in wdws], np.int32)
    lo, hi = 0, len(pairs)
    if group is not None:
        _, _, lo, hi = shard_block(len(pairs), group)

    def dev(x):
        return trace.h2d(torch.as_tensor(np.ascontiguousarray(x[lo:hi]),
                                         device=device))

    scores = np.zeros(0, np.float32)
    if hi > lo:
        # lengths and band diagonals go as host arrays: the row sweep
        # (K1f) takes its packing from them without reading the device
        scores = trace.d2h(pairwise_scores(
            dev(padded[ai]), dev(padded[bi]),
            np.array([lens[i] for i in ai[lo:hi]], np.int32),
            np.array([lens[j] for j in bi[lo:hi]], np.int32),
            trace.h2d(torch.as_tensor(mtx.astype(np.float32),
                                      device=device)), u, v,
            lw=lw[lo:hi], up=up[lo:hi], lossy=lossy,
            lw0=int(lw.min()))).numpy()
    if group is None:
        return scores
    return np.array(gather_blocks(list(scores), group), np.float32)


def scores_to_dist(scores: np.ndarray, self_scores: np.ndarray,
                   lens: np.ndarray, pairs: list[tuple[int, int]],
                   u: float) -> np.ndarray:
    """Condensed distances from condensed scores (alnscore2dist, x100)."""
    d = np.empty(len(pairs), np.float64)
    for k, (i, j) in enumerate(pairs):
        denome = np.sqrt(self_scores[i] * self_scores[j])
        scr = scores[k] + u * abs(int(lens[i]) - int(lens[j])) / 2.0
        d[k] = 100.0 * (1.0 - scr / denome)
    return d


def distance_matrix(seqs: list[np.ndarray], mtx: np.ndarray,
                    u: float, v: float, sh: int, group=None, *,
                    device: torch.device | str) -> np.ndarray:
    """Condensed DynScr distance matrix for encoded sequences."""
    n = len(seqs)
    pairs = [(i, j) for j in range(1, n) for i in range(j)]
    scores = all_pairs_scores(seqs, mtx, u, v, sh, group, device=device)
    self_scores = np.array([float(mtx[s, s].sum()) for s in seqs])
    lens = np.array([len(s) for s in seqs])
    return scores_to_dist(scores, self_scores, lens, pairs, u)


def _pairdvn_block(rows_i: np.ndarray, row_j: np.ndarray,
                   gap_code: int = 1) -> np.ndarray:
    """Vectorized pairdvn of each row in ``rows_i`` (k, L) vs ``row_j``
    (L,): matches/mismatches over non-gap columns plus the gap term
    0.8*gap_events + 0.2*unpaired, where gap events are one-sided
    gap-run starts in the both-gap-collapsed projection (the run-state
    machine of divseq.cc:44-74 counts exactly those)."""
    gi = rows_i <= gap_code                  # (k, L)
    gj = row_j <= gap_code                   # (L,)
    both = gi & gj
    resres = ~gi & ~gj
    mch = (resres & (rows_i == row_j)).sum(axis=1)
    mmc = resres.sum(axis=1) - mch
    unp = (gi ^ gj).sum(axis=1)
    # gap events replicate the divseq run-state machine exactly:
    # gsi = length of the raw row-i gap run entering c (both-gap
    # columns count, any i-residue resets); gsj = length of the
    # one-sided-j run entering c in the both-gap-collapsed projection
    # (both-gap columns are transparent, any other column resets).
    # An i-side event fires at one-sided-i columns iff gsi <= gsj,
    # a j-side event at one-sided-j columns iff gsi >= gsj.
    L = rows_i.shape[1]
    idx = np.arange(L)
    onesided_i = gi & ~gj
    onesided_j = gj & ~gi
    k = rows_i.shape[0]

    last_res_i = np.zeros((k, L), np.int64)
    last_res_i[:, 1:] = np.maximum.accumulate(
        np.where(~gi, idx[None, :], -1), axis=1)[:, :-1]
    last_res_i[:, 0] = -1
    gsi = idx[None, :] - 1 - last_res_i          # entering c

    resetj = ~both & ~onesided_j                 # valid non-j columns
    last_rst = np.zeros((k, L), np.int64)
    last_rst[:, 1:] = np.maximum.accumulate(
        np.where(resetj, idx[None, :], -1), axis=1)[:, :-1]
    last_rst[:, 0] = -1
    S = np.zeros((k, L + 1), np.int64)
    S[:, 1:] = np.cumsum(onesided_j, axis=1)
    gsj = S[:, :-1] - np.take_along_axis(S, last_rst + 1, axis=1)

    gap = ((onesided_i & (gsi <= gsj)).sum(axis=1)
           + (onesided_j & (gsi >= gsj)).sum(axis=1))
    gapunp = 0.8 * gap + 0.2 * unp
    denom = gapunp + mch + mmc
    return 1.0 - np.where(denom > 0, mch / np.maximum(denom, 1e-30),
                          0.0)


def pairdvn(msa: np.ndarray, i: int, j: int, gap_code: int = 1) -> float:
    """Percent-divergence between two rows of an MSA (divseq.cc:44-74
    pairdvn)."""
    return float(_pairdvn_block(msa[i][None, :], msa[j], gap_code)[0])


def msa_distance_matrix(msa: np.ndarray) -> np.ndarray:
    """Condensed pairdvn distances between all rows of an MSA
    (vectorized per anchor row)."""
    n = msa.shape[0]
    out = np.empty(n * (n - 1) // 2, np.float64)
    for j in range(1, n):
        idx = [condensed_index(i, j) for i in range(j)]
        out[idx] = _pairdvn_block(msa[:j], msa[j])
    return out
