"""Spaced-seed word counting for the k-mer filter, on the host.

Counterpart of ``prrn_aln_tpu/native.py::kmer_count`` and
``kmer_min_overlap``, whose work the JAX package hands to a C++ library
(``native/seqlib.cpp``) when it can compile one.  The port keeps the
NumPy forms only, vectorised over a sequence's windows; they give the
same integers as the library.
"""

from __future__ import annotations

import numpy as np


def kmer_count(red: np.ndarray, seed: str, nalpha: int) -> tuple[np.ndarray, int]:
    """Dense spaced-seed word counts; returns (counts, total).

    ``red`` holds reduced-alphabet classes (negative: the window is
    dropped); a window contributes the base-``nalpha`` word of its
    classes at the seed's ``1`` positions."""
    on = [i for i, c in enumerate(seed) if c == "1"]
    table_size = nalpha ** len(on)
    red = np.asarray(red, np.int64)
    nwin = len(red) - len(seed) + 1
    if nwin <= 0:
        return np.zeros(table_size, np.int32), 0
    w = np.zeros(nwin, np.int64)
    ok = np.ones(nwin, bool)
    for j in on:
        c = red[j:j + nwin]
        ok &= c >= 0
        w = w * nalpha + np.where(c < 0, 0, c)
    w = w[ok & (w < table_size)]
    counts = np.bincount(w, minlength=table_size).astype(np.int32)
    return counts, int(len(w))


def kmer_min_overlap(ca: np.ndarray, cb: np.ndarray,
                     ma: int = 1, mb: int = 1) -> int:
    """sum over words of min(ca*mb, cb*ma)."""
    return int(np.minimum(ca.astype(np.int64) * mb,
                          cb.astype(np.int64) * ma)
               [(ca > 0) & (cb > 0)].sum())
