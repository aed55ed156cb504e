"""Spaced-seed word counting for the k-mer filter, and the formatted
sequence database, on the host.

Counterpart of ``prrn_aln_tpu/native.py::kmer_count``,
``kmer_min_overlap`` and ``SeqDB``, whose work the JAX package hands to a
C++ library (``native/seqlib.cpp``) when it can compile one.  The port
keeps the NumPy forms only (the counts vectorised over a sequence's
windows); they give the same integers and the same files as the library.
"""

from __future__ import annotations

from pathlib import Path

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


class SeqDB:
    """Formatted random-access sequence DB (reference makdbs/DbsDt):
    .psq concatenated codes + .pix offsets + .pnm names."""

    def __init__(self, base: str | Path):
        self.base = Path(base)
        self.codes = np.memmap(f"{base}.psq", dtype=np.int8, mode="r")
        self.offsets = np.fromfile(f"{base}.pix", dtype=np.int64)
        self.names = Path(f"{base}.pnm").read_text().splitlines()

    def __len__(self):
        return len(self.offsets) - 1

    def __getitem__(self, i: int) -> np.ndarray:
        return np.asarray(self.codes[self.offsets[i]:self.offsets[i + 1]])

    @staticmethod
    def build(base: str | Path, seqs: list[np.ndarray],
              names: list[str]) -> "SeqDB":
        offsets = np.zeros(len(seqs) + 1, np.int64)
        for i, s in enumerate(seqs):
            offsets[i + 1] = offsets[i] + len(s)
        codes = (np.concatenate([s.astype(np.int8) for s in seqs])
                 if seqs else np.zeros(0, np.int8))
        names_blob = ("\n".join(names) + "\n").encode()
        codes.tofile(f"{base}.psq")
        offsets.tofile(f"{base}.pix")
        Path(f"{base}.pnm").write_bytes(names_blob)
        return SeqDB(base)
