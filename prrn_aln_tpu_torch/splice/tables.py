"""Splice-signal parameter tables (data asset).

Loads the dinucleotide signal tables (Intron53) and the 2nd-order
Markov context PWMs for donor / acceptor sites (Splice5 / Splice3),
extracted by tools/extract_splice_tables.py.  Layout mirrors the
reference loader (src/utilseq.cc PatMat::readPatMat; src/codepot.cc
Sig53::Sig53): each PWM row holds 84 features per window position =
4 zeroth-order + 16 first-order + 64 second-order log-odds terms.
"""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np

# the tables are read from the JAX package's data directory, not copied
_DATA = (Path(__file__).resolve().parent.parent.parent / "prrn_aln_tpu"
         / "data" / "splice_tables.npz")


@functools.lru_cache(maxsize=1)
def load_tables() -> dict:
    with np.load(_DATA) as z:
        return {k: z[k] for k in z.files}
